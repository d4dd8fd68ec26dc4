"""``TrainStep``: one training step per call (the JAX package's
``jit/api.py:275``).

A call runs the forward, the loss, the backward, gradient clipping and
the optimizer update of every parameter and its state, in place, on the
device the model was built on. The JAX package compiles the whole step
into one donated XLA program; here the step runs eagerly, because the
attention kernels launch through ``ctypes``, which ``torch.compile``
cannot trace. Capturing the step as a CUDA graph is later work
(ROADMAP A4).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core import flags
from ..distributed.fleet.utils.recompute import _as_config
from ..nn.layers_common import frozen_running_stats, train_step_trace
from ..optimizer.lr import LRScheduler


def _to_device(x, device):
    if isinstance(x, (tuple, list)):
        return type(x)(_to_device(v, device) for v in x)
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return torch.as_tensor(x, device=device)
    return x


def _raise_on_nonfinite(loss, grads):
    """Raise ``FloatingPointError`` naming the first non-finite value of
    the step: the loss, else the first gradient in parameter order. One
    host read of all the checks together."""
    finite = torch.stack([torch.isfinite(loss).all()]
                         + [torch.isfinite(g).all() for g in grads]).cpu()
    if bool(finite.all()):
        return
    bad = int((~finite).nonzero()[0])
    what = "the loss" if bad == 0 else f"the gradient of parameter {bad - 1}"
    raise FloatingPointError(
        f"check_nan_inf_in_program: {what} is not finite (nan or inf); "
        "the step's update was not applied")


class TrainStep:
    """Usage, as with the JAX package::

        step = TrainStep(model, opt, loss_fn)
        for inputs, labels in loader:
            loss = step(inputs, labels)    # updates model and opt in place

    ``loss_fn(model_output, labels)`` gives a scalar. The last argument
    of a call is the labels, the others go to the model; tensors and
    numpy arrays are placed on the model's device. With
    ``skip_nonfinite``, a step whose loss is not finite leaves the
    parameters and the optimizer state as they were and still returns
    the loss (this reads the loss on the host once per step). The step
    count and a per-iteration LR schedule advance on every call, and
    batch norm's running statistics stay as they were, as in the JAX
    package (an eager training forward updates them). ``donate`` is
    accepted for the JAX signature: the update is in place either way.

    With the flag ``check_nan_inf_in_program`` on (``set_flags`` or
    ``FLAGS_check_nan_inf_in_program=1``) a step whose loss or any
    gradient is not finite raises ``FloatingPointError`` before the
    update, as the JAX package's ``jax_debug_nans`` does; one host read
    per step, and none when the flag is off.

    ``recompute`` (a ``fleet.utils.RecomputeConfig`` or a policy name)
    runs the model and the loss as one recompute region under the
    config's policy, as the JAX package wraps its loss function in
    ``jax.checkpoint``; the model definition stays as it is. Each call
    runs once under that region: the JAX package's "recompute costs
    one compile" has no counterpart here.

    ``offload_opt_state`` keeps the optimizer's state (moments and fp32
    masters) in pinned host memory between steps, copied to the card for
    the update and back after it (``Optimizer.offload_state``). As in
    the JAX package, which turns it off where the device has no memory
    space of its own besides the host's, it is off for a model on the
    CPU. ``optimizer.state_dict()`` then holds the host tensors.

    The forward runs under ``train_step_trace``, where the JAX package
    traces: batch norm keeps its running statistics,
    ``ResNet(recompute_stages=)`` engages and attention dropout is off
    (ROADMAP C18).
    """

    def __init__(self, model: torch.nn.Module, optimizer, loss_fn: Callable,
                 donate: bool = True, sharding=None,
                 offload_opt_state: bool = False,
                 skip_nonfinite: bool = False, recompute=None):
        if sharding is not None:
            raise NotImplementedError(
                "TrainStep(sharding=...) is not ported yet (ROADMAP A11)")
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self._skip_nonfinite = skip_nonfinite
        self._params = [p for p in model.parameters() if p.requires_grad]
        devices = {p.device for p in self._params}
        if len(devices) != 1:
            raise ValueError(f"TrainStep needs the model's parameters on "
                             f"one device, found {sorted(map(str, devices))}")
        self.device = devices.pop()
        recompute = _as_config(recompute)
        self._loss_of = self._loss if recompute is None \
            else recompute.wrap(self._loss, model.modules())
        optimizer.offload_state = offload_opt_state and \
            self.device.type == "cuda"

    def _loss(self, *batch):
        return self.loss_fn(self.model(*batch[:-1]), batch[-1])

    def __call__(self, *batch):
        opt = self.optimizer
        lr = opt.get_lr()
        opt._step_count += 1
        batch = _to_device(batch, self.device)
        for p in self._params:
            p.grad = None
        # the JAX package traces this forward, so batch norm leaves its
        # running statistics as they were: freeze them here too
        with frozen_running_stats(), train_step_trace():
            loss = self._loss_of(*batch)
        loss.backward()
        # a parameter the loss does not reach gets a zero gradient, as
        # jax.grad gives it (AdamW still decays it and moves its moments)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self._params]
        for p in self._params:
            p.grad = None
        if flags.get_flag("check_nan_inf_in_program"):
            _raise_on_nonfinite(loss, grads)
        if not self._skip_nonfinite or bool(torch.isfinite(loss)):
            opt.apply_gradients(self._params, grads, lr=lr,
                                step=opt._step_count)
        if isinstance(opt._lr, LRScheduler) and opt._lr._step_each_iter:
            opt._lr.step()
        return loss.detach()

    def _unported(self, name, item):
        raise NotImplementedError(f"TrainStep.{name} is not ported yet "
                                  f"(ROADMAP {item})")

    def enable_warm_start(self, store=None):
        self._unported("enable_warm_start", "A9")

    def audit(self, *batch, **audit_kw):
        self._unported("audit", "A12")

    def cost_analysis(self, *batch):
        self._unported("cost_analysis", "A12")


# -------------------------------------------- functional autodiff (eager)
# The JAX package's ``functional_call``, ``grad`` and ``value_and_grad``
# (``jit/api.py:133``, ``:223``, ``:257``) on torch's autograd. As
# there, ``functional_call`` records no gradient of an eager call, but a
# gradient transform still differentiates through it (``no_grad`` stops
# the JAX package's tape, never ``jax.grad``).

import threading  # noqa: E402

_TRANSFORM = threading.local()


def _in_transform() -> bool:
    return getattr(_TRANSFORM, "depth", 0) > 0


def functional_call(layer: torch.nn.Module, params_and_buffers, *args,
                    **kwargs):
    """Run ``layer`` with the parameter and buffer values of the dict
    (name -> tensor or array), without changing the layer."""
    from torch.func import functional_call as _call
    from ..core.tensor import as_torch
    dev = next((p.device for p in layer.parameters()), None)
    values = {k: as_torch(v, None, dev) for k, v in
              params_and_buffers.items()}
    if _in_transform():
        return _call(layer, values, args, kwargs, strict=False)
    with torch.no_grad():
        return _call(layer, values, args, kwargs, strict=False)


def grad(*fargs, **fkwargs):
    """``paddle.grad`` in both of the JAX package's forms:

    - ``grad(fn, argnums=0, has_aux=False)``: the functional transform,
      a function returning the gradient of ``fn``'s scalar output with
      respect to the arguments at ``argnums``;
    - ``grad(outputs, inputs, grad_outputs=None, retain_graph=None,
      create_graph=False, only_inputs=True, allow_unused=False,
      no_grad_vars=None)``: the dygraph API
      (``autograd.backward_engine.tensor_grad``).
    """
    if fargs and callable(fargs[0]) and not isinstance(fargs[0],
                                                       torch.Tensor):
        return _functional(fargs[0], *fargs[1:], value=False, **fkwargs)
    from ..autograd.backward_engine import tensor_grad
    return tensor_grad(*fargs, **fkwargs)


def value_and_grad(fn: Callable, argnums=0, has_aux: bool = False):
    return _functional(fn, argnums, has_aux, value=True)


def _functional(fn, argnums=0, has_aux=False, value=False):
    from ..core.tensor import Tensor, as_torch

    def wrapped(*args, **kwargs):
        nums = (argnums,) if isinstance(argnums, int) else tuple(argnums)
        args = list(args)
        leaves = []
        for i in nums:
            with torch._C.DisableTorchFunctionSubclass():
                t = as_torch(args[i]).detach().requires_grad_(True)
            args[i] = t.as_subclass(Tensor)
            leaves.append(t)
        _TRANSFORM.depth = getattr(_TRANSFORM, "depth", 0) + 1
        try:
            with torch.enable_grad():
                out = fn(*args, **kwargs)
        finally:
            _TRANSFORM.depth -= 1
        val, aux = out if has_aux else (out, None)
        with torch._C.DisableTorchFunctionSubclass():
            v = val.as_subclass(torch.Tensor)
            if v.numel() != 1:
                raise TypeError(
                    "Gradient only defined for scalar-output functions. "
                    f"Output had shape: {list(v.shape)}.")
            gs = (torch.autograd.grad(v, leaves, allow_unused=True,
                                      materialize_grads=True)
                  if v.requires_grad else
                  [torch.zeros_like(t) for t in leaves])
        gs = [g.as_subclass(Tensor) for g in gs]
        g = gs[0] if isinstance(argnums, int) else tuple(gs)
        if value:
            v = val.detach()
            return ((v, aux), g) if has_aux else (v, g)
        return (g, aux) if has_aux else g

    return wrapped
