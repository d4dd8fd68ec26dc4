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
from ..nn.layers_common import frozen_running_stats
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
    """

    def __init__(self, model: torch.nn.Module, optimizer, loss_fn: Callable,
                 donate: bool = True, sharding=None,
                 offload_opt_state: bool = False,
                 skip_nonfinite: bool = False, recompute=None):
        unported = {"sharding": (sharding is not None, "A11"),
                    "offload_opt_state": (offload_opt_state, "A4"),
                    "recompute": (recompute is not None, "A4")}
        for name, (given, item) in unported.items():
            if given:
                raise NotImplementedError(
                    f"TrainStep({name}=...) is not ported yet (ROADMAP "
                    f"{item})")
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

    def __call__(self, *batch):
        opt = self.optimizer
        lr = opt.get_lr()
        opt._step_count += 1
        batch = _to_device(batch, self.device)
        for p in self._params:
            p.grad = None
        # the JAX package traces this forward, so batch norm leaves its
        # running statistics as they were: freeze them here too
        with frozen_running_stats():
            loss = self.loss_fn(self.model(*batch[:-1]), batch[-1])
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
