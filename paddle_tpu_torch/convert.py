"""Carry weights and optimizer state across from the JAX package.

``load_reference_state(model, arrays)`` takes the JAX model's
``state_dict()`` as a dict of numpy arrays (name -> array) and copies
each into this package's parameter of the same name. Both packages use
the same names and shapes (Paddle's ``[in, out]`` Linear layout), so the
copy is one to one. It is strict: a missing, extra, mis-shaped or
differently typed entry raises before anything is written. A name may
differ only by ``inner`` components, which the wrappers of
``quantization.QAT`` add: a plain state loads into a quantized model and
a quantized one into a plain model. This module imports no JAX; the
caller produces the arrays, e.g.
``{k: np.asarray(v._data) for k, v in jax_model.state_dict().items()}``.

``load_reference_optimizer_state(optimizer, state)`` takes the JAX
``Optimizer.state_dict()`` (``_step_count``, ``param_{i}`` dicts of
numpy arrays under the JAX optimizer's own keys: ``moment1``,
``moment2``, ``velocity``, ``master``, Adagrad's ``moment``, RMSProp's
``mean_square``, ``momentum`` and ``mean_grad``, Adamax's ``moment`` and
``inf_norm``; and ``LR_Scheduler``) and loads it, each array in its own
dtype, into the port's optimizer over the same parameter list, so a
resumed run computes the same next step. A master that is ``None``
(SGD and Momentum before their first update) is left out: the port
makes it from the parameter at that update, as the JAX package does.
Batch norm's running statistics are buffers of the model's state and
cross with ``load_reference_state``.

``load_reference_tensor(array, stop_gradient=True, name=None,
trainable=True, parameter=False, device=None)`` takes one JAX
``Tensor`` (``parameter=False``) or ``Parameter`` (``parameter=True``)
as its numpy value and its ``stop_gradient``, ``name`` and
``trainable``, and makes the port's ``Tensor`` or ``Parameter`` with
the same value, dtype and attributes on ``device`` (default: the
``set_device`` device).

``load_reference_hsigmoid_loss(layer, weight, bias=None)`` takes a JAX
``HSigmoidLoss``'s ``weight`` [num_classes - 1, feature_size] and
``bias`` [num_classes - 1] (numpy; ``bias`` None when the layer was
built with ``bias_attr=False``) into the port's layer, as strictly. It
is the only loss layer with parameters.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.dtype import convert_dtype

__all__ = ["load_reference_state", "load_reference_optimizer_state",
           "load_reference_hsigmoid_loss", "load_reference_tensor"]


def _as_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)                    # a writable, contiguous copy
    if a.dtype.name == "bfloat16":     # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _without_inner(name: str) -> str:
    return ".".join(p for p in name.split(".") if p != "inner")


def _match_inner(own, arrays):
    """``arrays`` under ``own``'s names where the two differ only by
    ``inner`` components; ``arrays`` unchanged where that does not give
    one name for one name."""
    own_by = {_without_inner(k): k for k in own}
    arr_by = {_without_inner(k): k for k in arrays}
    if len(own_by) != len(own) or len(arr_by) != len(arrays) or \
            set(own_by) != set(arr_by):
        return arrays
    return {own_by[k]: arrays[v] for k, v in arr_by.items()}


def load_reference_state(model: torch.nn.Module,
                         arrays: Mapping[str, np.ndarray]) -> None:
    """Copy ``arrays`` into ``model``'s state, name for name."""
    own = model.state_dict()
    if set(own) != set(arrays):
        arrays = _match_inner(own, arrays)
    missing = sorted(set(own) - set(arrays))
    extra = sorted(set(arrays) - set(own))
    if missing or extra:
        raise KeyError(f"state dicts differ: missing {missing}, "
                       f"unexpected {extra}")
    for name, t in own.items():
        a = np.asarray(arrays[name])
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"{name}: shape {tuple(a.shape)} != "
                             f"{tuple(t.shape)}")
        if convert_dtype(a.dtype.name) != t.dtype:
            raise TypeError(f"{name}: dtype {a.dtype.name} != {t.dtype}")
    with torch.no_grad():
        for name, t in own.items():
            t.copy_(_as_tensor(np.asarray(arrays[name])))


def load_reference_optimizer_state(optimizer, state: Mapping) -> None:
    """Load the JAX optimizer's ``state_dict()`` into ``optimizer``. It
    is strict: every ``param_{i}`` entry must name a parameter of the
    port's list and match its shape, and no parameter may be left out
    when any has state; nothing is loaded otherwise."""
    params = optimizer._parameter_list or []
    keys = sorted(k for k in state if k.startswith("param_"))
    wanted = {f"param_{i}" for i in range(len(params))}
    if keys and set(keys) != wanted:
        raise KeyError(f"optimizer state covers {keys}, the parameter "
                       f"list {sorted(wanted)}")
    converted = {k: v for k, v in state.items()
                 if not k.startswith("param_")}
    for key in keys:
        p = params[int(key[len("param_"):])]
        entry = {}
        for name, a in state[key].items():
            a = np.asarray(a)
            if a.dtype == object and a.shape == () and a.item() is None:
                continue       # a master not made yet (``np.asarray(None)``)
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{key}.{name}: shape {tuple(a.shape)} "
                                 f"!= {tuple(p.shape)}")
            entry[name] = _as_tensor(a)
        converted[key] = entry
    optimizer.set_state_dict(converted)


def load_reference_hsigmoid_loss(layer: torch.nn.Module, weight: np.ndarray,
                                 bias: np.ndarray = None) -> None:
    """Copy a JAX ``HSigmoidLoss``'s weight (and bias) into ``layer``."""
    arrays = {"weight": weight}
    if bias is not None:
        arrays["bias"] = bias
    load_reference_state(layer, arrays)


def load_reference_tensor(array: np.ndarray, stop_gradient: bool = True,
                          name=None, trainable: bool = True,
                          parameter: bool = False, device=None):
    """A JAX ``Tensor`` or ``Parameter`` (its numpy value and attributes)
    as the port's, in the array's own dtype."""
    from .core.device import resolve
    from .core.tensor import Parameter, Tensor
    t = _as_tensor(array).to(resolve(device))
    if parameter:
        out = Parameter(t, name=name, trainable=trainable)
        out.stop_gradient = stop_gradient
        return out
    out = t.as_subclass(Tensor)
    out.stop_gradient = stop_gradient
    if name is not None:
        out.name = name
    out.trainable = bool(trainable)
    return out
