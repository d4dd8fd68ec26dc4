"""Carry weights and optimizer state across from the JAX package.

``load_reference_state(model, arrays)`` takes the JAX model's
``state_dict()`` as a dict of numpy arrays (name -> array) and copies
each into this package's parameter of the same name. Both packages use
the same names and shapes (Paddle's ``[in, out]`` Linear layout), so the
copy is one to one. It is strict: a missing, extra, mis-shaped or
differently typed entry raises before anything is written. This module
imports no JAX; the caller produces the arrays, e.g.
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
           "load_reference_hsigmoid_loss"]


def _as_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)                    # a writable, contiguous copy
    if a.dtype.name == "bfloat16":     # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def load_reference_state(model: torch.nn.Module,
                         arrays: Mapping[str, np.ndarray]) -> None:
    """Copy ``arrays`` into ``model``'s state, name for name."""
    own = model.state_dict()
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
