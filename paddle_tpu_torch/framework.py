"""Top-level framework utilities (the JAX package's ``framework.py``):
type predicates, dtype queries, print options, the RNG state, Places
and a few wrappers. The Places are ``torch.device``s."""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from .core import dtype as dtype_mod
from .core import random as random_mod
from .core.tensor import Tensor, as_torch


# -------------------------------------------------------- type predicates
def is_tensor(x) -> bool:
    return isinstance(x, Tensor)


def _dtype_of(x) -> torch.dtype:
    if isinstance(x, torch.Tensor):
        with torch._C.DisableTorchFunctionSubclass():
            return x.dtype
    return as_torch(x, None, "cpu").dtype


def is_complex(x) -> bool:
    return _dtype_of(x).is_complex


def is_floating_point(x) -> bool:
    return _dtype_of(x).is_floating_point


def is_integer(x) -> bool:
    d = _dtype_of(x)
    return not (d.is_floating_point or d.is_complex or d == torch.bool)


def _device_of(x):
    with torch._C.DisableTorchFunctionSubclass():
        return x.device if isinstance(x, torch.Tensor) else None


def rank(x) -> Tensor:
    nd = x.dim() if isinstance(x, torch.Tensor) else np.ndim(x)
    return as_torch(nd, "int32", _device_of(x)).as_subclass(Tensor)


def tolist(x):
    return x.tolist() if isinstance(x, torch.Tensor) else \
        np.asarray(x).tolist()


def is_empty(x) -> Tensor:
    n = torch.Tensor.numel(x) if isinstance(x, torch.Tensor) \
        else np.size(x)
    return as_torch(int(n) == 0, None, _device_of(x)).as_subclass(Tensor)


# --------------------------------------------------------- dtype queries
class iinfo:
    """paddle.iinfo."""

    def __init__(self, dtype):
        info = torch.iinfo(dtype_mod.convert_dtype(dtype))
        self.min = int(info.min)
        self.max = int(info.max)
        self.bits = int(info.bits)
        self.dtype = dtype_mod.name_of(dtype_mod.convert_dtype(dtype))


class finfo:
    """paddle.finfo (bfloat16 included)."""

    def __init__(self, dtype):
        d = dtype_mod.convert_dtype(dtype)
        info = torch.finfo(d)
        self.min = float(info.min)
        self.max = float(info.max)
        self.eps = float(info.eps)
        self.tiny = float(info.tiny)
        self.smallest_normal = float(info.smallest_normal)
        self.bits = int(info.bits)
        self.dtype = dtype_mod.name_of(d)


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """Print options of a Tensor's repr, which prints through numpy."""
    kw = {}
    if precision is not None:
        kw["precision"] = precision
    if threshold is not None:
        kw["threshold"] = threshold
    if edgeitems is not None:
        kw["edgeitems"] = edgeitems
    if linewidth is not None:
        kw["linewidth"] = linewidth
    if sci_mode is not None:
        kw["suppress"] = not sci_mode
    np.set_printoptions(**kw)


# ------------------------------------------------------------ RNG state
def get_cuda_rng_state():
    """The state of every default generator made so far, by device."""
    return random_mod.get_states()


def set_cuda_rng_state(state):
    random_mod.set_states(state)


def disable_signal_handler():
    """Nothing to disable: no signal handler is installed."""


# ------------------------------------------------------------ Places
class CPUPlace:
    """The host, as a ``torch.device``."""

    def __new__(cls):
        return torch.device("cpu")


class CUDAPlace:
    """Card ``device_id``, as a ``torch.device``."""

    def __new__(cls, device_id: int = 0):
        return torch.device("cuda", int(device_id))


class CUDAPinnedPlace(CPUPlace):
    """Pinned host memory is host memory: the CPU device."""


class NPUPlace(CUDAPlace):
    """The accelerator of this package: a CUDA card."""


# ------------------------------------------------------------- wrappers
class LazyGuard:
    """paddle.LazyGuard: parameters are made at once here, so the guard
    changes nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def batch(reader, batch_size, drop_last=False):
    """paddle.batch: wrap a sample reader into a batch reader."""

    def batch_reader():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batch_reader


def check_shape(shape):
    """paddle.check_shape: validate a shape argument of a creation op."""
    if isinstance(shape, torch.Tensor):
        return
    for s in shape:
        if isinstance(s, torch.Tensor):
            continue
        if int(s) < -1 or int(s) == 0:
            raise ValueError(f"invalid dim {s} in shape {shape}")


class DataParallel:
    """paddle.DataParallel in the reference's delegating form: every call
    goes to the wrapped layer, and the no-sync / scale-loss API does
    nothing. Its collective half (gradients reduced across ranks) is
    ROADMAP A11."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        self._layers = layers

    def __call__(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        pass

    def no_sync(self):
        return contextlib.nullcontext()

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layers.set_state_dict(*a, **k)

    def __getattr__(self, name):
        return getattr(self.__dict__["_layers"], name)
