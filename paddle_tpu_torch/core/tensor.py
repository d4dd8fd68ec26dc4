"""The eager ``Tensor`` and ``Parameter`` (the JAX package's
``core/tensor.py``) on torch's own autograd.

``Tensor`` is a subclass of ``torch.Tensor`` made with ``as_subclass``:
Paddle's attributes are properties over torch's state
(``stop_gradient`` is ``not requires_grad``), ``backward``, ``grad``
and hooks are torch's autograd, and torch's default
``__torch_function__`` stays, so a torch op on a ``Tensor`` returns a
``Tensor``. The JAX package keeps its own tape (``GradNode``) only
because JAX has no eager autograd; this package has none. The Paddle
methods (``reshape``, ``sum``, ``astype``, ...) are installed on this
class by ``ops/__init__.py``; nothing is installed on ``torch.Tensor``
or ``torch.nn.Parameter``.

Three Paddle properties shadow torch's: ``shape`` is a ``list`` (as in
the JAX package), ``size`` the element count (an ``int`` that can still
be called as torch's ``size()``), and ``T`` swaps the last two axes. The
models, the engines and ``jit.TrainStep`` make plain torch tensors; no
``Tensor`` enters them.

Dtypes follow the JAX package, which runs without x64: Python ints and
int64 data become int32, float64 data the default float dtype.
"""
from __future__ import annotations

import copy
from typing import Callable, Optional

import numpy as np
import torch

from . import dtype as dtype_mod
from .device import resolve

__all__ = [
    "Tensor", "Parameter", "to_tensor", "is_grad_enabled", "no_grad",
    "enable_grad", "set_grad_enabled", "plain", "plain_grad",
    "plain_data",
]

_PLAIN = torch.Tensor


# ------------------------------------------------------------------ grad mode
# torch's thread-local grad mode; each is usable as a context manager and
# as a decorator, as in the JAX package

def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def set_grad_enabled(mode: bool):
    torch.set_grad_enabled(bool(mode))


def no_grad():
    return torch.no_grad()


def enable_grad():
    return torch.enable_grad()


# ------------------------------------------------------------ data to torch

_NP_X64 = {np.dtype(np.int64): np.int32, np.dtype(np.uint64): np.uint32,
           np.dtype(np.float64): np.float32,
           np.dtype(np.complex128): np.complex64}


def _scalar_dtype(value) -> Optional[torch.dtype]:
    if isinstance(value, bool):
        return torch.bool
    if isinstance(value, int):
        return torch.int32
    if isinstance(value, float):
        return dtype_mod.get_default_dtype()
    if isinstance(value, complex):
        return torch.complex64
    return None


def as_torch(value, dtype=None, device=None) -> torch.Tensor:
    """``value`` (a tensor, a numpy array, a Python scalar or a nested
    list) as a plain torch tensor in the JAX package's dtype for it, on
    ``device`` (a tensor's own device when None, else the default
    device)."""
    dtype = dtype_mod.convert_dtype(dtype)
    if isinstance(value, torch.Tensor):
        t = value.as_subclass(_PLAIN) if type(value) is not _PLAIN else value
        if device is not None:
            t = t.to(resolve(device))
        if dtype is not None:
            t = t.to(dtype_mod.canonical(dtype))
        return t
    dev = resolve(device)
    if dtype is None:
        sd = _scalar_dtype(value)
        if sd is not None:
            return torch.tensor(value, dtype=sd, device=dev)
    if isinstance(value, (list, tuple)) and value and any(
            isinstance(v, torch.Tensor) for v in value):
        return torch.stack([as_torch(v, dtype, dev) for v in value])
    arr = np.asarray(value)
    if dtype is None and arr.dtype == np.float64:
        dtype = dtype_mod.get_default_dtype()   # as the JAX package
    if arr.dtype.kind not in "biufc":
        raise TypeError(f"cannot make a tensor of {type(value).__name__} "
                        f"with dtype {arr.dtype}")
    # astype copies: the tensor never shares the caller's array
    t = torch.from_numpy(arr.astype(_NP_X64.get(arr.dtype, arr.dtype),
                                    order="C"))
    t = t.to(dev)
    if dtype is not None:
        t = t.to(dtype_mod.canonical(dtype))
    return t


# -------------------------------------------------------------------- Tensor

class _Numel(int):
    """Paddle's ``Tensor.size`` (the element count) that torch's own
    Python code can still call as ``size()`` / ``size(dim)``."""

    def __new__(cls, shape):
        n = 1
        for s in shape:
            n *= s
        obj = super().__new__(cls, n)
        obj._shape = shape
        return obj

    def __call__(self, dim=None):
        return self._shape if dim is None else self._shape[dim]


def _wrap(t: torch.Tensor) -> "Tensor":
    return t.as_subclass(Tensor)


def _plain(t: torch.Tensor) -> torch.Tensor:
    return t.as_subclass(_PLAIN) if type(t) is not _PLAIN else t


class Tensor(torch.Tensor):
    """A ``torch.Tensor`` with Paddle's eager API.

    ``stop_gradient`` defaults to True (only Parameters and tensors
    explicitly marked take part in autograd). ``Tensor(data, dtype,
    stop_gradient, name)`` builds one as ``to_tensor`` does.
    """

    name: Optional[str] = None
    persistable = False
    trainable = True
    _cut = False        # stop_gradient set on a computed tensor

    def __new__(cls, data=None, dtype=None, stop_gradient: bool = True,
                name: Optional[str] = None):
        t = as_torch([] if data is None else data, dtype)
        out = torch.Tensor._make_subclass(cls, t, False)
        if not stop_gradient:
            out.stop_gradient = False
        if name is not None:
            out.name = name
        return out

    def __init__(self, *args, **kwargs):
        pass

    # -- properties over torch's state ------------------------------------
    @property
    def stop_gradient(self) -> bool:
        with torch._C.DisableTorchFunctionSubclass():
            if _PLAIN.is_floating_point(self) or _PLAIN.is_complex(self):
                return self._cut or not self.requires_grad
        return self.__dict__.get("_stop_gradient", True)

    @stop_gradient.setter
    def stop_gradient(self, value: bool):
        value = bool(value)
        with torch._C.DisableTorchFunctionSubclass():
            if not (_PLAIN.is_floating_point(self) or _PLAIN.is_complex(self)):
                # torch keeps no gradient of an integer tensor: the flag is
                # kept for Paddle code that reads it back
                self.__dict__["_stop_gradient"] = value
            elif self.is_leaf:
                self.requires_grad_(not value)
            else:
                # a computed tensor (often a view, which torch cannot
                # detach in place): the ops take it detached from now on
                self._cut = value

    @property
    def shape(self):
        with torch._C.DisableTorchFunctionSubclass():
            return list(_PLAIN.size(self))

    @property
    def size(self):
        with torch._C.DisableTorchFunctionSubclass():
            return _Numel(_PLAIN.size(self))

    @property
    def place(self) -> torch.device:
        with torch._C.DisableTorchFunctionSubclass():
            return self.device

    @property
    def T(self):
        from .. import ops
        return ops.linalg.transpose_last2(self) if self.ndim >= 2 else self

    @property
    def grad(self):
        with torch._C.DisableTorchFunctionSubclass():
            g = _PLAIN.grad.__get__(self)
        return None if g is None else _wrap(g)

    @grad.setter
    def grad(self, value):
        with torch._C.DisableTorchFunctionSubclass():
            _PLAIN.grad.__set__(self, None if value is None
                                else _plain(value))

    def __repr__(self, *, tensor_contents=None):
        grad_str = ", stop_gradient=True" if self.stop_gradient else ""
        return (f"Tensor(shape={self.shape}, "
                f"dtype={dtype_mod.name_of(self.dtype)}, "
                f"place={self.place}{grad_str},\n       {self.numpy()})")

    __str__ = __repr__

    # -- host transfers: the only ones the op surface makes ----------------
    def numpy(self) -> np.ndarray:
        with torch._C.DisableTorchFunctionSubclass():
            t = _PLAIN.detach(self)
            if t.dtype == torch.bfloat16:
                t = t.float()       # numpy has no bfloat16 (ROADMAP C15)
            return t.numpy(force=True)

    def __hash__(self):
        return id(self)

    def __deepcopy__(self, memo):
        with torch._C.DisableTorchFunctionSubclass():
            out = _wrap(_PLAIN.clone(_PLAIN.detach(self)))
            if self.requires_grad:
                out.requires_grad_(True)
        out.__dict__.update(copy.deepcopy(self.__dict__, memo))
        memo[id(self)] = out
        return out

    # -- autograd ---------------------------------------------------------
    def detach(self) -> "Tensor":
        with torch._C.DisableTorchFunctionSubclass():
            t = _wrap(_PLAIN.detach(self))
        for k in ("name", "persistable", "trainable"):
            if k in self.__dict__:
                t.__dict__[k] = self.__dict__[k]
        return t

    def clone(self, *args, **kwargs) -> "Tensor":
        from .. import ops
        return ops.math.clone(self)

    def register_hook(self, hook: Callable):
        """Gradient hook: called with the gradient as a ``Tensor`` during
        backward; may return a replacement. Returns a callable that
        removes the hook (its ``remove()`` too)."""

        def on_grad(g):
            res = hook(_wrap(g))
            return None if res is None else _plain(
                as_torch(res, None, g.device))

        with torch._C.DisableTorchFunctionSubclass():
            handle = _PLAIN.register_hook(self, on_grad)
        return _HookHandle(handle)

    def backward(self, grad_tensor=None, retain_graph: bool = False):
        from ..autograd.backward_engine import run_backward
        run_backward(self, grad_tensor, retain_graph)

    def clear_grad(self):
        self.grad = None

    clear_gradient = clear_grad

    def set_value(self, value):
        """Write ``value`` (a tensor, an array or a scalar) into this
        tensor in its own dtype, outside autograd."""
        with torch._C.DisableTorchFunctionSubclass(), torch.no_grad():
            _PLAIN.copy_(self, as_torch(value, None, self.device))

    def copy_(self, other, *args, **kwargs):
        self.set_value(other)
        return self

    # -- in place (JAX: Tensor._adopt) --------------------------------------
    def _adopt(self, out) -> "Tensor":
        """Make this tensor hold ``out``, an op's result computed from it.

        Autograd sees a copy into this tensor: the gradient flows through
        ``out`` to its inputs, as the JAX package's adopted grad record
        does (a result of another shape, from the in-place ops that
        reshape, re-strides this tensor in place instead). torch refuses an in-place write to a leaf
        that requires grad; there, and for a result of another dtype or
        size, the data is replaced outside autograd and the tensor stays
        a leaf (ROADMAP C20)."""
        out = _plain(out)
        with torch._C.DisableTorchFunctionSubclass():
            size = _PLAIN.size(self)
            if out.dtype == self.dtype and not (self.requires_grad
                                                and self.is_leaf):
                if out.shape == size:
                    _PLAIN.copy_(self, out)
                    return self
                if out.numel() == self.numel() and self.is_contiguous():
                    # the in-place ops that change a shape (reshape_,
                    # flatten_, squeeze_, unsqueeze_) keep the values
                    _PLAIN.as_strided_(self, out.shape,
                                       _PLAIN.contiguous(out).stride())
                    return self
            with torch.no_grad():
                if out.shape == size and out.dtype == self.dtype:
                    _PLAIN.copy_(self, out)
                else:
                    _PLAIN.data.__set__(self, out.detach())
        return self

    def __setitem__(self, idx, value):
        from .. import ops
        self._adopt(ops.manipulation.setitem(self, idx, value))

    def __getitem__(self, idx):
        from .. import ops
        return ops.manipulation.getitem(self, idx)

    # -- operator sugar (the ops' registered implementations) -------------
    def _binop(self, other, opname, reverse=False):
        from .. import ops
        fn = getattr(ops.math, opname)
        return fn(other, self) if reverse else fn(self, other)

    def __add__(self, o):
        return self._binop(o, "add")

    def __radd__(self, o):
        return self._binop(o, "add", reverse=True)

    def __sub__(self, o):
        return self._binop(o, "subtract")

    def __rsub__(self, o):
        return self._binop(o, "subtract", reverse=True)

    def __mul__(self, o):
        return self._binop(o, "multiply")

    def __rmul__(self, o):
        return self._binop(o, "multiply", reverse=True)

    def __truediv__(self, o):
        return self._binop(o, "divide")

    def __rtruediv__(self, o):
        return self._binop(o, "divide", reverse=True)

    def __floordiv__(self, o):
        return self._binop(o, "floor_divide")

    def __mod__(self, o):
        return self._binop(o, "remainder")

    def __and__(self, o):
        return self._binop(o, "bitwise_and")

    __rand__ = __and__

    def __or__(self, o):
        return self._binop(o, "bitwise_or")

    __ror__ = __or__

    def __xor__(self, o):
        return self._binop(o, "bitwise_xor")

    __rxor__ = __xor__

    def __invert__(self):
        from .. import ops
        return ops.math.bitwise_not(self)

    def __pow__(self, o):
        return self._binop(o, "pow")

    def __rpow__(self, o):
        return self._binop(o, "pow", reverse=True)

    def __matmul__(self, o):
        from .. import ops
        return ops.linalg.matmul(self, o)

    def __rmatmul__(self, o):
        from .. import ops
        return ops.linalg.matmul(o, self)

    def __neg__(self):
        with torch._C.DisableTorchFunctionSubclass():
            minus = -1.0 if _PLAIN.is_floating_point(self) else -1
        return self._binop(minus, "multiply")

    def __abs__(self):
        from .. import ops
        return ops.math.abs(self)

    def __eq__(self, o):
        return self._binop(o, "equal")

    def __ne__(self, o):
        return self._binop(o, "not_equal")

    def __lt__(self, o):
        return self._binop(o, "less_than")

    def __le__(self, o):
        return self._binop(o, "less_equal")

    def __gt__(self, o):
        return self._binop(o, "greater_than")

    def __ge__(self, o):
        return self._binop(o, "greater_equal")

    # method-style op aliases are installed by ops/__init__.py


class _HookHandle:
    """What ``register_hook`` returns: call it (the JAX package's form)
    or its ``remove()`` (torch's) to remove the hook."""

    def __init__(self, handle):
        self._handle = handle

    def remove(self):
        self._handle.remove()

    __call__ = remove


class Parameter(Tensor, torch.nn.Parameter):
    """Trainable tensor: a ``torch.nn.Parameter`` with Paddle's
    attributes; ``stop_gradient`` defaults to False, ``persistable`` to
    True. torch ops on it return plain tensors, as on any
    ``nn.Parameter``, and so do its arithmetic operators with a plain
    torch tensor on the other side; the Paddle ops, and its operators
    with a ``Tensor`` or a Python number, return ``Tensor``s."""

    persistable = True

    def __new__(cls, data=None, dtype=None, name: Optional[str] = None,
                trainable: bool = True):
        t = as_torch([] if data is None else data, dtype)
        return torch.Tensor._make_subclass(cls, t, bool(trainable))

    def __init__(self, data=None, dtype=None, name=None, trainable=True):
        if name is not None:
            self.name = name
        self.trainable = bool(trainable)

    def __repr__(self, *, tensor_contents=None):
        return "Parameter containing:\n" + Tensor.__repr__(self)

    __str__ = __repr__

    def __deepcopy__(self, memo):
        with torch._C.DisableTorchFunctionSubclass():
            data = _PLAIN.clone(_PLAIN.detach(self))
        out = Parameter(data, name=self.name, trainable=self.trainable)
        out.stop_gradient = self.stop_gradient
        memo[id(self)] = out
        return out


def plain(t):
    """``t`` as a plain torch tensor: a ``Tensor`` or ``Parameter`` gives
    its plain view, attached to autograd (gradients reach ``t``); any
    other value comes back as it is."""
    return t.as_subclass(_PLAIN) if isinstance(t, Tensor) else t


def plain_grad(t: torch.Tensor) -> Optional[torch.Tensor]:
    """``t``'s gradient as the plain tensor torch keeps (a ``Tensor``'s
    ``grad`` property wraps it)."""
    return _PLAIN.grad.__get__(t)


def plain_data(t: torch.Tensor) -> torch.Tensor:
    """``t``'s data as a plain tensor outside autograd, sharing its
    storage: an in-place write to it writes ``t``."""
    return _PLAIN.data.__get__(t)


def _torch_with_plain(name):
    """Parameter's binary operator ``name``: torch's when the other
    operand is a plain torch tensor (the result plain, as torch code
    expects: Python tries a subclass's reflected operator first, so
    ``x * p`` would otherwise dispatch), Paddle's otherwise."""
    paddle_op = getattr(Tensor, name)
    torch_op = getattr(_PLAIN, name)

    def binop(self, other):
        if isinstance(other, _PLAIN) and not isinstance(other, Tensor):
            return torch_op(self, other)
        return paddle_op(self, other)

    binop.__name__ = name
    return binop


for _name in ("__add__", "__radd__", "__sub__", "__rsub__", "__mul__",
              "__rmul__", "__truediv__", "__rtruediv__", "__matmul__",
              "__rmatmul__", "__pow__", "__rpow__"):
    setattr(Parameter, _name, _torch_with_plain(_name))


def to_tensor(data, dtype=None, place=None, stop_gradient: bool = True
              ) -> Tensor:
    """paddle.to_tensor: ``data`` on ``place`` (default: the
    ``set_device`` device, the first card; without a card this raises),
    in the JAX package's dtype for it unless ``dtype`` is given."""
    if isinstance(data, torch.Tensor):
        with torch._C.DisableTorchFunctionSubclass():
            data = _plain(data).detach()
    out = _wrap(as_torch(data, dtype, resolve(place)))
    if not stop_gradient:
        out.stop_gradient = False
    return out
