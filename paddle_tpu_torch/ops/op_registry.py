"""Op registry and its dispatch (the JAX package's ``ops/op_registry.py``
and the dispatch of its ``core/tensor.py``).

``op(name, differentiable)`` registers an impl (plain torch tensors in,
plain torch tensors out) under ``name`` in ``OPS`` and returns its
public wrapper, which takes ``Tensor``s, numpy arrays and Python values.
``dispatch`` runs one call: a ``prof_hook`` span ``op::<name>`` while a
Profiler records, the AMP cast of ``amp.auto_cast.maybe_cast``, the
op's ``enforce`` validator, the impl (a ``TypeError``, ``ValueError``
or ``IndexError`` comes back naming the op and its operands), the
``check_nan_inf`` flag's scan, and the outputs as ``Tensor``s in the
JAX package's dtypes (no 64-bit kinds). Gradients are torch's autograd:
a non-differentiable op runs under ``no_grad``, as the JAX dispatch
records no grad node for it. The JAX package's static-graph hook has no
counterpart yet (``static/`` is ROADMAP A13).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np
import torch

from ..amp.auto_cast import is_autocast_enabled, maybe_cast
from ..core import dtype as dtype_mod
from ..core import enforce, flags, prof_hook
from ..core.tensor import Tensor, as_torch

_PLAIN = torch.Tensor
_NO_TF = torch._C.DisableTorchFunctionSubclass


@dataclass
class OpDef:
    name: str
    impl: Callable          # plain torch tensors in, plain tensors out
    public: Callable        # Tensor-aware wrapper
    differentiable: bool


OPS: Dict[str, OpDef] = {}


def op(name: str = None, differentiable: bool = True):
    """Register a torch op impl and return its Tensor-aware wrapper."""

    def deco(impl: Callable) -> Callable:
        opname = name or impl.__name__

        @functools.wraps(impl)
        def public(*args, **kwargs):
            return dispatch(opname, impl, args, kwargs, differentiable)

        OPS[opname] = OpDef(opname, impl, public, differentiable)
        public.op_name = opname
        public.raw = impl
        return public

    return deco


def get_op(name: str) -> OpDef:
    return OPS[name]


def dispatch(name: str, impl: Callable, args: tuple, kwargs: dict,
             differentiable: bool = True):
    """Run ``impl`` on the plain tensors behind ``args``/``kwargs`` and
    return its outputs as ``Tensor``s."""
    if prof_hook.enabled:
        prof_hook.begin(("op::" + name).encode())
        try:
            return _dispatch_body(name, impl, args, kwargs, differentiable)
        finally:
            prof_hook.end()
    return _dispatch_body(name, impl, args, kwargs, differentiable)


class _Leaves:
    """The device of the first tensor operand, the tensor leaves in order
    (for AMP, the error context and ``check_nan_inf``), the ids of the
    caller's own plain tensors among them (an output that is one of them
    is aliased, never re-classed), and whether a numpy array came too."""

    __slots__ = ("device", "tensors", "callers", "arrays")

    def __init__(self):
        self.device = None
        self.tensors = []
        self.callers = set()
        self.arrays = False


def _unwrap(x, seen: _Leaves):
    if isinstance(x, _PLAIN):
        if type(x) is _PLAIN:
            t = x
            seen.callers.add(id(x))
        else:
            t = x.as_subclass(_PLAIN)
            if getattr(x, "_cut", False):
                t = t.detach()
        if seen.device is None:
            seen.device = t.device
        seen.tensors.append(t)
        return t
    if isinstance(x, tuple):
        return tuple([_unwrap(v, seen) for v in x])
    if isinstance(x, list):
        return [_unwrap(v, seen) for v in x]
    if isinstance(x, np.ndarray):
        seen.arrays = True
    return x


def _arrays_to_torch(x, device):
    """numpy arrays among the operands, on the operands' device."""
    if isinstance(x, np.ndarray):
        return as_torch(x, None, device)
    if isinstance(x, tuple):
        return tuple([_arrays_to_torch(v, device) for v in x])
    if isinstance(x, list):
        return [_arrays_to_torch(v, device) for v in x]
    return x


def _cast_tree(x, cast: Dict[int, torch.Tensor]):
    if isinstance(x, _PLAIN):
        return cast.get(id(x), x)
    if isinstance(x, (list, tuple)):
        return type(x)(_cast_tree(v, cast) for v in x)
    return x


def _dispatch_body(name, impl, args, kwargs, differentiable):
    with _NO_TF():
        seen = _Leaves()
        args = _unwrap(args, seen)
        if kwargs:
            kwargs = {k: _unwrap(v, seen) for k, v in kwargs.items()}
        if seen.arrays:
            device, callers = seen.device, seen.callers
            seen = _Leaves()
            args = _unwrap(_arrays_to_torch(args, device), seen)
            kwargs = {k: _unwrap(_arrays_to_torch(v, device), seen)
                      for k, v in kwargs.items()}
            seen.callers = callers
        if is_autocast_enabled() and seen.tensors:
            cast = maybe_cast(name, *seen.tensors)
            moved = {id(a): b for a, b in zip(seen.tensors, cast)
                     if a is not b}
            if moved:
                args = _cast_tree(args, moved)
                kwargs = {k: _cast_tree(v, moved) for k, v in kwargs.items()}
                seen.tensors = list(cast)
        if enforce.get_check(name) is not None:
            enforce.run_check(name, *args, **kwargs)
        try:
            if differentiable:
                out = impl(*args, **kwargs)
            else:
                with torch.no_grad():
                    out = impl(*args, **kwargs)
        except (TypeError, ValueError, IndexError) as e:
            raise enforce.augment_error(e, name, seen.tensors) from e
        out = _wrap_outputs(out, seen.device, seen.callers)
    if flags.get_flag("check_nan_inf"):
        _check_nan_inf(name, out)
    return out


def _wrap_outputs(out, device, callers=frozenset()):
    """Outputs as ``Tensor``s in the JAX package's dtypes. A fresh plain
    result is re-classed in place (no alias, no extra autograd node);
    one of the caller's own tensors is aliased."""
    if isinstance(out, _PLAIN):
        c = dtype_mod.canonical(out.dtype)
        if c is not out.dtype:
            out = out.to(c)
        if type(out) is _PLAIN and id(out) not in callers:
            out.__class__ = Tensor
            return out
        return out.as_subclass(Tensor)
    if isinstance(out, tuple):
        return tuple(_wrap_outputs(o, device, callers) for o in out)
    if isinstance(out, list):
        return [_wrap_outputs(o, device, callers) for o in out]
    if isinstance(out, (bool, int, float, complex)):
        # the JAX dispatch wraps Python scalars among the outputs too
        return as_torch(out, None, device).as_subclass(Tensor)
    return out


def _check_nan_inf(name, out):
    leaves = out if isinstance(out, (tuple, list)) else (out,)
    for leaf in leaves:
        if isinstance(leaf, (tuple, list)):
            _check_nan_inf(name, leaf)
        elif isinstance(leaf, _PLAIN):
            with _NO_TF():
                bad = ((leaf.is_floating_point() or leaf.is_complex())
                       and not bool(torch.isfinite(leaf).all()))
            if bad:
                raise FloatingPointError(
                    f"NaN/Inf detected in output of op '{name}' "
                    f"(FLAGS_check_nan_inf is enabled)")
