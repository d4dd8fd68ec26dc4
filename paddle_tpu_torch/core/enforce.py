"""Enforce-grade error reporting at the op-dispatch boundary.

Reference: paddle/phi/core/enforce.h (PADDLE_ENFORCE_* macros with
expected-vs-got messages) + the InferMeta validations
(paddle/phi/infermeta/binary.cc etc.) + op callstack attribution
(paddle/fluid/framework/op_call_stack.cc).

The port's copy of the JAX package's ``core/enforce.py``: the same
error classes and messages. Without it most errors would surface as raw
torch tracebacks. This module restores the reference's error UX two
ways:

1. per-op validators (registered via @infer_check) run cheap
   shape/dtype checks before the impl and raise EnforceError with
   op-name + expected-vs-got text;
2. the dispatcher wraps impl failures, appending the op name and every
   input's shape/dtype signature to whatever the op raised.

The op registry that calls them comes with ROADMAP A2; until then
wrappers call ``enforce``/``run_check`` themselves.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

__all__ = ["EnforceError", "enforce", "infer_check", "get_check",
           "signature_of", "augment_error"]


class EnforceError(ValueError):
    """Validation failure with a paddle-style expected-vs-got message."""


def enforce(cond: bool, op: str, msg: str):
    if not cond:
        raise EnforceError(f"(InvalidArgument) op '{op}': {msg}")


_CHECKS: Dict[str, Callable] = {}


def infer_check(name: str):
    """Register a shape/dtype validator for op `name`. The validator
    receives the RAW leaves (tensors / python scalars) in the op's
    (args, kwargs) order and raises EnforceError on bad input."""

    def deco(fn):
        _CHECKS[name] = fn
        return fn

    return deco


def get_check(name: str) -> Optional[Callable]:
    return _CHECKS.get(name)


def run_check(name: str, *args, **kwargs):
    """Invoke op `name`'s validator directly — for wrappers that close
    attrs into the dispatched impl (dispatch never sees them). Only an
    EnforceError escapes; validator bugs never mask execution."""
    check = _CHECKS.get(name)
    if check is None:
        return
    try:
        check(*args, **kwargs)
    except EnforceError:
        raise
    except Exception:
        pass


def _shape_of(x):
    s = getattr(x, "shape", None)
    return tuple(s) if s is not None else None


def _dtype_of(x):
    d = getattr(x, "dtype", None)
    return str(d) if d is not None else type(x).__name__


def signature_of(leaves) -> str:
    parts = []
    for leaf in leaves[:8]:
        s = _shape_of(leaf)
        if s is None:
            parts.append(repr(leaf)[:40])
        else:
            parts.append(f"{_dtype_of(leaf)}{list(s)}")
    if len(leaves) > 8:
        parts.append("...")
    return ", ".join(parts)


def augment_error(err: Exception, op: str, leaves) -> Exception:
    """Re-raise-helper: wrap a raw torch failure with op context (the
    op_call_stack.cc attribution analog)."""
    msg = (f"op '{op}' failed: {err}\n"
           f"  [operands: {signature_of(leaves)}]\n"
           f"  (paddle_tpu enforce: check the operand shapes/dtypes "
           f"above against the op's documented signature)")
    new = type(err) if isinstance(err, (ValueError, TypeError,
                                        IndexError)) \
        else ValueError
    try:
        return new(msg)
    except Exception:
        return ValueError(msg)
