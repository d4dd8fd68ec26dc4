"""Dtype registry: Paddle's dtype names and string aliases over
``torch.dtype`` (the JAX package's ``core/dtype.py`` maps the same
names onto numpy/jax dtypes)."""
from __future__ import annotations

import numpy as np
import torch

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_ALIASES = {
    "bool": bool_,
    "uint8": uint8,
    "int8": int8,
    "int16": int16,
    "int32": int32,
    "int64": int64,
    "float16": float16,
    "bfloat16": bfloat16,
    "bf16": bfloat16,
    "fp16": float16,
    "float32": float32,
    "fp32": float32,
    "float64": float64,
    "complex64": complex64,
    "complex128": complex128,
}

# The JAX package runs without x64: JAX makes no 64-bit array, and asking
# for one gives its 32-bit kind. The eager op surface (``ops/``) holds
# its outputs to the same dtypes; the models keep torch's own.
_X64 = {torch.int64: torch.int32, torch.float64: torch.float32,
        torch.complex128: torch.complex64, torch.uint64: torch.uint32}


def convert_dtype(dtype) -> torch.dtype:
    """Normalize a dtype spec (Paddle name, numpy dtype or torch dtype)
    to a ``torch.dtype``; ``None`` passes through."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    try:
        return _ALIASES[name]
    except KeyError:
        raise ValueError(f"Unknown dtype {dtype!r}") from None


def canonical(dtype: torch.dtype) -> torch.dtype:
    """The dtype the JAX package gives for ``dtype`` (64-bit kinds
    become their 32-bit ones)."""
    return _X64.get(dtype, dtype)


def get_default_dtype() -> torch.dtype:
    from . import flags
    return convert_dtype(flags.get_flag("default_dtype"))


def set_default_dtype(dtype):
    from . import flags
    d = convert_dtype(dtype)
    if not d.is_floating_point:
        raise TypeError(f"default dtype must be floating, got {d}")
    flags.set_flags({"default_dtype": name_of(d)})


def name_of(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype (``torch.float32`` -> 'float32')."""
    return str(dtype).replace("torch.", "")
