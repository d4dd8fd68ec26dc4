"""Tensor creation ops (the JAX package's ``ops/creation.py``). Every
creation lands on the default device (``set_device``; the first card
unless the caller asked for the CPU). The random ops draw from that
device's default generator (``core.random.generator``), never torch's
global one: the JAX package splits its global key instead, so the two
draw other numbers from one seed, and they agree in shape, dtype, range
and moments, and each repeats itself after ``seed()``."""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core import random as random_mod
from ..core.device import resolve
from ..core.tensor import Parameter, Tensor, as_torch, to_tensor  # noqa: F401
from .op_registry import _wrap_outputs, op


def _dt(dtype, default_float=True):
    """The JAX package's dtype for a creation: the default float dtype
    when none is given; a 64-bit one gives its 32-bit kind."""
    if dtype is None:
        return (dtype_mod.get_default_dtype() if default_float
                else torch.int32)
    return dtype_mod.canonical(dtype_mod.convert_dtype(dtype))


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _new(t: torch.Tensor) -> Tensor:
    return _wrap_outputs(t, t.device)


def _value(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def zeros(shape, dtype=None):
    return _new(torch.zeros(_shape(shape), dtype=_dt(dtype),
                            device=resolve()))


def ones(shape, dtype=None):
    return _new(torch.ones(_shape(shape), dtype=_dt(dtype),
                           device=resolve()))


def full(shape, fill_value, dtype=None):
    return _new(torch.full(_shape(shape), _value(fill_value),
                           dtype=_dt(dtype), device=resolve()))


def empty(shape, dtype=None):
    # the JAX package's empty is zeros (XLA has no uninitialized memory)
    return zeros(shape, dtype)


zeros_like = op("zeros_like", differentiable=False)(
    lambda x, dtype=None: torch.zeros_like(x, dtype=dtype_mod.convert_dtype(
        dtype)))
ones_like = op("ones_like", differentiable=False)(
    lambda x, dtype=None: torch.ones_like(x, dtype=dtype_mod.convert_dtype(
        dtype)))
full_like = op("full_like", differentiable=False)(
    lambda x, fill_value, dtype=None: torch.full_like(
        x, _value(fill_value), dtype=dtype_mod.convert_dtype(dtype)))
empty_like = zeros_like


def arange(start=0, end=None, step=1, dtype=None):
    if end is None:
        start, end = 0, start
    start, end, step = _value(start), _value(end), _value(step)
    if dtype is None:
        dtype = (dtype_mod.get_default_dtype()
                 if any(isinstance(v, float) for v in (start, end, step))
                 else torch.int32)
    return _new(torch.arange(start, end, step, dtype=_dt(dtype),
                             device=resolve()))


def linspace(start, stop, num, dtype=None):
    return _new(torch.linspace(_value(start), _value(stop), int(num),
                               dtype=_dt(dtype), device=resolve()))


def logspace(start, stop, num, base=10.0, dtype=None):
    return _new(torch.logspace(_value(start), _value(stop), int(num),
                               base=base, dtype=_dt(dtype),
                               device=resolve()))


def eye(num_rows, num_columns=None, dtype=None):
    return _new(torch.eye(num_rows, num_rows if num_columns is None
                          else num_columns, dtype=_dt(dtype),
                          device=resolve()))


def _arr(x):
    if isinstance(x, torch.Tensor):
        with torch._C.DisableTorchFunctionSubclass():
            return x.as_subclass(torch.Tensor)
    return as_torch(x)


def diag(x, offset=0, padding_value=0):
    arr = _arr(x)
    out = torch.diag(arr, offset)
    if padding_value != 0 and arr.dim() == 1:
        on = torch.diag(torch.ones(arr.shape[0], dtype=torch.bool,
                                   device=arr.device), offset)
        out = torch.where(on, out, torch.full_like(out, padding_value))
    return _new(out)


def diagflat(x, offset=0):
    return _new(torch.diagflat(_arr(x), offset))


def meshgrid(*args):
    arrs = [_arr(a) for a in (args[0] if len(args) == 1 and isinstance(
        args[0], (list, tuple)) else args)]
    return [_new(g) for g in torch.meshgrid(*arrs, indexing="ij")]


def assign(x, output=None):
    val = _arr(x)
    if output is not None:
        output.set_value(val)
        return output
    return _new(val.detach().clone())


tril = op("tril")(lambda x, diagonal=0: torch.tril(x, diagonal))
triu = op("triu")(lambda x, diagonal=0: torch.triu(x, diagonal))


def tril_indices(row, col, offset=0):
    return _new(torch.tril_indices(row, col, offset, device=resolve()))


def triu_indices(row, col, offset=0):
    return _new(torch.triu_indices(row, col, offset, device=resolve()))


def clone(x):
    from . import math as math_ops
    return math_ops.clone(x)


# ------------------------------------------------------------------ random


def _gen(device=None):
    dev = resolve(device)
    return dev, random_mod.generator(dev)


def rand(shape, dtype=None):
    dev, g = _gen()
    return _new(torch.rand(_shape(shape), dtype=_dt(dtype), device=dev,
                           generator=g))


def randn(shape, dtype=None):
    dev, g = _gen()
    return _new(torch.randn(_shape(shape), dtype=_dt(dtype), device=dev,
                            generator=g))


def randint(low=0, high=None, shape=(1,), dtype=None):
    if high is None:
        low, high = 0, low
    dev, g = _gen()
    return _new(torch.randint(low, high, _shape(shape), device=dev,
                              generator=g, dtype=_dt(dtype, False)))


def randperm(n, dtype=None):
    dev, g = _gen()
    return _new(torch.randperm(n, device=dev, generator=g).to(
        _dt(dtype, False)))


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0):
    """Uniform in [min, max); a nonzero ``seed`` draws from a generator
    of its own, so the same seed gives the same tensor."""
    dev, g = _gen()
    if seed != 0:
        g = torch.Generator(device=dev)
        g.manual_seed(int(seed))
    out = torch.empty(_shape(shape), dtype=_dt(dtype), device=dev)
    return _new(out.uniform_(min, max, generator=g))


def normal(mean=0.0, std=1.0, shape=None):
    dev, g = _gen()
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        m, s = _arr(mean) if isinstance(mean, torch.Tensor) else mean, \
            _arr(std) if isinstance(std, torch.Tensor) else std
        shp = torch.broadcast_shapes(tuple(getattr(m, "shape", ())),
                                     tuple(getattr(s, "shape", ())))
        z = torch.randn(shp, dtype=dtype_mod.get_default_dtype(),
                        device=dev, generator=g)
        return _new(z * s + m)
    z = torch.randn(_shape(shape or (1,)),
                    dtype=dtype_mod.get_default_dtype(), device=dev,
                    generator=g)
    return _new(z * std + mean)


def bernoulli(x):
    arr = _arr(x)
    g = random_mod.generator(arr.device)
    return _new(torch.bernoulli(arr.detach(), generator=g).to(arr.dtype))


def multinomial(x, num_samples=1, replacement=False):
    arr = _arr(x)
    g = random_mod.generator(arr.device)
    return _new(torch.multinomial(arr.detach(), num_samples, replacement,
                                  generator=g))


def standard_normal(shape, dtype=None):
    return randn(shape, dtype)


def randint_like(x, low=0, high=None, dtype=None):
    shp = tuple(x.shape)
    d = dtype or (x.dtype if isinstance(x, torch.Tensor) else None)
    return randint(low, high, shp, d)


def poisson(x):
    arr = _arr(x)
    g = random_mod.generator(arr.device)
    return _new(torch.poisson(arr.detach(), generator=g).to(arr.dtype))


def create_parameter(shape, dtype, name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """paddle.create_parameter: a free-standing Parameter on the default
    device, from ``default_initializer`` (an ``nn.initializer``
    instance) or the reference's default: zeros for a bias, else
    ``nn.initializer.XavierNormal`` from the device's generator."""
    from ..nn import initializer as I
    d = _dt(dtype)
    shp = _shape(shape)
    dev, g = _gen()
    init = default_initializer
    if init is None:
        init = I.Constant(0.0) if is_bias else I.XavierNormal()
    return Parameter(init(shp, d, device=dev, generator=g), name=name)
