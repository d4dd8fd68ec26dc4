"""Weight initializers (the JAX package's ``nn/initializer.py``).

An initializer is called as ``init(shape, dtype, device=, generator=)``
and returns a new plain tensor, or fills one in place with
``init.fill_(t, generator)``. Random draws come from an explicit
``torch.Generator`` (``core/random.py``; the JAX package splits its
global key instead, so the two draw other numbers from one seed and
weights move across with ``convert.py``). ``_fan_in_out`` reads a
Linear weight as Paddle's ``[in, out]`` and a conv weight as ``[out,
in / groups, *kernel]``, as the JAX package does. ``Orthogonal`` follows
``jax.nn.initializers.orthogonal``: the last axis holds the columns, so
a weight of ``rows >= cols`` has orthonormal columns.

``ParamAttr`` carries a parameter's initializer, ``trainable`` and
``regularizer``; its ``name``, ``learning_rate`` and ``need_clip`` are
kept on the attribute and applied nowhere, as in the JAX package, whose
optimizers never read them (ROADMAP C23).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core.device import resolve

__all__ = [
    "Initializer", "Constant", "Uniform", "Normal", "TruncatedNormal",
    "XavierUniform", "XavierNormal", "KaimingUniform", "KaimingNormal",
    "Orthogonal", "Assign", "Dirac", "ParamAttr",
]


def _fan_in_out(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        # Paddle's Linear weight is [in, out]
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    # conv weight [out_c, in_c / groups, *k]
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    """``init(shape, dtype=None, device=None, generator=None)`` makes
    the tensor; subclasses define ``fill_``."""

    def __call__(self, shape, dtype=None, device=None, generator=None):
        t = torch.empty(tuple(int(s) for s in shape),
                        dtype=dtype_mod.convert_dtype(dtype or "float32"),
                        device=resolve(device))
        return self.fill_(t, generator)

    def fill_(self, t: torch.Tensor, generator=None) -> torch.Tensor:
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def fill_(self, t, generator=None):
        with torch.no_grad():
            return t.fill_(float(self.value))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def fill_(self, t, generator=None):
        with torch.no_grad():
            return t.uniform_(float(self.low), float(self.high),
                              generator=generator)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def fill_(self, t, generator=None):
        with torch.no_grad():
            return t.normal_(float(self.mean), float(self.std),
                             generator=generator)


class TruncatedNormal(Initializer):
    """mean + std * N(0, 1) cut to [-2, 2] (``jax.random.
    truncated_normal(-2, 2)``), drawn by the inverse CDF of a uniform
    draw between the bounds' CDF values."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def fill_(self, t, generator=None):
        lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
        hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
        with torch.no_grad():
            u = torch.empty(t.shape, dtype=torch.float32, device=t.device)
            u.uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0, generator=generator)
            z = (torch.erfinv(u) * math.sqrt(2.0)).clamp_(-2.0, 2.0)
            return t.copy_(self.mean + self.std * z)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def fill_(self, t, generator=None):
        fi, fo = _fan_in_out(t.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        with torch.no_grad():
            return t.uniform_(-limit, limit, generator=generator)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def fill_(self, t, generator=None):
        fi, fo = _fan_in_out(t.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        with torch.no_grad():
            return t.normal_(0.0, std, generator=generator)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _gain(self):
        if self.nonlinearity == "relu":
            return math.sqrt(2.0)
        if self.nonlinearity == "leaky_relu":
            return math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        return 1.0

    def _fan(self, shape):
        fi, _ = _fan_in_out(shape)
        return self.fan_in if self.fan_in is not None else fi

    def fill_(self, t, generator=None):
        limit = self._gain() * math.sqrt(3.0 / self._fan(t.shape))
        with torch.no_grad():
            return t.uniform_(-limit, limit, generator=generator)


class KaimingNormal(KaimingUniform):
    def fill_(self, t, generator=None):
        std = self._gain() / math.sqrt(self._fan(t.shape))
        with torch.no_grad():
            return t.normal_(0.0, std, generator=generator)


class Orthogonal(Initializer):
    """gain * Q of a normal draw's QR, its signs fixed by R's diagonal,
    over the shape read as (prod(shape[:-1]), shape[-1])."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def fill_(self, t, generator=None):
        if t.dim() < 2:
            raise ValueError(f"Orthogonal needs a weight of rank >= 2, "
                             f"got shape {tuple(t.shape)}")
        cols = t.shape[-1]
        rows = t.numel() // cols
        with torch.no_grad():
            a = torch.empty((max(rows, cols), min(rows, cols)),
                            dtype=torch.float32, device=t.device)
            a.normal_(0.0, 1.0, generator=generator)
            q, r = torch.linalg.qr(a)
            q = q * torch.sign(torch.diagonal(r))
            if rows < cols:
                q = q.T
            return t.copy_((self.gain * q).reshape(t.shape))


class Assign(Initializer):
    """The given value (an array, a list, a tensor), reshaped to the
    parameter's shape, exactly."""

    def __init__(self, value):
        self.value = value

    def fill_(self, t, generator=None):
        v = self.value
        src = v.detach().as_subclass(torch.Tensor) \
            if isinstance(v, torch.Tensor) \
            else torch.as_tensor(np.asarray(v))
        with torch.no_grad():
            return t.copy_(src.reshape(t.shape))


class Dirac(Initializer):
    """A delta at each kernel's center, so a conv starts as a (grouped)
    identity map: out channel g * (out / groups) + i reads in channel i,
    for i below min(out / groups, in)."""

    def __init__(self, groups: int = 1, name=None):
        self.groups = int(groups)

    def fill_(self, t, generator=None):
        shape = tuple(t.shape)
        if len(shape) < 3:
            raise ValueError(
                f"Dirac needs a conv weight of rank 3/4/5, got {shape}")
        out_c, in_c = shape[0], shape[1]
        if out_c % self.groups != 0:
            raise ValueError(
                f"out_channels {out_c} not divisible by groups "
                f"{self.groups}")
        center = tuple(k // 2 for k in shape[2:])
        per = out_c // self.groups
        with torch.no_grad():
            t.zero_()
            for g in range(self.groups):
                for i in range(min(per, in_c)):
                    t[(g * per + i, i) + center] = 1.0
        return t


class ParamAttr:
    """The JAX package's ``ParamAttr``: one parameter's initializer,
    ``trainable`` and ``regularizer`` (``create_parameter`` applies
    these). ``name``, ``learning_rate`` and ``need_clip`` are kept and
    applied nowhere, as in the JAX package (ROADMAP C23)."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 trainable=True, regularizer=None, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.trainable = trainable
        self.regularizer = regularizer
        self.need_clip = need_clip

    def apply_to(self, param):
        """Set ``param``'s ``trainable`` flag and ``regularizer``."""
        param.requires_grad_(bool(self.trainable))
        param.trainable = bool(self.trainable)
        if self.regularizer is not None:
            param.regularizer = self.regularizer
        return param


def as_param_attr(attr):
    """``attr`` as a ``ParamAttr``: None (or False, no parameter) stays
    None, a bare initializer becomes ``ParamAttr(initializer=attr)``."""
    if attr is None or attr is False:
        return None
    if isinstance(attr, Initializer):
        return ParamAttr(initializer=attr)
    if not isinstance(attr, ParamAttr):
        raise TypeError(f"expected a ParamAttr or an Initializer, got "
                        f"{type(attr).__name__}")
    return attr
