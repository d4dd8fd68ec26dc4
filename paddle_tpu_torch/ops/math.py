"""Elementwise and reduction math ops (the JAX package's ``ops/math.py``)
as torch one-liners, under the same registered names, arguments and
differentiability. Where torch and ``jnp`` differ (an even median, a
mode's ties, a reduction's integer dtype) the impl follows ``jnp``."""
from __future__ import annotations

import builtins

import torch

from ..core import dtype as dtype_mod
from .op_registry import op


def _float(x):
    """``x`` in the default float dtype unless it is floating already
    (jnp's promotion of an integer operand of a float-valued op)."""
    if x.is_floating_point() or x.is_complex():
        return x
    return x.to(dtype_mod.get_default_dtype())


def _as_t(v, like):
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(
        v, device=like.device)


# ------------------------------------------------------------- binary

add = op("add")(lambda x, y: torch.add(x, y))
subtract = op("subtract")(lambda x, y: torch.subtract(x, y))
multiply = op("multiply")(lambda x, y: torch.multiply(x, y))
divide = op("divide")(lambda x, y: torch.true_divide(x, y))
floor_divide = op("floor_divide", differentiable=False)(
    lambda x, y: torch.floor_divide(x, y))
remainder = op("remainder")(lambda x, y: torch.remainder(x, y))
mod = remainder
pow = op("pow")(lambda x, y: torch.pow(x, y))
maximum = op("maximum")(lambda x, y: torch.maximum(x, _as_t(y, x)))
minimum = op("minimum")(lambda x, y: torch.minimum(x, _as_t(y, x)))
fmax = op("fmax")(lambda x, y: torch.fmax(x, _as_t(y, x)))
fmin = op("fmin")(lambda x, y: torch.fmin(x, _as_t(y, x)))
atan2 = op("atan2")(lambda x, y: torch.atan2(_float(x), _float(y)))
logaddexp = op("logaddexp")(lambda x, y: torch.logaddexp(x, y))
heaviside = op("heaviside", differentiable=False)(
    lambda x, y: torch.heaviside(x, _as_t(y, x).to(x.dtype)))
lerp = op("lerp")(lambda x, y, w: x + w * (y - x))
inner = op("inner")(lambda x, y: torch.inner(x, y))
outer = op("outer")(lambda x, y: torch.outer(x.reshape(-1), y.reshape(-1)))
kron = op("kron")(lambda x, y: torch.kron(x, y))
gcd = op("gcd", differentiable=False)(lambda x, y: torch.gcd(x, y))
lcm = op("lcm", differentiable=False)(lambda x, y: torch.lcm(x, y))

# ------------------------------------------------------------- comparison

equal = op("equal", differentiable=False)(lambda x, y: torch.eq(x, y))
not_equal = op("not_equal", differentiable=False)(
    lambda x, y: torch.ne(x, y))
less_than = op("less_than", differentiable=False)(
    lambda x, y: torch.lt(x, y))
less_equal = op("less_equal", differentiable=False)(
    lambda x, y: torch.le(x, y))
greater_than = op("greater_than", differentiable=False)(
    lambda x, y: torch.gt(x, y))
greater_equal = op("greater_equal", differentiable=False)(
    lambda x, y: torch.ge(x, y))


@op("equal_all", differentiable=False)
def equal_all(x, y):
    return torch.tensor(x.shape == y.shape and bool((x == y).all()),
                        device=x.device)


allclose = op("allclose", differentiable=False)(
    lambda x, y, rtol=1e-5, atol=1e-8, equal_nan=False: torch.isclose(
        x, y, rtol=rtol, atol=atol, equal_nan=equal_nan).all())
isclose = op("isclose", differentiable=False)(
    lambda x, y, rtol=1e-5, atol=1e-8, equal_nan=False:
    torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan))

logical_and = op("logical_and", differentiable=False)(
    lambda x, y: torch.logical_and(x, y))
logical_or = op("logical_or", differentiable=False)(
    lambda x, y: torch.logical_or(x, y))
logical_not = op("logical_not", differentiable=False)(
    lambda x: torch.logical_not(x))
logical_xor = op("logical_xor", differentiable=False)(
    lambda x, y: torch.logical_xor(x, y))
bitwise_and = op("bitwise_and", differentiable=False)(
    lambda x, y: torch.bitwise_and(x, y))
bitwise_or = op("bitwise_or", differentiable=False)(
    lambda x, y: torch.bitwise_or(x, y))
bitwise_xor = op("bitwise_xor", differentiable=False)(
    lambda x, y: torch.bitwise_xor(x, y))
bitwise_not = op("bitwise_not", differentiable=False)(
    lambda x: torch.bitwise_not(x))

isnan = op("isnan", differentiable=False)(lambda x: torch.isnan(x))
isinf = op("isinf", differentiable=False)(lambda x: torch.isinf(x))
isfinite = op("isfinite", differentiable=False)(lambda x: torch.isfinite(x))

# ------------------------------------------------------------- unary

abs = op("abs")(lambda x: torch.abs(x))
neg = op("neg")(lambda x: torch.neg(x))
sqrt = op("sqrt")(lambda x: torch.sqrt(_float(x)))
rsqrt = op("rsqrt")(lambda x: torch.rsqrt(_float(x)))
square = op("square")(lambda x: torch.square(x))
exp = op("exp")(lambda x: torch.exp(_float(x)))
expm1 = op("expm1")(lambda x: torch.expm1(_float(x)))
log = op("log")(lambda x: torch.log(_float(x)))
log2 = op("log2")(lambda x: torch.log2(_float(x)))
log10 = op("log10")(lambda x: torch.log10(_float(x)))
log1p = op("log1p")(lambda x: torch.log1p(_float(x)))
sin = op("sin")(lambda x: torch.sin(_float(x)))
cos = op("cos")(lambda x: torch.cos(_float(x)))
tan = op("tan")(lambda x: torch.tan(_float(x)))
asin = op("asin")(lambda x: torch.asin(_float(x)))
acos = op("acos")(lambda x: torch.acos(_float(x)))
atan = op("atan")(lambda x: torch.atan(_float(x)))
sinh = op("sinh")(lambda x: torch.sinh(_float(x)))
cosh = op("cosh")(lambda x: torch.cosh(_float(x)))
tanh = op("tanh")(lambda x: torch.tanh(_float(x)))
asinh = op("asinh")(lambda x: torch.asinh(_float(x)))
acosh = op("acosh")(lambda x: torch.acosh(_float(x)))
atanh = op("atanh")(lambda x: torch.atanh(_float(x)))
floor = op("floor", differentiable=False)(lambda x: torch.floor(x))
ceil = op("ceil", differentiable=False)(lambda x: torch.ceil(x))
round = op("round", differentiable=False)(lambda x: torch.round(x))
trunc = op("trunc", differentiable=False)(lambda x: torch.trunc(x))
sign = op("sign", differentiable=False)(lambda x: torch.sign(x))
reciprocal = op("reciprocal")(lambda x: 1.0 / x)
erf = op("erf")(lambda x: torch.erf(_float(x)))
erfinv = op("erfinv")(lambda x: torch.erfinv(_float(x)))
lgamma = op("lgamma")(lambda x: torch.lgamma(_float(x)))
digamma = op("digamma")(lambda x: torch.digamma(_float(x)))
deg2rad = op("deg2rad")(lambda x: torch.deg2rad(_float(x)))
rad2deg = op("rad2deg")(lambda x: torch.rad2deg(_float(x)))
angle = op("angle")(lambda x: torch.angle(_float(x)))
conj = op("conj")(lambda x: torch.conj_physical(x))
real = op("real")(lambda x: torch.real(x))
imag = op("imag")(
    lambda x: torch.imag(x) if x.is_complex() else torch.zeros_like(x))
nan_to_num = op("nan_to_num")(
    lambda x, nan=0.0, posinf=None, neginf=None:
    torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf))


@op("clip")
def clip(x, min=None, max=None):
    if min is None and max is None:
        return x + 0
    return torch.clamp(x, min, max)


scale = op("scale")(
    lambda x, scale=1.0, bias=0.0, bias_after_scale=True:
    x * scale + bias if bias_after_scale else (x + bias) * scale)
clone = op("clone")(lambda x: torch.clone(x))
increment = op("increment")(lambda x, value=1.0: x + value)
stanh = op("stanh")(
    lambda x, scale_a=0.67, scale_b=1.7159:
    scale_b * torch.tanh(scale_a * x))


@op("multiplex", differentiable=False)
def multiplex(inputs, index):
    rows = torch.arange(index.shape[0], device=index.device)
    return torch.stack(list(inputs), 0)[index[:, 0].long(), rows]


# differentiable for float -> float (``logits.astype("float32")`` keeps
# the graph); a non-float target has no gradient and runs under no_grad
_cast_op = op("cast")(
    lambda x, dtype: x.to(dtype_mod.canonical(dtype_mod.convert_dtype(
        dtype))))


def cast(x, dtype):
    d = dtype_mod.convert_dtype(dtype)
    if not (d.is_floating_point or d.is_complex):
        with torch.no_grad():
            return _cast_op(x, dtype)
    return _cast_op(x, dtype)


cast.op_name = "cast"
cast.raw = _cast_op.raw

# ------------------------------------------------------------- cumulative


def _flat_axis(x, axis):
    return (x.reshape(-1), 0) if axis is None else (x, axis)


@op("cumsum")
def cumsum(x, axis=None):
    x, axis = _flat_axis(x, axis)
    return torch.cumsum(x, axis)


@op("cumprod")
def cumprod(x, dim=None):
    x, dim = _flat_axis(x, dim)
    return torch.cumprod(x, dim)


@op("logcumsumexp")
def logcumsumexp(x, axis=None):
    x, axis = _flat_axis(x, axis)
    return torch.logcumsumexp(_float(x), axis)

# ------------------------------------------------------------- reductions


def _axis(axis):
    if isinstance(axis, list):
        return tuple(axis)
    return axis


def _dims(x, axis):
    """``axis`` as the tuple of dims a torch reduction takes (all dims
    for None)."""
    axis = _axis(axis)
    if axis is None:
        return tuple(range(x.dim()))
    return axis if isinstance(axis, tuple) else (axis,)


def _all_or(x, axis):
    """``axis`` for torch.sum / torch.mean: None (torch's own reduction
    of every element, the one a plain ``x.sum()`` runs) or the dims."""
    return None if axis is None else _dims(x, axis)


@op("sum")
def sum(x, axis=None, dtype=None, keepdim=False):
    return torch.sum(x, dim=_all_or(x, axis), keepdim=keepdim,
                     dtype=dtype_mod.convert_dtype(dtype))


@op("mean")
def mean(x, axis=None, keepdim=False):
    return torch.mean(_float(x), dim=_all_or(x, axis), keepdim=keepdim)


@op("max")
def max(x, axis=None, keepdim=False):
    return torch.amax(x, dim=_dims(x, axis), keepdim=keepdim)


@op("min")
def min(x, axis=None, keepdim=False):
    return torch.amin(x, dim=_dims(x, axis), keepdim=keepdim)


amax = max
amin = min


@op("prod")
def prod(x, axis=None, keepdim=False, dtype=None):
    d = dtype_mod.convert_dtype(dtype)
    dims = sorted(a % builtins.max(x.dim(), 1) for a in _dims(x, axis))
    out = x if d is None else x.to(d)
    for a in reversed(dims):
        out = torch.prod(out, dim=a, keepdim=True)
    return out if keepdim else out.reshape(
        [s for i, s in enumerate(out.shape) if i not in dims])


std = op("std")(
    lambda x, axis=None, unbiased=True, keepdim=False: torch.std(
        _float(x), dim=_dims(x, axis), correction=1 if unbiased else 0,
        keepdim=keepdim))
var = op("var")(
    lambda x, axis=None, unbiased=True, keepdim=False: torch.var(
        _float(x), dim=_dims(x, axis), correction=1 if unbiased else 0,
        keepdim=keepdim))
logsumexp = op("logsumexp")(
    lambda x, axis=None, keepdim=False:
    torch.logsumexp(_float(x), dim=_dims(x, axis), keepdim=keepdim))


@op("all", differentiable=False)
def all(x, axis=None, keepdim=False):
    return torch.all(x.bool(), dim=_dims(x, axis), keepdim=keepdim)


@op("any", differentiable=False)
def any(x, axis=None, keepdim=False):
    return torch.any(x.bool(), dim=_dims(x, axis), keepdim=keepdim)


def _arg(fn, x, axis, keepdim, dtype):
    d = dtype_mod.canonical(dtype_mod.convert_dtype(dtype))
    if axis is None:
        return fn(x.reshape(-1)).to(d)
    return fn(x, dim=axis, keepdim=keepdim).to(d)


argmax = op("argmax", differentiable=False)(
    lambda x, axis=None, keepdim=False, dtype="int64":
    _arg(torch.argmax, x, axis, keepdim, dtype))
argmin = op("argmin", differentiable=False)(
    lambda x, axis=None, keepdim=False, dtype="int64":
    _arg(torch.argmin, x, axis, keepdim, dtype))


@op("count_nonzero", differentiable=False)
def count_nonzero(x, axis=None, keepdim=False):
    dims = _dims(x, axis)
    out = torch.count_nonzero(x, dim=dims)
    if keepdim:
        for a in sorted(d % x.dim() for d in dims):
            out = out.unsqueeze(a)
    return out


def _quantile(fn, x, q, axis, keepdim):
    """jnp's (nan)quantile: linear interpolation over ``axis`` (all
    axes, flattened, for None)."""
    x = _float(x)
    qt = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    if axis is None:
        out = fn(x.reshape(-1), qt, dim=0)
        if keepdim:
            out = out.reshape(tuple(qt.shape) + (1,) * x.dim())
        return out
    dims = _dims(x, axis)
    if len(dims) == 1:
        return fn(x, qt, dim=dims[0], keepdim=keepdim)
    dims = sorted(d % x.dim() for d in dims)
    rest = [d for d in range(x.dim()) if d not in dims]
    moved = x.permute(rest + dims).reshape(
        [x.shape[d] for d in rest] + [-1])
    out = fn(moved, qt, dim=-1)
    if keepdim:
        shape = list(x.shape)
        for d in dims:
            shape[d] = 1
        out = out.reshape(tuple(qt.shape) + tuple(shape))
    return out


median = op("median", differentiable=False)(
    lambda x, axis=None, keepdim=False:
    _quantile(torch.quantile, x, 0.5, axis, keepdim))
quantile = op("quantile", differentiable=False)(
    lambda x, q, axis=None, keepdim=False:
    _quantile(torch.quantile, x, q, axis, keepdim))


@op("trace")
def trace(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


diagonal = op("diagonal")(
    lambda x, offset=0, axis1=0, axis2=1:
    torch.diagonal(x, offset, axis1, axis2))

addmm = op("addmm")(
    lambda input, x, y, beta=1.0, alpha=1.0:
    beta * input + alpha * torch.matmul(x, y))


# -------------------------------------------------- cumulative / nan-aware

def _cum_extreme(x, axis, fn):
    """(values, indices) of a running max/min; ties keep the FIRST
    occurrence (the JAX package's associative scan): a value's index is
    where the running value last changed."""
    if axis is None:
        x, axis = x.reshape(-1), 0
    ax = axis % x.dim()
    vals = fn(x, dim=ax)[0]
    n = x.shape[ax]
    pos = torch.arange(n, device=x.device).reshape(
        [-1 if i == ax else 1 for i in range(x.dim())]).expand(x.shape)
    change = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    change.narrow(ax, 1, n - 1).copy_(
        vals.narrow(ax, 1, n - 1) != vals.narrow(ax, 0, n - 1))
    idx = torch.cummax(torch.where(change, pos, torch.zeros_like(pos)),
                       dim=ax)[0]
    return vals, idx.to(torch.int32)


cummax = op("cummax")(lambda x, axis=None: _cum_extreme(x, axis,
                                                        torch.cummax))
cummin = op("cummin")(lambda x, axis=None: _cum_extreme(x, axis,
                                                        torch.cummin))


@op("nanmean")
def nanmean(x, axis=None, keepdim=False):
    return torch.nanmean(_float(x), dim=_dims(x, axis), keepdim=keepdim)


@op("nansum")
def nansum(x, axis=None, dtype=None, keepdim=False):
    return torch.nansum(x, dim=_dims(x, axis), keepdim=keepdim,
                        dtype=dtype_mod.convert_dtype(dtype))


nanmedian = op("nanmedian")(
    lambda x, axis=None, keepdim=False:
    _quantile(torch.nanquantile, x, 0.5, axis, keepdim))
@op("vander")
def vander(x, n=None, increasing=False):
    n = x.shape[0] if n is None else n
    powers = torch.arange(n, device=x.device)
    if not increasing:
        powers = powers.flip(0)
    return x.unsqueeze(-1) ** powers
frac = op("frac")(lambda x: x - torch.trunc(x))
hypot = op("hypot")(lambda x, y: torch.hypot(x, y))

logit = op("logit")(
    lambda x, eps=None: torch.log(
        (xc := (torch.clamp(x, eps, 1.0 - eps) if eps else x))
        / (1.0 - xc)))
sgn = op("sgn")(lambda x: torch.sgn(x))


@op("frexp", differentiable=False)
def frexp(x):
    m, e = torch.frexp(x)
    return m, e.to(torch.int32)


@op("add_n")
def add_n(inputs):
    out = inputs[0]
    for t in inputs[1:]:
        out = out + t
    return out


@op("renorm")
def renorm(x, p, axis, max_norm):
    """Per-slice p-norm clamp along ``axis`` (the reference's renorm)."""
    reduce_axes = tuple(i for i in range(x.dim()) if i != axis % x.dim())
    norms = torch.sum(torch.abs(x) ** p, dim=reduce_axes,
                      keepdim=True) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                         torch.ones_like(norms))
    return x * factor


nanquantile = op("nanquantile", differentiable=False)(
    lambda x, q, axis=None, keepdim=False:
    _quantile(torch.nanquantile, x, q, axis, keepdim))


@op("kthvalue", differentiable=False)
def kthvalue(x, k, axis=-1, keepdim=False):
    """k-th smallest along axis -> (values, indices), 1-based k."""
    srt, idx = torch.sort(x, dim=axis, stable=True)
    vals = srt.select(axis, k - 1)
    inds = idx.select(axis, k - 1)
    if keepdim:
        vals, inds = vals.unsqueeze(axis), inds.unsqueeze(axis)
    return vals, inds


@op("mode", differentiable=False)
def mode(x, axis=-1, keepdim=False):
    """Most frequent value along axis -> (values, indices); ties pick
    the largest value, as the JAX package's sort-based scan."""
    ax = axis % x.dim()
    srt, sidx = torch.sort(x, dim=ax, stable=True)
    n = x.shape[ax]
    pos = torch.arange(n, device=x.device).reshape(
        [-1 if i == ax else 1 for i in range(x.dim())]).expand(x.shape)
    same = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    same.narrow(ax, 1, n - 1).copy_(
        srt.narrow(ax, 1, n - 1) == srt.narrow(ax, 0, n - 1))
    start = torch.cummax(torch.where(same, torch.zeros_like(pos), pos),
                         dim=ax)[0]
    runs = (pos - start + 1).to(torch.float32)
    bias = torch.linspace(0, 0.5, n, device=x.device).reshape(
        [-1 if i == ax else 1 for i in range(x.dim())])
    best = torch.argmax(runs + bias, dim=ax, keepdim=True)
    vals = torch.take_along_dim(srt, best, dim=ax)
    inds = torch.take_along_dim(sidx, best, dim=ax)
    if not keepdim:
        vals, inds = vals.squeeze(ax), inds.squeeze(ax)
    return vals, inds
