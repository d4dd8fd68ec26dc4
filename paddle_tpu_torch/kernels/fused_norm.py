"""Fused LayerNorm / RMSNorm over the last dim, forward and input
gradient (the JAX package's ``kernels/fused_norm.py``).

``fused_layer_norm`` and ``fused_rms_norm`` go through ``_NormFn``, a
``torch.autograd.Function`` (the JAX package's custom VJP). Its forward
runs ``norm_fwd`` and its backward ``norm_dx``: the kernels of
``csrc/fused_norm.cu`` for tensors on a CUDA card, the plain versions
``norm_fwd_plain`` / ``norm_dx_plain`` (same signatures) for tensors on
the CPU. Nothing else picks a plain version: on the card a kernel
either launches or raises. Each wrapper counts its launches
(``norm_fwd.launches``), each plain version its calls
(``norm_fwd_plain.calls``). dw and db are plain fp32 reductions over the
rows in the backward, cast to the weight's dtype, as they are plain XLA
reductions in the JAX package.

Numerics, as in the JAX package's kernels: statistics in fp32, two
passes (the mean, then the mean of squared deviations; RMSNorm: the
mean of squares), ``rsqrt(ms + eps)``, the affine ``xhat*w + b`` in
fp32 and one rounding to x's dtype at the end. This differs from
``nn.functional.layer_norm``, which rounds ``xhat`` to x's dtype before
the affine, so the plain versions here do not reuse it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_SIG = {"paddle_norm_fwd": (_I, (_P, _P, _P, _P, _L, _I, _L, _F, _I, _I,
                                 _P)),
        "paddle_norm_dx": (_I, (_P, _P, _P, _P, _L, _I, _L, _L, _F, _I, _I,
                                _P))}


def _wide(t):
    """``t`` in fp32, or float64 when it already is."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _stats(xf, eps, rms):
    """(mean, rstd) per row of the wide xf [rows, D], as ``_stats`` in the
    JAX package: RMSNorm's mean is 0."""
    if rms:
        mean = torch.zeros((xf.shape[0], 1), dtype=xf.dtype,
                           device=xf.device)
        ms = xf.square().mean(1, keepdim=True)
    else:
        mean = xf.mean(1, keepdim=True)
        ms = (xf - mean).square().mean(1, keepdim=True)
    return mean, torch.rsqrt(ms + eps)


def _xhat(x2, eps, rms):
    xf = _wide(x2)
    mean, rstd = _stats(xf, eps, rms)
    return (xf - mean) * rstd, rstd


# ----------------------------------------------------------- plain versions

def norm_fwd_plain(x2, w, b, eps, rms):
    """Plain version of the forward kernel: y [rows, D] in x2's dtype from
    x2 [rows, D], w and b [D]."""
    norm_fwd_plain.calls += 1
    xhat, _ = _xhat(x2, eps, rms)
    return (xhat * _wide(w) + _wide(b)).to(x2.dtype)


def norm_dx_plain(x2, w, dy2, eps, rms):
    """Plain version of the dx kernel: dx [rows, D] in x2's dtype,
    recomputing the row statistics from x2."""
    norm_dx_plain.calls += 1
    xhat, rstd = _xhat(x2, eps, rms)
    g = _wide(dy2) * _wide(w)
    c2 = (g * xhat).mean(1, keepdim=True)
    if rms:
        dx = rstd * (g - xhat * c2)
    else:
        c1 = g.mean(1, keepdim=True)
        dx = rstd * (g - c1 - xhat * c2)
    return dx.to(x2.dtype)


# ----------------------------------------------------------- kernels

def _check(x2, w, b=None, dy2=None):
    if x2.dim() != 2 or tuple(w.shape) != (x2.shape[1],):
        raise ValueError(f"x2 [rows, D] and w [D] expected, got "
                         f"{tuple(x2.shape)} and {tuple(w.shape)}")
    for name, t, shape in (("b", b, (x2.shape[1],)),
                           ("dy2", dy2, tuple(x2.shape))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{tuple(t.shape)}")
    for t in (w, b, dy2):
        if t is not None and t.device != x2.device:
            raise ValueError(f"inputs on {x2.device} and {t.device}")
    if dy2 is not None and dy2.dtype != x2.dtype:
        raise TypeError(f"dy2 ({dy2.dtype}) must be {x2.dtype}")
    if not (x2.dtype.is_floating_point and w.dtype.is_floating_point):
        raise TypeError(f"the fused norms take float tensors, got "
                        f"{x2.dtype} and {w.dtype}")
    if x2.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the fused norms run on CUDA or the CPU, got "
                         f"{x2.device}")


def _rows(t):
    """``t`` [rows, D] and its row stride, for a kernel that reads the
    last dim contiguous and the rows at any stride that does not
    overlap; a copy only when that does not hold."""
    if t.stride(1) != 1 or (t.shape[0] > 1 and t.stride(0) < t.shape[1]):
        t = t.contiguous()
    return t, (t.stride(0) if t.shape[0] > 1 else t.shape[1])


def _code(x2):
    if x2.dtype not in _DTYPE_CODES:
        raise TypeError(f"the fused norm kernels take float32, bfloat16 "
                        f"or float16, got {x2.dtype}")
    return _DTYPE_CODES[x2.dtype]


def _library():
    return _build.library("fused_norm", _SIG)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def norm_fwd(x2, w, b, eps, rms):
    """y [rows, D] of the row-wise LayerNorm (``rms`` False) or RMSNorm of
    x2 [rows, D] with w and b [D]: the kernel for CUDA tensors
    (``paddle_norm_fwd``), the plain version for CPU tensors."""
    _check(x2, w, b)
    if x2.device.type == "cpu":
        return norm_fwd_plain(x2, w, b, eps, rms)
    code = _code(x2)
    x2, ldx = _rows(x2)
    wf, bf = w.float().contiguous(), b.float().contiguous()
    y = torch.empty(x2.shape, dtype=x2.dtype, device=x2.device)
    if y.numel() == 0:
        return y
    with torch.cuda.device(x2.device):
        err = _library().paddle_norm_fwd(
            x2.data_ptr(), wf.data_ptr(), bf.data_ptr(), y.data_ptr(),
            x2.shape[0], x2.shape[1], ldx, float(eps), int(rms), code,
            _stream(x2))
    _build.raise_on(err, "norm_fwd")
    norm_fwd.launches += 1
    return y


def norm_dx(x2, w, dy2, eps, rms):
    """dx [rows, D] of ``norm_fwd`` from its output gradient dy2: the
    kernel for CUDA tensors (``paddle_norm_dx``), the plain version for
    CPU tensors."""
    _check(x2, w, dy2=dy2)
    if x2.device.type == "cpu":
        return norm_dx_plain(x2, w, dy2, eps, rms)
    code = _code(x2)
    x2, ldx = _rows(x2)
    dy2, lddy = _rows(dy2)
    wf = w.float().contiguous()
    dx = torch.empty(x2.shape, dtype=x2.dtype, device=x2.device)
    if dx.numel() == 0:
        return dx
    with torch.cuda.device(x2.device):
        err = _library().paddle_norm_dx(
            x2.data_ptr(), wf.data_ptr(), dy2.data_ptr(), dx.data_ptr(),
            x2.shape[0], x2.shape[1], ldx, lddy, float(eps), int(rms), code,
            _stream(x2))
    _build.raise_on(err, "norm_dx")
    norm_dx.launches += 1
    return dx


KERNEL_WRAPPERS = (norm_fwd, norm_dx)
PLAIN_VERSIONS = (norm_fwd_plain, norm_dx_plain)


def reset_counts():
    """Zero every launch and plain-call counter."""
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    for fn in PLAIN_VERSIONS:
        fn.calls = 0


reset_counts()


# ----------------------------------------------------------- autograd

def param_grads(x2, dy2, eps, rms, dtype):
    """(dw, db) of the norm: fp32 sums over the rows of dy*xhat and dy,
    cast to ``dtype`` (the JAX package's ``_norm_bwd`` :119-123)."""
    xhat, _ = _xhat(x2, eps, rms)
    dyf = _wide(dy2)
    return (dyf * xhat).sum(0).to(dtype), dyf.sum(0).to(dtype)


class _NormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, eps, rms):
        ctx.save_for_backward(x, w)
        ctx.eps, ctx.rms = eps, rms
        cols = x.shape[-1]
        return norm_fwd(x.reshape(-1, cols), w, b, eps, rms).reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        cols = x.shape[-1]
        x2, dy2 = x.reshape(-1, cols), dy.reshape(-1, cols).to(x.dtype)
        dx = norm_dx(x2, w, dy2, ctx.eps, ctx.rms).reshape(x.shape) \
            if ctx.needs_input_grad[0] else None
        dw = db = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = param_grads(x2, dy2, ctx.eps, ctx.rms, w.dtype)
        return (dx, dw if ctx.needs_input_grad[1] else None,
                db if ctx.needs_input_grad[2] else None, None, None)


def fused_layer_norm(x, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over the last dim through the fused kernels; a missing
    weight is ones and a missing bias zeros, in x's dtype."""
    cols = x.shape[-1]
    w = weight if weight is not None else \
        torch.ones((cols,), dtype=x.dtype, device=x.device)
    b = bias if bias is not None else \
        torch.zeros((cols,), dtype=x.dtype, device=x.device)
    return _NormFn.apply(x, w, b, float(epsilon), False)


def fused_rms_norm(x, weight=None, epsilon=1e-6):
    """RMSNorm over the last dim through the fused kernels; a missing
    weight is ones in x's dtype. The bias is an internal zero, with no
    gradient."""
    cols = x.shape[-1]
    w = weight if weight is not None else \
        torch.ones((cols,), dtype=x.dtype, device=x.device)
    b = torch.zeros((cols,), dtype=x.dtype, device=x.device)
    return _NormFn.apply(x, w, b, float(epsilon), True)
