"""Fused ResNet training ops: a 1x1 convolution computed as a matrix
product whose epilogue also gives the batch-norm statistics of its
output, the same with a BN-apply + ReLU prologue on its input, the 3x3
stride-1 convolution with that prologue and epilogue, and the
residual-lean BN applies around them (the JAX package's
``kernels/fused_resnet.py``).

``matmul_bn_stats`` and ``bn_relu_matmul_bn_stats`` are
``torch.autograd.Function``s (the JAX package's custom VJPs). Their
forwards go to ``matmul_bn_stats_fwd`` / ``bn_relu_matmul_bn_stats_fwd``
and their backwards to ``matmul_bn_stats_bwd`` /
``bn_relu_matmul_bn_stats_bwd``: the kernels of ``csrc/fused_resnet.cu``
for tensors on a CUDA card, the plain versions (``*_plain``, same
signatures) for tensors on the CPU. Nothing else picks a plain version:
on the card a kernel either launches or raises. Each kernel wrapper
counts its launches (``matmul_bn_stats_fwd.launches``), each plain
version its calls (``matmul_bn_stats_fwd_plain.calls``). ``route(dtype)``
names where the kernels' products run: bfloat16 on the tensor cores
(``"mma"``), float32 on the CUDA cores (``"fma"``), one tile body for
both; ``_geometry()`` is the tile the library exports, which sizes the
partial buffers and the dw kernel's row chunks.

Numerics, as in the JAX package: y is rounded to the input dtype before
its statistics are taken; the activation ``a`` is rounded before the
product; the effective output gradient ``dy + perch + dvar2*(y - mean)``
(the mean and var cotangents folded in, the dvar term on the CENTERED
y) is rounded before both products. The kernels combine per-tile
(mean, M2) pairs in a fixed order (Chan's formula) where the TPU kernel
anchors a shifted one-pass sum on its first block; both avoid the
cancelling E[y^2] - E[y]^2 form.

The BN applies (``bn_apply_relu_add`` ... ``bn_moments``) are plain
PyTorch, as they are plain jnp in the JAX package; each is an autograd
Function whose backward is the JAX rule written out, so it saves only
the tensors that already exist and keeps the centered-form gamma
gradient.

``conv3x3_bn_act_stats`` (``bn_relu_conv3x3_bn_stats`` from the Paddle
weight) is the fused 3x3 pair: its autograd Function runs
``conv3x3_bn_stats_fwd`` and ``conv3x3_bn_stats_bwd``, the kernels of
``csrc/fused_conv3x3.cu`` on a card and ``*_plain`` on the CPU, with the
same numerics (the activation rounded before the product, zero outside
the image in the activation domain; y rounded before its statistics;
the effective gradient rounded before both products).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"paddle_mm_bn_stats_geometry": (None, (_P,)),
        "paddle_mm_bn_stats_route": (_I, (_I,)),
        "paddle_mm_bn_stats": (_I, (_P,) * 9 + (_I,) * 5 + (_P,)),
        "paddle_mm_bn_stats_bwd": (_I, (_P,) * 16 + (_I,) * 7 + (_P,))}
_SIG3 = {"paddle_conv3x3_bn_stats": (_I, (_P,) * 10 + (_I,) * 9 + (_P,)),
         "paddle_conv3x3_bn_stats_bwd": (_I, (_P,) * 16 + (_I,) * 11
                                         + (_P,))}
# the 1x1 dw kernel's rows are cut into chunks until about _DW_BLOCKS
# blocks (4 per SM of an H100) are in flight; its tile comes from the
# library (``_geometry``)
_DW_BLOCKS = 4 * 132
# the 3x3 kernels' tile: at most _PIX3 output pixels (slabs of whole rows
# of one image, or of a column tile) and _WIN3 window positions; the dw
# kernel's block keeps a _DW3_C x _DW3_O (c, o) tile, about _DW3_BLOCKS
# (2 per SM) in flight, its chunks' fp32 partials within _DW3_SCRATCH
# bytes
_PIX3, _WIN3, _DW3_C, _DW3_O = 128, 512, 64, 32
_DW3_BLOCKS, _DW3_SCRATCH = 2 * 132, 64 * 2 ** 20


def _wide(t):
    """``t`` in fp32, or float64 when it already is."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


# ----------------------------------------------------------- helpers

def _finish_shifted_stats(s, q, k, rows):
    """(mean, var) from shifted sums s = sum(y - k), q = sum((y - k)^2):
    mean = k + E[y-k], var = E[(y-k)^2] - E[y-k]^2 for any anchor k;
    k near the mean keeps both subtractions benign. Round-off can leave
    var a hair below 0: clamped."""
    ds = s / rows
    return k + ds, torch.clamp_min(q / rows - ds * ds, 0.0)


def _stats_cotangent_coeffs(dmean, dvar, rows):
    """Per-channel coefficients of dy_eff = dy + perch + dvar2*(y - mean)
    from the cotangents of mean = sum(y)/M and var = E[(y - mean)^2]."""
    return (dmean / rows).float(), ((2.0 / rows) * dvar).float()


def _dy_effective(dy, perch, dvar2, y, mean):
    """The cotangent of y through the (y, mean, var) outputs, in fp32:
    dy + perch + dvar2*(y - mean). The dvar term multiplies the CENTERED
    y; expanding it as dvar2*y - dvar2*mean cancels when |mean| >> std.
    (The JAX package's helper takes dmean, dvar and the row count;
    ``_stats_cotangent_coeffs`` turns those into perch and dvar2.)"""
    return _wide(dy) + perch + dvar2 * (_wide(y) - mean)


def _prologue(x2, scale, shift):
    """pre = x*scale + shift in fp32 and a = relu(pre) rounded to x's
    dtype, the activation the prologue kernels feed the product."""
    pre = _wide(x2) * scale + shift
    return pre, torch.clamp_min(pre, 0.0).to(x2.dtype)


def _two_pass_stats(y):
    """Mean and var per channel (last dim) of y, two-pass (shifted by the
    exact mean)."""
    yf = _wide(y).reshape(-1, y.shape[-1])
    k = yf.mean(0)
    d = yf - k
    return _finish_shifted_stats(d.sum(0), d.square().sum(0), k,
                                 yf.shape[0])


def _product_stats(a, w2):
    """y = a @ w2 (fp32 sums) rounded to a's dtype, and the mean and var
    of the rounded y per column, two-pass."""
    y = (_wide(a) @ _wide(w2)).to(a.dtype)
    return (y, *_two_pass_stats(y))


def _w9_oihw(w9, c):
    """The tap-major w9 [9C, O] as a conv weight [O, C, 3, 3] (fp32)."""
    return _wide(w9).reshape(3, 3, c, w9.shape[1]).permute(3, 2, 0, 1)


# ----------------------------------------------------------- plain versions

def matmul_bn_stats_fwd_plain(x2, w2):
    """Plain version of the forward kernel: (y [M,N], mean [N], var [N])
    with y = x2 @ w2 rounded to x2's dtype and fp32 statistics of it."""
    matmul_bn_stats_fwd_plain.calls += 1
    return _product_stats(x2, w2)


def bn_relu_matmul_bn_stats_fwd_plain(x2, scale, shift, w2):
    """Plain version of the prologue forward kernel: as
    ``matmul_bn_stats_fwd_plain`` on a = relu(x2*scale + shift)."""
    bn_relu_matmul_bn_stats_fwd_plain.calls += 1
    return _product_stats(_prologue(x2, scale, shift)[1], w2)


def matmul_bn_stats_bwd_plain(dy, y, x2, w2, perch, dvar2, mean):
    """Plain version of the backward kernel: with e = dy_eff rounded to
    x2's dtype, dx = e @ w2^T (rounded) and dw = x2^T @ e (fp32)."""
    matmul_bn_stats_bwd_plain.calls += 1
    e = _wide(_dy_effective(dy, perch, dvar2, y, mean).to(x2.dtype))
    dx = (e @ _wide(w2).t()).to(x2.dtype)
    return dx, _wide(x2).t() @ e


def bn_relu_matmul_bn_stats_bwd_plain(dy, y, x2, scale, shift, w2, perch,
                                      dvar2, mean):
    """Plain version of the prologue backward kernel: da = e @ w2^T,
    gated = da where pre > 0, dx = gated*scale (rounded), dscale =
    sum gated*x, dshift = sum gated, dw = a^T @ e; a recomputed from
    x2. Returns (dx, dw, dscale, dshift)."""
    bn_relu_matmul_bn_stats_bwd_plain.calls += 1
    e = _wide(_dy_effective(dy, perch, dvar2, y, mean).to(x2.dtype))
    pre, a = _prologue(x2, scale, shift)
    da = e @ _wide(w2).t()
    gated = torch.where(pre > 0, da, torch.zeros_like(da))
    dx = (gated * scale).to(x2.dtype)
    dscale = (gated * _wide(x2)).sum(0)
    return dx, _wide(a).t() @ e, dscale, gated.sum(0)


def conv3x3_bn_stats_fwd_plain(x, scale, shift, w9):
    """Plain version of the fused 3x3 forward kernel: a = relu(x*scale +
    shift) rounded to x's dtype, y = the 3x3/s1 SAME convolution of a
    (zero padding, fp32 sums) rounded, and the two-pass mean and var of
    the rounded y. x [N,H,W,C], w9 [9C,O]; returns (y, mean, var)."""
    conv3x3_bn_stats_fwd_plain.calls += 1
    a = _prologue(x, scale, shift)[1]
    y = torch.nn.functional.conv2d(_wide(a).permute(0, 3, 1, 2),
                                   _w9_oihw(w9, x.shape[-1]), padding=1)
    y = y.permute(0, 2, 3, 1).to(x.dtype)
    return (y, *_two_pass_stats(y))


def conv3x3_bn_stats_bwd_plain(dy, y, x, scale, shift, w9, perch, dvar2,
                               mean):
    """Plain version of the fused 3x3 backward kernel: e = dy_eff rounded
    to x's dtype; da = the transposed convolution of e; gated = da where
    pre = x*scale + shift > 0; dx = gated*scale (rounded), dscale = sum
    gated*x, dshift = sum gated, dw [9C,O] = the weight gradient of the
    convolution of a (recomputed from x) against e, fp32. Returns (dx,
    dw, dscale, dshift)."""
    conv3x3_bn_stats_bwd_plain.calls += 1
    c, o = x.shape[-1], w9.shape[1]
    e = _wide(_dy_effective(dy, perch, dvar2, y, mean).to(x.dtype))
    e = e.permute(0, 3, 1, 2)
    pre, a = _prologue(x, scale, shift)
    wk = _w9_oihw(w9, c)
    da = torch.nn.grad.conv2d_input(
        (x.shape[0], c, x.shape[1], x.shape[2]), wk, e, padding=1)
    da = da.permute(0, 2, 3, 1)
    gated = torch.where(pre > 0, da, torch.zeros_like(da))
    dx = (gated * scale).to(x.dtype)
    axes = (0, 1, 2)
    dw = torch.nn.grad.conv2d_weight(_wide(a).permute(0, 3, 1, 2),
                                     wk.shape, e, padding=1)
    return (dx, dw.permute(2, 3, 1, 0).reshape(9 * c, o),
            (gated * _wide(x)).sum(axes), gated.sum(axes))


for _fn in (matmul_bn_stats_fwd_plain, bn_relu_matmul_bn_stats_fwd_plain,
            matmul_bn_stats_bwd_plain, bn_relu_matmul_bn_stats_bwd_plain,
            conv3x3_bn_stats_fwd_plain, conv3x3_bn_stats_bwd_plain):
    _fn.calls = 0


# ----------------------------------------------------------- kernels

def _check(x2, w2, scale=None, shift=None):
    if x2.dim() != 2 or w2.dim() != 2 or x2.shape[1] != w2.shape[0]:
        raise ValueError(f"x2 [M,K] and w2 [K,N] expected, got "
                         f"{tuple(x2.shape)} and {tuple(w2.shape)}")
    if x2.dtype != w2.dtype or x2.device != w2.device:
        raise TypeError(f"x2 ({x2.dtype}, {x2.device}) and w2 ({w2.dtype}, "
                        f"{w2.device}) differ")
    for name, t in (("scale", scale), ("shift", shift)):
        if t is not None and (tuple(t.shape) != (x2.shape[1],)
                              or t.device != x2.device):
            raise ValueError(f"{name} must be [{x2.shape[1]}] on "
                             f"{x2.device}, got {tuple(t.shape)} on "
                             f"{t.device}")
    if x2.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused ResNet ops run on CUDA or the CPU, got "
                         f"{x2.device}")


def _check_bwd(dy, y, x2, w2, perch, dvar2, mean):
    m, n = x2.shape[0], w2.shape[1]
    for name, t, shape in (("dy", dy, (m, n)), ("y", y, (m, n)),
                           ("perch", perch, (n,)), ("dvar2", dvar2, (n,)),
                           ("mean", mean, (n,))):
        if tuple(t.shape) != shape or t.device != x2.device:
            raise ValueError(f"{name} must be {list(shape)} on {x2.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
    if dy.dtype != x2.dtype or y.dtype != x2.dtype:
        raise TypeError(f"dy ({dy.dtype}) and y ({y.dtype}) must be "
                        f"{x2.dtype}")


def _kernel_inputs(named):
    """Contiguous copies (views when already contiguous) the kernels can
    read: 16-byte aligned rows of a dtype they take."""
    out = []
    for name, t in named:
        t = t.contiguous()
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
        out.append(t)
    return out


def _library():
    return _build.library("fused_resnet", _SIG)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _codes(x2, w2):
    m, k = x2.shape
    n = w2.shape[1]
    if x2.dtype not in _DTYPE_CODES:
        raise TypeError(f"the fused ResNet kernels take float32 or "
                        f"bfloat16, got {x2.dtype}")
    if k % 8 or n % 8:
        raise ValueError(f"the fused ResNet kernels take K and N in "
                         f"multiples of 8, got K={k}, N={n}")
    return _DTYPE_CODES[x2.dtype], m, k, n


def _f32(t):
    """``t`` as contiguous fp32 the kernels read 8 at a time (16-byte
    aligned: a misaligned view is copied)."""
    if t is None:
        return None
    t = t.float().contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _geometry():
    """The 1x1 kernels' tile geometry, as the built library exports it:
    (statistics row tile, dw tile rows of K, dw tile columns of N, dw
    row step)."""
    g = (ctypes.c_int * 4)()
    _library().paddle_mm_bn_stats_geometry(g)
    return tuple(g)


def route(dtype):
    """Which products ``paddle_mm_bn_stats`` and
    ``paddle_mm_bn_stats_bwd`` run for inputs of ``dtype`` on the card:
    ``"mma"``, the tensor cores (bfloat16), or ``"fma"``, the fp32 CUDA
    cores (float32), with one tile body for both. Asks the built
    ``csrc/fused_resnet.cu``."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"the fused ResNet kernels take float32 or "
                        f"bfloat16, got {dtype}")
    lib = _library()
    return "mma" if lib.paddle_mm_bn_stats_route(_DTYPE_CODES[dtype]) \
        else "fma"


def _launch_forward(x2, w2, scale, shift, what):
    code, m, k, n = _codes(x2, w2)
    x2, w = _kernel_inputs([("x2", x2), ("w2", w2)])
    scale, shift = _f32(scale), _f32(shift)
    lib = _library()
    tiles = -(-m // _geometry()[0])
    f32 = dict(dtype=torch.float32, device=x2.device)
    y = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    part = torch.empty((2, tiles, n), **f32)
    stats = torch.empty((2, n), **f32)
    with torch.cuda.device(x2.device):
        err = lib.paddle_mm_bn_stats(
            x2.data_ptr(), None if scale is None else scale.data_ptr(),
            None if shift is None else shift.data_ptr(), w.data_ptr(),
            y.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
            stats[0].data_ptr(), stats[1].data_ptr(), code,
            int(scale is not None), m, k, n, _stream(x2))
    _build.raise_on(err, what)
    return y, stats[0], stats[1]


def _dw_chunks(m, k, n, geometry):
    """(chunks, rows per chunk) of the dw kernel's split over M for the
    tile ``geometry`` (``_geometry()``): enough chunks to fill the card,
    each a whole number of row steps."""
    _, tile_k, tile_n, step = geometry
    tiles = -(-k // tile_k) * -(-n // tile_n)
    chunks = max(1, min(-(-_DW_BLOCKS // tiles), -(-m // 64)))
    rows = -(-m // chunks)
    rows = -(-rows // step) * step
    return -(-m // rows), rows


def _launch_backward(dy, y, x2, w2, perch, dvar2, mean, scale, shift, what):
    code, m, k, n = _codes(x2, w2)
    # w2^T is the conv weight's own [O, I] layout: no copy for the
    # transposed view the entry points pass
    dy, y, x2, wt = _kernel_inputs([("dy", dy), ("y", y), ("x2", x2),
                                    ("w2^T", w2.t())])
    perch, dvar2, mean = _f32(perch), _f32(dvar2), _f32(mean)
    scale, shift = _f32(scale), _f32(shift)
    pro = scale is not None
    lib = _library()
    geometry = _geometry()
    tiles = -(-m // geometry[0])
    chunks, rows = _dw_chunks(m, k, n, geometry)
    f32 = dict(dtype=torch.float32, device=x2.device)
    dx = torch.empty((m, k), dtype=x2.dtype, device=x2.device)
    dw = torch.empty((k, n), **f32)
    dw_part = torch.empty((chunks, k, n), **f32) if chunks > 1 else None
    dsd = torch.empty((2, k), **f32) if pro else None
    dsd_part = torch.empty((2, tiles, k), **f32) if pro else None

    def ptr(t, i=None):
        return None if t is None else (t if i is None else t[i]).data_ptr()

    with torch.cuda.device(x2.device):
        err = lib.paddle_mm_bn_stats_bwd(
            dy.data_ptr(), y.data_ptr(), x2.data_ptr(), ptr(scale),
            ptr(shift), wt.data_ptr(), perch.data_ptr(), dvar2.data_ptr(),
            mean.data_ptr(), dx.data_ptr(), dw.data_ptr(), ptr(dw_part),
            ptr(dsd, 0), ptr(dsd, 1), ptr(dsd_part, 0), ptr(dsd_part, 1),
            code, int(pro), m, k, n, chunks, rows, _stream(x2))
    _build.raise_on(err, what)
    return (dx, dw) if not pro else (dx, dw, dsd[0], dsd[1])


def matmul_bn_stats_fwd(x2, w2):
    """(y, mean, var) of x2 [M,K] @ w2 [K,N]: the kernel for CUDA tensors
    (``paddle_mm_bn_stats``), the plain version for CPU tensors."""
    _check(x2, w2)
    if x2.device.type == "cpu":
        return matmul_bn_stats_fwd_plain(x2, w2)
    out = _launch_forward(x2, w2, None, None, "mm_bn_stats")
    matmul_bn_stats_fwd.launches += 1
    return out


def bn_relu_matmul_bn_stats_fwd(x2, scale, shift, w2):
    """(y, mean, var) of relu(x2*scale + shift) @ w2, the activation never
    written: the prologue kernel for CUDA tensors, the plain version for
    CPU tensors."""
    _check(x2, w2, scale, shift)
    if x2.device.type == "cpu":
        return bn_relu_matmul_bn_stats_fwd_plain(x2, scale, shift, w2)
    out = _launch_forward(x2, w2, scale, shift, "bn_relu_mm_bn_stats")
    bn_relu_matmul_bn_stats_fwd.launches += 1
    return out


def matmul_bn_stats_bwd(dy, y, x2, w2, perch, dvar2, mean):
    """(dx, dw fp32) of ``matmul_bn_stats`` from dy and the per-channel
    coefficients of ``_stats_cotangent_coeffs``: the backward kernel for
    CUDA tensors (``paddle_mm_bn_stats_bwd``), the plain version for CPU
    tensors."""
    _check(x2, w2)
    _check_bwd(dy, y, x2, w2, perch, dvar2, mean)
    if x2.device.type == "cpu":
        return matmul_bn_stats_bwd_plain(dy, y, x2, w2, perch, dvar2, mean)
    out = _launch_backward(dy, y, x2, w2, perch, dvar2, mean, None, None,
                           "mm_bn_stats_bwd")
    matmul_bn_stats_bwd.launches += 1
    return out


def bn_relu_matmul_bn_stats_bwd(dy, y, x2, scale, shift, w2, perch, dvar2,
                                mean):
    """(dx, dw, dscale, dshift) of ``bn_relu_matmul_bn_stats``: the
    prologue backward kernel for CUDA tensors, the plain version for CPU
    tensors."""
    _check(x2, w2, scale, shift)
    _check_bwd(dy, y, x2, w2, perch, dvar2, mean)
    if x2.device.type == "cpu":
        return bn_relu_matmul_bn_stats_bwd_plain(dy, y, x2, scale, shift,
                                                 w2, perch, dvar2, mean)
    out = _launch_backward(dy, y, x2, w2, perch, dvar2, mean, scale, shift,
                           "bn_relu_mm_bn_stats_bwd")
    bn_relu_matmul_bn_stats_bwd.launches += 1
    return out


# ----------------------------------------------------------- 3x3 kernels

def _conv3x3_tiles(n, h, w):
    """(R, Wt, G, tiles): the 3x3 kernels' tiling of n images of h x w.
    A slab is R rows by Wt columns of one image (rows and columns split
    evenly), a tile G slabs of at most _PIX3 pixels and _WIN3 window
    positions ((R+2) x (Wt+2) a slab)."""
    wt = -(-w // -(-w // _PIX3))
    r = -(-h // -(-h // min(h, _PIX3 // wt)))
    slabs = n * -(-h // r) * -(-w // wt)
    g = min(_PIX3 // (r * wt), _WIN3 // ((r + 2) * (wt + 2)), slabs)
    return r, wt, g, -(-slabs // g)


def _dw3_chunks(tiles, c, o):
    """(chunks, tiles per chunk) of the 3x3 dw kernel's split over the
    pixel tiles: enough chunks to fill the card, their fp32 partials
    [chunks, 9C, O] within _DW3_SCRATCH bytes."""
    blocks = -(-c // _DW3_C) * -(-o // _DW3_O)
    chunks = max(1, min(tiles, _DW3_BLOCKS // blocks,
                        _DW3_SCRATCH // (36 * c * o)))
    per = -(-tiles // chunks)
    return -(-tiles // per), per


def _check3(x, w9, scale, shift):
    if x.dim() != 4 or w9.dim() != 2 or w9.shape[0] != 9 * x.shape[-1]:
        raise ValueError(f"x [N,H,W,C] and w9 [9C,O] expected, got "
                         f"{tuple(x.shape)} and {tuple(w9.shape)}")
    # w9's first tap [C, O] stands for the weight in the shared checks
    _check(x.flatten(0, 2), w9[:x.shape[-1]], scale, shift)


def _check_bwd3(dy, y, x, w9, perch, dvar2, mean):
    shape = (*x.shape[:3], w9.shape[1])
    for name, t in (("dy", dy), ("y", y)):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{tuple(t.shape)}")
    _check_bwd(dy.flatten(0, 2), y.flatten(0, 2), x.flatten(0, 2),
               w9[:x.shape[-1]], perch, dvar2, mean)


def _library3():
    return _build.library("fused_conv3x3", _SIG3)


def conv3x3_bn_stats_fwd(x, scale, shift, w9):
    """(y, mean, var) of relu(x*scale + shift) -> 3x3/s1 SAME conv with
    the tap-major w9 [9C, O], x NHWC: the kernel for CUDA tensors
    (``paddle_conv3x3_bn_stats``), the plain version for CPU tensors."""
    _check3(x, w9, scale, shift)
    if x.device.type == "cpu":
        return conv3x3_bn_stats_fwd_plain(x, scale, shift, w9)
    n, h, w, c = x.shape
    code, _, _, o = _codes(x.flatten(0, 2), w9[:c])
    x, w9 = _kernel_inputs([("x", x), ("w9", w9)])
    scale, shift = _f32(scale), _f32(shift)
    r, wt, g, tiles = _conv3x3_tiles(n, h, w)
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((n, h, w, o), dtype=x.dtype, device=x.device)
    part = torch.empty((2, tiles, o), **f32)
    count = torch.empty((tiles,), **f32)
    stats = torch.empty((2, o), **f32)
    with torch.cuda.device(x.device):
        err = _library3().paddle_conv3x3_bn_stats(
            x.data_ptr(), scale.data_ptr(), shift.data_ptr(), w9.data_ptr(),
            y.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
            count.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
            code, n, h, w, c, o, r, wt, g, _stream(x))
    _build.raise_on(err, "conv3x3_bn_stats")
    conv3x3_bn_stats_fwd.launches += 1
    return y, stats[0], stats[1]


def conv3x3_bn_stats_bwd(dy, y, x, scale, shift, w9, perch, dvar2, mean):
    """(dx, dw fp32 [9C, O], dscale, dshift) of ``conv3x3_bn_act_stats``
    from dy and the per-channel coefficients of
    ``_stats_cotangent_coeffs``: the backward kernels for CUDA tensors
    (``paddle_conv3x3_bn_stats_bwd``), the plain version for CPU
    tensors."""
    _check3(x, w9, scale, shift)
    _check_bwd3(dy, y, x, w9, perch, dvar2, mean)
    if x.device.type == "cpu":
        return conv3x3_bn_stats_bwd_plain(dy, y, x, scale, shift, w9, perch,
                                          dvar2, mean)
    n, h, w, c = x.shape
    code, _, _, o = _codes(x.flatten(0, 2), w9[:c])
    dy, y, x, w9 = _kernel_inputs([("dy", dy), ("y", y), ("x", x),
                                   ("w9", w9)])
    perch, dvar2, mean = _f32(perch), _f32(dvar2), _f32(mean)
    scale, shift = _f32(scale), _f32(shift)
    r, wt, g, tiles = _conv3x3_tiles(n, h, w)
    chunks, per = _dw3_chunks(tiles, c, o)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dw = torch.empty((9 * c, o), **f32)
    dw_part = torch.empty((chunks, 9 * c, o), **f32) if chunks > 1 else None
    dsd = torch.empty((2, c), **f32)
    dsd_part = torch.empty((2, tiles, c), **f32)
    with torch.cuda.device(x.device):
        err = _library3().paddle_conv3x3_bn_stats_bwd(
            dy.data_ptr(), y.data_ptr(), x.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), w9.data_ptr(), perch.data_ptr(),
            dvar2.data_ptr(), mean.data_ptr(), dx.data_ptr(), dw.data_ptr(),
            None if dw_part is None else dw_part.data_ptr(),
            dsd[0].data_ptr(), dsd[1].data_ptr(), dsd_part[0].data_ptr(),
            dsd_part[1].data_ptr(), code, n, h, w, c, o, r, wt, g, chunks,
            per, _stream(x))
    _build.raise_on(err, "conv3x3_bn_stats_bwd")
    conv3x3_bn_stats_bwd.launches += 1
    return dx, dw, dsd[0], dsd[1]


KERNEL_WRAPPERS = (matmul_bn_stats_fwd, bn_relu_matmul_bn_stats_fwd,
                   matmul_bn_stats_bwd, bn_relu_matmul_bn_stats_bwd,
                   conv3x3_bn_stats_fwd, conv3x3_bn_stats_bwd)
PLAIN_VERSIONS = (matmul_bn_stats_fwd_plain,
                  bn_relu_matmul_bn_stats_fwd_plain,
                  matmul_bn_stats_bwd_plain,
                  bn_relu_matmul_bn_stats_bwd_plain,
                  conv3x3_bn_stats_fwd_plain,
                  conv3x3_bn_stats_bwd_plain)


def reset_counts():
    """Zero every launch and plain-call counter."""
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    for fn in PLAIN_VERSIONS:
        fn.calls = 0


reset_counts()


# ----------------------------------------------------------- autograd

class _MatmulBnStatsFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, w2):
        y, mean, var = matmul_bn_stats_fwd(x2, w2)
        ctx.save_for_backward(x2, w2, y, mean)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x2, w2, y, mean = ctx.saved_tensors
        perch, dvar2 = _stats_cotangent_coeffs(dmean, dvar, x2.shape[0])
        dx, dw = matmul_bn_stats_bwd(dy.to(x2.dtype), y, x2, w2, perch,
                                     dvar2, mean)
        return dx, dw.to(w2.dtype)


class _BnReluMatmulBnStatsFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, scale, shift, w2):
        y, mean, var = bn_relu_matmul_bn_stats_fwd(x2, scale, shift, w2)
        ctx.save_for_backward(x2, scale, shift, w2, y, mean)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x2, scale, shift, w2, y, mean = ctx.saved_tensors
        perch, dvar2 = _stats_cotangent_coeffs(dmean, dvar, x2.shape[0])
        dx, dw, dscale, dshift = bn_relu_matmul_bn_stats_bwd(
            dy.to(x2.dtype), y, x2, scale, shift, w2, perch, dvar2, mean)
        return dx, dscale, dshift, dw.to(w2.dtype)


class _Conv3x3BnStatsFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, shift, w9):
        y, mean, var = conv3x3_bn_stats_fwd(x, scale, shift, w9)
        ctx.save_for_backward(x, scale, shift, w9, y, mean)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x, scale, shift, w9, y, mean = ctx.saved_tensors
        perch, dvar2 = _stats_cotangent_coeffs(dmean, dvar,
                                               math.prod(x.shape[:3]))
        dx, dw, dscale, dshift = conv3x3_bn_stats_bwd(
            dy.to(x.dtype), y, x, scale, shift, w9, perch, dvar2, mean)
        return dx, dscale, dshift, dw.to(w9.dtype)


def matmul_bn_stats(x2, w2):
    """y = x2 @ w2 plus the BN batch statistics of y in one pass over
    device memory. Returns (y [M,N], mean [N] fp32, var [N] fp32);
    differentiable in x2 and w2 through all three outputs."""
    return _MatmulBnStatsFn.apply(x2, w2)


def bn_relu_matmul_bn_stats(x2, scale, shift, w2):
    """a = relu(x2*scale + shift); y = a @ w2; plus the BN statistics of
    y. scale/shift are the previous BN folded (``bn_fold``), so the
    normalized activation is never written. Returns (y, mean, var)."""
    return _BnReluMatmulBnStatsFn.apply(x2, scale, shift, w2)


# ----------------------------------------------------------- BN applies

def _channel_axes(y):
    return tuple(range(y.dim() - 1))


def _gate(out, dout):
    return torch.where(out > 0, dout, torch.zeros((), dtype=dout.dtype,
                                                  device=dout.device))


class _BnApplyReluAdd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, scale, shift, identity):
        pre = (_wide(y) * scale + shift).to(y.dtype)
        out = torch.clamp_min(pre + identity, 0)
        ctx.save_for_backward(y, scale, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        y, scale, out = ctx.saved_tensors
        g = _gate(out, dout)
        gf, axes = _wide(g), _channel_axes(y)
        return ((gf * scale).to(y.dtype), (gf * _wide(y)).sum(axes),
                gf.sum(axes), g)


class _BnApplyRelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, scale, shift):
        out = torch.clamp_min((_wide(y) * scale + shift).to(y.dtype), 0)
        ctx.save_for_backward(y, scale, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        y, scale, out = ctx.saved_tensors
        gf, axes = _wide(_gate(out, dout)), _channel_axes(y)
        return ((gf * scale).to(y.dtype), (gf * _wide(y)).sum(axes),
                gf.sum(axes))


class _BnApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, scale, shift):
        ctx.save_for_backward(y, scale)
        return (_wide(y) * scale + shift).to(y.dtype)

    @staticmethod
    def backward(ctx, dout):
        y, scale = ctx.saved_tensors
        df, axes = _wide(dout), _channel_axes(y)
        return ((df * scale).to(y.dtype), (df * _wide(y)).sum(axes),
                df.sum(axes))


class _BnCenterApplyReluAdd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mean, scale, beta, identity):
        pre = ((_wide(y) - mean) * scale + beta).to(y.dtype)
        out = torch.clamp_min(pre + identity, 0)
        ctx.save_for_backward(y, mean, scale, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        y, mean, scale, out = ctx.saved_tensors
        g = _gate(out, dout)
        gf, axes = _wide(g), _channel_axes(y)
        dbeta = gf.sum(axes)
        return ((gf * scale).to(y.dtype), -dbeta * scale,
                (gf * (_wide(y) - mean)).sum(axes), dbeta, g)


class _BnCenterApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mean, scale, beta):
        ctx.save_for_backward(y, mean, scale)
        return ((_wide(y) - mean) * scale + beta).to(y.dtype)

    @staticmethod
    def backward(ctx, dout):
        y, mean, scale = ctx.saved_tensors
        df, axes = _wide(dout), _channel_axes(y)
        dbeta = df.sum(axes)
        return ((df * scale).to(y.dtype), -dbeta * scale,
                (df * (_wide(y) - mean)).sum(axes), dbeta)


class _BnMoments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        yf, axes = _wide(y), _channel_axes(y)
        mean = yf.mean(axes)
        # two-pass: E[y^2] - E[y]^2 cancels when |mean| >> std
        var = (yf - mean).square().mean(axes)
        ctx.save_for_backward(y, mean)
        return mean, var

    @staticmethod
    def backward(ctx, dmean, dvar):
        y, mean = ctx.saved_tensors
        rows = math.prod(y.shape[:-1])
        perch, dvar2 = _stats_cotangent_coeffs(dmean, dvar, rows)
        return (perch + dvar2 * (_wide(y) - mean)).to(y.dtype)


def bn_apply_relu_add(y, scale, shift, identity):
    """relu(bf16(y*scale + shift) + identity): the bottleneck block's
    closing apply with the residual branch ``identity``."""
    return _BnApplyReluAdd.apply(y, scale, shift, identity)


def bn_apply_relu(y, scale, shift):
    """relu(bf16(y*scale + shift)): the between-conv apply."""
    return _BnApplyRelu.apply(y, scale, shift)


def bn_apply(y, scale, shift):
    """bf16(y*scale + shift): the downsample-branch apply (no relu)."""
    return _BnApply.apply(y, scale, shift)


def bn_center_apply_relu_add(y, mean, scale, beta, identity):
    """relu(bf16((y - mean)*scale + beta) + identity): the closing apply
    in centered form (scale = gamma*rsqrt(var + eps), ``bn_fold``'s
    first output). Its backward takes dscale against the fp32-centered
    y, so the gamma gradient has no cancelling dscale - mean*dshift."""
    return _BnCenterApplyReluAdd.apply(y, mean, scale, beta, identity)


def bn_center_apply(y, mean, scale, beta):
    """bf16((y - mean)*scale + beta): the downsample-branch apply in
    centered form."""
    return _BnCenterApply.apply(y, mean, scale, beta)


def bn_moments(y):
    """Channel-last batch mean and var (fp32), saving only the input."""
    return _BnMoments.apply(y)


def bn_fold(gamma, beta, mean, var, epsilon):
    """BN (gamma, beta, batch mean/var) folded into per-channel fp32
    (scale, shift): bn(y) = y*scale + shift."""
    g = gamma.float() if gamma is not None else 1.0
    b = beta.float() if beta is not None else 0.0
    scale = g * torch.rsqrt(var.float() + epsilon)
    return scale, b - mean.float() * scale


# ----------------------------------------------------------- NHWC entries

def conv1x1_bn_stats(x, weight, stride=1):
    """1x1 conv of NHWC ``x`` (Paddle weight layout [O, I, 1, 1]) plus
    the BN batch statistics of its output. A stride takes
    ``x[:, ::s, ::s]`` as a contiguous copy first. Returns (y, mean,
    var)."""
    o, i = weight.shape[0], weight.shape[1]
    w2 = weight.reshape(o, i).t().to(x.dtype)
    if stride != 1:
        x = x[:, ::stride, ::stride, :].contiguous()
    shp = x.shape
    y2, mean, var = matmul_bn_stats(x.reshape(-1, shp[-1]), w2)
    return y2.reshape(*shp[:-1], o), mean, var


def bn_relu_conv1x1_bn_stats(x, scale, shift, weight):
    """relu(x*scale + shift) -> 1x1 conv (NHWC) -> BN statistics of the
    output, without writing the normalized activation."""
    o, i = weight.shape[0], weight.shape[1]
    w2 = weight.reshape(o, i).t().to(x.dtype)
    shp = x.shape
    y2, mean, var = bn_relu_matmul_bn_stats(x.reshape(-1, shp[-1]), scale,
                                            shift, w2)
    return y2.reshape(*shp[:-1], o), mean, var


def conv3x3_vmem_ok(h, w, c, o, itemsize=2, budget=14 * 2 ** 20):
    """Whether the JAX package routes a fused stride-1 block's 3x3 through
    its fused kernel pair: the TPU backward's VMEM footprint for one image
    (two halo windows, the fp32 dw accumulator, fp32 temporaries and the
    double-buffered blocks) within 14 MiB. The port keeps the reference's
    route with it; it is no limit of the CUDA kernels, which tile any
    image."""
    halo = (h + 2) * (w + 2)
    img = h * w
    windows = itemsize * halo * (o + c)
    dw_acc = 4 * 9 * c * o
    temps = 4 * img * (o + c)
    streams = 2 * itemsize * img * (2 * o + 2 * c)
    return windows + dw_acc + temps + streams < budget


def conv3x3_bn_act_stats(x, scale, shift, w9):
    """relu(x*scale + shift) -> 3x3 SAME conv (NHWC, stride 1) -> BN batch
    statistics of the output, the normalized activation never written.
    w9 is the tap-major [9C, O] weight (rows (dh*3+dw)*C ... +C hold tap
    (dh, dw)). Returns (y, mean [O] fp32, var [O] fp32); differentiable
    in x, scale, shift and w9 through all three outputs."""
    return _Conv3x3BnStatsFn.apply(x, scale, shift, w9)


def bn_relu_conv3x3_bn_stats(x, scale, shift, weight):
    """relu(x*scale + shift) -> 3x3/s1 SAME conv (NHWC, Paddle weight
    layout [O, I, 3, 3]) -> BN statistics of the output: the fused middle
    of a stride-1 bottleneck block. Returns (y, mean, var)."""
    o, i = weight.shape[0], weight.shape[1]
    w9 = weight.permute(2, 3, 1, 0).reshape(9 * i, o).to(x.dtype)
    return conv3x3_bn_act_stats(x, scale, shift, w9)
