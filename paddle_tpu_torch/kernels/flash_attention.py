"""Flash attention for training, prefill and decode: CUDA kernels for
Hopper and their plain PyTorch versions.

``flash_attention`` (training and prefill), ``flash_attention_decode``
(one decode step's 1..8 query rows against the KV cache),
``flash_attention_chunk`` (a chunked-prefill window of any length
against the cache) and ``flash_attention_decode_paged`` (a decode step
against a paged cache) launch the kernels in ``csrc/flash_fwd.cu``,
``csrc/flash_decode.cu`` and ``csrc/flash_decode_paged.cu`` for tensors
on a CUDA card and run the plain versions beside them for tensors on
the CPU. When an input requires a gradient, ``flash_attention`` goes
through ``_FlashAttentionFn``, whose backward is ``flash_attention_bwd``
(``csrc/flash_bwd.cu`` on a card).
Nothing else picks a plain version: on the card a kernel either
launches or raises. Each wrapper counts its launches in a plain integer
attribute (``flash_attention.launches``), each plain version its calls
(``flash_attention_plain.calls``), so a run can show which path it
took. ``route(dtype, d)`` says which kernels the forward and backward
take on the card: the tensor-core ones for bfloat16 and float16 at
head_dim <= 128 (``"mma"``), the fp32 CUDA-core ones otherwise
(``"fma"``); ``chunk_route(dtype, d)`` says the same of the chunk
kernel. The wrappers take the head dims in ``KERNEL_HEAD_DIMS`` and
raise on others; ``decode_xla``, the JAX package's XLA decode path, is
the route the callers (``generation.attention.cached_attention``) take
for those, before any launch.

Layouts are the JAX package's public ones: ``[batch, seq, heads,
head_dim]`` for queries, keys and values, ``[batch, max_len, kv_heads,
head_dim]`` for one layer's cache, ``[n_pages, page_size, kv_heads,
head_dim]`` for one layer's page pool with ``page_table [batch,
pages_per_row]`` int32. Inputs are read through their strides (only
head_dim must be contiguous), so views of a fused qkv projection or a
layer slice of the cache or pool cost no copy.

The three decode-shaped functions also take an int8 cache or pool
(``QuantKVCache``, ``QuantPagedKVCache``) with its bf16 ``k_scale`` /
``v_scale`` ([batch, max_len, kv_heads], or [n_pages, page_size,
kv_heads] for a pool): the dequantisation fuses into the kernel (the
key scale multiplies each score column, the value scale each softmax
weight), so the cache streams at half the bytes and is never widened.
Their int8 launches and plain calls count under their own names
(``flash_attention_decode.launches_int8``,
``flash_attention_decode_plain.calls_int8``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

#: the decode kernel's query window (a speculative verify window of k
#: draft tokens + 1 must fit in it), as in the JAX package
MAX_DECODE_QLEN = 8
#: head dims the kernels are instantiated for
KERNEL_HEAD_DIMS = (16, 32, 64, 128, 256)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_P = ctypes.c_void_p
_I = ctypes.c_int
_STRIDES = ctypes.POINTER(ctypes.c_int64)
_FWD_SIG = {"paddle_flash_fwd": (_I, (
    _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _STRIDES, _I,
    ctypes.c_float, _P)), "paddle_flash_route": (_I, (_I, _I))}
_DECODE_ARGS = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _STRIDES,
                ctypes.c_float, _P)
# the int8 entries take the two scale pointers after k and v
_DECODE_INT8_ARGS = _DECODE_ARGS[:3] + (_P, _P) + _DECODE_ARGS[3:]
_DECODE_SIG = {"paddle_flash_decode": (_I, _DECODE_ARGS),
               "paddle_flash_chunk": (_I, _DECODE_ARGS),
               "paddle_flash_chunk_route": (_I, (_I, _I)),
               "paddle_flash_decode_int8": (_I, _DECODE_INT8_ARGS),
               "paddle_flash_chunk_int8": (_I, _DECODE_INT8_ARGS)}
_PAGED_ARGS = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
               _STRIDES, ctypes.c_float, _P)
_PAGED_SIG = {"paddle_flash_decode_paged": (_I, _PAGED_ARGS),
              "paddle_flash_decode_paged_int8": (
                  _I, _PAGED_ARGS[:3] + (_P, _P) + _PAGED_ARGS[3:])}
_BWD_SIG = {"paddle_flash_bwd": (_I, (
    _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
    _STRIDES, _I, ctypes.c_float, _P))}


# ------------------------------------------------------------- checks

def _check_4d(name, t, dims=None):
    if t.dim() != 4:
        raise ValueError(f"{name} must be 4-D, got shape {tuple(t.shape)}")
    if dims is not None and t.shape[-1] != dims:
        raise ValueError(f"{name} head_dim {t.shape[-1]} != {dims}")


def _same_device_dtype(named, dtype=True):
    ref_name, ref = named[0]
    for name, t in named[1:]:
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, {ref_name} on "
                             f"{ref.device}")
        if dtype and t.dtype != ref.dtype:
            raise TypeError(f"{name} is {t.dtype}, {ref_name} is "
                            f"{ref.dtype}")


def _check_kernel_type(dtype, head_dim):
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"flash attention kernels take float32, bfloat16 "
                        f"or float16, got {dtype}")
    if head_dim not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f"head_dim {head_dim}: the CUDA kernels are built for "
            f"{KERNEL_HEAD_DIMS}")


def _kernel_args(named, head_dim):
    """dtype code plus the (batch, seq, head) strides of every tensor;
    raises on what the kernels do not take."""
    ref = named[0][1]
    _check_kernel_type(ref.dtype, head_dim)
    strides = []
    for name, t in named:
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous head_dim "
                             f"(stride {t.stride(-1)})")
        strides += list(t.stride()[:3])
    return _DTYPE_CODES[ref.dtype], (ctypes.c_int64 * len(strides))(
        *strides)


def route(dtype, d):
    """Which kernels ``flash_attention`` and ``flash_attention_bwd`` run
    for inputs of ``dtype`` at head_dim ``d`` on the card: ``"mma"``,
    the tensor-core kernels (bfloat16 and float16 at head_dim <= 128),
    or ``"fma"``, the fp32 CUDA-core kernels (float32, and head_dim
    256). Asks the built ``csrc/flash_fwd.cu``, whose entry points make
    the same choice before they launch."""
    _check_kernel_type(dtype, d)
    lib = _build.library("flash_fwd", _FWD_SIG)
    return "mma" if lib.paddle_flash_route(_DTYPE_CODES[dtype], d) else "fma"


def chunk_route(dtype, d):
    """Which kernel ``flash_attention_chunk`` runs for queries of
    ``dtype`` at head_dim ``d`` on the card (wide or int8 cache alike):
    ``"mma"``, the tensor-core chunk kernel (bfloat16 and float16 at
    head_dim <= 128), or ``"fma"``, the shared fp32 body of the decode
    kernels (float32, and head_dim 256). Asks the built
    ``csrc/flash_decode.cu``, whose chunk entries make the same choice
    before they launch."""
    _check_kernel_type(dtype, d)
    lib = _build.library("flash_decode", _DECODE_SIG)
    return "mma" if lib.paddle_flash_chunk_route(_DTYPE_CODES[dtype], d) \
        else "fma"


# -------------------------------------------------------------- prefill

def _wide(t):
    """``t`` in fp32, or float64 when it already is (so a float64
    gradcheck sees float64 arithmetic)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def flash_attention_plain(query, key, value, causal: bool = False,
                          scale: Optional[float] = None,
                          return_lse: bool = False):
    """Plain version of the forward kernel: masked softmax attention in
    fp32 (float64 inputs stay float64), output in the query's dtype. Causal masking aligns the
    diagonal bottom-right (key column c is visible to query row r iff
    c <= r + sk - sq); fully masked rows give zeros. Grouped-query
    attention maps query head h to kv head h // (hq // hk). With
    ``return_lse`` also returns the natural-log logsumexp of each row's
    scaled scores, [batch, heads, sq] fp32 (-inf for fully masked
    rows)."""
    flash_attention_plain.calls += 1
    b, sq, hq, d = query.shape
    sk, hk = key.shape[1], key.shape[2]
    g = hq // hk
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    qf = _wide(query).reshape(b, sq, hk, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, _wide(key)) * scale
    if causal:
        rows = torch.arange(sq, device=query.device)[:, None]
        cols = torch.arange(sk, device=query.device)[None, :]
        s = s.masked_fill(cols > rows + (sk - sq), float("-inf"))
    out = _softmax_pv(s, value, "bhgqk,bkhd->bqhgd")
    out = out.reshape(b, sq, hq, d).to(query.dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(s, dim=-1).reshape(b, hq, sq)


flash_attention_plain.calls = 0


def _softmax_pv(s, value, pv_eq, v_scale=None):
    """fp32 softmax of masked scores (-inf = masked) times V; rows with
    no visible column give zeros. ``v_scale`` (broadcast against the
    softmax weights, one per column) dequantises an int8 V by scaling
    the normalised weights, as the JAX package's fallback does."""
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l == 0, torch.ones_like(l), l)
    if v_scale is not None:
        p = p * v_scale
    return torch.einsum(pv_eq, p, _wide(value))


def _check_attention(query, key, value):
    """Shapes, devices and dtypes the forward takes; returns the named
    inputs."""
    _check_4d("query", query)
    _check_4d("key", key, query.shape[-1])
    _check_4d("value", value, query.shape[-1])
    b, hq = query.shape[0], query.shape[2]
    if key.shape[0] != b or value.shape != key.shape:
        raise ValueError(f"key {tuple(key.shape)} / value "
                         f"{tuple(value.shape)} do not match query "
                         f"{tuple(query.shape)}")
    if hq % key.shape[2]:
        raise ValueError(f"q heads {hq} not divisible by kv heads "
                         f"{key.shape[2]}")
    named = [("query", query), ("key", key), ("value", value)]
    _same_device_dtype(named)
    return named


def _forward(query, key, value, causal, scale, return_lse):
    """The forward on checked inputs: the kernel for CUDA tensors, the
    plain version for CPU tensors. Same signature as
    ``flash_attention_plain``."""
    if query.device.type == "cpu":
        return flash_attention_plain(query, key, value, causal, scale,
                                     return_lse)
    if query.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or the CPU, got "
                         f"{query.device}")
    b, sq, hq, d = query.shape
    sk, hk = key.shape[1], key.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    out = torch.empty((b, sq, hq, d), dtype=query.dtype,
                      device=query.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32,
                      device=query.device) if return_lse else None
    named = [("query", query), ("key", key), ("value", value)]
    code, strides = _kernel_args(named + [("out", out)], d)
    lib = _build.library("flash_fwd", _FWD_SIG)
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        err = lib.paddle_flash_fwd(
            query.data_ptr(), key.data_ptr(), value.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(), code,
            b, hq, hk, sq, sk, d, strides, int(bool(causal)), scale, stream)
    _build.raise_on(err, "flash_fwd")
    flash_attention.launches += 1
    return out if lse is None else (out, lse)


class _FlashAttentionFn(torch.autograd.Function):
    """Differentiable flash attention (the JAX package's ``_flash_bhsd``
    custom VJP). The forward keeps q, k, v, the output and the
    natural-log LSE; the backward is ``flash_attention_bwd``: the CUDA
    kernel on a card, the plain version on the CPU."""

    @staticmethod
    def forward(ctx, query, key, value, causal, scale):
        out, lse = _forward(query, key, value, causal, scale, True)
        ctx.save_for_backward(query, key, value, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        query, key, value, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(query, key, value, out, lse,
                                         dout.contiguous(), ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(query, key, value, causal: bool = False,
                    scale: Optional[float] = None,
                    return_lse: bool = False):
    """Flash attention over ``[batch, seq, heads, head_dim]`` inputs
    (self or cross length, causal or not, grouped-query heads). Any
    sequence lengths are taken: the kernel masks the ragged key and
    query tails itself. ``return_lse`` also returns each row's
    natural-log logsumexp ([batch, heads, sq] fp32). When grad mode is
    on and an input requires a gradient, the call records
    ``_FlashAttentionFn`` (which keeps the LSE for its backward);
    otherwise, as in serving, nothing is saved and no LSE is written
    unless asked for."""
    _check_attention(query, key, value)
    if torch.is_grad_enabled() and (query.requires_grad or key.requires_grad
                                    or value.requires_grad):
        out, lse = _FlashAttentionFn.apply(query, key, value, bool(causal),
                                           scale)
        return (out, lse) if return_lse else out
    return _forward(query, key, value, causal, scale, return_lse)


flash_attention.launches = 0


# ------------------------------------------------------------- backward

def flash_attention_bwd_plain(query, key, value, out, lse, dout,
                              causal: bool = False,
                              scale: Optional[float] = None):
    """Plain version of the backward kernel, with its explicit fp32
    formulas over the whole score matrix (no autograd): P = exp(S - lse)
    (0 where masked or lse = -inf), dV = P^T dO, dP = dO V^T,
    dS = P (dP - rowsum(dO O)), dQ = dS K scale, dK = dS^T Q scale.
    Grouped-query gradients of one kv head sum over its query heads.
    Returns (dq, dk, dv) in the inputs' dtypes."""
    flash_attention_bwd_plain.calls += 1
    b, sq, hq, d = query.shape
    sk, hk = key.shape[1], key.shape[2]
    g = hq // hk
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    qf = _wide(query).reshape(b, sq, hk, g, d)
    dof = _wide(dout).reshape(b, sq, hk, g, d)
    kf, vf = _wide(key), _wide(value)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    lse5 = _wide(lse).reshape(b, hk, g, sq, 1)
    ok = torch.isfinite(lse5).expand_as(s)
    if causal:
        rows = torch.arange(sq, device=query.device)[:, None]
        cols = torch.arange(sk, device=query.device)[None, :]
        ok = ok & (cols <= rows + (sk - sq))
    p = torch.exp(torch.where(ok, s - lse5, float("-inf")))
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    delta = (dof * _wide(out).reshape(b, sq, hk, g, d)).sum(-1)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf) * scale
    return (dq.reshape(b, sq, hq, d).to(query.dtype), dk.to(key.dtype),
            dv.to(value.dtype))


flash_attention_bwd_plain.calls = 0


def flash_attention_bwd(query, key, value, out, lse, dout,
                        causal: bool = False,
                        scale: Optional[float] = None):
    """Gradients (dq, dk, dv) of ``flash_attention`` from the forward's
    output ``out``, its natural-log ``lse`` [batch, heads, sq] fp32 and
    the output's cotangent ``dout``; same layouts, masking and head
    grouping as the forward. A CUDA tensor goes to the kernel of
    ``csrc/flash_bwd.cu`` (delta = rowsum(dO O) is one fp32 torch
    reduction beside it), a CPU tensor to the plain version."""
    named = _check_attention(query, key, value)
    b, sq, hq, d = query.shape
    for name, t in (("out", out), ("dout", dout)):
        if tuple(t.shape) != tuple(query.shape):
            raise ValueError(f"{name} {tuple(t.shape)} != query "
                             f"{tuple(query.shape)}")
    if tuple(lse.shape) != (b, hq, sq):
        raise ValueError(f"lse must be [batch, heads, sq]={(b, hq, sq)}, "
                         f"got {tuple(lse.shape)}")
    named += [("out", out), ("dout", dout)]
    _same_device_dtype(named)
    _same_device_dtype([("query", query), ("lse", lse)], dtype=False)
    if query.device.type == "cpu":
        return flash_attention_bwd_plain(query, key, value, out, lse, dout,
                                         causal, scale)
    if query.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on CUDA or the CPU, "
                         f"got {query.device}")
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise TypeError(f"lse must be a contiguous float32 tensor, got "
                        f"{lse.dtype}")
    sk, hk = key.shape[1], key.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2) \
        .contiguous()                                     # [b, hq, sq]
    dq = torch.empty(query.shape, dtype=query.dtype, device=query.device)
    dk = torch.empty(key.shape, dtype=key.dtype, device=key.device)
    dv = torch.empty(key.shape, dtype=key.dtype, device=key.device)
    code, strides = _kernel_args(
        named[:3] + [("dout", dout), ("dq", dq), ("dk", dk), ("dv", dv)], d)
    lib = _build.library("flash_bwd", _BWD_SIG)
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        err = lib.paddle_flash_bwd(
            query.data_ptr(), key.data_ptr(), value.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), code, b, hq, hk,
            sq, sk, d, strides, int(bool(causal)), scale, stream)
    _build.raise_on(err, "flash_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


# --------------------------------------------------------------- decode

def _column_scales(sc):
    """[batch, t, kv_heads] scales as fp32 [batch, kv_heads, 1, 1, t],
    broadcast against the "bhgqk" scores."""
    return sc.float().permute(0, 2, 1)[:, :, None, None, :]


def _decode_math(query, key_cache, value_cache, kv_len, scale,
                 k_scale=None, v_scale=None):
    """Query row i of batch row b attends cache columns c <= kv_len[b] -
    sq + i, in fp32, output in the query's dtype; rows with no visible
    column give zeros. The arithmetic of every plain decode-shaped
    version (dense, chunk, paged). With ``k_scale``/``v_scale`` (an int8
    cache) it is the JAX package's fused-dequant fallback
    (``_decode_xla``): scores scaled per column by ``k_scale`` before the
    mask, the softmax normalised over the unscaled weights, then
    ``(p * v_scale) @ v_int8`` in fp32."""
    b, sq, hq, d = query.shape
    t, hk = key_cache.shape[1], key_cache.shape[2]
    g = hq // hk
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    qf = query.float().reshape(b, sq, hk, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, key_cache.float()) * scale
    if k_scale is not None:
        s = s * _column_scales(k_scale)
    rows = torch.arange(sq, device=query.device)[None, :, None]
    cols = torch.arange(t, device=query.device)[None, None, :]
    lim = kv_len.to(device=query.device, dtype=torch.int64)
    visible = cols - rows <= (lim - sq)[:, None, None]       # [b, sq, t]
    s = s.masked_fill(~visible[:, None, None], float("-inf"))
    out = _softmax_pv(s, value_cache, "bhgqk,bkhd->bqhgd",
                      None if v_scale is None else _column_scales(v_scale))
    return out.reshape(b, sq, hq, d).to(query.dtype)


def _count_plain(fn, k_scale):
    if k_scale is None:
        fn.calls += 1
    else:
        fn.calls_int8 += 1


def flash_attention_decode_plain(query, key_cache, value_cache, kv_len,
                                 scale: Optional[float] = None, *,
                                 k_scale=None, v_scale=None):
    """Plain version of the decode kernel: query row i of batch row b
    attends cache columns c <= kv_len[b] - sq + i, in fp32, output in
    the query's dtype. Rows with no visible column give zeros. With
    ``k_scale``/``v_scale`` the plain version of its int8 mode."""
    _count_plain(flash_attention_decode_plain, k_scale)
    return _decode_math(query, key_cache, value_cache, kv_len, scale,
                        k_scale, v_scale)


flash_attention_decode_plain.calls = 0
flash_attention_decode_plain.calls_int8 = 0


def flash_attention_chunk_plain(query, key_cache, value_cache, kv_len,
                                scale: Optional[float] = None, *,
                                k_scale=None, v_scale=None):
    """Plain version of the chunk kernel: the decode plain version's
    arithmetic for a window of any length (int8 mode included)."""
    _count_plain(flash_attention_chunk_plain, k_scale)
    return _decode_math(query, key_cache, value_cache, kv_len, scale,
                        k_scale, v_scale)


flash_attention_chunk_plain.calls = 0
flash_attention_chunk_plain.calls_int8 = 0

#: the JAX package's masking constant in ``_decode_xla``: large-negative
#: instead of -inf, so a row with no visible column averages every
#: column instead of giving zeros (the kernels give zeros)
_NEG_INF = -1e30


def decode_xla(query, key_cache, value_cache, kv_len,
               scale: Optional[float] = None, *, k_scale=None, v_scale=None,
               page_table=None):
    """The JAX package's XLA decode path (``_decode_xla``), in plain
    PyTorch, for the head dims the kernels are not built for: the route
    ``flash_attention_decode``, ``flash_attention_chunk`` and
    ``flash_attention_decode_paged`` take there, on every device. Not a
    kernel's plain version: ``cached_attention`` dispatches to it on
    ``head_dim not in KERNEL_HEAD_DIMS`` before any launch, and it counts
    its own calls (``decode_xla.calls``).

    Layouts and masking are the decode functions' (query row i of batch
    row b attends columns ``<= kv_len[b] - q_len + i``, grouped heads by
    index). With ``page_table`` the caches are page pools, gathered into
    the logical rows first, as the reference's paged fallback does.
    Numerics are the reference's: fp32 scores, masked with -1e30; the
    softmax weights rounded to the cache's dtype before ``p @ v`` in that
    dtype; an int8 cache scales the score columns by ``k_scale`` and the
    normalised weights by ``v_scale`` before ``p @ v`` in fp32; the
    output in the query's dtype."""
    decode_xla.calls += 1
    b, sq, hq, d = query.shape
    if page_table is not None:
        n_slots = page_table.shape[1]
        ps, hk = key_cache.shape[1], key_cache.shape[2]
        idx = page_table.to(device=key_cache.device, dtype=torch.long)
        key_cache = key_cache[idx].reshape(b, n_slots * ps, hk, d)
        value_cache = value_cache[idx].reshape(b, n_slots * ps, hk, d)
        if k_scale is not None:
            k_scale = k_scale[idx].reshape(b, n_slots * ps, hk)
            v_scale = v_scale[idx].reshape(b, n_slots * ps, hk)
    t, hk = key_cache.shape[1], key_cache.shape[2]
    g = hq // hk
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    qf = query.float().reshape(b, sq, hk, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, key_cache.float()) * scale
    if k_scale is not None:
        s = s * _column_scales(k_scale)
    rows = torch.arange(sq, device=query.device)[None, :, None]
    cols = torch.arange(t, device=query.device)[None, None, :]
    lim = kv_len.to(device=query.device, dtype=torch.int64)
    visible = cols - rows <= (lim - sq)[:, None, None]       # [b, sq, t]
    s = torch.where(visible[:, None, None], s, _NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l == 0, torch.ones_like(l), l)
    if v_scale is not None:
        out = torch.einsum("bhgqk,bkhd->bqhgd", p * _column_scales(v_scale),
                           value_cache.float())
    else:
        out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(value_cache.dtype),
                           value_cache)
    return out.reshape(b, sq, hq, d).to(query.dtype)


decode_xla.calls = 0


def _check_cache_dtypes(named):
    """Devices of the query and its cache (or pool) tensors; the caches
    share one dtype, which is the query's unless it is int8. Returns
    True for an int8 cache."""
    _same_device_dtype(named, dtype=False)
    _same_device_dtype(named[1:])
    int8 = named[1][1].dtype == torch.int8
    if not int8:
        _same_device_dtype(named)
    return int8


def _check_scales(fn, query, k_scale, v_scale, shape):
    """The int8 cache's scale pair: both given (else the JAX package's
    ValueError), of ``shape``, on the query's device; a kernel launch
    also needs them in bfloat16."""
    if k_scale is None or v_scale is None:
        if fn.endswith("_paged"):
            raise ValueError(
                "flash_attention_decode_paged: int8 pools need "
                "k_scale/v_scale ([n_pages, page_size, kv_heads] — the "
                "QuantPagedKVCache sidecars); an unscaled int8 pool cannot "
                "be dequantized")
        raise ValueError(
            f"{fn}: int8 caches need k_scale/v_scale "
            "([batch, max_len, kv_heads] — the QuantKVCache sidecars); "
            "an unscaled int8 cache cannot be dequantized")
    for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
        if tuple(sc.shape) != tuple(shape):
            raise ValueError(f"{fn}: {name} must be {tuple(shape)}, got "
                             f"{tuple(sc.shape)}")
        _same_device_dtype([("query", query), (name, sc)], dtype=False)
        if query.device.type == "cuda" and sc.dtype != torch.bfloat16:
            raise TypeError(f"{fn}: {name} must be bfloat16 on the card, "
                            f"got {sc.dtype}")


def _check_decode(query, key_cache, value_cache, kv_len):
    """Shapes, devices and dtypes of a dense decode-shaped call; returns
    the named tensors and whether the cache is int8."""
    _check_4d("query", query)
    _check_4d("key_cache", key_cache, query.shape[-1])
    _check_4d("value_cache", value_cache, query.shape[-1])
    b, hq = query.shape[0], query.shape[2]
    if key_cache.shape[0] != b or value_cache.shape != key_cache.shape:
        raise ValueError(f"caches {tuple(key_cache.shape)} / "
                         f"{tuple(value_cache.shape)} do not match query "
                         f"{tuple(query.shape)}")
    if hq % key_cache.shape[2]:
        raise ValueError(f"q heads {hq} not divisible by kv heads "
                         f"{key_cache.shape[2]}")
    _check_kv_len(query, kv_len)
    named = [("query", query), ("key_cache", key_cache),
             ("value_cache", value_cache)]
    return named, _check_cache_dtypes(named)


def _check_kv_len(query, kv_len):
    b = query.shape[0]
    if tuple(kv_len.shape) != (b,):
        raise ValueError(f"kv_len must be [batch]={b}, got "
                         f"{tuple(kv_len.shape)}")
    _same_device_dtype([("query", query), ("kv_len", kv_len)], dtype=False)


def _check_int32(name, t):
    if t.dtype != torch.int32 or not t.is_contiguous():
        raise TypeError(f"{name} must be a contiguous int32 tensor, got "
                        f"{t.dtype}")


def _scale_args(scales, strides):
    """The int8 entries' extra arguments: the two scale pointers, and
    the strides with each scale tensor's three appended."""
    if scales is None:
        return [], strides
    ks, vs = scales
    st = list(strides) + list(ks.stride()) + list(vs.stride())
    return [ks.data_ptr(), vs.data_ptr()], (ctypes.c_int64 * len(st))(*st)


def _launch_dense(entry, query, key_cache, value_cache, kv_len, scale,
                  named, scales=None):
    """Launch ``entry`` of ``csrc/flash_decode.cu`` (its ``_int8`` twin
    when ``scales`` is the (k_scale, v_scale) pair) on checked CUDA
    tensors; returns the output."""
    _check_int32("kv_len", kv_len)
    b, sq, hq, d = query.shape
    t, hk = key_cache.shape[1], key_cache.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    out = torch.empty((b, sq, hq, d), dtype=query.dtype,
                      device=query.device)
    code, strides = _kernel_args(named + [("out", out)], d)
    sc_ptrs, strides = _scale_args(scales, strides)
    if scales is not None:
        entry += "_int8"
    lib = _build.library("flash_decode", _DECODE_SIG)
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        err = getattr(lib, entry)(
            query.data_ptr(), key_cache.data_ptr(), value_cache.data_ptr(),
            *sc_ptrs, kv_len.data_ptr(), out.data_ptr(), code, b, sq, hq,
            hk, t, d, strides, scale, stream)
    _build.raise_on(err, entry)
    return out


def _on_card(query, name):
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if query.device.type == "cpu":
        return False
    if query.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or the CPU, got "
                         f"{query.device}")
    return True


def _dense_scales(fn, query, key_cache, k_scale, v_scale, int8):
    """(k_scale, v_scale) of an int8 dense cache, checked; None for a
    wide cache (whose scales, if any, are ignored, as in the JAX
    package)."""
    if not int8:
        return None
    b, t, hk = key_cache.shape[:3]
    _check_scales(fn, query, k_scale, v_scale, (b, t, hk))
    return k_scale, v_scale


def flash_attention_decode(query, key_cache, value_cache, kv_len,
                           scale: Optional[float] = None, *,
                           k_scale=None, v_scale=None):
    """Decode-shaped attention: ``query`` [batch, q_len<=8, heads,
    head_dim] against one layer's cache ``key_cache``/``value_cache``
    [batch, max_len, kv_heads, head_dim] (new tokens already written),
    with ``kv_len`` [batch] int32 valid entries per row INCLUDING the
    q_len new positions. Query row i attends columns
    ``<= kv_len - q_len + i``. The cache is read in place through its
    strides and never repeated for grouped-query heads.

    Int8 cache mode: with ``key_cache``/``value_cache`` int8 pass
    ``k_scale``/``v_scale`` ([batch, max_len, kv_heads], the
    ``QuantKVCache`` sidecars); the dequantisation fuses into the
    kernel, which streams half the bytes."""
    named, int8 = _check_decode(query, key_cache, value_cache, kv_len)
    if query.shape[1] > MAX_DECODE_QLEN:
        raise ValueError(
            f"flash_attention_decode: q_len {query.shape[1]} > "
            f"MAX_DECODE_QLEN ({MAX_DECODE_QLEN}); use "
            "flash_attention_chunk for longer query windows")
    scales = _dense_scales("flash_attention_decode", query, key_cache,
                           k_scale, v_scale, int8)
    if not _on_card(query, "flash_attention_decode"):
        return flash_attention_decode_plain(
            query, key_cache, value_cache, kv_len, scale,
            **_scale_kw(scales))
    out = _launch_dense("paddle_flash_decode", query, key_cache,
                        value_cache, kv_len, scale, named, scales)
    _count_launch(flash_attention_decode, scales)
    return out


flash_attention_decode.launches = 0
flash_attention_decode.launches_int8 = 0


def _scale_kw(scales):
    return {} if scales is None else dict(k_scale=scales[0],
                                          v_scale=scales[1])


def _count_launch(fn, scales):
    if scales is None:
        fn.launches += 1
    else:
        fn.launches_int8 += 1


def flash_attention_chunk(query, key_cache, value_cache, kv_len,
                          scale: Optional[float] = None, *,
                          k_scale=None, v_scale=None):
    """Chunk-prefill attention: ``flash_attention_decode``'s contract
    without the 8-row cap, for the serving engine's chunked prefill (a
    C-token window of a long prompt attends the cache the earlier
    chunks wrote). Query row i attends columns ``<= kv_len - q_len +
    i``; rows whose limit is below 0 give zeros. An int8 cache takes
    its ``k_scale``/``v_scale`` as in ``flash_attention_decode``."""
    named, int8 = _check_decode(query, key_cache, value_cache, kv_len)
    scales = _dense_scales("flash_attention_chunk", query, key_cache,
                           k_scale, v_scale, int8)
    if not _on_card(query, "flash_attention_chunk"):
        return flash_attention_chunk_plain(
            query, key_cache, value_cache, kv_len, scale,
            **_scale_kw(scales))
    out = _launch_dense("paddle_flash_chunk", query, key_cache, value_cache,
                        kv_len, scale, named, scales)
    _count_launch(flash_attention_chunk, scales)
    return out


flash_attention_chunk.launches = 0
flash_attention_chunk.launches_int8 = 0


# --------------------------------------------------------- paged decode

def flash_attention_decode_paged_plain(query, key_pool, value_pool,
                                       page_table, kv_len,
                                       scale: Optional[float] = None, *,
                                       k_scale=None, v_scale=None):
    """Plain version of the paged decode kernel, as the JAX package's
    fallback: gather each row's pages (and, for an int8 pool, its scale
    pages through the same table) into the logical [batch,
    pages_per_row * page_size, ...] layout and run the dense decode
    arithmetic. Content past kv_len is masked to exact zeros, so the
    result equals the dense plain version's on the same logical rows
    bit for bit."""
    _count_plain(flash_attention_decode_paged_plain, k_scale)
    b, n_slots = page_table.shape
    ps, hk, d = key_pool.shape[1:]
    idx = page_table.to(device=key_pool.device, dtype=torch.long)
    k_rows = key_pool[idx].reshape(b, n_slots * ps, hk, d)
    v_rows = value_pool[idx].reshape(b, n_slots * ps, hk, d)
    if k_scale is not None:
        k_scale = k_scale[idx].reshape(b, n_slots * ps, hk)
        v_scale = v_scale[idx].reshape(b, n_slots * ps, hk)
    return _decode_math(query, k_rows, v_rows, kv_len, scale, k_scale,
                        v_scale)


flash_attention_decode_paged_plain.calls = 0
flash_attention_decode_paged_plain.calls_int8 = 0


def flash_attention_decode_paged(query, key_pool, value_pool, page_table,
                                 kv_len, scale: Optional[float] = None, *,
                                 k_scale=None, v_scale=None):
    """Decode-shaped attention over a PAGED cache: ``query`` [batch,
    q_len<=8, heads, head_dim] against one layer's page pools
    ``key_pool``/``value_pool`` [n_pages, page_size, kv_heads,
    head_dim] (new tokens already written through the table), with
    ``page_table`` [batch, pages_per_row] int32 (entry 0 is the reserved
    null page) and ``kv_len`` [batch] int32 as in
    ``flash_attention_decode``, whose masking this is. The pool is read
    in place through its strides and the table; the table's values are
    trusted, as in the JAX package.

    Int8 pool mode: with int8 pools pass ``k_scale``/``v_scale``
    ([n_pages, page_size, kv_heads], the ``QuantPagedKVCache``
    sidecars); the scale pages resolve through the same table and the
    dequantisation fuses into the kernel."""
    _check_4d("query", query)
    _check_4d("key_pool", key_pool, query.shape[-1])
    _check_4d("value_pool", value_pool, query.shape[-1])
    b, sq, hq, d = query.shape
    n_pages, ps, hk = key_pool.shape[:3]
    if sq > MAX_DECODE_QLEN:
        raise ValueError(
            f"flash_attention_decode_paged: q_len {sq} > MAX_DECODE_QLEN "
            f"({MAX_DECODE_QLEN}); same contract as flash_attention_decode")
    if value_pool.shape != key_pool.shape:
        raise ValueError(f"pools {tuple(key_pool.shape)} / "
                         f"{tuple(value_pool.shape)} differ")
    if hq % hk:
        raise ValueError(f"q heads {hq} not divisible by kv heads {hk}")
    if page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError(f"page_table must be [batch={b}, pages_per_row], "
                         f"got {tuple(page_table.shape)}")
    _check_kv_len(query, kv_len)
    named = [("query", query), ("key_pool", key_pool),
             ("value_pool", value_pool)]
    int8 = _check_cache_dtypes(named)
    _same_device_dtype([("query", query), ("page_table", page_table)],
                       dtype=False)
    scales = None
    if int8:
        _check_scales("flash_attention_decode_paged", query, k_scale,
                      v_scale, (n_pages, ps, hk))
        scales = (k_scale, v_scale)
    if not _on_card(query, "flash_attention_decode_paged"):
        return flash_attention_decode_paged_plain(
            query, key_pool, value_pool, page_table, kv_len, scale,
            **_scale_kw(scales))
    _check_int32("kv_len", kv_len)
    _check_int32("page_table", page_table)
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    out = torch.empty((b, sq, hq, d), dtype=query.dtype,
                      device=query.device)
    code, strides = _kernel_args(named + [("out", out)], d)
    strides = (ctypes.c_int64 * 13)(*strides, page_table.stride(0))
    sc_ptrs, strides = _scale_args(scales, strides)
    entry = "paddle_flash_decode_paged" + ("" if scales is None
                                           else "_int8")
    lib = _build.library("flash_decode_paged", _PAGED_SIG)
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        err = getattr(lib, entry)(
            query.data_ptr(), key_pool.data_ptr(), value_pool.data_ptr(),
            *sc_ptrs, page_table.data_ptr(), kv_len.data_ptr(),
            out.data_ptr(), code, b, sq, hq, hk, ps, page_table.shape[1], d,
            strides, scale, stream)
    _build.raise_on(err, entry)
    _count_launch(flash_attention_decode_paged, scales)
    return out


flash_attention_decode_paged.launches = 0
flash_attention_decode_paged.launches_int8 = 0


def reset_counts():
    """Zero every launch and plain-call counter (int8 modes included)."""
    for fn in (flash_attention, flash_attention_bwd, flash_attention_decode,
               flash_attention_chunk, flash_attention_decode_paged):
        fn.launches = 0
    for fn in (flash_attention_decode, flash_attention_chunk,
               flash_attention_decode_paged):
        fn.launches_int8 = 0
    for fn in (flash_attention_plain, flash_attention_bwd_plain,
               flash_attention_decode_plain, flash_attention_chunk_plain,
               flash_attention_decode_paged_plain):
        fn.calls = 0
    for fn in (flash_attention_decode_plain, flash_attention_chunk_plain,
               flash_attention_decode_paged_plain):
        fn.calls_int8 = 0
    decode_xla.calls = 0
