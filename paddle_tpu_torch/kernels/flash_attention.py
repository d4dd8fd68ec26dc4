"""Flash attention for training, prefill and decode: CUDA kernels for
Hopper and their plain PyTorch versions.

``flash_attention`` (training and prefill) and
``flash_attention_decode`` (one decode step's 1..8 query rows against
the KV cache) launch the kernels in ``csrc/flash_fwd.cu`` and
``csrc/flash_decode.cu`` for tensors on a CUDA card and run the plain
versions beside them for tensors on the CPU. When an input requires a
gradient, ``flash_attention`` goes through ``_FlashAttentionFn``, whose
backward is ``flash_attention_bwd`` (``csrc/flash_bwd.cu`` on a card).
Nothing else picks a plain version: on the card a kernel either
launches or raises. Each wrapper counts its launches in a plain integer
attribute (``flash_attention.launches``), each plain version its calls
(``flash_attention_plain.calls``), so a run can show which path it
took.

Layouts are the JAX package's public ones: ``[batch, seq, heads,
head_dim]`` for queries, keys and values, ``[batch, max_len, kv_heads,
head_dim]`` for one layer's cache. Inputs are read through their
strides (only head_dim must be contiguous), so views of a fused qkv
projection or a layer slice of the cache cost no copy.
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
    ctypes.c_float, _P))}
_DECODE_SIG = {"paddle_flash_decode": (_I, (
    _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _STRIDES,
    ctypes.c_float, _P))}
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


def _kernel_args(named, head_dim):
    """dtype code plus the (batch, seq, head) strides of every tensor;
    raises on what the kernels do not take."""
    ref = named[0][1]
    if ref.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash attention kernels take float32, bfloat16 "
                        f"or float16, got {ref.dtype}")
    if head_dim not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f"head_dim {head_dim}: the CUDA kernels are built for "
            f"{KERNEL_HEAD_DIMS}")
    strides = []
    for name, t in named:
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous head_dim "
                             f"(stride {t.stride(-1)})")
        strides += list(t.stride()[:3])
    return _DTYPE_CODES[ref.dtype], (ctypes.c_int64 * len(strides))(
        *strides)


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


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


def _softmax_pv(s, value, pv_eq):
    """fp32 softmax of masked scores (-inf = masked) times V; rows with
    no visible column give zeros."""
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l == 0, torch.ones_like(l), l)
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
    _raise_on(err, "flash_fwd")
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
    _raise_on(err, "flash_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


# --------------------------------------------------------------- decode

def flash_attention_decode_plain(query, key_cache, value_cache, kv_len,
                                 scale: Optional[float] = None):
    """Plain version of the decode kernel: query row i of batch row b
    attends cache columns c <= kv_len[b] - sq + i, in fp32, output in
    the query's dtype. Rows with no visible column give zeros."""
    flash_attention_decode_plain.calls += 1
    b, sq, hq, d = query.shape
    t, hk = key_cache.shape[1], key_cache.shape[2]
    g = hq // hk
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    qf = query.float().reshape(b, sq, hk, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, key_cache.float()) * scale
    rows = torch.arange(sq, device=query.device)[None, :, None]
    cols = torch.arange(t, device=query.device)[None, None, :]
    lim = kv_len.to(device=query.device, dtype=torch.int64)
    visible = cols - rows <= (lim - sq)[:, None, None]       # [b, sq, t]
    s = s.masked_fill(~visible[:, None, None], float("-inf"))
    out = _softmax_pv(s, value_cache, "bhgqk,bkhd->bqhgd")
    return out.reshape(b, sq, hq, d).to(query.dtype)


flash_attention_decode_plain.calls = 0


def flash_attention_decode(query, key_cache, value_cache, kv_len,
                           scale: Optional[float] = None):
    """Decode-shaped attention: ``query`` [batch, q_len<=8, heads,
    head_dim] against one layer's cache ``key_cache``/``value_cache``
    [batch, max_len, kv_heads, head_dim] (new tokens already written),
    with ``kv_len`` [batch] int32 valid entries per row INCLUDING the
    q_len new positions. Query row i attends columns
    ``<= kv_len - q_len + i``. The cache is read in place through its
    strides and never repeated for grouped-query heads."""
    _check_4d("query", query)
    _check_4d("key_cache", key_cache, query.shape[-1])
    _check_4d("value_cache", value_cache, query.shape[-1])
    b, sq, hq, d = query.shape
    t, hk = key_cache.shape[1], key_cache.shape[2]
    if sq > MAX_DECODE_QLEN:
        raise ValueError(
            f"flash_attention_decode: q_len {sq} > MAX_DECODE_QLEN "
            f"({MAX_DECODE_QLEN}); use flash_attention for longer query "
            "windows")
    if key_cache.shape[0] != b or value_cache.shape != key_cache.shape:
        raise ValueError(f"caches {tuple(key_cache.shape)} / "
                         f"{tuple(value_cache.shape)} do not match query "
                         f"{tuple(query.shape)}")
    if hq % hk:
        raise ValueError(f"q heads {hq} not divisible by kv heads {hk}")
    if tuple(kv_len.shape) != (b,):
        raise ValueError(f"kv_len must be [batch]={b}, got "
                         f"{tuple(kv_len.shape)}")
    named = [("query", query), ("key_cache", key_cache),
             ("value_cache", value_cache)]
    _same_device_dtype(named)
    _same_device_dtype([("query", query), ("kv_len", kv_len)], dtype=False)
    if query.device.type == "cpu":
        return flash_attention_decode_plain(query, key_cache, value_cache,
                                            kv_len, scale)
    if query.device.type != "cuda":
        raise ValueError(f"flash_attention_decode runs on CUDA or the "
                         f"CPU, got {query.device}")
    if kv_len.dtype != torch.int32 or not kv_len.is_contiguous():
        raise TypeError("kv_len must be a contiguous int32 tensor, got "
                        f"{kv_len.dtype}")
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    out = torch.empty((b, sq, hq, d), dtype=query.dtype,
                      device=query.device)
    code, strides = _kernel_args(named + [("out", out)], d)
    lib = _build.library("flash_decode", _DECODE_SIG)
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        err = lib.paddle_flash_decode(
            query.data_ptr(), key_cache.data_ptr(), value_cache.data_ptr(),
            kv_len.data_ptr(), out.data_ptr(), code, b, sq, hq, hk, t, d,
            strides, scale, stream)
    _raise_on(err, "flash_decode")
    flash_attention_decode.launches += 1
    return out


flash_attention_decode.launches = 0


def reset_counts():
    """Zero every launch and plain-call counter."""
    for fn in (flash_attention, flash_attention_bwd, flash_attention_decode):
        fn.launches = 0
    for fn in (flash_attention_plain, flash_attention_bwd_plain,
               flash_attention_decode_plain):
        fn.calls = 0
