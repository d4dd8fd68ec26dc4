"""Fused LM head + cross entropy (the JAX package's
``kernels/fused_ce.py``): the per-row cross entropy of ``softmax(h @ W)``
against integer labels, and its gradients for h and W, without the
[N, V] logits in device memory.

``fused_linear_ce`` goes through ``_LinearCEFn``, a
``torch.autograd.Function`` (the JAX package's custom VJP). Its forward
runs ``ce_fwd`` and its backward ``ce_bwd``: the kernels of
``csrc/fused_ce.cu`` for tensors on a CUDA card, the plain versions
``ce_fwd_plain`` / ``ce_bwd_plain`` (same signatures) for tensors on the
CPU. Nothing else picks a plain version: on the card a kernel either
launches or raises. ``ce_fwd.launches`` counts forward launches and
``ce_bwd.launches`` the backward's, two a vocabulary chunk
(``ce_bwd_plan``): the logits with d, then dW and dh; each plain
version counts its calls (``ce_fwd_plain.calls``).

Numerics, as in the JAX package's kernels: logits in fp32 (exact
products of the inputs, fp32 sums); natural exp and log, ``l == 0``
taken as 1 before the log; the gold logit is that of column y, so a
label >= V gives gold 0 and ce = lse; rows with y < 0 give ce 0 and a
dh row of exact zeros. In the backward ``d = (p - onehot) * s`` with
``s = where(y >= 0, dce, 0)``, rounded to W's dtype before ``d @ W``
and to h's before ``h^T @ d``; dh and dW are written once, in h's and
W's dtypes. The TPU's block shapes (``block_n``, ``block_v``) are
tiling, not semantics: they are checked and otherwise unused, and the
kernels pick their own tiles.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

DEFAULT_BLOCK_N = 512
DEFAULT_BLOCK_V = 1024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIG = {"paddle_ce_fwd": (_I, (_P, _P, _P, _P, _P, _L, _L, _I, _I, _P)),
        "paddle_ce_bwd": (_I, (_P,) * 9 + (_L, _L, _I, _I, _I, _P))}
#: the backward's vocabulary chunk: at most _CHUNK_V columns, a multiple
#: of _CHUNK_STEP (csrc/fused_ce.cu's kChunkV and kChunkStep)
_CHUNK_V, _CHUNK_STEP = 8192, 128
#: fp32 logits a plain version builds at once, in rows of V
_PLAIN_CHUNK = 1 << 27


# ----------------------------------------------------------- plain versions

def _vocab_rows(w, vocab_major):
    """W as [V, H] (a view)."""
    return w if vocab_major else w.t()


def _row_chunks(n, vocab):
    step = max(1, _PLAIN_CHUNK // max(vocab, 1))
    return [slice(i, min(i + step, n)) for i in range(0, n, step)]


def _gold_index(y, vocab):
    """(hit, index): whether label y_i names a column, and y_i clamped
    into [0, V) for a gather."""
    hit = (y >= 0) & (y < vocab)
    return hit, y.clamp(0, vocab - 1).long()[:, None]


def ce_fwd_plain(h, w, y, vocab_major=True):
    """Plain version of the forward kernel: (lse, ce) [N] fp32 of h [N, H]
    against W ([V, H] when ``vocab_major``, else [H, V]) and labels y
    [N]. Builds the fp32 logits in row chunks."""
    ce_fwd_plain.calls += 1
    wf = _vocab_rows(w, vocab_major).float()
    n, vocab = h.shape[0], wf.shape[0]
    lse = torch.empty((n,), dtype=torch.float32, device=h.device)
    ce = torch.empty((n,), dtype=torch.float32, device=h.device)
    for sl in _row_chunks(n, vocab):
        logits = h[sl].float() @ wf.t()
        m = logits.max(1).values
        l = torch.exp(logits - m[:, None]).sum(1)
        lse[sl] = m + torch.log(torch.where(l == 0, torch.ones_like(l), l))
        yc = y[sl]
        hit, idx = _gold_index(yc, vocab)
        gold = torch.where(hit, logits.gather(1, idx)[:, 0],
                           torch.zeros_like(lse[sl]))
        ce[sl] = torch.where(yc >= 0, lse[sl] - gold, torch.zeros_like(gold))
    return lse, ce


def ce_bwd_plain(h, w, y, lse, dce, vocab_major=True):
    """Plain version of the backward kernels: (dh, dW) in h's and W's
    dtypes and shapes, from the forward's lse and the cotangent dce [N],
    recomputing the logits in row chunks."""
    ce_bwd_plain.calls += 1
    wv = _vocab_rows(w, vocab_major)
    wf = wv.float()
    n, vocab = h.shape[0], wv.shape[0]
    s = torch.where(y >= 0, dce.float(), torch.zeros_like(dce.float()))
    dh = torch.empty(h.shape, dtype=h.dtype, device=h.device)
    dw = torch.zeros(wv.shape, dtype=torch.float32, device=h.device)
    for sl in _row_chunks(n, vocab):
        d = torch.exp(h[sl].float() @ wf.t() - lse[sl, None])
        hit, idx = _gold_index(y[sl], vocab)
        rows = torch.arange(d.shape[0], device=d.device)[hit]
        d[rows, idx[hit, 0]] -= 1.0                    # p - onehot
        d *= s[sl, None]
        dh[sl] = (d.to(w.dtype).float() @ wf).to(h.dtype)
        dw += d.to(h.dtype).float().t() @ h[sl].float()
    dw = dw.to(w.dtype)
    return dh, (dw if vocab_major else dw.t().contiguous())


# ----------------------------------------------------------- kernels

def ce_bwd_plan(n, vocab, hd, elem):
    """(vc, chunks, scratch bytes) of the backward kernels on h [n, hd]
    and W [vocab, hd] of ``elem`` bytes an element (hd as the kernels
    take it, a multiple of 8): the vocabulary in ``chunks`` chunks of vc
    columns, the last one shorter; the scratch is d [n, vc] in the
    element type and, past one chunk, the fp32 dh accumulator [n, hd].
    The kernels launch twice a chunk."""
    vc = min(_CHUNK_V, -(-vocab // _CHUNK_STEP) * _CHUNK_STEP)
    chunks = -(-vocab // vc)
    return vc, chunks, n * vc * elem + (4 * n * hd if chunks > 1 else 0)


def _check(h, w, y, vocab_major):
    if h.dim() != 2 or w.dim() != 2 or y.dim() != 1:
        raise ValueError(f"h [N, H], w [V, H] or [H, V] and y [N] expected, "
                         f"got {tuple(h.shape)}, {tuple(w.shape)} and "
                         f"{tuple(y.shape)}")
    hd = w.shape[1] if vocab_major else w.shape[0]
    if hd != h.shape[1] or y.shape[0] != h.shape[0]:
        raise ValueError(f"h {tuple(h.shape)}, w {tuple(w.shape)} "
                         f"(vocab_major={vocab_major}) and y "
                         f"{tuple(y.shape)} do not agree")
    if (w.shape[0] if vocab_major else w.shape[1]) < 1:
        raise ValueError("the vocabulary is empty")
    for t in (w, y):
        if t.device != h.device:
            raise ValueError(f"inputs on {h.device} and {t.device}")
    if not (h.dtype.is_floating_point and w.dtype.is_floating_point):
        raise TypeError(f"h and w must be float tensors, got {h.dtype} and "
                        f"{w.dtype}")
    if y.dtype.is_floating_point or y.dtype == torch.bool:
        raise TypeError(f"labels must be integers, got {y.dtype}")
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_linear_ce runs on CUDA or the CPU, got "
                         f"{h.device}")


def _kernel_operands(h, w, y, vocab_major):
    """(code, h, W as contiguous [V, H8], y as int32) for the kernels, or
    raise on what they do not take. The kernels' rows are whole 16-byte
    chunks, so a hidden size that is not a multiple of 8 is padded to
    one, H8, with zero columns: they add exact zeros to every logit, and
    the gradients' padding columns are cut off again (``_unpad``)."""
    if h.dtype != w.dtype or h.dtype not in _DTYPE_CODES:
        raise TypeError(f"the fused CE kernels take h and w of one dtype, "
                        f"float32 or bfloat16, got {h.dtype} and {w.dtype}")
    wv = _vocab_rows(w, vocab_major)
    pad = -h.shape[1] % 8
    if pad:
        h = torch.nn.functional.pad(h, (0, pad))
        wv = torch.nn.functional.pad(wv, (0, pad))
    return (_DTYPE_CODES[h.dtype], h.contiguous(), wv.contiguous(),
            y.to(torch.int32).contiguous())


def _unpad(g, hd):
    """A gradient [rows, H8] of the kernels cut back to the hidden size."""
    return g if g.shape[1] == hd else g[:, :hd].contiguous()


def _library():
    return _build.library("fused_ce", _SIG)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def ce_fwd(h, w, y, vocab_major=True):
    """(lse, ce) [N] fp32: the kernel for CUDA tensors
    (``paddle_ce_fwd``), the plain version for CPU tensors."""
    _check(h, w, y, vocab_major)
    if h.device.type == "cpu":
        return ce_fwd_plain(h, w, y, vocab_major)
    code, hc, wv, y32 = _kernel_operands(h, w, y, vocab_major)
    n = h.shape[0]
    lse = torch.empty((n,), dtype=torch.float32, device=h.device)
    ce = torch.empty((n,), dtype=torch.float32, device=h.device)
    if n == 0:
        return lse, ce
    with torch.cuda.device(h.device):
        err = _library().paddle_ce_fwd(
            hc.data_ptr(), wv.data_ptr(), y32.data_ptr(), lse.data_ptr(),
            ce.data_ptr(), n, wv.shape[0], hc.shape[1], code, _stream(h))
    _build.raise_on(err, "ce_fwd")
    ce_fwd.launches += 1
    return lse, ce


def ce_bwd(h, w, y, lse, dce, vocab_major=True):
    """(dh, dW) in h's and W's dtypes and shapes: the kernels for CUDA
    tensors (``paddle_ce_bwd``: three products over vocabulary chunks,
    with the scratch ``ce_bwd_plan`` sizes), the plain version for CPU
    tensors."""
    _check(h, w, y, vocab_major)
    if tuple(lse.shape) != tuple(y.shape) or \
            tuple(dce.shape) != tuple(y.shape):
        raise ValueError(f"lse and dce must be [N] = {tuple(y.shape)}, got "
                         f"{tuple(lse.shape)} and {tuple(dce.shape)}")
    if h.device.type == "cpu":
        return ce_bwd_plain(h, w, y, lse, dce, vocab_major)
    code, hc, wv, y32 = _kernel_operands(h, w, y, vocab_major)
    lse = lse.float().contiguous()
    s = torch.where(y >= 0, dce.float(), torch.zeros_like(dce.float()))
    dh = torch.empty(hc.shape, dtype=h.dtype, device=h.device)
    dw = torch.empty(wv.shape, dtype=w.dtype, device=h.device)
    if h.shape[0] == 0:
        dw.zero_()
        dw = _unpad(dw, h.shape[1])
        return _unpad(dh, h.shape[1]), (dw if vocab_major
                                        else dw.t().contiguous())
    n, vocab, hd = h.shape[0], wv.shape[0], hc.shape[1]
    vc, chunks, _ = ce_bwd_plan(n, vocab, hd, hc.element_size())
    d = torch.empty((n, vc), dtype=h.dtype, device=h.device)
    acc = torch.empty((n, hd), dtype=torch.float32, device=h.device) \
        if chunks > 1 else None
    with torch.cuda.device(h.device):
        err = _library().paddle_ce_bwd(
            hc.data_ptr(), wv.data_ptr(), y32.data_ptr(), lse.data_ptr(),
            s.data_ptr(), dh.data_ptr(), dw.data_ptr(), d.data_ptr(),
            None if acc is None else acc.data_ptr(), n, vocab, hd, vc, code,
            _stream(h))
    _build.raise_on(err, "ce_bwd")
    ce_bwd.launches += 2 * chunks
    dh, dw = _unpad(dh, h.shape[1]), _unpad(dw, h.shape[1])
    return dh, (dw if vocab_major else dw.t().contiguous())


KERNEL_WRAPPERS = (ce_fwd, ce_bwd)
PLAIN_VERSIONS = (ce_fwd_plain, ce_bwd_plain)


def reset_counts():
    """Zero every launch and plain-call counter."""
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    for fn in PLAIN_VERSIONS:
        fn.calls = 0


reset_counts()


# ----------------------------------------------------------- autograd

class _LinearCEFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, y, vocab_major):
        lse, ce = ce_fwd(h, w, y, vocab_major)
        ctx.save_for_backward(h, w, y, lse)
        ctx.vocab_major = vocab_major
        return ce

    @staticmethod
    def backward(ctx, dce):
        h, w, y, lse = ctx.saved_tensors
        dh, dw = ce_bwd(h, w, y, lse, dce, ctx.vocab_major)
        return dh, dw, None, None


def fused_linear_ce(h, w, y, vocab_major=True, block_n=DEFAULT_BLOCK_N,
                    block_v=DEFAULT_BLOCK_V):
    """Per-row cross entropy [N] fp32 of ``softmax(h @ W)`` against labels
    ``y`` without materializing the [N, V] logits.

    h: [N, H] activations (bf16/fp32). w: [V, H] when ``vocab_major``
    (tied embedding layout) else [H, V]. y: [N] int labels, < 0 =
    ignored (0 for that row). Differentiable wrt h and w; y gets no
    gradient. ``block_n`` / ``block_v`` are the JAX kernel's tile sizes:
    checked, and not used by the kernels here."""
    for name, b in (("block_n", block_n), ("block_v", block_v)):
        if isinstance(b, bool) or not isinstance(b, int) or b < 1:
            raise ValueError(f"{name} must be a positive int, got {b!r}")
    return _LinearCEFn.apply(h, w, y, bool(vocab_major))
