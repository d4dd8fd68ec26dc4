"""Row-invariant ``y = x @ W + b`` for the products of a cached forward:
the kernel of ``csrc/row_gemm.cu`` and its plain PyTorch version.

It replaces no TPU kernel. The JAX package leaves a Linear to XLA, whose
GEMM gives a row the same bits whatever the batch, so the reference
holds the engine's streams to batch-1 ``generate`` bit for bit. cuBLAS
picks its kernel by the row count, so on the card it did not (ROADMAP
C12). ``row_gemm``'s tile, contraction order and split count come from
K and N alone (``split_count``), so a row's bits do not depend on M.

``row_linear(x, weight, bias)`` takes Paddle's ``[K, N]`` weight (or
any view whose transpose is contiguous, such as the tied LM head's
``wte.t()``), an optional ``[N]`` bias of ``x``'s dtype, and ``x`` of
shape ``[..., K]``; it launches the kernel for tensors on a CUDA card
and runs ``row_linear_plain`` for tensors on the CPU, nothing else. The
kernel has no backward: it serves inference only.

The route: ``cached_forward()`` is the one switch, entered by the
models' cached (generation) forwards. Inside it ``routes(...)`` is true
unless a gradient is being recorded, and ``nn.functional.linear``, the
GPT LM head and the weight-only layers send their products here.
Training and the uncached forward never enter it, so they keep cuBLAS.
The switch is per thread (engines may step on pump threads) and is off
again when the forward leaves, by return or by exception.

Counters: ``row_linear.launches`` (kernel launches) and
``row_linear_plain.calls`` (plain calls); ``reset_counts()`` zeroes
both.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import threading

import torch

from . import _build

#: the kernel's tile (rows, columns, contraction slice); csrc/row_gemm.cu
#: kBM, kBN, kBK
TILE_M, TILE_N, TILE_K = 64, 64, 32
#: the blocks a launch aims to put in flight (two per SM of an H100)
TARGET_BLOCKS = 2 * 132
#: the fewest contraction slices a split walks
MIN_SLICES_PER_SPLIT = 4

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"paddle_row_gemm": (_I, (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _I, _P))}

_STATE = threading.local()


@contextlib.contextmanager
def cached_forward():
    """The switch: products inside go through ``row_linear`` (nested
    entries are fine; the previous state comes back on exit)."""
    depth = getattr(_STATE, "depth", 0)
    _STATE.depth = depth + 1
    try:
        yield
    finally:
        _STATE.depth = depth


def in_cached_forward(fn):
    """``fn`` (a model's cached forward) run inside ``cached_forward()``."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with cached_forward():
            return fn(*args, **kwargs)
    return wrapped


def route_on() -> bool:
    """Whether this thread is inside a cached forward."""
    return getattr(_STATE, "depth", 0) > 0


def routes(*tensors) -> bool:
    """Whether a product of ``tensors`` goes through ``row_linear``:
    inside a cached forward, and no gradient being recorded for them
    (the kernel has no backward)."""
    if not route_on():
        return False
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        return False
    return True


def split_count(k: int, n: int) -> int:
    """The contraction splits of a [*, k] @ [k, n] launch, from k and n
    alone: enough to put ``TARGET_BLOCKS`` blocks in flight over the
    ``ceil(n / TILE_N)`` column tiles of one row tile, each split
    walking at least ``MIN_SLICES_PER_SPLIT`` slices."""
    slices = -(-int(k) // TILE_K)
    col_tiles = max(1, -(-int(n) // TILE_N))
    want = -(-TARGET_BLOCKS // col_tiles)
    return max(1, min(want, slices // MIN_SLICES_PER_SPLIT))


def _check(x, weight, bias):
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"row_linear takes float32, bfloat16 or float16, "
                        f"got {x.dtype}")
    if weight.dim() != 2 or x.shape[-1] != weight.shape[0]:
        raise ValueError(f"row_linear: x {tuple(x.shape)} against weight "
                         f"{tuple(weight.shape)} ([in, out])")
    for name, t in (("weight", weight), ("bias", bias)):
        if t is None:
            continue
        if t.dtype != x.dtype:
            raise TypeError(f"row_linear: {name} is {t.dtype}, x {x.dtype}")
        if t.device != x.device:
            raise ValueError(f"row_linear: {name} on {t.device}, x on "
                             f"{x.device}")
    if bias is not None and tuple(bias.shape) != (weight.shape[1],):
        raise ValueError(f"row_linear: bias {tuple(bias.shape)} against "
                         f"{weight.shape[1]} outputs")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"row_linear runs on CUDA or the CPU, got "
                         f"{x.device}")


def row_linear_plain(x, weight, bias=None):
    """Plain version: ``(x.float() @ weight.float() + bias.float())`` in
    x's dtype."""
    row_linear_plain.calls += 1
    _check(x, weight, bias)
    y = x.float() @ weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


row_linear_plain.calls = 0


def row_linear(x, weight, bias=None):
    """``x @ weight + bias`` with a row's bits independent of the row
    count: the ``row_gemm`` kernel for CUDA tensors, the plain version
    for CPU tensors."""
    _check(x, weight, bias)
    if x.device.type == "cpu":
        return row_linear_plain(x, weight, bias)
    k, n = weight.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y.reshape(*lead, n)
    if weight.is_contiguous():
        w, w_nk = weight, 0
    elif weight.t().is_contiguous():
        w, w_nk = weight.t(), 1
    else:
        w, w_nk = weight.contiguous(), 0
    b = None if bias is None else bias.contiguous()
    splits = split_count(k, n)
    part = torch.empty((splits, m, n), dtype=torch.float32,
                       device=x.device) if splits > 1 else None
    args = (x2.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            y.data_ptr(), None if part is None else part.data_ptr(), m, n, k,
            w_nk, splits, _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    fn = _build.library("row_gemm", _SIG).paddle_row_gemm
    # 49 calls a decode step: skip the device guard when x is on the
    # current device already (the usual case)
    if x.device.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(x.device):
            err = fn(*args)
    _build.raise_on(err, "row_linear")
    row_linear.launches += 1
    return y.reshape(*lead, n)


row_linear.launches = 0


def reset_counts():
    """Zero the launch and plain-call counters."""
    row_linear.launches = 0
    row_linear_plain.calls = 0
