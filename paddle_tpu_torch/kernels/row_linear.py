"""Row-invariant ``y = x @ W + b`` for the products of a cached forward:
the kernel of ``csrc/row_gemm.cu`` and its plain PyTorch version.

It replaces no TPU kernel. The JAX package leaves a Linear to XLA, whose
GEMM gives a row the same bits whatever the batch, so the reference
holds the engine's streams to batch-1 ``generate`` bit for bit. cuBLAS
picks its kernel by the row count, so on the card it did not (ROADMAP
C12). Nothing about a ``row_gemm`` launch depends on M or on x's
address: ``plan(k, n, dtype, w_nk, w_aligned)`` chooses the route, the
tile, the split count and the cluster from K, N, the dtype, W's layout
and W's alignment alone, so a row's bits do not depend on M. A view of
x that TMA cannot take (not 16-byte aligned) is copied into fresh
memory first (``aligned_rows``), not sent elsewhere.

Routes: bf16 and fp16 run on Hopper's warpgroup products fed by TMA
("wgmma": a 64 x 128 tile, 64 deep a slice); fp32, and bf16/fp16 whose W
TMA cannot take (K, or N of a ``[K, N]`` weight, not a multiple of 8; W
not 16-byte aligned), on a 64 x 64 CUDA-core tile ("fma"). Both cut the
contraction into ``splits`` runs of slices, and the blocks of one
output tile form a thread-block cluster whose splits fold in rank order
through distributed shared memory: one launch a product, no scratch in
device memory. At a decode step's few rows the kernel is bound by W's
bytes and a launch's fixed cost: the split spreads W over up to 132
SMs, and the launch overlaps the previous kernel (programmatic
dependent launch). At a prefill's hundreds of rows it is bound by the
tensor cores, and the fold's traffic (splits x M x N fp32 values)
grows with the split, so each split walks at least ``MIN_SLICES``
slices.

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
from typing import NamedTuple

import torch

from . import _build

#: the warpgroup route's tile: 64 rows (one wgmma m64n128 product), 128
#: columns, 64 deep a slice; csrc/row_gemm.cu kBM, kBN, kBK
WG_TILE_M, WG_TILE_N, WG_TILE_K = 64, 128, 64
#: the CUDA-core route's tile; csrc/row_gemm.cu kFM, kFN, kFK
FMA_TILE_M, FMA_TILE_N, FMA_TILE_K = 64, 64, 32
#: the fewest slices a split walks, by route: each split's fp32 partial
#: crosses the cluster once at every row the call has, so at a prefill
#: more splits cost more than the SMs they fill
MIN_SLICES = {"wgmma": 3, "fma": 4}
#: the blocks a launch aims to put in flight: one per SM of an H100
TARGET_BLOCKS = 132
#: the largest portable cluster, so the most splits; csrc/row_gemm.cu
#: kMaxSplits
MAX_SPLITS = 8

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"paddle_row_gemm": (_I, (_P, _P, _P, _P, _I, _I, _I, _I, _P))}


class Plan(NamedTuple):
    """One layer's launch: ``route`` ("wgmma" or "fma"), ``tile`` (rows,
    columns, depth), ``splits`` (the cluster's blocks) and ``code``, the
    int the C entry takes (its bit layout is stated there)."""
    route: str
    tile: tuple
    splits: int
    code: int


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


def route(k: int, n: int, dtype: torch.dtype, w_nk: bool,
          w_aligned: bool) -> str:
    """"wgmma" where TMA can take W and the type is bf16 or fp16: K (and
    N of a ``[K, N]`` weight) a multiple of 8, W 16-byte aligned; else
    "fma"."""
    rows8 = k > 0 and k % 8 == 0 and (w_nk or n % 8 == 0)
    if dtype in (torch.bfloat16, torch.float16) and rows8 and w_aligned:
        return "wgmma"
    return "fma"


def tile(route: str) -> tuple:
    """(rows, columns, depth) of the route's tile."""
    if route == "wgmma":
        return WG_TILE_M, WG_TILE_N, WG_TILE_K
    return FMA_TILE_M, FMA_TILE_N, FMA_TILE_K


def split_count(k: int, n: int, route: str) -> int:
    """The contraction splits of a [*, k] @ [k, n] launch, which are the
    blocks of one cluster: doubled from 1 while the column tiles of one
    row tile times the splits fall short of ``TARGET_BLOCKS``, up to
    ``MAX_SPLITS``, each split walking at least ``MIN_SLICES[route]``
    slices."""
    _, tn, tk = tile(route)
    slices = -(-int(k) // tk)
    col_tiles = max(1, -(-int(n) // tn))
    s = 1
    while (s * col_tiles < TARGET_BLOCKS and 2 * s <= MAX_SPLITS
           and 2 * s * MIN_SLICES[route] <= slices):
        s *= 2
    return s


@functools.lru_cache(maxsize=None)
def plan(k: int, n: int, dtype: torch.dtype, w_nk: bool,
         w_aligned: bool) -> Plan:
    """The launch of a layer, from K, N, the dtype, W's layout and W's
    alignment: a layer's values are fixed, whatever M and x."""
    r = route(k, n, dtype, w_nk, w_aligned)
    s = split_count(k, n, r)
    code = (_DTYPE_CODES[dtype] | int(w_nk) << 2 | (r == "wgmma") << 3
            | s << 8)
    return Plan(r, tile(r), s, code)


def aligned_rows(x):
    """``x`` itself when it is contiguous at a 16-byte aligned address,
    else a contiguous copy in fresh memory: the kernel reads x's rows
    through TMA (or 16-byte copies), and no launch choice may depend on
    where x lies."""
    if x.is_contiguous() and not x.data_ptr() & 15:
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _check(x, weight, bias):
    """The wrapper's argument checks, a few attribute reads on the hot
    call; raises on what the kernel does not take."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"row_linear takes float32, bfloat16 or float16, "
                        f"got {x.dtype}")
    if weight.dtype != x.dtype:
        raise TypeError(f"row_linear: weight is {weight.dtype}, x {x.dtype}")
    if weight.dim() != 2 or x.shape[-1] != weight.shape[0]:
        raise ValueError(f"row_linear: x {tuple(x.shape)} against weight "
                         f"{tuple(weight.shape)} ([in, out])")
    dev = x.get_device()
    if weight.get_device() != dev:
        raise ValueError(f"row_linear: weight on {weight.device}, x on "
                         f"{x.device}")
    if bias is not None:
        if bias.dtype != x.dtype:
            raise TypeError(f"row_linear: bias is {bias.dtype}, x {x.dtype}")
        if bias.get_device() != dev:
            raise ValueError(f"row_linear: bias on {bias.device}, x on "
                             f"{x.device}")
        if bias.dim() != 1 or bias.shape[0] != weight.shape[1]:
            raise ValueError(f"row_linear: bias {tuple(bias.shape)} against "
                             f"{weight.shape[1]} outputs")
    if not (x.is_cuda or x.is_cpu):
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
    if not x.is_cuda:
        return row_linear_plain(x, weight, bias)
    dev = x.get_device()
    # 49 calls a decode step: skip the device guard when x is on the
    # current device already (the usual case)
    if dev == torch.cuda.current_device():
        return _launch(x, weight, bias,
                       torch._C._cuda_getCurrentRawStream(dev))
    with torch.cuda.device(dev):
        return _launch(x, weight, bias,
                       torch._C._cuda_getCurrentRawStream(dev))


def _layout(weight):
    """(W as the kernel reads it, whether it lies [N, K]): Paddle's
    contiguous [K, N], the transposed view of a contiguous [N, K] (the
    tied head's ``wte.t()``), or else a contiguous copy."""
    k, n = weight.shape
    st = weight.stride()
    if st[1] == 1 and (st[0] == n or k == 1):
        return weight, False
    if st[0] == 1 and (st[1] == k or n == 1):
        return weight, True
    return weight.contiguous(), False


def plan_for(weight) -> Plan:
    """The plan ``row_linear`` launches for ``weight`` ([K, N], any x)."""
    w, w_nk = _layout(weight)
    k, n = weight.shape
    return plan(k, n, weight.dtype, w_nk, not w.data_ptr() & 15)


def _launch(x, weight, bias, stream):
    """One ``row_gemm`` launch on ``stream``: allocates y and nothing
    else (the splits fold in a cluster, with no scratch)."""
    k, n = weight.shape
    x = aligned_rows(x)
    y = x.new_empty((*x.shape[:-1], n))
    m = y.numel() // n if n else 0
    if m == 0:
        return y
    w, w_nk = _layout(weight)
    wp = w.data_ptr()
    code = plan(k, n, x.dtype, w_nk, not wp & 15).code
    err = _build.library("row_gemm", _SIG).paddle_row_gemm(
        x.data_ptr(), wp, None if bias is None else
        bias.contiguous().data_ptr(), y.data_ptr(), m, n, k, code, stream)
    _build.raise_on(err, "row_linear")
    row_linear.launches += 1
    return y


row_linear.launches = 0


def reset_counts():
    """Zero the launch and plain-call counters."""
    row_linear.launches = 0
    row_linear_plain.calls = 0
