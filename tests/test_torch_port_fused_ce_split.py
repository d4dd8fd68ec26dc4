"""The bf16 fused CE forward's split plan (TPU kernel table row 11,
``csrc/fused_ce.cu``'s ``ce_fwd_wgmma``), on the CPU.

The kernel cuts the vocabulary into ``kFwdTile``-column W tiles (256)
and the tiles into ``kFwdSplits`` (8) contiguous runs (``_splits``), one
block each; both constants are read from the source. A tile is two 128-column products (the warpgroup body's
``kBN``), each one softmax step: consumer lane q (thread % 4) of a token
row owns columns 8j + 2q + e (j < 16, e < 2) of every step and keeps a
running (max, sum-exp) over them, the step's sum taken in four partial
chains (j % 4); the four lanes of a row merge as lane pairs (0, 1) and
(2, 3), then the pairs; split 0's block folds the splits' partials in
rank order. The gold logit is the label column's, 0 when the label is no
column; ce is 0 where the label is negative. ``_split_forward`` is that
algorithm in torch (fp32 logits from the inputs' values, W rows past V
zero as TMA fills them). It is held against the port's plain version
(``ce_fwd_plain``: whole rows at once) and the JAX package's ``_fwd`` in
interpret mode, at vocabulary sizes on and beside a step's and a tile's
edge and beside ``kFwdSplits`` tiles (where splits are empty), with a
ragged N, labels in the last tile, past V and negative. Tolerances: fp32
within 1e-5 (the same fp32 logits, their statistics in another order);
bf16 inputs by the LSE rule, 1e-4 + 1e-4 |reference| (fp32 statistics of
exact bf16 products). The plan's constants are held to the source's, and
the forward's ctypes signature to its ``extern "C"`` entry.
"""
import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.fused_ce import _fwd as jax_fwd
from paddle_tpu_torch.kernels import fused_ce as tfc

_CSRC = Path(tfc.__file__).resolve().parents[1] / "csrc"
_SRC = (_CSRC / "fused_ce.cu").read_text()
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_NEG = -1e30
TILE, SPLITS = (int(re.search(rf"constexpr int {k} = (\d+);", _SRC).group(1))
                for k in ("kFwdTile", "kFwdSplits"))
STEP = 128         # the softmax step: one m64n128 product's columns
N, H = 130, 32     # N ragged to the kernel's 128-row tiles


def _splits(vocab, splits=SPLITS, tile=TILE):
    """[(v0, v1)] per split of the bf16 forward kernel (``split_tiles``):
    the vocabulary's ``tile``-column tiles in contiguous runs of
    ceil(tiles / splits), split s the columns [v0, v1) (v0 == v1: an
    empty split, whose statistics fold to nothing)."""
    tiles = -(-vocab // tile)
    per = -(-tiles // splits)
    out = []
    for s in range(splits):
        t0 = min(tiles, s * per)
        t1 = min(tiles, t0 + per)
        out.append((min(vocab, t0 * tile), min(vocab, t1 * tile)))
    return out


def _merge(m, l, m2, l2):
    """Two running (max, sum-exp) merged, as the kernel's ``merge``."""
    mn = torch.maximum(m, m2)
    return mn, l * torch.exp(m - mn) + l2 * torch.exp(m2 - mn)


def _split_forward(h, w, y, splits=SPLITS, tile=TILE):
    """(lse, ce) [N] of h [N, H] against W [V, H] and labels y as the bf16
    forward kernel computes them (see the module's note)."""
    hf, wf = h.float(), w.float()
    n, vocab = hf.shape[0], wf.shape[0]
    parts = []
    for v0, v1 in _splits(vocab, splits, tile):
        m = torch.full((n, 4), _NEG)
        l = torch.zeros((n, 4))
        gold = torch.zeros(n)
        # the split's tiles in order, as steps of STEP columns; a step
        # wholly past V is none
        for c0 in range(v0, v1, STEP):
            wt = torch.zeros((STEP, hf.shape[1]))
            wt[:min(STEP, vocab - c0)] = wf[c0:c0 + STEP]
            lg = hf @ wt.t()                                   # [n, STEP]
            lim = min(STEP, vocab - c0)
            rows = ((y >= c0) & (y < c0 + lim)).nonzero()[:, 0]
            gold[rows] = lg[rows, y[rows] - c0]
            x = torch.where(torch.arange(STEP) < lim, lg,
                            torch.full_like(lg, -float("inf")))
            # lane q's columns 8j + 2q + e, in (j, e) order
            x = x.view(n, STEP // 8, 4, 2).permute(0, 2, 1, 3) \
                .reshape(n, 4, -1)
            tmax = x.max(-1).values
            live = tmax > _NEG
            mn = torch.maximum(m, tmax)
            p = torch.exp(x - mn[..., None])
            # four partial chains over j % 4, joined in a fixed order
            ch = p.view(n, 4, STEP // 32, 4, 2).sum((2, 4))
            sm = (ch[..., 0] + ch[..., 1]) + (ch[..., 2] + ch[..., 3])
            l = torch.where(live, l * torch.exp(m - mn) + sm, l)
            m = torch.where(live, mn, m)
        ma, la = _merge(m[:, 0], l[:, 0], m[:, 1], l[:, 1])
        mb, lb = _merge(m[:, 2], l[:, 2], m[:, 3], l[:, 3])
        parts.append((*_merge(ma, la, mb, lb), gold))
    m, l, g = torch.full((n,), _NEG), torch.zeros(n), torch.zeros(n)
    for pm, pl, pg in parts:            # the fold, in rank order
        m, l = _merge(m, l, pm, pl)
        g = g + pg
    lse = m + torch.log(torch.where(l == 0, torch.ones_like(l), l))
    return lse, torch.where(y >= 0, lse - g, torch.zeros_like(lse))


def _inputs(vocab, dtype, seed, n=N, hd=H):
    rng = np.random.RandomState(seed)
    h = rng.randn(n, hd).astype(np.float32)
    w = (rng.randn(vocab, hd) * 0.3).astype(np.float32)
    y = rng.randint(0, vocab, (n,))
    y[::7] = -1
    y[3] = -100                   # any negative label is ignored
    y[5] = vocab + 3              # past the vocabulary: gold 0, ce = lse
    y[1] = vocab - 1              # the last tile's last column
    y[n - 1] = 0
    tdt = getattr(torch, dtype)
    return (h, w, y), (torch.tensor(h).to(tdt), torch.tensor(w).to(tdt),
                       torch.tensor(y))


def _close(out, ref, dtype):
    out, ref = out.float().numpy(), np.asarray(ref, np.float32)
    tol = 1e-5 if dtype == "float32" else 1e-4
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


_VOCABS = [1, STEP - 1, STEP, STEP + 1, TILE - 1, TILE, TILE + 1,
           SPLITS * TILE - 1, SPLITS * TILE, SPLITS * TILE + 1,
           2 * SPLITS * TILE + 5]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vocab", _VOCABS)
def test_split_forward_matches_plain_and_jax(dtype, vocab):
    (h, w, y), (ht, wt, yt) = _inputs(vocab, dtype, vocab)
    lse, ce = _split_forward(ht, wt, yt)
    lse_p, ce_p = tfc.ce_fwd_plain(ht, wt, yt)
    _close(lse, lse_p, dtype)
    _close(ce, ce_p, dtype)
    assert bool((ce[yt < 0] == 0).all())
    assert float(ce[5]) == float(lse[5])          # a label past V: gold 0
    jdt = _JDT[dtype]
    jlse, jgold = jax_fwd(jnp.asarray(h, jdt), jnp.asarray(w, jdt),
                          jnp.asarray(y, jnp.int32), True, 32, 64)
    _close(lse, jlse, dtype)
    # the JAX kernel's gold for a label in its padded vocabulary is the
    # padding's -1e30: rows with a label past V are held to plain only
    on = (y >= 0) & (y < vocab)
    _close(ce[torch.tensor(on)], (np.asarray(jlse) - np.asarray(jgold))[on],
           dtype)


@pytest.mark.parametrize("vocab", [300, 1025])
def test_split_forward_at_gpt2_width(vocab):
    """At gpt2-small's hidden size (768, 12 of the kernel's 64-deep
    slices) in bf16, across row tiles (N 257); at V 300 the last tile's
    second step is cut, at 1025 it is past V."""
    (h, w, y), (ht, wt, yt) = _inputs(vocab, "bfloat16", 7, n=257, hd=768)
    lse, ce = _split_forward(ht, wt / 8, yt)
    lse_p, ce_p = tfc.ce_fwd_plain(ht, wt / 8, yt)
    _close(lse, lse_p, "bfloat16")
    _close(ce, ce_p, "bfloat16")


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_any_split_count_gives_the_same_statistics(splits):
    """The fold over splits in rank order is one softmax: 1, 2, 4 or 8
    splits agree within fp32 rounding (their bits differ)."""
    _, (ht, wt, yt) = _inputs(3 * TILE + 17, "float32", 11)
    lse, ce = _split_forward(ht, wt, yt, splits)
    lse_1, ce_1 = _split_forward(ht, wt, yt, 1)
    _close(lse, lse_1, "float32")
    _close(ce, ce_1, "float32")


@pytest.mark.parametrize("splits", [1, 4, 8])
@pytest.mark.parametrize("vocab", [1, 127, 128, 129, 255, 256, 257, 2047,
                                   2048, 2049, 8191, 50257])
def test_split_plan_covers_the_vocabulary_once(vocab, splits):
    """Contiguous runs of whole tiles in order, the same number of tiles
    each but the last non-empty one, empty splits only at the end."""
    plan = _splits(vocab, splits)
    assert len(plan) == splits
    assert plan[0][0] == 0 and plan[-1][1] == vocab
    tiles = -(-vocab // TILE)
    per = -(-tiles // splits)
    for s, (v0, v1) in enumerate(plan):
        assert 0 <= v0 <= v1 <= vocab
        if s:
            assert v0 == plan[s - 1][1]
        assert (v0 % TILE == 0 or v0 == v1 == vocab) and v1 - v0 <= per * TILE
        if v1 < vocab:
            assert v1 - v0 in (0, per * TILE)
    empty = [v0 == v1 for v0, v1 in plan]
    assert empty == sorted(empty)            # empties trail
    assert sum(not e for e in empty) == -(-tiles // per)


def test_lm_head_plan():
    """gpt2-small's vocabulary: 197 tiles, 25 a split, the last split 22."""
    plan = _splits(50257)
    assert [(v1 - v0 + TILE - 1) // TILE for v0, v1 in plan] == \
        [25] * 7 + [22]


def test_forward_constants_match_the_source():
    """The tile and the split count, read from the source, are the
    kernel's: the split count a portable cluster's blocks, the cluster
    launched with it; a tile is the wide ring's two m64n128 products, a
    step one of them."""
    tile, splits = TILE, SPLITS
    assert (tile, splits) == (256, 8)
    assert 1 <= splits <= 8                   # a portable cluster
    assert "attr[0].val.clusterDim.x = kFwdSplits;" in _SRC
    assert "static_assert(kFwdTile == pw::kWideBN" in _SRC
    assert "constexpr int kFwdStep = pw::kBN;" in _SRC
    body = (_CSRC / "wgmma_gemm.cuh").read_text()
    assert STEP == int(re.search(r"constexpr int kBN = (\d+);",
                                 body).group(1))
    assert "constexpr int kWideBN = 2 * kBN;" in body and tile == 2 * STEP


_CTYPES = {"void*": ctypes.c_void_p, "int*": ctypes.c_void_p,
           "float*": ctypes.c_void_p, "long long": ctypes.c_longlong,
           "int": ctypes.c_int}


def test_forward_signature_matches_the_source():
    """``_SIG["paddle_ce_fwd"]`` is the ``extern "C"`` entry's parameter
    list, read from ``csrc/fused_ce.cu``, one for one."""
    restype, argtypes = tfc._SIG["paddle_ce_fwd"]
    block = _SRC[_SRC.index('extern "C" {'):]
    m = re.search(r"\nint paddle_ce_fwd\(([^)]*)\)", block)
    assert m is not None and restype is ctypes.c_int
    params = [re.sub(r"\s*\w+$", "", p.strip()).replace("const ", "")
              .replace(" *", "*") for p in m.group(1).split(",")]
    assert [_CTYPES[p] for p in params] == list(argtypes), params
