"""The fused CE backward's three-product plan (TPU kernel table row 12,
``csrc/fused_ce.cu``'s ``paddle_ce_bwd``), on the CPU.

The kernels take the vocabulary in fixed chunks of vc columns, in order:
per chunk one product gives the logits and d, rounded to the element
type; dW_c = d_c^T @ h is written once; dh accumulates d_c @ W_c in fp32
over the chunks in chunk order and is rounded once. ``_chunked`` is that
algorithm written in torch; it is held against the port's plain
version (``ce_bwd_plain``, whole rows at once) and against the JAX
package's ``_bwd`` in interpret mode, at vocabulary sizes on and on
either side of a chunk edge. Tolerances: fp32 within 1e-5 (the same
fp32 d, its products summed in another order); bf16 by the fused-CE
rule of ``tests/test_torch_port_fused_ce.py`` (one bf16 ulp plus 1e-3 of
the largest magnitude: both round fp32 sums of the same bf16-rounded d,
taken in another order). The chunk plan and its scratch bytes are held
to the source's constants, and the ctypes signatures to its ``extern
"C"`` entries.
"""
import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.fused_ce import _bwd as jax_bwd
from paddle_tpu.kernels.fused_ce import _fwd as jax_fwd
from paddle_tpu_torch.kernels import fused_ce as tfc

_SRC = (Path(tfc.__file__).resolve().parents[1] / "csrc" /
        "fused_ce.cu").read_text()
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
N, H, VC = 70, 32, 128     # VC: a chunk as small as the plan allows


def _chunked(h, w, y, lse, dce, vc):
    """(dh, dW) of h [N, H], W [V, H] as the kernels compute them: for
    each vc-column chunk, d = (exp(logit - lse) - onehot) * s from fp32
    logits, rounded to the element type; dW_c = d_c^T @ h rounded once;
    dh = the fp32 sum over the chunks, in chunk order, of d_c @ W_c,
    rounded once at the end."""
    hf, wf = h.float(), w.float()
    s = torch.where(y >= 0, dce.float(), torch.zeros_like(dce.float()))
    acc = torch.zeros(hf.shape)
    dw = torch.empty_like(w)
    for v0 in range(0, w.shape[0], vc):
        wc = wf[v0:v0 + vc]
        cols = torch.arange(v0, v0 + wc.shape[0])
        p = torch.exp(hf @ wc.t() - lse[:, None])
        d = ((p - (cols[None, :] == y[:, None]).float()) * s[:, None]) \
            .to(h.dtype).float()
        dw[v0:v0 + vc] = (d.t() @ hf).to(w.dtype)
        acc = acc + d @ wc
    return acc.to(h.dtype), dw


def _inputs(vocab, dtype, seed):
    rng = np.random.RandomState(seed)
    h = rng.randn(N, H).astype(np.float32)
    w = (rng.randn(vocab, H) * 0.1).astype(np.float32)
    y = rng.randint(0, vocab, (N,))
    y[::7] = -1
    y[5] = vocab + 3                  # past the vocabulary: no onehot
    dce = rng.rand(N).astype(np.float32)
    tdt = getattr(torch, dtype)
    return (h, w, y, dce), (torch.tensor(h).to(tdt), torch.tensor(w).to(tdt),
                            torch.tensor(y), torch.tensor(dce))


def _close(out, ref, dtype):
    out, ref = out.float().numpy(), np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
        return
    big = np.maximum(np.abs(out), np.abs(ref))
    ulp = np.ldexp(np.float32(1.0), np.frexp(big)[1] - 8)
    bad = ~(np.abs(out - ref) <= ulp + 1e-3 * np.abs(ref).max())
    assert not bad.any(), (int(bad.sum()), float(np.abs(out - ref).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vocab", [VC - 1, VC, VC + 1, 2 * VC + 1, 3 * VC])
def test_chunked_backward_matches_plain_and_jax(dtype, vocab):
    (h, w, y, dce), (ht, wt, yt, dt) = _inputs(vocab, dtype, vocab)
    lse, _ = tfc.ce_fwd_plain(ht, wt, yt)
    dh, dw = _chunked(ht, wt, yt, lse, dt, VC)
    dh_p, dw_p = tfc.ce_bwd_plain(ht, wt, yt, lse, dt)
    _close(dh, dh_p.float(), dtype)
    _close(dw, dw_p.float(), dtype)
    assert bool((dh[yt < 0] == 0).all())
    jdt = _JDT[dtype]
    hj, wj, yj = jnp.asarray(h, jdt), jnp.asarray(w, jdt), jnp.asarray(
        y, jnp.int32)
    jlse, _ = jax_fwd(hj, wj, yj, True, 32, 64)
    jdh, jdw = jax_bwd(hj, wj, yj, jlse, jnp.asarray(dce), True, 32, 64)
    _close(dh, jdh.astype(jnp.float32), dtype)
    _close(dw, jdw.astype(jnp.float32), dtype)


def _source_constants():
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (kChunk\w+) = (\d+);", _SRC)}


def test_chunk_constants_match_the_source():
    c = _source_constants()
    assert (tfc._CHUNK_V, tfc._CHUNK_STEP) == (c["kChunkV"], c["kChunkStep"])
    assert c["kChunkV"] % c["kChunkStep"] == 0


# (N, H as the kernels take it, V, element bytes): gpt2-small's LM head
# and chip_smoke.py's other fused-CE shapes, chunk edges, tiny ones
@pytest.mark.parametrize("n,hd,vocab,elem", [
    (16368, 768, 50257, 2), (4093, 768, 50257, 2), (2045, 768, 8191, 4),
    (4093, 1024, 50257, 2), (2045, 1600, 50257, 2), (1027, 104, 8191, 4),
    (100, 64, 8191, 2), (100, 64, 8192, 2), (100, 64, 8193, 2),
    (100, 64, 16383, 4), (100, 64, 16384, 2), (100, 64, 16385, 4),
    (1, 8, 1, 4), (70, 32, 150, 2)])
def test_chunk_plan_covers_the_vocabulary_once(n, hd, vocab, elem):
    vc, chunks, scratch = tfc.ce_bwd_plan(n, vocab, hd, elem)
    assert vc % tfc._CHUNK_STEP == 0 and 0 < vc <= tfc._CHUNK_V
    assert (chunks - 1) * vc < vocab <= chunks * vc
    assert vc < vocab + tfc._CHUNK_STEP        # no chunk wider than needed
    assert scratch == n * vc * elem + (4 * n * hd if chunks > 1 else 0)


def test_lm_head_scratch_is_within_its_stated_bytes():
    """At gpt2-small's LM head (b16 s1024) the scratch is d [N, 8192]
    bf16 and the fp32 dh accumulator: under 512 MB, under a sixth of the
    3.3 GB of fp32 logits the saved-logits path keeps."""
    n, hd, vocab = 16368, 768, 50257
    vc, chunks, scratch = tfc.ce_bwd_plan(n, vocab, hd, 2)
    assert (vc, chunks) == (8192, 7)
    assert scratch == 268_173_312 + 50_282_496
    assert scratch < 512 * 2 ** 20
    assert scratch < n * vocab * 4 / 6


_CTYPES = {"void*": ctypes.c_void_p, "int*": ctypes.c_void_p,
           "float*": ctypes.c_void_p, "long long": ctypes.c_longlong,
           "int": ctypes.c_int}


@pytest.mark.parametrize("name", sorted(tfc._SIG))
def test_signatures_match_the_source(name):
    """``_SIG``'s ctypes types are the ``extern "C"`` entries' parameters,
    read from ``csrc/fused_ce.cu``, one for one."""
    restype, argtypes = tfc._SIG[name]
    block = _SRC[_SRC.index('extern "C" {'):]
    m = re.search(r"\nint " + name + r"\(([^)]*)\)", block)
    assert m is not None and restype is ctypes.c_int
    params = [re.sub(r"\s*\w+$", "", p.strip()).replace("const ", "")
              .replace(" *", "*") for p in m.group(1).split(",")
              if p.strip() and p.strip() != "void"]
    assert [_CTYPES[p] for p in params] == list(argtypes), params


def test_every_entry_has_a_signature():
    block = _SRC[_SRC.index('extern "C" {'):]
    assert sorted(re.findall(r"\nint (paddle_\w+)\(", block)) == \
        sorted(tfc._SIG)
