"""The host side of the split-key decode kernels (TPU kernel table rows 5
and 7, ``csrc/flash_decode_split.cuh``), on the CPU: the split length
against the source, the grid's split count from the cache's capacity,
the scratch rule, the ctypes signatures of the decode libraries' C entry
points, and the design's arithmetic (per-split online softmax, then the
fold of the splits in split order) in fp32 against the plain version.
No JAX: the plain decode versions are held to the JAX package in
``tests/test_torch_port_kernels.py`` and ``test_torch_port_int8.py``.
"""
import ctypes
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as fa

_CSRC = Path(fa.__file__).resolve().parent.parent / "csrc"


def test_split_constants_match_the_source():
    src = (_CSRC / "flash_decode_split.cuh").read_text()
    m = re.search(r"#define PADDLE_DECODE_SPLIT (\d+)", src)
    assert m is not None and int(m.group(1)) == fa.DECODE_SPLIT_KEYS
    m = re.search(r"#define PADDLE_DECODE_CLUSTER_SPLITS (\d+)", src)
    assert m is not None and int(m.group(1)) == fa.DECODE_CLUSTER_SPLITS


@pytest.mark.parametrize("t_cap,n_split", [
    (1, 1), (128, 1), (129, 2), (200, 2), (640, 5),  # the serving cache
    (5 * 128, 5), (8 * 48, 3), (3 * 16, 1),          # page tables
    (2048, 16), (4096, 32)])
def test_splits_follow_the_capacity(t_cap, n_split):
    assert fa.decode_splits(t_cap) == n_split


@pytest.mark.parametrize("b,sq,hq,hk,t_cap,d,floats", [
    (8, 1, 12, 12, 640, 64, 0),                     # the serving step
    (1, 1, 12, 12, 640, 64, 0),                     # generate
    (8, 1, 12, 12, 1024, 64, 0),                    # 8 splits: a cluster
    (8, 1, 12, 12, 1025, 64, 8 * 12 * 9 * 66),      # 9: scratch
    (4, 2, 8, 2, 2048, 64, 4 * 2 * 16 * 4 * 2 * 66),  # grouped, verify
    (5, 8, 16, 1, 4096, 256, 5 * 32 * 16 * 8 * 258)])
def test_scratch_rule(b, sq, hq, hk, t_cap, d, floats):
    assert fa.decode_scratch_floats(b, sq, hq, hk, t_cap, d) == floats


_CTYPES = {"void*": ctypes.c_void_p, "int*": ctypes.c_void_p,
           "int64_t": ctypes.c_int64,
           "int64_t*": ctypes.POINTER(ctypes.c_int64),
           "int": ctypes.c_int, "float": ctypes.c_float}


@pytest.mark.parametrize("source,name", [
    ("flash_decode.cu", n) for n in fa._DECODE_SIG] + [
    ("flash_decode_paged.cu", n) for n in fa._PAGED_SIG])
def test_decode_signatures_match_the_source(source, name):
    """``_DECODE_SIG`` and ``_PAGED_SIG`` are the C entry points'
    parameters, read from the sources, one for one."""
    restype, argtypes = (fa._DECODE_SIG if source == "flash_decode.cu"
                         else fa._PAGED_SIG)[name]
    src = (_CSRC / source).read_text()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    assert m is not None and restype is ctypes.c_int
    params = [re.sub(r"\s*\w+$", "", p.strip()).replace("const ", "")
              .replace(" *", "*") for p in m.group(1).split(",")
              if p.strip()]
    assert [_CTYPES[p] for p in params] == list(argtypes), params


def _split_fold(q, k, v, kv_len, k_scale=None, v_scale=None):
    """The kernels' algorithm in fp32: base-2 scores on pre-scaled q
    (int8: times the key scale), each fixed split's (m, l, O) (int8: O
    over p times the value scale), then M = max m_s, L = sum l_s
    2^(m_s - M), O = sum O_s 2^(m_s - M), out = O / L over the splits
    holding a visible column of the row; rows seeing nothing give 0."""
    b, sq, hq, d = q.shape
    t, hk = k.shape[1], k.shape[2]
    g = hq // hk
    qs = q.float().reshape(b, sq, hk, g, d) * (1 / math.sqrt(d)) / math.log(2)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qs, k.float())
    if k_scale is not None:
        s = s * k_scale.float().permute(0, 2, 1)[:, :, None, None, :]
    pos = torch.arange(sq)[None, :, None]
    lim = (kv_len.long() - sq)[:, None, None] + pos            # [b, sq, 1]
    cols = torch.arange(t)[None, None, :]
    s = s.masked_fill(~(cols <= lim)[:, None, None], float("-inf"))
    vsc = None if v_scale is None else \
        v_scale.float().permute(0, 2, 1)[:, :, None, None, :]
    parts = []
    for c0 in range(0, t, fa.DECODE_SPLIT_KEYS):
        ss = s[..., c0:c0 + fa.DECODE_SPLIT_KEYS]
        m = ss.amax(-1, keepdim=True)
        p = torch.where(torch.isinf(ss), torch.zeros_like(ss),
                        torch.exp2(ss - m.clamp(min=-1e30)))
        pv = p if vsc is None else p * vsc[..., c0:c0 + fa.DECODE_SPLIT_KEYS]
        o = torch.einsum("bhgqk,bkhd->bhgqd", pv,
                         v[:, c0:c0 + fa.DECODE_SPLIT_KEYS].float())
        parts.append((m, p.sum(-1, keepdim=True), o))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    lsum = sum(torch.where(torch.isinf(m), torch.zeros_like(l),
                           l * torch.exp2(m - mx)) for m, l, _ in parts)
    out = sum(torch.where(torch.isinf(m), torch.zeros_like(o),
                          o * torch.exp2(m - mx)) for m, _, o in parts)
    out = torch.where(lsum > 0, out / lsum.clamp(min=1e-30),
                      torch.zeros_like(out))
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("sq,hq,hk,t", [(1, 4, 4, 200), (3, 6, 2, 331),
                                        (8, 4, 1, 640)])
def test_split_fold_equals_one_softmax(int8, sq, hq, hk, t):
    """Folding fixed splits in split order is the softmax over all
    visible columns (fp32, 1e-5), whatever split a row's last column
    falls in; a row with nothing visible gives zeros."""
    rng = np.random.default_rng(sq * 100 + t + int8)
    b, d = 5, 32
    q = torch.tensor(rng.standard_normal((b, sq, hq, d)), dtype=torch.float32)
    kv = torch.tensor([0, sq, 128, 129 + sq, t], dtype=torch.int32)
    if int8:
        k, v = (torch.tensor(rng.integers(-127, 128, (b, t, hk, d)),
                             dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.tensor(rng.uniform(0.005, 0.02, (b, t, hk)),
                               dtype=torch.float32).bfloat16()
                  for _ in range(2))
        ref = fa.flash_attention_decode_plain(q, k, v, kv, k_scale=ks,
                                              v_scale=vs)
        got = _split_fold(q, k, v, kv, ks, vs)
    else:
        k, v = (torch.tensor(rng.standard_normal((b, t, hk, d)),
                             dtype=torch.float32) for _ in range(2))
        ref = fa.flash_attention_decode_plain(q, k, v, kv)
        got = _split_fold(q, k, v, kv)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    assert got[0].abs().max().item() == 0.0
