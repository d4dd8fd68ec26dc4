"""The port's int8 KV cache against the JAX package, on test-tiny in fp32
on the CPU.

- ``quantize_kv``, ``QuantKVCache`` and ``QuantPagedKVCache``: one
  script of operations through both packages gives bitwise equal int8
  values, bf16 scales, lengths and clip counts.
- The int8 modes of ``flash_attention_decode``, ``flash_attention_chunk``
  and ``flash_attention_decode_paged`` (their plain versions, what runs
  on the CPU) against the JAX public functions within 1e-5 + 1e-5·|ref|
  (fp32 sums in another order, exp against exp2), and against the
  Pallas bodies in interpret mode within 2e-4, the JAX package's own
  tolerance between its two paths; the port's paged int8 plain output
  is bitwise equal to its dense int8 plain output.
- Whole paths: int8 decode logits against JAX's within 1e-4 and against
  the port's own wide cache within the JAX package's bound
  (0.01·max(1, max|wide|)); greedy int8 ``generate`` tokens and the eos
  position equal JAX's; the dense, paged (copy-on-write) and chunked
  paged int8 engines equal sequential int8 ``generate`` of both
  packages (the JAX engine cannot be built here, ROADMAP C1); ``clips``
  stays 0 throughout.
"""
import importlib

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.generation import generate as jax_generate
from paddle_tpu.generation.kv_cache import KVCache as JKVCache
from paddle_tpu.generation.kv_cache import quantize_kv as jax_quantize
from paddle_tpu.generation.paged_cache import PagedKVCache as JPaged
from paddle_tpu.jit.api import functional_call
from paddle_tpu.models.gpt import gpt as jax_gpt
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.generation import (GenerationSession, KVCache,
                                         PagedKVCache, generate)
from paddle_tpu_torch.generation.kv_cache import (QuantKVCache,
                                                  quantize_kv,
                                                  resolve_cache_dtype)
from paddle_tpu_torch.generation.paged_cache import QuantPagedKVCache
from paddle_tpu_torch.inference import Config
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.models.gpt import gpt
from paddle_tpu_torch.serving import (RequestParams, RequestStatus,
                                      ServingEngine)

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")

ATOL = RTOL = 1e-5
INTERPRET_TOL = 2e-4
LOGIT_TOL = 1e-4


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _np(x):
    """A port or JAX array as numpy (bf16 widened to fp32 exactly)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


# the JAX caches' ops, jitted once per shape (eagerly each jnp op would
# compile on its own)
_j_update = jax.jit(lambda c, layer, k, v, pos: c.update(layer, k, v, pos),
                    static_argnums=1)
_j_install_row = jax.jit(lambda c, src, slot, row, start:
                         c.install_row(src, slot, row, start))
_j_install_span = jax.jit(lambda c, src, row, start:
                          c.install_span(src, row, start))


def _same(port, ref, names):
    for name in names:
        np.testing.assert_array_equal(_np(getattr(port, name)),
                                      _np(getattr(ref, name)), err_msg=name)


# ----------------------------------------------------------- quantizer


def test_quantize_kv_bitwise():
    """Values, scales and clips bitwise equal to JAX's, over tokens whose
    magnitudes span 1e-3..1e3, with all-zero rows (the 1e-6 floor: the
    scale is bf16(1e-6 / 127), not 0) and exact half-step ties."""
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 7, 4, 16)
         * rng.lognormal(0, 2, (3, 7, 4, 1))).astype(np.float32)
    x[0, 2] = 0.0                              # every head of one token
    x[1, 3, 1] = 0.0                           # one head
    x[2, 4, 0] = np.arange(16) - 7.5           # ties at .5 of the step
    x[2, 4, 0, 0] = 127.0
    q, s, c = quantize_kv(torch.from_numpy(x))
    jq, js, jc = jax_quantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
    assert c.dtype == torch.int32 and c.dim() == 0 and int(c) == 0
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_np(s), _np(js))
    assert int(c) == int(jc)
    assert float(s[0, 2, 0]) == float(torch.tensor(1e-6 / 127).bfloat16())


def _cache_pair(layers, batch, t, h, d):
    return (KVCache.create(layers, batch, t, h, d, device="cpu",
                           cache_dtype="int8"),
            JKVCache.create(layers, batch, t, h, d, cache_dtype="int8"))


def test_quant_cache_ops_match_jax():
    """update (ragged positions, a ring wrap), with_kv_len, reset_rows
    (index and mask) and copy_row_from through both caches: equal int8
    values, scales, lengths and clips; the port updates in place and
    keeps its class."""
    L, B, T, H, D = 2, 3, 8, 2, 4
    rng = np.random.RandomState(1)
    tc, jc = _cache_pair(L, B, T, H, D)
    assert isinstance(tc, QuantKVCache) and tc.cache_dtype == "int8"
    for layer, s, pos in ((0, 3, None), (1, 3, None),
                          (0, 2, np.array([6, 3, 0], np.int32))):
        kn, vn = _rand(rng, B, s, H, D), _rand(rng, B, s, H, D)
        tpos = tc.kv_len if pos is None else torch.from_numpy(pos)
        jpos = jc.kv_len if pos is None else jnp.asarray(pos)
        assert tc.update(layer, torch.from_numpy(kn), torch.from_numpy(vn),
                         tpos) is tc
        jc = _j_update(jc, layer, jnp.asarray(kn), jnp.asarray(vn), jpos)
    tc.with_kv_len(3)
    jc = jc.with_kv_len(3)
    _same(tc, jc, ("k", "v", "k_scale", "v_scale", "kv_len", "clips"))
    tc.reset_rows(1).reset_rows(torch.tensor([False, False, True]))
    jc = jc.reset_rows(1).reset_rows(jnp.asarray([False, False, True]))
    assert isinstance(tc, QuantKVCache)
    _same(tc, jc, ("kv_len",))
    assert tc.kv_len.tolist() == [3, 0, 0]
    td, jd = _cache_pair(L, B, T, H, D)
    td.clips.fill_(2)
    jd.clips = jnp.asarray(2, jnp.int32)
    td.copy_row_from(tc, 0, 2)
    jd = jd.copy_row_from(jc, 0, 2)
    _same(td, jd, ("k", "v", "k_scale", "v_scale", "kv_len", "clips"))
    assert int(td.clips) == 2


def _quant_row(rng, layers, t, h, d, length):
    """A batch-1 int8 prefill row in both packages (same content)."""
    tr, jr = _cache_pair(layers, 1, t, h, d)
    for layer in range(layers):
        k, v = _rand(rng, 1, length, h, d), _rand(rng, 1, length, h, d)
        tr.update(layer, torch.from_numpy(k), torch.from_numpy(v), 0)
        jr = _j_update(jr, layer, jnp.asarray(k), jnp.asarray(v), jr.kv_len)
    tr.with_kv_len(length)
    return tr, jr.with_kv_len(length)


def test_quant_paged_cache_ops_match_jax():
    """install_row (a shared first page skipped), install_span, update
    (live rows, an idle lane, a write past the table) and reset_rows
    through both int8 pools: equal values and scales past the null page,
    tables, lengths; clips fold once per install_row and never per
    install_span."""
    L, B, n_pages, ps, P, H, D = 2, 3, 10, 4, 4, 2, 8
    rng = np.random.RandomState(2)
    tc = PagedKVCache.create(L, B, n_pages, ps, P, H, D, device="cpu",
                             cache_dtype="int8")
    jc = JPaged.create(L, B, n_pages, ps, P, H, D, cache_dtype="int8")
    assert isinstance(tc, QuantPagedKVCache)
    for slot, row, start, length in ((0, [1, 2, 3, 0], 0, 10),
                                     (1, [1, 4, 0, 0], 4, 7)):
        tr, jr = _quant_row(rng, L, 16, H, D, length)
        tr.clips.fill_(1)
        jr.clips = jnp.asarray(1, jnp.int32)
        tc.install_row(tr, slot, torch.tensor(row, dtype=torch.int32), start)
        jc = _j_install_row(jc, jr, slot, np.array(row, np.int32), start)
    tr, jr = _quant_row(rng, L, 16, H, D, 12)
    tr.clips.fill_(5)
    jr.clips = jnp.asarray(5, jnp.int32)
    tc.install_span(tr, torch.tensor([5, 6, 7, 0]), 4)
    jc = _j_install_span(jc, jr, np.array([5, 6, 7, 0], np.int32), 4)
    assert int(tc.clips) == 2                 # two install_rows, no span
    for layer, s, pos in ((1, 1, None), (0, 2, np.array([15, 3, 0]))):
        kn, vn = _rand(rng, B, s, H, D), _rand(rng, B, s, H, D)
        jpos = jc.kv_len if pos is None else jnp.asarray(pos, jnp.int32)
        tpos = tc.kv_len if pos is None else torch.from_numpy(pos)
        jc = _j_update(jc, layer, jnp.asarray(kn), jnp.asarray(vn), jpos)
        tc.update(layer, torch.from_numpy(kn), torch.from_numpy(vn), tpos)
        jc = jc.with_kv_len(jc.kv_len + s)
        tc.with_kv_len(tc.kv_len + s)
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(_np(getattr(tc, name))[:, 1:],
                                      _np(getattr(jc, name))[:, 1:],
                                      err_msg=name)
    _same(tc, jc, ("page_table", "kv_len", "clips"))
    assert not tc.k[:, 8:].any() and not tc.k_scale[:, 8:].any()
    tc.reset_rows(1).reset_rows(torch.tensor([False, False, True]))
    jc = jc.reset_rows(1).reset_rows(jnp.asarray([False, False, True]))
    assert isinstance(tc, QuantPagedKVCache)
    _same(tc, jc, ("page_table", "kv_len"))


# -------------------------------------------------------------- kernels


def _int8_cache(rng, b, t, hk, d):
    k8 = rng.randint(-127, 128, (b, t, hk, d)).astype(np.int8)
    v8 = rng.randint(-127, 128, (b, t, hk, d)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, (b, t, hk)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (b, t, hk)).astype(np.float32)
    return k8, v8, ks, vs


def _bf16(x):
    """fp32 numpy -> (bf16 torch tensor, the same values as bf16 jnp)."""
    t = torch.from_numpy(x).bfloat16()
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _dense_call(fn, jfn, q, k8, v8, ks, vs, kv):
    tks, jks = _bf16(ks)
    tvs, jvs = _bf16(vs)
    out = fn(torch.from_numpy(q), torch.from_numpy(k8), torch.from_numpy(v8),
             torch.from_numpy(kv), k_scale=tks, v_scale=tvs)
    ref = jfn(jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8),
              jnp.asarray(kv), k_scale=jks, v_scale=jvs)
    return out.numpy(), np.asarray(ref)


@pytest.mark.parametrize("sq,hq,hk", [(1, 4, 4), (1, 4, 2), (3, 6, 2),
                                      (8, 4, 4)])
def test_int8_decode_matches_jax(sq, hq, hk):
    """Ragged kv_len (sq exactly, off every grid, full), grouped heads,
    1..8 query rows."""
    rng = np.random.RandomState(10 * sq + hq + hk)
    b, t, d = 3, 48, 16
    k8, v8, ks, vs = _int8_cache(rng, b, t, hk, d)
    q = _rand(rng, b, sq, hq, d)
    kv = np.array([sq, 29, t], np.int32)
    tfa.reset_counts()
    out, ref = _dense_call(tfa.flash_attention_decode,
                           jfa.flash_attention_decode, q, k8, v8, ks, vs, kv)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    assert tfa.flash_attention_decode_plain.calls_int8 == 1
    assert tfa.flash_attention_decode_plain.calls == 0


@pytest.mark.parametrize("sq,hq,hk", [(9, 4, 4), (33, 4, 2), (130, 6, 2)])
def test_int8_chunk_matches_jax(sq, hq, hk):
    rng = np.random.RandomState(sq + hq + hk)
    b, t, d = 3, 256, 16
    k8, v8, ks, vs = _int8_cache(rng, b, t, hk, d)
    q = _rand(rng, b, sq, hq, d)
    kv = np.array([sq, sq + 3, t], np.int32)
    tfa.reset_counts()
    out, ref = _dense_call(tfa.flash_attention_chunk,
                           jfa.flash_attention_chunk, q, k8, v8, ks, vs, kv)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    assert tfa.flash_attention_chunk_plain.calls_int8 == 1


def _int8_paged(rng, b, hk, page, t, d=16):
    """Int8 pools and bf16 scale pools with a null page 0 and shuffled
    pages, the table, and the dense int8 cache with the same rows."""
    n_slots = t // page
    n_pages = 1 + b * n_slots
    k8, v8, ks, vs = _int8_cache(rng, n_pages, page, hk, d)
    table = (1 + rng.permutation(b * n_slots)).reshape(b, n_slots)
    table = table.astype(np.int32)
    dense = [a[table].reshape((b, t) + a.shape[2:]) for a in (k8, v8, ks, vs)]
    return (k8, v8, ks, vs), table, dense


@pytest.mark.parametrize("page,hq,hk,sq", [(4, 4, 4, 1), (8, 4, 2, 3),
                                           (16, 4, 2, 8)])
def test_int8_paged_decode_matches_jax_and_dense(page, hq, hk, sq):
    """Against the JAX public function (its gather fallback on the CPU),
    and bitwise equal to the port's dense int8 plain output on the same
    logical rows."""
    rng = np.random.RandomState(page + sq + hk)
    b, t, d = 4, 48, 16
    (k8, v8, ks, vs), table, dense = _int8_paged(rng, b, hk, page, t)
    q = _rand(rng, b, sq, hq, d)
    kv = np.array([sq, sq + 1, 29, t], np.int32)
    tks, jks = _bf16(ks)
    tvs, jvs = _bf16(vs)
    args = [torch.from_numpy(a) for a in (q, k8, v8, table, kv)]
    out = tfa.flash_attention_decode_paged(*args, k_scale=tks, v_scale=tvs)
    ref = np.asarray(jfa.flash_attention_decode_paged(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(table),
        jnp.asarray(kv), k_scale=jks, v_scale=jvs))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)
    dk8, dv8, dks, dvs = dense
    flat = tfa.flash_attention_decode(
        args[0], torch.from_numpy(dk8), torch.from_numpy(dv8), args[4],
        k_scale=_bf16(dks)[0], v_scale=_bf16(dvs)[0])
    assert torch.equal(out, flat)


def _interpret_inputs(seed, sq):
    """The JAX package's int8 interpret tests' inputs
    (tests/test_quant_cache.py, tests/test_chunked_prefill.py): B*Hk
    rows of T = 128, D = 64, as one kv head of batch B."""
    rng = np.random.RandomState(seed)
    B, T, D = 2, 128, 64
    k8 = rng.randint(-127, 128, (B, T, D)).astype(np.int8)
    v8 = rng.randint(-127, 128, (B, T, D)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, (B, T)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (B, T)).astype(np.float32)
    q = rng.randn(B, sq, D).astype(np.float32)
    return q, k8, v8, ks, vs


@pytest.mark.parametrize("body,seed,sq,kv", [
    ("decode", 2, 2, (37, 100)), ("chunk", 3, 12, (37, 100))])
def test_int8_matches_pallas_interpret(body, seed, sq, kv):
    """Against ``_decode_pallas`` and ``_chunk_pallas`` in interpret mode
    with scales, at the shapes of the JAX package's own tests."""
    q, k8, v8, ks, vs = _interpret_inputs(seed, sq)
    kv = np.array(kv, np.int32)
    d = q.shape[-1]
    tks, jks = _bf16(ks)
    tvs, jvs = _bf16(vs)
    pallas = jfa._decode_pallas if body == "decode" else jfa._chunk_pallas
    ref = np.asarray(pallas(jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8),
                            jnp.asarray(kv), float(d ** -0.5),
                            k_scale=jks, v_scale=jvs))
    fn = tfa.flash_attention_decode if body == "decode" \
        else tfa.flash_attention_chunk
    # [B*Hk, sq, D] rows as batch rows of one head
    out = fn(torch.from_numpy(q)[:, :, None], torch.from_numpy(k8)[:, :, None],
             torch.from_numpy(v8)[:, :, None], torch.from_numpy(kv),
             k_scale=tks[:, :, None], v_scale=tvs[:, :, None])
    np.testing.assert_allclose(out[:, :, 0].numpy(), ref,
                               atol=INTERPRET_TOL, rtol=INTERPRET_TOL)


def test_int8_wrapper_contract_on_the_cpu():
    """An int8 cache without scales raises the JAX package's ValueError;
    scales of the wrong shape raise; mixed k/v dtypes raise; int8 plain
    calls count under their own names."""
    rng = np.random.RandomState(4)
    k8, v8, ks, vs = (torch.from_numpy(a) for a in _int8_cache(rng, 2, 16, 2,
                                                               16))
    q = torch.from_numpy(_rand(rng, 2, 1, 2, 16))
    kv = torch.tensor([5, 16], dtype=torch.int32)
    for fn in (tfa.flash_attention_decode, tfa.flash_attention_chunk):
        with pytest.raises(ValueError, match="int8 caches need k_scale"):
            fn(q, k8, v8, kv)
        with pytest.raises(ValueError, match="k_scale must be"):
            fn(q, k8, v8, kv, k_scale=ks[:1], v_scale=vs)
    with pytest.raises(TypeError):
        tfa.flash_attention_decode(q, k8, v8.float(), kv, k_scale=ks,
                                   v_scale=vs)
    table = torch.tensor([[1], [0]], dtype=torch.int32)
    with pytest.raises(ValueError, match="int8 pools need k_scale"):
        tfa.flash_attention_decode_paged(q, k8, v8, table, kv)
    tfa.reset_counts()
    tfa.flash_attention_decode_paged(q, k8, v8, table, kv, k_scale=ks,
                                     v_scale=vs)
    assert tfa.flash_attention_decode_paged_plain.calls_int8 == 1
    assert tfa.flash_attention_decode_paged_plain.calls == 0
    assert tfa.flash_attention_decode_paged.launches_int8 == 0


# ---------------------------------------------------------------- model


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    jm = jax_gpt("test-tiny")
    jm.eval()
    tm = gpt("test-tiny", device="cpu")
    load_reference_state(
        tm, {k: np.asarray(v._data) for k, v in jm.state_dict().items()})
    tm.eval()
    return jm, tm


def test_int8_decode_logits(pair):
    """Prefill into an int8 cache, then a decode step: logits within
    1e-4 of JAX's over its int8 cache, the caches bitwise equal, and
    within the JAX package's bound of the port's wide-cache logits."""
    jm, tm = pair
    ids = np.random.RandomState(0).randint(0, 512, (1, 24)).astype(np.int32)
    plen = np.full((1,), 24, np.int32)
    with torch.no_grad():
        _, cw = tm(torch.as_tensor(ids), use_cache=True,
                   prompt_len=torch.as_tensor(plen), cache_max_len=128)
        _, cq = tm(torch.as_tensor(ids), use_cache=True,
                   prompt_len=torch.as_tensor(plen), cache_max_len=128,
                   cache_dtype="int8")
    state = jm.state_dict()
    names, vals = list(state), tuple(t._data for t in state.values())

    @jax.jit
    def jax_forward(vals, ids, cache):        # the JAX model, compiled
        kw = dict(use_cache=True, prompt_len=Tensor(plen), cache_max_len=128,
                  cache_dtype="int8") if cache is None else dict(cache=cache)
        logits, cache = functional_call(jm, dict(zip(names, vals)),
                                        Tensor(ids), **kw)
        return logits._data, cache

    _, jq = jax_forward(vals, ids, None)
    assert isinstance(cq, QuantKVCache)
    t = np.array([[3]], np.int32)
    with torch.no_grad():
        lw, cw = tm(torch.as_tensor(t), cache=cw)
        lq, cq = tm(torch.as_tensor(t), cache=cq)
    jl, jq = jax_forward(vals, t, jq)
    np.testing.assert_allclose(lq.numpy(), np.asarray(jl),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    wide = lw.numpy()
    assert np.abs(wide - lq.numpy()).max() <= \
        0.01 * max(1.0, np.abs(wide).max())
    _same(cq, jq, ("k", "v", "k_scale", "v_scale", "kv_len", "clips"))
    assert int(cq.clips) == 0


def test_int8_greedy_tokens_and_eos_position(pair):
    """Greedy int8 ``generate`` equals JAX's token for token, and stops
    at the same eos position as the port's wide cache (the eos is a
    token the wide stream emits mid-sequence, as in the JAX package's
    parity test)."""
    jm, tm = pair
    ids = np.random.RandomState(5).randint(0, 512, (2, 20))
    wide = generate(tm, ids, 16).numpy()
    eos = int(wide[0, 4])
    w = generate(tm, ids, 16, eos_token_id=eos).numpy()
    q = generate(tm, ids, 16, eos_token_id=eos,
                 kv_cache_dtype="int8").numpy()
    jq = np.asarray(jax_generate(jm, ids.astype(np.int32), 16,
                                 eos_token_id=eos,
                                 kv_cache_dtype="int8")._data)
    np.testing.assert_array_equal(q, jq)
    for row in range(2):
        cut = [int(np.argmax(a[row] == eos)) if eos in a[row] else 16
               for a in (w, q)]
        assert cut[0] == cut[1]
        np.testing.assert_array_equal(w[row][:cut[0]], q[row][:cut[1]])
    assert eos in q[0]


# -------------------------------------------------------------- engines


def _config(tm, *, max_new=8, buckets=(16,), max_batch=2,
            kv_cache_dtype="int8", **serving):
    return (Config().from_layer(tm).disable_gpu()
            .enable_generation(max_new_tokens=max_new,
                               prefill_buckets=buckets, max_batch=max_batch,
                               kv_cache_dtype=kv_cache_dtype)
            .enable_serving(**serving))


def _drain(eng):
    while eng.busy:
        eng.step()
        assert int(eng._cache.clips) == 0


def _sequential(pair, prompt, budget, buckets, cache_len):
    """Sequential batch-1 int8 generate at the engine's bucket and cache
    geometry, in the port and in JAX; asserts they agree."""
    jm, tm = pair
    bucket = next(b for b in buckets if b >= prompt.size)
    ids = np.zeros((1, bucket), np.int32)
    ids[0, :prompt.size] = prompt
    plen = np.array([prompt.size], np.int32)
    port = generate(tm, ids, budget, prompt_len=plen,
                    cache_max_len=cache_len, kv_cache_dtype="int8").numpy()[0]
    ref = np.asarray(jax_generate(jm, ids, budget, prompt_len=plen,
                                  cache_max_len=cache_len,
                                  kv_cache_dtype="int8")._data)[0]
    np.testing.assert_array_equal(port, ref)
    return port


def test_int8_engine_ragged_equals_sequential(pair):
    """The dense int8 engine under ragged traffic with mid-decode
    arrivals (tests/test_quant_cache.py's traffic): every request equals
    sequential int8 generate, port and JAX; clips stay 0."""
    _, tm = pair
    eng = ServingEngine(_config(tm), poll_every=2)
    assert isinstance(eng._cache, QuantKVCache)
    rng = np.random.RandomState(0)
    lens, budgets = (5, 12, 14, 7, 3), (8, 3, 6, 5, 8)
    prompts = [rng.randint(0, 512, n).astype(np.int32) for n in lens]
    handles = [eng.submit(p, RequestParams(max_new_tokens=b))
               for p, b in zip(prompts[:2], budgets[:2])]
    for _ in range(3):
        eng.step()
    handles += [eng.submit(p, RequestParams(max_new_tokens=b))
                for p, b in zip(prompts[2:], budgets[2:])]
    _drain(eng)
    assert all(h.status is RequestStatus.COMPLETED for h in handles)
    assert eng.stats["slots_reused"] >= 3
    for p, b, h in zip(prompts, budgets, handles):
        np.testing.assert_array_equal(
            h.result(), _sequential(pair, p, b, eng.buckets, eng.max_len)[:b])


def test_int8_paged_engine_cow(pair):
    """int8 pages x shared-prefix copy-on-write (page 16, two identical
    20-token prompts): the second references the first's full page and
    privatizes the partial tail, values and scales together; one prefix
    hit, one COW copy, both equal sequential int8 generate; the pool is
    conserved."""
    _, tm = pair
    eng = ServingEngine(_config(tm, buckets=(16, 32), paged=True,
                                kv_page_size=16), poll_every=2)
    assert isinstance(eng._cache, QuantPagedKVCache)
    prompt = np.random.RandomState(3).randint(0, 512, 20).astype(np.int32)
    h1 = eng.submit(prompt, RequestParams(max_new_tokens=6))
    _drain(eng)
    h2 = eng.submit(prompt.copy(), RequestParams(max_new_tokens=8))
    _drain(eng)
    s = eng._alloc.stats
    assert (s["prefix_hits"], s["cow_copies"]) == (1, 1)
    for h, b in ((h1, 6), (h2, 8)):
        np.testing.assert_array_equal(
            h.result(), _sequential(pair, prompt, b, eng.buckets,
                                    eng.max_len)[:b])
    assert eng._alloc.used_pages() == 0
    eng._alloc.assert_conserved()


def test_int8_chunked_paged_engine(pair):
    """Chunked admission over the int8 pool (page 8, chunk 8; span
    installs, then the final commit), arrivals mid-decode: every request
    equals sequential int8 generate, 0 pages in use after the drain, the
    side cache left zeroed (kv_len 0, clips 0)."""
    _, tm = pair
    eng = ServingEngine(_config(tm, buckets=(16, 32), paged=True,
                                kv_page_size=8, prefill_chunk_tokens=8,
                                max_queue=8), poll_every=2)
    assert isinstance(eng._row_cache, QuantKVCache)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 512, n).astype(np.int32)
               for n in (5, 24, 12, 20, 7)]
    handles = [eng.submit(prompts[0])]
    for _ in range(2):
        eng.step()
    handles += [eng.submit(p) for p in prompts[1:]]
    _drain(eng)
    assert all(h.status is RequestStatus.COMPLETED for h in handles)
    assert eng.stats["prefill_chunks"] >= 6
    for h, p in zip(handles, prompts):
        np.testing.assert_array_equal(
            h.tokens, _sequential(pair, p, 8, eng.buckets, eng.max_len))
    assert eng._alloc.used_pages() == 0
    eng._alloc.assert_conserved()
    assert int(eng._row_cache.kv_len[0]) == 0
    assert int(eng._row_cache.clips) == 0
    assert not eng._row_cache.k.any()


# -------------------------------------------------------------- surface


def test_int8_config_and_env_knobs(pair, monkeypatch):
    """The config validates eagerly with the JAX package's message; the
    serving value wins over the generation one; PADDLE_KV_CACHE_DTYPE
    fills the gap and garbage in it falls back to full width."""
    _, tm = pair
    for bad in (lambda: Config().enable_generation(kv_cache_dtype="int3"),
                lambda: Config().enable_serving(kv_cache_dtype="int4")):
        with pytest.raises(ValueError, match=r"kv_cache_dtype .*: one of "
                                             r"\['int8'\] or None"):
            bad()
    assert resolve_cache_dtype(None) is None
    assert resolve_cache_dtype("int8") == "int8"
    monkeypatch.setenv("PADDLE_KV_CACHE_DTYPE", "int8")
    assert resolve_cache_dtype(None) == "int8"
    assert ServingEngine(_config(tm, kv_cache_dtype=None)).cache_dtype \
        == "int8"
    for value in ("garbage", "off"):
        monkeypatch.setenv("PADDLE_KV_CACHE_DTYPE", value)
        assert resolve_cache_dtype(None) is None
    eng = ServingEngine(_config(tm, kv_cache_dtype=None))
    assert eng.cache_dtype is None and eng._cache.cache_dtype is None
    cfg = _config(tm, kv_cache_dtype=None)
    cfg.enable_serving(kv_cache_dtype="int8")
    assert ServingEngine(cfg).cache_dtype == "int8"


def test_generate_session_dtype_mismatch_raises(pair):
    _, tm = pair
    ids = np.arange(1, 9)[None]
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        generate(tm, ids, 4, session=GenerationSession(tm),
                 kv_cache_dtype="int8")
    sess = GenerationSession(tm, cache_dtype="int8")
    np.testing.assert_array_equal(
        generate(tm, ids, 4, session=sess).numpy(),
        generate(tm, ids, 4, kv_cache_dtype="int8").numpy())
