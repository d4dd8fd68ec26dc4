"""The port's chunked prefill against the JAX package, on test-tiny in
fp32 on the CPU.

- ``flash_attention_chunk`` (its plain version, what runs on the CPU)
  against the JAX function within 1e-5 (fp32 sums in another order,
  exp against exp2), and once against the q-tiled Pallas body in
  interpret mode.
- The decode-mode forward with ``prompt_len`` (the final chunk) against
  the JAX model's logits within 1e-4, as the other model tests.
- The chunked ``ServingEngine``, dense and paged: the JAX engine cannot
  be built here (ROADMAP C1), so it is held to what the reference tests
  state: chunked tokens equal sequential ``generate()``, a
  PENDING_PREFILL slot is never decoded, one chunked admission at a
  time in FIFO order, a deadline mid-prefill releases the pages, and
  ``assert_conserved()`` holds after each paged engine test.
"""
import importlib
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.generation import generate as jax_generate
from paddle_tpu.generation.kv_cache import KVCache as JKVCache
from paddle_tpu.models.gpt import gpt as jax_gpt
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.generation import KVCache, generate
from paddle_tpu_torch.inference import Config
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.models.gpt import gpt
from paddle_tpu_torch.serving import (RequestParams, RequestStatus,
                                      ServingEngine)

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")

ATOL = RTOL = 1e-5


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


# ------------------------------------------------------------- kernel


@pytest.mark.parametrize("sq,hq,hk", [(9, 4, 4), (33, 4, 2), (130, 4, 4),
                                      (130, 6, 2)])
def test_chunk_matches_jax(sq, hq, hk):
    """Port plain chunk attention vs the JAX public function, windows
    past the decode kernel's 8-row cap, grouped heads, ragged kv_len."""
    rng = np.random.RandomState(sq + hq + hk)
    b, d, t = 3, 16, 256
    kv = np.array([sq, sq + 3, t], np.int32)
    q = _rand(rng, b, sq, hq, d)
    kc, vc = _rand(rng, b, t, hk, d), _rand(rng, b, t, hk, d)
    ref = np.asarray(jfa.flash_attention_chunk(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kv)))
    out = tfa.flash_attention_chunk(
        *(torch.from_numpy(a) for a in (q, kc, vc, kv))).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_chunk_matches_pallas_interpret():
    """Against the q-tiled Pallas body in interpret mode, at the JAX
    package's own interpret test's shapes (a padded tail tile)."""
    rng = np.random.RandomState(2)
    b, hq, hk, d, t, sq = 2, 4, 2, 64, 256, 20
    kv = np.array([sq + 5, 250], np.int32)
    q = _rand(rng, b, sq, hq, d)
    kc, vc = _rand(rng, b, t, hk, d), _rand(rng, b, t, hk, d)
    qt = jnp.swapaxes(jnp.asarray(q), 1, 2).reshape(b * hq, sq, d)
    kt = jnp.swapaxes(jnp.asarray(kc), 1, 2).reshape(b * hk, t, d)
    vt = jnp.swapaxes(jnp.asarray(vc), 1, 2).reshape(b * hk, t, d)
    ref = jfa._chunk_pallas(qt, kt, vt, jnp.repeat(jnp.asarray(kv), hk),
                            1.0 / np.sqrt(d), block_k=128, group=hq // hk)
    ref = np.asarray(jnp.swapaxes(ref.reshape(b, hq, sq, d), 1, 2))
    out = tfa.flash_attention_chunk(
        *(torch.from_numpy(a) for a in (q, kc, vc, kv))).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_chunk_wrapper_contract_on_the_cpu():
    """No 8-row cap; rows whose limit is below 0 give zeros; a CPU
    tensor runs the plain version, counted apart from decode's."""
    rng = np.random.RandomState(5)
    q = torch.from_numpy(_rand(rng, 2, 20, 2, 16))
    kc = torch.from_numpy(_rand(rng, 2, 32, 2, 16))
    kv = torch.tensor([5, 32], dtype=torch.int32)
    tfa.reset_counts()
    out = tfa.flash_attention_chunk(q, kc, kc, kv)
    assert out.shape == q.shape
    assert torch.all(out[0, :15] == 0) and torch.all(out[0, 15:] != 0)
    assert tfa.flash_attention_chunk_plain.calls == 1
    assert tfa.flash_attention_decode_plain.calls == 0
    assert tfa.flash_attention_chunk.launches == 0
    with pytest.raises(ValueError, match="kv_len"):
        tfa.flash_attention_chunk(q, kc, kc, kv[:1])


# -------------------------------------------------------------- model


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


def test_final_chunk_forward_matches_jax(pair):
    """Two 16-token chunks of a 27-token prompt into a batch-1 cache,
    the last padded and carrying prompt_len: the logits at the last real
    position and kv_len match the JAX model's, and the logits match a
    one-shot prefill of the prompt."""
    jm, tm = pair
    rng = np.random.RandomState(6)
    C, plen = 16, 27
    ids = np.zeros((1, 2 * C), np.int64)
    ids[0, :plen] = rng.randint(0, 512, plen)
    layers, heads, hd = 2, 4, 16
    jc = JKVCache.create(layers, 1, 64, heads, hd)
    tc = KVCache.create(layers, 1, 64, heads, hd)
    pl = np.array([plen], np.int32)
    with torch.no_grad():
        for k in range(2):
            chunk = ids[:, k * C:(k + 1) * C]
            kw = dict(prompt_len=pl) if k == 1 else {}
            j_logits, jc = jm(paddle.to_tensor(chunk.astype(np.int32)),
                              cache=jc, **{k_: paddle.to_tensor(v)
                                           for k_, v in kw.items()})
            t_logits, tc = tm(torch.as_tensor(chunk), cache=tc,
                              **{k_: torch.as_tensor(v)
                                 for k_, v in kw.items()})
        full, _ = tm(torch.as_tensor(ids[:, :plen]), use_cache=True,
                     cache_max_len=64)
    assert t_logits.shape == (1, 1, 512)
    np.testing.assert_allclose(t_logits.numpy(),
                               np.asarray(j_logits._data), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_array_equal(tc.kv_len.numpy(), np.asarray(jc.kv_len))
    assert int(tc.kv_len[0]) == plen
    np.testing.assert_allclose(t_logits.numpy(), full.numpy(), atol=1e-4,
                               rtol=1e-4)


# -------------------------------------------------------------- engine


def _config(tm, *, max_new=8, buckets=(16, 32), max_batch=2, **serving):
    return (Config().from_layer(tm).disable_gpu()
            .enable_generation(max_new_tokens=max_new,
                               prefill_buckets=buckets, max_batch=max_batch)
            .enable_serving(**serving))


def _drain(eng):
    while eng.busy:
        eng.step()


@pytest.mark.parametrize("serving", [
    dict(prefill_chunk_tokens=8),
    dict(prefill_chunk_tokens=12),
    dict(prefill_chunk_tokens=8, paged=True, kv_page_size=8),
    dict(prefill_chunk_tokens=8, paged=True, kv_page_size=4),
], ids=["dense8", "dense12", "paged8", "paged4-chunk8"])
def test_chunked_engine_equals_sequential_generate(pair, serving):
    """Ragged traffic of short (inline) and long (chunked) prompts,
    arrivals mid-decode: every request's tokens equal the port's
    sequential generate() for its prompt; two also equal JAX
    generate()."""
    jm, tm = pair
    eng = ServingEngine(_config(tm, **serving), poll_every=2)
    rng = np.random.RandomState(0)
    lens = (25, 5, 31, 12, 17, 3, 30)
    budgets = (8, 3, 6, 5, 8, 2, 7)
    prompts = [rng.randint(0, 512, n) for n in lens]
    handles = [eng.submit(p, RequestParams(max_new_tokens=b))
               for p, b in zip(prompts[:2], budgets[:2])]
    for _ in range(3):
        eng.step()
    handles += [eng.submit(p, RequestParams(max_new_tokens=b))
                for p, b in zip(prompts[2:], budgets[2:])]
    _drain(eng)
    C = serving["prefill_chunk_tokens"]
    assert eng.stats["prefill_chunks"] == sum(-(-n // C) for n in lens
                                              if n > C)
    assert eng.stats["prefills"] == len(lens)
    for p, b, h in zip(prompts, budgets, handles):
        assert h.status is RequestStatus.COMPLETED
        np.testing.assert_array_equal(h.result(),
                                      generate(tm, p[None], b).numpy()[0])
    for p, b, h in list(zip(prompts, budgets, handles))[:3:2]:
        ref = np.asarray(jax_generate(jm, p[None].astype(np.int32),
                                      b)._data)[0]
        np.testing.assert_array_equal(h.result(), ref)
    if eng._alloc is not None:
        assert eng._alloc.used_pages() == 0
        eng._alloc.assert_conserved()


def test_pending_prefill_slot_never_decoded(pair):
    """While a long prompt is mid-prefill its slot is PENDING_PREFILL:
    the decode steps that run beside it leave its lane parked (finished,
    kv_len 0, no tokens written); a second long prompt waits in the
    queue (one chunked admission at a time) though a slot is free."""
    _, tm = pair
    eng = ServingEngine(_config(tm, max_batch=3, paged=True, kv_page_size=4,
                                prefill_chunk_tokens=4), poll_every=1)
    rng = np.random.RandomState(7)
    short, long1, long2 = (rng.randint(0, 512, n) for n in (3, 30, 22))
    hs = eng.submit(short)
    eng.step()                               # short admitted inline
    h1, h2 = eng.submit(long1), eng.submit(long2)
    eng.step()                               # long1 begins chunking
    slot = eng._slots.index(h1)
    for _ in range(4):
        assert h1.status is RequestStatus.PENDING_PREFILL
        assert h2.status is RequestStatus.QUEUED and None in eng._slots
        assert bool(eng._finished[slot]) and int(eng._cache.kv_len[slot]) == 0
        assert not eng._out_buf[slot].any() and int(eng._steps[slot]) == 0
        eng.step()
    _drain(eng)
    for p, h in ((short, hs), (long1, h1), (long2, h2)):
        np.testing.assert_array_equal(h.result(),
                                      generate(tm, p[None], 8).numpy()[0])
    eng._alloc.assert_conserved()


def test_deadline_mid_prefill_releases_pages(pair):
    _, tm = pair
    eng = ServingEngine(_config(tm, paged=True, kv_page_size=8,
                                prefill_chunk_tokens=8), poll_every=1)
    h = eng.submit(np.arange(1, 30), RequestParams(deadline_s=60.0))
    eng.step()                               # begins, first chunk runs
    assert h.status is RequestStatus.PENDING_PREFILL
    assert eng.stats["prefill_chunks"] == 1
    assert eng._alloc.used_pages() == 5      # 29 + 8 tokens
    h.deadline = time.monotonic() - 1e-3
    eng.step()
    assert h.status is RequestStatus.CANCELLED and h.detail == "deadline"
    assert eng._chunking is None and all(s is None for s in eng._slots)
    assert eng._alloc.used_pages() == 0
    eng._alloc.assert_conserved()
    nxt = eng.submit(np.arange(2, 28))       # the engine chunks again
    np.testing.assert_array_equal(
        nxt.result(timeout=60),
        generate(tm, np.arange(2, 28)[None], 8).numpy()[0])
    eng._alloc.assert_conserved()


def test_chunked_config_validation(pair):
    _, tm = pair
    with pytest.raises(ValueError, match=">= 1"):
        ServingEngine(_config(tm, prefill_chunk_tokens=0))
    with pytest.raises(ValueError, match="multiple of kv_page_size"):
        ServingEngine(_config(tm, paged=True, kv_page_size=8,
                              prefill_chunk_tokens=12))
    with pytest.raises(ValueError, match="past the cache length"):
        ServingEngine(_config(tm, prefill_chunk_tokens=24,
                              cache_max_len=40))
    eng = ServingEngine(_config(tm, prefill_chunk_tokens=32))
    assert not eng._chunk_enabled and eng._row_cache is None
