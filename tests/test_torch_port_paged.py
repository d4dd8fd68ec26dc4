"""The port's paged KV cache against the JAX package, on test-tiny in
fp32 on the CPU.

- ``flash_attention_decode_paged`` (its plain version, what runs on the
  CPU) against the JAX function within 1e-5 (fp32 sums in another
  order, exp against exp2), and once against the Pallas body in
  interpret mode; the port's paged plain output is bitwise equal to its
  dense plain output on the same logical rows.
- ``PagedKVCache`` and ``PageAllocator``: one script of operations
  through both packages gives equal pools, tables, lengths, page ids,
  stats and versions.
- The paged ``ServingEngine``: the JAX engine cannot be built here
  (ROADMAP C1), so it is held to what the reference tests state: paged
  tokens equal the dense engine's and JAX ``generate``'s, copy-on-write
  after a shared prefix, eviction and completion return pages, a
  blocked head is admitted once pages free up, and
  ``assert_conserved()`` holds after each engine test.
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
from paddle_tpu.generation.paged_cache import PageAllocator as JAllocator
from paddle_tpu.generation.paged_cache import PagedKVCache as JPaged
from paddle_tpu.models.gpt import gpt as jax_gpt
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.generation import (KVCache, PageAllocator,
                                         PagedKVCache, generate)
from paddle_tpu_torch.inference import Config
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.models.gpt import gpt
from paddle_tpu_torch.serving import (RequestParams, RequestStatus,
                                      ServingEngine)

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")

ATOL = RTOL = 1e-5


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _paged_inputs(seed, b, sq, hq, hk, page, t, d=16):
    """q, pools with a null page 0 and b * (t // page) shuffled pages,
    the page table, and the dense [b, t, hk, d] caches with the same
    logical rows."""
    rng = np.random.RandomState(seed)
    n_slots = t // page
    n_pages = 1 + b * n_slots
    pool_k, pool_v = (_rand(rng, n_pages, page, hk, d) for _ in range(2))
    table = (1 + rng.permutation(b * n_slots)).reshape(b, n_slots)
    table = table.astype(np.int32)
    dense_k = pool_k[table].reshape(b, t, hk, d)
    dense_v = pool_v[table].reshape(b, t, hk, d)
    return _rand(rng, b, sq, hq, d), pool_k, pool_v, table, dense_k, dense_v


# ------------------------------------------------------------- kernel


@pytest.mark.parametrize("page,hq,hk,sq", [
    (4, 4, 4, 1), (4, 4, 2, 8), (8, 4, 2, 3), (8, 4, 4, 8), (16, 4, 2, 1),
    (16, 4, 4, 5)])
def test_paged_decode_matches_jax(page, hq, hk, sq):
    """Port plain paged decode vs the JAX public function (its gather
    fallback on the CPU). kv_len covers 0 (a parked lane: the port
    writes zeros, the JAX fallback an unmasked mean, so it is held to
    zero instead), sq exactly, a row off the page grid, and full rows."""
    b, t = 4, 48
    q, pk, pv, table, dk, dv = _paged_inputs(page * 10 + sq + hk, b, sq,
                                             hq, hk, page, t)
    kv = np.array([0, sq, 29, t], np.int32)
    ref = np.asarray(jfa.flash_attention_decode_paged(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(table), jnp.asarray(kv)))
    args = [torch.from_numpy(a) for a in (q, pk, pv, table, kv)]
    out = tfa.flash_attention_decode_paged(*args).numpy()
    np.testing.assert_allclose(out[1:], ref[1:], atol=ATOL, rtol=RTOL)
    assert np.all(out[0] == 0.0)
    # bitwise equal to the dense plain version on the same logical rows
    dense = tfa.flash_attention_decode(torch.from_numpy(q),
                                       torch.from_numpy(dk),
                                       torch.from_numpy(dv), args[4])
    assert torch.equal(torch.from_numpy(out), dense)


def test_paged_decode_matches_pallas_interpret():
    """Against the scalar-prefetch Pallas body itself in interpret mode,
    at the shapes of the JAX package's own interpret test."""
    rng = np.random.RandomState(1)
    B, P, ps, Hk, D, Hq, sq = 2, 4, 8, 2, 64, 4, 2
    pool_k = _rand(rng, 1 + B * P, ps, Hk, D)
    pool_v = _rand(rng, 1 + B * P, ps, Hk, D)
    table = np.arange(1, 1 + B * P, dtype=np.int32).reshape(B, P)
    kv = np.array([13, 27], np.int32)
    q = _rand(rng, B, sq, Hq, D)
    qt = jnp.swapaxes(jnp.asarray(q), 1, 2).reshape(B * Hq, sq, D)
    kp = jnp.transpose(jnp.asarray(pool_k), (2, 0, 1, 3))
    vp = jnp.transpose(jnp.asarray(pool_v), (2, 0, 1, 3))
    ref = jfa._paged_decode_pallas(qt, kp, vp, jnp.asarray(table),
                                   jnp.asarray(kv), float(D ** -0.5),
                                   group=Hq // Hk, interpret=True)
    ref = np.asarray(jnp.swapaxes(ref.reshape(B, Hq, sq, D), 1, 2))
    out = tfa.flash_attention_decode_paged(
        *(torch.from_numpy(a) for a in (q, pool_k, pool_v, table, kv)))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_paged_wrapper_contract_on_the_cpu():
    q, pk, pv, table, _, _ = (torch.from_numpy(a) for a in
                              _paged_inputs(0, 2, 9, 2, 2, 4, 16))
    kv = torch.tensor([9, 16], dtype=torch.int32)
    with pytest.raises(ValueError, match="MAX_DECODE_QLEN"):
        tfa.flash_attention_decode_paged(q, pk, pv, table, kv)
    with pytest.raises(ValueError, match="page_table"):
        tfa.flash_attention_decode_paged(q[:, :2], pk, pv, table[:1], kv)
    with pytest.raises(ValueError, match="differ"):
        tfa.flash_attention_decode_paged(q[:, :2], pk, pv[:3], table, kv)
    tfa.reset_counts()
    tfa.flash_attention_decode_paged(q[:, :2], pk, pv, table, kv)
    assert tfa.flash_attention_decode_paged_plain.calls == 1
    assert tfa.flash_attention_decode_plain.calls == 0
    assert tfa.flash_attention_decode_paged.launches == 0


# ------------------------------------------------------- cache and pool


def _src(rng, layers, t, h, d, length):
    k, v = _rand(rng, layers, 1, t, h, d), _rand(rng, layers, 1, t, h, d)
    kl = np.array([length], np.int32)
    return (JKVCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(kl)),
            KVCache(torch.from_numpy(k), torch.from_numpy(v),
                    torch.from_numpy(kl)))


def test_paged_cache_ops_match_jax():
    """update (live rows, an idle lane, a write past the table),
    install_row (with a shared first page skipped), install_span,
    with_kv_len and reset_rows (index and mask) through both caches:
    equal pools past the null page, tables and lengths. Pages no table
    names stay untouched: idle and out-of-table writes went to page 0."""
    L, B, n_pages, ps, P, H, D = 2, 3, 10, 4, 4, 2, 8
    rng = np.random.RandomState(0)
    jc = JPaged.create(L, B, n_pages, ps, P, H, D)
    tc = PagedKVCache.create(L, B, n_pages, ps, P, H, D, device="cpu")
    for (js, ts), slot, row, start in (
            (_src(rng, L, 16, H, D, 10), 0, [1, 2, 3, 0], 0),
            (_src(rng, L, 16, H, D, 7), 1, [1, 4, 0, 0], 4)):
        jc = jc.install_row(js, slot, np.array(row, np.int32), start)
        tc.install_row(ts, slot, torch.tensor(row, dtype=torch.int32),
                       start)
    js, ts = _src(rng, L, 16, H, D, 12)
    jc = jc.install_span(js, np.array([5, 6, 7, 0], np.int32), 4)
    tc.install_span(ts, torch.tensor([5, 6, 7, 0]), 4)
    for layer, s, pos in ((1, 1, None), (0, 2, np.array([15, 3, 0]))):
        kn, vn = _rand(rng, B, s, H, D), _rand(rng, B, s, H, D)
        jpos = jc.kv_len if pos is None else jnp.asarray(pos, jnp.int32)
        tpos = tc.kv_len if pos is None else torch.from_numpy(pos)
        jc = jc.update(layer, jnp.asarray(kn), jnp.asarray(vn), jpos)
        tc.update(layer, torch.from_numpy(kn), torch.from_numpy(vn), tpos)
        jc = jc.with_kv_len(jc.kv_len + s)
        tc.with_kv_len(tc.kv_len + s)
    np.testing.assert_array_equal(tc.positions(2).numpy(),
                                  np.asarray(jc.positions(2)))
    for name in ("k", "v"):
        np.testing.assert_array_equal(getattr(tc, name)[:, 1:].numpy(),
                                      np.asarray(getattr(jc, name))[:, 1:])
    assert not tc.k[:, 8:].any() and not tc.v[:, 8:].any()
    jc = jc.reset_rows(1).reset_rows(jnp.asarray([False, False, True]))
    tc.reset_rows(1).reset_rows(torch.tensor([False, False, True]))
    for name in ("page_table", "kv_len"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)))
    assert tc.page_table.tolist() == [[1, 2, 3, 0], [0] * 4, [0] * 4]
    # the int8 pool is ported since (tests/test_torch_port_int8.py)
    assert PagedKVCache.create(L, B, n_pages, ps, P, H, D,
                               cache_dtype="int8").cache_dtype == "int8"
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        PagedKVCache.create(L, B, n_pages, ps, P, H, D, cache_dtype="int3")


def _allocator_script(cls):
    """plan / commit / register / free_row through exhaustion, prefix
    hits with copy-on-write and LRU reclaim; returns everything
    observable after each step."""
    a = cls(8, 4)                           # 7 allocatable pages
    seen = []

    def note(what, plan=None):
        fields = None if plan is None else (
            list(plan.shared_pages), plan.shared_len, plan.n_private,
            plan.cow, plan.total_pages, len(plan.keys))
        seen.append((what, fields, dict(a.stats), a.version,
                     a.free_pages(), a.used_pages(), a.page_occupancy()))

    base = np.arange(10, dtype=np.int32)
    p1 = a.plan(base, 4)
    r1 = a.commit(p1)
    a.register(p1, r1)
    note(r1, p1)
    p2 = a.plan(np.r_[base[:8], [99, 98]].astype(np.int32), 2)  # COW
    r2 = a.commit(p2)
    a.register(p2, r2)
    note(r2, p2)
    p3 = a.plan(np.arange(100, 116, dtype=np.int32), 4)  # 5 pages: dry
    note(a.commit(p3), p3)
    a.free_row(r1)
    note("free r1")
    a.free_row(r2)
    note("free r2")
    p4 = a.plan(np.arange(200, 220, dtype=np.int32), 4)  # needs reclaim
    r4 = a.commit(p4)
    note(r4, p4)
    a.free_row(r4)
    a.drop_registry()
    note("dropped")
    a.assert_conserved()
    return seen


def test_allocator_script_matches_jax():
    port, ref = _allocator_script(PageAllocator), _allocator_script(JAllocator)
    assert port == ref
    assert port[2][0] is None               # the pool ran dry
    assert port[1][1][3] is True            # copy-on-write planned
    assert port[-2][2]["reclaimed"] >= 1


# -------------------------------------------------------------- engine


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


def _config(tm, *, max_new=8, buckets=(16, 32), max_batch=2, **serving):
    return (Config().from_layer(tm).disable_gpu()
            .enable_generation(max_new_tokens=max_new,
                               prefill_buckets=buckets, max_batch=max_batch)
            .enable_serving(**serving))


def _drain(eng):
    while eng.busy:
        eng.step()


def _ragged(eng, prompts, budgets):
    """Two arrivals, three steps (both slots mid-decode), then the
    rest: slots are reused under load."""
    handles = [eng.submit(p, RequestParams(max_new_tokens=b))
               for p, b in zip(prompts[:2], budgets[:2])]
    for _ in range(3):
        eng.step()
    handles += [eng.submit(p, RequestParams(max_new_tokens=b))
                for p, b in zip(prompts[2:], budgets[2:])]
    _drain(eng)
    return handles


@pytest.mark.parametrize("page", [8, 16])
def test_paged_engine_equals_dense_engine_and_jax(pair, page):
    """Ragged traffic, slot reuse and two prompts with a shared
    16-token prefix: every token stream equals the dense engine's and
    JAX generate()'s; pages are conserved after the drain."""
    jm, tm = pair
    rng = np.random.RandomState(0)
    lens = (5, 12, 20, 7, 3, 31)
    budgets = (8, 3, 6, 5, 8, 1)
    prompts = [rng.randint(0, 512, n) for n in lens]
    prompts += [np.r_[prompts[2][:16], rng.randint(0, 512, 9)],
                np.r_[prompts[2][:16], rng.randint(0, 512, 4)]]
    budgets += (7, 8)
    dense = ServingEngine(_config(tm), poll_every=2)
    paged = ServingEngine(_config(tm, paged=True, kv_page_size=page),
                          poll_every=2)
    d_h = _ragged(dense, prompts, budgets)
    p_h = _ragged(paged, prompts, budgets)
    assert all(h.status is RequestStatus.COMPLETED for h in p_h)
    assert paged.stats["slots_reused"] >= 3
    assert paged._alloc.stats["prefix_hits"] >= 1
    for p, b, dh, ph in zip(prompts, budgets, d_h, p_h):
        np.testing.assert_array_equal(ph.result(), dh.result())
        ref = np.asarray(jax_generate(jm, p[None].astype(np.int32),
                                      b)._data)[0]
        np.testing.assert_array_equal(ph.result(), ref)
    assert paged._alloc.used_pages() == 0
    paged._alloc.assert_conserved()


def test_cow_after_share_divergence(pair):
    """Two requests with one 20-token prompt (20 % 16 != 0): the second
    references the first's full page and privatizes the partial tail
    (copy-on-write) before its decode writes diverge; both equal
    sequential generate()."""
    _, tm = pair
    eng = ServingEngine(_config(tm, paged=True, kv_page_size=16))
    prompt = np.random.RandomState(3).randint(0, 512, 20)
    h1 = eng.submit(prompt, RequestParams(max_new_tokens=6))
    _drain(eng)
    h2 = eng.submit(prompt.copy(), RequestParams(max_new_tokens=8))
    _drain(eng)
    s = eng._alloc.stats
    assert (s["prefix_hits"], s["shared_pages"], s["cow_copies"]) == (1, 1, 1)
    np.testing.assert_array_equal(h1.result(),
                                  generate(tm, prompt[None], 6).numpy()[0])
    np.testing.assert_array_equal(h2.result(),
                                  generate(tm, prompt[None], 8).numpy()[0])
    eng._alloc.assert_conserved()


def test_mid_decode_eviction_returns_pages(pair):
    """A deadline mid-decode evicts the request: partial tokens kept,
    its table row nulled, every page back; the slot serves again."""
    _, tm = pair
    eng = ServingEngine(_config(tm, max_batch=1, paged=True,
                                kv_page_size=8), poll_every=1)
    slow = eng.submit(np.arange(1, 12), RequestParams(deadline_s=60.0))
    eng.step()
    assert slow.status is RequestStatus.RUNNING
    assert eng._alloc.used_pages() == 3      # 11 + 8 tokens
    slow.deadline = time.monotonic() - 1e-3
    _drain(eng)
    assert slow.status is RequestStatus.CANCELLED
    assert slow.tokens is not None and 1 <= slow.tokens.size < 8
    assert eng._alloc.used_pages() == 0
    assert int(eng._cache.kv_len[0]) == 0
    assert not eng._cache.page_table[0].any()
    eng._alloc.assert_conserved()
    nxt = eng.submit(np.arange(3, 9))
    np.testing.assert_array_equal(
        nxt.result(timeout=60), generate(tm, np.arange(3, 9)[None],
                                         8).numpy()[0])
    eng._alloc.assert_conserved()


def test_blocked_head_admitted_once_pages_free(pair):
    """A pool of 5 allocatable pages: the first request takes all 5, so
    the second stays queued with a free slot (page-blocked) until the
    first completes, then is admitted and served right."""
    _, tm = pair
    eng = ServingEngine(_config(tm, paged=True, kv_page_size=8,
                                kv_pages=6), poll_every=1)
    rng = np.random.RandomState(4)
    a, b = rng.randint(0, 512, 32), rng.randint(0, 512, 20)
    ha = eng.submit(a)
    hb = eng.submit(b)
    eng.step()
    assert ha.status is RequestStatus.RUNNING
    assert hb.status is RequestStatus.QUEUED and eng._page_blocked
    assert eng._slots[1] is None
    _drain(eng)
    assert not eng._page_blocked
    for p, h in ((a, ha), (b, hb)):
        np.testing.assert_array_equal(h.result(),
                                      generate(tm, p[None], 8).numpy()[0])
    eng._alloc.assert_conserved()


def test_paged_config_validation(pair):
    _, tm = pair
    with pytest.raises(ValueError, match="must divide"):
        ServingEngine(_config(tm, paged=True, kv_page_size=48))
    with pytest.raises(ValueError, match="cannot hold one"):
        ServingEngine(_config(tm, paged=True, kv_page_size=8, kv_pages=5))
    eng = ServingEngine(_config(tm, paged=True, kv_page_size=32))
    assert eng._alloc.n_pages == 2 * eng.pages_per_row + 1
    assert eng._cache.k.shape[1:3] == (eng._alloc.n_pages, 32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Config().enable_serving(paged=True, hbm_budget=1 << 30)
    assert Config().enable_serving(
        paged=True, weight_bits=4)._serving["weight_bits"] == 4
    eng = ServingEngine(_config(tm, paged=True, kv_page_size=32,
                                kv_cache_dtype="int8"))
    assert eng._cache.cache_dtype == "int8"
    assert eng._cache.k_scale.shape == eng._cache.k.shape[:-1]
