"""The port's generation and serving against the JAX package, on
test-tiny in fp32 on the CPU with the JAX weights carried across.

Greedy tokens must be EQUAL: the port's ``generate()`` against JAX
``generate()``, and every request the port's ``ServingEngine`` serves
under ragged traffic against both the port's sequential ``generate()``
for that prompt and JAX ``generate()`` for it. The JAX serving engine
is deliberately not the oracle (ROADMAP C1: its fixture tests are red
on the reference); the engine invariants its tests state — queue
bound, deadlines queued and in flight, inline pumping, eos trimming,
slot reuse — are checked here directly.
"""
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.generation import generate as jax_generate
from paddle_tpu.models.gpt import gpt as jax_gpt
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.generation import generate, sample
from paddle_tpu_torch.inference import Config
from paddle_tpu_torch.models.gpt import gpt
from paddle_tpu_torch.serving import (QueueFull, RequestFailed,
                                      RequestParams, RequestStatus,
                                      ServingEngine)


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


def _jax_tokens(jm, ids, n, **kw):
    out = jax_generate(jm, np.asarray(ids, np.int32), n, **kw)
    return np.asarray(out._data)


def _config(tm, *, max_new=8, buckets=(16, 32), max_batch=2, eos=None,
            **serving):
    cfg = (Config().from_layer(tm).disable_gpu()
           .enable_generation(max_new_tokens=max_new,
                              prefill_buckets=buckets, max_batch=max_batch,
                              eos_token_id=eos))
    return cfg.enable_serving(**serving) if serving else cfg


# ---------------------------------------------------------- generate


def test_generate_greedy_matches_jax_ragged_rows(pair):
    jm, tm = pair
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 512, (3, 18))
    plen = np.array([18, 7, 1])
    ref = _jax_tokens(jm, ids, 12, prompt_len=plen.astype(np.int32))
    out = tm.generate(ids, 12, prompt_len=plen)
    assert out.dtype == torch.int32 and out.shape == (3, 12)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_generate_eos_padding_matches_jax(pair):
    jm, tm = pair
    ids = np.random.RandomState(4).randint(0, 512, (2, 10))
    free = _jax_tokens(jm, ids, 20)
    eos = int(free[0, 3])                 # row 0 stops at step 3
    ref = _jax_tokens(jm, ids, 20, eos_token_id=eos, pad_token_id=511)
    out = generate(tm, ids, 20, eos_token_id=eos, pad_token_id=511)
    np.testing.assert_array_equal(out.numpy(), ref)
    first = int(np.nonzero(ref[0] == eos)[0][0])
    assert np.all(ref[0, first + 1:] == 511)


def test_generate_validates_lengths(pair):
    _, tm = pair
    with pytest.raises(ValueError, match="max_position_embeddings"):
        generate(tm, np.zeros((1, 100), np.int64), 40)
    with pytest.raises(ValueError, match="cache_max_len"):
        generate(tm, np.zeros((1, 10), np.int64), 8, cache_max_len=12)


def test_sampling_is_seeded_and_top_k_one_is_greedy(pair):
    _, tm = pair
    ids = np.random.RandomState(5).randint(0, 512, (2, 6))
    a = generate(tm, ids, 6, do_sample=True, temperature=0.8, seed=11)
    b = generate(tm, ids, 6, do_sample=True, temperature=0.8, seed=11)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    greedy = generate(tm, ids, 6)
    top1 = generate(tm, ids, 6, do_sample=True, top_k=1, seed=12)
    np.testing.assert_array_equal(top1.numpy(), greedy.numpy())
    logits = torch.randn(4, 50, generator=torch.Generator().manual_seed(0))
    nucleus = sample(logits, torch.Generator().manual_seed(1),
                     do_sample=True, top_p=0.0)
    np.testing.assert_array_equal(nucleus.numpy(),
                                  logits.argmax(-1).numpy())


# ------------------------------------------------------------ engine


def test_engine_ragged_traffic_matches_generate_and_jax(pair):
    """Mixed prompt lengths and budgets, arrivals while both slots are
    mid-decode, 2 slots so they get reused: every request's tokens equal
    the port's sequential generate() for that prompt, and JAX
    generate() for it."""
    jm, tm = pair
    eng = ServingEngine(_config(tm, max_new=8, buckets=(16, 32),
                                max_batch=2), poll_every=2)
    rng = np.random.RandomState(0)
    lens = (5, 12, 20, 7, 3, 31)
    budgets = (8, 3, 6, 5, 8, 1)
    prompts = [rng.randint(0, 512, n) for n in lens]
    handles = [eng.submit(p, RequestParams(max_new_tokens=b))
               for p, b in zip(prompts[:2], budgets[:2])]
    for _ in range(3):                  # both slots now mid-decode
        eng.step()
    handles += [eng.submit(p, RequestParams(max_new_tokens=b))
                for p, b in zip(prompts[2:], budgets[2:])]
    while eng.busy:
        eng.step()
    assert all(h.status is RequestStatus.COMPLETED for h in handles)
    assert eng.stats["slots_reused"] >= 3
    assert eng.stats["admitted"] == len(prompts)
    for p, b, h in zip(prompts, budgets, handles):
        seq = generate(tm, p[None], b).numpy()[0]
        np.testing.assert_array_equal(h.result(), seq)
        np.testing.assert_array_equal(h.result(), _jax_tokens(jm, p[None],
                                                              b)[0])
        assert h.ttft is not None and h.ttft >= 0.0


def test_engine_serve_forever_and_inline_pump(pair):
    _, tm = pair
    eng = ServingEngine(_config(tm, max_new=4, buckets=(16,),
                                max_batch=2))
    h = eng.submit(np.arange(1, 9), RequestParams(max_new_tokens=4))
    out = h.result(timeout=60)          # no thread: result() pumps
    assert out.shape == (4,) and h.status is RequestStatus.COMPLETED
    prompts = [np.arange(i, i + 5) for i in range(5)]
    handles = eng.serve_forever(iter(prompts))
    assert [x.status for x in handles] == [RequestStatus.COMPLETED] * 5
    for p, x in zip(prompts, handles):
        np.testing.assert_array_equal(x.tokens,
                                      generate(tm, p[None], 4).numpy()[0])


def test_engine_eos_frees_slot_and_trims(pair):
    _, tm = pair
    prompt = np.arange(1, 7)
    free = generate(tm, prompt[None], 8).numpy()[0]
    eos = int(free[3])
    eng = ServingEngine(_config(tm, max_new=8, buckets=(16,), max_batch=1,
                                eos=eos), poll_every=1)
    h = eng.submit(prompt)
    out = h.result(timeout=60)
    first = int(np.nonzero(free == eos)[0][0])
    np.testing.assert_array_equal(out, free[:first])
    assert h.n_emitted == first + 1      # the eos itself was emitted


def test_engine_queue_bound_and_deadlines(pair):
    _, tm = pair
    eng = ServingEngine(_config(tm, max_new=8, buckets=(16,), max_batch=1,
                                max_queue=1), poll_every=1)
    running = eng.submit([1, 2, 3])
    eng.step()                           # admitted into the only slot
    queued = eng.submit([4, 5])          # fills the queue (bound 1)
    with pytest.raises(QueueFull) as ei:
        eng.submit([6, 7])
    assert ei.value.reason == "queue_full:no_free_slots"
    assert ei.value.request.status is RequestStatus.REJECTED
    assert eng.stats["rejected"] == 1
    assert running.result(timeout=60).size == 8
    assert queued.result(timeout=60).size == 8

    # deadline on a QUEUED request: it expires before a slot frees
    blocker = eng.submit([1, 2, 3])
    eng.step()
    late = eng.submit([4, 5], RequestParams(deadline_s=0.0))
    while not late.done():
        eng.step()
    assert late.status is RequestStatus.CANCELLED
    assert late.detail == "deadline"
    with pytest.raises(RequestFailed, match="deadline"):
        late.result(timeout=5)
    assert blocker.result(timeout=60).size == 8

    # deadline on an IN-FLIGHT request: evicted mid-decode, slot freed,
    # partial tokens kept
    slow = eng.submit([1, 2, 3], RequestParams(deadline_s=60.0))
    eng.step()
    assert slow.status is RequestStatus.RUNNING
    slow.deadline = time.monotonic() - 1e-3
    while not slow.done():
        eng.step()
    assert slow.status is RequestStatus.CANCELLED
    assert slow.tokens is not None and 1 <= slow.tokens.size < 8
    assert all(s is None for s in eng._slots)
    assert int(eng._cache.kv_len[0]) == 0
    nxt = eng.submit([9, 9])             # the evicted slot is reusable
    assert nxt.result(timeout=60).size == 8


def test_engine_validates_requests_and_config(pair):
    _, tm = pair
    with pytest.raises(ValueError, match="live layer"):
        ServingEngine(Config())
    with pytest.raises(ValueError, match="enable_generation"):
        ServingEngine(Config().from_layer(tm).disable_gpu())
    with pytest.raises(ValueError, match="no prefill bucket"):
        ServingEngine(_config(tm, buckets=(512,)))
    eng = ServingEngine(_config(tm, max_new=4, buckets=(16,), max_batch=1))
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit([])
    with pytest.raises(ValueError, match="largest"):
        eng.submit(list(range(17)))
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit([1, 2], RequestParams(max_new_tokens=9))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Config().enable_serving(hbm_budget="16GiB")
    # ported since: the paged cache and chunked prefill, the int8 cache,
    # the int8 and int4 weight paths
    assert Config().enable_serving(weight_bits=4)._serving["weight_bits"] == 4
    with pytest.raises(ValueError, match="weight_bits"):
        Config().enable_serving(weight_bits=2)
    assert Config().enable_serving(
        kv_cache_dtype="int8")._serving["kv_cache_dtype"] == "int8"
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        Config().enable_serving(kv_cache_dtype="int3")
    opts = Config().enable_serving(paged=True, kv_page_size=16, kv_pages=9,
                                   prefill_chunk_tokens=64)._serving
    assert (opts["paged"], opts["kv_page_size"], opts["kv_pages"],
            opts["prefill_chunk_tokens"]) == (True, 16, 9, 64)
    # ported since: speculative decoding, validated eagerly
    assert Config().enable_generation(
        speculative="ngram")._generation["speculative"] == "ngram"
    with pytest.raises(ValueError, match="draft_model"):
        Config().enable_generation(speculative="draft")
    with pytest.raises(TypeError):
        Config().enable_serving(no_such_option=1)
