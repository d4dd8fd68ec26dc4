"""The port's speculative ServingEngine slots, its ``Config`` options,
and the engine's page-size and chunk-width environment knobs, on the
CPU on test-tiny in fp32 with the JAX weights carried across.

The JAX serving engine cannot be built here (ROADMAP C1/C3), so the
speculative engine is held to the invariants the JAX engine tests
state (``tests/test_speculative.py``): every stream equals the port's
sequential ``generate`` of the same cache dtype (which the port's
generate tests hold to JAX), and the non-speculative engine's; the
paged engine equals the dense one; eos trims inside a window; the
budget lands exactly; the overhang is validated up front; draft mode is
refused. Random test-tiny weights repeat one token, which hides a
position error; so the engines also serve a copy whose non-embedding
matrices are scaled by 2 ("varied"): its streams vary and depend on
the positions, and it still accepts drafts. The environment knobs
follow the JAX engine's
``serving/engine.py`` precedence: keyword, then ``enable_serving``,
then the environment, then the default.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import gpt as jax_gpt
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.generation import SpeculativeConfig, generate
from paddle_tpu_torch.inference import Config
from paddle_tpu_torch.models.gpt import gpt
from paddle_tpu_torch.serving import (RequestParams, RequestStatus,
                                      ServingEngine)


@pytest.fixture(scope="module")
def tm():
    paddle.seed(0)
    jm = jax_gpt("test-tiny")
    jm.eval()
    m = gpt("test-tiny", device="cpu")
    load_reference_state(
        m, {k: np.asarray(v._data) for k, v in jm.state_dict().items()})
    return m.eval()


@pytest.fixture(scope="module")
def models(tm):
    varied = gpt("test-tiny", device="cpu")
    varied.load_state_dict(tm.state_dict())
    with torch.no_grad():
        for name, p in varied.named_parameters():
            if p.dim() == 2 and "wte" not in name:
                p.mul_(2.0)
    return {"jax": tm, "varied": varied.eval()}


def _config(m, *, max_new=8, buckets=(16, 32), max_batch=2, eos=None,
            speculative="ngram", kv_cache_dtype=None, **serving):
    cfg = (Config().from_layer(m).disable_gpu()
           .enable_generation(max_new_tokens=max_new,
                              prefill_buckets=buckets, max_batch=max_batch,
                              eos_token_id=eos, speculative=speculative,
                              kv_cache_dtype=kv_cache_dtype))
    return cfg.enable_serving(**serving) if serving else cfg


def _looping_prompt(n=24):
    motif = np.array([11, 7, 42, 99, 3, 5], np.int64)
    return np.tile(motif, n // motif.size + 1)[:n]


def _traffic():
    """Ragged prompts and budgets, two of them sharing a 16-token prefix
    (two full 8-token pages), and a looping one (real acceptances)."""
    rng = np.random.RandomState(0)
    prefix = rng.randint(0, 512, 16)
    prompts = [rng.randint(0, 512, n) for n in (5, 12, 20, 7, 3, 31)]
    prompts += [np.r_[prefix, rng.randint(0, 512, 4)],
                np.r_[prefix, rng.randint(0, 512, 9)], _looping_prompt()]
    budgets = (8, 3, 6, 5, 8, 1, 8, 7, 8)
    return prompts, budgets


def _serve(eng, prompts, budgets):
    """Two requests, three steps (both slots mid-decode), then the rest."""
    handles = [eng.submit(p, RequestParams(max_new_tokens=b))
               for p, b in zip(prompts[:2], budgets[:2])]
    for _ in range(3):
        eng.step()
    handles += [eng.submit(p, RequestParams(max_new_tokens=b))
                for p, b in zip(prompts[2:], budgets[2:])]
    while eng.busy:
        eng.step()
    assert all(h.status is RequestStatus.COMPLETED for h in handles)
    return [h.result() for h in handles]


_ENGINES = {
    "dense": {},
    "paged": dict(paged=True, kv_page_size=8),
    "chunked": dict(paged=True, kv_page_size=8, prefill_chunk_tokens=8),
    "int8": dict(kv_cache_dtype="int8"),
    "int8_paged": dict(kv_cache_dtype="int8", paged=True, kv_page_size=8),
}


#: the varied model proposes on 2-grams: its streams repeat pairs, not
#: triples
_SPECS = {"jax": "ngram", "varied": SpeculativeConfig(k=4, ngram=2)}


@pytest.fixture(scope="module")
def served(models):
    """Each model's and engine's streams, speculative and not, and the
    engine's stats."""
    prompts, budgets = _traffic()
    out = {}
    for model, m in models.items():
        for name, kw in _ENGINES.items():
            for spec in (_SPECS[model], None):
                eng = ServingEngine(_config(m, speculative=spec, **kw),
                                    poll_every=2)
                out[model, name, spec is not None] = (
                    _serve(eng, prompts, budgets), dict(eng.stats))
                if eng._alloc is not None:
                    eng._alloc.assert_conserved()
                    assert eng._alloc.used_pages() == 0
    return out


@pytest.mark.parametrize("model", ["jax", "varied"])
@pytest.mark.parametrize("name", list(_ENGINES))
def test_spec_engine_equals_sequential_generate(models, served, name,
                                                model):
    """Ragged traffic with mid-decode arrivals: every speculative stream
    equals the port's sequential generate of the same cache dtype, and
    the non-speculative engine's; the counters drained."""
    prompts, budgets = _traffic()
    streams, stats = served[model, name, True]
    plain, base = served[model, name, False]
    kv = _ENGINES[name].get("kv_cache_dtype")
    for p, b, got, ref in zip(prompts, budgets, streams, plain):
        seq = generate(models[model], p[None], b,
                       kv_cache_dtype=kv).numpy()[0]
        np.testing.assert_array_equal(got, seq)
        np.testing.assert_array_equal(got, ref)
    assert stats["spec_proposed"] > 0 and stats["spec_accepted"] > 0
    assert stats["spec_accepted"] <= stats["spec_proposed"]
    # speculation amortized forwards: fewer decode steps than without
    assert stats["decode_steps"] < base["decode_steps"]


@pytest.mark.parametrize("model", ["jax", "varied"])
@pytest.mark.parametrize("kv", [None, "int8"])
def test_spec_paged_equals_dense(served, kv, model):
    dense = served[model, "int8" if kv else "dense", True]
    paged = served[model, "int8_paged" if kv else "paged", True]
    for a, b in zip(dense[0], paged[0]):
        np.testing.assert_array_equal(a, b)
    assert dense[1]["spec_accepted"] == paged[1]["spec_accepted"]


def test_spec_engine_chunked_admission_installs_drafter_row(tm):
    """A chunked admission installs the slot's drafter row: the padded
    prompt with the first token appended, tok_len prompt + 1."""
    eng = ServingEngine(_config(tm, max_batch=1, paged=True, kv_page_size=8,
                                prefill_chunk_tokens=8), poll_every=1)
    prompt = _looping_prompt(20)
    h = eng.submit(prompt, RequestParams(max_new_tokens=1))
    while eng._slots[0] is None or \
            eng._slots[0].status is not RequestStatus.RUNNING:
        eng.step()
    assert int(eng._tok_len[0]) == 21
    np.testing.assert_array_equal(eng._tok_buf[0, :20].numpy(), prompt)
    assert int(eng._tok_buf[0, 20]) == int(eng._out_buf[0, 0])
    while eng.busy:
        eng.step()
    assert h.result().size == 1


def test_engine_spec_budget_exact_boundary(tm):
    """A window spanning the budget (looping prompt: multi-token
    acceptance) emits exactly the budget, equal to sequential decode."""
    eng = ServingEngine(_config(tm, buckets=(32,), max_batch=1),
                        poll_every=1)
    prompt = _looping_prompt()
    for budget in (2, 3, 5, 8):
        h = eng.submit(prompt, RequestParams(max_new_tokens=budget))
        out = h.result(timeout=60)
        assert out.size == budget
        assert int(eng._steps[0]) == budget
        np.testing.assert_array_equal(
            out, generate(tm, prompt[None], budget).numpy()[0])
    assert eng.stats["spec_accepted"] > 0


def test_engine_spec_eos_trims_within_window(tm):
    """An eos inside an accepted window finishes the row there: the
    result stops before it, n_emitted counts it."""
    prompt = _looping_prompt()
    ref = generate(tm, prompt[None], 8).numpy()[0]
    eos = int(ref[3])
    first = int(np.nonzero(ref == eos)[0][0])
    eng = ServingEngine(_config(tm, buckets=(32,), max_batch=1, eos=eos),
                        poll_every=1)
    h = eng.submit(prompt)
    np.testing.assert_array_equal(h.result(timeout=60), ref[:first])
    assert h.n_emitted == first + 1
    assert int(eng._cache.kv_len[0]) == 0        # the finished lane pinned


def test_engine_spec_overhang_validation(tm):
    """The exact cache bound passes, one below names the overhang; the
    paged pool's worst case and the bucket filter carry it too; draft
    mode is refused; the page plan reserves it."""
    ServingEngine(_config(tm, buckets=(16,), max_batch=1),
                  cache_max_len=16 + 8 + 4)
    with pytest.raises(ValueError, match="overhang"):
        ServingEngine(_config(tm, buckets=(16,), max_batch=1),
                      cache_max_len=16 + 8 + 3)
    # 28 positions = 4 pages of 8: a pool of 4 + the null page holds one
    ServingEngine(_config(tm, buckets=(16,), max_batch=1, paged=True,
                          kv_page_size=8, kv_pages=5), cache_max_len=32)
    with pytest.raises(ValueError, match="overhang"):
        ServingEngine(_config(tm, buckets=(16,), max_batch=1, paged=True,
                              kv_page_size=8, kv_pages=4),
                      cache_max_len=32)
    ServingEngine(_config(tm, buckets=(16,), max_batch=1, paged=True,
                          kv_page_size=8, kv_pages=4, speculative=None),
                  cache_max_len=32)
    # 120 + 6 fits max_position_embeddings=128, not with k=4
    eng = ServingEngine(_config(tm, max_new=6, buckets=(16, 120),
                                speculative=None))
    assert eng.buckets == [16, 120]
    eng = ServingEngine(_config(tm, max_new=6, buckets=(16, 120)))
    assert eng.buckets == [16]
    with pytest.raises(ValueError, match="ngram"):
        ServingEngine(Config().from_layer(tm).disable_gpu()
                      .enable_generation(max_new_tokens=8,
                                         prefill_buckets=(16,),
                                         speculative="draft",
                                         draft_model=tm))
    eng = ServingEngine(_config(tm, buckets=(16,), max_batch=1, paged=True,
                                kv_page_size=8))
    eng.submit(np.arange(1, 14), RequestParams(max_new_tokens=8))
    eng._pop_queue()
    pages, _ = next(iter(eng._pending_pages.values()))
    assert len(pages) == -(-(13 + 8 + 4) // 8) == 4


def test_config_speculative_options(tm):
    cfg = Config().enable_generation(speculative="ngram")
    assert cfg._generation["speculative"] == "ngram"
    assert cfg._generation["draft_model"] is None
    spec = SpeculativeConfig(k=2, ngram=2)
    cfg = Config().enable_generation(speculative=spec)
    assert cfg._generation["speculative"] is spec
    cfg = Config().enable_generation(speculative="draft", draft_model=tm)
    assert cfg._generation["draft_model"] is tm
    with pytest.raises(ValueError, match="draft_model"):
        Config().enable_generation(speculative="draft")
    with pytest.raises(ValueError, match="ngram"):
        Config().enable_generation(speculative="ngram", draft_model=tm)
    with pytest.raises(ValueError, match="MAX_DECODE_QLEN"):
        Config().enable_generation(speculative=SpeculativeConfig(k=8))
    with pytest.raises(TypeError):
        Config().enable_generation(speculative=3)
    eng = ServingEngine(_config(tm, speculative=spec))
    assert eng._spec is spec and "k=2" in repr(eng)


# ------------------------------------------------ environment knobs (C11)


@pytest.mark.parametrize("env,kw,opt,want", [
    ("64", None, None, 64),            # digits: the environment's size
    ("garbage", None, None, 128),      # not digits: the default
    (" 32 ", None, None, 32),          # stripped, as the reference does
    ("64", 16, None, 16),              # the keyword wins
    ("64", None, 32, 32),              # so does enable_serving
    ("", None, None, 128),
])
def test_engine_reads_kv_page_size_from_env(tm, monkeypatch, env, kw, opt,
                                            want):
    monkeypatch.setenv("PADDLE_KV_PAGE_SIZE", env)
    monkeypatch.delenv("PADDLE_PREFILL_CHUNK_TOKENS", raising=False)
    eng = ServingEngine(_config(tm, buckets=(64,), speculative=None,
                                paged=True, kv_page_size=opt),
                        kv_page_size=kw, cache_max_len=128)
    assert eng.page_size == want
    assert eng.pages_per_row == 128 // want


@pytest.mark.parametrize("env,kw,opt,paged,want", [
    ("16", None, None, False, 16),
    ("garbage", None, None, False, None),
    ("16", 8, None, False, 8),
    ("16", None, 32, False, 32),
    ("", None, None, False, None),
    ("16", None, None, True, 16),
])
def test_engine_reads_prefill_chunk_tokens_from_env(tm, monkeypatch, env,
                                                    kw, opt, paged, want):
    monkeypatch.setenv("PADDLE_PREFILL_CHUNK_TOKENS", env)
    monkeypatch.setenv("PADDLE_KV_PAGE_SIZE", "8")
    eng = ServingEngine(_config(tm, buckets=(16, 64), speculative=None,
                                paged=paged, prefill_chunk_tokens=opt),
                        prefill_chunk_tokens=kw)
    assert eng.prefill_chunk_tokens == want
    assert eng._chunk_enabled == (want is not None)
    if paged:
        assert eng.page_size == 8


def test_engine_env_knobs_raise_the_reference_errors(tm, monkeypatch):
    """A page size from the environment that does not divide the cache,
    and a chunk width that is not page-aligned on a paged engine, raise
    the reference's ValueErrors; served tokens under environment knobs
    equal sequential generate."""
    monkeypatch.setenv("PADDLE_KV_PAGE_SIZE", "48")
    with pytest.raises(ValueError, match="PADDLE_KV_PAGE_SIZE"):
        ServingEngine(_config(tm, speculative=None, paged=True),
                      cache_max_len=128)
    monkeypatch.setenv("PADDLE_KV_PAGE_SIZE", "8")
    monkeypatch.setenv("PADDLE_PREFILL_CHUNK_TOKENS", "12")
    with pytest.raises(ValueError, match="multiple of kv_page_size 8"):
        ServingEngine(_config(tm, speculative=None, paged=True))
    monkeypatch.setenv("PADDLE_PREFILL_CHUNK_TOKENS", "0")
    with pytest.raises(ValueError, match="PADDLE_PREFILL_CHUNK_TOKENS"):
        ServingEngine(_config(tm, speculative=None))
    monkeypatch.setenv("PADDLE_PREFILL_CHUNK_TOKENS", "8")
    eng = ServingEngine(_config(tm, paged=True), poll_every=2)
    assert (eng.page_size, eng.prefill_chunk_tokens) == (8, 8)
    prompts, budgets = _traffic()
    for p, b, got in zip(prompts, budgets, _serve(eng, prompts, budgets)):
        np.testing.assert_array_equal(got, generate(tm, p[None],
                                                    b).numpy()[0])
    assert eng.stats["prefill_chunks"] > 0
