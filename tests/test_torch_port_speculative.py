"""The port's speculative decoding (``paddle_tpu_torch.generation.
speculative``) against the JAX package's, on the CPU.

The pure functions (``ngram_propose``, greedy ``spec_accept``, the
window bookkeeping) must give the JAX functions' values on the same
lanes. The rejection sampler draws from a ``torch.Generator``, so it is
held to the target distribution with the JAX test's statistic (total
variation < 0.1 over 800 draws), not to JAX's draws. Greedy
``generate(speculative=...)`` on test-tiny (and test-tiny-draft as the
draft model), with the JAX weights carried across, must give tokens
EQUAL to the port's sequential ``generate`` and to JAX
``generate(speculative=...)``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.generation import GenerationConfig as JaxGenerationConfig
from paddle_tpu.generation import SpeculativeConfig as JaxSpeculativeConfig
from paddle_tpu.generation import generate as jax_generate
from paddle_tpu.generation import speculative as jspec
from paddle_tpu.models.gpt import gpt as jax_gpt
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.generation import (GenerationConfig,
                                         GenerationSession,
                                         SpeculativeConfig, generate,
                                         ngram_propose, spec_accept)
from paddle_tpu_torch.generation import speculative as tspec
from paddle_tpu_torch.kernels.flash_attention import MAX_DECODE_QLEN
from paddle_tpu_torch.models.gpt import gpt


def _port(jm, name):
    tm = gpt(name, device="cpu")
    load_reference_state(
        tm, {k: np.asarray(v._data) for k, v in jm.state_dict().items()})
    return tm.eval()


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    jm = jax_gpt("test-tiny")
    jm.eval()
    return jm, _port(jm, "test-tiny")


@pytest.fixture(scope="module")
def draft_pair():
    paddle.seed(7)
    jd = jax_gpt("test-tiny-draft")
    jd.eval()
    return jd, _port(jd, "test-tiny-draft")


@pytest.fixture(scope="module")
def prompt_ids():
    return np.random.RandomState(0).randint(0, 512, (2, 12)).astype(np.int32)


def _jax_tokens(jm, ids, n, **kw):
    return np.asarray(jax_generate(jm, np.asarray(ids, np.int32), n,
                                   **kw)._data)


def _looping_prompt(n=24):
    # a repeated motif: the prompt-lookup drafter gets real multi-token
    # acceptances for the boundary tests to clamp
    motif = np.array([11, 7, 42, 99, 3, 5], np.int64)
    return np.tile(motif, n // motif.size + 1)[None, :n]


# ------------------------------------------------- pure functions vs JAX


def _ngram_cases():
    rng = np.random.RandomState(1)
    cases = []
    # the JAX tests' hand-built rows: the most recent match wins, no
    # match repeats the last token, continuations clamp to known tokens,
    # histories shorter than n + 1 fall back
    buf = np.zeros((2, 16), np.int64)
    buf[0, :10] = [7, 8, 3, 5, 7, 8, 9, 1, 7, 8]
    buf[1, :6] = [1, 2, 3, 4, 5, 6]
    cases.append((buf, [10, 6], 3, 2))
    buf = np.full((1, 12), 99, np.int64)
    buf[0, :7] = [4, 5, 1, 2, 4, 5, 1]
    cases.append((buf, [7], 4, 2))
    buf = np.zeros((1, 8), np.int64)
    buf[0, :2] = [3, 4]
    cases.append((buf, [2], 2, 3))
    # random small-alphabet histories (many matches), every length
    for k, n in ((1, 1), (4, 3), (7, 2), (3, 5)):
        buf = rng.randint(0, 4, (6, 40))
        lens = rng.randint(0, 41, 6)
        lens[0], lens[1] = 0, n
        cases.append((buf, lens.tolist(), k, n))
    return cases


@pytest.mark.parametrize("case", range(len(_ngram_cases())))
def test_ngram_propose_matches_jax(case):
    buf, lens, k, n = _ngram_cases()[case]
    ref = np.asarray(jspec.ngram_propose(jnp.asarray(buf, jnp.int32),
                                         jnp.asarray(lens, jnp.int32),
                                         k=k, n=n))
    out = ngram_propose(torch.as_tensor(buf), torch.as_tensor(lens), k=k,
                        n=n)
    assert out.dtype == torch.int64 and out.shape == (buf.shape[0], k)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_ngram_propose_known_rows():
    buf, lens, k, n = _ngram_cases()[0]
    out = ngram_propose(torch.as_tensor(buf), torch.as_tensor(lens), k=k,
                        n=n).numpy()
    np.testing.assert_array_equal(out, [[9, 1, 7], [6, 6, 6]])
    buf, lens, k, n = _ngram_cases()[1]
    out = ngram_propose(torch.as_tensor(buf), torch.as_tensor(lens), k=k,
                        n=n).numpy()
    np.testing.assert_array_equal(out, [[2, 4, 5, 1]])


@pytest.mark.parametrize("k", [1, 4, 7])
def test_spec_accept_greedy_matches_jax(k):
    rng = np.random.RandomState(k)
    b, v = 16, 6
    logits = rng.randn(b, k + 1, v).astype(np.float32)
    tgt = logits.argmax(-1)
    # drafts that match the argmax for a random prefix, then diverge
    draft = rng.randint(0, v, (b, k))
    for r in range(b):
        m = rng.randint(0, k + 1)
        draft[r, :m] = tgt[r, :m]
    em_j, n_j = jspec.spec_accept(jnp.asarray(logits),
                                  jnp.asarray(draft, jnp.int32),
                                  jax.random.PRNGKey(0),
                                  JaxGenerationConfig())
    em_t, n_t = spec_accept(torch.as_tensor(logits), torch.as_tensor(draft),
                            None, GenerationConfig())
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    np.testing.assert_array_equal(em_t.numpy(), np.asarray(em_j))


def test_spec_accept_greedy_prefix_and_correction():
    logits = np.full((1, 3, 6), -5.0, np.float32)
    logits[0, 0, 2] = logits[0, 1, 3] = logits[0, 2, 4] = 5.0
    cfg = GenerationConfig()
    for draft, n, head in (([2, 3], 2, [2, 3, 4]), ([2, 9], 1, [2, 3]),
                           ([9, 9], 0, [2])):
        em, na = spec_accept(torch.as_tensor(logits),
                             torch.as_tensor([draft]), None, cfg)
        assert int(na[0]) == n
        np.testing.assert_array_equal(em[0, :len(head)].numpy(), head)


def _lanes(seed, b=12, k=4, width=10, eos=5):
    rng = np.random.RandomState(seed)
    emitted = rng.randint(0, 8, (b, k + 1))
    n_accept = rng.randint(0, k + 1, b)
    budget = np.full(b, width)
    # budget - done from 0 to k + 1 and past it
    done = budget - np.arange(b) % (k + 3)
    finished = rng.rand(b) < 0.25
    return emitted, n_accept, finished, done, budget, eos


@pytest.mark.parametrize("eos", [None, 5])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_window_bookkeeping_matches_jax(seed, eos):
    emitted, n_accept, finished, done, budget, _ = _lanes(seed)
    en_j, fin_j = jspec.acceptance_bookkeeping(
        jnp.asarray(emitted, jnp.int32), jnp.asarray(n_accept, jnp.int32),
        jnp.asarray(finished), jnp.asarray(done, jnp.int32),
        jnp.asarray(budget, jnp.int32), eos)
    en_t, fin_t = tspec.acceptance_bookkeeping(
        torch.as_tensor(emitted), torch.as_tensor(n_accept),
        torch.as_tensor(finished), torch.as_tensor(done, dtype=torch.int32),
        torch.as_tensor(budget, dtype=torch.int32), eos)
    np.testing.assert_array_equal(en_t.numpy(), np.asarray(en_j))
    np.testing.assert_array_equal(fin_t.numpy(), np.asarray(fin_j))
    assert (en_t.numpy() <= np.maximum(budget - done, 0)).all()
    # scatter into a buffer whose width the later rows overrun (dropped)
    rng = np.random.RandomState(seed + 10)
    buf = rng.randint(100, 200, (emitted.shape[0], 10))
    start = rng.randint(0, 12, emitted.shape[0])
    sc_j = jspec.scatter_window(jnp.asarray(buf, jnp.int32),
                                jnp.asarray(start, jnp.int32),
                                jnp.asarray(emitted, jnp.int32), en_j)
    sc_t = tspec.scatter_window(torch.as_tensor(buf), torch.as_tensor(start),
                                torch.as_tensor(emitted), en_t)
    np.testing.assert_array_equal(sc_t.numpy(), np.asarray(sc_j))
    tok = rng.randint(0, 8, emitted.shape[0])
    adv_j = jspec.window_advance(jnp.asarray(tok, jnp.int32),
                                 jnp.asarray(emitted, jnp.int32), en_j)
    adv_t = tspec.window_advance(torch.as_tensor(tok),
                                 torch.as_tensor(emitted), en_t)
    np.testing.assert_array_equal(adv_t.numpy(), np.asarray(adv_j))


def test_config_errors_match_jax():
    bad = [dict(mode="telepathy"), dict(k=0), dict(k=MAX_DECODE_QLEN),
           dict(ngram=0)]
    for kw in bad:
        with pytest.raises(ValueError) as ej:
            JaxSpeculativeConfig(**kw)
        with pytest.raises(ValueError) as et:
            SpeculativeConfig(**kw)
        assert str(et.value) == str(ej.value)
    SpeculativeConfig(k=MAX_DECODE_QLEN - 1)        # window == 8
    for args in (("draft", None), ("ngram", object()), (3, None)):
        with pytest.raises((ValueError, TypeError)) as ej:
            jspec.as_spec_config(*args)
        with pytest.raises((ValueError, TypeError)) as et:
            tspec.as_spec_config(*args)
        assert type(et.value) is type(ej.value)
        assert str(et.value) == str(ej.value)
    assert tspec.as_spec_config(None) is None
    assert tspec.as_spec_config("ngram") == SpeculativeConfig()
    spec = SpeculativeConfig(k=2, ngram=4)
    assert tspec.as_spec_config(spec) is spec


# ------------------------------------------------------------- sampling


@pytest.mark.parametrize("draft_tok", [0, 4])
def test_spec_accept_rejection_matches_target_distribution(draft_tok):
    """A point-mass drafter (the likeliest token, or a rare one), accept
    with p(d) and resample the residual: the first emitted token must
    follow the target distribution (the JAX test's statistic: total
    variation < 0.1 over 800 draws)."""
    probs = np.array([0.45, 0.25, 0.15, 0.10, 0.05], np.float64)
    n = 800
    logits = np.log(probs)[None, None, :].repeat(2, axis=1).repeat(n, 0)
    draft = torch.full((n, 1), draft_tok, dtype=torch.int64)
    cfg = GenerationConfig(do_sample=True, temperature=1.0)
    emitted, n_accept = spec_accept(
        torch.as_tensor(logits, dtype=torch.float32), draft,
        torch.Generator().manual_seed(draft_tok), cfg)
    emp = np.bincount(emitted[:, 0].numpy(), minlength=5) / n
    tv = 0.5 * np.abs(emp - probs).sum()
    assert tv < 0.1, f"total variation {tv:.3f}: emp={emp} vs {probs}"
    # acceptance at the draft token's own probability
    assert abs(float(n_accept.float().mean()) - probs[draft_tok]) < 0.06


def test_spec_accept_top_k_one_is_greedy():
    logits = np.zeros((1, 2, 8), np.float32)
    logits[0, 0, 3] = logits[0, 1, 5] = 4.0
    cfg = GenerationConfig(do_sample=True, temperature=1.7, top_k=1)
    gen = torch.Generator().manual_seed(0)
    for _ in range(10):
        em, n = spec_accept(torch.as_tensor(logits), torch.tensor([[3]]),
                            gen, cfg)
        assert int(n[0]) == 1
        np.testing.assert_array_equal(em[0].numpy(), [3, 5])
        em, n = spec_accept(torch.as_tensor(logits), torch.tensor([[6]]),
                            gen, cfg)
        assert int(n[0]) == 0 and int(em[0, 0]) == 3


def test_generate_spec_sampling_seeded_and_top_k_one(pair, prompt_ids):
    _, tm = pair
    kw = dict(do_sample=True, temperature=1.3, top_k=50,
              speculative="ngram")
    a = generate(tm, prompt_ids, 8, seed=11, **kw)
    b = generate(tm, prompt_ids, 8, seed=11, **kw)
    c = generate(tm, prompt_ids, 8, seed=12, **kw)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not np.array_equal(a.numpy(), c.numpy())
    assert a.shape == (2, 8) and (a >= 0).all() and (a < 512).all()
    greedy = generate(tm, prompt_ids, 8)
    top1 = generate(tm, prompt_ids, 8, do_sample=True, top_k=1, seed=3,
                    speculative="ngram")
    np.testing.assert_array_equal(top1.numpy(), greedy.numpy())


# ----------------------------------------------------- generate vs JAX


@pytest.mark.parametrize("k", [1, 4])
def test_generate_ngram_greedy_matches_sequential_and_jax(pair, prompt_ids,
                                                          k):
    """Greedy speculative tokens equal the port's sequential generate and
    JAX generate(speculative=...), with eos padding, and on ragged rows."""
    jm, tm = pair
    seq = generate(tm, prompt_ids, 16).numpy()
    out = generate(tm, prompt_ids, 16,
                   speculative=SpeculativeConfig(k=k)).numpy()
    np.testing.assert_array_equal(out, seq)
    eos = int(seq[0, 3])
    kw = dict(eos_token_id=eos, pad_token_id=499)
    ref = _jax_tokens(jm, prompt_ids, 16,
                      speculative=JaxSpeculativeConfig(k=k), **kw)
    out = generate(tm, prompt_ids, 16, speculative=SpeculativeConfig(k=k),
                   **kw).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, generate(tm, prompt_ids, 16,
                                                **kw).numpy())
    assert (out[0, 4:] == 499).all()
    plen = np.array([5, 12])
    rag = generate(tm, prompt_ids, 8, prompt_len=plen, cache_max_len=128,
                   speculative=SpeculativeConfig(k=k)).numpy()
    np.testing.assert_array_equal(rag, generate(
        tm, prompt_ids, 8, prompt_len=plen, cache_max_len=128).numpy())
    np.testing.assert_array_equal(rag, _jax_tokens(
        jm, prompt_ids, 8, prompt_len=plen.astype(np.int32),
        cache_max_len=128, speculative=JaxSpeculativeConfig(k=k)))


def test_generate_draft_model_matches_sequential_and_jax(pair, draft_pair,
                                                         prompt_ids):
    """Draft mode with test-tiny-draft: the sequential tokens and JAX's;
    with the target itself as the draft model every proposal is accepted
    (the k+1-step draft keeps both caches aligned under full acceptance)."""
    jm, tm = pair
    jd, td = draft_pair
    seq = generate(tm, prompt_ids, 12).numpy()
    sess = GenerationSession(tm)
    out = generate(tm, prompt_ids, 12, speculative="draft", draft_model=td,
                   session=sess).numpy()
    np.testing.assert_array_equal(out, seq)
    np.testing.assert_array_equal(out, _jax_tokens(
        jm, prompt_ids, 12, speculative="draft", draft_model=jd))
    # max_new 11 = the prefill token + two full k=4 windows: no budget
    # clamp discards an acceptance, so self-drafting accepts all
    spec = SpeculativeConfig(mode="draft")
    out = generate(tm, prompt_ids, 11, speculative=spec, draft_model=tm,
                   session=sess).numpy()
    np.testing.assert_array_equal(out, seq[:, :11])
    st = sess.speculative(spec, tm).stats
    assert st["proposed"] == 2 * 2 * 4 and st["accepted"] == st["proposed"]
    assert sess.speculative(spec, tm) is sess.speculative(spec, tm)


def test_spec_budget_boundary_never_overshoots(pair):
    """max_new_tokens lands mid-window (k=4, high acceptance): exactly
    the budget, equal to sequential decode."""
    _, tm = pair
    ids = _looping_prompt()
    for max_new in (5, 6, 7):
        ref = generate(tm, ids, max_new).numpy()
        out = generate(tm, ids, max_new, speculative="ngram").numpy()
        assert out.shape == (1, max_new)
        np.testing.assert_array_equal(out, ref)


def test_spec_ring_capacity_and_overhang_guards(pair, draft_pair,
                                                prompt_ids):
    """The ring carries k slack: the exact bound runs and equals
    sequential decode, one below raises naming the overhang (and fits
    without speculation); the position tables (target and draft) carry
    the overhang too."""
    _, tm = pair
    ids = _looping_prompt()                       # prompt 24
    k, max_new = 4, 8
    exact = 24 + max_new + k
    out = generate(tm, ids, max_new, cache_max_len=exact,
                   speculative=SpeculativeConfig(k=k)).numpy()
    np.testing.assert_array_equal(out, generate(
        tm, ids, max_new, cache_max_len=exact).numpy())
    with pytest.raises(ValueError, match="overhang"):
        generate(tm, ids, max_new, cache_max_len=exact - 1,
                 speculative=SpeculativeConfig(k=k))
    generate(tm, ids, max_new, cache_max_len=exact - 1)
    # prompt 12 + 113 fits max_position_embeddings=128, not with k=4
    with pytest.raises(ValueError, match="overhang"):
        generate(tm, prompt_ids, 113, speculative="ngram")
    short = gpt("test-tiny-draft", device="cpu",
                max_position_embeddings=16).eval()
    with pytest.raises(ValueError, match="DRAFT"):
        generate(tm, prompt_ids, 8, speculative="draft", draft_model=short)
    with pytest.raises(ValueError, match="draft_model"):
        tm.generate(prompt_ids, 4, speculative="draft")
    with pytest.raises(ValueError, match="ngram"):
        tm.generate(prompt_ids, 4, speculative="ngram",
                    draft_model=draft_pair[1])
    with pytest.raises(TypeError, match="SpeculativeConfig"):
        tm.generate(prompt_ids, 4, speculative=3)


@pytest.fixture(scope="module")
def varied(pair):
    """test-tiny with its non-embedding matrices scaled by 2: streams that
    vary and depend on the positions (random weights otherwise repeat one
    token, which hides a position error), that still accept drafts."""
    m = gpt("test-tiny", device="cpu")
    m.load_state_dict(pair[1].state_dict())
    with torch.no_grad():
        for name, p in m.named_parameters():
            if p.dim() == 2 and "wte" not in name:
                p.mul_(2.0)
    return m.eval()


@pytest.mark.parametrize("spec,draft", [
    (SpeculativeConfig(k=1, ngram=2), None),
    (SpeculativeConfig(k=4, ngram=2), None),
    (SpeculativeConfig(mode="draft", k=4), "self"),
    (SpeculativeConfig(mode="draft", k=3), "tiny-draft"),
])
def test_generate_position_sensitive_stream_matches_sequential(
        varied, draft_pair, spec, draft):
    """On streams that vary: greedy speculative tokens equal the
    sequential ones on ragged rows with eos, wide and int8; self-drafting
    accepts every proposal that no budget clamp discards."""
    ids = np.random.RandomState(5).randint(0, 512, (3, 14))
    plen = np.array([14, 6, 9])
    dm = {"self": varied, "tiny-draft": draft_pair[1], None: None}[draft]
    for kv in (None, "int8"):
        seq = generate(varied, ids, 24, prompt_len=plen,
                       kv_cache_dtype=kv).numpy()
        assert all(len(set(r.tolist())) > 3 for r in seq)
        sess = GenerationSession(varied, kv)
        out = generate(varied, ids, 24, prompt_len=plen, kv_cache_dtype=kv,
                       speculative=spec, draft_model=dm, session=sess)
        np.testing.assert_array_equal(out.numpy(), seq)
        eos = int(seq[1, 5])
        kw = dict(prompt_len=plen, kv_cache_dtype=kv, eos_token_id=eos)
        np.testing.assert_array_equal(
            generate(varied, ids, 24, speculative=spec, draft_model=dm,
                     **kw).numpy(),
            generate(varied, ids, 24, **kw).numpy())
        st = sess.speculative(spec, dm).stats
        assert st["accepted"] > 0
        if draft == "self":
            # 24 = the prefill token + 4 full windows + 3 tokens of a
            # fifth, whose budget clamp discards one accepted draft a row
            assert st["accepted"] == st["proposed"] - 3
