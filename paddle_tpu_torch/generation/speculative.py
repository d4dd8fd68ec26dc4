"""Speculative decoding: draft-propose + single-dispatch verify (the JAX
package's ``generation/speculative.py``, eager, on explicit devices).

Sequential decode pays one target forward per token. A DRAFTER proposes
``k`` tokens, then ONE target forward over the ``k + 1``-token window
verifies them all: the window is a decode-shaped query of ``k + 1 <=
MAX_DECODE_QLEN`` rows, so it runs in the flash decode kernel (dense
cache) or the paged decode kernel (paged cache), each row attending the
cache to its own position. Per-row accept lengths decide how many
tokens each row emitted (1 to k + 1 a window). Two drafters:

- **prompt lookup** (``mode="ngram"``): the most recent earlier
  occurrence of the row's last ``ngram`` tokens in its own token buffer
  (prompt + everything emitted, on the device); its continuation is the
  draft. No second model.
- **draft model** (``mode="draft"``): a small LM sharing the target's
  vocabulary and cache layout proposes ``k`` tokens greedily in ``k +
  1`` steps (the extra step writes the last draft token's KV, so both
  caches stay aligned under full acceptance).

Acceptance is exact. Greedy: accept draft tokens while they equal the
target argmax, then emit the target's own token; the stream is the
sequential greedy stream. Sampling: rejection sampling against the
target's FILTERED distribution (temperature, top-k, top-p as
``sampling.sample`` applies them). Both drafters are deterministic, so a
draft token ``d`` is accepted with probability ``p_target(d)`` and a
rejection resamples from the residual with ``d`` masked out; the emitted
marginal is the sequential sampling marginal. Random draws come from an
explicit ``torch.Generator``.

KV rollback is free: the verify forward writes all ``k + 1`` positions,
then each row's ``kv_len`` is rolled back to ``base + emit_n``; entries
past ``kv_len`` are masked and overwritten by the next window. The ring
carries ``k`` positions of slack past prompt + max_new for the last
window's overhang; ``generate()`` and the serving engine check that up
front.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import monitor
from ..kernels.flash_attention import MAX_DECODE_QLEN
from .sampling import apply_temperature, apply_top_k, apply_top_p

__all__ = ["SpeculativeConfig", "SpeculativeSession", "ngram_propose",
           "spec_accept"]


@dataclasses.dataclass(frozen=True)
class SpeculativeConfig:
    """Speculation knobs.

    mode: ``"ngram"`` (prompt lookup, no second model) or ``"draft"`` (a
    draft LM passed separately). k: draft tokens a window; the verify
    window is ``k + 1`` query rows and must fit the decode kernel's
    window. ngram: the suffix length the prompt-lookup drafter matches."""
    mode: str = "ngram"
    k: int = 4
    ngram: int = 3

    def __post_init__(self):
        if self.mode not in ("ngram", "draft"):
            raise ValueError(
                f"speculative mode {self.mode!r}: one of 'ngram' "
                "(self-speculative prompt lookup) or 'draft' (draft "
                "model)")
        if self.k < 1:
            raise ValueError(f"speculative draft_k must be >= 1, "
                             f"got {self.k}")
        if self.k + 1 > MAX_DECODE_QLEN:
            raise ValueError(
                f"speculative draft_k={self.k}: the verify window "
                f"k+1={self.k + 1} exceeds flash_attention_decode's "
                f"MAX_DECODE_QLEN ({MAX_DECODE_QLEN}, the 8-row fp32 "
                f"sublane tile); use draft_k <= {MAX_DECODE_QLEN - 1}")
        if self.ngram < 1:
            raise ValueError(f"speculative ngram must be >= 1, "
                             f"got {self.ngram}")


def as_spec_config(speculative, draft_model=None):
    """Coerce the user-facing ``speculative=`` argument (None, a mode
    string or a SpeculativeConfig) and cross-check the draft model."""
    if speculative is None or speculative is False:
        return None
    if isinstance(speculative, str):
        speculative = SpeculativeConfig(mode=speculative)
    if not isinstance(speculative, SpeculativeConfig):
        raise TypeError(
            "speculative= takes 'ngram', 'draft', or a "
            f"SpeculativeConfig; got {type(speculative).__name__}")
    if speculative.mode == "draft" and draft_model is None:
        raise ValueError(
            "speculative='draft' needs draft_model= (a generative LM "
            "sharing the target's vocabulary); use "
            "speculative='ngram' for model-free self-speculation")
    if speculative.mode == "ngram" and draft_model is not None:
        raise ValueError(
            "draft_model= given but speculative mode is 'ngram'; pass "
            "speculative='draft' to use it")
    return speculative


# ------------------------------------------------------------- drafters

def ngram_propose(tok_buf, tok_len, *, k: int, n: int):
    """Prompt-lookup proposal with static shapes.

    tok_buf: [B, L] int — each row's token history (prompt + every
    emitted token, the pending one included). tok_len: [B] valid
    lengths. Finds the most recent p < len - n with ``buf[p:p+n] ==
    buf[len-n:len]`` and proposes the k tokens after the match, clamped
    to known tokens; a row without a match (or with fewer than n + 1
    tokens) proposes its last token repeated. Returns [B, k] int64."""
    b, L = tok_buf.shape
    dev = tok_buf.device
    tok_len = tok_len.long()
    ctx_idx = (tok_len[:, None] - n + torch.arange(n, device=dev)[None, :]
               ).clamp(0, L - 1)
    ctx = tok_buf.gather(1, ctx_idx)                            # [B, n]
    win = tok_buf.unfold(1, n, 1)                               # [B, P, n]
    eq = (win == ctx[:, None, :]).all(dim=-1)                   # [B, P]
    p = torch.arange(L - n + 1, device=dev)[None, :]
    valid = (p < tok_len[:, None] - n) & (tok_len[:, None] >= n + 1)
    best = torch.where(eq & valid, p, -1).amax(dim=1)           # [B]
    last = tok_buf.gather(1, (tok_len - 1).clamp_min(0)[:, None])[:, 0]
    cont_idx = best[:, None] + n + torch.arange(k, device=dev)[None, :]
    cont = tok_buf.gather(1, cont_idx.clamp(0, L - 1))
    ok = (best[:, None] >= 0) & (cont_idx < tok_len[:, None])
    return torch.where(ok, cont, last[:, None]).long()


# ----------------------------------------------------------- acceptance

def spec_accept(logits, draft, generator, cfg):
    """Accept or reject k deterministic draft tokens against the
    target's k + 1 logits. logits: [B, k+1, V] fp32 (position j predicts
    the token AFTER window input j); draft: [B, k] int. Returns
    ``(emitted [B, k+1], n_accept [B])``, int64: emitted[j] is draft[j]
    for j < n_accept, the target's own correction or bonus token at
    j == n_accept, and anything past it (the caller's emit count masks
    it).

    Greedy (cfg.do_sample False or temperature 0): accept while draft ==
    argmax. Sampling: rejection sampling against the FILTERED target
    distribution, the accept draws ``torch.rand`` and the correction one
    categorical draw from ``generator``."""
    b, kp1, v = logits.shape
    k = kp1 - 1
    dev = logits.device
    draft = draft.long()
    pos = torch.arange(kp1, device=dev)[None, :]
    dpad = torch.cat([draft, draft[:, -1:]], dim=1)             # [B, k+1]
    if not cfg.do_sample or float(cfg.temperature) == 0.0:
        tgt = torch.argmax(logits, dim=-1)                      # [B, k+1]
        match = (draft == tgt[:, :k]).long()
        n_accept = torch.cumprod(match, dim=1).sum(dim=1)
        corr = tgt.gather(1, n_accept[:, None])
        return torch.where(pos == n_accept[:, None], corr, dpad), n_accept
    if generator is None:
        raise ValueError("sampling (do_sample=True) needs a generator")
    f = apply_temperature(logits, cfg.temperature)
    if cfg.top_k and cfg.top_k > 0:
        f = apply_top_k(f, cfg.top_k)
    if cfg.top_p is not None and float(cfg.top_p) < 1.0:
        f = apply_top_p(f, cfg.top_p)
    probs = torch.softmax(f, dim=-1)                            # [B,k+1,V]
    p_draft = probs[:, :k].gather(-1, draft[..., None])[..., 0]  # [B, k]
    u = torch.rand((b, k), generator=generator, device=dev)
    accept = (u < p_draft).long()
    n_accept = torch.cumprod(accept, dim=1).sum(dim=1)          # 0..k
    # the stop position's distribution: the residual (draft token
    # masked) on a rejection, the filtered distribution for the bonus
    # token on full acceptance
    p_stop = probs.gather(1, n_accept[:, None, None].expand(b, 1, v))[:, 0]
    d_stop = dpad.gather(1, n_accept[:, None])[:, 0]
    masked = p_stop * (torch.arange(v, device=dev)[None, :]
                       != d_stop[:, None])
    resid = torch.where((n_accept == k)[:, None], p_stop, masked)
    corr = torch.multinomial(resid.clamp_min(1e-38), 1,
                             generator=generator)               # [B, 1]
    return torch.where(pos == n_accept[:, None], corr, dpad), n_accept


def acceptance_bookkeeping(emitted, n_accept, finished, done, budget,
                           eos_token_id):
    """Clamp a window's acceptance into per-row emit counts.

    done/budget: [B] tokens already emitted / per-row cap. A row never
    emits past its budget (``emit_n <= budget - done``) nor past its
    first eos inside the window; a finished row emits nothing. Returns
    ``(emit_n, new_finished)``."""
    kp1 = emitted.shape[1]
    avail = (budget.long() - done.long()).clamp_min(0)
    emit_n = torch.minimum(n_accept.long() + 1, avail)
    emit_n = torch.where(finished, torch.zeros_like(emit_n), emit_n)
    j = torch.arange(kp1, device=emitted.device)[None, :]
    if eos_token_id is not None:
        is_eos = (emitted == int(eos_token_id)) & (j < emit_n[:, None])
        eos_hit = is_eos.any(dim=1)
        first = torch.argmax(is_eos.long(), dim=1)
        emit_n = torch.where(eos_hit, torch.minimum(emit_n, first + 1),
                             emit_n)
    else:
        eos_hit = torch.zeros_like(finished)
    new_finished = finished | eos_hit | (done.long() + emit_n
                                         >= budget.long())
    return emit_n, new_finished


def scatter_window(buf, start, vals, emit_n):
    """``buf`` with ``vals[:, :emit_n]`` written at per-row offsets
    ``start``; writes past the buffer's width are dropped, so a clamped
    row never writes anywhere. Returns a new [B, C] tensor (a view of a
    buffer one sink column wider)."""
    b, c = buf.shape
    j = torch.arange(vals.shape[1], device=buf.device)[None, :]
    idx = start.long()[:, None] + j
    keep = (j < emit_n[:, None]) & (idx < c)
    out = torch.cat([buf, buf.new_zeros((b, 1))], dim=1)
    out.scatter_(1, torch.where(keep, idx, c), vals.to(buf.dtype))
    return out[:, :c]


def window_advance(tok, emitted, emit_n):
    """Next pending token: the window's last emitted token (the row's
    old pending token when it emitted nothing)."""
    last = emitted.gather(1, (emit_n - 1).clamp_min(0)[:, None])[:, 0]
    return torch.where(emit_n > 0, last, tok.long())


def apply_verify_window(logits, draft, generator, cfg, spec, tok, cache,
                        finished, done, budget, out_buf, tok_buf, tok_len,
                        proposed, accepted, *, pin_finished_kv=False):
    """The acceptance and bookkeeping behind every verify window
    (``SpeculativeSession.verify`` and the engine's speculative step):
    accept the window, clamp emissions (budget, eos, finished), scatter
    into the output and token-history buffers, advance the pending token
    and the counters, and roll the cache back to the accepted window.
    ``pin_finished_kv`` is the engine's idle-lane contract (a finished
    slot holds kv_len 0, so it never wraps the ring while parked).
    Returns ``(tok, cache, finished, done, out_buf, tok_buf, tok_len,
    proposed, accepted)``, all advanced (the cache in place)."""
    emitted, n_accept = spec_accept(logits, draft, generator, cfg)
    emit_n, new_finished = acceptance_bookkeeping(
        emitted, n_accept, finished, done, budget, cfg.eos_token_id)
    out_buf = scatter_window(out_buf, done, emitted, emit_n)
    tok_buf = scatter_window(tok_buf, tok_len, emitted, emit_n)
    live = (~finished).long()
    proposed = proposed + spec.k * live.sum()
    # acceptances clamped away count as NOT accepted (wasted proposals);
    # the correction or bonus token is never a draft token
    accepted = accepted + (torch.minimum(n_accept, emit_n) * live).sum()
    tok = window_advance(tok, emitted, emit_n)
    # rollback: the forward wrote (and advanced past) all k + 1 window
    # positions; keep only the accepted inputs
    new_len = cache.kv_len.long() - (spec.k + 1) + emit_n
    if pin_finished_kv:
        new_len = torch.where(new_finished, torch.zeros_like(new_len),
                              new_len)
    cache = cache.with_kv_len(new_len)
    return (tok, cache, new_finished, done + emit_n.to(done.dtype), out_buf,
            tok_buf, tok_len + emit_n.to(tok_len.dtype), proposed, accepted)


# -------------------------------------------------------------- session

class SpeculativeSession:
    """The (draft, verify) pair over one target network and, in draft
    mode, one draft network. Built once per (GenerationSession,
    SpeculativeConfig, draft network) and cached on the generation
    session (``GenerationSession.speculative``)."""

    def __init__(self, session, spec: SpeculativeConfig,
                 draft_network=None):
        from .api import GenerationSession
        self.session = session
        self.spec = spec
        self.draft_network = draft_network
        self._draft_session = None
        #: lifetime counters over this session's ``generate`` calls:
        #: verify windows, draft tokens proposed to live rows, accepted
        self.stats = dict(windows=0, proposed=0, accepted=0)
        #: the verify shapes ``aot_compile`` warmed: ("verify", (batch,),
        #: (batch, out-buffer width), cache_len, cfg)
        self.registered = set()
        if spec.mode == "draft":
            if draft_network is None:
                raise ValueError("speculative mode 'draft' needs a "
                                 "draft network")
            draft_network.eval()
            # the draft model's own (prefill, decode) session: its
            # prefill fills the draft cache (full width, as the JAX
            # package's) at the start of generate()
            self._draft_session = GenerationSession(draft_network)

    def registered_buf_width(self, batch: int, cache_len: int, cfg,
                             min_width: int) -> int:
        """The smallest registered verify out-buffer width that holds
        ``min_width`` tokens (``min_width`` itself when none matches).
        A caller asking for fewer tokens than the warmed budget
        (``Predictor.generate(max_new_tokens=...)``) decodes into the
        warmed width: the budget is a lane, and the result is sliced
        back."""
        widths = [k[2][1] for k in self.registered
                  if k[0] == "verify" and k[1] == (batch,)
                  and k[3] == cache_len and k[4] == cfg
                  and k[2][1] >= min_width]
        return min(widths) if widths else min_width

    @torch.no_grad()
    def aot_compile(self, batch: int, prompt_len: int, cache_len: int,
                    max_new: int, cfg):
        """The warm build of the (draft, verify) pair for one padded
        shape: one draft and one verify window on scratch state after a
        scratch prefill (in draft mode the draft model's prefill too),
        nothing recorded, and the verify shape registered for
        ``registered_buf_width``. The base pair is warmed by
        ``GenerationSession.aot_compile``."""
        sess = self.session
        dev = sess.device
        ids, plen, gen = sess.scratch_batch(batch, prompt_len, cfg)
        tok, cache, finished = sess.prefill(ids, plen, cfg, cache_len, gen)
        tok_buf = torch.full((batch, cache_len), cfg.pad_value,
                             dtype=torch.int64, device=dev)
        tok_len = plen + 1
        if self.spec.mode == "draft":
            from .api import GenerationConfig
            _, dcache, _ = self._draft_session.prefill(
                ids, plen, GenerationConfig(), cache_len)
            draft, _ = self.draft(tok, dcache, cache.kv_len)
        else:
            draft = self.draft(tok_buf, tok_len)
        lane = torch.zeros(batch, dtype=torch.int64, device=dev)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        out_buf = torch.full((batch, int(max_new)), cfg.pad_value,
                             dtype=torch.int64, device=dev)
        self.verify(tok, draft, cache, gen, finished, lane,
                    torch.full_like(lane, int(max_new)), out_buf, tok_buf,
                    tok_len, zero, zero, cfg)
        self.registered.add(("verify", (batch,), (batch, int(max_new)),
                             cache_len, cfg))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return self

    @torch.no_grad()
    def draft(self, *args):
        """One draft dispatch: ``(tok_buf, tok_len)`` in ngram mode,
        ``(tok, draft_cache, sync_len)`` in draft mode. Returns the
        [B, k] draft (and, in draft mode, the draft cache)."""
        spec = self.spec
        if spec.mode == "ngram":
            tok_buf, tok_len = args
            return ngram_propose(tok_buf, tok_len, k=spec.k, n=spec.ngram)
        from .api import _expect_logits_cache
        tok, dcache, sync_len = args
        net = self.draft_network
        if net.training:
            net.eval()
        # re-anchor the draft cache at the target's accepted length, so
        # one program serves every acceptance outcome
        dcache = dcache.with_kv_len(sync_len)
        drafts = []
        t = tok
        # k proposals + one step that only writes the last draft token's
        # KV: under full acceptance the next window's rollback needs
        # base + k + 1 entries in BOTH caches
        for _ in range(spec.k + 1):
            logits, dcache = _expect_logits_cache(
                net(t[:, None], cache=dcache))
            t = torch.argmax(logits[:, -1].float(), dim=-1)
            drafts.append(t)
        return torch.stack(drafts[:spec.k], dim=1), dcache

    @torch.no_grad()
    def verify(self, tok, draft, cache, generator, finished, done, budget,
               out_buf, tok_buf, tok_len, proposed, accepted, cfg):
        """One target forward over the [B, k+1] window ``tok`` + ``draft``
        and its acceptance (``apply_verify_window``)."""
        from .api import _expect_logits_cache
        self.session._ensure_eval()
        window = torch.cat([tok.long()[:, None], draft], dim=1)
        logits, cache = _expect_logits_cache(
            self.session.network(window, cache=cache))
        return apply_verify_window(
            logits.float(), draft, generator, cfg, self.spec, tok, cache,
            finished, done, budget, out_buf, tok_buf, tok_len, proposed,
            accepted)


# ----------------------------------------------------------- host loop

@torch.no_grad()
def decode_loop(session, ids, plen, cfg, spec, draft_model, cache_len,
                max_new_tokens, generator, poll_every: int = 4,
                live_rows=None):
    """The speculative ``generate()`` loop: one prefill, then draft +
    verify windows until every row finishes (eos or budget). Rows
    advance raggedly: per-row emit counts live on the device, and the
    host reads one bool every ``poll_every`` windows. Returns the
    [B, max_new_tokens] int32 result with post-eos padding, the
    sequential path's contract (and, under greedy, its tokens). The
    output buffer takes the registered verify width when one holds the
    budget (``registered_buf_width``); ``live_rows`` limits the
    ``gen.tokens`` count to the leading real rows."""
    spec_sess = session.speculative(spec, draft_model)
    dev = session.device
    b = ids.shape[0]
    ids_t = torch.as_tensor(ids, device=dev)
    plen_t = torch.as_tensor(plen, device=dev)
    tok, cache, finished = session.prefill(ids_t, plen_t, cfg, cache_len,
                                           generator)
    if monitor.enabled:
        monitor.record_generation(prefill_steps=1)
    dcache = None
    if spec.mode == "draft":
        # the draft prefill's token is discarded: greedy, so it draws
        # nothing from the generator
        from .api import GenerationConfig
        _, dcache, _ = spec_sess._draft_session.prefill(
            ids_t, plen_t, GenerationConfig(), cache_len)
        if monitor.enabled:
            monitor.record_generation(prefill_steps=1)

    pad = cfg.pad_value
    width = spec_sess.registered_buf_width(b, cache_len, cfg,
                                           max_new_tokens)
    out_buf = torch.full((b, width), pad, dtype=torch.int64, device=dev)
    out_buf[:, 0] = tok
    # the drafter's token history: the padded prompt + the pending token
    hist = np.full((b, cache_len), pad, np.int64)
    hist[:, :ids.shape[1]] = ids
    tok_buf = torch.as_tensor(hist, device=dev)
    tok_buf[torch.arange(b, device=dev), plen_t.long()] = tok
    tok_len = plen_t.long() + 1
    done = torch.ones((b,), dtype=torch.int64, device=dev)
    budget = torch.full((b,), max_new_tokens, dtype=torch.int64, device=dev)
    finished = finished | (done >= budget)
    proposed = torch.zeros((), dtype=torch.int64, device=dev)
    accepted = torch.zeros((), dtype=torch.int64, device=dev)

    windows = 0
    for w in range(max_new_tokens - 1):
        windows += 1
        if spec.mode == "draft":
            draft, dcache = spec_sess.draft(tok, dcache, cache.kv_len)
        else:
            draft = spec_sess.draft(tok_buf, tok_len)
        (tok, cache, finished, done, out_buf, tok_buf, tok_len, proposed,
         accepted) = spec_sess.verify(
            tok, draft, cache, generator, finished, done, budget, out_buf,
            tok_buf, tok_len, proposed, accepted, cfg)
        if monitor.enabled:
            monitor.record_generation(decode_steps=1)
        # every live row emits >= 1 token a window, so the loop also ends
        # unpolled after max_new_tokens - 1 windows
        if (w + 1) % poll_every == 0 and bool(finished.all()):
            break
    result = out_buf[:, :max_new_tokens]
    st = spec_sess.stats
    st["windows"] += windows
    n_prop, n_acc = int(proposed), int(accepted)
    st["proposed"] += n_prop
    st["accepted"] += n_acc
    if monitor.enabled:
        # end-of-call telemetry (the JAX package's decode_loop): one
        # read of the result and the per-row emit counts
        monitor.record_speculative(n_prop, n_acc)
        live = b if live_rows is None else min(int(live_rows), b)
        arr = result[:live].cpu().numpy()
        done_h = done.cpu().numpy()
        if cfg.eos_token_id is not None:
            hit = arr == cfg.eos_token_id
            per_row = np.where(hit.any(1), hit.argmax(1) + 1,
                               max_new_tokens)
            tokens = int(per_row.sum())
        else:
            tokens = int(done_h[:live].sum())
        monitor.record_generation(tokens=tokens)
        # occupancy from the tokens actually emitted
        monitor.record_cache_occupancy(
            int(np.max(np.asarray(plen) + done_h)) / cache_len)
    return result.to(torch.int32)
