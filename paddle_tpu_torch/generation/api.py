"""Autoregressive generation: the (prefill, decode) pair and the host
loop (the JAX package's ``generation/api.py``, run eagerly: no AOT
compile and no retrace tracking are needed in PyTorch).

``generate(speculative=...)`` hands off to ``speculative.decode_loop``:
draft + verify windows of ``k + 1`` tokens in place of single steps.

Networks plug in through the cache protocol (``models/gpt.py``):
``forward(input_ids, use_cache=True, prompt_len=..., cache_max_len=N)``
returns (next-token logits, filled cache) for prefill, and
``forward(input_ids, cache=cache)`` returns (logits, cache) for decode.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import monitor
from .kv_cache import resolve_cache_dtype
from .sampling import sample

__all__ = ["GenerationConfig", "GenerationSession", "generate"]

_EOS_CHECK_EVERY = 16  # decode steps between host reads of `finished`


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """Sampling and stopping configuration."""
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    eos_token_id: Optional[int] = None
    pad_token_id: Optional[int] = None

    @property
    def pad_value(self) -> int:
        if self.pad_token_id is not None:
            return int(self.pad_token_id)
        return int(self.eos_token_id) if self.eos_token_id is not None \
            else 0

    def sample_kwargs(self) -> dict:
        return dict(do_sample=self.do_sample, temperature=self.temperature,
                    top_k=self.top_k, top_p=self.top_p)


def _round_up(n: int, mult: int = 128) -> int:
    return -(-int(n) // mult) * mult


def _expect_logits_cache(out):
    """The cache protocol returns exactly (logits, cache)."""
    if not (isinstance(out, (tuple, list)) and len(out) == 2):
        got = (f"a {len(out)}-tuple" if isinstance(out, (tuple, list))
               else type(out).__name__)
        raise TypeError(
            "generate(): the network's cached forward must return "
            f"(logits, cache), got {got}; use a generative LM head "
            "(e.g. models.gpt.GPTForCausalLM)")
    return out


class GenerationSession:
    """The (prefill, decode) pair for one network. ``cache_dtype``
    (None = full width, ``"int8"`` = the quantized cache) is what its
    prefill creates: a session serves exactly one cache dtype."""

    def __init__(self, network, cache_dtype=None):
        network.eval()
        self.network = network
        self.cache_dtype = resolve_cache_dtype(cache_dtype) \
            if cache_dtype is not None else None
        self._spec_sessions = {}  # (SpeculativeConfig, draft id) -> sess
        #: the shapes ``aot_compile`` warmed: (kind, shape, cache_len, cfg)
        self.registered = set()

    @property
    def device(self) -> torch.device:
        return next(self.network.parameters()).device

    def _ensure_eval(self):
        if self.network.training:
            self.network.eval()

    @torch.no_grad()
    def prefill(self, ids, prompt_len, cfg: GenerationConfig,
                cache_len: int, generator=None):
        """Prefill the right-padded prompt ``ids`` [B, S] (true lengths
        ``prompt_len`` [B]); returns (first token [B], cache, finished
        [B])."""
        self._ensure_eval()
        kw = {} if self.cache_dtype is None \
            else {"cache_dtype": self.cache_dtype}
        logits, cache = _expect_logits_cache(self.network(
            ids, use_cache=True, prompt_len=prompt_len,
            cache_max_len=cache_len, **kw))
        tok = sample(logits[:, -1], generator, **cfg.sample_kwargs())
        if cfg.eos_token_id is not None:
            finished = tok == cfg.eos_token_id
        else:
            finished = torch.zeros_like(tok, dtype=torch.bool)
        return tok, cache, finished

    @torch.no_grad()
    def decode(self, tok, cache, finished, cfg: GenerationConfig,
               generator=None):
        """One decode step; returns (next token, emitted token — the
        pad value on rows that finished earlier —, cache, finished)."""
        self._ensure_eval()
        logits, cache = _expect_logits_cache(
            self.network(tok[:, None], cache=cache))
        nxt = sample(logits[:, -1], generator, **cfg.sample_kwargs())
        emitted = torch.where(finished, torch.full_like(nxt, cfg.pad_value),
                              nxt)
        if cfg.eos_token_id is not None:
            finished = finished | (nxt == cfg.eos_token_id)
        return nxt, emitted, cache, finished

    @torch.no_grad()
    def aot_compile(self, batch: int, prompt_len: int, cache_len: int,
                    cfg: GenerationConfig, decode: bool = True):
        """The warm build of the (prefill, decode) pair for one padded
        shape (the JAX package compiles it ahead of time): load every
        kernel library the pair launches, run the pair once on scratch
        state (a pad-token batch, a scratch cache and a scratch sampling
        generator) and register the shape. Nothing is recorded.
        ``decode=False`` runs the prefill only (the draft model's
        admission path)."""
        ids, plen, gen = self.scratch_batch(batch, prompt_len, cfg)
        tok, cache, finished = self.prefill(ids, plen, cfg, cache_len, gen)
        self.registered.add(("prefill", (batch, prompt_len), cache_len,
                             cfg))
        if decode:
            self.decode(tok, cache, finished, cfg, gen)
            self.registered.add(("decode", (batch,), cache_len, cfg))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def scratch_batch(self, batch: int, prompt_len: int,
                      cfg: GenerationConfig):
        """A warm build's inputs: a pad-token [batch, prompt_len] batch,
        prompt lengths of 1, and a scratch sampling generator (None when
        greedy), so nothing draws from the caller's generators."""
        dev = self.device
        gen = None
        if cfg.do_sample:
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
        ids = torch.full((batch, prompt_len), cfg.pad_value,
                         dtype=torch.int64, device=dev)
        return ids, torch.ones(batch, dtype=torch.int64, device=dev), gen

    def speculative(self, spec, draft_network=None):
        """The cached :class:`speculative.SpeculativeSession` (the draft
        and verify pair) for one SpeculativeConfig and draft network,
        reused across ``generate(speculative=..., session=...)`` calls."""
        from .speculative import SpeculativeSession
        key = (spec, id(draft_network))
        sess = self._spec_sessions.get(key)
        if sess is None:
            sess = SpeculativeSession(self, spec,
                                      draft_network=draft_network)
            self._spec_sessions[key] = sess
        return sess


def _as_int_ids(input_ids) -> np.ndarray:
    if isinstance(input_ids, torch.Tensor):
        input_ids = input_ids.cpu().numpy()
    ids = np.asarray(input_ids)
    if ids.ndim == 1:
        ids = ids[None, :]
    if ids.ndim != 2:
        raise ValueError(f"input_ids must be [batch, seq], got "
                         f"shape {ids.shape}")
    return ids.astype(np.int64)


def _record_call(arr, cfg, n_done, plen, cache_len, cache, sess):
    """End-of-call telemetry of the sequential path (the JAX package's
    ``generate``): real generated tokens (the live rows ``arr`` holds,
    each up to its first eos), the cache occupancy, and on an int8 cache
    the bytes it saved against the activations' width and this call's
    saturation count. One host read of the result and of ``clips``, at
    call end only."""
    if cfg.eos_token_id is not None:
        hit = arr == cfg.eos_token_id
        per_row = np.where(hit.any(1), hit.argmax(1) + 1, n_done)
        tokens = int(per_row.sum())
    else:
        tokens = arr.shape[0] * n_done
    monitor.record_generation(tokens=tokens)
    monitor.record_cache_occupancy((int(plen.max()) + n_done) / cache_len)
    if getattr(cache, "k_scale", None) is not None:
        monitor.record_kv_quant(
            bytes_saved=quant_bytes_saved(
                cache, next(sess.network.parameters()).dtype),
            scale_clips=int(cache.clips))


def quant_bytes_saved(cache, wide_dtype) -> int:
    """Device bytes an int8 cache saves against the wide dtype it would
    have carried (the JAX package counts the width of the model's first
    state value): one byte less for each K and V value, less the two
    bf16 scale arrays (host arithmetic over shapes)."""
    wide = wide_dtype.itemsize if wide_dtype.is_floating_point else 4
    saved = 2 * cache.k.numel() * (wide - 1) - 2 * cache.k_scale.numel() * 2
    return max(0, saved)


def generate(network, input_ids, max_new_tokens: int = 32, *,
             do_sample: bool = False, temperature: float = 1.0,
             top_k: int = 0, top_p: float = 1.0,
             eos_token_id: Optional[int] = None,
             pad_token_id: Optional[int] = None,
             prompt_len=None, cache_max_len: Optional[int] = None,
             seed: Optional[int] = None,
             session: Optional[GenerationSession] = None,
             live_rows: Optional[int] = None,
             speculative=None, draft_model=None,
             kv_cache_dtype=None) -> torch.Tensor:
    """Generate ``max_new_tokens`` tokens after ``input_ids`` on the
    network's device.

    input_ids: [batch, seq] int prompt (right-padded for ragged
    batches; pass per-row true lengths via ``prompt_len``). Returns the
    GENERATED ids only, [batch, max_new_tokens] int32; with
    ``eos_token_id`` set, positions after a row's first eos hold
    ``pad_token_id`` (default: the eos id). One prefill plus one decode
    step per token; raises up front when prompt + new tokens would
    exceed the model's ``max_position_embeddings``. Sampling draws from
    a generator seeded with ``seed``, or from the device's default
    generator; greedy decoding draws nothing.

    ``kv_cache_dtype="int8"`` (or ``PADDLE_KV_CACHE_DTYPE=int8``)
    quantizes the KV cache: int8 values with per-(position, head) bf16
    scales, dequantized inside the decode kernel (half the cache bytes
    per step). ``session`` reuses a :class:`GenerationSession`; asking
    it for another cache dtype than it serves raises.

    ``live_rows`` marks how many leading batch rows are real requests
    (the Predictor pads its fixed batch with dummy rows): the
    ``gen.tokens`` metric counts only those, each up to its first eos.
    """
    ids = _as_int_ids(input_ids)
    b, s = ids.shape
    max_new_tokens = int(max_new_tokens)
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, "
                         f"got {max_new_tokens}")
    if prompt_len is None:
        plen = np.full((b,), s, np.int64)
    else:
        if isinstance(prompt_len, torch.Tensor):
            prompt_len = prompt_len.cpu().numpy()
        plen = np.asarray(prompt_len).astype(np.int64).reshape(-1)
        if plen.shape != (b,):
            raise ValueError(f"prompt_len must be [batch]={b}, got "
                             f"shape {plen.shape}")
        if (plen < 1).any() or (plen > s).any():
            raise ValueError("prompt_len entries must be in [1, "
                             f"{s}], got {plen.tolist()}")

    from .speculative import as_spec_config
    spec = as_spec_config(speculative, draft_model)
    # the verify window writes (and embeds positions for) up to k
    # unaccepted draft tokens past the last real token: the position
    # table and the KV ring both need that slack
    overhang = spec.k if spec is not None else 0

    max_pos = getattr(getattr(network, "cfg", None),
                      "max_position_embeddings", None)
    total = int(plen.max()) + max_new_tokens
    if max_pos is not None and total + overhang > int(max_pos):
        raise ValueError(
            f"generate(): prompt ({int(plen.max())} tokens) + "
            f"max_new_tokens ({max_new_tokens})"
            + (f" + speculative window overhang ({overhang})"
               if overhang else "")
            + f" = {total + overhang} exceeds the "
            f"model's max_position_embeddings ({int(max_pos)})")
    # the draft model walks the same positions (its cache stays aligned
    # with the target's): a smaller draft position table would clip its
    # gathers into garbage proposals instead of an error
    if spec is not None and spec.mode == "draft":
        d_max = getattr(getattr(draft_model, "cfg", None),
                        "max_position_embeddings", None)
        if d_max is not None and total + overhang > int(d_max):
            raise ValueError(
                f"generate(): prompt + max_new_tokens + speculative "
                f"overhang = {total + overhang} exceeds the DRAFT "
                f"model's max_position_embeddings ({int(d_max)}); the "
                "draft model must cover the same positions as the "
                "target")
    cache_len = int(cache_max_len) if cache_max_len is not None \
        else _round_up(s + max_new_tokens + overhang)
    if cache_len < s + max_new_tokens + overhang:
        raise ValueError(
            f"cache_max_len {cache_len} < prompt {s} + max_new_tokens "
            f"{max_new_tokens}"
            + (f" + speculative verify-window overhang {overhang} (the "
               "last window's unaccepted draft tokens still write "
               "their KV before rollback)" if overhang else "")
            + "; the ring cache would wrap and overwrite the oldest "
            "context")

    cfg = GenerationConfig(do_sample=do_sample, temperature=temperature,
                           top_k=top_k, top_p=top_p,
                           eos_token_id=eos_token_id,
                           pad_token_id=pad_token_id)
    cache_dtype = resolve_cache_dtype(kv_cache_dtype)
    if session is not None:
        if kv_cache_dtype is not None and \
                session.cache_dtype != kv_cache_dtype:
            raise ValueError(
                f"generate(): session serves kv_cache_dtype="
                f"{session.cache_dtype!r} but {kv_cache_dtype!r} was "
                "requested; build a session with the matching "
                "cache_dtype")
        sess = session
    else:
        sess = GenerationSession(network, cache_dtype)
    dev = sess.device
    generator = None
    if cfg.do_sample:
        if seed is not None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(int(seed))
        else:
            from ..core import random as _random
            generator = _random.generator(dev)

    if spec is not None:
        from .speculative import decode_loop
        return decode_loop(sess, ids, plen, cfg, spec, draft_model,
                           cache_len, max_new_tokens, generator,
                           live_rows=live_rows)

    tok, cache, finished = sess.prefill(
        torch.as_tensor(ids, device=dev), torch.as_tensor(plen, device=dev),
        cfg, cache_len, generator)
    if monitor.enabled:
        monitor.record_generation(prefill_steps=1)
    outs = [tok]
    for i in range(max_new_tokens - 1):
        tok, emitted, cache, finished = sess.decode(tok, cache, finished,
                                                    cfg, generator)
        outs.append(emitted)
        if monitor.enabled:
            monitor.record_generation(decode_steps=1)
        # eos early exit: one tiny host read every K steps
        if cfg.eos_token_id is not None and \
                (i + 1) % _EOS_CHECK_EVERY == 0 and bool(finished.all()):
            break
    result = torch.stack(outs, dim=1).to(torch.int32)
    n_done = result.shape[1]
    if monitor.enabled:
        live = b if live_rows is None else min(int(live_rows), b)
        _record_call(result[:live].cpu().numpy(), cfg, n_done, plen,
                     cache_len, cache, sess)
    if n_done < max_new_tokens:                      # early eos exit
        pad = torch.full((b, max_new_tokens - n_done), cfg.pad_value,
                         dtype=torch.int32, device=dev)
        result = torch.cat([result, pad], dim=1)
    return result
