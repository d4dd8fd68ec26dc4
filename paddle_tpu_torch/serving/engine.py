"""Continuous-batching serving engine over ONE shared KV cache, dense
or paged (the JAX package's ``serving/engine.py``: dense, paged and
chunked-prefill paths).

- **decode never drains.** The decode step always runs at the fixed
  batch of ``max_batch`` slots against the shared cache. A finished row
  (eos or budget) is masked by its ``finished`` lane: its output buffer
  entry and step count stay frozen and its ``kv_len`` is pinned to 0,
  so an idle lane neither wraps the ring nor walks the position table
  while it waits (on a paged cache its writes go to the null page); the
  slot is freed in place.
- **admission = prefill into a slot.** A queued request is prefilled
  alone (batch 1) at its prompt's bucket (``Config.enable_generation``
  buckets), then its row cache is copied into the freed slot (dense:
  ``KVCache.copy_row_from``; paged: ``PagedKVCache.install_row`` into
  the pages the allocator committed, skipping shared prefix pages) and
  the slot's token/finished/step/budget lanes are reset.
- **paged** (``enable_serving(paged=True)``): admission also needs the
  head request's pages; a head the pool cannot cover stays queued
  (``_page_blocked``) until pages free up. Prompts whose leading full
  pages match a registered prompt reference those pages.
- **chunked prefill** (``prefill_chunk_tokens``): a prompt longer than
  one chunk takes its slot in PENDING_PREFILL and is fed into a batch-1
  side cache one chunk per scheduler iteration, after that iteration's
  decode step; the final chunk samples the first token and installs the
  row as an inline admission would. One chunked admission at a time,
  strict FIFO.
- **int8 cache** (``kv_cache_dtype="int8"`` in ``enable_serving`` or
  ``enable_generation``, or ``PADDLE_KV_CACHE_DTYPE``): the slots are a
  ``QuantKVCache`` or ``QuantPagedKVCache`` (and the chunked side cache
  a ``QuantKVCache``). Prefill quantizes the row once and admission
  copies its int8 values and scales verbatim, so a slot decodes as a
  sequential int8 ``generate`` would. The saturation count stays on the
  device in ``engine._cache.clips``.
- **speculative slots** (``enable_generation(speculative="ngram")``,
  the model-free prompt-lookup drafter only, as in the JAX package):
  each decode step becomes one ngram draft over the slots' token
  histories (``tok_buf``: prompt + everything emitted) and ONE forward
  over the ``[max_batch, k + 1]`` window, then
  ``speculative.apply_verify_window`` advances every live row by 1 to
  k + 1 tokens and rolls ``kv_len`` back to the accepted window. The
  cache, the page plans and the bucket filter carry ``k`` positions of
  overhang; the poll drains the proposed/accepted counters into
  ``stats``.
- **host syncs** happen only at the poll cadence (every ``poll_every``
  decode steps: the [batch] lane reads), once per admission (the
  time-to-first-token point), once per prefill chunk and once per
  completion (the row read).
- **environment**: ``PADDLE_KV_PAGE_SIZE`` and
  ``PADDLE_PREFILL_CHUNK_TOKENS`` fill in the page size and the chunk
  width when neither the keyword nor ``enable_serving`` sets them; a
  value that is not digits is recorded (``errors.swallowed``) and the
  default stays.
- **telemetry** (the JAX engine's recording sites, at the same points
  in the same order): the ``serve.*`` and ``gen.*`` metric families of
  ``core.monitor``, the ``serve.submit/admit/prefill_chunk/evict``
  flight-recorder events, 1-in-``trace_sample`` request spans, per
  request cost, and the ``serve.goodput.*`` ledger (a dispatch that
  built a kernel at its first use is charged to ``compile``). Device
  counters (cache and page occupancy, speculation, int8 clips) are read
  only at the poll; with the registry off every site costs one
  ``if monitor.enabled``-style check.

- **operations surface**: ``warmup()`` (on by default) loads every
  kernel library the scheduler's programs launch and runs each program
  once on scratch state, leaving the live cache, lanes, sampling
  generator, stats and registry as they were; ``health()`` is the
  readiness document a router scores and ``/readyz`` serves; ``drain()``
  rejects the queue, aborts a pending chunked prefill, decodes the
  in-flight slots up to ``drain_timeout_s`` and cancels the stragglers;
  ``start()``/``shutdown()`` run the scheduler on a daemon pump thread;
  ``serve_forever`` drains on a preemption (``distributed.resilience``);
  ``telemetry_port`` (or ``PADDLE_TELEMETRY_PORT``) starts the
  ``core.telemetry_server`` before warmup, so ``/healthz`` answers while
  ``/readyz`` says ``warming``.

On a CUDA card every inline prefill's attention runs in the flash
forward kernel, every chunk's in the chunk kernel, and every decode
step's (a speculative verify window's too) in the flash decode kernel
(dense cache) or the paged decode kernel (paged cache), in their int8
modes on an int8 cache. Two engines may step at once from two threads
(an in-process fleet): the kernel wrappers launch on each thread's
current stream and allocate their scratch per call.
"""
from __future__ import annotations

import collections
import heapq
import os
import threading
import time
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from ..core import flight_recorder, goodput, monitor, telemetry_server
from ..core import slo as slo_mod
from ..generation.api import (GenerationConfig, GenerationSession,
                              _round_up, quant_bytes_saved)
from ..generation.kv_cache import KVCache, resolve_cache_dtype
from ..generation.paged_cache import PageAllocator, PagedKVCache
from ..generation.sampling import sample
from ..generation.speculative import (apply_verify_window, as_spec_config,
                                      ngram_propose)
from ..inference.precision import serving_params
from ..kernels import _build
from .request import QueueFull, Request, RequestParams, RequestStatus

__all__ = ["ServingEngine"]


class ServingEngine:
    """Slot-scheduled continuous batching over a live generative module.

    ::

        cfg = (inference.Config().from_layer(model)
               .enable_use_gpu("bfloat16")
               .enable_generation(max_new_tokens=64,
                                  prefill_buckets=(128, 512),
                                  max_batch=8)
               .enable_serving(max_queue=128))
        engine = ServingEngine(cfg)
        handle = engine.submit(prompt_ids, RequestParams(max_new_tokens=32))
        tokens = handle.result()          # pumps the engine inline
        # or: engine.serve_forever(request_iter)   # blocking loop
        # or: engine.start(); ...; engine.shutdown()

    The keyword arguments override ``enable_serving()``."""

    def __init__(self, config, *, max_queue: Optional[int] = None,
                 poll_every: Optional[int] = None,
                 drain_timeout_s: Optional[float] = None,
                 default_deadline_s: Optional[float] = None,
                 cache_max_len: Optional[int] = None,
                 warmup: bool = True, seed: Optional[int] = None,
                 trace_sample: Optional[int] = None,
                 telemetry_port: Optional[int] = None,
                 paged: Optional[bool] = None,
                 kv_page_size: Optional[int] = None,
                 kv_pages: Optional[int] = None,
                 prefill_chunk_tokens: Optional[int] = None):
        layer = getattr(config, "_layer", None)
        if layer is None:
            raise ValueError("ServingEngine needs a live layer: use "
                             "Config.from_layer(...)")
        opts = getattr(config, "_generation", None)
        if opts is None:
            raise ValueError("ServingEngine reuses the generation "
                             "serving setup: call "
                             "Config.enable_generation() first")
        sopts = getattr(config, "_serving", None) or {}

        def _opt(kw, key, default):
            if kw is not None:
                return kw
            v = sopts.get(key)
            return default if v is None else v

        self.max_queue = int(_opt(max_queue, "max_queue", 64))
        self.poll_every = max(1, int(_opt(poll_every, "poll_every", 4)))
        self.drain_timeout_s = float(
            _opt(drain_timeout_s, "drain_timeout_s", 30.0))
        self.default_deadline_s = _opt(default_deadline_s,
                                       "default_deadline_s", None)
        cache_max_len = _opt(cache_max_len, "cache_max_len", None)
        # per-request tracing: 1-in-N requests carry queue-wait,
        # prefill and decode spans into the flight recorder; 0 = off
        env_sample = os.environ.get("PADDLE_TRACE_SAMPLE", "").strip()
        if env_sample.lower() in ("off", "false", "no"):
            env_default = 0
        elif env_sample.isdigit():
            env_default = int(env_sample)
        else:
            if env_sample:  # garbage must not silently re-enable
                monitor.record_swallowed(
                    "serving.trace_sample",
                    ValueError(f"PADDLE_TRACE_SAMPLE={env_sample!r}"))
            env_default = 8
        self.trace_sample = int(_opt(trace_sample, "trace_sample",
                                     env_default))

        self._sp = serving_params(layer, config)
        self.network = self._sp.layer
        self.device = self._sp.device
        self.config = config
        # the serving knob wins over the generation one; the environment
        # fills the gap
        explicit = sopts.get("kv_cache_dtype")
        if explicit is None:
            explicit = opts.get("kv_cache_dtype")
        self.cache_dtype = resolve_cache_dtype(explicit)
        self._session = GenerationSession(self.network,
                                          cache_dtype=self.cache_dtype)
        self._cfg = GenerationConfig(
            do_sample=opts["do_sample"], temperature=opts["temperature"],
            top_k=opts["top_k"], top_p=opts["top_p"],
            eos_token_id=opts["eos_token_id"],
            pad_token_id=opts["pad_token_id"])
        self.max_new_tokens = int(opts["max_new_tokens"])
        self.max_batch = int(opts["max_batch"])
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")

        # speculative slots: the model-free prompt-lookup drafter only
        # (a draft model would need its own per-slot cache admission);
        # generate() serves draft mode
        self._spec = as_spec_config(opts.get("speculative"),
                                    opts.get("draft_model"))
        if self._spec is not None and self._spec.mode != "ngram":
            raise ValueError(
                "ServingEngine supports speculative='ngram' (the "
                "model-free prompt-lookup drafter); draft-model "
                "speculation is a generate() path for now")
        # the last window's unaccepted draft tokens write their KV (and
        # embed their positions) before the rollback
        overhang = self._spec.k if self._spec is not None else 0
        self._overhang = overhang

        net_cfg = getattr(self.network, "cfg", None)
        max_pos = getattr(net_cfg, "max_position_embeddings", None)
        buckets = sorted(
            int(b) for b in opts["prefill_buckets"]
            if max_pos is None
            or b + self.max_new_tokens + overhang <= int(max_pos))
        if not buckets:
            raise ValueError(
                f"no prefill bucket in {opts['prefill_buckets']} fits "
                f"max_position_embeddings={max_pos} with "
                f"max_new_tokens={self.max_new_tokens}"
                + (f" + speculative overhang {overhang}" if overhang
                   else ""))
        self.buckets = buckets
        self.max_len = int(cache_max_len) if cache_max_len else \
            _round_up(buckets[-1] + self.max_new_tokens + overhang)
        if self.max_len < buckets[-1] + self.max_new_tokens + overhang:
            raise ValueError(
                f"cache_max_len {self.max_len} < largest bucket "
                f"{buckets[-1]} + max_new_tokens {self.max_new_tokens}"
                + (f" + speculative verify-window overhang {overhang} "
                   "(the last window's unaccepted draft tokens still "
                   "write their KV before rollback)" if overhang else "")
                + "; the shared ring cache would wrap under a "
                "full-length request")

        # ------------------------------------------------- paged cache
        # K/V in a pool of fixed-size pages, an int32 page table per
        # slot; admission needs free pages as well as a free slot
        self._alloc = None
        if bool(_opt(paged, "paged", False)):
            # keyword > enable_serving > PADDLE_KV_PAGE_SIZE > 128; an
            # environment value that is not digits is recorded and the
            # default stays
            env_ps = os.environ.get("PADDLE_KV_PAGE_SIZE", "").strip()
            if env_ps and not env_ps.isdigit():
                monitor.record_swallowed(
                    "serving.kv_page_size",
                    ValueError(f"PADDLE_KV_PAGE_SIZE={env_ps!r}"))
            ps = int(_opt(kv_page_size, "kv_page_size",
                          int(env_ps) if env_ps.isdigit() else 128))
            if ps < 1 or self.max_len % ps:
                raise ValueError(
                    f"kv_page_size {ps} must divide the cache length "
                    f"{self.max_len} (PADDLE_KV_PAGE_SIZE / "
                    "enable_serving(kv_page_size=...))")
            self.page_size = ps
            self.pages_per_row = self.max_len // ps
            # default pool: the dense cache's footprint (max_batch rows
            # of max_len) plus the reserved null page
            n_pages = int(_opt(kv_pages, "kv_pages",
                               self.max_batch * self.pages_per_row + 1))
            # a pool that cannot hold ONE full-size request would stall
            # the queue head forever with no error
            worst = -(-(buckets[-1] + self.max_new_tokens + overhang)
                      // ps)
            if n_pages - 1 < worst:
                raise ValueError(
                    f"kv_pages {n_pages} (1 reserved) cannot hold one "
                    f"full-size request: bucket {buckets[-1]} + "
                    f"max_new_tokens {self.max_new_tokens}"
                    + (f" + speculative overhang {overhang}" if overhang
                       else "")
                    + f" needs {worst} pages of {ps}; raise kv_pages "
                    "or kv_page_size")
            self._alloc = PageAllocator(n_pages, ps)
            self._page_seen: Dict[str, int] = {}
            self._pending_pages: Dict[int, tuple] = {}
            self._row_pages: List[Optional[list]] = [None] * self.max_batch
            self._page_blocked = False
            # (req.id, allocator version) of the last head whose plan
            # failed to commit: while the pool is unchanged, the pump
            # loop does not re-plan it
            self._blocked_key = None

        # --------------------------------------------- chunked prefill
        # keyword > enable_serving > PADDLE_PREFILL_CHUNK_TOKENS > off;
        # an environment value that is not digits is recorded and
        # leaves chunking off
        env_ct = os.environ.get("PADDLE_PREFILL_CHUNK_TOKENS", "").strip()
        if env_ct and not env_ct.isdigit():
            monitor.record_swallowed(
                "serving.prefill_chunk_tokens",
                ValueError(f"PADDLE_PREFILL_CHUNK_TOKENS={env_ct!r}"))
        ct = _opt(prefill_chunk_tokens, "prefill_chunk_tokens",
                  int(env_ct) if env_ct.isdigit() else None)
        self.prefill_chunk_tokens = None
        if ct is not None:
            ct = int(ct)
            if ct < 1:
                raise ValueError(
                    f"prefill_chunk_tokens {ct} must be >= 1 "
                    "(PADDLE_PREFILL_CHUNK_TOKENS / "
                    "enable_serving(prefill_chunk_tokens=...))")
            if self._alloc is not None and ct % self.page_size:
                raise ValueError(
                    f"prefill_chunk_tokens {ct} must be a multiple of "
                    f"kv_page_size {self.page_size}: every completed "
                    "chunk must end on a page boundary so its span "
                    "installs into whole committed pages")
            # the final chunk pads to the chunk width, so the side cache
            # takes up to ceil(bucket / C) * C positions; past max_len
            # the ring would wrap them onto the prompt's own prefix
            padded_top = -(-buckets[-1] // ct) * ct
            if ct < buckets[-1] and padded_top > self.max_len:
                raise ValueError(
                    f"prefill_chunk_tokens {ct}: the largest bucket "
                    f"{buckets[-1]} pads to {padded_top} chunked tokens, "
                    f"past the cache length {self.max_len}; raise "
                    "prefill_chunk_tokens or cache_max_len")
            self.prefill_chunk_tokens = ct
        # chunking applies only to prompts LONGER than one chunk
        self._chunk_enabled = (self.prefill_chunk_tokens is not None
                               and self.prefill_chunk_tokens < buckets[-1])
        self._chunking: Optional[dict] = None   # the one in-flight
        #                                         chunked admission

        self._gen = None
        if self._cfg.do_sample:
            self._gen = torch.Generator(device=self.device)
            if seed is not None:
                self._gen.manual_seed(int(seed))
            else:
                from ..core import random as _random
                self._gen.manual_seed(int(torch.randint(
                    0, 2 ** 62, (1,), device=self.device,
                    generator=_random.generator(self.device)).item()))

        # ------------------------------------------------ device state
        B, cap, dev = self.max_batch, self.max_new_tokens, self.device
        wdtype = next(p.dtype for p in self.network.parameters()
                      if p.is_floating_point())
        cd = self.cache_dtype
        self._cache = self._new_cache(B)
        # the served cache dtype as an info gauge, and on an int8 cache
        # the bytes it saves against the width it would have carried
        # (the serving compute dtype, else the model's own)
        self._clips_seen = 0
        if cd is not None:
            self._kv_dtype_label = "int8"
            monitor.record_kv_quant(bytes_saved=quant_bytes_saved(
                self._cache, self._sp.compute_dtype or wdtype))
        else:
            self._kv_dtype_label = str(self._cache.k.dtype).replace(
                "torch.", "")
        monitor.record_kv_dtype(self._kv_dtype_label)
        # chunked prefill's persistent batch-1 side cache: zeroed after
        # each chunked admission (kv_len 0, and clips 0 on an int8 cache)
        self._row_cache = None
        if self._chunk_enabled:
            self._row_cache = self._new_cache(1, dense=True)
        self._rows = torch.arange(B, device=dev)
        self._tok = torch.zeros(B, dtype=torch.int64, device=dev)
        self._finished = torch.ones(B, dtype=torch.bool, device=dev)
        self._steps = torch.zeros(B, dtype=torch.int32, device=dev)
        self._budget = torch.zeros(B, dtype=torch.int32, device=dev)
        self._out_buf = torch.zeros((B, cap), dtype=torch.int64, device=dev)
        if self._spec is not None:
            # drafter lanes: each slot's token history (prompt + emitted,
            # the n-gram lookup corpus) and the proposed/accepted
            # counters the poll drains into stats
            self._tok_buf = torch.zeros((B, self.max_len), dtype=torch.int64,
                                        device=dev)
            self._tok_len = torch.zeros(B, dtype=torch.int64, device=dev)
            self._proposed = torch.zeros((), dtype=torch.int64, device=dev)
            self._accepted = torch.zeros((), dtype=torch.int64, device=dev)

        # ------------------------------------------------- host state
        self._slots: List[Optional[Request]] = [None] * B
        self._slot_used = [False] * B          # reuse detection
        self._queue = collections.deque()
        self._qlock = threading.Lock()
        self._pump_lock = threading.RLock()
        self._thread: Optional[threading.Thread] = None
        self._warm = False
        self._shutdown = False
        self._steps_since_poll = 0
        self._window_t0: Optional[float] = None
        self._window_steps = 0
        self.stats: Dict[str, int] = dict(
            submitted=0, admitted=0, completed=0, cancelled=0,
            rejected=0, slots_reused=0, decode_steps=0, prefills=0,
            prefill_chunks=0, spec_proposed=0, spec_accepted=0)
        # top-K most expensive terminal requests: a heap of (total_s,
        # req id, cost dict)
        self._cost_top: List[tuple] = []
        self._cost_topk = 10
        # goodput ledger (serve.goodput.*): admissions and dispatch
        # windows charge compute (compile when a kernel was built during
        # the dispatch); the unattributed rest is idle
        self._goodput = goodput.GoodputLedger("serve",
                                              default_bucket="idle")
        self._goodput.start()
        # live export surface: telemetry_port= (here or in
        # enable_serving) or PADDLE_TELEMETRY_PORT. Started BEFORE warmup
        # so /healthz answers while the replica warms (/readyz stays 503
        # until warm). A bind failure never aborts the engine: it serves
        # un-scraped and the swallow is recorded.
        self.telemetry = None
        tp = _opt(telemetry_port, "telemetry_port", None)
        try:
            if tp is not None:
                self.telemetry = telemetry_server.TelemetryServer(
                    port=int(tp)).start().attach_engine(self)
            else:
                self.telemetry = telemetry_server.start_from_env(self)
        except OSError as e:
            monitor.record_swallowed("serving.telemetry_bind", e)
        if warmup:
            try:
                self.warmup()
            except BaseException:
                # the caller never gets a handle, so nothing else could
                # release the port
                if self.telemetry is not None:
                    self.telemetry.stop()
                    self.telemetry = None
                raise

    def _new_cache(self, batch: int, dense: bool = False,
                   n_pages: Optional[int] = None):
        """A zeroed cache of the engine's geometry for ``batch`` rows:
        the slots' dense or paged cache (a pool of ``n_pages``, default
        the allocator's), or (``dense``) a batch-1 row cache like the
        chunked side cache."""
        net_cfg = self.network.cfg
        heads = net_cfg.num_heads
        wdtype = next(p.dtype for p in self.network.parameters()
                      if p.is_floating_point())
        if dense or self._alloc is None:
            return KVCache.create(net_cfg.num_layers, batch, self.max_len,
                                  heads, net_cfg.hidden_size // heads,
                                  dtype=wdtype, device=self.device,
                                  cache_dtype=self.cache_dtype)
        return PagedKVCache.create(
            net_cfg.num_layers, batch, n_pages or self._alloc.n_pages,
            self.page_size,
            self.pages_per_row, heads, net_cfg.hidden_size // heads,
            dtype=wdtype, device=self.device, cache_dtype=self.cache_dtype)

    # ----------------------------------------------------------- warmup
    @torch.no_grad()
    def warmup(self):
        """The eager counterpart of compiling every program the
        scheduler can dispatch: build or load every kernel library those
        programs launch, then run each program once on scratch state —
        one prefill per bucket, the admission install, one decode step
        (a verify window on speculative slots), the free, and with
        chunked prefill the chunk and final-chunk pair and (paged) the
        span install. The live cache, lanes, page allocator, slots,
        sampling generator, stats and metrics are left as they were; a
        kernel build here is charged to goodput's ``compile`` bucket."""
        builds0 = _build.build_count()
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            # the flash forward (inline prefill), the slots' decode
            # kernel, the chunk kernel (in the dense decode library) and
            # the cached forward's row-invariant products
            from ..kernels import flash_attention as fa
            from ..kernels import row_linear
            libs = {"flash_fwd": fa._FWD_SIG, "row_gemm": row_linear._SIG}
            if self._alloc is None or self._chunk_enabled:
                libs["flash_decode"] = fa._DECODE_SIG
            if self._alloc is not None:
                libs["flash_decode_paged"] = fa._PAGED_SIG
            for name, sig in libs.items():
                _build.library(name, sig)
        self._warm_programs()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if _build.build_count() > builds0:
            self._goodput.charge("compile", time.perf_counter() - t0)
        self._warm = True
        return self

    def _warm_programs(self):
        """Each scheduler program once, on a scratch cache of ONE row of
        the live geometry (a paged pool of that row's pages and the null
        page) and a scratch generator. The kernels are built per
        library, not per shape, so one row loads and runs what the
        fixed batch does, and warmup's memory stays a row's next to the
        live cache."""
        dev = self.device
        gen = None
        if self._gen is not None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
        skw = self._cfg.sample_kwargs()
        table = None
        if self._alloc is None:
            cache = self._new_cache(1)
        else:
            cache = self._new_cache(1, n_pages=self.pages_per_row + 1)
            table = self._table_row(list(range(1, self.pages_per_row + 1)))
        for bucket in self.buckets:
            ids = torch.full((1, bucket), self._cfg.pad_value,
                             dtype=torch.int64, device=dev)
            tok, row, _ = self._session.prefill(
                ids, torch.ones(1, dtype=torch.int64, device=dev),
                self._cfg, self.max_len, gen)
        # admission install into slot 0, then one decode step (a verify
        # window on speculative slots), then free
        if self._alloc is None:
            cache.copy_row_from(row, 0, 0)
        else:
            cache.install_row(row, 0, table, 0)
        window = tok[:1, None]
        if self._spec is not None:
            window = torch.cat([window, window.new_zeros(
                (1, self._spec.k))], dim=1)
        logits, _ = self.network(window, cache=cache)
        sample(logits[:, -1], gen, **skw)
        cache.reset_rows(0)
        if self._chunk_enabled:
            C = self.prefill_chunk_tokens
            side = self._new_cache(1, dense=True)
            ids = torch.full((1, C), self._cfg.pad_value,
                             dtype=torch.int64, device=dev)
            self.network(ids, cache=side)
            if self._alloc is not None:
                cache.install_span(side, table, 0)
            logits, side = self.network(
                ids, cache=side,
                prompt_len=torch.tensor([2 * C], device=dev))
            sample(logits[:, -1], gen, **skw)

    # -------------------------------------------------------- admission
    def submit(self, prompt, params: Optional[RequestParams] = None) \
            -> Request:
        """Enqueue one prompt; returns the Future-style handle at once.
        Raises :class:`QueueFull` at the queue bound and ``ValueError``
        for prompts no bucket holds or budgets past the engine's."""
        if isinstance(prompt, torch.Tensor):
            prompt = prompt.cpu().numpy()
        ids = np.asarray(prompt).reshape(-1).astype(np.int64)
        if ids.size < 1:
            raise ValueError("empty prompt")
        if ids.size > self.buckets[-1]:
            raise ValueError(
                f"prompt of {ids.size} tokens exceeds the largest "
                f"prefill bucket {self.buckets[-1]}")
        params = params if params is not None else RequestParams()
        budget = self.max_new_tokens if params.max_new_tokens is None \
            else int(params.max_new_tokens)
        if not 1 <= budget <= self.max_new_tokens:
            raise ValueError(
                f"max_new_tokens {budget} outside [1, "
                f"{self.max_new_tokens}] (the engine's budget; raise it "
                "in enable_generation())")
        dl = params.deadline_s if params.deadline_s is not None \
            else self.default_deadline_s
        deadline = None if dl is None else time.monotonic() + float(dl)
        req = Request(ids, params, budget, deadline, engine=self)
        with self._qlock:
            if self._shutdown:
                req._finish(RequestStatus.REJECTED, "shutdown")
                self.stats["rejected"] += 1
                monitor.record_serve_request("rejected")
                raise RuntimeError(
                    "serving engine is shut down; no new requests")
            if len(self._queue) >= self.max_queue:
                reason = self._rejection_reason()
                req._finish(RequestStatus.REJECTED, reason)
                self.stats["rejected"] += 1
                monitor.record_serve_request("rejected")
                raise QueueFull(
                    f"request queue at bound ({self.max_queue}): "
                    f"{reason}", reason=reason, request=req)
            if self.trace_sample and req.id % self.trace_sample == 0:
                req.traced = True
                req._t_submit_ns = flight_recorder.now_ns()
            self._queue.append(req)
            self.stats["submitted"] += 1
            qdepth = len(self._queue)
            monitor.record_serve_queue_depth(qdepth)
        if flight_recorder.enabled:
            flight_recorder.record("serve.submit", req=req.id,
                                   prompt_len=int(ids.size),
                                   budget=budget, queue_depth=qdepth)
        return req

    def _rejection_reason(self) -> str:
        """The structured reason a queue-bound rejection carries on both
        the ``QueueFull`` and the terminal handle (callers hold
        ``_qlock``): ``queue_full:no_free_pages`` when the paged queue
        head waits on pool pages, ``queue_full:no_free_slots`` when every
        decode lane is busy, bare ``queue_full`` when the blocker is not
        known yet (a submit burst filled the queue between scheduler
        steps while slots were free). A router re-routes on it."""
        if self._alloc is not None and self._page_blocked:
            return "queue_full:no_free_pages"
        if sum(s is not None for s in self._slots) >= self.max_batch:
            return "queue_full:no_free_slots"
        return "queue_full"

    @property
    def busy(self) -> bool:
        """True while anything is queued or occupies a slot."""
        with self._qlock:
            if self._queue:
                return True
        return any(s is not None for s in self._slots)

    # -------------------------------------------------------- scheduler
    def step(self):
        """One scheduler iteration: admit queued requests into free
        slots (short prompts inline, long ones as a chunked admission),
        dispatch one fixed-batch decode step for the running slots,
        run at most one prefill chunk, poll completions every
        ``poll_every`` steps. Decode is issued before the chunk's sync,
        so running streams overlap the chunk instead of waiting behind a
        whole long prefill."""
        with self._pump_lock:
            self._admit_ready()
            if any(s is not None and s.status is RequestStatus.RUNNING
                   for s in self._slots):
                self._dispatch_decode()
            self._advance_chunked()
            if self._steps_since_poll >= self.poll_every:
                self._poll()

    def _unblock_if(self, req: Request):
        """Clear the page-pressure flag when the request it was computed
        for leaves the queue."""
        if self._alloc is not None and self._blocked_key is not None \
                and self._blocked_key[0] == req.id:
            self._blocked_key = None
            self._page_blocked = False

    def _pop_queue(self) -> Optional[Request]:
        with self._qlock:
            while self._queue:
                req = self._queue[0]
                if req.deadline is not None and \
                        time.monotonic() > req.deadline:
                    self._queue.popleft()
                    monitor.record_serve_queue_depth(len(self._queue))
                    self._unblock_if(req)
                    self._cancel(req, "deadline")
                    continue
                if self._needs_chunk(req) and self._chunking is not None:
                    # ONE chunked prefill at a time, strict FIFO: the
                    # long head waits (un-popped, no pages committed)
                    return None
                if self._alloc is not None:
                    # the head's page plan must commit before its slot is
                    # spent; a pool too full leaves it QUEUED. While the
                    # pool is unchanged since the head last failed, it is
                    # not re-planned.
                    ver = self._alloc.version
                    if self._blocked_key == (req.id, ver):
                        self._page_blocked = True
                        return None
                    # the plan covers the budget AND the speculative
                    # overhang: the last window writes k positions past it
                    plan = self._alloc.plan(req.prompt,
                                            req.budget + self._overhang)
                    pages = self._alloc.commit(plan)
                    if pages is None:
                        # a failed commit may still have reclaimed cached
                        # pages: key on the version after the attempt
                        self._blocked_key = (req.id, self._alloc.version)
                        self._page_blocked = True
                        return None
                    self._blocked_key = None
                    self._page_blocked = False
                    self._pending_pages[req.id] = (pages, plan)
                self._queue.popleft()
                monitor.record_serve_queue_depth(len(self._queue))
                return req
        return None

    def _needs_chunk(self, req: Request) -> bool:
        """Chunked admission applies to prompts LONGER than one chunk;
        shorter ones prefill inline in one dispatch."""
        return self._chunk_enabled and \
            req.prompt.size > self.prefill_chunk_tokens

    def _admit_ready(self):
        for slot, occupant in enumerate(self._slots):
            if occupant is not None:
                continue
            req = self._pop_queue()
            if req is None:
                break
            try:
                if self._needs_chunk(req):
                    self._begin_chunked(req, slot)
                else:
                    self._admit(req, slot)
            except Exception as e:
                # the request left the queue but reached no slot: it
                # must still go terminal or its handle would hang, and
                # its committed pages must return to the free list; the
                # engine serves the others on, and the swallow is
                # recorded
                if self._chunking is not None and \
                        self._chunking["req"] is req:
                    self._chunking = None
                self._slots[slot] = None
                self._release_pending(req)
                self._cancel(req, f"admission error: "
                                  f"{type(e).__name__}: {e}",
                             label="error")
                monitor.record_swallowed("serving.admit", e)

    def _table_row(self, pages: List[int]) -> torch.Tensor:
        """A slot's page table: the row's pages in position order, the
        unused entries on the null page 0."""
        table = np.zeros((self.pages_per_row,), np.int32)
        table[:len(pages)] = pages
        return torch.as_tensor(table, device=self.device)

    def _install(self, req: Request, slot: int, row_cache: KVCache,
                 tok, fin, start: int = 0):
        """Install a prefilled batch-1 row into ``slot`` and reset the
        slot's lanes (the JAX package's admit_fn / paged_admit_fn). On a
        paged cache only positions at or past ``start`` are written
        (those below are shared prefix pages or already installed
        chunks), then the prompt's full pages are registered."""
        if self._alloc is None:
            self._cache.copy_row_from(row_cache, 0, slot)
        else:
            pages, plan = self._pending_pages[req.id]
            self._cache.install_row(row_cache, slot, self._table_row(pages),
                                    max(start, plan.shared_len))
        self._tok[slot] = tok[0]
        self._steps[slot] = 1
        self._budget[slot] = req.budget
        self._out_buf[slot] = 0
        self._out_buf[slot, 0] = tok[0]
        self._finished[slot] = fin[0] | (req.budget <= 1)
        if self._spec is not None:
            # the drafter's corpus row: the padded prompt with the first
            # token appended
            n = int(req.prompt.size)
            row = torch.full((self.max_len,), self._cfg.pad_value,
                             dtype=torch.int64, device=self.device)
            row[:n] = torch.as_tensor(req.prompt, device=self.device)
            row[n] = tok[0]
            self._tok_buf[slot] = row
            self._tok_len[slot] = n + 1
        if self._alloc is not None:
            # popped only once the install landed: a failed install
            # leaves it for _release_pending to roll back
            self._pending_pages.pop(req.id)
            self._alloc.register(plan, pages)
            self._row_pages[slot] = pages
        if self._slot_used[slot]:
            self.stats["slots_reused"] += 1
        self._slot_used[slot] = True
        self._slots[slot] = req
        req.status = RequestStatus.RUNNING
        self.stats["admitted"] += 1
        monitor.record_serve_slot_occupancy(self._occupied())

    def _occupied(self) -> float:
        return sum(s is not None for s in self._slots) / self.max_batch

    def _exe_prefill(self, bucket: int):
        """The batch-1 prefill call for ``bucket`` (the JAX package's
        per-bucket prefill executable; the eager port has one callable
        for every bucket). Fault injection wraps this fetch."""
        return self._session.prefill

    def _charged(self, req: Request, fn, *args):
        """Run an admission dispatch and book its wall time: to the
        request's prefill cost, and to the goodput ledger as compute, or
        as compile when a kernel library was built during it."""
        builds0 = _build.build_count()
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            dt = time.perf_counter() - t0
            req._cost_prefill_s += dt
            self._goodput.charge(
                "compile" if _build.build_count() > builds0 else "compute",
                dt)

    def _admit(self, req: Request, slot: int):
        self._charged(req, self._admit_inner, req, slot)

    @torch.no_grad()
    def _admit_inner(self, req: Request, slot: int):
        """Batch-1 bucketed prefill, then install the row into ``slot``
        (the JAX package's prefill_fn + admit_fn)."""
        bucket = next(b for b in self.buckets if b >= req.prompt.size)
        ids = np.full((1, bucket), self._cfg.pad_value, np.int64)
        ids[0, :req.prompt.size] = req.prompt
        t_admit_ns = flight_recorder.now_ns() if req.traced else 0
        prefill = self._exe_prefill(bucket)
        tok, row_cache, fin = prefill(
            torch.as_tensor(ids, device=self.device),
            torch.as_tensor([req.prompt.size], device=self.device),
            self._cfg, self.max_len, self._gen)
        # time to first token: the first token exists once the prefill
        # lands — one small sync per admission
        tok.cpu()
        now = time.monotonic()
        req.admitted_at = req.first_token_at = now
        monitor.record_serve_ttft(now - req.submitted_at)
        if flight_recorder.enabled:
            flight_recorder.record("serve.admit", req=req.id, slot=slot,
                                   bucket=bucket)
        if req.traced:
            # the sampled request's first two segments: queued, then the
            # synchronous prefill into the slot
            t1 = flight_recorder.now_ns()
            req.span("queue_wait", req._t_submit_ns, t_admit_ns)
            req.span("prefill", t_admit_ns, t1, bucket=bucket, slot=slot)
            req._t_seg_ns = t1
        monitor.record_generation(prefill_steps=1)
        self.stats["prefills"] += 1
        self._install(req, slot, row_cache, tok, fin)
        # the prefill sync above is not per-token decode latency: the
        # next dispatch re-anchors the poll window
        self._window_steps = 0

    # ------------------------------------------------- chunked prefill
    def _begin_chunked(self, req: Request, slot: int):
        """Reserve ``slot`` for a long prompt and park it in
        PENDING_PREFILL: its lane stays masked (finished, kv_len 0) while
        ``_advance_chunked`` feeds the prompt into the side cache one
        chunk per scheduler iteration. Host bookkeeping only."""
        C = self.prefill_chunk_tokens
        plen = int(req.prompt.size)
        n = -(-plen // C)
        ids = np.full((1, n * C), self._cfg.pad_value, np.int64)
        ids[0, :plen] = req.prompt
        shared = 0
        if self._alloc is not None:
            shared = int(self._pending_pages[req.id][1].shared_len)
        if req.traced:
            req.span("queue_wait", req._t_submit_ns, flight_recorder.now_ns())
        self._chunking = dict(req=req, slot=slot, plen=plen, n=n, next=0,
                              ids=torch.as_tensor(ids, device=self.device),
                              shared=shared, decode_steps=0)
        self._slots[slot] = req
        req.status = RequestStatus.PENDING_PREFILL
        monitor.record_serve_slot_occupancy(self._occupied())

    def _advance_chunked(self):
        """Run AT MOST ONE chunk of the in-flight chunked prefill. The
        final chunk samples the first token and installs the row. The
        deadline of a request mid-prefill is checked here, because
        ``_poll`` skips PENDING_PREFILL slots."""
        st = self._chunking
        if st is None:
            return
        req = st["req"]
        if req.deadline is not None and time.monotonic() > req.deadline:
            self._abort_chunked("deadline")
            return
        # the same goodput and cost contract as _admit: each chunk's
        # wall is the request's prefill cost
        try:
            self._charged(req, self._chunk_step if st["next"] < st["n"] - 1
                          else self._finish_chunked, st)
        except Exception as e:
            self._abort_chunked(
                f"admission error: {type(e).__name__}: {e}",
                label="error")
            monitor.record_swallowed("serving.admit", e)
        finally:
            # the blocking chunk sync is not per-token decode latency
            self._window_steps = 0

    @torch.no_grad()
    def _chunk_step(self, st: dict):
        """One non-final chunk: the decode-mode forward of C tokens over
        the side cache (the chunk kernel attends what the earlier chunks
        wrote), on a paged engine the span install into the committed
        pages, then one sync."""
        req, slot, k = st["req"], st["slot"], st["next"]
        C = self.prefill_chunk_tokens
        t_ns = flight_recorder.now_ns() if req.traced else 0
        self.network(st["ids"][:, k * C:(k + 1) * C], cache=self._row_cache)
        if self._alloc is not None:
            # commit the chunk's positions now, past the shared prefix;
            # the table row and kv_len wait for the final admission
            start = max(k * C, st["shared"])
            if (k + 1) * C > start:
                pages = self._pending_pages[req.id][0]
                self._cache.install_span(self._row_cache,
                                         self._table_row(pages), start)
        # the chunk must land before the host moves on: this sync bounds
        # how long a chunk holds the device between decode steps
        self._row_cache.kv_len.cpu()
        st["next"] = k + 1
        tokens = min(C, st["plen"] - k * C)
        self.stats["prefill_chunks"] += 1
        monitor.record_prefill_chunk(tokens)
        if flight_recorder.enabled:
            flight_recorder.record(
                "serve.prefill_chunk", req=req.id, slot=slot, chunk=k,
                start=k * C, tokens=tokens, remaining=st["n"] - k - 1)
        if req.traced:
            req.span("prefill_chunk", t_ns, flight_recorder.now_ns(),
                     chunk=k, slot=slot, tokens=tokens)

    @torch.no_grad()
    def _finish_chunked(self, st: dict):
        """The final (padded) chunk and the admission: sample the first
        token at the last real prompt position (TTFT), install the side
        cache into the slot, flip the request to RUNNING."""
        req, slot, k = st["req"], st["slot"], st["n"] - 1
        C = self.prefill_chunk_tokens
        t_ns = flight_recorder.now_ns() if req.traced else 0
        plen = torch.tensor([st["plen"]], device=self.device)
        logits, row_cache = self.network(st["ids"][:, k * C:(k + 1) * C],
                                         cache=self._row_cache,
                                         prompt_len=plen)
        tok = sample(logits[:, -1], self._gen, **self._cfg.sample_kwargs())
        if self._cfg.eos_token_id is not None:
            fin = tok == self._cfg.eos_token_id
        else:
            fin = torch.zeros_like(tok, dtype=torch.bool)
        tok.cpu()                     # TTFT point, as inline admission
        now = time.monotonic()
        req.admitted_at = req.first_token_at = now
        monitor.record_serve_ttft(now - req.submitted_at)
        tokens = st["plen"] - k * C
        self.stats["prefill_chunks"] += 1
        monitor.record_prefill_chunk(tokens)
        monitor.record_prefill_interleave(st["decode_steps"] / st["n"])
        if flight_recorder.enabled:
            flight_recorder.record(
                "serve.prefill_chunk", req=req.id, slot=slot, chunk=k,
                start=k * C, tokens=tokens, remaining=0)
            flight_recorder.record("serve.admit", req=req.id, slot=slot,
                                   bucket=st["n"] * C, chunks=st["n"])
        if req.traced:
            t1 = flight_recorder.now_ns()
            req.span("prefill_chunk", t_ns, t1, chunk=k, slot=slot,
                     tokens=tokens)
            req._t_seg_ns = t1
        monitor.record_generation(prefill_steps=1)
        self.stats["prefills"] += 1
        # the spans below the final chunk's base are installed already
        self._install(req, slot, row_cache, tok, fin, start=k * C)
        self._chunking = None
        self._zero_row_cache()

    def _zero_row_cache(self):
        """Reset the chunked side cache for the next chunked admission, in
        place: every tensor zeroed (kv_len 0, clips 0 on an int8 cache),
        as the JAX engine rebuilds it."""
        for name in ("k", "v", "kv_len", "k_scale", "v_scale", "clips"):
            t = getattr(self._row_cache, name, None)
            if t is not None:
                t.zero_()

    def _abort_chunked(self, reason: str, label: Optional[str] = None):
        """Terminal exit for a request mid-prefill (deadline, dispatch
        error): release its committed pages and clear the slot. Its lane
        was never installed (finished, kv_len 0), so nothing on the
        device needs a reset."""
        st, self._chunking = self._chunking, None
        if st is None:
            return
        req, slot = st["req"], st["slot"]
        if flight_recorder.enabled:
            flight_recorder.record(
                "serve.evict", req=req.id, slot=slot, reason=reason,
                tokens=0, chunks_done=st["next"])
        self._zero_row_cache()
        self._release_pending(req)
        self._slots[slot] = None
        self._cancel(req, reason, label=label)
        self._note_cost(req)

    @torch.no_grad()
    def _dispatch_decode(self):
        """The fixed-batch decode step over every slot (the JAX
        package's step_fn, or its spec_step_fn on a speculative engine),
        entirely on the device."""
        if self._spec is not None:
            self._dispatch_verify()
        else:
            self._dispatch_step()
        self._steps_since_poll += 1
        if self._chunking is not None:
            # decode steps interleaved into this chunked admission: the
            # serve.prefill.interleave_ratio numerator
            self._chunking["decode_steps"] += 1
        if self._window_steps == 0:
            # anchor the latency window at the first dispatch after a
            # poll: idle gaps are not per-token latency
            self._window_t0 = time.monotonic()
        self._window_steps += 1
        self.stats["decode_steps"] += 1
        monitor.record_generation(decode_steps=1)

    def _dispatch_step(self):
        """The plain decode step: one token for every live slot."""
        logits, _ = self.network(self._tok[:, None], cache=self._cache)
        nxt = sample(logits[:, -1], self._gen, **self._cfg.sample_kwargs())
        idx = self._steps.clamp(0, self._out_buf.shape[1] - 1).long()
        cur = self._out_buf[self._rows, idx]
        # finished lanes are masked: their buffer entry and step count
        # stay frozen while the fixed-batch step runs on
        self._out_buf[self._rows, idx] = torch.where(self._finished, cur,
                                                     nxt)
        self._steps += (~self._finished).to(self._steps.dtype)
        if self._cfg.eos_token_id is not None:
            self._finished |= nxt == self._cfg.eos_token_id
        self._finished |= self._steps >= self._budget
        # dead slots: pin kv_len at 0 so an idle lane never wraps the
        # ring or walks the position table out of range
        self._cache.kv_len.masked_fill_(self._finished, 0)
        self._tok = nxt

    def _dispatch_verify(self):
        """The speculative step: an ngram draft for every slot, ONE
        forward over the [max_batch, k + 1] window, then the shared
        acceptance, clamp, scatter and rollback core, with finished
        slots pinned at kv_len 0."""
        spec = self._spec
        draft = ngram_propose(self._tok_buf, self._tok_len, k=spec.k,
                              n=spec.ngram)
        window = torch.cat([self._tok[:, None], draft], dim=1)
        logits, _ = self.network(window, cache=self._cache)
        (self._tok, _, self._finished, self._steps, self._out_buf,
         self._tok_buf, self._tok_len, self._proposed,
         self._accepted) = apply_verify_window(
            logits.float(), draft, self._gen, self._cfg, spec, self._tok,
            self._cache, self._finished, self._steps, self._budget,
            self._out_buf, self._tok_buf, self._tok_len, self._proposed,
            self._accepted, pin_finished_kv=True)

    def _poll(self):
        """Read the [batch] finished/step lanes, complete finished rows,
        cancel over-deadline ones (queued and in flight). A
        PENDING_PREFILL slot belongs to ``_advance_chunked``: its lane
        reads finished but it is not done."""
        self._steps_since_poll = 0
        fin = self._finished.cpu().numpy()
        steps = self._steps.cpu().numpy()
        if self._spec is not None:
            # drain the speculation counters in the same poll: read,
            # add to stats, reset on the device
            prop, acc = torch.stack([self._proposed,
                                     self._accepted]).tolist()
            if prop or acc:
                self.stats["spec_proposed"] += prop
                self.stats["spec_accepted"] += acc
                monitor.record_speculative(prop, acc)
            self._proposed.zero_()
            self._accepted.zero_()
        now = time.monotonic()
        window_dt = 0.0
        if self._window_t0 is not None and self._window_steps:
            window_dt = now - self._window_t0
            monitor.record_serve_token_latency(
                window_dt / self._window_steps)
            # the dispatch window (host dispatches and the device wait
            # the lane reads above just paid) is goodput compute
            self._goodput.charge("compute", window_dt)
        self._window_steps = 0   # the next dispatch re-anchors
        if window_dt > 0.0:
            # cost attribution: every live request owns an equal share
            # of the window (the shares sum to it), plus page*seconds
            # for its resident pages; charged before the completions
            # below. A PENDING_PREFILL slot pays for its chunks instead.
            live = sum(r is not None
                       and r.status is not RequestStatus.PENDING_PREFILL
                       for r in self._slots)
            if live:
                share = window_dt / live
                for i, r in enumerate(self._slots):
                    if r is None or \
                            r.status is RequestStatus.PENDING_PREFILL:
                        continue
                    r._cost_decode_s += share
                    if self._alloc is not None:
                        pages = self._row_pages[i]
                        if pages:
                            r._cost_page_s += len(pages) * window_dt
        t_poll_ns = flight_recorder.now_ns()
        for i, req in enumerate(self._slots):
            if req is None or req.status is RequestStatus.PENDING_PREFILL:
                continue
            if fin[i]:
                toks = self._out_buf[i, :int(steps[i])].cpu().numpy()
                self._complete(req, toks)
                self._slots[i] = None     # freed in place
                self._free_slot_pages(i)
            elif req.deadline is not None and now > req.deadline:
                self._evict(i, req, "deadline", int(steps[i]))
            elif req.traced:
                # a rolling decode segment, one span per poll window
                req.span("decode", req._t_seg_ns, t_poll_ns,
                         tokens=int(steps[i]))
                req._t_seg_ns = t_poll_ns
        with self._qlock:
            for req in list(self._queue):
                if req.deadline is not None and now > req.deadline:
                    self._queue.remove(req)
                    self._unblock_if(req)
                    self._cancel(req, "deadline")
            monitor.record_serve_queue_depth(len(self._queue))
        monitor.record_serve_slot_occupancy(self._occupied())
        if monitor.enabled:
            # device-side gauges and counters are read here, at the
            # poll, and nowhere on the decode step
            monitor.record_cache_occupancy(self._cache.occupancy())
            self._drain_page_stats()
            self._drain_quant_stats()
            self._goodput.flush()
            # SLO watchtower: sample the time-series ring and evaluate
            # burn rates at most once per ring period
            slo_mod.tick()

    def _complete(self, req: Request, toks: np.ndarray):
        eos = self._cfg.eos_token_id
        req.n_emitted = int(toks.size)
        n_real = int(toks.size)
        if eos is not None:
            hits = np.nonzero(toks == eos)[0]
            if hits.size:
                n_real = int(hits[0]) + 1    # the eos itself counts
                toks = toks[:int(hits[0])]   # result is eos-trimmed
        req.tokens = toks.astype(np.int32)
        monitor.record_generation(tokens=n_real)
        req._finish(RequestStatus.COMPLETED)
        self.stats["completed"] += 1
        monitor.record_serve_request("completed")
        self._note_cost(req)

    def _cancel(self, req: Request, reason: str,
                label: Optional[str] = None):
        """Terminal CANCELLED for a request not occupying a slot.
        ``label`` overrides the metric label when ``reason`` carries
        free text (error messages must not become label cardinality)."""
        req._finish(RequestStatus.CANCELLED, reason)
        self.stats["cancelled"] += 1
        monitor.record_serve_request("cancelled")
        monitor.record_serve_cancellation(label or reason)

    def _evict(self, slot: int, req: Request, reason: str,
               n_done: int = 0):
        """Cancel an in-flight request: mask its lane and reset its cache
        row (the JAX package's free_fn), return its pages, keep what it
        produced."""
        if flight_recorder.enabled:
            flight_recorder.record("serve.evict", req=req.id, slot=slot,
                                   reason=reason, tokens=n_done)
        self._cache.reset_rows(slot)
        self._finished[slot] = True
        if n_done:
            row = self._out_buf[slot, :n_done].cpu().numpy()
            req.tokens = row.astype(np.int32)
            req.n_emitted = n_done
        self._slots[slot] = None
        self._free_slot_pages(slot)
        self._cancel(req, reason)
        self._note_cost(req)

    def _note_cost(self, req: Request):
        """Terminal cost attribution: the request's accumulated cost
        into the serve.cost.* histograms, and the top-K most expensive
        requests kept for ``cost_table``."""
        c = req.cost()
        monitor.record_request_cost(c["prefill_s"], c["decode_s"],
                                    c["page_s"])
        with self._qlock:
            heapq.heappush(self._cost_top, (c["total_s"], req.id, c))
            while len(self._cost_top) > self._cost_topk:
                heapq.heappop(self._cost_top)

    def cost_table(self) -> List[dict]:
        """The top-K most expensive terminal requests, costliest
        first."""
        with self._qlock:
            top = sorted(self._cost_top, reverse=True)
        return [dict(req=rid, **{k: round(v, 6) for k, v in c.items()})
                for _, rid, c in top]

    def goodput(self) -> Dict:
        """The serve-side goodput decomposition right now:
        ``{"wall_s", "buckets", "goodput_fraction"}``, the buckets
        summing to the wall time."""
        return self._goodput.snapshot()

    # ------------------------------------------------- page bookkeeping
    def _free_slot_pages(self, slot: int):
        """Return a terminal slot's page references to the allocator
        (pages other rows reference, or the prefix registry caches, stay
        resident: that is the sharing)."""
        if self._alloc is None:
            return
        pages, self._row_pages[slot] = self._row_pages[slot], None
        if pages:
            self._alloc.free_row(pages)

    def _release_pending(self, req: Request):
        """Roll back a committed page plan whose admission failed."""
        if self._alloc is None:
            return
        ent = self._pending_pages.pop(req.id, None)
        if ent is not None:
            self._alloc.free_row(ent[0])

    def _drain_page_stats(self):
        """The allocator's lifetime counters into the registry as
        deltas, and the pool's page occupancy (host ints only)."""
        if self._alloc is None:
            return
        stats = dict(self._alloc.stats)
        prev, self._page_seen = self._page_seen, stats
        delta = {k: stats[k] - prev.get(k, 0) for k in stats}
        monitor.record_paged_cache(
            allocated=delta["pages_allocated"],
            freed=delta["pages_freed"],
            prefix_hits=delta["prefix_hits"],
            shared_pages=delta["shared_pages"],
            cow_copies=delta["cow_copies"])
        monitor.record_page_occupancy(self._alloc.page_occupancy())

    def _drain_quant_stats(self):
        """The int8 cache's on-device saturation counter into
        ``gen.cache.quant.scale_clips``: one scalar read at the poll, as
        a modular delta (the int32 counter may wrap)."""
        if getattr(self._cache, "clips", None) is None:
            return
        clips = int(self._cache.clips)
        d = (clips - self._clips_seen) % (1 << 32)
        if d:
            self._clips_seen = clips
            monitor.record_kv_quant(scale_clips=d)

    # -------------------------------------------------------- front-end
    def _submit_item(self, item) -> Request:
        if isinstance(item, tuple) and len(item) == 2 and \
                isinstance(item[1], RequestParams):
            return self.submit(item[0], item[1])
        return self.submit(item)

    def serve_forever(self, request_iter: Optional[Iterable] = None, *,
                      shutdown=None, on_step=None,
                      idle_sleep_s: float = 0.0005) -> List[Request]:
        """Blocking serve loop. With ``request_iter`` it pulls prompts
        (or ``(prompt, RequestParams)`` tuples; the iterator must not
        block in ``__next__``) whenever the queue has room and returns
        the handles once the iterator is exhausted and every request is
        terminal. With ``request_iter=None`` it serves ``submit()``
        traffic from other threads until ``shutdown()`` or a preemption
        ends it.

        Preemption: when ``shutdown`` (a ``GracefulShutdown``, else the
        active one) reports preempted, or ``shutdown()`` was called, the
        loop drains: queued requests end REJECTED, in-flight slots decode
        up to ``drain_timeout_s`` and the rest are cancelled. A
        preemption records ``serve.preempted``, dumps the flight recorder
        first, and charges the drain's wall (less the compute recorded
        inside it) to goodput's ``preemption_recovery`` bucket.
        ``on_step(engine)`` runs once per loop iteration."""
        from ..distributed import resilience
        handles: List[Request] = []
        it = iter(request_iter) if request_iter is not None else None
        exhausted = False   # an iterator-less loop never finishes
        try:
            while True:
                gs = shutdown if shutdown is not None \
                    else resilience.active()
                if self._shutdown or (gs is not None and gs.preempted):
                    preempted_drain = gs is not None and \
                        gs.preempted and not self._shutdown
                    if preempted_drain:
                        # the black box first, while the in-flight
                        # requests' spans still show what was running
                        flight_recorder.record(
                            "serve.preempted",
                            in_flight=sum(s is not None
                                          for s in self._slots))
                        flight_recorder.auto_dump("preemption")
                    compute0 = self._goodput.bucket_total("compute")
                    t_drain = time.perf_counter()
                    self.drain()
                    if preempted_drain:
                        dc = self._goodput.bucket_total("compute") \
                            - compute0
                        self._goodput.charge(
                            "preemption_recovery",
                            max(time.perf_counter() - t_drain - dc, 0.0))
                    break
                while it is not None and not exhausted and \
                        self._queue_room():
                    try:
                        item = next(it)
                    except StopIteration:
                        exhausted = True
                        break
                    handles.append(self._submit_item(item))
                if on_step is not None:
                    on_step(self)
                if self.busy:
                    self.step()
                elif exhausted:
                    break
                else:
                    time.sleep(idle_sleep_s)
        except BaseException as e:
            # an uncaught scheduler or device error, or an operator's
            # Ctrl-C: dump, then propagate (SystemExit is a preemption
            # path that already dumped)
            if not isinstance(e, SystemExit):
                flight_recorder.record(
                    "serve.crash", error=f"{type(e).__name__}: {e}")
                flight_recorder.auto_dump("serve_crash")
            raise
        return handles

    def drain(self):
        """Graceful shutdown: reject everything still queued, abort a
        pending chunked prefill (its pages return), keep decoding the
        in-flight slots until each is terminal or ``drain_timeout_s``
        passes, take a final poll, then cancel the stragglers
        ``CANCELLED("shutdown")``. Every request ends terminal; none
        hang. Idempotent; the engine accepts no new work afterwards."""
        with self._pump_lock:
            with self._qlock:
                already = self._shutdown and not self._queue \
                    and all(s is None for s in self._slots)
                self._shutdown = True
                queued, self._queue = \
                    list(self._queue), collections.deque()
                if self._alloc is not None:
                    self._blocked_key = None
                    self._page_blocked = False
                monitor.record_serve_queue_depth(0)
            if flight_recorder.enabled and not already:
                flight_recorder.record(
                    "serve.drain_begin", queued=len(queued),
                    in_flight=sum(s is not None for s in self._slots))
            for req in queued:
                req._finish(RequestStatus.REJECTED, "shutdown")
                self.stats["rejected"] += 1
                monitor.record_serve_request("rejected")
            # a PENDING_PREFILL slot never decodes to terminal: abort it
            # now, or the drain below would spin on it until the timeout
            self._abort_chunked("shutdown")
            deadline = time.monotonic() + self.drain_timeout_s
            while any(s is not None for s in self._slots) and \
                    time.monotonic() < deadline:
                self._dispatch_decode()
                if self._steps_since_poll >= self.poll_every:
                    self._poll()
            if any(s is not None for s in self._slots):
                # rows that finished since the last cadence poll must
                # complete, not be called stragglers
                self._poll()
            steps = self._steps.cpu().numpy()
            for i, req in enumerate(self._slots):
                if req is not None:
                    self._evict(i, req, "shutdown", int(steps[i]))
            monitor.record_serve_slot_occupancy(0.0)
            if monitor.enabled:
                self._drain_page_stats()
                self._drain_quant_stats()
                self._goodput.flush()
            if flight_recorder.enabled and not already:
                flight_recorder.record("serve.drain_end")

    shutdown_now = drain

    # ----------------------------------------------------- thread mode
    def start(self) -> "ServingEngine":
        """Background pump thread: ``submit()``/``result()`` from any
        thread, ``shutdown()`` to drain and stop."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._thread = threading.Thread(
            target=self._run_loop, daemon=True, name="serving-engine")
        self._thread.start()
        return self

    def _run_loop(self):
        while not self._shutdown:
            if self.busy:
                with self._pump_lock:
                    if not self._shutdown:
                        self.step()
            else:
                time.sleep(0.001)

    def shutdown(self):
        """Drain (every request terminal), stop the pump thread, free
        the caches, close the goodput ledger and release the telemetry
        port. ``drain()``
        alone keeps the server up (a scrape after the drain is how a
        fleet sees the exit); ``shutdown()`` frees the port so an engine
        relaunched on the same fixed port can bind it."""
        self.drain()
        if self._thread is not None:
            self._thread.join(timeout=self.drain_timeout_s + 5.0)
            self._thread = None
        # the caches go with the engine: handles keep the engine itself
        # referenced, and a replica relaunched in its place must not
        # hold two of them
        self._cache = self._row_cache = None
        self._goodput.close()
        if self.telemetry is not None:
            self.telemetry.stop()
            self.telemetry = None

    def _queue_room(self) -> bool:
        with self._qlock:
            return len(self._queue) < self.max_queue

    def _try_pump(self) -> bool:
        """Inline pump for ``handle.result()`` when no thread owns the
        engine; True when it made progress."""
        if self._thread is not None and self._thread.is_alive():
            return False
        if not self._pump_lock.acquire(blocking=False):
            return False
        try:
            if self.busy and not self._shutdown:
                self.step()
                return True
            return False
        finally:
            self._pump_lock.release()

    # ----------------------------------------------------------- health
    def health(self) -> Dict:
        """Readiness document for ``/readyz`` and the fleet router:
        ready iff warm, not draining and the queue below its bound,
        always with the capacity detail that explains a 503 — queue
        depth and what its head waits on (``pages``: pool memory;
        ``slots``: every decode lane busy), slot occupancy, the cache
        capacity and headroom in tokens (slots x max_len dense, pool
        pages x page size paged), the chunked-prefill backlog, and on a
        paged cache the pool's pages."""
        with self._qlock:
            depth = len(self._queue)
        busy = sum(s is not None for s in self._slots)
        paged = self._alloc is not None
        blocked_on = None
        if depth:
            if paged and self._page_blocked:
                blocked_on = "pages"
            elif busy >= self.max_batch:
                blocked_on = "slots"
        reasons = []
        if self._shutdown:
            reasons.append("draining")
        if not self._warm:
            reasons.append("warming")
        if depth >= self.max_queue:
            reasons.append("queue_full" if blocked_on is None
                           else f"queue_full:no_free_{blocked_on}")
        if paged:
            cap_tokens = (self._alloc.n_pages - 1) * self.page_size
            free_tokens = self._alloc.free_pages() * self.page_size
        else:
            cap_tokens = self.max_batch * self.max_len
            free_tokens = (self.max_batch - busy) * self.max_len
        pp_tokens = pp_chunks = 0
        st = self._chunking
        if st is not None:
            pp_tokens = max(
                0, st["plen"] - st["next"] * self.prefill_chunk_tokens)
            pp_chunks = st["n"] - st["next"]
        return {
            "ready": not reasons,
            **({"reason": ",".join(reasons)} if reasons else {}),
            "queue_depth": depth, "max_queue": self.max_queue,
            "queue_blocked_on": blocked_on,
            "slots_busy": busy, "max_batch": self.max_batch,
            "free_slots": self.max_batch - busy,
            "kv_cache_dtype": self._kv_dtype_label,
            "capacity_tokens": cap_tokens,
            "free_tokens": free_tokens,
            "pending_prefill_tokens": pp_tokens,
            "prefill_chunks_queued": pp_chunks,
            **({"free_pages": self._alloc.free_pages(),
                "total_pages": self._alloc.n_pages - 1,
                "page_occupancy": round(
                    self._alloc.page_occupancy(), 4)} if paged else {}),
            "warm": self._warm, "draining": self._shutdown,
        }

    def __repr__(self):
        occ = sum(s is not None for s in self._slots)
        with self._qlock:
            q = len(self._queue)
        paged = "" if self._alloc is None else \
            (f", pages={self._alloc.used_pages()}"
             f"/{self._alloc.n_pages - 1}x{self.page_size}")
        chunk = "" if self.prefill_chunk_tokens is None else \
            f", prefill_chunk_tokens={self.prefill_chunk_tokens}"
        spec = "" if self._spec is None else \
            f", speculative=ngram(k={self._spec.k}, n={self._spec.ngram})"
        return (f"ServingEngine(slots={occ}/{self.max_batch}, "
                f"queued={q}, buckets={self.buckets}, "
                f"max_len={self.max_len}{paged}{chunk}{spec}, "
                f"device={self.device}, warm={self._warm}, "
                f"shutdown={self._shutdown})")
