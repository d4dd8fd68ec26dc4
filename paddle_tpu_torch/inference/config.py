"""AnalysisConfig analog: the model to serve, its device and precision,
and the generation and serving knobs the ``ServingEngine`` reads (the
JAX package's ``inference/config.py``: the dense, paged and chunked
serving paths, and speculative decoding).

Options of the JAX package that belong to paths not ported yet (int8
and int4 weights, the memory planner) are accepted by name and raise
when set, naming the ROADMAP entry.
"""
from __future__ import annotations

from typing import Optional

from ..generation.kv_cache import validate_cache_dtype
from ..generation.speculative import as_spec_config


class PrecisionType:
    Float32 = "float32"
    Half = "float16"
    Bfloat16 = "bfloat16"
    Int8 = "int8"


#: option name -> the ROADMAP entry that ports it
_LATER_SERVING = {
    "weight_bits": "A8 (int8/int4 weight paths)",
    "hbm_budget": "A12 (memory planner)",
}


def _refuse_later(kind: str, later: dict, table: dict):
    for name, value in later.items():
        if name not in table:
            raise TypeError(f"{kind}() got an unexpected keyword "
                            f"argument {name!r}")
        if value not in (None, False):
            raise NotImplementedError(
                f"{kind}({name}=...) is not ported yet (ROADMAP "
                f"{table[name]})")


class Config:
    def __init__(self):
        self._layer = None
        self._input_spec = None
        self.precision: str = PrecisionType.Float32
        #: 'gpu' (the first card) unless disable_gpu() asks for the CPU
        self.device: str = "gpu"
        self._generation: Optional[dict] = None
        self._serving: Optional[dict] = None

    def from_layer(self, layer, input_spec=None):
        """Serve a live module."""
        self._layer = layer
        self._input_spec = input_spec
        return self

    def enable_use_gpu(self, precision: str = PrecisionType.Bfloat16,
                       device_id: int = 0):
        """Serve on CUDA card ``device_id`` in ``precision`` (the JAX
        package's ``enable_tpu``)."""
        if precision == PrecisionType.Int8:
            raise NotImplementedError(
                "int8 serving precision is not ported yet (ROADMAP A8)")
        if precision not in (PrecisionType.Float32, PrecisionType.Half,
                             PrecisionType.Bfloat16):
            raise ValueError(f"unknown precision {precision!r}")
        self.device = f"gpu:{int(device_id)}"
        self.precision = precision
        return self

    def disable_gpu(self):
        """Serve on the CPU (tests)."""
        self.device = "cpu"
        return self

    def enable_generation(self, max_new_tokens: int = 64,
                          prefill_buckets=(64, 128, 256, 512),
                          max_batch: int = 1, do_sample: bool = False,
                          temperature: float = 1.0, top_k: int = 0,
                          top_p: float = 1.0, eos_token_id=None,
                          pad_token_id=None, speculative=None,
                          draft_model=None, kv_cache_dtype=None):
        """Generation knobs: the token budget, the prompt-length buckets
        prompts are right-padded to, the fixed decode batch, and the
        sampling configuration.

        ``speculative`` turns on speculative decoding for the serving
        engine built from this config: ``"ngram"`` (model-free prompt
        lookup), ``"draft"`` with ``draft_model=`` a small live LM
        sharing the vocabulary (``generate()`` only; the engine refuses
        it, as the JAX package's does), or a
        ``generation.SpeculativeConfig`` for draft-k and n-gram. Greedy
        output stays the non-speculative output.

        ``kv_cache_dtype="int8"`` (or
        ``PADDLE_KV_CACHE_DTYPE``) quantizes the KV cache of every
        serving surface built from this config: int8 values with
        per-(position, head) bf16 scales, dequantized inside the decode
        kernels (half the cache bytes streamed per token)."""
        as_spec_config(speculative, draft_model)  # eagerly, as JAX does
        validate_cache_dtype(kv_cache_dtype)
        self._generation = dict(
            max_new_tokens=int(max_new_tokens),
            prefill_buckets=tuple(sorted(int(b) for b in prefill_buckets)),
            max_batch=int(max_batch), do_sample=bool(do_sample),
            temperature=float(temperature), top_k=int(top_k),
            top_p=float(top_p), eos_token_id=eos_token_id,
            pad_token_id=pad_token_id, speculative=speculative,
            draft_model=draft_model, kv_cache_dtype=kv_cache_dtype)
        return self

    def enable_serving(self, max_queue: int = 64, poll_every: int = 4,
                       drain_timeout_s: float = 30.0,
                       default_deadline_s=None, cache_max_len=None,
                       paged: bool = False, kv_page_size=None,
                       kv_pages=None, prefill_chunk_tokens=None,
                       kv_cache_dtype=None, trace_sample=None,
                       telemetry_port=None, **later):
        """Continuous-batching knobs for ``serving.ServingEngine``:
        ``max_queue`` bounds admission (submit past it raises
        QueueFull), ``poll_every`` sets the completion-poll cadence in
        decode steps, ``drain_timeout_s`` bounds how long a graceful
        drain keeps decoding in-flight requests before it cancels them,
        ``default_deadline_s`` applies to requests that
        carry none, ``cache_max_len`` overrides the shared KV ring
        length (default: largest bucket + max_new_tokens, rounded up to
        128).

        ``paged=True`` swaps the dense per-slot cache for the paged one
        (``generation.PagedKVCache``): K/V live in a pool of
        ``kv_pages`` pages of ``kv_page_size`` positions (default 128,
        which must divide the cache length; default pool: the dense
        cache's footprint plus the null page), admission waits for free
        pages as well as free slots, and identical prompt prefixes share
        pages. ``prefill_chunk_tokens`` admits prompts longer than that
        many tokens one chunk per scheduler iteration, between decode
        steps (on a paged engine a multiple of the page size).
        ``kv_cache_dtype="int8"`` quantizes the engine's cache, dense or
        paged (it wins over the ``enable_generation`` value).
        ``trace_sample`` traces 1-in-N requests end to end into the
        flight recorder (default 8, or ``PADDLE_TRACE_SAMPLE``; 0 =
        off), and ``telemetry_port`` starts the engine's telemetry
        server (``/metrics``, ``/healthz``, ``/readyz``; 0 binds an
        ephemeral port; default ``PADDLE_TELEMETRY_PORT``)."""
        _refuse_later("enable_serving", later, _LATER_SERVING)
        validate_cache_dtype(kv_cache_dtype)
        self._serving = dict(
            max_queue=int(max_queue), poll_every=int(poll_every),
            drain_timeout_s=float(drain_timeout_s),
            default_deadline_s=default_deadline_s,
            cache_max_len=cache_max_len, paged=bool(paged),
            kv_page_size=kv_page_size, kv_pages=kv_pages,
            prefill_chunk_tokens=prefill_chunk_tokens,
            kv_cache_dtype=kv_cache_dtype, trace_sample=trace_sample,
            telemetry_port=telemetry_port)
        return self
