"""AnalysisConfig analog: the model to serve, its device and precision,
and the generation and serving knobs the ``Predictor`` and the
``ServingEngine`` read (the JAX package's ``inference/config.py``).

Options of the JAX package that belong to paths not ported yet (the
persistent compile cache, the memory planner) are accepted by name and
raise when set, naming the ROADMAP entry. Options that tuned the
reference's IR passes and math library are recorded, as in the JAX
package.
"""
from __future__ import annotations

import os
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
    def __init__(self, prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        """``prog_file`` names a saved artifact's path prefix (the JAX
        package's ``.pdmodel`` / ``.stablehlo``; the Predictor refuses
        them, see ``set_model``)."""
        self._model_prefix: Optional[str] = None
        self._layer = None
        self._input_spec = None
        self.precision: str = PrecisionType.Float32
        #: 'gpu' (the first card) unless disable_gpu() asks for the CPU
        self.device: str = "gpu"
        self._memory_optim = True
        self._ir_optim = True
        self._int8_compute = False
        self._math_threads = 1
        self._generation: Optional[dict] = None
        self._serving: Optional[dict] = None
        if prog_file is not None:
            self.set_model(prog_file, params_file)

    # ---------------------------------------------------------- model src
    def set_model(self, prefix: str, params_file: Optional[str] = None):
        """Point at a saved artifact by its path prefix. The artifacts
        (``prefix.pdmodel``, ``prefix.stablehlo``) are the JAX package's
        formats: ``create_predictor`` raises FileNotFoundError when
        neither exists, and NotImplementedError naming ROADMAP A9 when
        one does."""
        self._model_prefix = prefix
        return self

    def from_layer(self, layer, input_spec=None):
        """Serve a live module. ``input_spec`` lists example inputs (one
        per positional input of ``run()``); without it ``run()`` takes
        one input."""
        self._layer = layer
        self._input_spec = input_spec
        return self

    def model_dir(self) -> Optional[str]:
        return os.path.dirname(self._model_prefix) \
            if self._model_prefix else None

    def enable_use_gpu(self, precision: str = PrecisionType.Bfloat16,
                       device_id: int = 0):
        """Serve on CUDA card ``device_id`` in ``precision`` (the JAX
        package's ``enable_tpu``). ``PrecisionType.Int8`` serves int8
        weights (``enable_serving(weight_bits=4)``: packed int4 Linear
        weights), or with ``enable_int8_compute()`` int8 x int8 -> int32
        products (``inference.precision``)."""
        if precision not in (PrecisionType.Float32, PrecisionType.Half,
                             PrecisionType.Bfloat16, PrecisionType.Int8):
            raise ValueError(f"unknown precision {precision!r}")
        self.device = f"gpu:{int(device_id)}"
        self.precision = precision
        return self

    def disable_gpu(self):
        """Serve on the CPU (tests)."""
        self.device = "cpu"
        return self

    def enable_int8_compute(self, flag: bool = True):
        """With precision Int8, run Linear and Conv2D products as int8 x
        int8 -> int32 (``quantization.int8_compute``) instead of
        weight-only dequantization. Activations quantize with the PTQ
        scales when the served layer came from ``PTQ.convert()``,
        dynamically otherwise."""
        self._int8_compute = flag
        return self

    def enable_memory_optim(self, flag: bool = True):
        self._memory_optim = flag  # the caching allocator plans; recorded
        return self

    def switch_ir_optim(self, flag: bool = True):
        self._ir_optim = flag      # no IR pass pipeline; recorded
        return self

    def set_cpu_math_library_num_threads(self, n: int):
        self._math_threads = n     # recorded, as in the JAX package
        return self

    def set_compile_cache_dir(self, path: str):
        """The JAX package's persistent compile cache and executable
        store; not ported yet (ROADMAP A9). The port builds each kernel
        library once a process."""
        if path:
            raise NotImplementedError(
                "set_compile_cache_dir is not ported yet (ROADMAP A9: "
                "jit/compile_cache.py)")
        return self

    enable_compile_cache = set_compile_cache_dir

    def summary(self) -> str:
        return (f"Config(model={self._model_prefix or self._layer}, "
                f"device={self.device}, precision={self.precision}, "
                f"memory_optim={self._memory_optim})")

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
                       telemetry_port=None, weight_bits=None, **later):
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
        ephemeral port; default ``PADDLE_TELEMETRY_PORT``).

        ``weight_bits=4`` packs the served Linear weights two int4
        values per byte with per-channel scales, ``8`` (the default of
        precision Int8) stores them int8; both apply under precision
        Int8 weight-only serving."""
        _refuse_later("enable_serving", later, _LATER_SERVING)
        validate_cache_dtype(kv_cache_dtype)
        if weight_bits not in (None, 4, 8):
            raise ValueError(
                f"weight_bits {weight_bits!r}: 4 (packed int4 "
                "weight-only), 8 (int8 weight-only), or None")
        self._serving = dict(
            max_queue=int(max_queue), poll_every=int(poll_every),
            drain_timeout_s=float(drain_timeout_s),
            default_deadline_s=default_deadline_s,
            cache_max_len=cache_max_len, paged=bool(paged),
            kv_page_size=kv_page_size, kv_pages=kv_pages,
            prefill_chunk_tokens=prefill_chunk_tokens,
            kv_cache_dtype=kv_cache_dtype, trace_sample=trace_sample,
            telemetry_port=telemetry_port, weight_bits=weight_bits)
        return self
