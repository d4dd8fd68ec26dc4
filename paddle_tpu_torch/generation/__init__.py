"""Autoregressive generation: dense ring and paged KV caches (with the
host-side page allocator), cached attention through the decode, chunk
and paged decode kernels, sampling, speculative decoding, and the
(prefill, decode) pair behind ``generate()`` and the serving engine."""
from .api import GenerationConfig, GenerationSession, generate  # noqa: F401
from .kv_cache import KVCache  # noqa: F401
from .paged_cache import (AdmissionPlan, PageAllocator,  # noqa: F401
                          PagedKVCache)
from .sampling import (apply_temperature, apply_top_k,  # noqa: F401
                       apply_top_p, sample)
from .speculative import (SpeculativeConfig,  # noqa: F401
                          SpeculativeSession, ngram_propose, spec_accept)

__all__ = ["GenerationConfig", "GenerationSession", "generate", "KVCache",
           "PagedKVCache", "PageAllocator", "AdmissionPlan", "sample",
           "apply_temperature", "apply_top_k", "apply_top_p",
           "SpeculativeConfig", "SpeculativeSession", "ngram_propose",
           "spec_accept"]
