"""Dense ring KV cache for incremental decoding.

One object holds every layer's cached keys and values:

    k, v:   [num_layers, batch, max_len, num_heads, head_dim]
    kv_len: [batch] int32 — valid entries per row (ragged batches)

The JAX package's ``KVCache`` is an immutable pytree that XLA updates
in place through buffer donation. Here the tensors are updated IN
PLACE: ``update`` writes the new rows into the layer's slice,
``with_kv_len``/``reset_rows``/``copy_row_from`` overwrite lengths and
rows, and each returns the same cache object so call sites read the
same as the functional original. The decode kernel then reads a
layer's slice ``k[layer]`` through its strides, without a copy.

Write positions wrap modulo ``max_len`` (ring semantics), as in the JAX
package: ``generate()`` and the serving engine validate lengths up
front so a live cache never wraps.

Quantized mode (``cache_dtype="int8"``): decode is bound by streaming
the cache, so :class:`QuantKVCache` stores K/V as int8 with one bf16
scale per (position, head) in the side arrays ``k_scale``/``v_scale``
([layers, batch, max_len, heads]): half the bytes per decode step, and
twice the rows a fixed memory budget holds. ``update`` quantizes at
write time (absmax over head_dim per appended token), and the decode
kernels dequantize inside the tile, so a wide cache never exists. A
0-d int32 ``clips`` counter on the cache's device counts values that
saturated the int8 range (structurally 0 for absmax scales); it is
never read back on the step path.
"""
from __future__ import annotations

import os

import torch

#: cache dtypes ``KVCache.create(cache_dtype=)`` accepts (None = the
#: activation dtype, the full-width mode)
CACHE_DTYPES = (None, "int8")


def validate_cache_dtype(value):
    """Reject anything outside CACHE_DTYPES with the one shared error
    (config knobs, cache constructors and the resolver all call this)."""
    if value not in CACHE_DTYPES:
        raise ValueError(
            f"kv_cache_dtype {value!r}: one of "
            f"{[d for d in CACHE_DTYPES if d]} or None (full width)")
    return value


def resolve_cache_dtype(explicit=None):
    """The effective KV-cache dtype: an explicit value wins (and is
    validated: a typo'd config raises, never silently serves wide),
    else ``PADDLE_KV_CACHE_DTYPE``; garbage in the environment is
    recorded through ``record_swallowed`` and falls back to full width
    (the same contract as ``PADDLE_KV_PAGE_SIZE``)."""
    if explicit is not None:
        return validate_cache_dtype(explicit)
    env = os.environ.get("PADDLE_KV_CACHE_DTYPE", "").strip().lower()
    if not env or env in ("auto", "none", "off", "wide", "float"):
        return None
    if env in CACHE_DTYPES:
        return env
    from ..core import monitor
    monitor.record_swallowed(
        "generation.kv_cache_dtype",
        ValueError(f"PADDLE_KV_CACHE_DTYPE={env!r}"))
    return None


def quantize_kv(x):
    """Quantize fresh K or V values ``[..., heads, head_dim]`` to int8
    with one bfloat16 scale per (..., head): ``scale = max(absmax,
    1e-6) / 127`` rounded to bf16, ``q = round(x / scale)`` (half to
    even) clamped to +-127. Returns ``(q int8, scale bf16, clips)``,
    ``clips`` a 0-d int32 count of values past +-127 BEFORE the clamp:
    structurally 0 under round-to-nearest absmax scales (the worst-case
    ratio is 127 * (1 + 2^-9) < 127.5)."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)                       # [..., heads]
    scale = (absmax.clamp_min(1e-6) / 127.0).to(torch.bfloat16)
    q = torch.round(xf / scale.float()[..., None])
    clips = (q.abs() > 127.0).sum(dtype=torch.int32)
    q = q.clamp(-127.0, 127.0).to(torch.int8)
    return q, scale, clips


class KVCache:
    """Per-layer K/V ring cache with per-row valid lengths."""

    __slots__ = ("k", "v", "kv_len")

    def __init__(self, k, v, kv_len):
        self.k = k
        self.v = v
        self.kv_len = kv_len

    # ------------------------------------------------------------- shape
    @property
    def num_layers(self) -> int:
        return self.k.shape[0]

    @property
    def batch(self) -> int:
        return self.k.shape[1]

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @property
    def cache_dtype(self):
        """The low-bit storage mode (None = full width)."""
        return None

    # ---------------------------------------------------------- creation
    @classmethod
    def create(cls, num_layers: int, batch: int, max_len: int,
               num_heads: int, head_dim: int, dtype=torch.float32,
               device=None, cache_dtype=None) -> "KVCache":
        """A zeroed cache; ``cache_dtype="int8"`` gives a
        :class:`QuantKVCache` (``dtype`` is then only the activations')."""
        shape = (num_layers, batch, max_len, num_heads, head_dim)
        kv_len = torch.zeros((batch,), dtype=torch.int32, device=device)
        if validate_cache_dtype(cache_dtype) is not None:
            sshape = shape[:-1]
            return QuantKVCache(
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(shape, dtype=torch.int8, device=device), kv_len,
                torch.zeros(sshape, dtype=torch.bfloat16, device=device),
                torch.zeros(sshape, dtype=torch.bfloat16, device=device),
                torch.zeros((), dtype=torch.int32, device=device))
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), kv_len)

    # ------------------------------------------------------------ update
    def _ring_index(self, b: int, s: int, pos):
        """(rows, positions) [b, s] of ``s`` writes per row starting at
        ``pos``, modulo max_len."""
        pos = torch.as_tensor(pos, device=self.k.device)
        if pos.dim() == 0:
            pos = pos.expand(b)
        steps = torch.arange(s, device=self.k.device)
        idx = (pos.long()[:, None] + steps[None, :]) % self.max_len
        rows = torch.arange(b, device=self.k.device)[:, None].expand(b, s)
        return rows, idx

    def update(self, layer: int, k_new, v_new, pos) -> "KVCache":
        """Write ``k_new``/``v_new`` ([batch, s, heads, head_dim]) into
        ``layer`` in place, at positions ``(pos + arange(s)) % max_len``
        per row (``pos``: [batch] int tensor or an int). Does NOT
        advance ``kv_len``: every layer of one forward writes at the
        same positions; the model advances the length once through
        ``with_kv_len``."""
        rows, idx = self._ring_index(k_new.shape[0], k_new.shape[1], pos)
        self.k[layer][rows, idx] = k_new.to(self.k.dtype)
        self.v[layer][rows, idx] = v_new.to(self.v.dtype)
        return self

    def positions(self, s: int):
        """Absolute positions of ``s`` appended tokens per row ([batch,
        s]: ``kv_len[r] .. kv_len[r]+s-1``) — the decode position
        offsets."""
        return self.kv_len.long()[:, None] + \
            torch.arange(s, device=self.k.device)[None, :]

    # -------------------------------------------------------- slot reuse
    def reset_rows(self, rows) -> "KVCache":
        """Free batch rows for reuse: zero ``kv_len`` at ``rows`` (a row
        index or a list of them) without touching K/V. Stale K/V past a
        row's kv_len is invisible (attention masks by kv_len) and the
        next prefill overwrites it."""
        self.kv_len[rows] = 0
        return self

    def copy_row_from(self, src: "KVCache", src_row: int,
                      dst_row: int) -> "KVCache":
        """Slot admission: overwrite row ``dst_row`` of this cache with
        row ``src_row`` of ``src`` — K, V and kv_len — leaving every
        other row untouched. ``src`` must share layers, max_len, heads
        and head_dim (typically a batch-1 prefill cache being installed
        into a freed slot of the shared decode cache)."""
        self.k[:, dst_row].copy_(src.k[:, src_row])
        self.v[:, dst_row].copy_(src.v[:, src_row])
        self.kv_len[dst_row] = src.kv_len[src_row]
        return self

    def with_kv_len(self, kv_len) -> "KVCache":
        """Set every row's valid length (an int or a [batch] tensor),
        in place."""
        kv_len = torch.as_tensor(kv_len, device=self.k.device)
        self.kv_len.copy_(kv_len.to(torch.int32).expand(self.batch))
        return self

    def occupancy(self) -> float:
        """Host-side fraction of the cache in use (max over rows): the
        gen.cache_occupancy gauge. Reads kv_len ([batch] int32) on the
        host, so callers read it only at a poll."""
        return float(int(self.kv_len.max())) / self.max_len

    def __repr__(self):
        return (f"KVCache(layers={self.num_layers}, batch={self.batch}, "
                f"max_len={self.max_len}, dtype={self.k.dtype})")


class QuantKVCache(KVCache):
    """Int8 ring cache: K/V int8 with per-(position, head) bf16 scales in
    ``k_scale``/``v_scale`` ([layers, batch, max_len, heads]) and the 0-d
    int32 ``clips`` saturation counter. Same protocol as
    :class:`KVCache`, in place: ``update`` quantizes at write time, and
    the decode kernels take a layer's scale slices beside its values.
    Scales are per written position, so an append never requantizes
    earlier entries, and a row copy moves values and scales verbatim:
    an installed row decodes bitwise equal to its batch-1 prefill."""

    __slots__ = ("k_scale", "v_scale", "clips")

    def __init__(self, k, v, kv_len, k_scale, v_scale, clips):
        super().__init__(k, v, kv_len)
        self.k_scale = k_scale
        self.v_scale = v_scale
        self.clips = clips

    @property
    def cache_dtype(self):
        return "int8"

    def update(self, layer: int, k_new, v_new, pos) -> "QuantKVCache":
        """Quantize the fresh k/v (absmax per appended token x head) and
        ring-write int8 values and bf16 scales at ``pos``; saturated
        values add to ``clips``. Same contract as the wide cache."""
        rows, idx = self._ring_index(k_new.shape[0], k_new.shape[1], pos)
        kq, ks, kc = quantize_kv(k_new)
        vq, vs, vc = quantize_kv(v_new)
        self.k[layer][rows, idx] = kq
        self.v[layer][rows, idx] = vq
        self.k_scale[layer][rows, idx] = ks
        self.v_scale[layer][rows, idx] = vs
        self.clips += kc + vc
        return self

    def copy_row_from(self, src: "QuantKVCache", src_row: int,
                      dst_row: int) -> "QuantKVCache":
        """Slot admission: int8 values AND their scales copy verbatim (no
        requantization); ``src.clips`` (the prefill's count) folds into
        this cache's counter."""
        super().copy_row_from(src, src_row, dst_row)
        self.k_scale[:, dst_row].copy_(src.k_scale[:, src_row])
        self.v_scale[:, dst_row].copy_(src.v_scale[:, src_row])
        self.clips += src.clips
        return self

    def __repr__(self):
        return (f"QuantKVCache(layers={self.num_layers}, "
                f"batch={self.batch}, max_len={self.max_len}, "
                f"dtype=int8+bf16-scales)")
