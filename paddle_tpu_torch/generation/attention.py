"""Shared cached-attention step for model wiring.

Write the fresh k/v into the cache at each row's ``kv_len``, then either
attend the cached prefix (decode) or run self-attention over the fresh
window through the forward kernel (prefill). A decode window goes to
the paged decode kernel on a paged cache; on a dense cache to the chunk
kernel when it is longer than ``MAX_DECODE_QLEN`` (a chunked-prefill
step), else to the decode kernel. On an int8 cache (``QuantKVCache``,
``QuantPagedKVCache``) the write quantizes, and the layer's scale slices
ride into the same three kernels, which dequantize inside the tile.
Prefill attends the fresh wide k/v, so the prompt's own attention never
sees the quantization, as in the JAX package. A head_dim the kernels are
not built for (``KERNEL_HEAD_DIMS``) takes the JAX package's XLA routes
instead, on every device: ``decode_xla`` for every decode-shaped window
(paged pools gathered first), ``sdpa_xla`` (through
``F.scaled_dot_product_attention``) for prefill.
"""
from __future__ import annotations

from ..kernels.flash_attention import (KERNEL_HEAD_DIMS, MAX_DECODE_QLEN,
                                       decode_xla, flash_attention_chunk,
                                       flash_attention_decode,
                                       flash_attention_decode_paged)
from ..nn import functional as F


def cached_attention(q, k, v, cache, layer_idx, *, decode: bool,
                     causal: bool, attn_mask=None):
    """Write ``k``/``v`` ([b, s, heads, head_dim]) into ``cache`` at
    layer ``layer_idx`` and attend. Returns (out, cache); ``out`` is
    [b, s, heads, head_dim]. Decode reads the cached prefix with
    per-row ragged masking at ``kv_len + s``; prefill is ordinary
    self-attention over the fresh window."""
    cache.update(layer_idx, k, v, cache.kv_len)
    if not decode:
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, is_causal=causal, training=False)
        return out, cache
    mask_len = cache.kv_len + q.shape[1]    # includes the new rows
    scales = {} if getattr(cache, "k_scale", None) is None else dict(
        k_scale=cache.k_scale[layer_idx], v_scale=cache.v_scale[layer_idx])
    page_table = getattr(cache, "page_table", None)
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        out = decode_xla(q, cache.k[layer_idx], cache.v[layer_idx], mask_len,
                         page_table=page_table, **scales)
    elif page_table is not None:
        out = flash_attention_decode_paged(q, cache.k[layer_idx],
                                           cache.v[layer_idx],
                                           cache.page_table, mask_len,
                                           **scales)
    elif q.shape[1] > MAX_DECODE_QLEN:
        out = flash_attention_chunk(q, cache.k[layer_idx],
                                    cache.v[layer_idx], mask_len, **scales)
    else:
        out = flash_attention_decode(q, cache.k[layer_idx],
                                     cache.v[layer_idx], mask_len, **scales)
    return out, cache
