"""Scaled dot-product attention over ``[batch, seq, heads, head_dim]``.

Every call goes to ``kernels.flash_attention``: the hand-written
forward kernel on a CUDA card, its plain version on the CPU. In
training (an input requires a gradient) the call is differentiable and
its backward is the hand-written backward kernel on a card. The JAX
package gates its TPU kernel on ``seq >= 512`` and ``head_dim in (64,
128, 256)``; that gate was measured on a TPU and is not carried over —
the CUDA kernels take any length and mask the ragged tail themselves.
"""
from __future__ import annotations

from typing import Optional

from ...kernels.flash_attention import flash_attention


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True,
                                 scale: Optional[float] = None):
    """query/key/value: [batch, seq, heads, head_dim]. Explicit masks
    and attention dropout, which the JAX package sends to its XLA path
    (``_sdpa_xla``), are not ported yet and raise."""
    if attn_mask is not None:
        raise NotImplementedError(
            "attention with an explicit mask is not ported yet (ROADMAP "
            "A10, B2)")
    if training and dropout_p > 0.0:
        raise NotImplementedError(
            "attention dropout is not ported yet (ROADMAP A4)")
    return flash_attention(query, key, value, causal=is_causal, scale=scale)
