"""Scaled dot-product attention over ``[batch, seq, heads, head_dim]``.

A head_dim the CUDA kernels are built for (``KERNEL_HEAD_DIMS``) goes to
``kernels.flash_attention``: the hand-written forward kernel on a CUDA
card, its plain version on the CPU. In training (an input requires a
gradient) the call is differentiable and its backward is the
hand-written backward kernel on a card. Any other head_dim, and an
explicit mask, go to ``sdpa_xla``, the JAX package's XLA path
(``_sdpa_xla``) in plain PyTorch, on every device; autograd
differentiates it, as ``jax.grad`` does the reference's. The JAX package
also gates its TPU kernel on ``seq >= 512``; that gate was measured on a
TPU and is not carried over — the CUDA kernels take any length and mask
the ragged tail themselves.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ... import amp
from ...core import random as random_mod
from ...kernels.flash_attention import KERNEL_HEAD_DIMS, flash_attention
from ..layers_common import in_train_step


def _sdpa_xla(query, key, value, attn_mask=None, is_causal: bool = False,
              scale: Optional[float] = None, dropout_p: float = 0.0,
              keep=None):
    """``sdpa_xla`` with attention dropout from a given boolean ``keep``
    mask over the probabilities [batch, heads, sq, sk] (the JAX
    package's ``jax.random.bernoulli(rng, 1 - p, probs.shape)``), used
    when ``dropout_p > 0``."""
    b, sq, hq, d = query.shape
    sk, hk = key.shape[1], key.shape[2]
    g = hq // hk
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    qf = query.float().reshape(b, sq, hk, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, key.float()) * scale
    logits = logits.reshape(b, hq, sq, sk)
    if is_causal:
        rows = torch.arange(sq, device=query.device)[:, None]
        cols = torch.arange(sk, device=query.device)[None, :]
        logits = logits.masked_fill(cols > rows + (sk - sq), float("-inf"))
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = logits.masked_fill(~attn_mask, float("-inf"))
        else:
            logits = logits + attn_mask
    probs = torch.softmax(logits, dim=-1).to(query.dtype)
    if dropout_p > 0.0:
        # the divisor in the query's dtype, as JAX's weak-typed scalar
        kept = probs / torch.tensor(1.0 - dropout_p, dtype=probs.dtype,
                                    device=probs.device)
        probs = torch.where(keep, kept, torch.zeros_like(probs))
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.reshape(b, hk, g, sq, sk),
                       value.to(query.dtype))
    return out.reshape(b, sq, hq, d)


def sdpa_xla(query, key, value, attn_mask=None, is_causal: bool = False,
             scale: Optional[float] = None, dropout_p: float = 0.0):
    """The JAX package's ``_sdpa_xla``: fp32 logits of the inputs'
    products, times ``scale``; causal masking aligned bottom-right
    (column c visible to row r iff c <= r + sk - sq); a boolean
    ``attn_mask`` keeps the True positions, any other is added to the
    logits (either broadcast against [batch, heads, sq, sk]); an fp32
    softmax rounded to the query's dtype, then dropout when
    ``dropout_p > 0`` (its keep mask drawn from the device's default
    generator), times V in that dtype. A row with nothing visible gives
    NaN, as the reference's does. Grouped-query heads map query head h
    to kv head h // (hq // hk), as the kernels do (the reference's
    einsum takes equal head counts). Counts its calls in
    ``sdpa_xla.calls``."""
    sdpa_xla.calls += 1
    keep = None
    if dropout_p > 0.0:
        b, sq, hq, _ = query.shape
        keep = torch.rand((b, hq, sq, key.shape[1]), device=query.device,
                          generator=random_mod.generator(query.device)) \
            < 1.0 - dropout_p
    return _sdpa_xla(query, key, value, attn_mask, is_causal, scale,
                     dropout_p, keep)


sdpa_xla.calls = 0


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True,
                                 scale: Optional[float] = None):
    """query/key/value: [batch, seq, heads, head_dim]. The route is
    chosen before any launch, from the head_dim, the mask and dropout
    alone (see the module note)."""
    query, key, value, attn_mask = amp.maybe_cast(
        "scaled_dot_product_attention", query, key, value, attn_mask)
    if not training:
        dropout_p = 0.0
    if attn_mask is not None or dropout_p > 0.0 or \
            query.shape[-1] not in KERNEL_HEAD_DIMS:
        if in_train_step():
            dropout_p = 0.0       # the reference's trace: no dropout key
        return sdpa_xla(query, key, value, attn_mask, is_causal, scale,
                        dropout_p)
    return flash_attention(query, key, value, causal=is_causal, scale=scale)
