"""Transformer layers (the JAX package's ``nn/transformer.py``):
``MultiHeadAttention``, ``TransformerEncoderLayer`` / ``Encoder``,
``TransformerDecoderLayer`` / ``Decoder`` and ``Transformer``, whose
defaults are the Transformer-base of Vaswani et al. (2017): d_model
512, 8 heads, 6 + 6 layers, feed-forward 2048, relu.

Attention goes through ``F.scaled_dot_product_attention``, so an
unmasked attention with dropout 0 at a kernel head_dim runs the flash
kernels (``csrc/flash_fwd.cu``, ``flash_bwd.cu``) on a card and their
plain versions on the CPU, and a masked one runs ``sdpa_xla``, as the
JAX package's mask route does. ``Transformer(dropout=p)`` also sets the
attention dropout to p, as in the JAX package, so in training only
``dropout=0.0`` reaches the kernels. Every sublayer takes ``device``,
``dtype`` and ``generator`` for its weights.
"""
from __future__ import annotations

import copy

import torch

from ..core.device import resolve
from ..core.tensor import Tensor
from . import functional as F
from .container import LayerList
from .layer import Layer
from .layers_common import Dropout, LayerNorm, Linear


class MultiHeadAttention(Layer):
    """Projections ``q_proj`` (embed -> embed), ``k_proj`` (kdim ->
    embed), ``v_proj`` (vdim -> embed) and ``out_proj``. With ``cache``
    (the previous keys and values, each [batch, seq, heads, head_dim]),
    the new ones are appended and ``(out, (k, v))`` is returned, for
    incremental decoding."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        kw = dict(weight_attr=weight_attr, bias_attr=bias_attr,
                  device=device, dtype=dtype, generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(kdim or embed_dim, embed_dim, **kw)
        self.v_proj = Linear(vdim or embed_dim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = query if value is None else value
        q = self.q_proj(query)
        k = self.k_proj(key)
        v = self.v_proj(value)
        b, sq = q.shape[0], q.shape[1]
        sk = k.shape[1]
        q = q.reshape(b, sq, self.num_heads, self.head_dim)
        k = k.reshape(b, sk, self.num_heads, self.head_dim)
        v = v.reshape(b, sk, self.num_heads, self.head_dim)
        if cache is not None:
            k = torch.cat([cache[0], k], dim=1)
            v = torch.cat([cache[1], v], dim=1)
            cache = (k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training)
        out = self.out_proj(out.reshape(b, sq, self.embed_dim))
        if cache is not None:
            return out, cache
        return out


_ACT = {"relu": F.relu, "gelu": F.gelu, "silu": F.silu}


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 *, device=None, dtype=None, generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        mk = dict(device=device, dtype=dtype, generator=generator)
        self.self_attn = MultiHeadAttention(d_model, nhead,
                                            dropout=attn_dropout, **mk)
        self.linear1 = Linear(d_model, dim_feedforward, **mk)
        self.linear2 = Linear(dim_feedforward, d_model, **mk)
        self.norm1 = LayerNorm(d_model, **mk)
        self.norm2 = LayerNorm(d_model, **mk)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.act_dropout = Dropout(act_dropout)
        self.activation = _ACT[activation]

    def forward(self, src, src_mask=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = self.self_attn(src, attn_mask=src_mask)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.act_dropout(self.activation(
            self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(Layer):
    """``num_layers`` copies of ``encoder_layer`` (the first is the
    given one, the rest deep copies), or the given list of layers."""

    def __init__(self, encoder_layer_or_list, num_layers=None, norm=None):
        super().__init__()
        if isinstance(encoder_layer_or_list, (list, tuple)):
            self.layers = LayerList(encoder_layer_or_list)
        else:
            self.layers = LayerList(
                [encoder_layer_or_list] +
                [copy.deepcopy(encoder_layer_or_list)
                 for _ in range(num_layers - 1)])
        self.norm = norm

    def forward(self, src, src_mask=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask=src_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        mk = dict(device=device, dtype=dtype, generator=generator)
        self.self_attn = MultiHeadAttention(d_model, nhead,
                                            dropout=attn_dropout, **mk)
        self.cross_attn = MultiHeadAttention(d_model, nhead,
                                             dropout=attn_dropout, **mk)
        self.linear1 = Linear(d_model, dim_feedforward, **mk)
        self.linear2 = Linear(dim_feedforward, d_model, **mk)
        self.norm1 = LayerNorm(d_model, **mk)
        self.norm2 = LayerNorm(d_model, **mk)
        self.norm3 = LayerNorm(d_model, **mk)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.act_dropout = Dropout(act_dropout)
        self.activation = _ACT[activation]

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        tgt = self.self_attn(tgt, attn_mask=tgt_mask)
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = self.cross_attn(tgt, memory, memory, attn_mask=memory_mask)
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.act_dropout(self.activation(
            self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [decoder_layer] + [copy.deepcopy(decoder_layer)
                               for _ in range(num_layers - 1)])
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None):
        out = tgt
        for layer in self.layers:
            out = layer(out, memory, tgt_mask=tgt_mask,
                        memory_mask=memory_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out


class Transformer(Layer):
    """Encoder-decoder; the copies of each stack start equal to its
    first layer, as in the JAX package (``deepcopy``)."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", normalize_before=False, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        mk = dict(device=device, dtype=dtype, generator=generator)
        enc = TransformerEncoderLayer(d_model, nhead, dim_feedforward,
                                      dropout, activation,
                                      normalize_before=normalize_before,
                                      **mk)
        dec = TransformerDecoderLayer(d_model, nhead, dim_feedforward,
                                      dropout, activation,
                                      normalize_before=normalize_before,
                                      **mk)
        self.encoder = TransformerEncoder(enc, num_encoder_layers)
        self.decoder = TransformerDecoder(dec, num_decoder_layers)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """[length, length] bool ``Tensor``, True on and below the
        diagonal (the positions a query may attend), as in the JAX
        package."""
        m = torch.ones((length, length), dtype=torch.bool,
                       device=resolve(device))
        return torch.tril(m).as_subclass(Tensor)
