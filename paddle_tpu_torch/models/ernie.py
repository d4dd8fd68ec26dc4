"""ERNIE / BERT bidirectional encoder (the JAX package's
``models/ernie.py``): MLM + sentence-order pretraining, sequence
classification and incremental (cached) encoding.

Parameter names and shapes follow the JAX package, so a state dict moves
across with ``convert.load_reference_state``; the MLM head decodes
against the tied word embedding, which appears once in the state dict
(under ``ernie.embeddings``), as in the reference. Attention is
non-causal ``F.scaled_dot_product_attention``: the flash forward and
backward kernels on a card without a mask, ``sdpa_xla`` with one (a
``[b, s]`` padding mask turns additive, ``(1 - m) * -1e9`` in fp32, as
the reference does it). The cached forward (``ErnieModel(...,
use_cache=True)`` / ``cache=``) runs under the row-invariant product
route (``kernels.row_linear``), as GPT's does. ``use_recompute`` runs
each layer in training as a recompute region under
``recompute_granularity``'s policy. ``decoder_bias`` is built in fp32
whatever the model's dtype, as the reference builds it; ``.bfloat16()``
casts it with the rest, as the reference's ``to(dtype)`` does.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import torch

from ..core import device as device_mod
from ..distributed.parallel.mp_layers import sharded_constraint
from ..distributed.parallel.recompute import recompute
from ..generation.attention import cached_attention
from ..generation.kv_cache import KVCache
from ..kernels import row_linear
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.container import LayerList
from ..nn.layer import Layer
from ..nn.layers_common import Dropout, Embedding, LayerNorm
from ._common import spec_linear as _linear
from .gpt import _remat_policy


@dataclass
class ErnieConfig:
    vocab_size: int = 40000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: Optional[int] = None   # default 4*hidden
    max_position_embeddings: int = 2048
    type_vocab_size: int = 4
    hidden_act: str = "gelu"
    dropout: float = 0.0
    attention_dropout: float = 0.0
    layer_norm_epsilon: float = 1e-12
    initializer_range: float = 0.02
    use_recompute: bool = False
    #: the recompute policy of use_recompute: GPTConfig's vocabulary
    recompute_granularity: str = "core_attn"
    #: the [CLS] pooler (ERNIE's sentence-order head and the classifier
    #: read it)
    with_pooler: bool = True
    #: fused MLM loss: gather up to max_predictions masked positions a
    #: row and run the head only on them; the [B, S, vocab] logits are
    #: never formed
    fused_mlm_loss: bool = False
    max_predictions: int = 80

    @property
    def ffn_size(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size


class ErnieEmbeddings(Layer):
    """word + position + token_type embeddings -> LayerNorm -> dropout."""

    def __init__(self, cfg: ErnieConfig, **kw):
        super().__init__()
        std = cfg.initializer_range
        dev = dict(device=kw.get("device"), dtype=kw.get("dtype"))

        def table(n):
            return Embedding(n, cfg.hidden_size, weight_attr=I.ParamAttr(
                initializer=I.Normal(0.0, std)), **kw)
        self.word_embeddings = table(cfg.vocab_size)
        self.position_embeddings = table(cfg.max_position_embeddings)
        self.token_type_embeddings = table(cfg.type_vocab_size)
        self.layer_norm = LayerNorm(cfg.hidden_size,
                                    epsilon=cfg.layer_norm_epsilon, **dev)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, input_ids, token_type_ids=None, pos=None):
        b, s = input_ids.shape
        if pos is None:
            pos = torch.arange(s, device=input_ids.device)
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is None:
            token_type_ids = torch.zeros((b, s), dtype=torch.int64,
                                         device=input_ids.device)
        x = x + self.token_type_embeddings(token_type_ids)
        x = sharded_constraint(x)
        return self.dropout(self.layer_norm(x))


class ErnieSelfAttention(Layer):
    def __init__(self, cfg: ErnieConfig, **kw):
        super().__init__()
        h, nh = cfg.hidden_size, cfg.num_heads
        self.num_heads = nh
        self.head_dim = h // nh
        std = cfg.initializer_range
        self.qkv_proj = _linear(h, 3 * h, std, **kw)
        self.out_proj = _linear(h, h, std / math.sqrt(2 * cfg.num_layers),
                                **kw)
        self.dropout_p = cfg.attention_dropout

    def forward(self, x, attn_mask=None, cache=None, layer_idx=0,
                decode=False):
        b, s, h = x.shape
        qkv = sharded_constraint(self.qkv_proj(x))
        qkv = qkv.reshape(b, s, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.unbind(dim=2)
        if cache is not None:
            # incremental encoding (eval): the prefill attends
            # bidirectionally; appended tokens attend the whole cached
            # prefix and, causally, their own window
            out, cache = cached_attention(q, k, v, cache, layer_idx,
                                          decode=decode, causal=False,
                                          attn_mask=attn_mask)
            return self.out_proj(out.reshape(b, s, h)), cache
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, is_causal=False,
            dropout_p=self.dropout_p, training=self.training)
        return self.out_proj(out.reshape(b, s, h))


class ErnieLayer(Layer):
    """Post-LN encoder block (BERT/ERNIE layout: residual -> LayerNorm)."""

    def __init__(self, cfg: ErnieConfig, **kw):
        super().__init__()
        std = cfg.initializer_range
        dev = dict(device=kw.get("device"), dtype=kw.get("dtype"))
        self.attn = ErnieSelfAttention(cfg, **kw)
        self.ln1 = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_epsilon,
                             **dev)
        self.fc1 = _linear(cfg.hidden_size, cfg.ffn_size, std, **kw)
        self.fc2 = _linear(cfg.ffn_size, cfg.hidden_size,
                           std / math.sqrt(2 * cfg.num_layers), **kw)
        self.ln2 = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_epsilon,
                             **dev)
        self.dropout = Dropout(cfg.dropout)
        self.act = cfg.hidden_act

    def _ffn(self, x):
        h = self.fc1(x)
        return F.gelu(h, approximate=True) if self.act == "gelu" \
            else F.relu(h)

    def forward(self, x, attn_mask=None, cache=None, layer_idx=0,
                decode=False):
        if cache is not None:
            a, cache = self.attn(x, attn_mask, cache=cache,
                                 layer_idx=layer_idx, decode=decode)
            x = self.ln1(x + a)
            return self.ln2(x + self.fc2(self._ffn(x))), cache
        x = self.ln1(x + self.dropout(self.attn(x, attn_mask)))
        return self.ln2(x + self.dropout(self.fc2(self._ffn(x))))


class ErniePooler(Layer):
    """[CLS] pooler: first-token hidden -> dense -> tanh."""

    def __init__(self, cfg: ErnieConfig, **kw):
        super().__init__()
        self.dense = _linear(cfg.hidden_size, cfg.hidden_size,
                             cfg.initializer_range, **kw)

    def forward(self, x):
        return F.tanh(self.dense(x[:, 0]))


class ErnieModel(Layer):
    """The encoder trunk. Built on ``device`` (default: the first CUDA
    card; ``device="cpu"`` only when asked) in ``dtype``, every weight
    drawn from ``generator`` (default: the device's seeded one)."""

    def __init__(self, cfg: ErnieConfig, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device_mod.resolve(device), dtype=dtype,
                  generator=generator)
        self.embeddings = ErnieEmbeddings(cfg, **kw)
        self.layers = LayerList([ErnieLayer(cfg, **kw)
                                 for _ in range(cfg.num_layers)])
        self.pooler = ErniePooler(cfg, **kw) if cfg.with_pooler else None

    def forward(self, input_ids, token_type_ids=None, attn_mask=None,
                cache=None, use_cache=False, prompt_len=None,
                cache_max_len=None, cache_dtype=None):
        """Returns (sequence_output, pooled_output-or-None), plus the KV
        cache as a third element under ``use_cache`` / ``cache``
        (incremental encoding: prefill fills the cache, later calls
        append tokens without recomputing the prefix). ``attn_mask``: a
        [b, s] 1/0 padding mask, or a broadcastable additive [b, 1, s,
        s] mask; a [b, s] one turns additive here."""
        if attn_mask is not None and attn_mask.dim() == 2:
            add = (1.0 - attn_mask.to(torch.float32)) * -1e9
            attn_mask = add[:, None, None, :]
        if cache is not None or use_cache:
            return self._forward_cached(input_ids, token_type_ids,
                                        attn_mask, cache, prompt_len,
                                        cache_max_len, cache_dtype)
        x = self.embeddings(input_ids, token_type_ids)
        policy = _remat_policy(self.cfg.recompute_granularity) \
            if self.cfg.use_recompute and self.training else None
        for layer in self.layers:
            if policy is not None:
                x = recompute(layer, x, attn_mask, policy=policy)
            else:
                x = layer(x, attn_mask)
        pooled = self.pooler(x) if self.pooler is not None else None
        return x, pooled

    @row_linear.in_cached_forward
    def _forward_cached(self, input_ids, token_type_ids, attn_mask, cache,
                        prompt_len, cache_max_len, cache_dtype=None):
        """Incremental-encoding forward (eval only): returns
        (sequence_output, pooled-or-None, cache); ``pooled`` is filled
        on prefill only (an appended window holds no [CLS]). A ragged
        prefill (``prompt_len`` shorter than the padded width) is not
        masked here: pass a [b, s] ``attn_mask`` for a padded one."""
        b, s = input_ids.shape
        decode = cache is not None
        if decode:
            x = self.embeddings(input_ids, token_type_ids,
                                pos=cache.positions(s))
        else:
            x = self.embeddings(input_ids, token_type_ids)
            max_len = int(cache_max_len
                          or self.cfg.max_position_embeddings)
            cfg = self.cfg
            cache = KVCache.create(
                cfg.num_layers, b, max_len, cfg.num_heads,
                cfg.hidden_size // cfg.num_heads, dtype=x.dtype,
                device=x.device, cache_dtype=cache_dtype)
        for i, layer in enumerate(self.layers):
            x, cache = layer(x, attn_mask, cache=cache, layer_idx=i,
                             decode=decode)
        if decode:
            cache.with_kv_len(cache.kv_len + s)
        else:
            cache.with_kv_len(s if prompt_len is None else prompt_len)
        pooled = self.pooler(x) if self.pooler is not None \
            and not decode else None
        return x, pooled, cache


class ErnieMLMHead(Layer):
    """transform (dense + gelu + LayerNorm), then decode against the tied
    word embedding plus an fp32 ``decoder_bias``."""

    def __init__(self, cfg: ErnieConfig, embed: ErnieEmbeddings, **kw):
        super().__init__()
        dev = dict(device=kw.get("device"), dtype=kw.get("dtype"))
        self.transform = _linear(cfg.hidden_size, cfg.hidden_size,
                                 cfg.initializer_range, **kw)
        self.layer_norm = LayerNorm(cfg.hidden_size,
                                    epsilon=cfg.layer_norm_epsilon, **dev)
        self._embed_ref = [embed]     # a list: not a second registration
        self.decoder_bias = self.create_parameter(
            (cfg.vocab_size,), dtype="float32", is_bias=True,
            device=kw.get("device"))

    def forward(self, x):
        x = self.layer_norm(F.gelu(self.transform(x), approximate=True))
        wte = self._embed_ref[0].word_embeddings.weight
        logits = torch.add(F.linear(x, torch.t(wte)), self.decoder_bias)
        return sharded_constraint(logits)


class ErnieForPretraining(Layer):
    """MLM + sentence-order (2-way) pretraining heads, joint loss."""

    def __init__(self, cfg: ErnieConfig, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not cfg.with_pooler:
            raise ValueError("ErnieForPretraining needs the [CLS] pooler "
                             "for its sentence-order head; set "
                             "with_pooler=True")
        self.cfg = cfg
        dev = device_mod.resolve(device)
        kw = dict(device=dev, dtype=dtype, generator=generator)
        self.ernie = ErnieModel(cfg, **kw)
        self.mlm_head = ErnieMLMHead(cfg, self.ernie.embeddings, **kw)
        self.sop_head = _linear(cfg.hidden_size, 2, cfg.initializer_range,
                                **kw)

    def forward(self, input_ids, token_type_ids=None, attn_mask=None):
        """(mlm_logits, sop_logits); under ``fused_mlm_loss`` (sequence
        output, sop_logits, head parameters), which ``loss`` takes."""
        seq, pooled = self.ernie(input_ids, token_type_ids, attn_mask)
        if self.cfg.fused_mlm_loss:
            head = self.mlm_head
            wp = (head.transform.weight, head.transform.bias,
                  head.layer_norm.weight, head.layer_norm.bias,
                  head.decoder_bias,
                  self.ernie.embeddings.word_embeddings.weight)
            return seq, self.sop_head(pooled), wp
        return self.mlm_head(seq), self.sop_head(pooled)

    def _fused_mlm(self, h, y, tw, tb, lw, lb, db, wte):
        """Gathered-position MLM: the first max_predictions masked slots
        of each row (a stable sort of "not masked", so in their original
        order; slots past a row's masked count hold unmasked positions,
        label < 0, and count nothing), then transform + LayerNorm +
        decode on those alone. The reference's jnp, op for op."""
        p = min(self.cfg.max_predictions, h.shape[1])
        masked = y >= 0
        order = torch.argsort(torch.where(masked, 0, 1), dim=1,
                              stable=True)[:, :p]
        gh = torch.take_along_dim(h, order[..., None], dim=1)
        gy = torch.take_along_dim(y, order, dim=1)
        t = gh @ tw.to(gh.dtype) + tb.to(gh.dtype)
        c = 0.7978845608028654  # sqrt(2/pi)
        t = 0.5 * t * (1.0 + torch.tanh(c * (t + 0.044715 * t ** 3)))
        mu = t.mean(dim=-1, keepdim=True)
        var = t.var(dim=-1, keepdim=True, correction=0)
        t = (t - mu) / torch.sqrt(var + self.cfg.layer_norm_epsilon)
        t = t * lw.to(t.dtype) + lb.to(t.dtype)
        logits = (t @ torch.t(wte).to(t.dtype)).float() + db.float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, gy.clamp_min(0)[..., None],
                                    dim=-1)[..., 0]
        valid = (gy >= 0).float()
        return ((lse - gold) * valid).sum() / valid.sum().clamp_min(1.0)

    def loss(self, outputs, labels):
        """outputs = (mlm_logits, sop_logits), or under fused_mlm_loss
        (seq_hidden, sop_logits, head_params); labels = (mlm_labels with
        ignore_index -100, sop_labels)."""
        mlm_labels, sop_labels = labels
        if self.cfg.fused_mlm_loss:
            seq, sop_logits, wp = outputs
            mlm = self._fused_mlm(seq, mlm_labels.long(), *wp)
        else:
            mlm_logits, sop_logits = outputs
            mlm = F.cross_entropy(
                mlm_logits.reshape(-1, mlm_logits.shape[-1]),
                mlm_labels.reshape(-1), ignore_index=-100)
        sop = F.cross_entropy(sop_logits, sop_labels)
        return mlm + sop

    def num_params(self) -> int:
        return sum(torch.numel(p) for p in self.parameters())

    def flops_per_token(self, seq_len: int) -> float:
        """Training FLOPs per token (6N + attention term), the JAX
        package's formula."""
        att = 12 * self.cfg.num_layers * self.cfg.hidden_size * seq_len
        return 6 * self.num_params() + att


class ErnieForSequenceClassification(Layer):
    def __init__(self, cfg: ErnieConfig, num_classes: int = 2, *,
                 device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not cfg.with_pooler:
            raise ValueError("ErnieForSequenceClassification classifies "
                             "the pooled [CLS] state; set with_pooler=True")
        kw = dict(device=device_mod.resolve(device), dtype=dtype,
                  generator=generator)
        self.ernie = ErnieModel(cfg, **kw)
        self.dropout = Dropout(cfg.dropout)
        self.classifier = _linear(cfg.hidden_size, num_classes,
                                  cfg.initializer_range, **kw)

    def forward(self, input_ids, token_type_ids=None, attn_mask=None):
        _, pooled = self.ernie(input_ids, token_type_ids, attn_mask)
        return self.classifier(self.dropout(pooled))


# public ERNIE-3.0 / BERT sizes
CONFIGS = {
    "ernie-3.0-base": ErnieConfig(hidden_size=768, num_layers=12,
                                  num_heads=12),
    "ernie-3.0-medium": ErnieConfig(hidden_size=768, num_layers=6,
                                    num_heads=12),
    "ernie-3.0-xbase": ErnieConfig(hidden_size=1024, num_layers=20,
                                   num_heads=16),
    "bert-base": ErnieConfig(vocab_size=30522, hidden_size=768,
                             num_layers=12, num_heads=12,
                             max_position_embeddings=512,
                             type_vocab_size=2),
    "bert-large": ErnieConfig(vocab_size=30522, hidden_size=1024,
                              num_layers=24, num_heads=16,
                              max_position_embeddings=512,
                              type_vocab_size=2),
    "test-tiny": ErnieConfig(vocab_size=512, hidden_size=64, num_layers=2,
                             num_heads=4, max_position_embeddings=128),
}


def ernie(name: str = "ernie-3.0-base", *, device=None, dtype=None,
          generator=None, **overrides) -> ErnieForPretraining:
    cfg = dataclasses.replace(CONFIGS[name], **overrides)
    return ErnieForPretraining(cfg, device=device, dtype=dtype,
                               generator=generator)


def bert(name: str = "bert-base", **kwargs) -> ErnieForPretraining:
    return ernie(name, **kwargs)
