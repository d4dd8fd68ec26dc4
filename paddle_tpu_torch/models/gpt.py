"""GPT decoder-only transformer (the JAX package's ``models/gpt.py``):
training and inference.

Parameter names and shapes follow the JAX package exactly, so a state
dict moves across with ``convert.load_reference_state``. Training and
prefill attention go through ``nn.functional.scaled_dot_product_attention``
(the flash forward and backward kernels on a card), decode attention
through ``generation.attention.cached_attention`` (the flash decode,
chunk or paged decode kernel). The tied LM head is a plain ``torch.matmul`` against ``wte``,
as the JAX package leaves it to XLA. The cached forward runs every
product (the Linears and the head) through ``kernels.row_linear``, so a
row's bits do not depend on the batch. ``use_recompute`` runs each block
in training as a recompute region (``distributed.parallel.recompute``)
under ``recompute_granularity``'s policy. Options of the JAX config that
are not ported yet (sequence parallelism, experts) raise.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as TF
from torch.utils.checkpoint import checkpoint

from .. import amp
from ..core import device as device_mod
from ..distributed.parallel.recompute import recompute
from ..generation.attention import cached_attention
from ..generation.kv_cache import KVCache
from ..kernels import row_linear
from ..nn import functional as F
from ..nn.container import LayerList
from ..nn.layer import Layer
from ..nn.layers_common import Dropout, Embedding, LayerNorm, Linear


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: Optional[int] = None   # default 4*hidden
    max_position_embeddings: int = 1024
    dropout: float = 0.0
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    use_recompute: bool = False
    #: the recompute policy of use_recompute: "selective" keeps the
    #: Linear products (save_dots_no_batch), "full" keeps nothing; also
    #: "core_attn" and fleet.utils.RecomputeConfig's policy names
    recompute_granularity: str = "selective"
    #: fuse the LM head into the loss: forward() returns (hidden, head
    #: weight) and loss() applies the head and cross entropy per
    #: sequence chunk of lm_loss_chunk positions, recomputing each
    #: chunk's logits in backward, so the [B, S, vocab] logits are never
    #: kept whole; a single chunk whose fp32 logits fit
    #: lm_loss_save_logits_budget bytes keeps its logits instead
    fused_lm_loss: bool = False
    lm_loss_chunk: int = 256
    lm_loss_save_logits_budget: int = 4 << 30
    tie_word_embeddings: bool = True
    sequence_parallel: bool = False
    moe_num_experts: int = 0

    @property
    def ffn_size(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size

    def check_ported(self):
        """Raise on the JAX config's options this package lacks."""
        unported = ["sequence_parallel"] if self.sequence_parallel else []
        if self.moe_num_experts > 0:
            unported.append("moe_num_experts")
        if unported:
            raise NotImplementedError(
                f"GPTConfig {unported}: not ported yet (ROADMAP A11 "
                "sequence parallelism and experts)")


#: recompute_granularity -> distributed.parallel.recompute policy name:
#: the reference's granularities and fleet.utils.RecomputeConfig's names
_REMAT_POLICY = {
    "selective": "save_dots_no_batch",
    "dots_with_no_batch_dims_saveable": "save_dots_no_batch",
    "core_attn": "save_dots",
    "dots_saveable": "save_dots",
    "full": "full",
    "nothing_saveable": "full",
}


def _remat_policy(granularity: str) -> str:
    """The recompute policy of ``granularity``; an unknown one raises
    rather than train under a default the user did not ask for."""
    try:
        return _REMAT_POLICY[granularity]
    except KeyError:
        raise ValueError(
            f"unknown recompute_granularity {granularity!r}; one of "
            f"{sorted(_REMAT_POLICY)}") from None


class GPTAttention(Layer):
    def __init__(self, cfg: GPTConfig, **kw):
        super().__init__()
        h, nh = cfg.hidden_size, cfg.num_heads
        self.num_heads = nh
        self.head_dim = h // nh
        std = cfg.initializer_range
        self.qkv_proj = Linear(h, 3 * h, std=std, **kw)
        self.out_proj = Linear(h, h, std=std / math.sqrt(2 * cfg.num_layers),
                               **kw)
        self.dropout_p = cfg.dropout

    def forward(self, x, attn_mask=None, cache=None, layer_idx=0,
                decode=False):
        b, s, h = x.shape
        qkv = self.qkv_proj(x).reshape(b, s, 3, self.num_heads,
                                       self.head_dim)
        q, k, v = qkv.unbind(dim=2)      # strided views, no copy
        if cache is not None:
            out, cache = cached_attention(q, k, v, cache, layer_idx,
                                          decode=decode, causal=True,
                                          attn_mask=attn_mask)
            return self.out_proj(out.reshape(b, s, h)), cache
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, is_causal=True,
            dropout_p=self.dropout_p, training=self.training)
        return self.out_proj(out.reshape(b, s, h))


class GPTMLP(Layer):
    def __init__(self, cfg: GPTConfig, generator=None, **kw):
        super().__init__()
        std = cfg.initializer_range
        self.fc1 = Linear(cfg.hidden_size, cfg.ffn_size, std=std,
                          generator=generator, **kw)
        self.fc2 = Linear(cfg.ffn_size, cfg.hidden_size,
                          std=std / math.sqrt(2 * cfg.num_layers),
                          generator=generator, **kw)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x):
        return self.dropout(self.fc2(TF.gelu(self.fc1(x),
                                             approximate="tanh")))


class GPTBlock(Layer):
    def __init__(self, cfg: GPTConfig, generator=None, **kw):
        super().__init__()
        dev = dict(device=kw.get("device"), dtype=kw.get("dtype"))
        self.ln1 = LayerNorm(cfg.hidden_size,
                             epsilon=cfg.layer_norm_epsilon, **dev)
        self.attn = GPTAttention(cfg, generator=generator, **kw)
        self.ln2 = LayerNorm(cfg.hidden_size,
                             epsilon=cfg.layer_norm_epsilon, **dev)
        self.mlp = GPTMLP(cfg, generator=generator, **kw)

    def forward(self, x, attn_mask=None, cache=None, layer_idx=0,
                decode=False):
        if cache is not None:
            a, cache = self.attn(self.ln1(x), attn_mask, cache=cache,
                                 layer_idx=layer_idx, decode=decode)
            x = x + a
            x = x + self.mlp(self.ln2(x))
            return x, cache
        x = x + self.attn(self.ln1(x), attn_mask)
        return x + self.mlp(self.ln2(x))


class GPTEmbeddings(Layer):
    """Token + position embedding (+ dropout)."""

    def __init__(self, cfg: GPTConfig, generator=None, **kw):
        super().__init__()
        std = cfg.initializer_range
        self.wte = Embedding(cfg.vocab_size, cfg.hidden_size, std=std,
                             generator=generator, **kw)
        self.wpe = Embedding(cfg.max_position_embeddings, cfg.hidden_size,
                             std=std, generator=generator, **kw)
        self.drop = Dropout(cfg.dropout)

    def forward(self, input_ids, pos=None):
        if pos is None:
            pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        return self.drop(self.wte(input_ids) + self.wpe(pos))


class GPTModel(Layer):
    def __init__(self, cfg: GPTConfig, generator=None, **kw):
        super().__init__()
        self.cfg = cfg
        self.embed = GPTEmbeddings(cfg, generator=generator, **kw)
        self.blocks = LayerList(
            [GPTBlock(cfg, generator=generator, **kw)
             for _ in range(cfg.num_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size,
                              epsilon=cfg.layer_norm_epsilon,
                              device=kw.get("device"), dtype=kw.get("dtype"))

    def forward(self, input_ids, attn_mask=None, cache=None,
                use_cache=False, prompt_len=None, cache_max_len=None,
                cache_dtype=None):
        if cache is not None or use_cache:
            return self._forward_cached(input_ids, attn_mask, cache,
                                        prompt_len, cache_max_len,
                                        cache_dtype)
        x = self.embed(input_ids)
        if self.cfg.use_recompute and self.training:
            policy = _remat_policy(self.cfg.recompute_granularity)
            for block in self.blocks:
                x = recompute(block, x, attn_mask, policy=policy)
        else:
            for block in self.blocks:
                x = block(x, attn_mask)
        return self.ln_f(x)

    @row_linear.in_cached_forward
    def _forward_cached(self, input_ids, attn_mask, cache, prompt_len,
                        cache_max_len, cache_dtype=None):
        """Generation forward: prefill creates and fills the KV cache
        (``cache=None``; ``cache_dtype="int8"`` creates the quantized
        cache), decode appends to one. Returns (hidden, cache).
        ``prompt_len`` [b] marks each row's true length in a
        right-padded prompt; kv_len advances to it, so the pad tail is
        invisible to (and overwritten by) decode steps. Decode with
        ``prompt_len`` is the final chunk of a chunked prefill: s
        cache-writing positions whose tail may overhang the row's true
        length, so kv_len clamps to ``prompt_len`` in the same way."""
        b, s = input_ids.shape
        decode = cache is not None
        if decode:
            x = self.embed(input_ids, pos=cache.positions(s))
        else:
            x = self.embed(input_ids)
            max_len = int(cache_max_len
                          or self.cfg.max_position_embeddings)
            cache = KVCache.create(
                self.cfg.num_layers, b, max_len, self.cfg.num_heads,
                self.cfg.hidden_size // self.cfg.num_heads,
                dtype=x.dtype, device=x.device, cache_dtype=cache_dtype)
        for i, block in enumerate(self.blocks):
            x, cache = block(x, attn_mask, cache=cache, layer_idx=i,
                             decode=decode)
        if decode:
            new_len = cache.kv_len + s
            if prompt_len is not None:
                new_len = torch.minimum(new_len, torch.as_tensor(
                    prompt_len, device=new_len.device).to(new_len.dtype))
            cache.with_kv_len(new_len)
        else:
            cache.with_kv_len(s if prompt_len is None else prompt_len)
        return self.ln_f(x), cache


class GPTForCausalLM(Layer):
    """GPT with the (tied) LM head. Built on ``device`` (default: the
    first CUDA card; ``device="cpu"`` only when asked) in ``dtype``,
    with every weight drawn from ``generator`` (default: the device's
    seeded generator)."""

    def __init__(self, cfg: GPTConfig, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg.check_ported()
        self.cfg = cfg
        kw = dict(device=device_mod.resolve(device), dtype=dtype)
        self.gpt = GPTModel(cfg, generator=generator, **kw)
        if not cfg.tie_word_embeddings:
            self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size,
                                  bias=False, std=cfg.initializer_range,
                                  generator=generator, **kw)
        else:
            self.lm_head = None

    def _logits(self, h):
        if self.lm_head is not None:
            return self.lm_head(h)
        # the JAX package's F.linear against the transposed wte
        h, w = amp.maybe_cast("linear", h, self.gpt.embed.wte.weight)
        if row_linear.routes(h, w):
            return row_linear.row_linear(h, torch.t(w))
        return torch.matmul(h, torch.t(w))

    def forward(self, input_ids, attn_mask=None, cache=None,
                use_cache=False, prompt_len=None, cache_max_len=None,
                cache_dtype=None):
        """Logits [b, s, vocab]; under ``fused_lm_loss`` the pair
        (final hidden states, head weight) that ``loss`` takes instead.
        The cached (generation) forward always returns logits;
        ``cache_dtype="int8"`` makes its prefill create the int8 cache."""
        if cache is not None or use_cache:
            return self._forward_cached(input_ids, attn_mask, cache,
                                        prompt_len, cache_max_len,
                                        cache_dtype)
        h = self.gpt(input_ids, attn_mask)
        if self.cfg.fused_lm_loss:
            w = self.lm_head.weight if self.lm_head is not None \
                else self.gpt.embed.wte.weight
            return h, w
        return self._logits(h)

    @row_linear.in_cached_forward
    def _forward_cached(self, input_ids, attn_mask, cache, prompt_len,
                        cache_max_len, cache_dtype=None):
        """Generation forward: returns (logits, cache). Prefill returns
        next-token logits only ([b, 1, vocab], gathered at each row's
        last REAL position — the prompt logits are never formed);
        decode returns logits for every new position, except the final
        chunk of a chunked prefill (decode with ``prompt_len``), which
        returns the [b, 1, vocab] logits at the last real prompt
        position."""
        decode = cache is not None
        # the cache updates in place: keep the entry lengths
        kv0 = cache.kv_len.clone() if decode and prompt_len is not None \
            else None
        h, cache = self.gpt(input_ids, attn_mask, cache=cache,
                            use_cache=True, prompt_len=prompt_len,
                            cache_max_len=cache_max_len,
                            cache_dtype=cache_dtype)
        if kv0 is not None:
            # window-local index of global position prompt_len - 1
            idx = torch.as_tensor(prompt_len, device=h.device).long() - 1 \
                - kv0.long()
            h = h[torch.arange(h.shape[0], device=h.device), idx][:, None]
        elif not decode:
            b, s = input_ids.shape
            if prompt_len is None:
                h = h[:, s - 1:s]
            else:
                idx = torch.as_tensor(prompt_len, device=h.device).long()
                h = h[torch.arange(b, device=h.device), idx - 1][:, None]
        return self._logits(h), cache

    def generate(self, input_ids, max_new_tokens: int = 32, **kwargs):
        """Autoregressive decoding with the KV cache — see
        ``generation.generate``."""
        from ..generation.api import generate as _generate
        return _generate(self, input_ids, max_new_tokens, **kwargs)

    def _fused_loss(self, hidden, labels, w):
        """Shifted LM head + cross entropy, mean over labels >= 0.

        One chunk whose fp32 logits fit the budget keeps them for
        backward (the JAX package's saved-logits branch). Otherwise the
        positions go in chunks of ``lm_loss_chunk``, the last one
        ragged, and each chunk runs under ``torch.utils.checkpoint``,
        so its logits exist only inside its forward and again inside its
        backward (the JAX package's per-chunk ``jax.checkpoint`` scan,
        whose zero-padded tail rows add nothing to either sum)."""
        tied = self.lm_head is None
        hs, ys = hidden[:, :-1], labels[:, 1:]
        b, s1, _ = hs.shape
        chunk = min(self.cfg.lm_loss_chunk, s1)
        n_chunks = -(-s1 // chunk)

        def chunk_ce(hc, yc, wv):
            wmat = torch.t(wv) if tied else wv
            logits = (hc @ wmat.to(hc.dtype)).float()
            lse = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, yc.clamp_min(0).long()[..., None])
            valid = (yc >= 0).float()
            return ((lse - gold[..., 0]) * valid).sum(), valid.sum()

        vocab = w.shape[0] if tied else w.shape[-1]
        if n_chunks == 1 and \
                b * s1 * vocab * 4 <= self.cfg.lm_loss_save_logits_budget:
            total, count = chunk_ce(hs, ys, w)
            return total / count.clamp_min(1.0)
        total = count = 0.0
        for i in range(n_chunks):
            sl = slice(i * chunk, (i + 1) * chunk)
            t, c = checkpoint(chunk_ce, hs[:, sl], ys[:, sl], w,
                              use_reentrant=False)
            total, count = total + t, count + c
        return total / count.clamp_min(1.0)

    def loss(self, logits, labels):
        """Shifted LM loss: the mean cross entropy of position t's
        logits against label t + 1, over labels that are not ignored
        (< 0 under the fused loss, -100 otherwise, as in the JAX
        package). Takes ``forward``'s output."""
        if self.cfg.fused_lm_loss:
            hidden, w = logits
            return self._fused_loss(hidden, labels, w)
        shifted = logits[:, :-1, :]
        return F.cross_entropy(shifted.reshape(-1, shifted.shape[-1]),
                               labels[:, 1:].reshape(-1))

    def num_params(self) -> int:
        return sum(torch.numel(p) for p in self.parameters())

    def flops_per_token(self, seq_len: int) -> float:
        """Approximate training FLOPs per token (6N + attention term),
        the JAX package's formula."""
        att = 12 * self.cfg.num_layers * self.cfg.hidden_size * seq_len
        return 6 * self.num_params() + att


CONFIGS = {
    "gpt2-small": GPTConfig(hidden_size=768, num_layers=12, num_heads=12),
    "gpt2-medium": GPTConfig(hidden_size=1024, num_layers=24, num_heads=16),
    "gpt2-large": GPTConfig(hidden_size=1280, num_layers=36, num_heads=20),
    "gpt3-6.7b": GPTConfig(hidden_size=4096, num_layers=32, num_heads=32,
                           max_position_embeddings=2048),
    "test-tiny": GPTConfig(vocab_size=512, hidden_size=64, num_layers=2,
                           num_heads=4, max_position_embeddings=128),
    "test-tiny-draft": GPTConfig(vocab_size=512, hidden_size=32,
                                 num_layers=1, num_heads=2,
                                 max_position_embeddings=128),
}


def gpt(name: str = "gpt2-small", *, device=None, dtype=None,
        generator=None, **overrides) -> GPTForCausalLM:
    cfg = dataclasses.replace(CONFIGS[name], **overrides)
    return GPTForCausalLM(cfg, device=device, dtype=dtype,
                          generator=generator)
