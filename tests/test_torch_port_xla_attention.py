"""The port's XLA attention routes (``nn.functional.attention.sdpa_xla``,
``kernels.flash_attention.decode_xla``) against the JAX package's
``_sdpa_xla`` and ``_decode_xla``, on the CPU, inputs made with numpy
from a seed; the dispatch rule that sends a head_dim outside
``KERNEL_HEAD_DIMS`` (or an explicit mask) to them and every other call
to the kernel wrappers; and a GPT at head_dim 80 through both packages.

Tolerances: fp32 outputs within 1e-5 and gradients within 1e-4 (the
same fp32 arithmetic, sums taken in another order); GPT logits 1e-4
(``tests/test_torch_port_gpt.py``'s rule).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import gpt as jax_gpt
from paddle_tpu.nn.functional.attention import _sdpa_xla
from _port_jax_decode import prefill_and_decode
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.generation.attention import cached_attention
from paddle_tpu_torch.generation.kv_cache import KVCache
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.models.gpt import gpt
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional.attention import sdpa_xla

# the module, not the function the package exports under its name
jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")
OUT = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)


def _reset():
    fa.reset_counts()
    sdpa_xla.calls = 0


def _qkv(seed, b, sq, sk, hq, hk, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, sq, hq, d).astype(np.float32),
            rng.randn(b, sk, hk, d).astype(np.float32),
            rng.randn(b, sk, hk, d).astype(np.float32),
            rng.randn(b, sq, hq, d).astype(np.float32))


# ----------------------------------------------------------- sdpa_xla

@pytest.mark.parametrize("d", [80, 96])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk,hq,hk", [(37, 37, 4, 4), (20, 45, 4, 4),
                                         (33, 33, 4, 2)])
def test_sdpa_xla_matches_jax_with_gradients(d, causal, sq, sk, hq, hk):
    """Output and the gradients of q, k, v (against ``jax.grad`` of the
    reference). The reference's einsum takes equal head counts, so a
    grouped-query case is held to it on k and v repeated per group."""
    q, k, v, cot = _qkv(d + sq + sk + hk, 2, sq, sk, hq, hk, d)
    g = hq // hk

    def ref(qq, kk, vv):
        kk, vv = jnp.repeat(kk, g, axis=2), jnp.repeat(vv, g, axis=2)
        return _sdpa_xla(qq, kk, vv, is_causal=causal)

    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    out_ref = ref(jq, jk, jv)
    grads_ref = jax.grad(lambda *a: jnp.sum(ref(*a) * cot),
                         argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    _reset()
    out = sdpa_xla(tq, tk, tv, is_causal=causal)
    (out * torch.tensor(cot)).sum().backward()
    assert sdpa_xla.calls == 1
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref),
                               **OUT)
    for t, r in zip((tq, tk, tv), grads_ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), **GRAD)


@pytest.mark.parametrize("kind", ["bool", "additive"])
def test_sdpa_masks_go_to_the_xla_route(kind):
    """An explicit mask takes the reference's XLA path at any head_dim,
    as in the JAX package: bool keeps True positions, a float mask adds."""
    q, k, v, _ = _qkv(5, 2, 12, 12, 2, 2, 64)
    rng = np.random.RandomState(6)
    mask = rng.rand(2, 1, 12, 12) > 0.3
    mask[..., 0] = True                 # every row sees a column
    if kind == "additive":
        mask = np.where(mask, 0.0, -1e4).astype(np.float32) \
            + rng.randn(2, 1, 12, 12).astype(np.float32)
    ref = _sdpa_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(mask))
    _reset()
    out = F.scaled_dot_product_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        attn_mask=torch.tensor(mask), training=False)
    assert (sdpa_xla.calls, fa.flash_attention_plain.calls) == (1, 0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **OUT)


def test_sdpa_bf16_rounds_the_weights_as_the_reference():
    """bf16 inputs: fp32 logits and softmax, weights rounded to bf16,
    then P V in bf16 (bitwise-close: one bf16 rounding apart at most)."""
    q, k, v, _ = _qkv(7, 1, 16, 16, 2, 2, 80)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    ref = np.asarray(_sdpa_xla(*jb, is_causal=True).astype(jnp.float32))
    tb = [torch.tensor(a).bfloat16() for a in (q, k, v)]
    out = sdpa_xla(*tb, is_causal=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref,
                               atol=1e-2, rtol=2.0 ** -7)


# --------------------------------------------------------- decode_xla

def _cache(seed, b, t, hk, d, int8):
    rng = np.random.RandomState(seed)
    if not int8:
        return [rng.randn(b, t, hk, d).astype(np.float32) for _ in range(2)]
    k = rng.randint(-128, 128, (b, t, hk, d)).astype(np.int8)
    v = rng.randint(-128, 128, (b, t, hk, d)).astype(np.int8)
    ks = (rng.rand(b, t, hk) * 0.02 + 1e-3).astype(np.float32)
    vs = (rng.rand(b, t, hk) * 0.02 + 1e-3).astype(np.float32)
    # the scales are bf16 in a QuantKVCache: both sides read the same bits
    ks, vs = (np.asarray(jnp.asarray(s, jnp.bfloat16).astype(jnp.float32))
              for s in (ks, vs))
    return [k, v, ks, vs]


def _jax_decode(fn, q, cache, kv, **extra):
    scales = {} if len(cache) == 2 else dict(
        k_scale=jnp.asarray(cache[2], jnp.bfloat16),
        v_scale=jnp.asarray(cache[3], jnp.bfloat16))
    return np.asarray(fn(jnp.asarray(q), *(jnp.asarray(c) for c in cache[:2]),
                         **extra, kv_len=jnp.asarray(kv, jnp.int32),
                         **scales))


def _port_decode(q, cache, kv, **extra):
    scales = {} if len(cache) == 2 else dict(
        k_scale=torch.tensor(cache[2]).bfloat16(),
        v_scale=torch.tensor(cache[3]).bfloat16())
    return fa.decode_xla(torch.tensor(q), *(torch.tensor(c)
                                            for c in cache[:2]),
                         torch.tensor(kv, dtype=torch.int32), **extra,
                         **scales).numpy()


@pytest.mark.parametrize("d", [80, 96])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("sq,hq,hk", [(1, 4, 4), (3, 4, 2), (12, 4, 2),
                                      (20, 6, 6)])
def test_decode_xla_matches_jax(d, int8, sq, hq, hk):
    """The reference's public decode (q_len <= 8) or chunk function,
    which on the CPU runs ``_decode_xla`` for every head_dim, on the same
    ragged lengths: one row's kv_len is below q_len, so its leading rows
    see nothing (the reference's -1e30 masking averages every column
    there; the port's route does the same)."""
    b, t = 3, 48
    cache = _cache(d + sq + hk, b, t, hk, d, int8)
    q = np.random.RandomState(sq).randn(b, sq, hq, d).astype(np.float32)
    kv = np.array([sq - 1 if sq > 1 else 1, 30, t], np.int32)
    fn = jfa.flash_attention_decode if sq <= 8 else jfa.flash_attention_chunk
    ref = _jax_decode(fn, q, cache, kv)
    _reset()
    out = _port_decode(q, cache, kv)
    assert fa.decode_xla.calls == 1
    np.testing.assert_allclose(out, ref, **OUT)


@pytest.mark.parametrize("int8", [False, True])
def test_decode_xla_paged_matches_jax(int8):
    """The reference's paged decode on the CPU gathers the row's pages
    and runs ``_decode_xla``; the port's route through ``page_table``."""
    d, hq, hk, ps, b, sq = 80, 4, 2, 16, 2, 2
    pool = _cache(11, 9, ps, hk, d, int8)
    table = np.array([[3, 1, 7], [2, 8, 0]], np.int32)
    q = np.random.RandomState(12).randn(b, sq, hq, d).astype(np.float32)
    kv = np.array([40, 17], np.int32)
    scales = {} if not int8 else dict(
        k_scale=jnp.asarray(pool[2], jnp.bfloat16),
        v_scale=jnp.asarray(pool[3], jnp.bfloat16))
    ref = np.asarray(jfa.flash_attention_decode_paged(
        jnp.asarray(q), jnp.asarray(pool[0]), jnp.asarray(pool[1]),
        jnp.asarray(table), jnp.asarray(kv), **scales))
    _reset()
    out = _port_decode(q, pool, kv, page_table=torch.tensor(table))
    assert fa.decode_xla.calls == 1
    np.testing.assert_allclose(out, ref, **OUT)


# ------------------------------------------------------ dispatch rule

@pytest.mark.parametrize("d,xla", [(80, True), (96, True), (64, False),
                                   (16, False)])
def test_sdpa_dispatches_on_the_head_dim(d, xla):
    """A head_dim outside KERNEL_HEAD_DIMS reaches sdpa_xla and never the
    kernel wrapper (no launch, no plain-version call); one inside reaches
    the wrapper (on the CPU, its plain version) and never sdpa_xla."""
    q, k, v, _ = _qkv(d, 1, 10, 10, 2, 2, d)
    _reset()
    F.scaled_dot_product_attention(*(torch.tensor(a) for a in (q, k, v)),
                                   is_causal=True, training=False)
    assert sdpa_xla.calls == int(xla)
    assert fa.flash_attention_plain.calls == int(not xla)
    assert fa.flash_attention.launches == 0


@pytest.mark.parametrize("d,xla", [(80, True), (64, False)])
@pytest.mark.parametrize("window", ["decode", "chunk", "paged", "prefill"])
def test_cached_attention_dispatches_on_the_head_dim(d, xla, window):
    """Every window of ``cached_attention`` at head_dim 80 takes the XLA
    routes (decode_xla for decode-shaped windows, paged ones gathered;
    sdpa_xla for prefill); at 64 the kernel wrappers (their plain
    versions here). The kernels' plain versions never run on the XLA
    route."""
    from paddle_tpu_torch.generation.paged_cache import PagedKVCache
    b, h, s = 2, 2, {"decode": 3, "chunk": 12, "paged": 2, "prefill": 6}[
        window]
    rng = np.random.RandomState(d)
    q, k, v = (torch.tensor(rng.randn(b, s, h, d).astype(np.float32))
               for _ in range(3))
    if window == "paged":
        cache = PagedKVCache.create(1, b, 9, 16, 4, h, d)
        cache.page_table.copy_(torch.tensor([[3, 1, 7, 5], [2, 8, 4, 6]]))
        cache.k.normal_(generator=torch.Generator().manual_seed(1))
        cache.v.normal_(generator=torch.Generator().manual_seed(2))
        cache.kv_len = torch.tensor([17, 6], dtype=torch.int32)
    else:
        cache = KVCache.create(1, b, 64, h, d, dtype=torch.float32)
        cache.k.normal_(generator=torch.Generator().manual_seed(1))
        cache.v.normal_(generator=torch.Generator().manual_seed(2))
        cache.kv_len = torch.tensor([5, 20], dtype=torch.int32)
    _reset()
    out, _ = cached_attention(q, k, v, cache, 0, decode=window != "prefill",
                              causal=True)
    assert out.shape == (b, s, h, d)
    plain = {"decode": fa.flash_attention_decode_plain,
             "chunk": fa.flash_attention_chunk_plain,
             "paged": fa.flash_attention_decode_paged_plain,
             "prefill": fa.flash_attention_plain}[window]
    xla_calls = sdpa_xla.calls if window == "prefill" else fa.decode_xla.calls
    assert (xla_calls, plain.calls) == ((1, 0) if xla else (0, 1))


# ------------------------------------------------ a GPT at head_dim 80

def test_gpt_at_head_dim_80_matches_jax():
    """hidden 160 over 2 heads: prefill and teacher-forced decode logits
    against the JAX package's, through the XLA routes only."""
    paddle.seed(0)
    jm = jax_gpt("test-tiny", hidden_size=160, num_heads=2)
    jm.eval()
    tm = gpt("test-tiny", device="cpu", hidden_size=160, num_heads=2)
    load_reference_state(tm, {k: np.asarray(t._data)
                              for k, t in jm.state_dict().items()})
    tm.eval()
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 512, (2, 14))
    plen = np.array([14, 6], np.int32)
    forced = rng.randint(0, 512, (3, 2))

    j_logits, _ = prefill_and_decode(jm, ids, plen, forced, 32)
    _reset()
    with torch.no_grad():
        t_logits, t_cache = tm(torch.as_tensor(ids), use_cache=True,
                               prompt_len=torch.as_tensor(plen),
                               cache_max_len=32)
        np.testing.assert_allclose(t_logits.numpy(), j_logits[0],
                                   atol=1e-4, rtol=1e-4)
        for tok, ref in zip(forced, j_logits[1:]):
            t_logits, t_cache = tm(torch.as_tensor(tok)[:, None],
                                   cache=t_cache)
            np.testing.assert_allclose(t_logits.numpy(), ref,
                                       atol=1e-4, rtol=1e-4)
    assert sdpa_xla.calls > 0 and fa.decode_xla.calls == 2 * len(forced)
    assert fa.flash_attention_plain.calls == 0
    assert fa.flash_attention_decode_plain.calls == 0
