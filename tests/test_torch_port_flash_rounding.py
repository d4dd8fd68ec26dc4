"""Where the tensor-core flash kernels round, checked on the CPU.

The bf16 / fp16 flash-attention kernels (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu`` on their tensor-core route) keep scores, softmax
statistics and every sum in fp32. P, and dS, reach the products that
consume them (O += P V, dV += P^T dO, dQ += dS K, dK += dS^T Q) as two
terms of the input type, hi = T(x) and lo = T(x - hi)
(``csrc/flash_mma.cuh``). The JAX Pallas kernels round them once, at the
same points (paddle_tpu/kernels/flash_attention.py ``p.astype(v.dtype)``,
``ds.astype(k.dtype)``, ``p.astype(do.dtype)``, ``ds.astype(q.dtype)``).
``_mirror_fwd`` and ``_mirror_bwd`` repeat that arithmetic in torch,
with either form, and are held three ways:

1. with the single rounding, against the JAX ``flash_attention``
   forward and ``jax.vjp`` backward in bf16 (Pallas in interpret mode,
   as tests/test_torch_port_train_attention.py runs it), closer than
   the port's fp32 plain versions are to it: these are the reference's
   rounding points. The scale is chosen so that scale * log2(e) is a
   power of two, which makes the JAX wrapper's rounding of
   q * scale * log2(e) to bf16 exact (the kernels scale in fp32 and do
   not round q), so the comparison sees the rounding of P and dS alone.
   Under grouped-query heads the JAX wrapper rounds each head's dk and
   dv to bf16 before it sums the group (the VJP of its ``jnp.repeat``);
   the kernels sum the group in fp32 and round once, so dk and dv are
   compared as the mirror's per-head gradients summed the JAX way;
2. with the two terms, against ``flash_attention_plain`` and
   ``flash_attention_bwd_plain`` at [2, 512, 4, 64]: inside the rule
   ``chip_smoke.py`` holds the kernels to at the training shapes
   (2^-7 |plain| + 1e-3 max |plain| per tensor), at most 0.85 of it,
   and inside the card tests' bf16 tolerance (1e-2 + 1e-2 |plain|);
3. with the single rounding, at the same inputs: some elements of the
   gradients fall outside that rule, which is why the kernels carry
   two terms.
"""
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as tfa

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")

#: scale * log2(e) == 1/8: the JAX wrapper's bf16 rounding of the
#: pre-scaled q is exact
SCALE = 0.125 / math.log2(math.e)
ULP_BF16 = 2.0 ** -7       # chip_smoke.py's training rule
SCALED_FRAC = 1e-3
CARD_TOL = 1e-2            # tests/test_torch_port_cuda.py's bf16 _TOL


def _inputs(seed, b, sq, sk, hq, hk, d):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for shape in
            ((b, sq, hq, d), (b, sk, hk, d), (b, sk, hk, d),
             (b, sq, hq, d))]


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _scores(q, k, causal, scale):
    """fp32 scaled scores [b, hk, g, sq, sk] and the visibility mask."""
    b, sq, hq, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, sq, hk, hq // hk, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    ok = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        ok = torch.arange(sk)[None, :] <= torch.arange(sq)[:, None] + sk - sq
    return s, ok


def _round(x, dtype, split):
    """x rounded to dtype once, or as the sum of two dtype terms."""
    hi = x.to(dtype).float()
    return hi + (x - hi).to(dtype).float() if split else hi


def _mirror_fwd(q, k, v, causal, scale, split):
    """The forward: P = exp(s - m) and l in fp32, P rounded to the input
    type (in one term, or two with ``split``) before P V."""
    b, sq, hq, d = q.shape
    hk = k.shape[2]
    s, ok = _scores(q, k, causal, scale)
    s = s.masked_fill(~ok, float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bqhgd", _round(p, q.dtype, split), v.float())
    o = o / l.permute(0, 3, 1, 2, 4).clamp_min(1e-30)
    lse = (m + torch.log(l)).reshape(b, hq, sq)
    return o.reshape(b, sq, hq, d).to(q.dtype), lse


def _mirror_bwd(q, k, v, out, lse, do, causal, scale, split):
    """The backward: P and dS in fp32, P rounded (in one term, or two
    with ``split``) before dV += P^T dO, dS before dQ and dK."""
    b, sq, hq, d = q.shape
    hk = k.shape[2]
    g = hq // hk
    s, ok = _scores(q, k, causal, scale)
    p = torch.exp(s - lse.reshape(b, hk, g, sq, 1)).masked_fill(~ok, 0.0)
    dof = do.float().reshape(b, sq, hk, g, d)
    delta = (dof * out.float().reshape(b, sq, hk, g, d)).sum(-1)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", _round(p, q.dtype, split), dof)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, v.float())
    ds = _round(p * (dp - delta.permute(0, 2, 3, 1)[..., None]), q.dtype,
                split)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, q.float().reshape(
        b, sq, hk, g, d)) * scale
    return (dq.reshape(b, sq, hq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _rel(a, r):
    """|a - r| over |r|, Frobenius, in fp32."""
    a, r = a.float(), r.float()
    return float((a - r).norm() / r.norm())


def _group_sum_of_heads(q, k, v, out, lse, do, causal, scale):
    """dk, dv as the JAX wrapper forms them under grouped-query heads:
    it repeats K and V over the group (``jnp.repeat``), so each query
    head's gradient is rounded to bf16 before the VJP of the repeat sums
    the group. The mirror's per-head gradients, summed the same way."""
    b, sk, hk, d = k.shape
    g = q.shape[2] // hk
    rep = [t.repeat_interleave(g, dim=2) for t in (k, v)]
    _, dk, dv = _mirror_bwd(q, *rep, out, lse, do, causal, scale, False)
    return [t.float().reshape(b, sk, hk, g, d).sum(3).to(k.dtype)
            for t in (dk, dv)]


@pytest.mark.parametrize("causal", [True, False])
def test_mirror_rounds_where_the_jax_kernels_round(causal):
    b, s, hq, hk, d = 2, 256, 4, 2, 64
    qn, kn, vn, don = _inputs(7 + causal, b, s, s, hq, hk, d)
    q, k, v, do = (_bf16(a) for a in (qn, kn, vn, don))
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16)
                       for a in (qn, kn, vn, don))

    def fwd(a, b_, c):
        return jfa.flash_attention(a, b_, c, causal=causal, scale=SCALE)

    jout, vjp = jax.vjp(fwd, jq, jk, jv)
    ref = [torch.from_numpy(np.array(x.astype(jnp.float32)))
           for x in (jout, *vjp(jdo))]

    out, lse = _mirror_fwd(q, k, v, causal, SCALE, False)
    dq = _mirror_bwd(q, k, v, out, lse, do, causal, SCALE, False)[0]
    mirror = [out, dq, *_group_sum_of_heads(q, k, v, out, lse, do, causal,
                                            SCALE)]
    pout, plse = tfa.flash_attention_plain(q, k, v, causal, SCALE,
                                           return_lse=True)
    plain = [pout, *tfa.flash_attention_bwd_plain(q, k, v, pout, plse, do,
                                                  causal, SCALE)]
    for name, mi, pl, r in zip(("out", "dq", "dk", "dv"), mirror, plain,
                               ref):
        # with the reference's rounding points the mirror lands on its
        # bf16 values (over 99% of elements equal), where the plain
        # version, which keeps P and dS in fp32, is an ulp off in about
        # 40%: relative error under 1e-3 and under half the plain's
        e_mirror, e_plain = _rel(mi, r), _rel(pl, r)
        assert e_mirror < 1e-3 and e_mirror < 0.5 * e_plain, \
            (name, e_mirror, e_plain)


def _outside_training_rule(mirror, plain):
    """Per tensor, the largest |mirror - plain| over chip_smoke.py's
    training rule and the count of elements above 1 of it, and whether
    every element is within the card tests' bf16 tolerance."""
    res = {}
    for name, a, r in zip(("out", "dq", "dk", "dv"), mirror, plain):
        a, r = a.float(), r.float()
        diff = (a - r).abs()
        ratio = diff / (ULP_BF16 * r.abs() + SCALED_FRAC * r.abs().max())
        card = bool((diff <= CARD_TOL + CARD_TOL * r.abs()).all())
        res[name] = (float(ratio.max()), int((ratio > 1).sum()), card)
    return res


@pytest.mark.parametrize("causal", [True, False])
def test_two_terms_meet_the_card_gates_and_one_rounding_does_not(causal):
    b, s, hq, hk, d = 2, 512, 4, 2, 64
    q, k, v, do = (_bf16(a) for a in _inputs(11 + causal, b, s, s, hq, hk,
                                              d))
    scale = 1.0 / math.sqrt(d)
    pout, plse = tfa.flash_attention_plain(q, k, v, causal, scale,
                                           return_lse=True)
    plain = [pout, *tfa.flash_attention_bwd_plain(q, k, v, pout, plse, do,
                                                  causal, scale)]
    outside = {}
    for split in (True, False):
        out, lse = _mirror_fwd(q, k, v, causal, scale, split)
        torch.testing.assert_close(lse, plse, atol=1e-4, rtol=1e-4)
        mirror = [out, *_mirror_bwd(q, k, v, out, lse, do, causal, scale,
                                    split)]
        outside[split] = _outside_training_rule(mirror, plain)
    for name, (ratio, n_out, card) in outside[True].items():
        assert ratio <= 0.85 and n_out == 0 and card, (name, ratio)
    # rounded once, as the JAX kernels do, the gradients leave the rule
    # in a few elements (the card tests' looser tolerance still holds)
    assert sum(n for _, n, _ in outside[False].values()) > 0, outside
    assert all(card for _, _, card in outside[False].values())


def test_route_refuses_what_the_kernels_do_not_take():
    """``route`` checks its arguments before it asks the built library,
    so it raises here, where nothing is built."""
    with pytest.raises(TypeError, match="float32, bfloat16"):
        tfa.route(torch.float64, 64)
    with pytest.raises(NotImplementedError, match="head_dim 48"):
        tfa.route(torch.bfloat16, 48)
