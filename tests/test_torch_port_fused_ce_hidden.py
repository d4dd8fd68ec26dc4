"""The port's fused linear + cross entropy at hidden sizes the card's
kernels once refused (past 768, or not a multiple of 8), against the
JAX package's ``fused_linear_ce`` in interpret mode, on the CPU, inputs
made with numpy from a seed; and the wrapper's zero padding of such a
hidden size for the kernels.

Tolerances, as in ``tests/test_torch_port_fused_ce.py``: fp32 ce within
1e-5 and both gradients within 1e-4 (the same fp32 logits and softmax,
summed in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.fused_ce import fused_linear_ce as jax_ce
from paddle_tpu_torch.kernels import fused_ce as tfc
from paddle_tpu_torch.kernels import fused_linear_ce

N, V = 40, 130


def _inputs(hd, seed=0):
    rng = np.random.RandomState(seed + hd)
    h = rng.randn(N, hd).astype(np.float32)
    w = (rng.randn(V, hd) * hd ** -0.5).astype(np.float32)
    y = rng.randint(0, V, (N,))
    y[::7] = -1
    cot = rng.rand(N).astype(np.float32)
    return h, w, y, cot


@pytest.mark.parametrize("hd", [100, 1024, 1600])
@pytest.mark.parametrize("vocab_major", [True, False])
def test_wide_and_ragged_hidden_sizes_match_jax(hd, vocab_major):
    h, w, y, cot = _inputs(hd)
    wl = np.ascontiguousarray(w if vocab_major else w.T)
    yj = jnp.asarray(y, jnp.int32)

    def f(hh, ww):
        return jnp.sum(jax_ce(hh, ww, yj, vocab_major, 16, 64) * cot)

    hj, wj = jnp.asarray(h), jnp.asarray(wl)
    ref_ce = np.asarray(jax_ce(hj, wj, yj, vocab_major, 16, 64))
    ref_gh, ref_gw = (np.asarray(g) for g in
                      jax.grad(f, argnums=(0, 1))(hj, wj))
    ht = torch.tensor(h, requires_grad=True)
    wt = torch.tensor(wl, requires_grad=True)
    tfc.reset_counts()
    ce = fused_linear_ce(ht, wt, torch.tensor(y), vocab_major)
    (ce * torch.tensor(cot)).sum().backward()
    assert (tfc.ce_fwd_plain.calls, tfc.ce_bwd_plain.calls) == (1, 1)
    np.testing.assert_allclose(ce.detach().numpy(), ref_ce, atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(ht.grad.numpy(), ref_gh, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(wt.grad.numpy(), ref_gw, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("hd,padded", [(100, 104), (1600, 1600), (13, 16)])
@pytest.mark.parametrize("vocab_major", [True, False])
def test_kernel_operands_pad_the_hidden_size_with_zeros(hd, padded,
                                                        vocab_major):
    """The kernels take H as whole 16-byte chunks: the wrapper pads h and
    [V, H] W with zero columns to a multiple of 8, which changes no logit
    (the plain version on the padded operands gives the unpadded ce and,
    cut back by ``_unpad``, the unpadded gradients)."""
    h, w, y, cot = _inputs(hd, seed=1)
    wl = torch.tensor(np.ascontiguousarray(w if vocab_major else w.T))
    code, hp, wp, y32 = tfc._kernel_operands(torch.tensor(h), wl,
                                             torch.tensor(y), vocab_major)
    assert code == 0 and y32.dtype == torch.int32
    assert tuple(hp.shape) == (N, padded) and tuple(wp.shape) == (V, padded)
    assert hp.is_contiguous() and wp.is_contiguous()
    assert not hp[:, hd:].any() and not wp[:, hd:].any()
    torch.testing.assert_close(hp[:, :hd], torch.tensor(h), rtol=0, atol=0)
    yt, dce = torch.tensor(y), torch.tensor(cot)
    lse, ce = tfc.ce_fwd_plain(torch.tensor(h), torch.tensor(w), yt)
    lse_p, ce_p = tfc.ce_fwd_plain(hp, wp, yt)
    torch.testing.assert_close(ce_p, ce, atol=1e-6, rtol=1e-6)
    dh, dw = tfc.ce_bwd_plain(torch.tensor(h), torch.tensor(w), yt, lse, dce)
    dh_p, dw_p = tfc.ce_bwd_plain(hp, wp, yt, lse_p, dce)
    assert not dh_p[:, hd:].any() and not dw_p[:, hd:].any()
    torch.testing.assert_close(tfc._unpad(dh_p, hd), dh, atol=1e-6,
                               rtol=1e-6)
    torch.testing.assert_close(tfc._unpad(dw_p, hd), dw, atol=1e-6,
                               rtol=1e-6)
