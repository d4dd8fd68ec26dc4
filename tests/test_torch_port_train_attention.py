"""The port's differentiable flash attention on the CPU (its plain
backward, which is what runs there) against the JAX package's custom
VJP.

The same inputs and output cotangent, drawn from a seed with numpy, go
through ``jax.vjp`` of the JAX ``flash_attention`` (its Pallas backward
in interpret mode, as tests/test_kernels.py runs it), or of its XLA
attention ``_sdpa_xla`` where the JAX wrapper refuses the shape, and
through the port: both ``flash_attention_bwd_plain`` directly and
``torch.autograd.grad`` through ``flash_attention``. All in fp32. The
tolerance (1e-4) allows for fp32 sums in another order: a gradient sums
over a whole row or column of the score matrix, more terms than one
output element. The CUDA kernel is held to the plain backward on the
card in tests/test_torch_port_cuda.py.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional.attention import _sdpa_xla
from paddle_tpu_torch.kernels import flash_attention as tfa

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")

TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(seed, b, sq, sk, hq, hk, d):
    rng = np.random.RandomState(seed)
    f = np.float32
    return (rng.randn(b, sq, hq, d).astype(f), rng.randn(b, sk, hk, d)
            .astype(f), rng.randn(b, sk, hk, d).astype(f),
            rng.randn(b, sq, hq, d).astype(f))


def _jax_grads(fn, q, k, v, do):
    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port_grads(q, k, v, do, causal):
    """(autograd through flash_attention, flash_attention_bwd_plain)."""
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(qt, kt, vt, causal=causal)
    auto = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    with torch.no_grad():
        o, lse = tfa.flash_attention(qt, kt, vt, causal=causal,
                                     return_lse=True)
        plain = tfa.flash_attention_bwd_plain(qt, kt, vt, o, lse,
                                              torch.from_numpy(do), causal)
    return [g.numpy() for g in auto], [g.numpy() for g in plain]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk,hq,hk", [
    (128, 128, 2, 2),
    (128, 256, 2, 2),     # cross length: diagonal aligned bottom-right
    (128, 128, 4, 2),     # grouped-query heads
])
def test_flash_backward_matches_pallas(causal, sq, sk, hq, hk):
    q, k, v, do = _inputs(sq + sk + 10 * hq + hk + causal, 2, sq, sk, hq,
                          hk, 64)
    ref = _jax_grads(lambda a, b, c: jfa.flash_attention(a, b, c,
                                                         causal=causal),
                     q, k, v, do)
    auto, plain = _port_grads(q, k, v, do, causal)
    for name, r, a, p in zip("qkv", ref, auto, plain):
        np.testing.assert_allclose(p, r, err_msg=f"plain d{name}", **TOL)
        np.testing.assert_allclose(a, r, err_msg=f"autograd d{name}", **TOL)


@pytest.mark.parametrize("sq,sk,hq,hk", [(100, 100, 2, 2), (37, 100, 4, 2),
                                         (100, 130, 2, 1)])
def test_ragged_causal_backward_matches_xla_reference(sq, sk, hq, hk):
    """Causal lengths off the 128 grid, which the JAX kernel refuses,
    against jax.vjp of the JAX package's XLA attention (GQA by an
    explicit repeat of the kv heads there)."""
    q, k, v, do = _inputs(sq * 3 + sk + hq, 2, sq, sk, hq, hk, 32)
    with pytest.raises(NotImplementedError):
        jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=True)
    g = hq // hk

    def xla(a, b, c):
        return _sdpa_xla(a, jnp.repeat(b, g, axis=2), jnp.repeat(c, g, axis=2),
                         is_causal=True)

    ref = _jax_grads(xla, q, k, v, do)
    auto, plain = _port_grads(q, k, v, do, True)
    for name, r, a, p in zip("qkv", ref, auto, plain):
        np.testing.assert_allclose(p, r, err_msg=f"plain d{name}", **TOL)
        np.testing.assert_allclose(a, r, err_msg=f"autograd d{name}", **TOL)


def test_fully_masked_rows_give_zero_gradients():
    """sq > sk causal: the leading sq - sk rows see no key (lse = -inf);
    their dq is exactly zero and nothing is NaN."""
    q, k, v, do = _inputs(4, 1, 20, 12, 2, 2, 16)
    auto, plain = _port_grads(q, k, v, do, True)
    for g in auto + plain:
        assert np.isfinite(g).all()
    assert np.all(plain[0][:, :8] == 0.0) and np.all(auto[0][:, :8] == 0.0)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_function_gradcheck_float64(causal):
    """float64 gradcheck of the autograd Function at a tiny ragged GQA
    shape (the plain versions keep float64 inputs in float64)."""
    rng = np.random.RandomState(11)
    q = torch.tensor(rng.randn(2, 9, 4, 8), requires_grad=True)
    k = torch.tensor(rng.randn(2, 6, 2, 8), requires_grad=True)
    v = torch.tensor(rng.randn(2, 6, 2, 8), requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, b, c: tfa._FlashAttentionFn.apply(a, b, c, causal,
                                                    None)[0], (q, k, v))


def test_output_grad_fn_is_the_flash_backward():
    """Training attention records the flash Function on every device
    (before, the CPU recorded the plain einsum chain and the card
    recorded nothing); under no_grad nothing is recorded or saved."""
    q, k, v, _ = _inputs(5, 1, 16, 16, 2, 2, 16)
    qt = torch.from_numpy(q).requires_grad_()
    out = tfa.flash_attention(qt, torch.from_numpy(k), torch.from_numpy(v),
                              causal=True)
    assert out.requires_grad
    assert type(out.grad_fn) is tfa._FlashAttentionFn._backward_cls
    with torch.no_grad():
        out = tfa.flash_attention(qt, torch.from_numpy(k),
                                  torch.from_numpy(v), causal=True)
    assert out.grad_fn is None


def test_cpu_backward_takes_the_plain_version():
    tfa.reset_counts()
    q, k, v, do = _inputs(6, 1, 16, 16, 2, 2, 16)
    _port_grads(q, k, v, do, True)
    assert tfa.flash_attention_bwd_plain.calls == 2
    assert tfa.flash_attention_bwd.launches == 0
    assert tfa.flash_attention.launches == 0


def test_backward_refuses_bad_inputs():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(7, 1, 8, 8, 2, 2,
                                                         16))
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="dout"):
        tfa.flash_attention_bwd(q, k, v, q, lse, do[:, :4])
    with pytest.raises(ValueError, match="lse"):
        tfa.flash_attention_bwd(q, k, v, q, lse[:, :1], do)
    with pytest.raises(TypeError):
        tfa.flash_attention_bwd(q, k, v, q.double(), lse, do)
