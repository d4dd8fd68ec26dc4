"""The port's GPT training loss and gradients against the JAX package's,
on test-tiny in fp32 with the JAX weights carried across by
``convert.load_reference_state``.

The JAX side takes ``jax.value_and_grad`` of the loss through
``paddle_tpu.jit.api.functional_call`` (as its ``TrainStep`` does); the
port takes ``loss.backward()``. Three loss branches: the unfused
``cross_entropy`` on full logits; the fused loss with one saved-logits
chunk; the fused chunk scan with per-chunk recompute and a ragged last
chunk. Tolerances: the loss within 1e-5 and every gradient within
1e-5 absolute + 1e-4 relative — fp32 arithmetic in both, summed in
another order (XLA against PyTorch's CPU BLAS) over two layers.
"""
import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.jit.api import functional_call
from paddle_tpu.models.gpt import gpt as jax_gpt
from paddle_tpu.nn.functional.loss import cross_entropy as jax_ce
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.models.gpt import gpt
from paddle_tpu_torch.nn.functional import cross_entropy

GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


def _arrays(jax_model):
    return {k: np.asarray(v._data) for k, v in jax_model.state_dict().items()}


def _pair(seed=0, **overrides):
    paddle.seed(seed)
    jm = jax_gpt("test-tiny", **overrides)
    tm = gpt("test-tiny", device="cpu", **overrides)
    load_reference_state(tm, _arrays(jm))
    return jm, tm


def _jax_loss_and_grads(jm, ids, labels):
    names = [n for n, _ in jm.named_parameters()]
    vals = [p._data for _, p in jm.named_parameters()]
    x = paddle.to_tensor(ids.astype(np.int32))
    y = paddle.to_tensor(labels.astype(np.int32))

    def loss_of(pvals):
        out = functional_call(jm, dict(zip(names, pvals)), x)
        return jm.loss(out, y)._data

    loss, grads = jax.value_and_grad(loss_of)(vals)
    return float(loss), dict(zip(names, (np.asarray(g) for g in grads)))


@pytest.mark.parametrize("case", ["unfused", "saved_logits", "chunk_scan"])
def test_loss_and_every_gradient_match(case):
    overrides = {
        "unfused": {},
        "saved_logits": dict(fused_lm_loss=True, lm_loss_chunk=1024),
        # 39 shifted positions in chunks of 16: 16 + 16 + 7
        "chunk_scan": dict(fused_lm_loss=True, lm_loss_chunk=16,
                           lm_loss_save_logits_budget=0),
    }[case]
    jm, tm = _pair(**overrides)
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 512, (2, 40))
    labels = ids.copy()
    labels[0, 5:9] = -100                       # ignored positions
    ref_loss, ref_grads = _jax_loss_and_grads(jm, ids, labels)
    loss = tm.loss(tm(torch.as_tensor(ids)), torch.as_tensor(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref_loss, atol=1e-5, rtol=1e-5)
    names = [n for n, _ in tm.named_parameters()]
    assert names == list(ref_grads)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name],
                                   err_msg=name, **GRAD_TOL)


def test_fused_forward_returns_hidden_and_head_weight():
    _, tm = _pair(fused_lm_loss=True)
    h, w = tm(torch.zeros((1, 5), dtype=torch.long))
    assert h.shape == (1, 5, 64)
    assert w is tm.gpt.embed.wte.weight
    with torch.no_grad():                        # generation: real logits
        logits, _ = tm(torch.zeros((1, 5), dtype=torch.long),
                       use_cache=True)
    assert logits.shape == (1, 1, 512)


def test_untied_chunk_scan_matches():
    """An untied head ([in, vocab] weight) through the chunk scan."""
    jm, tm = _pair(seed=1, tie_word_embeddings=False, fused_lm_loss=True,
                   lm_loss_chunk=8, lm_loss_save_logits_budget=0)
    ids = np.random.RandomState(4).randint(0, 512, (2, 21))
    ref_loss, ref_grads = _jax_loss_and_grads(jm, ids, ids)
    loss = tm.loss(tm(torch.as_tensor(ids)), torch.as_tensor(ids))
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref_loss, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tm.lm_head.weight.grad.numpy(),
                               ref_grads["lm_head.weight"], **GRAD_TOL)


def test_flops_per_token_matches():
    jm, tm = _pair()
    assert tm.flops_per_token(128) == jm.flops_per_token(128)
    assert tm.num_params() == jm.num_params()


@pytest.mark.parametrize("kw", [
    dict(),
    dict(reduction="sum"),
    dict(reduction="none"),
    dict(ignore_index=3),
    dict(ignore_index=3, reduction="none"),
    dict(soft_label=True),
    dict(soft_label=True, reduction="none", axis=1),
])
def test_cross_entropy_matches(kw):
    rng = np.random.RandomState(5)
    axis = kw.get("axis", -1)
    logits = rng.randn(6, 7, 5).astype(np.float32)
    n_cls = logits.shape[axis]
    if kw.get("soft_label"):
        lbl = rng.rand(*logits.shape).astype(np.float32)
        lbl /= lbl.sum(axis=axis, keepdims=True)
    else:
        shape = list(logits.shape)
        del shape[axis]
        lbl = rng.randint(0, n_cls, shape)
        lbl[0, 0] = kw.get("ignore_index", -100)
        lbl[1, 1] = 3
    ref = jax_ce(jnp.asarray(logits), jnp.asarray(lbl), **kw)
    ref = np.asarray(getattr(ref, "_data", ref))
    out = cross_entropy(torch.from_numpy(logits), torch.as_tensor(lbl),
                        **kw).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)


def test_cross_entropy_unported_options_raise():
    x, y = torch.zeros(2, 3), torch.zeros(2, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cross_entropy(x, y, weight=torch.ones(3))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cross_entropy(x, y, label_smoothing=0.1)
