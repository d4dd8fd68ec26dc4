"""The port's fused linear + cross entropy (TPU kernel table rows 11-12)
against the JAX package's, on the CPU, inputs made with numpy from a
seed.

The JAX side runs its Pallas kernels in interpret mode, as
``tests/test_fused_ce.py`` does; the port runs the plain versions of its
kernels (CPU tensors) through its autograd Function.

Tolerances: in fp32 ce within 1e-5 and both gradients within 1e-4
(relative and absolute): the same fp32 logits and softmax, summed in
another order. In bf16 ce within 1e-4, the LSE rule (fp32 statistics of
exact bf16 products); dh and dW within one bf16 ulp of the JAX value
plus 1e-3 of the tensor's largest magnitude (both round an fp32 sum of
the same bf16-rounded d, taken in another order, so the results may sit
one rounding apart, and a d that lies on a bf16 rounding boundary may
round the other way). The slice test holds the test-tiny LM head's mean
loss and both gradients within 1e-4, and the port's own ``_fused_loss``
branches within 1e-5 of the kernel's mean loss.
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.kernels.fused_ce import fused_linear_ce as jax_ce
from paddle_tpu.models.gpt import gpt as jax_gpt
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.kernels import fused_ce as tfc
from paddle_tpu_torch.kernels import fused_linear_ce
from paddle_tpu_torch.models.gpt import gpt

N, H, V = 70, 32, 150   # deliberately not multiples of the blocks
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    h = rng.randn(N, H).astype(np.float32)
    w = (rng.randn(V, H) * 0.1).astype(np.float32)
    y = rng.randint(0, V, (N,))
    y[::7] = -1                  # deterministic ignored rows
    y[3] = -100                  # any negative label is ignored
    cot = rng.rand(N).astype(np.float32)
    return h, w, y, cot


def _jax(h, w, y, cot, dtype, vocab_major, block_n=32, block_v=64):
    jdt = _JDT[dtype]
    wl = w if vocab_major else w.T
    hj, wj = jnp.asarray(h, jdt), jnp.asarray(np.ascontiguousarray(wl), jdt)
    yj = jnp.asarray(y, jnp.int32)

    def f(hh, ww):
        return jnp.sum(jax_ce(hh, ww, yj, vocab_major, block_n, block_v)
                       * cot)

    ce = jax_ce(hj, wj, yj, vocab_major, block_n, block_v)
    gh, gw = jax.grad(f, argnums=(0, 1))(hj, wj)
    return tuple(np.asarray(a.astype(jnp.float32)) for a in (ce, gh, gw))


def _port(h, w, y, cot, dtype, vocab_major, **blocks):
    tdt = getattr(torch, dtype)
    wl = w if vocab_major else w.T
    ht = torch.tensor(h).to(tdt).requires_grad_()
    wt = torch.tensor(np.ascontiguousarray(wl)).to(tdt).requires_grad_()
    ce = fused_linear_ce(ht, wt, torch.tensor(y), vocab_major, **blocks)
    (ce * torch.tensor(cot)).sum().backward()
    assert ce.dtype == torch.float32
    assert ht.grad.dtype == tdt and wt.grad.dtype == tdt
    assert tuple(wt.grad.shape) == tuple(wl.shape)
    return tuple(t.detach().float().numpy() for t in (ce, ht.grad, wt.grad))


def _within_bf16_rule(out, ref):
    big = np.maximum(np.abs(out), np.abs(ref))
    ulp = np.ldexp(np.float32(1.0), np.frexp(big)[1] - 8)
    lim = ulp + 1e-3 * np.abs(ref).max()
    bad = ~(np.abs(out - ref) <= lim)
    assert not bad.any(), (f"{int(bad.sum())} elements beyond the bf16 rule, "
                           f"max gap {np.abs(out - ref).max()}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vocab_major", [True, False])
def test_forward_and_gradients_match_jax(dtype, vocab_major):
    h, w, y, cot = _inputs()
    ref = _jax(h, w, y, cot, dtype, vocab_major)
    out = _port(h, w, y, cot, dtype, vocab_major, block_n=32, block_v=64)
    if dtype == "float32":
        np.testing.assert_allclose(out[0], ref[0], atol=1e-5, rtol=1e-5)
        for o, r in zip(out[1:], ref[1:]):
            np.testing.assert_allclose(o, r, atol=1e-4, rtol=1e-4)
    else:
        np.testing.assert_allclose(out[0], ref[0], atol=1e-4, rtol=1e-4)
        for o, r in zip(out[1:], ref[1:]):
            _within_bf16_rule(o, r)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ignored_rows_are_zero_with_zero_dh_rows(dtype):
    h, w, y, cot = _inputs(1)
    ce, dh, _ = _port(h, w, y, cot, dtype, True)
    ignored = y < 0
    assert ignored.sum() == 11
    assert np.all(ce[ignored] == 0.0)
    assert np.all(dh[ignored] == 0.0)
    assert np.all(dh[~ignored].any(axis=1))


def test_label_past_the_vocab_gives_the_jax_value():
    """A label >= V names no column: the JAX kernel sums no logit for it
    once it also lies past the padded last block (V 150 pads to 192 at
    block_v 64), so gold is 0 and ce = lse; the port gives the same at
    any label >= V."""
    h, w, y, cot = _inputs(2)
    y[4], y[9] = V + 100, V + 1000
    ref = _jax(h, w, y, cot, "float32", True)
    out = _port(h, w, y, cot, "float32", True)
    np.testing.assert_allclose(out[0], ref[0], atol=1e-5, rtol=1e-5)
    for o, r in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(o, r, atol=1e-4, rtol=1e-4)
    lse, _ = tfc.ce_fwd_plain(torch.tensor(h), torch.tensor(w),
                              torch.tensor(y))
    np.testing.assert_allclose(out[0][[4, 9]], lse.numpy()[[4, 9]],
                               rtol=0, atol=0)


def test_labels_get_no_gradient_and_blocks_change_nothing():
    h, w, y, cot = _inputs(3)
    a = _port(h, w, y, cot, "float32", True, block_n=32, block_v=64)
    b = _port(h, w, y, cot, "float32", True, block_n=8, block_v=1024)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
    # the JAX kernel at other blocks differs by fp32 rounding only
    ref = _jax(h, w, y, cot, "float32", True, block_n=16, block_v=128)
    np.testing.assert_allclose(a[0], ref[0], atol=1e-5, rtol=1e-5)
    for o, r in zip(a[1:], ref[1:]):
        np.testing.assert_allclose(o, r, atol=1e-4, rtol=1e-4)
    yt = torch.tensor(y)
    ht = torch.tensor(h, requires_grad=True)
    ce = fused_linear_ce(ht, torch.tensor(w), yt)
    assert ce.grad_fn is not None and not yt.requires_grad
    grads = torch.autograd.grad(ce.sum(), ht)
    assert grads[0].shape == ht.shape
    with pytest.raises(ValueError, match="block_v"):
        fused_linear_ce(ht, torch.tensor(w), yt, block_v=0)


def test_plain_versions_count_and_agree_with_the_autograd_function():
    h, w, y, cot = _inputs(4)
    ht, wt, yt = torch.tensor(h), torch.tensor(w), torch.tensor(y)
    tfc.reset_counts()
    lse, ce = tfc.ce_fwd(ht, wt, yt)
    dh, dw = tfc.ce_bwd(ht, wt, yt, lse, torch.tensor(cot))
    assert (tfc.ce_fwd_plain.calls, tfc.ce_bwd_plain.calls) == (1, 1)
    assert (tfc.ce_fwd.launches, tfc.ce_bwd.launches) == (0, 0)
    out = _port(h, w, y, cot, "float32", True)
    np.testing.assert_array_equal(ce.numpy(), out[0])
    np.testing.assert_array_equal(dh.numpy(), out[1])
    np.testing.assert_array_equal(dw.numpy(), out[2])
    # row chunks of the plain versions change nothing
    old = tfc._PLAIN_CHUNK
    try:
        tfc._PLAIN_CHUNK = 3 * V
        lse2, ce2 = tfc.ce_fwd(ht, wt, yt)
        dh2, dw2 = tfc.ce_bwd(ht, wt, yt, lse2, torch.tensor(cot))
    finally:
        tfc._PLAIN_CHUNK = old
    # (dW's fp32 row sums then run in another order)
    for a, b in ((ce2, ce), (dh2, dh), (dw2, dw)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                   rtol=1e-6)


def test_wrappers_refuse_what_they_do_not_take():
    h = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="do not agree"):
        tfc.ce_fwd(h, torch.zeros(10, 9), torch.zeros(4, dtype=torch.long))
    with pytest.raises(TypeError, match="integers"):
        tfc.ce_fwd(h, torch.zeros(10, 8), torch.zeros(4))
    with pytest.raises(ValueError, match="lse and dce"):
        tfc.ce_bwd(h, torch.zeros(10, 8), torch.zeros(4, dtype=torch.long),
                   torch.zeros(3), torch.zeros(4))


# ------------------------------------------------------------ the slice

@pytest.fixture(scope="module")
def tiny_head():
    """test-tiny's final hidden states and tied wte from the JAX model
    (fused LM loss on), with labels shifted as the LM loss shifts them."""
    paddle.seed(0)
    jm = jax_gpt("test-tiny", fused_lm_loss=True)
    tm = gpt("test-tiny", device="cpu", fused_lm_loss=True)
    load_reference_state(tm, {k: np.asarray(v._data)
                              for k, v in jm.state_dict().items()})
    rng = np.random.RandomState(5)
    ids = rng.randint(0, 512, (2, 40))
    labels = ids.copy()
    labels[0, 5:9] = -100
    jh, jw = jm(paddle.to_tensor(ids.astype(np.int32)))
    with torch.no_grad():
        th, tw = tm(torch.as_tensor(ids))
    return dict(jh=np.asarray(jh._data), jw=np.asarray(jw._data),
                th=th.numpy(), tw=tw.detach().numpy(), labels=labels, tm=tm)


def _mean_loss(ce, y):
    valid = (y >= 0)
    return ce.sum() / valid.sum().clamp_min(1)


def test_slice_lm_head_matches_jax_and_the_port_loss_branches(tiny_head):
    d = tiny_head
    np.testing.assert_allclose(d["th"], d["jh"], atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(d["tw"], d["jw"])
    b, s, hd = d["jh"].shape
    y = d["labels"][:, 1:].reshape(-1)

    def jloss(hh, ww):
        ce = jax_ce(hh[:, :-1].reshape(-1, hd), ww,
                    jnp.asarray(y, jnp.int32), True, 32, 64)
        valid = (jnp.asarray(y) >= 0).astype(jnp.float32)
        return jnp.sum(ce) / jnp.maximum(jnp.sum(valid), 1.0)

    jl, (jgh, jgw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(d["jh"]), jnp.asarray(d["jw"]))

    th = torch.tensor(d["jh"], requires_grad=True)
    tw = torch.tensor(d["jw"], requires_grad=True)
    yt = torch.as_tensor(y)
    loss = _mean_loss(fused_linear_ce(th[:, :-1].reshape(-1, hd), tw, yt),
                      yt)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw),
                               atol=1e-4, rtol=1e-4)

    # the port's own _fused_loss, saved-logits and chunked branches
    tm = d["tm"]
    hidden = torch.tensor(d["jh"], requires_grad=True)
    labels = torch.as_tensor(d["labels"])
    cfg = tm.cfg
    for chunk, budget in ((1024, 4 << 30), (16, 0)):
        old = (cfg.lm_loss_chunk, cfg.lm_loss_save_logits_budget)
        cfg.lm_loss_chunk, cfg.lm_loss_save_logits_budget = chunk, budget
        try:
            ref = tm._fused_loss(hidden, labels, torch.tensor(d["jw"]))
        finally:
            cfg.lm_loss_chunk, cfg.lm_loss_save_logits_budget = old
        np.testing.assert_allclose(loss.item(), ref.item(), atol=1e-5,
                                   rtol=1e-5)


def test_kernel_module_imports_no_jax():
    code = ("import sys, paddle_tpu_torch.kernels.fused_ce; "
            "from paddle_tpu_torch.kernels import fused_linear_ce; "
            "import paddle_tpu_torch.nn.layers_wrap; "
            "from paddle_tpu_torch.nn import functional as F; "
            "F.edit_distance; F.ctc_loss; "
            "assert 'jax' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True)
