"""The port's AMP (``amp.auto_cast``, ``decorate``, ``GradScaler``)
against the JAX package's, on the CPU.

Cast decisions: the JAX package casts in its op dispatch, which calls
``paddle_tpu.amp.auto_cast.maybe_cast_args(name, leaves)`` for every op
under ``auto_cast`` (looked up at call time, so the test wraps the
module attribute; no JAX file changes). The port calls
``amp.maybe_cast(name, *tensors)`` at the head of each function whose
JAX counterpart dispatches under a listed name. On test-tiny GPT's
forward and loss (both loss branches, O1 and O2) and on a small fused
ResNet's, the two see the same listed names in the same order with the
same floating input dtypes. Names on neither list take their inputs as
they come in both packages and are left out of the comparison; integer
inputs (labels: int32 in the JAX test, int64 here) are left out too.

Numbers: a budget of one ulp of the JAX value plus 1e-3 of the largest
|value| per op on the path. The O1 and O2 logits, in bf16 or fp16, are
held to four such budgets, though 16 ops round on their path (7 in each
of the 2 blocks, ln_f, the head); measured, O2 in bf16 (every op
rounds to bf16) reaches 2.8 of them, O1 2.1, fp16 0.5. The loss (one
fp32 cross entropy on those logits) within 1e-3 of its value.
``GradScaler``: a scripted run of finite and non-finite gradients gives
the JAX scaler's scale trajectory, skipped steps, ``state_dict`` and
``amp.scaler.*`` values exactly, and its parameters within 1e-6.
"""
import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptim
from paddle_tpu.core import metrics as jmetrics
from paddle_tpu.models.gpt import gpt as jax_gpt
import paddle_tpu.models.resnet as jresnet
from paddle_tpu_torch import amp
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.core import flags, metrics
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.models.gpt import gpt
from paddle_tpu_torch.nn import CrossEntropyLoss, Linear

jac = importlib.import_module("paddle_tpu.amp.auto_cast")
tac = importlib.import_module("paddle_tpu_torch.amp.auto_cast")
LISTED = jac.WHITE_LIST | jac.BLACK_LIST
FLOATS = ("float32", "float16", "bfloat16")


def _arrays(jax_model):
    return {k: np.asarray(v._data) for k, v in jax_model.state_dict().items()}


def _gpt_pair(**overrides):
    paddle.seed(0)
    jm = jax_gpt("test-tiny", **overrides)
    tm = gpt("test-tiny", device="cpu", **overrides)
    load_reference_state(tm, _arrays(jm))
    return jm, tm


def _recorders(monkeypatch):
    """Wrap both cast hooks; each appends (name, float dtypes) for a
    listed name."""
    seen = {"jax": [], "port": []}
    j_orig, t_orig = jac.maybe_cast_args, amp.maybe_cast

    def j_spy(name, leaves):
        if name in LISTED:
            seen["jax"].append((name, tuple(
                str(l.dtype) for l in leaves
                if hasattr(l, "dtype") and str(l.dtype) in FLOATS)))
        return j_orig(name, leaves)

    def t_spy(name, *tensors):
        assert name in LISTED, name
        seen["port"].append((name, tuple(
            str(t.dtype).replace("torch.", "") for t in tensors
            if isinstance(t, torch.Tensor) and t.is_floating_point())))
        return t_orig(name, *tensors)

    monkeypatch.setattr(jac, "maybe_cast_args", j_spy)
    monkeypatch.setattr(amp, "maybe_cast", t_spy)
    return seen


def _gpt_run(level, dtype, fused):
    jm, tm = _gpt_pair(fused_lm_loss=fused)
    if level == "O2":
        paddle.amp.decorate(jm, level="O2", dtype=dtype)
        amp.decorate(tm, level="O2", dtype=dtype)
    ids = np.random.RandomState(0).randint(0, 512, (2, 16))
    with paddle.amp.auto_cast(level=level, dtype=dtype):
        jx = paddle.to_tensor(ids.astype(np.int32))
        jo = jm(jx)
        jl = jm.loss(jo, jx)
    x = torch.as_tensor(ids)
    with amp.auto_cast(level=level, dtype=dtype):
        to = tm(x)
        tl = tm.loss(to, x)
    return jo, jl, to, tl


AMP_CASES = [("O1", "bfloat16"), ("O2", "bfloat16"), ("O2", "float16")]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("level,dtype", AMP_CASES)
def test_gpt_cast_decisions_match_jax(monkeypatch, level, dtype, fused):
    seen = _recorders(monkeypatch)
    _gpt_run(level, dtype, fused)
    assert seen["port"] == seen["jax"]
    names = [n for n, _ in seen["jax"]]
    # 2 blocks: 5 layer norms, 8 trunk linears, 2 attentions; the head
    # and the cross entropy unless the loss is fused
    assert names.count("layer_norm") == 5
    assert names.count("scaled_dot_product_attention") == 2
    assert names.count("linear") == (8 if fused else 9)
    assert names.count("cross_entropy") == (0 if fused else 1)


def test_resnet_cast_decisions_match_jax(monkeypatch):
    paddle.seed(7)
    kw = dict(num_classes=10, data_format="NHWC", fused_bn=True,
              stem_space_to_depth=True)
    jm = jresnet.ResNet(jresnet.BottleneckBlock, [2, 1, 1, 2], **kw)
    tm = tresnet.ResNet(tresnet.BottleneckBlock, [2, 1, 1, 2],
                        device="cpu", **kw)
    load_reference_state(tm, _arrays(jm))
    jm.train()
    tm.train()
    rng = np.random.RandomState(8)
    img = rng.randn(2, 3, 64, 64).astype(np.float32)
    lbl = np.array([1, 2])
    seen = _recorders(monkeypatch)
    with paddle.amp.auto_cast():
        jnn.CrossEntropyLoss()(jm(paddle.to_tensor(img)),
                               paddle.to_tensor(lbl))
    with amp.auto_cast():
        loss = CrossEntropyLoss()(tm(torch.tensor(img)), torch.tensor(lbl))
    assert seen["port"] == seen["jax"]
    # the stem and the 3 stride-2 3x3s on the ordinary conv, the stem's
    # batch norm, the head and the loss
    assert [n for n, _ in seen["jax"]] == [
        "conv2d", "batch_norm_train", "conv2d", "conv2d", "conv2d",
        "linear", "cross_entropy"]
    assert loss.dtype == torch.float32


@pytest.mark.parametrize("level,dtype", AMP_CASES)
def test_gpt_logits_and_loss_match_jax(level, dtype):
    jo, jl, to, tl = _gpt_run(level, dtype, fused=False)
    ref = np.asarray(jo._data).astype(np.float32)
    out = to.detach()
    assert out.dtype == getattr(torch, dtype)
    out = out.float().numpy()
    mant = 7 if dtype == "bfloat16" else 10
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - mant)
    tol = 4 * (ulp + 1e-3 * np.abs(ref).max())
    assert (np.abs(out - ref) <= tol).all(), np.abs(out - ref).max()
    j_loss = float(np.asarray(jl._data))
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.item(), j_loss, rtol=1e-3)


@pytest.mark.parametrize("level,dtype", AMP_CASES)
def test_fused_loss_matches_jax(level, dtype):
    _, jl, _, tl = _gpt_run(level, dtype, fused=True)
    np.testing.assert_allclose(tl.item(), float(np.asarray(jl._data)),
                               rtol=1e-3)


def test_state_lists_and_flag():
    """The port keeps the JAX lists; ``dtype`` defaults to the flag
    ``amp_dtype``; custom lists move names; the state nests and comes
    back."""
    assert tac.WHITE_LIST == jac.WHITE_LIST
    assert tac.BLACK_LIST == jac.BLACK_LIST
    assert not amp.is_autocast_enabled()
    assert amp.get_autocast_dtype() == torch.bfloat16
    assert amp.get_autocast_level() == "O1"
    old = flags.get_flag("amp_dtype")
    try:
        flags.set_flags({"amp_dtype": "float16"})
        with amp.auto_cast(custom_white_list={"layer_norm"},
                           custom_black_list={"linear"}):
            assert amp.is_autocast_enabled()
            assert amp.get_autocast_dtype() == torch.float16
            x = torch.ones(2)
            assert amp.maybe_cast("layer_norm", x)[0].dtype == torch.float16
            assert amp.maybe_cast("linear", x.half())[0].dtype == \
                torch.float32
            with amp.amp_guard(enable=False, level="O2"):
                assert not amp.is_autocast_enabled()
                assert amp.get_autocast_level() == "O2"
                assert amp.maybe_cast("conv2d", x)[0] is x
            assert amp.get_autocast_level() == "O1"
    finally:
        flags.set_flags({"amp_dtype": old})
    assert not amp.is_autocast_enabled()


def test_maybe_cast_leaves_other_dtypes():
    with amp.auto_cast():
        i = torch.ones(2, dtype=torch.int64)
        d = torch.ones(2, dtype=torch.float64)
        out = amp.maybe_cast("linear", i, d, None)
        assert out[0] is i and out[1] is d and out[2] is None
        h = torch.ones(2, dtype=torch.float16)
        assert amp.maybe_cast("linear", h)[0].dtype == torch.bfloat16
        assert amp.maybe_cast("gelu", h)[0] is h


def test_decorate_casts_models_in_place():
    _, tm = _gpt_pair()
    params = list(tm.parameters())
    opt = toptim.AdamW(1e-3, parameters=params, multi_precision=True)
    out = amp.decorate(tm, optimizers=opt, level="O2", dtype="float16")
    assert out == (tm, opt)
    assert all(p.dtype == torch.float16 for p in tm.parameters())
    assert [id(p) for p in tm.parameters()] == [id(p) for p in params]
    both = amp.decorate([tm, None], dtype="bfloat16")
    assert both[0] is tm
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())


# ------------------------------------------------------------ GradScaler

@pytest.fixture
def clean_registries():
    saved, was_on = jmetrics.all_metrics(), jmetrics.is_enabled()

    def clear():
        for m in (jmetrics, metrics):
            m.disable()
            with m._registry_lock:
                m._metrics.clear()

    clear()
    try:
        yield
    finally:
        clear()
        with jmetrics._registry_lock:
            jmetrics._metrics.update(saved)
        if was_on:
            jmetrics.enable()


def _scripted(pkg, bad_steps):
    """8 eager steps of a Linear(4, 3) with a GradScaler (scale 8,
    growth every 2 good steps, shrink after 1 bad one); on each step
    of ``bad_steps`` one gradient element is set to inf. Returns the
    scale after each step, the state dict, the parameters."""
    rng = np.random.RandomState(0)
    w0 = rng.randn(4, 3).astype(np.float32)
    x = rng.randn(5, 4).astype(np.float32)
    if pkg == "jax":
        paddle.seed(0)
        m = jnn.Linear(4, 3)
        m.weight.set_value(w0)
        opt = joptim.SGD(learning_rate=0.1, parameters=m.parameters())
        scaler = paddle.amp.GradScaler(init_loss_scaling=8.0,
                                       incr_every_n_steps=2,
                                       decr_every_n_nan_or_inf=1)
        xt = paddle.to_tensor(x)
    else:
        m = Linear(4, 3, device="cpu")
        with torch.no_grad():
            m.weight.copy_(torch.from_numpy(w0))
            m.bias.zero_()
        opt = toptim.SGD(learning_rate=0.1, parameters=m.parameters())
        scaler = amp.GradScaler(init_loss_scaling=8.0, incr_every_n_steps=2,
                                decr_every_n_nan_or_inf=1)
        xt = torch.from_numpy(x)
    scales = []
    for i in range(8):
        loss = (m(xt) * m(xt)).mean()
        scaler.scale(loss).backward()
        if i in bad_steps:
            if pkg == "jax":
                g = np.asarray(m.weight.grad.numpy()).copy()
                g[1, 2] = np.inf
                m.weight.grad = paddle.to_tensor(g)
            else:
                m.weight.grad[1, 2] = float("inf")
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        scales.append(scaler.get_loss_scaling())
    w = np.asarray(m.weight.numpy() if pkg == "jax"
                   else m.weight.detach().numpy())
    return scales, scaler.state_dict(), w


def test_grad_scaler_matches_jax(clean_registries):
    bad = (1, 2, 5)
    jmetrics.enable()
    metrics.enable()
    j_scales, j_sd, j_w = _scripted("jax", bad)
    t_scales, t_sd, t_w = _scripted("port", bad)
    assert t_scales == j_scales
    assert j_scales == [8.0, 4.0, 2.0, 2.0, 4.0, 2.0, 2.0, 4.0]
    assert t_sd == j_sd
    np.testing.assert_allclose(t_w, j_w, atol=1e-6, rtol=1e-6)
    j_snap, t_snap = jmetrics.snapshot(), metrics.snapshot()
    for key in ("amp.scaler.steps", "amp.scaler.skipped", "amp.loss_scale"):
        assert t_snap[key]["value"] == j_snap[key]["value"], key
    assert t_snap["amp.scaler.steps"]["value"] == 8
    assert t_snap["amp.scaler.skipped"]["value"] == len(bad)


def test_grad_scaler_state_dict_round_trip_and_disabled():
    s = amp.GradScaler(init_loss_scaling=64.0)
    s._good_steps, s._bad_steps = 3, 1
    t = amp.GradScaler()
    t.load_state_dict(s.state_dict())
    assert t.state_dict() == s.state_dict()
    off = amp.GradScaler(enable=False)
    assert not off.is_enable() and off.get_loss_scaling() == 1.0
    x = torch.ones(2)
    assert off.scale(x) is x
    m = Linear(2, 2, device="cpu")
    opt = toptim.SGD(learning_rate=0.1, parameters=m.parameters())
    m(x[None]).sum().backward()
    w = m.weight.detach().clone()
    off.minimize(opt, None)
    assert not torch.equal(m.weight, w)
