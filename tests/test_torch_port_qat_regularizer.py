"""The port's regularizers and quantization-aware training against the
JAX package's (``tests/test_regularizer_hub.py``,
``tests/test_quantization.py``), on the CPU in fp32, weights made with
numpy or carried across by ``convert.load_reference_state``.

Tolerances: the regularizers' gradient terms and one eager step bitwise
(the same fp32 operations in the same order); five ``TrainStep``s within
1e-6; QAT forwards and losses within 1e-5 (fake quantization rounds
x / s * 127 in both, and the products before it are summed in another
order, so a value on a rounding edge may take the next step; none does
on these inputs).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptim
from paddle_tpu import quantization as jq
from paddle_tpu import regularizer as jreg
from paddle_tpu.models.gpt import gpt as jax_gpt
from paddle_tpu.nn.initializer import ParamAttr
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch import quantization as tq
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.models.gpt import gpt


def _np(a):
    return np.asarray(a._data if hasattr(a, "_data") else a)


def _load(tm, jm):
    load_reference_state(tm, {k: _np(v) for k, v in jm.state_dict().items()})


# ------------------------------------------------------------ regularizers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["L1Decay", "L2Decay"])
def test_regularizer_terms_match_jax(kind, dtype):
    rng = np.random.RandomState(0)
    g = rng.randn(5, 7).astype(np.float32)
    p = rng.randn(5, 7).astype(np.float32)
    p[0, :3] = 0.0                               # sign(0) = 0
    jr, tr = getattr(jreg, kind)(0.37), getattr(treg, kind)(0.37)
    import jax.numpy as jnp
    jd = getattr(jnp, dtype)
    ref = np.asarray(jr(jnp.asarray(g, jd), jnp.asarray(p, jd))
                     .astype(jnp.float32))
    td = getattr(torch, dtype)
    out = tr(torch.from_numpy(g).to(td), torch.from_numpy(p).to(td))
    assert out.dtype == td
    np.testing.assert_array_equal(out.float().numpy(), ref)
    assert tr.coeff == jr.coeff and repr(tr) == repr(jr)


def _jax_linear(seed, w_attr=None):
    paddle.seed(seed)
    return jnn.Linear(4, 4, weight_attr=w_attr)


def _train_one(pkg, reg, param_reg=None):
    """The JAX test's ``_train_one``: one eager Momentum(0.1) step of a
    Linear(4, 4) on sum(x @ W + b) with x = ones((2, 4))."""
    x = np.ones((2, 4), np.float32)
    jm = _jax_linear(0, ParamAttr(regularizer=param_reg[0])
                     if param_reg else None)
    if pkg == "jax":
        opt = joptim.Momentum(learning_rate=0.1, parameters=jm.parameters(),
                              weight_decay=reg[0])
        jm(paddle.to_tensor(x)).sum().backward()
        opt.step()
        return _np(jm.weight)
    tm = tnn.Linear(4, 4, device="cpu")
    _load(tm, jm)
    if param_reg:
        tm.weight.regularizer = param_reg[1]
    opt = toptim.Momentum(learning_rate=0.1, parameters=tm.parameters(),
                          weight_decay=reg[1])
    tm(torch.from_numpy(x)).sum().backward()
    opt.step()
    return tm.weight.detach().numpy()


@pytest.mark.parametrize("kind,coeff", [("L2Decay", 0.5), ("L1Decay", 0.3)])
def test_eager_step_with_regularizer_matches_jax(kind, coeff):
    reg = (getattr(jreg, kind)(coeff), getattr(treg, kind)(coeff))
    ref = _train_one("jax", reg)
    got = _train_one("port", reg)
    np.testing.assert_array_equal(got, ref)
    # and the manual rule: grad 2 + the term, momentum's first step is SGD
    w0 = _np(_jax_linear(0).weight)
    term = coeff * (w0 if kind == "L2Decay" else np.sign(w0))
    np.testing.assert_allclose(got, w0 - 0.1 * (2.0 + term), rtol=1e-5,
                               atol=1e-6)


def test_parameter_regularizer_wins_over_weight_decay():
    """A parameter's own regularizer is used in place of the optimizer's
    ``weight_decay``; the bias, without one, takes ``weight_decay``."""
    reg = (jreg.L2Decay(0.5), treg.L2Decay(0.5))
    own = (jreg.L1Decay(0.2), treg.L1Decay(0.2))
    ref = _train_one("jax", reg, param_reg=own)
    got = _train_one("port", reg, param_reg=own)
    np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(got, _train_one("port", reg))


def test_regularizer_under_trainstep_matches_jax():
    """Five ``TrainStep``s of SGD(0.05) with ``L2Decay(0.1)`` on a
    Linear(4, 1) and a squared error: each loss and the parameters
    within 1e-6 of the JAX step's, the loss falling."""
    rng = np.random.RandomState(0)
    x = rng.rand(8, 4).astype(np.float32)
    y = np.zeros((8, 1), np.float32)
    paddle.seed(0)
    jm = jnn.Linear(4, 1)
    tm = tnn.Linear(4, 1, device="cpu")
    _load(tm, jm)
    jopt = joptim.SGD(learning_rate=0.05, parameters=jm.parameters(),
                      weight_decay=jreg.L2Decay(0.1))
    topt = toptim.SGD(learning_rate=0.05, parameters=tm.parameters(),
                      weight_decay=treg.L2Decay(0.1))
    jstep = paddle.jit.TrainStep(jm, jopt,
                                 lambda out, t: ((out - t) ** 2).mean())
    tstep = tjit.TrainStep(tm, topt, lambda out, t: ((out - t) ** 2).mean())
    losses = []
    for _ in range(5):
        j = float(jstep(paddle.to_tensor(x), paddle.to_tensor(y)))
        t = float(tstep(torch.from_numpy(x), torch.from_numpy(y)))
        np.testing.assert_allclose(t, j, atol=1e-6, rtol=1e-6)
        losses.append(t)
    assert losses[-1] < losses[0]
    for (n, p), (_, q) in zip(tm.named_parameters(), jm.named_parameters()):
        np.testing.assert_allclose(p.detach().numpy(), _np(q), atol=1e-6,
                                   rtol=1e-6, err_msg=n)


def test_parameter_regularizer_under_trainstep():
    """The per-parameter rule holds inside ``TrainStep`` too, where the
    port hands the parameters themselves to ``apply_gradients``."""
    rng = np.random.RandomState(1)
    x = rng.rand(8, 4).astype(np.float32)
    y = rng.rand(8, 4).astype(np.float32)
    jm = _jax_linear(2, ParamAttr(regularizer=jreg.L1Decay(0.05)))
    tm = tnn.Linear(4, 4, device="cpu")
    _load(tm, jm)
    tm.weight.regularizer = treg.L1Decay(0.05)
    jopt = joptim.SGD(learning_rate=0.1, parameters=jm.parameters(),
                      weight_decay=0.01)
    topt = toptim.SGD(learning_rate=0.1, parameters=tm.parameters(),
                      weight_decay=0.01)
    jstep = paddle.jit.TrainStep(jm, jopt,
                                 lambda out, t: ((out - t) ** 2).mean())
    tstep = tjit.TrainStep(tm, topt, lambda out, t: ((out - t) ** 2).mean())
    for _ in range(3):
        jstep(paddle.to_tensor(x), paddle.to_tensor(y))
        tstep(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(tm.weight.detach().numpy(), _np(jm.weight),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tm.bias.detach().numpy(), _np(jm.bias),
                               atol=1e-6, rtol=1e-6)


def test_parameter_regularizer_count_mismatch_raises():
    """Parameters with regularizers, and an update handed parameters the
    optimizer does not hold in a different count: the reference's
    ``ValueError``, not a silently different update."""
    tm = tnn.Linear(4, 4, device="cpu")
    tm.weight.regularizer = treg.L2Decay(0.1)
    opt = toptim.SGD(learning_rate=0.1, parameters=[tm.weight])
    with pytest.raises(ValueError, match="per-parameter regularizers"):
        opt._param_regularizers([tm.weight, tm.bias])
    step = tjit.TrainStep(tm, opt, lambda out, t: out.sum())
    with pytest.raises(ValueError, match="per-parameter regularizers"):
        step(torch.ones(2, 4), torch.ones(2, 4))


def test_parameter_regularizer_identity_match_survives_reorder():
    tm = tnn.Linear(4, 4, device="cpu")
    tm.weight.regularizer = treg.L2Decay(0.1)
    opt = toptim.SGD(learning_rate=0.1, parameters=[tm.weight, tm.bias])
    regs = opt._param_regularizers([tm.bias, tm.weight])
    assert regs[0] is None and regs[1] is tm.weight.regularizer
    assert toptim.SGD(parameters=[tm.bias])._param_regularizers(
        [tm.bias]) is None


# ------------------------------------------------------------ QAT

def _mlps(seed=0):
    paddle.seed(seed)
    jm = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    tm = tnn.Sequential(tnn.Linear(8, 16, device="cpu"), tnn.ReLU(),
                        tnn.Linear(16, 4, device="cpu"))
    _load(tm, jm)
    return jm, tm


def test_qat_swaps_layers_and_shares_params():
    _, tm = _mlps()
    orig = {id(p) for p in tm.parameters()}
    assert tq.QAT().quantize(tm) is tm
    assert isinstance(tm[0], tq.QuantedLinear)
    assert isinstance(tm[2], tq.QuantedLinear)
    assert {id(p) for p in tm.parameters()} == orig
    assert sorted(tm.state_dict()) == ["0.inner.bias", "0.inner.weight",
                                       "2.inner.bias", "2.inner.weight"]
    copy = tq.QAT().quantize(_mlps()[1], inplace=False)
    assert isinstance(copy[0], tq.QuantedLinear)


def test_qat_trains_and_converts_like_jax():
    """30 eager SGD(0.1) steps of the quantized MLP on an MSE loss:
    each loss within 1e-5 of the JAX run's, falling; after ``convert``
    the plain layers are back and give the JAX converted model's
    output."""
    jm, tm = _mlps()
    jq.QAT().quantize(jm)
    tq.QAT().quantize(tm)
    jopt = joptim.SGD(learning_rate=0.1, parameters=jm.parameters())
    topt = toptim.SGD(learning_rate=0.1, parameters=tm.parameters())
    rng = np.random.RandomState(2)
    x = rng.randn(32, 8).astype(np.float32)
    y = rng.randn(32, 4).astype(np.float32)
    jmse, tmse = jnn.MSELoss(), tnn.MSELoss()
    losses = []
    for _ in range(30):
        jl = jmse(jm(paddle.to_tensor(x)), paddle.to_tensor(y))
        jl.backward()
        jopt.step()
        jopt.clear_grad()
        tl = tmse(tm(torch.from_numpy(x)), torch.from_numpy(y))
        tl.backward()
        topt.step()
        topt.clear_grad()
        np.testing.assert_allclose(tl.item(), float(jl), atol=1e-5,
                                   rtol=1e-5)
        losses.append(tl.item())
    assert losses[-1] < losses[0]
    tq.QAT.convert(tm)
    jq.QAT.convert(jm)
    assert not any(isinstance(m, tq.QuantedLinear) for m in tm.modules())
    np.testing.assert_allclose(
        tm(torch.from_numpy(x)).detach().numpy(),
        _np(jm(paddle.to_tensor(x))), atol=1e-5, rtol=1e-5)


def test_qat_skip_config():
    _, tm = _mlps()
    tq.QAT(tq.QuantConfig().skip("2")).quantize(tm)
    assert isinstance(tm[0], tq.QuantedLinear)
    assert type(tm[2]) is tnn.Linear


def test_qat_conv2d_forward_matches_jax():
    paddle.seed(0)
    jm = jnn.Sequential(jnn.Conv2D(3, 4, 3, padding=1), jnn.ReLU())
    tm = tnn.Sequential(tnn.Conv2D(3, 4, 3, padding=1, device="cpu"),
                        tnn.ReLU())
    _load(tm, jm)
    jq.QAT().quantize(jm)
    tq.QAT().quantize(tm)
    assert isinstance(tm[0], tq.QuantedConv2D)
    x = np.random.RandomState(3).randn(2, 3, 8, 8).astype(np.float32)
    out = tm(torch.from_numpy(x))
    assert tuple(out.shape) == (2, 4, 8, 8)
    np.testing.assert_allclose(out.detach().numpy(),
                               _np(jm(paddle.to_tensor(x))), atol=1e-5,
                               rtol=1e-5)


def test_qat_custom_quanters_used():
    calls = []

    def my_act(x):
        calls.append("act")
        return x

    def my_weight(w, axis):
        calls.append(("weight", axis))
        return w

    cfg = tq.QuantConfig(activation=my_act, weight=my_weight)
    tm = tnn.Sequential(tnn.Linear(4, 4, device="cpu"))
    tq.QAT(cfg).quantize(tm)
    tm(torch.randn(2, 4))
    assert calls == ["act", ("weight", 1)]


def test_qat_gpt_trainstep_matches_jax_and_names_cross():
    """QAT on test-tiny GPT wraps its 8 trunk Linears (the tied head is
    no Linear); two ``TrainStep``s of SGD (an update linear in the
    gradient: AdamW's normalized step would blow a near-zero gradient's
    roundoff up to a full step) give the JAX losses within 1e-5, the
    straight-through gradients reaching every weight; the
    attention still runs the flash path (its plain version here). A plain
    JAX state loads into the quantized port model and a quantized JAX
    state into a plain one (``convert``'s ``inner`` names)."""
    paddle.seed(0)
    jm = jax_gpt("test-tiny")
    tm = gpt("test-tiny", device="cpu")
    _load(tm, jm)                       # plain -> plain
    jq.QAT().quantize(jm)
    tq.QAT().quantize(tm)
    wrapped = [n for n, m in tm.named_modules()
               if isinstance(m, tq.QuantedLinear)]
    assert len(wrapped) == 8
    _load(tm, jm)                       # quantized -> quantized
    ids = np.random.RandomState(0).randint(0, 512, (2, 16))
    jopt = joptim.SGD(0.1, parameters=jm.parameters())
    topt = toptim.SGD(0.1, parameters=tm.parameters())
    jstep = paddle.jit.TrainStep(jm, jopt, lambda o, y: jm.loss(o, y))
    tstep = tjit.TrainStep(tm, topt, lambda o, y: tm.loss(o, y))
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    fwd0 = tfa.flash_attention_plain.calls
    for _ in range(2):
        j = float(jstep(paddle.to_tensor(ids.astype(np.int32)),
                        paddle.to_tensor(ids.astype(np.int64))))
        t = float(tstep(torch.as_tensor(ids), torch.as_tensor(ids)))
        np.testing.assert_allclose(t, j, atol=1e-5, rtol=1e-5)
    assert tfa.flash_attention_plain.calls - fwd0 == 4
    for n, p in tm.named_parameters():
        assert not torch.equal(p, before[n]), n
    # a plain port model takes the quantized JAX state, and the reverse
    plain = gpt("test-tiny", device="cpu")
    _load(plain, jm)
    jq.QAT.convert(jm)
    _load(tm, jm)
    tq.QAT.convert(tm)
    assert not any(isinstance(m, tq.QuantedLinear) for m in tm.modules())
    x = torch.as_tensor(ids)
    with torch.no_grad():
        assert torch.equal(tm(x), plain(x))
    with pytest.raises(KeyError):
        load_reference_state(tm, {k + "x": _np(v) for k, v in
                                  jm.state_dict().items()})
