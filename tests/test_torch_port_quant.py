"""The port's quantization modules and int8/int4 weight preparation
against the JAX package's, on the CPU.

Inputs come from a numpy seed. Bitwise where both packages do the same
IEEE operations in the same order: ``quantize_int8``, ``quantize_int4``,
``pack_int4``/``unpack_int4``, ``serving_params``' stored values, scales
and ``materialize`` on test-tiny GPT (the weights carried across by
``convert.py``), and the int8 compute layers' int32 accumulators
(integer sums are exact). Float outputs built on those within 1e-5:
observer scales, a PTQ-converted MLP and the int8 compute layers'
rescaled outputs (fp32 products of the same values, which XLA may
contract differently). ``fake_quant``'s straight-through gradient
against ``jax.grad``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.inference import Config as JaxConfig
from paddle_tpu.inference import PrecisionType as JaxPrecision
from paddle_tpu.inference import precision as jprec
from paddle_tpu.models.gpt import gpt as jax_gpt
from paddle_tpu import quantization as jq
from paddle_tpu.quantization import int8_compute as jic
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import quantization as tq
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.inference import Config, PrecisionType
from paddle_tpu_torch.inference import precision as tprec
from paddle_tpu_torch.models.gpt import gpt

OUT_TOL = 1e-5


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _state(jm):
    return {k: np.asarray(v._data) for k, v in jm.state_dict().items()}


def _bitwise(a, b, what=""):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


# ------------------------------------------------------ int8 / int4 math

@pytest.mark.parametrize("axis", [None, 0, 1, -1])
def test_quantize_int8_bitwise(axis):
    x = np.random.RandomState(1).randn(13, 9).astype(np.float32) * 3
    x[2, :] = 0.0                       # an all-zero channel: the 1e-8 floor
    qj, sj = jq.quantize_int8(jnp.asarray(x), axis=axis)
    qt, st = tq.quantize_int8(torch.from_numpy(x), axis=axis)
    _bitwise(qj, qt, "q")
    _bitwise(sj, st, "scale")
    _bitwise(jq.dequantize_int8(qj, sj), tq.dequantize_int8(qt, st), "deq")


@pytest.mark.parametrize("which", ["int8", "int4"])
def test_bf16_weights_quantize_at_the_nearest_step(which):
    """ROADMAP C17: a bf16 weight is divided by its scale and rounded in
    fp32 (the nearest step, as for its fp32 widening); the JAX function
    rounds in bf16 and may land one step off. Scales equal."""
    w = np.random.RandomState(8).randn(64, 48).astype(np.float32)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    wj = jnp.asarray(wt.float().numpy()).astype(jnp.bfloat16)
    if which == "int8":
        qt, st = tq.quantize_int8(wt, axis=1)
        qj, sj = jq.quantize_int8(wj, axis=1)
        q32, _ = tq.quantize_int8(wt.float(), axis=1)
    else:
        qt, st = tprec.quantize_int4(wt, axis=1)
        qj, sj = jprec.quantize_int4(wj, axis=1)
        q32, _ = tprec.quantize_int4(wt.float(), axis=1)
    _bitwise(sj, st, "scale")
    assert st.dtype == torch.bfloat16
    _bitwise(q32, qt, "q")
    assert int(np.abs(_np(qt).astype(np.int32)
                      - _np(qj).astype(np.int32)).max()) <= 1


@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_int4_bitwise(axis):
    w = np.random.RandomState(2).randn(11, 6).astype(np.float32)
    qj, sj = jprec.quantize_int4(jnp.asarray(w), axis=axis)
    qt, st = tprec.quantize_int4(torch.from_numpy(w), axis=axis)
    _bitwise(qj, qt, "q")
    _bitwise(sj, st, "scale")
    assert int(np.abs(_np(qt)).max()) <= 7


@pytest.mark.parametrize("rows", [1, 6, 7, 12, 13])
def test_pack_unpack_int4_bitwise_and_round_trip(rows):
    q = np.random.RandomState(rows).randint(-7, 8, (rows, 5)).astype(np.int8)
    pj = jprec.pack_int4(jnp.asarray(q))
    pt = tprec.pack_int4(torch.from_numpy(q))
    assert tuple(pt.shape) == ((rows + 1) // 2, 5) and pt.dtype == torch.int8
    _bitwise(pj, pt, "packed")
    _bitwise(jprec.unpack_int4(pj, rows), tprec.unpack_int4(pt, rows),
             "unpacked")
    np.testing.assert_array_equal(tprec.unpack_int4(pt, rows).numpy(), q)


# ------------------------------------------------- serving_params on GPT

@pytest.fixture(scope="module")
def gpt_pair():
    paddle.seed(0)
    jm = jax_gpt("test-tiny")
    jm.eval()
    tm = gpt("test-tiny", device="cpu")
    load_reference_state(tm, _state(jm))
    return jm, tm.eval()


def _sp_pair(jm, tm, weight_bits, int8_compute=False):
    jc = JaxConfig().from_layer(jm, None)
    jc.enable_tpu(JaxPrecision.Int8)
    jc.enable_serving(weight_bits=weight_bits)
    tc = Config().from_layer(tm).enable_use_gpu(PrecisionType.Int8) \
        .disable_gpu().enable_serving(weight_bits=weight_bits)
    if int8_compute:
        jc.enable_int8_compute()
        tc.enable_int8_compute()
    return jprec.serving_params(jm, jc), tprec.serving_params(tm, tc)


@pytest.mark.parametrize("weight_bits", [8, 4])
def test_serving_params_bitwise_on_gpt(gpt_pair, weight_bits):
    """The stored values (int8, packed int4, bf16), the fp32 scales, the
    int4 row counts and ``materialize`` under the JAX names."""
    jm, tm = gpt_pair
    j, t = _sp_pair(jm, tm, weight_bits)
    assert t.names == j.names
    for n, a, b in zip(j.names, j.vals, t.vals):
        _bitwise(a, b, n)
    assert sorted(t.scales) == sorted(j.scales)
    assert len(t.scales) == 8           # qkv, out, fc1, fc2 of 2 layers
    for n in j.scales:
        _bitwise(j.scales[n], t.scales[n], n)
    assert t.int4 == j.int4
    assert bool(t.int4) == (weight_bits == 4)
    for n, a, b in zip(j.names, j.materialize(j.vals),
                       t.materialize(t.vals)):
        _bitwise(a, b, n)
    assert t.compute_dtype == torch.bfloat16
    # the tied LM head stays wide: wte is bf16, not quantized
    assert t.vals[t.names.index("gpt.embed.wte.weight")].dtype == \
        torch.bfloat16


@pytest.mark.parametrize("weight_bits", [8, 4])
def test_served_layers_dequantize_as_materialize(gpt_pair, weight_bits):
    """Each swapped layer's weight (computed at call time) is the
    ``materialize`` value of its stored tensor, and lies within the
    per-channel step of the original weight."""
    _, tm = gpt_pair
    tc = Config().from_layer(tm).enable_use_gpu("int8").disable_gpu() \
        .enable_serving(weight_bits=weight_bits)
    sp = tprec.serving_params(tm, tc)
    mat = dict(zip(sp.names, sp.materialize(sp.vals)))
    orig = tm.state_dict()
    qmax = 7 if weight_bits == 4 else 127
    for n in sp.scales:
        mod = sp.layer.get_submodule(n[:-len(".weight")])
        _bitwise(mod.weight, mat[n], n)
        step = sp.scales[n]                       # absmax / qmax, fp32
        w = orig[n].float()
        if qmax == 7:
            # the served bf16 weight, at the JAX test's int4 bound
            err = (mod.weight.float() - w).abs()
            assert bool((err <= 0.75 * step + 1e-6).all()), n
        else:
            # the quantization itself (q * step in fp32) within half a
            # step; the bf16 product adds up to about half a step more
            # of bf16 rounding (scale and product), so it is held
            # bitwise to materialize above instead
            err = (mod.weight_q.float() * step - w).abs()
            assert bool((err <= 0.5 * step + 1e-6).all()), n
    assert all(p.dtype == torch.bfloat16 for p in sp.layer.parameters())
    assert not any(p.dtype == torch.int8 for p in tm.parameters())


def test_serving_params_int8_compute_bitwise(gpt_pair):
    jm, tm = gpt_pair
    j, t = _sp_pair(jm, tm, None, int8_compute=True)
    # the swapped layers' buffers, under the JAX names (each package
    # orders its state dict its own way)
    assert sorted(t.names) == sorted(j.names)
    tv = dict(zip(t.names, t.vals))
    for n, a in zip(j.names, j.vals):
        _bitwise(a, tv[n], n)
    assert sum(n.endswith("weight_int8") for n in t.names) == 8
    assert not t.scales and not t.int4


# ------------------------------------------------------ observers and PTQ

def test_observer_scales_match_jax():
    rng = np.random.RandomState(3)
    batches = [rng.randn(4, 6).astype(np.float32) * (i + 1)
               for i in range(3)]
    pairs = [(jq.AbsmaxObserver(), tq.AbsmaxObserver()),
             (jq.AVGObserver(), tq.AVGObserver()),
             (jq.ChannelWiseAbsmaxObserver(axis=1),
              tq.ChannelWiseAbsmaxObserver(axis=1))]
    for jo, to in pairs:
        for b in batches:
            jo.observe(paddle.to_tensor(b))
            to.observe(torch.from_numpy(b))
        np.testing.assert_allclose(np.asarray(to.scale),
                                   np.asarray(jo.scale), rtol=OUT_TOL,
                                   atol=OUT_TOL)


def _mlps(seed=1):
    paddle.seed(seed)
    jm = jnn.Sequential(jnn.Linear(16, 32), jnn.ReLU(), jnn.Linear(32, 4))
    jm.eval()
    tm = tnn.Sequential(tnn.Linear(16, 32, device="cpu"), tnn.ReLU(),
                        tnn.Linear(32, 4, device="cpu"))
    load_reference_state(tm, _state(jm))
    return jm, tm.eval()


def test_ptq_converted_mlp_matches_jax():
    jm, tm = _mlps()
    rng = np.random.RandomState(1)
    calib = rng.randn(64, 16).astype(np.float32)
    x = rng.randn(8, 16).astype(np.float32)
    jp, tp = jq.PTQ(), tq.PTQ()
    jqm = jp.quantize(jm, inplace=False)
    tqm = tp.quantize(tm, inplace=False)
    jqm(paddle.to_tensor(calib))
    tqm(torch.from_numpy(calib))
    jqm, tqm = jp.convert(jqm), tp.convert(tqm)
    assert sorted(tp.quant_info) == sorted(jp.quant_info) == ["0", "2"]
    for name, ji in jp.quant_info.items():
        ti = tp.quant_info[name]
        np.testing.assert_allclose(ti["act_scale"], ji["act_scale"],
                                   rtol=OUT_TOL)
        np.testing.assert_array_equal(ti["weight_int8"], ji["weight_int8"])
        np.testing.assert_array_equal(ti["weight_scale"],
                                      ji["weight_scale"])
    want = jqm(paddle.to_tensor(x)).numpy()
    got = tqm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=OUT_TOL, atol=OUT_TOL)
    # the caller's model is left as it was (inplace=False)
    assert isinstance(tm[0], tnn.Linear)


# -------------------------------------------------------- int8 compute

def _jax_linear_acc(layer, x):
    xr = jnp.asarray(x, jnp.float32)
    qx, sx = jic._quantize_activation(xr, layer._act_scale)
    acc = jax.lax.dot_general(qx, layer.weight_int8._data,
                              (((xr.ndim - 1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    return qx, acc


def _jax_conv_acc(layer, x):
    from paddle_tpu.nn.functional.conv import _padding, _tuple
    xr = jnp.asarray(x, jnp.float32)
    qx, sx = jic._quantize_activation(xr, layer._act_scale)
    dn = ("NHWC", "OIHW", "NHWC") if layer.data_format == "NHWC" \
        else ("NCHW", "OIHW", "NCHW")
    acc = jax.lax.conv_general_dilated(
        qx, layer.weight_int8._data, _tuple(layer.stride, 2),
        _padding(layer.padding, 2), rhs_dilation=_tuple(layer.dilation, 2),
        dimension_numbers=dn, feature_group_count=layer.groups,
        preferred_element_type=jnp.int32)
    return qx, acc


@pytest.mark.parametrize("act_scale", [None, 3.5])
@pytest.mark.parametrize("shape", [(5, 24), (2, 3, 24)])
def test_int8_compute_linear_accumulators_bitwise(act_scale, shape):
    rng = np.random.RandomState(4)
    paddle.seed(4)
    jl = jnn.Linear(24, 20)
    tl = tnn.Linear(24, 20, device="cpu")
    load_reference_state(tl, _state(jl))
    ji = jic.Int8ComputeLinear.from_linear(jl, act_scale=act_scale)
    ti = tq.Int8ComputeLinear.from_linear(tl, act_scale=act_scale)
    for name in ("weight_int8", "weight_scale", "bias"):
        _bitwise(ji.state_dict()[name]._data, ti.state_dict()[name], name)
    x = rng.randn(*shape).astype(np.float32) * 2
    jqx, jacc = _jax_linear_acc(ji, x)
    tqx, _, tacc = ti.accumulate(torch.from_numpy(x))
    _bitwise(jqx, tqx, "qx")
    _bitwise(jacc, tacc, "acc")
    np.testing.assert_allclose(ti(torch.from_numpy(x)).numpy(),
                               ji(paddle.to_tensor(x)).numpy(),
                               rtol=OUT_TOL, atol=OUT_TOL)


CONV_CASES = [
    dict(padding=1),
    dict(padding="SAME", stride=2),
    dict(padding="VALID", dilation=2),
    dict(padding=[1, 2, 0, 1]),                    # asymmetric
    dict(padding=[2, 1], stride=(2, 1), groups=2),
    dict(padding="SAME", data_format="NHWC", act_scale=4.0),
]


@pytest.mark.parametrize("case", CONV_CASES,
                         ids=[str(i) for i in range(len(CONV_CASES))])
def test_int8_compute_conv_accumulators_bitwise(case):
    case = dict(case)
    act_scale = case.pop("act_scale", None)
    fmt = case.get("data_format", "NCHW")
    paddle.seed(5)
    jc = jnn.Conv2D(4, 6, 3, **case)
    tc = tnn.Conv2D(4, 6, 3, device="cpu", **case)
    load_reference_state(tc, _state(jc))
    ji = jic.Int8ComputeConv2D.from_conv(jc, act_scale=act_scale)
    ti = tq.Int8ComputeConv2D.from_conv(tc, act_scale=act_scale)
    for name in ("weight_int8", "weight_scale", "bias"):
        _bitwise(ji.state_dict()[name]._data, ti.state_dict()[name], name)
    shape = (2, 9, 7, 4) if fmt == "NHWC" else (2, 4, 9, 7)
    x = np.random.RandomState(6).randn(*shape).astype(np.float32)
    jqx, jacc = _jax_conv_acc(ji, x)
    tqx, _, tacc = ti.accumulate(torch.from_numpy(x))
    _bitwise(jqx, tqx, "qx")
    _bitwise(jacc, tacc, "acc")
    np.testing.assert_allclose(ti(torch.from_numpy(x)).numpy(),
                               ji(paddle.to_tensor(x)).numpy(),
                               rtol=OUT_TOL, atol=OUT_TOL)


def test_int8_compute_model_converts_from_jax_state():
    """A PTQ-calibrated MLP converted to int8 compute in JAX: its state
    (int8 weights, scales, biases) loads into the port's converted MLP
    through convert.py, and both give the same outputs."""
    jm, tm = _mlps(seed=2)
    rng = np.random.RandomState(2)
    calib = rng.randn(32, 16).astype(np.float32)
    x = rng.randn(6, 16).astype(np.float32)
    jp, tp = jq.PTQ(), tq.PTQ()
    jqm, tqm = jp.quantize(jm, inplace=False), tp.quantize(tm, inplace=False)
    jqm(paddle.to_tensor(calib))
    tqm(torch.from_numpy(calib))
    jcm = jq.convert_to_int8_compute(jp.convert(jqm))
    tcm = tq.convert_to_int8_compute(tp.convert(tqm))
    assert isinstance(tcm[0], tq.Int8ComputeLinear)
    assert tcm[0]._act_scale == pytest.approx(jcm[0]._act_scale, rel=1e-6)
    fresh = tq.convert_to_int8_compute(_mlps(seed=9)[1])
    for name, layer in tcm.named_children():
        if hasattr(layer, "_act_scale"):
            fresh.get_submodule(name)._act_scale = layer._act_scale
    load_reference_state(fresh, _state(jcm))
    for name, t in tcm.state_dict().items():
        _bitwise(fresh.state_dict()[name], t, name)
    want = jcm(paddle.to_tensor(x)).numpy()
    np.testing.assert_allclose(fresh(torch.from_numpy(x)).numpy(), want,
                               rtol=OUT_TOL, atol=OUT_TOL)


# --------------------------------------------------------- fake quant

@pytest.mark.parametrize("channelwise", [False, True])
@pytest.mark.parametrize("scale", [None, "given"])
def test_fake_quant_forward_and_straight_through_grad(channelwise, scale):
    rng = np.random.RandomState(7)
    x = rng.randn(6, 5).astype(np.float32) * 2
    g = rng.randn(6, 5).astype(np.float32)
    if scale == "given":
        s = np.abs(rng.randn(5)).astype(np.float32) + 0.5 if channelwise \
            else np.float32(1.3)
    else:
        s = None

    def jfq(v):
        if channelwise:
            out = jq.fake_quant_channelwise(paddle.Tensor(v), axis=1,
                                            scale=s)
        else:
            out = jq.fake_quant(paddle.Tensor(v), scale=s)
        return out._data if hasattr(out, "_data") else out

    jy, vjp = jax.vjp(lambda v: jfq(v), jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    ts = None if s is None else torch.as_tensor(s)
    ty = tq.fake_quant_channelwise(tx, axis=1, scale=ts) if channelwise \
        else tq.fake_quant(tx, scale=ts)
    ty.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jg))
    if scale == "given":
        # outside the representable range the gradient is zero
        assert (tx.grad.numpy() == 0).any()
