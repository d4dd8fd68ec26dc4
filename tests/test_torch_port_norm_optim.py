"""The port's fused LayerNorm / RMSNorm and fused AdamW (TPU kernel
table rows 8-10), ``F.rms_norm`` / ``nn.RMSNorm`` and the optimizers
Adagrad, RMSProp, Adamax and Lamb against the JAX package's, on the CPU,
inputs made with numpy from a seed.

The JAX side runs its Pallas kernels in interpret mode, as its own
tests do; the port runs the plain versions of its kernels (CPU
tensors) and its autograd Function.

Tolerances: the norms' forward in fp32 within 1e-5 (relative and
absolute): the same fp32 statistics summed in another order; in bf16
within one bf16 ulp (both round the same fp32 value, which may sit on
either side of a rounding boundary). dx, dw and db within 1e-4 of
``jax.grad`` (sums over rows and columns in another order). AdamW and
the optimizers within 1e-6 absolute + 1e-6 relative after three steps:
the same fp32 operations in the same order, so only the last bit of a
pow or a norm may differ. A relative 1e-6 on the second moment is what
shows the fp32 derivation of 1 - beta2: the Python double's rounding is
1.3e-5 away.
"""
import functools
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.kernels import (fused_adamw_update as j_adamw,
                                fused_layer_norm as j_ln,
                                fused_rms_norm as j_rms)
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import load_reference_optimizer_state
from paddle_tpu_torch.kernels import fused_adamw as tfa
from paddle_tpu_torch.kernels import fused_norm as tfn
from paddle_tpu_torch.nn import functional as TF

NORM_SHAPES = [(4, 32, 256), (16, 128), (3 * 37, 200)]
TOL = dict(atol=1e-6, rtol=1e-6)


def _rand(shape, seed, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale
            + shift).astype(np.float32)


def _within_one_bf16_ulp(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    big = np.maximum(np.abs(out), np.abs(ref))
    ulp = np.ldexp(np.float32(1.0), np.frexp(big)[1] - 8)
    bad = ~(np.abs(out - ref) <= ulp)
    assert not bad.any(), (f"{int(bad.sum())} elements beyond one bf16 ulp, "
                           f"max gap {np.abs(out - ref).max()}")


def _norm_inputs(shape, seed):
    d = shape[-1]
    return (_rand(shape, seed, 2.0, 0.5), _rand((d,), seed + 1, 0.1, 1.0),
            _rand((d,), seed + 2, 0.1))


@functools.partial(jax.jit, static_argnums=0)
def _jax_norm(kind, x, w, b):
    if kind == "layer":
        return j_ln(x, w, b)
    return j_rms(x, w)


def _port_norm(kind, x, w, b):
    if kind == "layer":
        return tfn.fused_layer_norm(x, w, b)
    return tfn.fused_rms_norm(x, w)


# ------------------------------------------------------------ fused norms

@pytest.mark.parametrize("shape", NORM_SHAPES)
@pytest.mark.parametrize("kind", ["layer", "rms"])
@pytest.mark.parametrize("affine", [True, False])
def test_fused_norm_forward_matches_jax(shape, kind, affine):
    x, w, b = _norm_inputs(shape, 3)
    if not affine:
        w = b = None
    ref = _jax_norm(kind, jnp.asarray(x), None if w is None
                    else jnp.asarray(w), None if b is None else jnp.asarray(b))
    n0 = tfn.norm_fwd_plain.calls
    out = _port_norm(kind, torch.tensor(x), None if w is None
                     else torch.tensor(w), None if b is None
                     else torch.tensor(b))
    assert tfn.norm_fwd_plain.calls == n0 + 1
    assert out.dtype == torch.float32 and tuple(out.shape) == shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("shape", NORM_SHAPES)
@pytest.mark.parametrize("kind", ["layer", "rms"])
def test_fused_norm_bf16_within_one_ulp(shape, kind):
    x, w, b = _norm_inputs(shape, 5)
    ref = _jax_norm(kind, jnp.asarray(x, jnp.bfloat16),
                    jnp.asarray(w, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16))
    out = _port_norm(kind, torch.tensor(x).bfloat16(),
                     torch.tensor(w).bfloat16(), torch.tensor(b).bfloat16())
    assert out.dtype == torch.bfloat16
    _within_one_bf16_ulp(out.float().numpy(),
                         np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("shape", NORM_SHAPES)
@pytest.mark.parametrize("kind", ["layer", "rms"])
def test_fused_norm_grads_match_jax(shape, kind):
    """dx, dw (and db) against jax.grad of the JAX function on the same
    random cotangent; the port's dx comes from ``norm_dx``."""
    x, w, b = _norm_inputs(shape, 7)
    ct = _rand(shape, 8)
    if kind == "layer":
        def loss(x, w, b):
            return jnp.sum(j_ln(x, w, b) * ct)
        refs = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(x, w, b)
    else:
        def loss(x, w):
            return jnp.sum(j_rms(x, w) * ct)
        refs = jax.jit(jax.grad(loss, argnums=(0, 1)))(x, w)
    tx, tw, tb = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    n0 = tfn.norm_dx_plain.calls
    y = _port_norm(kind, tx, tw, tb)
    y.backward(torch.tensor(ct))
    assert tfn.norm_dx_plain.calls == n0 + 1
    outs = (tx.grad, tw.grad, tb.grad)
    if kind == "rms":
        assert tb.grad is None      # the bias is not an input of RMSNorm
    for out, ref in zip(outs, refs):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                                   rtol=1e-4)


def test_fused_rms_norm_gives_no_bias_gradient():
    x = torch.tensor(_rand((4, 64), 9), requires_grad=True)
    w = torch.ones(64, requires_grad=True)
    y = tfn.fused_rms_norm(x, w)
    gx, gw = torch.autograd.grad(y.square().sum(), (x, w))
    assert gx.shape == x.shape and gw.shape == w.shape


def test_fused_norm_plain_rounds_once_after_the_affine():
    """The kernel contract rounds xhat*w + b once; the port's
    F.layer_norm rounds xhat to bf16 first. Against the fp32 answer the
    fused norm is within half a bf16 ulp, where F.layer_norm is not."""
    x, w, b = _norm_inputs((64, 256), 11)
    w = w * 3.0
    exact = tfn.fused_layer_norm(torch.tensor(x), torch.tensor(w),
                                 torch.tensor(b)).numpy()
    xb, wb, bb = (torch.tensor(a).bfloat16() for a in (x, w, b))
    fused = tfn.fused_layer_norm(xb, wb, bb).float().numpy()
    two_step = TF.layer_norm(xb, 256, wb, bb).float().numpy()
    exact_b = tfn.fused_layer_norm(xb.float(), wb.float(), bb.float())
    np.testing.assert_array_equal(fused, exact_b.bfloat16().float().numpy())
    assert np.abs(two_step - fused).max() > 0
    assert np.abs(fused - exact).max() < np.abs(two_step - exact).max()


def test_norm_kernel_inputs_are_checked():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="w \\[D\\]"):
        tfn.norm_fwd(x, torch.ones(7), torch.zeros(8), 1e-5, False)
    with pytest.raises(ValueError, match="dy2"):
        tfn.norm_dx(x, torch.ones(8), torch.zeros(4, 7), 1e-5, False)
    with pytest.raises(TypeError, match="dy2"):
        tfn.norm_dx(x, torch.ones(8), torch.zeros(4, 8).bfloat16(), 1e-5,
                    False)


@pytest.mark.parametrize("dtype,code", [(torch.float32, 0),
                                        (torch.bfloat16, 1),
                                        (torch.float16, 2)])
def test_norm_kernel_params_keep_their_dtype(dtype, code):
    """The kernels take w and b in fp32, bf16 or fp16 as they are: no
    copy, so no cast launched beside the kernel; float64 is cast to fp32
    and a strided view made contiguous."""
    w = torch.randn(8).to(dtype)
    got, got_code = tfn._param(w)
    assert got.data_ptr() == w.data_ptr() and got_code == code
    view = torch.randn(16).to(dtype)[::2]
    got, got_code = tfn._param(view)
    assert got.is_contiguous() and got_code == code
    assert torch.equal(got, view)
    got, got_code = tfn._param(w.double())
    assert got.dtype == torch.float32 and got_code == 0
    assert torch.equal(got, w.double().float())


def test_norm_kernel_signatures_match_the_source():
    """``_SIG``'s ctypes types are the C entry points' parameters, read
    from ``csrc/fused_norm.cu``, one for one."""
    import ctypes
    import re
    from pathlib import Path
    src = (Path(tfn.__file__).parents[1] / "csrc" /
           "fused_norm.cu").read_text()
    kinds = {"void*": ctypes.c_void_p, "long long": ctypes.c_longlong,
             "int": ctypes.c_int, "float": ctypes.c_float}
    for name, (restype, argtypes) in tfn._SIG.items():
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
        assert m is not None and restype is ctypes.c_int, name
        params = [re.sub(r"\s*\w+$", "", p.strip()).replace("const ", "")
                  .replace(" *", "*") for p in m.group(1).split(",")]
        assert [kinds[p] for p in params] == list(argtypes), (name, params)


# ------------------------------------------------------------ fused AdamW

_ADAMW = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, weight_decay=0.01)


def _adamw_both(dtype, tensors, steps=3, shape=(130, 7)):
    """``steps`` fused AdamW updates through both packages from the same
    param and gradients; returns [(jax p, m, v), (port p, m, v)] as
    float32 numpy."""
    p0 = _rand(shape, 0)
    grads = [_rand(shape, 10 + i) for i in range(steps)]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jp = jnp.asarray(p0, jdt)
    jm = jv = jnp.zeros(shape, jnp.float32)
    tp = torch.tensor(p0).to(dtype)
    tm, tv = torch.zeros(shape), torch.zeros(shape)
    for i, g in enumerate(grads):
        lr, step = 1e-3 * (1 + i), i + 1
        if tensors:
            jlr, jstep = jnp.float32(lr), jnp.float32(step)
            tlr, tstep = torch.tensor(lr), torch.tensor(float(step))
        else:
            jlr, jstep, tlr, tstep = lr, step, lr, step
        jp, jm, jv = j_adamw(jp, jnp.asarray(g, jdt), jm, jv, jlr,
                             step=jstep, **_ADAMW)
        out = tfa.fused_adamw_update(tp, torch.tensor(g).to(dtype), tm, tv,
                                     tlr, step=tstep, **_ADAMW)
        assert out[0] is tp and out[1] is tm and out[2] is tv   # in place
    return ([np.asarray(a.astype(jnp.float32)) for a in (jp, jm, jv)],
            [t.float().numpy() for t in (tp, tm, tv)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tensors", [False, True])
def test_fused_adamw_matches_jax(dtype, tensors):
    n0 = tfa.fused_adamw_update_plain.calls
    ref, out = _adamw_both(dtype, tensors)
    assert tfa.fused_adamw_update_plain.calls == n0 + 3
    for name, a, r in zip(("p", "m", "v"), out, ref):
        np.testing.assert_allclose(a, r, err_msg=name, **TOL)


def test_fused_adamw_derives_its_scalars_in_fp32():
    """At step 1 the second moment is (1 - b2)*g*g: the port's fp32
    1 - f32(0.999) agrees with JAX within 1e-6 relative, a Python double
    1 - 0.999 (rounded to fp32 0.001) does not."""
    ref, out = _adamw_both(torch.float32, False, steps=1)
    np.testing.assert_allclose(out[2], ref[2], rtol=1e-6, atol=0)
    g = _rand((130, 7), 10)
    v_double = np.float32(1 - 0.999) * g * g
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(v_double, ref[2], rtol=1e-6, atol=0)
    h = tfa.hyperparameters(torch.zeros(1), 1e-3, 0.9, 0.999, 1e-8, 0.0, 1)
    assert h[6] == np.float32(1) - np.float32(0.999) ** np.float32(1)
    assert h[6] != np.float32(1 - 0.999)


def test_fused_adamw_tensor_hyperparameters_equal_python_ones():
    """lr and step as tensors give the same fp32 vector as Python
    numbers."""
    p = torch.zeros(3)
    host = tfa.hyperparameters(p, 3e-4, 0.9, 0.95, 1e-8, 0.1, 7)
    dev = tfa.hyperparameters(p, torch.tensor(3e-4), 0.9, 0.95, 1e-8, 0.1,
                              torch.tensor(7))
    assert dev.dtype == torch.float32 and tuple(dev.shape) == (7,)
    np.testing.assert_allclose(dev.numpy(), np.array(host, np.float32),
                               rtol=1e-7, atol=0)


def test_fused_adamw_refuses_what_it_does_not_take():
    p, g = torch.zeros(4, 5), torch.zeros(4, 5)
    m, v = torch.zeros(4, 5), torch.zeros(4, 5)
    args = (1e-3, 0.9, 0.999, 1e-8, 0.01, 1)
    with pytest.raises(TypeError, match="m must be float32"):
        tfa.fused_adamw_update(p, g, m.bfloat16(), v, *args)
    with pytest.raises(ValueError, match="param's shape"):
        tfa.fused_adamw_update(p, g, torch.zeros(5, 4), v, *args)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.fused_adamw_update(p, g, m, torch.zeros(5, 4).t(), *args)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.fused_adamw_update(torch.zeros(5, 4).t(), g, m, v, *args)


def test_kernel_modules_import_no_jax():
    code = ("import sys, paddle_tpu_torch.kernels.fused_norm, "
            "paddle_tpu_torch.kernels.fused_adamw; "
            "from paddle_tpu_torch.kernels import fused_layer_norm, "
            "fused_rms_norm, fused_adamw_update; "
            "assert 'jax' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True)


# ------------------------------------------------------------ RMSNorm

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weighted", [True, False])
def test_rms_norm_functional_matches_jax(dtype, weighted):
    x, w, _ = _norm_inputs((6, 10, 96), 13)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    ref = JF.rms_norm(jnp.asarray(x, jdt),
                      jnp.asarray(w, jdt) if weighted else None, 1e-6)
    out = TF.rms_norm(torch.tensor(x).to(tdt),
                      torch.tensor(w).to(tdt) if weighted else None, 1e-6)
    assert out.dtype == tdt
    ref = np.asarray(ref._data.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=1e-6)
    else:
        _within_one_bf16_ulp(out.float().numpy(), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_layer_matches_jax(dtype):
    x = _rand((3, 5, 48), 14)
    jl = paddle.nn.RMSNorm(48, epsilon=1e-5)
    tl = tnn.RMSNorm(48, epsilon=1e-5, device="cpu")
    assert list(tl.state_dict()) == list(jl.state_dict()) == ["weight"]
    w = _rand((48,), 15, 0.1, 1.0)
    with torch.no_grad():
        tl.weight.copy_(torch.tensor(w))
    jl.weight._replace_data(jnp.asarray(w))
    if dtype == "bfloat16":
        jl.bfloat16()
        tl.bfloat16()
    jx = paddle.to_tensor(x).astype(dtype)
    ref = np.asarray(jl(jx)._data.astype(jnp.float32))
    out = tl(torch.tensor(x).to(getattr(torch, dtype))).detach().float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)
    else:
        _within_one_bf16_ulp(out, ref)


# ------------------------------------------------------------ optimizers

_OPT_SHAPES = [(8, 16), (16,), (3, 5, 7)]
_OPT_CASES = [
    ("Adagrad", {}),
    ("Adagrad", dict(initial_accumulator_value=0.1, epsilon=1e-5)),
    ("RMSProp", {}),
    ("RMSProp", dict(centered=True)),
    ("RMSProp", dict(momentum=0.9, rho=0.9)),
    ("RMSProp", dict(centered=True, momentum=0.5, weight_decay=0.01)),
    ("Adamax", {}),
    ("Adamax", dict(beta1=0.8, weight_decay=0.05)),
    ("Lamb", {}),
    ("Lamb", dict(lamb_weight_decay=0.1, beta1=0.8,
                  exclude_from_weight_decay_fn=lambda p: True)),
]
_STATE_KEYS = {"Adagrad": ["moment"], "Adamax": ["inf_norm", "moment"],
               "Lamb": ["moment1", "moment2"]}


def _opt_grads(step):
    rng = np.random.RandomState(20 + step)
    return [(rng.randn(*s) * 0.1).astype(np.float32) for s in _OPT_SHAPES]


@pytest.mark.parametrize("cls,kw", _OPT_CASES)
def test_optimizer_steps_and_state_match_jax(cls, kw):
    """Three apply_gradients steps through both packages, then the JAX
    state carried across by ``load_reference_optimizer_state`` into a
    fresh port optimizer: the fourth step matches too."""
    rng = np.random.RandomState(19)
    p0 = [rng.randn(*s).astype(np.float32) for s in _OPT_SHAPES]
    jparams = [paddle.create_parameter(list(s), "float32")
               for s in _OPT_SHAPES]
    jo = getattr(jopt, cls)(learning_rate=1e-2, parameters=jparams, **kw)
    jp = [jnp.asarray(p) for p in p0]
    js = [jo._init_state(p.shape, p.dtype) for p in jp]
    tp = [torch.tensor(p) for p in p0]
    to = getattr(topt, cls)(learning_rate=1e-2, parameters=tp, **kw)
    for i in range(3):
        gs = _opt_grads(i)
        jp, js = jo.apply_gradients(jp, [jnp.asarray(g) for g in gs], js,
                                    lr=1e-2, step=i + 1)
        to.apply_gradients(tp, [torch.tensor(g) for g in gs], lr=1e-2,
                           step=i + 1)
    for a, b, s, st in zip(jp, tp, js, (to._state[p] for p in tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
        keys = _STATE_KEYS.get(cls) or sorted(s)
        assert sorted(st) == sorted(s) == keys
        for k in s:
            assert st[k].dtype == torch.float32
            np.testing.assert_allclose(st[k].numpy(), np.asarray(s[k]),
                                       err_msg=k, **TOL)
    # the JAX state through the converter, then step 4 on both
    jo.set_state_dict({"_step_count": 3, **{
        f"param_{i}": {k: np.asarray(v) for k, v in s.items()}
        for i, s in enumerate(js)}})
    sd = jo.state_dict()
    tp2 = [torch.tensor(np.asarray(p)) for p in jp]
    to2 = getattr(topt, cls)(learning_rate=1e-2, parameters=tp2, **kw)
    load_reference_optimizer_state(to2, sd)
    assert to2._step_count == 3
    gs = _opt_grads(3)
    jp, _ = jo.apply_gradients(jp, [jnp.asarray(g) for g in gs], js,
                               lr=1e-2, step=4)
    to2.apply_gradients(tp2, [torch.tensor(g) for g in gs], lr=1e-2, step=4)
    for a, b in zip(jp, tp2):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def test_adagrad_and_rmsprop_keep_state_in_the_param_dtype():
    p = torch.zeros(3, dtype=torch.bfloat16)
    for opt in (topt.Adagrad(0.1, parameters=[p]),
                topt.RMSProp(0.1, parameters=[p], centered=True)):
        assert all(t.dtype == torch.bfloat16
                   for t in opt.state_for(p).values())
    for opt in (topt.Adamax(0.1, parameters=[p]),
                topt.Lamb(0.1, parameters=[p])):
        assert all(t.dtype == torch.float32
                   for t in opt.state_for(p).values())


def test_lamb_trust_ratio_is_one_for_a_zero_parameter():
    """|p| = 0: the trust ratio falls back to 1, so the step is lr * r."""
    p = torch.zeros(4)
    opt = topt.Lamb(0.1, parameters=[p], lamb_weight_decay=0.0)
    opt.apply_gradients([p], [torch.tensor([1.0, -2.0, 3.0, -4.0])], step=1)
    r = torch.tensor([1.0, -1.0, 1.0, -1.0]) / (1 + 1e-6)
    torch.testing.assert_close(p, -0.1 * r, atol=1e-6, rtol=1e-6)
