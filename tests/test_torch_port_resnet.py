"""The port's fused conv+BN ResNet training path against the JAX
package's, on the CPU in fp32, seeds made with numpy.

The JAX side runs its Pallas kernels in interpret mode, as its own tests
do, under ``jax.default_matmul_precision("highest")`` (XLA:CPU runs fp32
matmuls and convs at reduced precision otherwise). Both packages run
their default route, ``_PALLAS3X3`` True: the 3x3 of every stride-1
fused block goes through the fused 3x3 pair (the JAX Pallas kernels, the
port's plain versions of rows 17-18). One test sets both flags to False
and holds the ordinary-conv route too. The port runs the plain versions
of its kernels (CPU tensors).

Tolerances: the matrix-product ops' y, mean and var within 1e-5 and
their gradients within 1e-4 (fp32 sums in another order, the JAX stats
one-pass shifted, the port's two-pass); the BN applies within 1e-5; the
model's logits within 1e-4 and every gradient within max(1e-2,
4*chaos) of its norm, where chaos is the JAX path against itself under
+-1-ulp input noise (the reference's own conditioning floor, as
tests/test_fused_resnet.py measures it). The model sees 64x64 images:
at 32x32 layer4 has 2 rows per channel, its batch statistics amplify
round-off, and the JAX path's own logits move far beyond 1e-4 under
that noise.
"""
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.kernels.fused_resnet as jfr
import paddle_tpu.models.resnet as jresnet
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptim
from paddle_tpu.core.tensor import Parameter
from paddle_tpu.jit.api import functional_call
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch.convert import (load_reference_optimizer_state,
                                      load_reference_state)
from paddle_tpu_torch.kernels import fused_resnet as tfr
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.nn import CrossEntropyLoss
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.functional import fused_conv as TFC

HIGHEST = jax.default_matmul_precision("highest")


def _np(a):
    return np.asarray(a._data if hasattr(a, "_data") else a)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


# ----------------------------------------------------------- kernels

def _mm_loss_jax(fn):
    def loss(*args):
        y, m, v = fn(*args)
        return jnp.sum(y * y) + jnp.sum(m * 3.0) + jnp.sum(v * 0.5)
    return loss


@pytest.mark.parametrize("m", [96, 98])
@pytest.mark.parametrize("prologue", [False, True])
def test_matmul_bn_stats_match_jax(m, prologue):
    rng = np.random.RandomState(m + prologue)
    x = (rng.randn(m, 16) + 0.5).astype(np.float32)
    w = rng.randn(16, 24).astype(np.float32)
    scale = (rng.rand(16) + 0.5).astype(np.float32)
    shift = (rng.randn(16) * 0.1).astype(np.float32)
    args = (x, scale, shift, w) if prologue else (x, w)
    jfn = jfr.bn_relu_matmul_bn_stats if prologue else jfr.matmul_bn_stats
    tfn = tfr.bn_relu_matmul_bn_stats if prologue else tfr.matmul_bn_stats
    with HIGHEST:
        jout = jfn(*map(jnp.asarray, args))
        jgrads = jax.grad(_mm_loss_jax(jfn), argnums=tuple(
            range(len(args))))(*map(jnp.asarray, args))
    targs = [_t(a, grad=True) for a in args]
    tfr.reset_counts()
    y, mean, var = tfn(*targs)
    for out, ref in zip((y, mean, var), jout):
        np.testing.assert_allclose(out.detach().numpy(), _np(ref),
                                   rtol=1e-5, atol=1e-5)
    loss = (y * y).sum() + (mean * 3.0).sum() + (var * 0.5).sum()
    loss.backward()
    for a, g in zip(targs, jgrads):
        np.testing.assert_allclose(a.grad.numpy(), _np(g), rtol=1e-4,
                                   atol=1e-4)
    # on the CPU the plain versions ran, once each way
    assert [f.calls for f in tfr.PLAIN_VERSIONS] == \
        [int(not prologue), int(prologue), int(not prologue), int(prologue),
         0, 0]
    assert [f.launches for f in tfr.KERNEL_WRAPPERS] == [0] * 6


def test_conv1x1_bn_stats_stride2_matches_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 8, 8, 16).astype(np.float32)
    w = rng.randn(24, 16, 1, 1).astype(np.float32)
    with HIGHEST:
        jout = jfr.conv1x1_bn_stats(jnp.asarray(x), jnp.asarray(w), stride=2)
        jg = jax.grad(_mm_loss_jax(lambda a, b: jfr.conv1x1_bn_stats(
            a, b, stride=2)), argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x, True), _t(w, True)
    y, mean, var = tfr.conv1x1_bn_stats(tx, tw, stride=2)
    assert tuple(y.shape) == (2, 4, 4, 24)
    for out, ref in zip((y, mean, var), jout):
        np.testing.assert_allclose(out.detach().numpy(), _np(ref),
                                   rtol=1e-5, atol=1e-5)
    ((y * y).sum() + (mean * 3.0).sum() + (var * 0.5).sum()).backward()
    np.testing.assert_allclose(tx.grad.numpy(), _np(jg[0]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tw.grad.numpy(), _np(jg[1]), rtol=1e-4,
                               atol=1e-4)


def _bn_args(rng, names):
    shape, c = (2, 3, 5, 8), 8
    make = {"y": lambda: rng.randn(*shape) * 2 + 1,
            "identity": lambda: rng.randn(*shape),
            "scale": lambda: rng.rand(c) + 0.5,
            "shift": lambda: rng.randn(c) * 0.3,
            "beta": lambda: rng.randn(c) * 0.3,
            "mean": lambda: rng.randn(c)}
    return [make[n]().astype(np.float32) for n in names]


_BN_OPS = {
    "bn_apply_relu_add": ("y", "scale", "shift", "identity"),
    "bn_apply_relu": ("y", "scale", "shift"),
    "bn_apply": ("y", "scale", "shift"),
    "bn_center_apply_relu_add": ("y", "mean", "scale", "beta", "identity"),
    "bn_center_apply": ("y", "mean", "scale", "beta"),
    "bn_moments": ("y",),
}


@pytest.mark.parametrize("name", sorted(_BN_OPS))
def test_bn_applies_match_jax_custom_vjps(name):
    rng = np.random.RandomState(len(name))
    args = _bn_args(rng, _BN_OPS[name])
    jfn, tfn = getattr(jfr, name), getattr(tfr, name)
    jout, vjp = jax.vjp(jfn, *map(jnp.asarray, args))
    jouts = jout if isinstance(jout, tuple) else (jout,)
    cts = [rng.randn(*np.shape(o)).astype(np.float32) for o in jouts]
    jct = tuple(map(jnp.asarray, cts))
    jgrads = vjp(jct if isinstance(jout, tuple) else jct[0])
    targs = [_t(a, grad=True) for a in args]
    touts = tfn(*targs)
    touts = touts if isinstance(touts, tuple) else (touts,)
    for out, ref in zip(touts, jouts):
        np.testing.assert_allclose(out.detach().numpy(), _np(ref),
                                   rtol=1e-5, atol=1e-5)
    torch.autograd.backward(touts, [torch.tensor(c) for c in cts])
    for a, g in zip(targs, jgrads):
        np.testing.assert_allclose(a.grad.numpy(), _np(g), rtol=1e-5,
                                   atol=1e-5)


def test_bn_fold_matches_jax():
    rng = np.random.RandomState(5)
    g, b, m = (rng.randn(4).astype(np.float32) for _ in range(3))
    v = (rng.rand(4) + 0.1).astype(np.float32)
    for gamma, beta in ((g, b), (None, None)):
        js = jfr.bn_fold(None if gamma is None else jnp.asarray(gamma),
                         None if beta is None else jnp.asarray(beta),
                         jnp.asarray(m), jnp.asarray(v), 1e-5)
        ts = tfr.bn_fold(None if gamma is None else _t(gamma),
                         None if beta is None else _t(beta), _t(m), _t(v),
                         1e-5)
        for out, ref in zip(ts, js):
            np.testing.assert_allclose(out.numpy(), _np(ref), rtol=1e-6,
                                       atol=1e-6)


def test_fused_3x3_routes_the_stride1_blocks():
    """A fused ResNet(BottleneckBlock, [2,1,1,2]) in training runs the 3x3
    of each of its three stride-1 blocks (layer1.0, layer1.1, layer4.1)
    through the fused 3x3 pair, forward and backward once each, and
    ``bn_moments`` only for the three stride-2 blocks, which stay on the
    ordinary conv as in the JAX package."""
    assert tresnet._PALLAS3X3 is True
    model = tresnet.ResNet(tresnet.BottleneckBlock, [2, 1, 1, 2],
                           num_classes=4, data_format="NHWC", fused_bn=True,
                           device="cpu")
    moments = []

    def counting(y):
        moments.append(tuple(y.shape))
        return tfr.bn_moments(y)

    tfr.reset_counts()
    with mock.patch.object(TFC, "bn_moments", counting):
        model.train()
        model(torch.randn((2, 3, 32, 32))).square().sum().backward()
    assert tfr.conv3x3_bn_stats_fwd_plain.calls == 3
    assert tfr.conv3x3_bn_stats_bwd_plain.calls == 3
    # the stride-2 blocks' 3x3 outputs: layer2.0, layer3.0, layer4.0
    assert moments == [(2, 4, 4, 128), (2, 2, 2, 256), (2, 1, 1, 512)]


# ----------------------------------------------------------- the model

def _models(fused_bn=True, seed=7):
    paddle.seed(seed)
    jm = jresnet.ResNet(jresnet.BottleneckBlock, [2, 1, 1, 2],
                        num_classes=10, data_format="NHWC",
                        fused_bn=fused_bn, stem_space_to_depth=True)
    tm = tresnet.ResNet(tresnet.BottleneckBlock, [2, 1, 1, 2],
                        num_classes=10, data_format="NHWC",
                        fused_bn=fused_bn, stem_space_to_depth=True,
                        device="cpu")
    load_reference_state(tm, {k: _np(v) for k, v in
                              jm.state_dict().items()})
    return jm, tm


def _batch(seed=8):
    rng = np.random.RandomState(seed)
    img = rng.randn(2, 3, 64, 64).astype(np.float32)
    lbl = rng.randint(0, 10, (2,)).astype(np.int64)
    noise = (1 + 1.2e-7 * np.sign(rng.randn(*img.shape))).astype(np.float32)
    return img, lbl, noise


def _jax_grads(jm, images, lbl):
    """The gradient of every parameter of the JAX model's training loss,
    for each batch of ``images``, through one jitted
    ``value_and_grad`` (as its ``TrainStep`` takes it)."""
    names = [n for n, _ in jm.named_parameters()]
    vals = [p._data for _, p in jm.named_parameters()]
    ce = jnn.CrossEntropyLoss()

    @jax.jit
    def grads_of(pvals, x):
        def loss_of(pv):
            out = functional_call(jm, dict(zip(names, pv)),
                                  paddle.to_tensor(x))
            return ce(out, paddle.to_tensor(lbl))._data
        return jax.grad(loss_of)(pvals)

    jm.train()
    with HIGHEST:
        return [dict(zip(names, map(np.asarray, grads_of(vals, img))))
                for img in images]


def _stats(state):
    return {k: np.asarray(v) for k, v in state.items()
            if k.endswith(("_mean", "_variance"))}


@pytest.fixture(scope="module")
def trained_pair():
    """Both models after one eager training forward on the same batch
    (logits, running statistics), the port's gradients from its
    backward, the JAX gradients and the JAX path's chaos floor."""
    img, lbl, noise = _batch()
    jm, tm = _models()
    j_grads, floor = _jax_grads(jm, (img, img * noise), lbl)
    jm.train()
    with HIGHEST:
        j_logits = _np(jm(paddle.to_tensor(img)))
    tm.train()
    logits = tm(torch.tensor(img))
    CrossEntropyLoss()(logits, torch.tensor(lbl)).backward()
    return dict(jm=jm, tm=tm, j_logits=j_logits, j_grads=j_grads,
                floor=floor, logits=logits.detach())


def test_model_logits_and_running_stats_match_jax(trained_pair):
    p = trained_pair
    np.testing.assert_allclose(p["logits"].numpy(), p["j_logits"],
                               rtol=1e-4, atol=1e-4)
    j_stats = _stats({k: _np(v) for k, v in p["jm"].state_dict().items()})
    t_stats = _stats({k: v.numpy() for k, v in p["tm"].state_dict().items()})
    assert j_stats.keys() == t_stats.keys() and len(j_stats) == 2 * 23
    for k in j_stats:     # moved off their initial zeros and ones
        np.testing.assert_allclose(t_stats[k], j_stats[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert not np.allclose(t_stats["layer1.0.bn3._mean"], 0.0)


def test_model_gradients_match_jax(trained_pair):
    p = trained_pair
    names = [n for n, _ in p["tm"].named_parameters()]
    assert names == list(p["j_grads"])
    for name, param in p["tm"].named_parameters():
        ref, floor = p["j_grads"][name], p["floor"][name]
        norm = np.linalg.norm(ref) + 1e-12
        rel = np.linalg.norm(param.grad.numpy() - ref) / norm
        chaos = np.linalg.norm(floor - ref) / norm
        assert rel < max(1e-2, 4.0 * chaos), (name, rel, chaos)


def test_cudnn_route_matches_jax_xla_route(monkeypatch):
    """With ``_PALLAS3X3`` False in both packages the fused model runs its
    3x3s through the ordinary conv: the logits and running statistics of
    one training forward, then one ``TrainStep``'s loss and parameters,
    match the JAX package's on that route (tolerances as above)."""
    monkeypatch.setattr(jresnet, "_PALLAS3X3", False)
    monkeypatch.setattr(tresnet, "_PALLAS3X3", False)
    img, lbl, _ = _batch(11)
    jm, tm = _models()
    jm.train()
    tm.train()
    tfr.reset_counts()
    with HIGHEST:
        ref = _np(jm(paddle.to_tensor(img)))
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.tensor(img)).numpy(), ref,
                                   rtol=1e-4, atol=1e-4)
    assert tfr.conv3x3_bn_stats_fwd_plain.calls == 0
    j_stats = _stats({k: _np(v) for k, v in jm.state_dict().items()})
    t_stats = _stats({k: v.numpy() for k, v in tm.state_dict().items()})
    for k in j_stats:
        np.testing.assert_allclose(t_stats[k], j_stats[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    jopt = joptim.Momentum(learning_rate=1e-3, momentum=0.9,
                           parameters=jm.parameters())
    topt = toptim.Momentum(learning_rate=1e-3, momentum=0.9,
                           parameters=tm.parameters())
    jce, tce = jnn.CrossEntropyLoss(), CrossEntropyLoss()
    with HIGHEST:
        j_loss = float(paddle.jit.TrainStep(jm, jopt, lambda o, y: jce(
            o, y))(paddle.to_tensor(img), paddle.to_tensor(lbl)))
    t_loss = float(tjit.TrainStep(tm, topt, lambda o, y: tce(o, y))(
        torch.tensor(img), torch.tensor(lbl)))
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-4, atol=1e-4)
    jparams = dict(jm.named_parameters())
    for name, p in tm.named_parameters():
        ref = _np(jparams[name])
        assert np.abs(p.detach().numpy() - ref).max() <= \
            1e-5 + 1e-4 * np.abs(ref).max(), name
    assert tfr.conv3x3_bn_stats_fwd_plain.calls == 0


def test_eval_and_unfused_forward_match_jax():
    img = _batch(9)[0]
    jm, tm = _models()
    jm.eval()
    tm.eval()
    with HIGHEST:
        ref = _np(jm(paddle.to_tensor(img)))
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.tensor(img)).numpy(), ref,
                                   rtol=1e-4, atol=1e-4)
    jm, tm = _models(fused_bn=False)
    jm.train()
    tm.train()
    with HIGHEST:
        ref = _np(jm(paddle.to_tensor(img)))
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.tensor(img)).numpy(), ref,
                                   rtol=1e-4, atol=1e-4)
    assert _stats({k: v.numpy() for k, v in tm.state_dict().items()}) \
        .keys() == _stats({k: _np(v) for k, v in jm.state_dict().items()}) \
        .keys()


def test_train_steps_match_jax_and_freeze_running_stats():
    """5 TrainSteps with Momentum(1e-3, 0.9) in both packages, each
    port step started from the JAX step's state (parameters and
    velocities carried across by the converters): each loss within
    1e-4 and each updated parameter within 1e-5 + 1e-4*max|p|. Steps
    are compared one at a time because a 5-step trajectory on a batch
    this small is itself chaotic: a ReLU gate a few ulps from zero
    flips under +-1-ulp input noise and moves the JAX path's own later
    losses by more than 1e-4."""
    img, lbl, _ = _batch(10)
    jm, tm = _models()
    jm.train()
    tm.train()
    j_before = _stats({k: _np(v) for k, v in jm.state_dict().items()})
    jopt = joptim.Momentum(learning_rate=1e-3, momentum=0.9,
                           parameters=jm.parameters())
    topt = toptim.Momentum(learning_rate=1e-3, momentum=0.9,
                           parameters=tm.parameters())
    jce, tce = jnn.CrossEntropyLoss(), CrossEntropyLoss()
    jstep = paddle.jit.TrainStep(jm, jopt, lambda o, y: jce(o, y))
    tstep = tjit.TrainStep(tm, topt, lambda o, y: tce(o, y))
    x, y = paddle.to_tensor(img), paddle.to_tensor(lbl)
    losses = []
    for _ in range(5):
        load_reference_state(tm, {k: _np(v)
                                  for k, v in jm.state_dict().items()})
        load_reference_optimizer_state(topt, jopt.state_dict())
        t_before = _stats({k: v.numpy().copy()
                           for k, v in tm.state_dict().items()})
        with HIGHEST:
            j_loss = float(jstep(x, y))
        t_loss = float(tstep(torch.tensor(img), torch.tensor(lbl)))
        losses.append(t_loss)
        np.testing.assert_allclose(t_loss, j_loss, rtol=1e-4, atol=1e-4)
        jparams = dict(jm.named_parameters())
        for name, p in tm.named_parameters():
            ref = _np(jparams[name])
            assert np.abs(p.detach().numpy() - ref).max() <= \
                1e-5 + 1e-4 * np.abs(ref).max(), name
        t_after = _stats({k: v.numpy() for k, v in tm.state_dict().items()})
        for k in t_before:
            np.testing.assert_array_equal(t_after[k], t_before[k])
    assert losses[-1] < losses[0]
    assert topt._step_count == jopt._step_count == 5
    j_after = _stats({k: _np(v) for k, v in jm.state_dict().items()})
    for k in j_before:
        np.testing.assert_array_equal(j_after[k], j_before[k])
    # an eager training forward does move them
    with torch.no_grad():
        tm(torch.tensor(img))
    assert not np.array_equal(tm.state_dict()["bn1._mean"].numpy(),
                              j_before["bn1._mean"])


def test_bf16_state_crosses_with_buffers():
    jm, _ = _models()
    jm.bfloat16()
    tm = tresnet.ResNet(tresnet.BottleneckBlock, [2, 1, 1, 2],
                        num_classes=10, data_format="NHWC", fused_bn=True,
                        stem_space_to_depth=True, device="cpu",
                        dtype=torch.bfloat16)
    arrays = {k: _np(v) for k, v in jm.state_dict().items()}
    load_reference_state(tm, arrays)
    for k, v in tm.state_dict().items():
        assert v.dtype == torch.bfloat16, k
        np.testing.assert_array_equal(v.float().numpy(),
                                      arrays[k].astype(np.float32))


# ----------------------------------------------------------- optimizers

def _opt_pair(kind, dtype, **kw):
    rng = np.random.RandomState(11)
    shapes = [(6, 4), (5,)]
    init = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(4)]
    jparams = [Parameter(jnp.asarray(a, dtype=dtype)) for a in init]
    tparams = [torch.nn.Parameter(torch.tensor(a).to(
        getattr(torch, dtype))) for a in init]
    jopt = getattr(joptim, kind)(parameters=jparams, **kw)
    topt = getattr(toptim, kind)(parameters=tparams, **kw)
    return jparams, tparams, jopt, topt, grads


@pytest.mark.parametrize("kind,kw", [
    ("SGD", {}),
    ("Momentum", {}),
    ("Momentum", dict(use_nesterov=True)),
    ("Momentum", dict(weight_decay=0.01)),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sgd_and_momentum_match_jax(kind, kw, dtype):
    kw = dict(kw, learning_rate=0.05, multi_precision=dtype == "bfloat16")
    if kind == "Momentum":
        kw["momentum"] = 0.9
    jparams, tparams, jopt, topt, grads = _opt_pair(kind, dtype, **kw)
    for g in grads:
        for p, a in zip(jparams, g):
            p.grad = paddle.to_tensor(a).astype(dtype)
        jopt.step()
        jopt.clear_grad()
        for p, a in zip(tparams, g):
            p.grad = torch.tensor(a).to(p.dtype)
        topt.step()
        topt.clear_grad()
    for jp, tp in zip(jparams, tparams):
        np.testing.assert_allclose(tp.detach().float().numpy(),
                                   _np(jp).astype(np.float32), rtol=1e-6,
                                   atol=1e-6)
    jsd, tsd = jopt.state_dict(), topt.state_dict()
    for key in (k for k in jsd if k.startswith("param_")):
        for name, ref in jsd[key].items():
            np.testing.assert_allclose(tsd[key][name].float().numpy(),
                                       np.asarray(ref, np.float32),
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["SGD", "Momentum"])
def test_optimizer_state_converter_round_trip(kind):
    """JAX state before the first update (a master of None) and after
    two: loaded into a fresh port optimizer, the next step matches."""
    kw = dict(learning_rate=0.05, multi_precision=True)
    if kind == "Momentum":
        kw["momentum"] = 0.9
    jparams, tparams, jopt, topt, grads = _opt_pair(kind, "bfloat16", **kw)
    for i, g in enumerate(grads):
        if i in (0, 2):     # load the JAX state, then step both
            load_reference_optimizer_state(topt, jopt.state_dict())
            for p, jp in zip(tparams, jparams):
                with torch.no_grad():
                    p.copy_(torch.tensor(_np(jp).astype(np.float32)))
        for p, a in zip(jparams, g):
            p.grad = paddle.to_tensor(a).astype("bfloat16")
        jopt.step()
        jopt.clear_grad()
        for p, a in zip(tparams, g):
            p.grad = torch.tensor(a).to(torch.bfloat16)
        topt.step()
        topt.clear_grad()
        for jp, tp in zip(jparams, tparams):
            np.testing.assert_array_equal(
                tp.detach().float().numpy(), _np(jp).astype(np.float32))
    assert topt._step_count == jopt._step_count == 4


def test_resnet_imports_no_jax():
    code = ("import sys, paddle_tpu_torch.models.resnet, "
            "paddle_tpu_torch.nn.functional.fused_conv; "
            "assert 'jax' not in sys.modules; "
            "assert not any(m == 'paddle_tpu' or m.startswith('paddle_tpu.') "
            "for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], check=True)


def test_functionals_match_jax():
    """conv2d with the stem's asymmetric padding, per-dim padding,
    stride, dilation and groups in both layouts; max_pool2d with
    ceil_mode; adaptive_avg_pool2d; pad; batch norm train and infer."""
    import paddle_tpu.nn.functional as JF
    rng = np.random.RandomState(12)
    x = rng.randn(2, 6, 9, 7).astype(np.float32)
    w = rng.randn(4, 3, 3, 2).astype(np.float32)
    cases = [dict(padding=[2, 1, 2, 1]), dict(padding=1, stride=2),
             dict(padding=[1, 0], dilation=2, groups=2),
             dict(padding="SAME", stride=2), dict(padding="VALID")]
    for kw in cases:
        wi = w if "groups" in kw else rng.randn(4, 6, 3, 2).astype(
            np.float32)
        for df in ("NCHW", "NHWC"):
            xi = x if df == "NCHW" else x.transpose(0, 2, 3, 1)
            with HIGHEST:
                ref = _np(JF.conv2d(paddle.to_tensor(xi),
                                    paddle.to_tensor(wi), data_format=df,
                                    **kw))
            out = TF.conv2d(torch.tensor(xi), torch.tensor(wi),
                            data_format=df, **kw)
            np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5,
                                       atol=1e-5, err_msg=str((kw, df)))
    for kw in (dict(kernel_size=3, stride=2, padding=1),
               dict(kernel_size=2, stride=2, ceil_mode=True),
               dict(kernel_size=3, stride=2, padding=1, ceil_mode=True)):
        for df in ("NCHW", "NHWC"):
            xi = x if df == "NCHW" else x.transpose(0, 2, 3, 1)
            ref = _np(JF.max_pool2d(paddle.to_tensor(xi), data_format=df,
                                    **kw))
            out = TF.max_pool2d(torch.tensor(xi), data_format=df, **kw)
            np.testing.assert_array_equal(out.numpy(), ref)
    for size in (1, 3, (2, 4)):
        for df in ("NCHW", "NHWC"):
            xi = x if df == "NCHW" else x.transpose(0, 2, 3, 1)
            ref = _np(JF.adaptive_avg_pool2d(paddle.to_tensor(xi), size,
                                             data_format=df))
            out = TF.adaptive_avg_pool2d(torch.tensor(xi), size, df)
            np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6,
                                       atol=1e-6)
    for pad_, df in (([1, 0, 1, 0], "NCHW"), ([2, 1, 0, 3], "NHWC"),
                     ([0, 1, 1, 0, 2, 0, 0, 1], "NCHW")):
        ref = _np(JF.pad(paddle.to_tensor(x), pad_, data_format=df))
        np.testing.assert_array_equal(
            TF.pad(torch.tensor(x), pad_, data_format=df).numpy(), ref)
    g = (rng.rand(6) + 0.5).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    for df in ("NCHW", "NHWC"):
        xi = x if df == "NCHW" else x.transpose(0, 2, 3, 1)
        ref = JF.batch_norm_train(paddle.to_tensor(xi), paddle.to_tensor(g),
                                  paddle.to_tensor(b), 1e-5, df)
        out = TF.batch_norm_train(torch.tensor(xi), torch.tensor(g),
                                  torch.tensor(b), 1e-5, df)
        for o, r in zip(out, ref):
            np.testing.assert_allclose(o.numpy(), _np(r), rtol=1e-5,
                                       atol=1e-5)
        rm, rv = rng.randn(6).astype(np.float32), \
            (rng.rand(6) + 0.5).astype(np.float32)
        ref = JF.batch_norm_infer(paddle.to_tensor(xi), paddle.to_tensor(rm),
                                  paddle.to_tensor(rv), paddle.to_tensor(g),
                                  paddle.to_tensor(b), 1e-5, df)
        out = TF.batch_norm_infer(torch.tensor(xi), torch.tensor(rm),
                                  torch.tensor(rv), torch.tensor(g),
                                  torch.tensor(b), 1e-5, df)
        np.testing.assert_allclose(out.numpy(), _np(ref), rtol=1e-5,
                                   atol=1e-5)


def test_keys_and_parameter_order_equal_the_jax_model(trained_pair):
    """``state_dict`` keys (parameters, then buffers) and
    ``named_parameters`` order equal the JAX model's: ``convert.py``
    maps the optimizer state's ``param_{i}`` by that order."""
    jm, tm = trained_pair["jm"], trained_pair["tm"]
    assert list(tm.state_dict()) == list(jm.state_dict())
    assert [n for n, _ in tm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    assert [tuple(p.shape) for p in tm.parameters()] == \
        [tuple(p.shape) for p in jm.parameters()]
