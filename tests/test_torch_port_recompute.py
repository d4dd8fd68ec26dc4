"""The port's activation recompute against the JAX package's
(``tests/test_recompute.py``), on test-tiny in fp32 with the JAX weights
carried across by ``convert.load_reference_state``, and the other
``TrainStep`` options of the slice: ``offload_opt_state`` on a CPU
device, ``ResNet(recompute_stages=)`` and attention dropout inside a
step (ROADMAP C18, and the reference's one dropout mask per compiled
step, C19).

Tolerances against JAX: losses within 1e-5, gradients within 1e-5
absolute + 1e-4 relative (fp32 in both, summed in another order over
two layers), ``TrainStep`` parameters within 1e-4 absolute. Within the
port, recompute against no recompute is bitwise under every policy,
with and without dropout: the recomputation runs the same plain
versions on the same inputs, and the port's generators are put back to
the forward's state around it.
"""
import importlib

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as joptim
from paddle_tpu.distributed.fleet.utils import RecomputeConfig as JConfig
from paddle_tpu.jit.api import TrainStep as JTrainStep
from paddle_tpu.jit.api import _unwrap, _wrap, functional_call
from paddle_tpu.models.gpt import gpt as jax_gpt
import paddle_tpu.models.resnet as jresnet
from paddle_tpu import nn as jnn
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch.convert import (load_reference_optimizer_state,
                                      load_reference_state)
from paddle_tpu_torch.core import random as trandom
from paddle_tpu_torch.distributed.fleet.utils import (RecomputeConfig,
                                                      recompute)
from paddle_tpu_torch.distributed.parallel import RecomputeWrapper
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import fused_resnet as tfr
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.models.gpt import gpt
from paddle_tpu_torch.nn import CrossEntropyLoss, Linear
from paddle_tpu_torch.nn.functional import attention as tatt

# the module, which its package's ``recompute`` function shadows
precompute = importlib.import_module(
    "paddle_tpu_torch.distributed.parallel.recompute")
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
POLICIES = ["full", "dots_saveable", "dots_with_no_batch_dims_saveable"]


def _arrays(jax_model):
    return {k: np.asarray(v._data) for k, v in jax_model.state_dict().items()}


def _pair(seed=0, **overrides):
    paddle.seed(seed)
    jm = jax_gpt("test-tiny", **overrides)
    tm = gpt("test-tiny", device="cpu", **overrides)
    load_reference_state(tm, _arrays(jm))
    return jm, tm


def _ids(seed=0, shape=(2, 16)):
    return np.random.RandomState(seed).randint(0, 512, shape)


def _jax_loss_and_grads(jm, ids, policy):
    """The JAX test's ``_loss_and_grads``: the loss function wrapped per
    ``policy`` (None: no remat)."""
    names = [n for n, _ in jm.named_parameters()]
    pvals = [p._data for _, p in jm.named_parameters()]

    def loss_of(params):
        out = functional_call(jm, dict(zip(names, params)),
                              _wrap(ids.astype(np.int32)))
        return _unwrap(jm.loss(out, _wrap(ids.astype(np.int64))))

    fn = JConfig(policy).wrap(loss_of) if policy is not None else loss_of
    loss, grads = jax.jit(jax.value_and_grad(fn))(pvals)
    return float(loss), dict(zip(names, (np.asarray(g) for g in grads)))


def _port_loss_and_grads(tm, ids, policy, seed=None):
    """The port's loss and gradients, the model and loss wrapped as one
    region per ``policy`` (None: no recompute)."""
    x = torch.as_tensor(ids)

    def loss_of(inp):
        return tm.loss(tm(inp), inp)

    fn = RecomputeConfig(policy).wrap(loss_of, tm.modules()) \
        if policy is not None else loss_of
    tm.zero_grad(set_to_none=True)
    if seed is not None:
        trandom.seed(seed)
    loss = fn(x)
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in tm.named_parameters()}


def _assert_bitwise(got, ref):
    assert got[0] == ref[0]
    assert got[1].keys() == ref[1].keys()
    for n in ref[1]:
        assert torch.equal(got[1][n], ref[1][n]), n


# ------------------------------------------------------------ policies

@pytest.mark.parametrize("policy", POLICIES)
def test_loss_and_grads_match_no_remat_and_jax(policy):
    jm, tm = _pair()
    ids = _ids()
    ref = _port_loss_and_grads(tm, ids, None)
    got = _port_loss_and_grads(tm, ids, policy)
    _assert_bitwise(got, ref)
    j_loss, j_grads = _jax_loss_and_grads(jm, ids, policy)
    np.testing.assert_allclose(got[0], j_loss, atol=1e-5, rtol=1e-5)
    for n, g in got[1].items():
        np.testing.assert_allclose(g.numpy(), j_grads[n], err_msg=n,
                                   **GRAD_TOL)


@pytest.mark.parametrize("granularity", ["selective", "core_attn", "full",
                                         "dots_saveable",
                                         "nothing_saveable"])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_gpt_use_recompute_is_bitwise(granularity, dropout):
    """``GPTConfig(use_recompute=True)`` recomputes each block; from one
    generator state the loss and every gradient equal the run without
    recompute bit for bit, dropout masks included. Without dropout it
    also matches the JAX model with ``use_recompute``."""
    jm, tm = _pair(dropout=dropout)
    ids = _ids(1, (2, 24))
    ref = _port_loss_and_grads(tm, ids, None, seed=11)
    tm.cfg.use_recompute = True
    tm.cfg.recompute_granularity = granularity
    fwd0 = tfa.flash_attention_plain.calls
    xla0 = tatt.sdpa_xla.calls
    got = _port_loss_and_grads(tm, ids, None, seed=11)
    _assert_bitwise(got, ref)
    if dropout:
        # dropout routes attention to sdpa_xla, as the reference does;
        # each of the 2 blocks runs once forward, once recomputed
        assert tfa.flash_attention_plain.calls == fwd0
        assert tatt.sdpa_xla.calls - xla0 == 4
        return
    assert tfa.flash_attention_plain.calls - fwd0 == 4
    jm2, _ = _pair(dropout=dropout, use_recompute=True,
                   recompute_granularity=granularity)
    j_loss, j_grads = _jax_loss_and_grads(jm2, ids, None)
    np.testing.assert_allclose(got[0], j_loss, atol=1e-5, rtol=1e-5)
    for n, g in got[1].items():
        np.testing.assert_allclose(g.numpy(), j_grads[n], err_msg=n,
                                   **GRAD_TOL)


def test_recompute_outside_grad_mode_keeps_the_eval_path():
    """An eval-mode forward of a ``use_recompute`` model takes no
    region; its logits equal the plain model's."""
    _, tm = _pair()
    ids = torch.as_tensor(_ids())
    tm.eval()
    with torch.no_grad():
        ref = tm(ids)
    tm.cfg.use_recompute = True
    with torch.no_grad():
        assert torch.equal(tm(ids), ref)


# ------------------------------------------------------------ TrainStep

def _one_step(recompute_cfg, port):
    """One ``TrainStep`` with SGD(1e-2), as the JAX test takes it (the
    update is linear in the gradient)."""
    jm, tm = _pair()
    ids = _ids()
    if not port:
        opt = joptim.SGD(learning_rate=1e-2, parameters=jm.parameters())
        step = JTrainStep(jm, opt, lambda out, lbl: jm.loss(out, lbl),
                          recompute=recompute_cfg)
        loss = step(paddle.to_tensor(ids.astype(np.int32)),
                    paddle.to_tensor(ids.astype(np.int64)))
        return float(loss), {n: np.asarray(p._data)
                             for n, p in jm.named_parameters()}
    opt = toptim.SGD(learning_rate=1e-2, parameters=tm.parameters())
    step = tjit.TrainStep(tm, opt, lambda out, lbl: tm.loss(out, lbl),
                          recompute=recompute_cfg)
    loss = step(torch.as_tensor(ids), torch.as_tensor(ids))
    return float(loss), {n: p.detach().clone()
                         for n, p in tm.named_parameters()}


@pytest.mark.parametrize("cfg", ["full", "dots_saveable", "selective",
                                 "port_config"])
def test_trainstep_recompute_param_parity(cfg):
    ref_loss, ref_params = _one_step(None, port=True)
    port_cfg = RecomputeConfig("dots_saveable") if cfg == "port_config" \
        else cfg
    jax_cfg = JConfig("dots_saveable") if cfg == "port_config" else cfg
    loss, params = _one_step(port_cfg, port=True)
    assert loss == ref_loss
    for n in ref_params:
        assert torch.equal(params[n], ref_params[n]), n
    j_loss, j_params = _one_step(jax_cfg, port=False)
    np.testing.assert_allclose(loss, j_loss, atol=1e-5, rtol=1e-5)
    for n, p in params.items():
        np.testing.assert_allclose(p.numpy(), j_params[n], atol=1e-4,
                                   rtol=0, err_msg=n)


def test_trainstep_recompute_runs_the_kernels_twice_forward():
    """The whole loss is one region: each block's attention runs in the
    forward and again in the recomputation (the plain versions stand
    for the kernels on the CPU); the backward runs once."""
    _, tm = _pair()
    opt = toptim.SGD(learning_rate=1e-2, parameters=tm.parameters())
    step = tjit.TrainStep(tm, opt, lambda out, lbl: tm.loss(out, lbl),
                          recompute="full")
    ids = torch.as_tensor(_ids())
    fwd0 = tfa.flash_attention_plain.calls
    bwd0 = tfa.flash_attention_bwd_plain.calls
    step(ids, ids)
    assert tfa.flash_attention_plain.calls - fwd0 == 4
    assert tfa.flash_attention_bwd_plain.calls - bwd0 == 2


# ------------------------------------------------------------ config

def test_unknown_policy_rejected():
    with pytest.raises(ValueError, match="unknown recompute policy"):
        RecomputeConfig("save_everything_twice")
    with pytest.raises(ValueError, match="unknown recompute policy"):
        precompute.recompute(lambda x: x, torch.ones(1), policy="nope")


def test_none_policy_is_identity():
    cfg = RecomputeConfig(None)
    assert not cfg.enabled

    def fn(x):
        return x + 1
    assert cfg.wrap(fn) is fn
    x = torch.ones(2, requires_grad=True)
    out = recompute(fn, x, policy=RecomputeConfig(None))
    assert out.grad_fn is not None and "Checkpoint" not in \
        type(out.grad_fn).__name__


def test_raw_policy_function_accepted():
    """Where the JAX package takes a raw ``jax.checkpoint_policies``
    callable, the port takes a selective-checkpoint policy function."""
    raw = precompute._POLICIES["save_dots"]
    cfg = RecomputeConfig(raw)
    assert cfg.enabled and cfg.checkpoint_policy() is raw
    layer = Linear(8, 8, device="cpu",
                   generator=torch.Generator().manual_seed(3))
    x = torch.as_tensor(np.random.RandomState(0).randn(4, 8)
                        .astype(np.float32))
    assert torch.equal(recompute(layer, x, policy=raw), layer(x))


def test_recompute_policy_none_means_full():
    layer = Linear(8, 8, device="cpu",
                   generator=torch.Generator().manual_seed(3))
    x = torch.as_tensor(np.random.RandomState(0).randn(4, 8)
                        .astype(np.float32))
    out = recompute(layer, x, policy=None)
    assert torch.equal(out, layer(x))


def test_alias_policies_share_the_policy_function():
    assert RecomputeConfig("full").checkpoint_policy() is \
        RecomputeConfig("nothing_saveable").checkpoint_policy() is None
    assert RecomputeConfig("core_attn").checkpoint_policy() is \
        RecomputeConfig("dots_saveable").checkpoint_policy()
    assert RecomputeConfig("selective").checkpoint_policy() is \
        RecomputeConfig("dots_with_no_batch_dims_saveable") \
        .checkpoint_policy()
    jrec = importlib.import_module(
        "paddle_tpu.distributed.fleet.utils.recompute")
    trec = importlib.import_module(
        "paddle_tpu_torch.distributed.fleet.utils.recompute")
    assert set(trec._JAX_POLICIES) == set(jrec._JAX_POLICIES)


def test_selective_policies_keep_the_named_products():
    """"dots_saveable" keeps mm/addmm/bmm/baddbmm outputs and
    "dots_with_no_batch_dims_saveable" mm/addmm only; every other op is
    recomputed."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    both, no_batch = (precompute._POLICIES[k] for k in
                      ("save_dots", "save_dots_no_batch"))
    for op, in_both, in_no_batch in [
            (aten.mm.default, True, True), (aten.addmm.default, True, True),
            (aten.bmm.default, True, False),
            (aten.baddbmm.default, True, False),
            (aten.gelu.default, False, False),
            (aten.empty.memory_format, False, False)]:
        want = [CheckpointPolicy.MUST_SAVE if f else
                CheckpointPolicy.PREFER_RECOMPUTE
                for f in (in_both, in_no_batch)]
        assert [both(None, op), no_batch(None, op)] == want, op


def test_recompute_matches_direct_call_and_grads_flow():
    layer = Linear(8, 4, device="cpu",
                   generator=torch.Generator().manual_seed(3))
    x = torch.as_tensor(np.random.RandomState(0).randn(4, 8)
                        .astype(np.float32))
    # the reference's kwargs are accepted and dropped
    out = recompute(layer, x, use_reentrant=True, preserve_rng_state=False)
    assert torch.equal(out, layer(x))
    out = recompute(layer, x, policy="dots_saveable")
    out.mean().backward()
    assert layer.weight.grad is not None
    assert layer.weight.grad.abs().sum() > 0


def test_recompute_wrapper_gradients_bitwise():
    gen = torch.Generator().manual_seed(4)
    inner = Linear(6, 6, device="cpu", generator=gen)
    x = torch.as_tensor(np.random.RandomState(1).randn(3, 6)
                        .astype(np.float32))
    inner(x).square().sum().backward()
    ref = inner.weight.grad.clone()
    inner.weight.grad = None
    RecomputeWrapper(inner, policy="save_dots_no_batch")(x).square().sum() \
        .backward()
    assert torch.equal(inner.weight.grad, ref)


def test_typo_granularity_raises_not_falls_back():
    _, tm = _pair(use_recompute=True, recompute_granularity="core-attn")
    tm.train()
    with pytest.raises(ValueError, match="recompute_granularity"):
        tm(torch.as_tensor(_ids()))


def test_recompute_reenters_amp_state_and_training():
    """A region recomputed outside ``auto_cast`` and after ``eval()``
    runs as its forward ran: the gradients equal the run without
    recompute."""
    from paddle_tpu_torch import amp
    _, tm = _pair(dropout=0.1)
    ids = torch.as_tensor(_ids(2))

    def run(use):
        tm.cfg.use_recompute = use
        tm.train()
        tm.zero_grad(set_to_none=True)
        trandom.seed(3)
        with amp.auto_cast():
            loss = tm.loss(tm(ids), ids)
        tm.eval()
        loss.backward()
        return loss.item(), {n: p.grad.clone()
                             for n, p in tm.named_parameters()}

    ref = run(False)
    _assert_bitwise(run(True), ref)
    assert not amp.is_autocast_enabled() and not tm.training


# ------------------------------------------------------------ offload

def test_offload_on_a_cpu_device_is_off_and_bitwise():
    """The JAX package turns offload off where the device has no memory
    space of its own besides the host's; the port does so on the CPU."""
    runs = []
    for offload in (False, True):
        _, tm = _pair()
        opt = toptim.AdamW(1e-3, parameters=tm.parameters())
        step = tjit.TrainStep(tm, opt, lambda o, y: tm.loss(o, y),
                              offload_opt_state=offload)
        assert opt.offload_state is False
        ids = torch.as_tensor(_ids())
        losses = [float(step(ids, ids)) for _ in range(3)]
        runs.append((losses, [p.detach().clone() for p in tm.parameters()],
                     opt.state_dict()))
    (l0, p0, s0), (l1, p1, s1) = runs
    assert l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert s0.keys() == s1.keys()
    for k in s0:
        if k.startswith("param_"):
            for name in s0[k]:
                assert torch.equal(s0[k][name], s1[k][name])


# ------------------------------------------------------------ ResNet

HIGHEST = jax.default_matmul_precision("highest")


def _resnets(stages, seed=7):
    paddle.seed(seed)
    kw = dict(num_classes=10, data_format="NHWC", fused_bn=True,
              stem_space_to_depth=True, recompute_stages=stages)
    jm = jresnet.ResNet(jresnet.BottleneckBlock, [2, 1, 1, 2], **kw)
    tm = tresnet.ResNet(tresnet.BottleneckBlock, [2, 1, 1, 2],
                        device="cpu", **kw)
    load_reference_state(tm, {k: np.asarray(v._data) for k, v in
                              jm.state_dict().items()})
    return jm, tm


def _stats(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if k.endswith(("_mean", "_variance"))}


def test_resnet_recompute_stages_validated():
    with pytest.raises(ValueError, match="recompute_stages"):
        tresnet.ResNet(tresnet.BottleneckBlock, [1, 1, 1, 1],
                       recompute_stages=(0, 5), device="cpu")


def test_resnet_recompute_stages_in_trainstep():
    """``recompute_stages=(1, 2)`` inside ``TrainStep``: the step equals
    the one without recompute bit for bit, the running statistics stay
    as they were (the recomputed BN forwards move nothing), each
    recomputed block runs its forward kernels again (plain versions on
    the CPU) and its backward kernels once; the step matches the JAX
    step with the same stages (loss within 1e-4, parameters within
    1e-5 + 1e-4*max|p|, as tests/test_torch_port_resnet.py holds it).
    An eager forward takes the normal path."""
    rng = np.random.RandomState(10)
    img = rng.randn(2, 3, 64, 64).astype(np.float32)
    lbl = rng.randint(0, 10, (2,)).astype(np.int64)
    results = []
    for stages in ((), (1, 2)):
        jm, tm = _resnets(stages)
        tm.train()
        opt = toptim.Momentum(learning_rate=1e-3, momentum=0.9,
                              parameters=tm.parameters())
        ce = CrossEntropyLoss()
        step = tjit.TrainStep(tm, opt, lambda o, y: ce(o, y))
        before = _stats(tm)
        tfr.reset_counts()
        loss = float(step(torch.tensor(img), torch.tensor(lbl)))
        calls = [f.calls for f in tfr.PLAIN_VERSIONS]
        after = _stats(tm)
        assert all(torch.equal(before[k], after[k]) for k in before)
        results.append((loss, {n: p.detach().clone()
                               for n, p in tm.named_parameters()}, calls))
    (l0, p0, c0), (l1, p1, c1) = results
    assert l1 == l0
    assert all(torch.equal(p1[n], p0[n]) for n in p0)
    # stage 1: 2 blocks (the first with a downsample), stage 2: 1 block
    # with a downsample and stride 2 (its 3x3 on the ordinary conv):
    # 1x1 fwd +5, bn-relu 1x1 fwd +3, 3x3 fwd +2; backwards unchanged
    assert [b - a for a, b in zip(c0, c1)] == [5, 3, 0, 0, 2, 0]
    jopt = joptim.Momentum(learning_rate=1e-3, momentum=0.9,
                           parameters=jm.parameters())
    jce = jnn.CrossEntropyLoss()
    jm.train()
    jstep = paddle.jit.TrainStep(jm, jopt, lambda o, y: jce(o, y))
    with HIGHEST:
        j_loss = float(jstep(paddle.to_tensor(img), paddle.to_tensor(lbl)))
    np.testing.assert_allclose(l1, j_loss, rtol=1e-4, atol=1e-4)
    jparams = dict(jm.named_parameters())
    for n, p in p1.items():
        ref = np.asarray(jparams[n]._data)
        assert np.abs(p.numpy() - ref).max() <= \
            1e-5 + 1e-4 * np.abs(ref).max(), n
    # eager: the normal path, running statistics move
    _, tm = _resnets((1, 2))
    tm.train()
    before = _stats(tm)
    tfr.reset_counts()
    with torch.no_grad():
        tm(torch.tensor(img))
    assert [f.calls for f in tfr.PLAIN_VERSIONS][:2] == c0[:2]
    assert not torch.equal(before["bn1._mean"], _stats(tm)["bn1._mean"])


# ------------------------------------------------------------ C18, C19

def _attention_dropout_only(model):
    """Dropout on attention only: the embedding's and the MLPs' dropout
    layers set to p = 0 (they draw one mask per compiled step in the
    JAX package, C19)."""
    for name, m in model.named_sublayers() if hasattr(
            model, "named_sublayers") else model.named_modules():
        if type(m).__name__ == "Dropout":
            m.p = 0.0


def test_attention_dropout_is_off_inside_trainstep_c18():
    """The reference's traced ``TrainStep`` forward gets no dropout key,
    so its attention runs the XLA path without dropout; so does the
    port's (ROADMAP C18). An eager forward drops."""
    jm, tm = _pair(dropout=0.1)
    _attention_dropout_only(jm)
    _attention_dropout_only(tm)
    ids = _ids(3)
    jopt = joptim.SGD(learning_rate=0.0, parameters=jm.parameters())
    jstep = JTrainStep(jm, jopt, lambda o, y: jm.loss(o, y))
    j_loss = float(jstep(paddle.to_tensor(ids.astype(np.int32)),
                         paddle.to_tensor(ids.astype(np.int64))))
    topt = toptim.SGD(learning_rate=0.0, parameters=tm.parameters())
    tstep = tjit.TrainStep(tm, topt, lambda o, y: tm.loss(o, y))
    x = torch.as_tensor(ids)
    xla0, fwd0 = tatt.sdpa_xla.calls, tfa.flash_attention_plain.calls
    loss = float(tstep(x, x))
    assert tatt.sdpa_xla.calls - xla0 == 2
    assert tfa.flash_attention_plain.calls == fwd0
    np.testing.assert_allclose(loss, j_loss, atol=1e-5, rtol=1e-5)
    tm.eval()
    with torch.no_grad():
        ref = float(tm.loss(tm(x), x))
    assert loss == ref                           # no dropout in the step
    tm.train()
    with torch.no_grad():
        assert float(tm.loss(tm(x), x)) != ref   # eager: dropout


def test_jax_trainstep_draws_one_dropout_mask_c19():
    """The JAX ``F.dropout`` takes ``random.next_key()`` while
    ``TrainStep`` traces its step, so the key is a constant of the
    compiled step and every step draws the same mask: with lr 0 two
    steps give one loss. The port draws a fresh mask each step
    (Paddle's behaviour): its two losses differ (ROADMAP C19)."""
    jm, tm = _pair(dropout=0.1)
    ids = _ids(4)
    jopt = joptim.SGD(learning_rate=0.0, parameters=jm.parameters())
    jstep = JTrainStep(jm, jopt, lambda o, y: jm.loss(o, y))
    jx, jy = (paddle.to_tensor(ids.astype(np.int32)),
              paddle.to_tensor(ids.astype(np.int64)))
    j1, j2 = float(jstep(jx, jy)), float(jstep(jx, jy))
    assert j1 == j2
    topt = toptim.SGD(learning_rate=0.0, parameters=tm.parameters())
    tstep = tjit.TrainStep(tm, topt, lambda o, y: tm.loss(o, y))
    x = torch.as_tensor(ids)
    assert float(tstep(x, x)) != float(tstep(x, x))


def test_converted_optimizer_state_feeds_a_recomputed_step():
    """A JAX AdamW state carried across by the converter gives the same
    next recomputed step as the JAX one (parameters within 1e-4)."""
    jm, tm = _pair()
    ids = _ids(5)
    jopt = joptim.AdamW(1e-3, parameters=jm.parameters())
    jstep = JTrainStep(jm, jopt, lambda o, y: jm.loss(o, y),
                       recompute="full")
    jx, jy = (paddle.to_tensor(ids.astype(np.int32)),
              paddle.to_tensor(ids.astype(np.int64)))
    jstep(jx, jy)
    load_reference_state(tm, _arrays(jm))
    topt = toptim.AdamW(1e-3, parameters=tm.parameters())
    load_reference_optimizer_state(topt, jopt.state_dict())
    tstep = tjit.TrainStep(tm, topt, lambda o, y: tm.loss(o, y),
                           recompute="full")
    j_loss = float(jstep(jx, jy))
    x = torch.as_tensor(ids)
    np.testing.assert_allclose(float(tstep(x, x)), j_loss, atol=1e-5,
                               rtol=1e-5)
    jp = dict(jm.named_parameters())
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jp[n]._data), atol=1e-4,
                                   rtol=0, err_msg=n)


# ------------------------------------------------------------ attention dropout

@pytest.mark.parametrize("causal", [True, False])
def test_attention_dropout_matches_jax_with_its_mask(causal):
    """The port's internal form takes the keep mask the JAX package
    draws (``jax.random.bernoulli(key, 1 - p, probs.shape)``): the output
    within 1e-5 and the gradients of q, k, v within 1e-4 of
    ``_sdpa_xla(..., dropout_rng=key)``'s."""
    from paddle_tpu.nn.functional.attention import _sdpa_xla as j_sdpa
    rng = np.random.RandomState(6)
    q, k, v = (rng.randn(2, 12, 4, 16).astype(np.float32) for _ in range(3))
    w = rng.randn(2, 12, 4, 16).astype(np.float32)
    key, p = jax.random.PRNGKey(3), 0.1
    keep = np.array(jax.random.bernoulli(key, 1.0 - p, (2, 4, 12, 12)))
    assert 0 < keep.mean() < 1

    def j_loss(q_, k_, v_):
        return (j_sdpa(q_, k_, v_, None, p, causal, None, key) * w).sum()

    ref = np.asarray(j_sdpa(q, k, v, None, p, causal, None, key))
    j_grads = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2)))(q, k, v)
    tq_, tk_, tv_ = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = tatt._sdpa_xla(tq_, tk_, tv_, None, causal, None, p,
                         torch.from_numpy(keep))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5,
                               rtol=1e-5)
    (out * torch.from_numpy(w)).sum().backward()
    for t, g in zip((tq_, tk_, tv_), j_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-4,
                                   rtol=1e-4)


def test_attention_dropout_routes_to_xla_and_draws_from_the_generator():
    """Dropout in training never takes the flash path (the reference's
    gate); its mask comes from the device's default generator, so a
    seed repeats it; eval drops ``dropout_p`` and takes the flash path
    again."""
    from paddle_tpu_torch.nn import functional as F
    rng = np.random.RandomState(7)
    q, k, v = (torch.from_numpy(rng.randn(1, 8, 2, 16).astype(np.float32))
               for _ in range(3))
    xla0, fwd0 = tatt.sdpa_xla.calls, tfa.flash_attention_plain.calls
    trandom.seed(1)
    a = F.scaled_dot_product_attention(q, k, v, dropout_p=0.5,
                                       is_causal=True, training=True)
    trandom.seed(1)
    b = F.scaled_dot_product_attention(q, k, v, dropout_p=0.5,
                                       is_causal=True, training=True)
    c = F.scaled_dot_product_attention(q, k, v, dropout_p=0.5,
                                       is_causal=True, training=True)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert tatt.sdpa_xla.calls - xla0 == 3
    assert tfa.flash_attention_plain.calls == fwd0
    plain = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    ev = F.scaled_dot_product_attention(q, k, v, dropout_p=0.5,
                                        is_causal=True, training=False)
    assert torch.equal(ev, plain)
    assert tfa.flash_attention_plain.calls - fwd0 == 2
    # p = 0.5 keeps about half and doubles what it keeps
    none = tatt._sdpa_xla(q, k, v, None, True, None)
    half = torch.ones((1, 2, 8, 8), dtype=torch.bool)
    half[..., ::2] = False
    got = tatt._sdpa_xla(q, k, v, None, True, None, 0.5, half)
    assert not torch.equal(got, none)
