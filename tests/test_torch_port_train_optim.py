"""The port's optimizers, gradient clips, LR schedules and ``TrainStep``
against the JAX package's.

Inputs come from a numpy seed and go through both packages. The JAX
optimizers run through ``apply_gradients`` (the rule its ``TrainStep``
uses), the port's through its in-place ``apply_gradients``.
Tolerances: fp32 updates within 1e-6 absolute + 1e-5 relative after
several steps (Adam divides by sqrt(v), which turns last-bit
differences of tiny moments into slightly larger ones); schedules
exactly equal up to float rounding (1e-12), being the same Python
arithmetic; ``TrainStep`` losses within 1e-4 and parameters within
5e-5 after 10 steps on test-tiny (fp32 forward and backward summed in
another order, then 10 Adam steps at lr 1e-3).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.models.gpt import gpt as jax_gpt
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import (load_reference_optimizer_state,
                                      load_reference_state)
from paddle_tpu_torch.models.gpt import gpt
from paddle_tpu_torch.optimizer import lr as tlr

UPD_TOL = dict(atol=1e-6, rtol=1e-5)
SHAPES = [(8, 16), (16,), (3, 5, 7)]


def _f32(a):
    return np.asarray(a).astype(np.float32)


def _clip(kind, lib):
    return {"none": None,
            "global": lambda: lib.ClipGradByGlobalNorm(0.5),
            "norm": lambda: lib.ClipGradByNorm(0.3),
            "value": lambda: lib.ClipGradByValue(0.05)}[kind]


def _run_both(cls, kw, clip, dtype, steps=4):
    """``steps`` updates of random params with random gradients through
    both packages; returns (jax params, jax state, port params, port
    state) as float32 numpy."""
    rng = np.random.RandomState(7)
    p0 = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[rng.randn(*s).astype(np.float32) * 0.1 for s in SHAPES]
             for _ in range(steps)]
    jclip, tclip = _clip(clip, jopt), _clip(clip, topt)
    jo = getattr(jopt, cls)(learning_rate=1e-2, grad_clip=jclip and jclip(),
                            **kw)
    jp = [jnp.asarray(p, dtype) for p in p0]
    js = [jo.init_state_for(p) for p in jp]
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tp = [torch.tensor(p).to(tdt) for p in p0]
    to = getattr(topt, cls)(learning_rate=1e-2, parameters=tp,
                            grad_clip=tclip and tclip(), **kw)
    for i, gs in enumerate(grads):
        jp, js = jo.apply_gradients(jp, [jnp.asarray(g, dtype) for g in gs],
                                    js, lr=1e-2, step=i + 1)
        to.apply_gradients(tp, [torch.tensor(g).to(tdt) for g in gs],
                           lr=1e-2, step=i + 1)
    return ([_f32(p) for p in jp], [{k: _f32(v) for k, v in s.items()}
                                    for s in js],
            [p.float().numpy() for p in tp],
            [{k: v.float().numpy() for k, v in to._state[p].items()}
             for p in tp])


@pytest.mark.parametrize("cls,kw", [
    ("Adam", {}),
    ("Adam", dict(weight_decay=0.1)),          # coupled L2 on the grad
    ("AdamW", {}),
    ("AdamW", dict(weight_decay=0.2, beta1=0.8, epsilon=1e-6)),
])
@pytest.mark.parametrize("clip", ["none", "global"])
def test_adam_updates_match(cls, kw, clip):
    jp, js, tp, ts = _run_both(cls, kw, clip, jnp.float32)
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b, a, **UPD_TOL)
    for a, b in zip(js, ts):
        assert sorted(a) == sorted(b) == ["moment1", "moment2"]
        for k in a:
            np.testing.assert_allclose(b[k], a[k], err_msg=k, **UPD_TOL)


@pytest.mark.parametrize("cls", ["Adam", "AdamW"])
def test_multi_precision_bf16_matches(cls):
    """bf16 params under multi_precision: fp32 masters and moments
    compared in fp32; the bf16 params are the masters' rounding."""
    jp, js, tp, ts = _run_both(cls, dict(multi_precision=True), "global",
                               jnp.bfloat16)
    for a, b in zip(js, ts):
        assert sorted(a) == sorted(b) == ["master", "moment1", "moment2"]
        for k in a:
            np.testing.assert_allclose(b[k], a[k], err_msg=k, **UPD_TOL)
    for p, s in zip(tp, ts):
        np.testing.assert_array_equal(
            p, torch.tensor(s["master"]).bfloat16().float().numpy())
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b, a, atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("kind", ["global", "norm", "value"])
def test_grad_clips_match(kind):
    rng = np.random.RandomState(8)
    gs = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    ref = _clip(kind, jopt)()([jnp.asarray(g) for g in gs])
    out = _clip(kind, topt)()([torch.tensor(g) for g in gs])
    for a, b in zip(ref, out):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-7,
                                   rtol=1e-6)


def test_eager_step_and_minimize():
    """opt.step() on .grad (skipping params without one) and minimize()
    follow apply_gradients and advance the step count."""
    w = torch.nn.Parameter(torch.ones(3))
    unused = torch.nn.Parameter(torch.ones(2))
    opt = topt.AdamW(0.1, parameters=[w, unused])
    (w * torch.tensor([1.0, 2.0, 3.0])).sum().backward()
    opt.step()
    assert opt._step_count == 1 and unused.grad is None
    assert torch.equal(unused.detach(), torch.ones(2))
    ref = torch.ones(3) * (1 - 0.1 * 0.01) - 0.1
    torch.testing.assert_close(w.detach(), ref)
    opt.minimize((w ** 2).sum())
    assert opt._step_count == 2 and w.grad is None


# ------------------------------------------------------------ schedules

def _schedulers(lib):
    return {
        "NoamDecay": lambda: lib.NoamDecay(64, 10, learning_rate=2.0),
        "PiecewiseDecay": lambda: lib.PiecewiseDecay([5, 20],
                                                     [0.1, 0.05, 0.01]),
        "NaturalExpDecay": lambda: lib.NaturalExpDecay(0.5, 0.1),
        "InverseTimeDecay": lambda: lib.InverseTimeDecay(0.5, 0.1),
        "PolynomialDecay": lambda: lib.PolynomialDecay(0.5, 20, power=2.0),
        "PolynomialDecay_cycle": lambda: lib.PolynomialDecay(
            0.5, 15, cycle=True),
        "LinearWarmup": lambda: lib.LinearWarmup(0.5, 10, 0.0, 0.5),
        "LinearWarmup_sched": lambda: lib.LinearWarmup(
            lib.CosineAnnealingDecay(0.5, 30), 10, 0.0, 0.5),
        "ExponentialDecay": lambda: lib.ExponentialDecay(0.5, 0.9),
        "MultiStepDecay": lambda: lib.MultiStepDecay(0.5, [10, 25, 40]),
        "StepDecay": lambda: lib.StepDecay(0.5, 7, gamma=0.5),
        "LambdaDecay": lambda: lib.LambdaDecay(0.5, lambda e: 0.95 ** e),
        "CosineAnnealingDecay": lambda: lib.CosineAnnealingDecay(0.5, 25,
                                                                 0.01),
        "OneCycleLR": lambda: lib.OneCycleLR(0.5, 40),
        "OneCycleLR_linear": lambda: lib.OneCycleLR(
            0.5, 40, anneal_strategy="linear"),
        "CyclicLR": lambda: lib.CyclicLR(0.01, 0.5, 6),
        "CyclicLR_tri2": lambda: lib.CyclicLR(0.01, 0.5, 4, 8,
                                              mode="triangular2"),
        "CyclicLR_exp": lambda: lib.CyclicLR(0.01, 0.5, 5, mode="exp_range",
                                             exp_gamma=0.97),
    }


@pytest.mark.parametrize("name", sorted(_schedulers(tlr)))
def test_scheduler_sequence_matches(name):
    j, t = _schedulers(jlr)[name](), _schedulers(tlr)[name]()
    seq_j, seq_t = [], []
    for _ in range(50):
        seq_j.append(j())
        seq_t.append(t())
        j.step()
        t.step()
    np.testing.assert_allclose(seq_t, seq_j, rtol=1e-12, atol=0)
    assert t.state_dict() == j.state_dict()


def test_reduce_on_plateau_matches():
    metrics = np.random.RandomState(9).rand(50) + np.linspace(1, 0.9, 50)
    j = jlr.ReduceOnPlateau(0.5, patience=2, cooldown=1)
    t = tlr.ReduceOnPlateau(0.5, patience=2, cooldown=1)
    for m in metrics:
        j.step(float(m))
        t.step(float(m))
        assert t() == j()
    assert t() < 0.5


def test_every_scheduler_class_is_covered():
    covered = {n.split("_")[0] for n in _schedulers(tlr)} | {
        "ReduceOnPlateau"}
    classes = {n for n, c in vars(tlr).items() if isinstance(c, type)
               and issubclass(c, tlr.LRScheduler) and c is not
               tlr.LRScheduler}
    assert classes == covered


def test_scheduler_drives_the_optimizer_per_step():
    w = torch.nn.Parameter(torch.ones(2))
    sched = tlr.LinearWarmup(0.5, 4, 0.0, 0.5)
    opt = topt.Adam(sched, parameters=[w])
    seen = []
    for _ in range(6):
        seen.append(opt.get_lr())
        w.sum().backward()
        opt.step()
        opt.clear_grad()
    np.testing.assert_allclose(seen, [0.0, 0.125, 0.25, 0.375, 0.5, 0.5])
    with pytest.raises(RuntimeError):
        opt.set_lr(0.1)


# ------------------------------------------------------------ TrainStep

def _arrays(jax_model):
    return {k: np.asarray(v._data) for k, v in jax_model.state_dict().items()}


def _steps_pair(**overrides):
    paddle.seed(0)
    jm = jax_gpt("test-tiny", **overrides)
    tm = gpt("test-tiny", device="cpu", **overrides)
    load_reference_state(tm, _arrays(jm))
    jo = jopt.AdamW(1e-3, parameters=jm.parameters(),
                    grad_clip=jopt.ClipGradByGlobalNorm(1.0))
    to = topt.AdamW(1e-3, parameters=tm.parameters(),
                    grad_clip=topt.ClipGradByGlobalNorm(1.0))
    js = paddle.jit.TrainStep(jm, jo, lambda o, y: jm.loss(o, y))
    ts = tjit.TrainStep(tm, to, lambda o, y: tm.loss(o, y))
    return jm, tm, jo, to, js, ts


def _batch(seed, shape=(2, 33)):
    ids = np.random.RandomState(seed).randint(0, 512, shape)
    return ((paddle.to_tensor(ids.astype(np.int32)),
             paddle.to_tensor(ids.astype(np.int64))),
            (torch.as_tensor(ids), torch.as_tensor(ids)))


def _assert_params_close(jm, tm, atol=5e-5):
    ja = _arrays(jm)
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ja[k], atol=atol, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("fused", [False, True])
def test_train_step_tracks_jax_for_10_steps(fused):
    kw = dict(fused_lm_loss=True, lm_loss_chunk=8,
              lm_loss_save_logits_budget=0) if fused else {}
    jm, tm, jo, to, js, ts = _steps_pair(**kw)
    jb, tb = _batch(0)
    jl, tl = [], []
    for _ in range(10):
        jl.append(float(np.asarray(js(*jb)._data)))
        tl.append(ts(*tb).item())
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
    assert tl[-1] < tl[0]
    assert to._step_count == jo._step_count == 10
    _assert_params_close(jm, tm)


def test_skip_nonfinite_keeps_params_and_state():
    paddle.seed(0)
    tm = gpt("test-tiny", device="cpu",
             generator=torch.Generator().manual_seed(0))
    to = topt.AdamW(1e-3, parameters=tm.parameters())
    poison = {"on": False}

    def loss_fn(out, y):
        loss = tm.loss(out, y)
        return loss * math.inf if poison["on"] else loss

    ts = tjit.TrainStep(tm, to, loss_fn, skip_nonfinite=True)
    _, tb = _batch(1)
    ts(*tb)
    params = {k: v.clone() for k, v in tm.state_dict().items()}
    state = {i: {k: v.clone() for k, v in st.items()}
             for i, st in enumerate(to._state.values())}
    poison["on"] = True
    loss = ts(*tb)
    assert math.isinf(loss.item())
    for k, v in tm.state_dict().items():
        assert torch.equal(v, params[k]), k
    for i, st in enumerate(to._state.values()):
        for k, v in st.items():
            assert torch.equal(v, state[i][k]), (i, k)
    assert to._step_count == 2          # the count advances, as in JAX
    poison["on"] = False
    assert math.isfinite(ts(*tb).item())
    assert not torch.equal(tm.state_dict()["gpt.ln_f.bias"],
                           params["gpt.ln_f.bias"])


def test_carried_optimizer_state_reproduces_the_next_step():
    """Three JAX steps, then weights and optimizer state (moments,
    masters, step count) carried into fresh port objects: the fourth
    step matches."""
    jm, _, jo, _, js, _ = _steps_pair()
    for seed in (2, 3, 4):
        js(*_batch(seed)[0])
    tm = gpt("test-tiny", device="cpu")
    load_reference_state(tm, _arrays(jm))
    to = topt.AdamW(1e-3, parameters=tm.parameters(),
                    grad_clip=topt.ClipGradByGlobalNorm(1.0))
    sd = jo.state_dict()
    load_reference_optimizer_state(to, sd)
    assert to._step_count == 3
    ts = tjit.TrainStep(tm, to, lambda o, y: tm.loss(o, y))
    jb, tb = _batch(5)
    np.testing.assert_allclose(ts(*tb).item(),
                               float(np.asarray(js(*jb)._data)), atol=1e-5)
    _assert_params_close(jm, tm, atol=1e-5)
    bad = dict(sd, param_0={"moment1": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        load_reference_optimizer_state(to, bad)


def test_multi_precision_state_carries_masters():
    """bf16 params with multi_precision: the JAX fp32 masters come
    across bitwise and the bf16 params stay their rounding."""
    paddle.seed(0)
    jm = jax_gpt("test-tiny")
    jm.bfloat16()
    jo = jopt.AdamW(1e-3, parameters=jm.parameters(), multi_precision=True)
    js = paddle.jit.TrainStep(jm, jo, lambda o, y: jm.loss(o, y))
    js(*_batch(6)[0])
    tm = gpt("test-tiny", device="cpu", dtype=torch.bfloat16)
    load_reference_state(tm, _arrays(jm))
    to = topt.AdamW(1e-3, parameters=tm.parameters(), multi_precision=True)
    sd = jo.state_dict()
    load_reference_optimizer_state(to, sd)
    for i, p in enumerate(tm.parameters()):
        st = to._state[p]
        assert st["master"].dtype == torch.float32
        np.testing.assert_array_equal(st["master"].numpy(),
                                      sd[f"param_{i}"]["master"])
        assert torch.equal(st["master"].bfloat16(), p.detach())


def test_unported_train_step_options_raise():
    tm = gpt("test-tiny", device="cpu")
    opt = topt.AdamW(1e-3, parameters=tm.parameters())
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        tjit.TrainStep(tm, opt, tm.loss, sharding=object())
    # ported: offload and recompute build
    tjit.TrainStep(tm, opt, tm.loss, offload_opt_state=True,
                   recompute="full")
    ts = tjit.TrainStep(tm, opt, tm.loss)
    for call in (ts.enable_warm_start, ts.audit, ts.cost_analysis):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
