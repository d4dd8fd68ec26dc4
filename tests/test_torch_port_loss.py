"""The port's loss functionals and loss layers against the JAX
package's, on the CPU in fp32, inputs made with numpy from a seed.

Forward values within 1e-5 (relative and absolute): the same fp32
arithmetic, reduced in another order. Gradients, where the JAX op is
differentiable, from ``jax.grad`` of the op's pure ``impl`` (``.raw``)
against ``torch.autograd``, of the sum of the output times a fixed
random cotangent, within 1e-4. ``hsigmoid_loss``'s layer takes its
weights from the JAX layer through ``convert.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import load_reference_hsigmoid_loss
from paddle_tpu_torch.nn import functional as TF

B, C = 6, 5
REDUCTIONS = ["mean", "sum", "none"]


def _rng(seed):
    return np.random.RandomState(seed)


def _randn(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _log_softmax(x, axis=-1):
    x = x - x.max(axis=axis, keepdims=True)
    return (x - np.log(np.exp(x).sum(axis=axis, keepdims=True))).astype(
        np.float32)


def _sigmoid(x):
    return (1.0 / (1.0 + np.exp(-x))).astype(np.float32)


def _signs(rng, *shape):
    return np.where(rng.rand(*shape) < 0.5, -1.0, 1.0).astype(np.float32)


def _np(x):
    return np.asarray(getattr(x, "_data", x))


def _to_jax(v):
    return jnp.asarray(v) if isinstance(v, np.ndarray) else v


def _to_torch(v):
    return torch.tensor(v) if isinstance(v, np.ndarray) else v


def check(name, args, kwargs=None, diff=(0,), seed=0, raw=False):
    """F.<name>(*args, **kwargs) in both packages: values, then the
    gradient wrt args[i] for i in ``diff`` (none when empty). ``raw``
    takes the JAX value from the op's ``impl`` too, past the public
    wrapper's shape checks."""
    kwargs = kwargs or {}
    jfn, tfn = getattr(JF, name), getattr(TF, name)
    jargs = [_to_jax(a) for a in args]
    jkw = {k: _to_jax(v) for k, v in kwargs.items()}
    targs = [_to_torch(a) for a in args]
    tkw = {k: _to_torch(v) for k, v in kwargs.items()}
    for i in diff:
        targs[i].requires_grad_()
    ref = _np((jfn.raw if raw else jfn)(*jargs, **jkw))
    out = tfn(*targs, **tkw)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5,
                               rtol=1e-5)
    if not diff:
        return
    cot = np.asarray(_rng(seed + 100).rand(*ref.shape), np.float32)

    def f(*d):
        full = list(jargs)
        for i, v in zip(diff, d):
            full[i] = v
        return jnp.sum(jfn.raw(*full, **jkw) * cot)

    jgrads = jax.grad(f, argnums=tuple(range(len(diff))))(
        *[jargs[i] for i in diff])
    (out * torch.tensor(cot)).sum().backward()
    for i, g in zip(diff, jgrads):
        np.testing.assert_allclose(targs[i].grad.numpy(), np.asarray(g),
                                   atol=1e-4, rtol=1e-4, err_msg=f"arg {i}")


# ------------------------------------------------------------ cross entropy

@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("ignore", [False, True])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_hard_labels(reduction, weighted, ignore, smoothing):
    rng = _rng(1)
    x = _randn(rng, B, C, scale=2.0)
    y = rng.randint(0, C, (B,)).astype(np.int64)
    if ignore:
        y[[1, 4]] = -100
    kw = dict(reduction=reduction, label_smoothing=smoothing)
    if weighted:
        kw["weight"] = rng.rand(C).astype(np.float32) + 0.5
    check("cross_entropy", [x, y], kw)


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("smoothing", [0.0, 0.2])
def test_cross_entropy_soft_labels(reduction, smoothing):
    rng = _rng(2)
    x = _randn(rng, B, C)
    soft = np.exp(_log_softmax(_randn(rng, B, C)))
    check("cross_entropy", [x, soft], dict(
        reduction=reduction, soft_label=True, label_smoothing=smoothing),
        diff=(0, 1))


@pytest.mark.parametrize("case", ["axis1", "trailing_one", "ignore_index",
                                  "alias"])
def test_cross_entropy_layouts(case):
    rng = _rng(3)
    if case == "axis1":        # [B, C, L] logits, [B, L] labels
        x = _randn(rng, B, C, 4)
        y = rng.randint(0, C, (B, 4)).astype(np.int64)
        check("cross_entropy", [x, y], dict(axis=1, weight=rng.rand(
            C).astype(np.float32), label_smoothing=0.1), raw=True)
    elif case == "trailing_one":
        x = _randn(rng, B, C)
        y = rng.randint(0, C, (B, 1)).astype(np.int64)
        check("cross_entropy", [x, y])
    elif case == "ignore_index":
        x = _randn(rng, B, C)
        y = rng.randint(0, C, (B,)).astype(np.int64)
        y[0] = 2
        check("cross_entropy", [x, y], dict(ignore_index=2))
    else:
        x = _randn(rng, B, C)
        y = rng.randint(0, C, (B,)).astype(np.int64)
        check("softmax_with_cross_entropy", [x, y])


def test_cross_entropy_weight_and_smoothing_no_longer_raise():
    loss = tnn.CrossEntropyLoss(weight=torch.ones(C), label_smoothing=0.1)(
        torch.zeros(2, C), torch.tensor([0, 1]))
    np.testing.assert_allclose(loss.item(), np.log(C), rtol=1e-6)


# ------------------------------------------------------------ the others

def _case(name, rng, reduction):
    """(args, kwargs, diff) of one functional's case."""
    x, y = _randn(rng, B, C), _randn(rng, B, C)
    r = {"reduction": reduction}
    if name == "nll_loss":
        lbl = rng.randint(0, C, (B,)).astype(np.int64)
        lbl[2] = -100
        return [_log_softmax(x), lbl], r, (0,)
    if name == "nll_loss_weighted":
        lbl = rng.randint(0, C, (B,)).astype(np.int64)
        lbl[2] = 1
        return [_log_softmax(x), lbl], dict(
            r, weight=rng.rand(C).astype(np.float32) + 0.5,
            ignore_index=1), (0,)
    if name in ("mse_loss", "l1_loss"):
        return [x, y], r, (0, 1)
    if name == "smooth_l1_loss":
        return [x, y], dict(r, delta=0.7), (0, 1)
    if name == "binary_cross_entropy":
        return [_sigmoid(x), rng.rand(B, C).astype(np.float32)], dict(
            r, weight=rng.rand(C).astype(np.float32)), (0, 1)
    if name == "binary_cross_entropy_with_logits":
        return [x, rng.rand(B, C).astype(np.float32)], dict(
            r, weight=rng.rand(C).astype(np.float32),
            pos_weight=rng.rand(C).astype(np.float32) + 1.0), (0, 1)
    if name == "kl_div":
        return [_log_softmax(x), np.exp(_log_softmax(y))], r, (0, 1)
    if name == "margin_ranking_loss":
        return [x[:, 0], y[:, 0], _signs(rng, B)], dict(r, margin=0.3), \
            (0, 1)
    if name == "hinge_embedding_loss":
        return [x, _signs(rng, B, C)], dict(r, margin=0.8), (0,)
    if name == "cosine_embedding_loss":
        return [x, y, _signs(rng, B)], dict(r, margin=0.2), (0, 1)
    if name == "triplet_margin_loss":
        return [x, y, _randn(rng, B, C)], dict(r, margin=0.5, p=1.5,
                                               swap=True), (0, 1, 2)
    if name == "sigmoid_focal_loss":
        return [x, (rng.rand(B, C) < 0.3).astype(np.float32)], dict(
            r, normalizer=np.float32(3.0), gamma=1.5), (0,)
    if name == "soft_margin_loss":
        return [x, _signs(rng, B, C)], r, (0,)
    if name == "multi_label_soft_margin_loss":
        return [x, (rng.rand(B, C) < 0.5).astype(np.float32)], dict(
            r, weight=rng.rand(C).astype(np.float32)), (0,)
    if name == "multi_margin_loss":
        return [x, rng.randint(0, C, (B,)).astype(np.int64)], dict(
            r, p=2, margin=0.7, weight=rng.rand(C).astype(np.float32)), (0,)
    if name == "multi_margin_loss_p1":
        return [x, rng.randint(0, C, (B,)).astype(np.int64)], r, (0,)
    raise KeyError(name)


OTHERS = ["nll_loss", "nll_loss_weighted", "mse_loss", "l1_loss",
          "smooth_l1_loss", "binary_cross_entropy",
          "binary_cross_entropy_with_logits", "kl_div",
          "margin_ranking_loss", "hinge_embedding_loss",
          "cosine_embedding_loss", "triplet_margin_loss",
          "sigmoid_focal_loss", "soft_margin_loss",
          "multi_label_soft_margin_loss", "multi_margin_loss",
          "multi_margin_loss_p1"]


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("name", OTHERS)
def test_loss_functional_matches_jax(name, reduction):
    args, kw, diff = _case(name, _rng(OTHERS.index(name) + 10), reduction)
    check(name.replace("_weighted", "").replace("_p1", ""), args, kw, diff)


@pytest.mark.parametrize("name", OTHERS)
def test_unknown_reduction_returns_the_unreduced_loss(name):
    """The JAX package's ``_reduce`` helpers reduce "mean" and "sum" and
    return any other word's loss unreduced; so does the port."""
    fn_name = name.replace("_weighted", "").replace("_p1", "")
    args, kw, diff = _case(name, _rng(OTHERS.index(name) + 10),
                           "elementwise")
    check(fn_name, args, kw, diff)
    targs = [_to_torch(a) for a in args]
    tkw = {k: _to_torch(v) for k, v in kw.items()}
    out = getattr(TF, fn_name)(*targs, **tkw)
    none = getattr(TF, fn_name)(*targs, **dict(tkw, reduction="none"))
    assert out.dim() > 0
    torch.testing.assert_close(out, none, atol=0, rtol=0)


def test_kl_div_batchmean_and_square_error_cost():
    rng = _rng(40)
    x, y = _log_softmax(_randn(rng, B, C)), np.exp(_log_softmax(
        _randn(rng, B, C)))
    check("kl_div", [x, y], dict(reduction="batchmean"), diff=(0, 1))
    check("square_error_cost", [_randn(rng, B, C), _randn(rng, B, C)],
          diff=(0, 1))


@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_ctc_loss_matches_jax(reduction):
    rng = _rng(41)
    t, b, c = 12, 3, 6
    lp = _log_softmax(_randn(rng, t, b, c))
    labels = rng.randint(1, c, (b, 4)).astype(np.int32)
    labels[0, 1] = labels[0, 0]              # a repeat needs a blank
    check("ctc_loss", [lp, labels, np.array([12, 10, 9], np.int32),
                       np.array([4, 3, 2], np.int32)],
          dict(blank=0, reduction=reduction))


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("swap", [False, True])
def test_triplet_margin_with_distance_loss_matches_jax(reduction, swap):
    rng = _rng(42)
    a, p, n = (_randn(rng, B, C) for _ in range(3))
    kw = dict(margin=0.4, swap=swap, reduction=reduction)
    ref = JF.triplet_margin_with_distance_loss(
        jnp.asarray(a), jnp.asarray(p), jnp.asarray(n), **kw)
    ta = torch.tensor(a, requires_grad=True)
    out = TF.triplet_margin_with_distance_loss(ta, torch.tensor(p),
                                               torch.tensor(n), **kw)
    np.testing.assert_allclose(out.detach().numpy(), _np(ref), atol=1e-5,
                               rtol=1e-5)
    # a distance callable on torch tensors: squared L2 against the
    # default's closed form
    sq = TF.triplet_margin_with_distance_loss(
        ta, torch.tensor(p), torch.tensor(n),
        distance_function=lambda u, v: (u - v).square().sum(-1), **kw)
    dp = ((a - p) ** 2).sum(-1)
    dn = ((a - n) ** 2).sum(-1)
    if swap:
        dn = np.minimum(dn, ((p - n) ** 2).sum(-1))
    want = np.maximum(dp - dn + 0.4, 0.0)
    want = {"mean": want.mean(), "sum": want.sum(), "none": want}[reduction]
    np.testing.assert_allclose(sq.detach().numpy(), want, atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("num_classes", [2, 5, 8])
@pytest.mark.parametrize("with_bias", [True, False])
def test_hsigmoid_loss_matches_jax(num_classes, with_bias):
    rng = _rng(43 + num_classes)
    feat = 7
    args = [_randn(rng, B, feat), rng.randint(0, num_classes, (B,)).astype(
        np.int64), num_classes, _randn(rng, num_classes - 1, feat)]
    kw = {"bias": _randn(rng, num_classes - 1)} if with_bias else {}
    check("hsigmoid_loss", args, kw, diff=(0, 3))


@pytest.mark.parametrize("normalized", [True, False])
@pytest.mark.parametrize("lengths", [False, True])
@pytest.mark.parametrize("ignored", [None, [3]])
def test_edit_distance_matches_jax(normalized, lengths, ignored):
    rng = _rng(44)
    a = rng.randint(0, 5, (4, 7)).astype(np.int64)
    b = rng.randint(0, 5, (4, 6)).astype(np.int64)
    kw = dict(normalized=normalized, ignored_tokens=ignored)
    if lengths:
        kw.update(input_length=np.array([7, 3, 0, 5], np.int64),
                  label_length=np.array([6, 6, 2, 0], np.int64))
    jd, jn = JF.edit_distance(jnp.asarray(a), jnp.asarray(b), **{
        k: _to_jax(v) for k, v in kw.items()})
    td, tn = TF.edit_distance(torch.tensor(a), torch.tensor(b), **{
        k: _to_torch(v) for k, v in kw.items()})
    assert td.dtype == torch.float32 and tuple(td.shape) == (4, 1)
    np.testing.assert_allclose(td.numpy(), _np(jd), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(tn.numpy(), _np(jn))


# ------------------------------------------------------------ layers

def _layer_case(name, rng):
    """(jax layer, port layer, inputs) of one loss layer."""
    x, y = _randn(rng, B, C), _randn(rng, B, C)
    w = rng.rand(C).astype(np.float32) + 0.5
    lbl = rng.randint(0, C, (B,)).astype(np.int64)
    if name == "CrossEntropyLoss":
        return dict(weight=w, label_smoothing=0.1, reduction="sum"), [x, lbl]
    if name in ("MSELoss", "L1Loss"):
        return dict(reduction="sum"), [x, y]
    if name == "BCELoss":
        return dict(weight=w), [_sigmoid(x), rng.rand(B, C).astype(
            np.float32)]
    if name == "BCEWithLogitsLoss":
        return dict(pos_weight=w), [x, rng.rand(B, C).astype(np.float32)]
    if name == "KLDivLoss":
        return dict(reduction="batchmean"), [_log_softmax(x),
                                             np.exp(_log_softmax(y))]
    if name == "SmoothL1Loss":
        return dict(delta=0.5), [x, y]
    if name == "NLLLoss":
        return dict(weight=w, ignore_index=2), [_log_softmax(x), lbl]
    if name == "CTCLoss":
        lp = _log_softmax(_randn(rng, 10, 2, C))
        return ([0, "sum"], {}), [lp, rng.randint(1, C, (2, 3)).astype(
            np.int32), np.array([10, 8], np.int32), np.array([3, 2],
                                                             np.int32)]
    if name == "CosineEmbeddingLoss":
        return ([0.1], {}), [x, y, _signs(rng, B)]
    if name == "HingeEmbeddingLoss":
        return ([], dict(margin=0.5)), [x, _signs(rng, B, C)]
    if name == "MarginRankingLoss":
        return ([0.2, "none"], {}), [x, y, _signs(rng, B, C)]
    if name == "TripletMarginLoss":
        return ([0.5, 1.0], dict(swap=True)), [x, y, _randn(rng, B, C)]
    if name == "MultiLabelSoftMarginLoss":
        return ([w], {}), [x, (rng.rand(B, C) < 0.5).astype(np.float32)]
    if name == "MultiMarginLoss":
        return ([2, 0.5, w], {}), [x, lbl]
    if name == "SoftMarginLoss":
        return (["sum"], {}), [x, _signs(rng, B, C)]
    if name == "TripletMarginWithDistanceLoss":
        return ([], dict(margin=0.3)), [x, y, _randn(rng, B, C)]
    raise KeyError(name)


LAYERS = ["CrossEntropyLoss", "MSELoss", "L1Loss", "BCELoss",
          "BCEWithLogitsLoss", "KLDivLoss", "SmoothL1Loss", "NLLLoss",
          "CTCLoss", "CosineEmbeddingLoss", "HingeEmbeddingLoss",
          "MarginRankingLoss", "TripletMarginLoss",
          "MultiLabelSoftMarginLoss", "MultiMarginLoss", "SoftMarginLoss",
          "TripletMarginWithDistanceLoss"]


@pytest.mark.parametrize("name", LAYERS)
def test_loss_layer_matches_jax(name):
    opts, inputs = _layer_case(name, _rng(LAYERS.index(name) + 60))
    pos, kw = opts if isinstance(opts, tuple) else ([], opts)
    jlayer = getattr(jnn, name)(*[_to_jax(v) for v in pos],
                                **{k: _to_jax(v) for k, v in kw.items()})
    tlayer = getattr(tnn, name)(*[_to_torch(v) for v in pos],
                                **{k: _to_torch(v) for k, v in kw.items()})
    ref = _np(jlayer(*[_to_jax(v) for v in inputs]))
    out = tlayer(*[_to_torch(v) for v in inputs])
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("bias", [True, False])
def test_hsigmoid_layer_with_converted_weights_matches_jax(bias):
    paddle.seed(7)
    kw = {} if bias else dict(bias_attr=False)
    jlayer = jnn.HSigmoidLoss(9, 6, **kw)
    tlayer = tnn.HSigmoidLoss(9, 6, device="cpu",
                              generator=torch.Generator().manual_seed(0),
                              **kw)
    assert tuple(tlayer.weight.shape) == (5, 9)
    assert (tlayer.bias is None) == (not bias)
    state = {k: np.asarray(v._data) for k, v in jlayer.state_dict().items()}
    load_reference_hsigmoid_loss(tlayer, state["weight"], state.get("bias"))
    rng = _rng(70)
    x = _randn(rng, B, 9)
    lbl = rng.randint(0, 6, (B,)).astype(np.int64)
    ref = _np(jlayer(jnp.asarray(x), jnp.asarray(lbl)))
    out = tlayer(torch.tensor(x), torch.tensor(lbl))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5,
                               rtol=1e-5)
    out.sum().backward()
    assert tlayer.weight.grad is not None
    with pytest.raises(NotImplementedError):
        tnn.HSigmoidLoss(9, 6, is_custom=True)
