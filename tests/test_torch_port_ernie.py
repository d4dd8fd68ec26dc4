"""The port's ERNIE / BERT (``paddle_tpu_torch.models.ernie``) against
the JAX package's, on test-tiny in fp32 with the JAX weights carried
across by ``convert.load_reference_state``; plus the pieces of A2 it
brought (``nn.initializer``, ``LayerList``, ``gelu``/``tanh``,
``mp_layers.sharded_constraint``).

Tolerances: logits, pooled output and classifier logits within 1e-4
(the same fp32 arithmetic, sums in another order: XLA against PyTorch's
CPU BLAS, over two layers); the MLM + SOP loss, dense and fused, within
1e-5; gradients within 1e-5 absolute + 1e-4 relative, as GPT's; three
``TrainStep``s of AdamW within 1e-4. Incremental encoding is held to
the JAX cached forward within 1e-4, and a 4-token append to four
1-token appends within the reference's own 2e-4
(``tests/test_generation.py::test_ernie_incremental_encoding_consistency``).
Recompute is held bitwise to none.
"""
import importlib

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.api import functional_call
from paddle_tpu_torch import convert
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch.distributed.parallel import sharded_constraint
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.kernels import row_linear as rl
from paddle_tpu_torch.nn import LayerList, functional as F, initializer as I
from paddle_tpu_torch.nn.layers_common import Embedding, Linear

jax_ernie = importlib.import_module("paddle_tpu.models.ernie")
ternie = importlib.import_module("paddle_tpu_torch.models.ernie")

TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


def _arrays(jm):
    return {k: np.asarray(v._data) for k, v in jm.state_dict().items()}


def _pair(seed=0, **overrides):
    paddle.seed(seed)
    jm = jax_ernie.ernie("test-tiny", **overrides)
    tm = ternie.ernie("test-tiny", device="cpu", **overrides)
    convert.load_reference_state(tm, _arrays(jm))
    return jm, tm


@pytest.fixture(scope="module")
def pair():
    jm, tm = _pair()
    jm.eval()
    return jm, tm.eval()


def _batch(seed=0, b=2, s=16, masked=0.3):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 512, (b, s))
    tt = rng.randint(0, 4, (b, s))
    mlm = ids.copy()
    mlm[rng.rand(b, s) > masked] = -100
    sop = rng.randint(0, 2, (b,))
    return ids, tt, mlm, sop


def _j(a):
    return paddle.to_tensor(np.asarray(a, np.int32))


def _t(a):
    return torch.as_tensor(np.asarray(a, np.int64))


def _np(x):
    return np.asarray(x._data) if hasattr(x, "_data") else \
        x.detach().float().numpy()


# ---------------------------------------------------------- converter

def test_converter_round_trips_with_the_tied_embedding_once(pair):
    jm, tm = pair
    arrays = _arrays(jm)
    own = tm.state_dict()
    assert list(own) == list(arrays)
    assert not any(k.startswith("mlm_head.") and "word_embeddings" in k
                   for k in own)
    for name, t in own.items():
        np.testing.assert_array_equal(t.numpy(), arrays[name], err_msg=name)
    back = {k: v.numpy() for k, v in own.items()}
    tm2 = ternie.ernie("test-tiny", device="cpu")
    convert.load_reference_state(tm2, back)
    for (n1, a), (n2, b) in zip(tm.state_dict().items(),
                                tm2.state_dict().items()):
        assert n1 == n2 and torch.equal(a, b)
    arrays["mlm_head.word_embeddings.weight"] = \
        arrays["ernie.embeddings.word_embeddings.weight"]
    with pytest.raises(KeyError):
        convert.load_reference_state(tm2, arrays)


def test_num_params_and_flops_match(pair):
    jm, tm = pair
    assert tm.num_params() == jm.num_params()
    for s in (16, 512):
        assert tm.flops_per_token(s) == jm.flops_per_token(s)


def test_dtypes_follow_the_reference():
    """decoder_bias is built fp32 at any model dtype; ``.bfloat16()``
    casts every floating parameter, as the reference's ``to`` does."""
    paddle.seed(0)
    jm = jax_ernie.ernie("test-tiny").bfloat16()
    tm = ternie.ernie("test-tiny", device="cpu").bfloat16()
    jd = {k: str(np.asarray(v._data).dtype) for k, v in
          jm.state_dict().items()}
    td = {k: str(v.dtype).replace("torch.", "") for k, v in
          tm.state_dict().items()}
    assert jd == td
    built = ternie.ernie("test-tiny", device="cpu", dtype=torch.bfloat16)
    assert built.mlm_head.decoder_bias.dtype == torch.float32
    assert built.mlm_head.transform.weight.dtype == torch.bfloat16


# ------------------------------------------------------------ forward

@pytest.mark.parametrize("mask", [False, True])
def test_pretraining_logits_and_pooled_match(pair, mask):
    jm, tm = pair
    ids, tt, _, _ = _batch(1)
    m = None
    if mask:
        m = np.ones(ids.shape, np.int32)
        m[0, 11:] = 0
        m[1, 5:] = 0
    jmask = None if m is None else _j(m)
    tmask = None if m is None else _t(m)
    jl, js = jm(_j(ids), _j(tt), jmask)
    with torch.no_grad():
        tl, ts = tm(_t(ids), _t(tt), tmask)
        tseq, tpool = tm.ernie(_t(ids), _t(tt), tmask)
    jseq, jpool = jm.ernie(_j(ids), _j(tt), jmask)
    for got, ref in ((tl, jl), (ts, js), (tseq, jseq), (tpool, jpool)):
        np.testing.assert_allclose(_np(got), _np(ref), **TOL)


def test_padding_mask_blocks_attention(pair):
    """Padded positions do not move the others (the reference's test),
    and the masked run matches JAX's."""
    jm, tm = pair
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 512, (1, 8))
    mask = np.ones((1, 8), np.int32)
    mask[0, 6:] = 0
    ids2 = ids.copy()
    ids2[0, 6:] = rng.randint(0, 512, (2,))
    with torch.no_grad():
        out1, _ = tm.ernie(_t(ids), None, _t(mask))
        out2, _ = tm.ernie(_t(ids2), None, _t(mask))
    np.testing.assert_allclose(out1[0, :6].numpy(), out2[0, :6].numpy(),
                               rtol=2e-5, atol=2e-5)
    ref, _ = jm.ernie(_j(ids), None, _j(mask))
    np.testing.assert_allclose(out1.numpy(), _np(ref), **TOL)


def test_classifier_logits_match():
    paddle.seed(2)
    cfg = jax_ernie.CONFIGS["test-tiny"]
    jm = jax_ernie.ErnieForSequenceClassification(cfg, num_classes=3)
    jm.eval()
    tm = ternie.ErnieForSequenceClassification(
        ternie.CONFIGS["test-tiny"], num_classes=3, device="cpu").eval()
    convert.load_reference_state(tm, _arrays(jm))
    ids, tt, _, _ = _batch(3, s=10)
    with torch.no_grad():
        got = tm(_t(ids), _t(tt))
    np.testing.assert_allclose(got.numpy(), _np(jm(_j(ids), _j(tt))), **TOL)
    assert tuple(got.shape) == (2, 3)


def test_layers_without_a_pooler_refuse_the_heads():
    cfg = ternie.ErnieConfig(vocab_size=64, hidden_size=16, num_layers=1,
                             num_heads=2, with_pooler=False)
    with pytest.raises(ValueError, match="pooler"):
        ternie.ErnieForPretraining(cfg, device="cpu")
    with pytest.raises(ValueError, match="pooler"):
        ternie.ErnieForSequenceClassification(cfg, device="cpu")


# ------------------------------------------------ loss and gradients

def _jax_loss_and_grads(jm, ids, tt, mlm, sop):
    names = [n for n, _ in jm.named_parameters()]
    vals = [p._data for _, p in jm.named_parameters()]
    y = (paddle.to_tensor(mlm.astype(np.int64)),
         paddle.to_tensor(sop.astype(np.int64)))

    def loss_of(pvals):
        out = functional_call(jm, dict(zip(names, pvals)), _j(ids), _j(tt))
        return jm.loss(out, y)._data

    loss, grads = jax.jit(jax.value_and_grad(loss_of))(vals)
    return float(loss), dict(zip(names, (np.asarray(g) for g in grads)))


@pytest.mark.parametrize("case", ["dense", "fused", "fused_truncated"])
def test_loss_and_every_gradient_match(case):
    overrides = {"dense": {},
                 "fused": dict(fused_mlm_loss=True),
                 # fewer slots than some rows' masked positions
                 "fused_truncated": dict(fused_mlm_loss=True,
                                         max_predictions=3)}[case]
    jm, tm = _pair(**overrides)
    ids, tt, mlm, sop = _batch(4, masked=0.35)
    ref_loss, ref_grads = _jax_loss_and_grads(jm, ids, tt, mlm, sop)
    loss = tm.loss(tm(_t(ids), _t(tt)), (_t(mlm), _t(sop)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref_loss, atol=1e-5, rtol=1e-5)
    names = [n for n, _ in tm.named_parameters()]
    assert names == list(ref_grads)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name],
                                   err_msg=name, **GRAD_TOL)


def test_fused_loss_equals_the_dense_loss():
    """With every masked position inside max_predictions, the gathered
    head gives the dense head's loss."""
    _, dense = _pair()
    _, fused = _pair(fused_mlm_loss=True, max_predictions=16)
    ids, tt, mlm, sop = _batch(5)
    y = (_t(mlm), _t(sop))
    with torch.no_grad():
        a = dense.loss(dense(_t(ids), _t(tt)), y)
        b = fused.loss(fused(_t(ids), _t(tt)), y)
    np.testing.assert_allclose(b.item(), a.item(), atol=1e-5, rtol=1e-5)


def test_train_steps_match_jax():
    """bench.py's recipe at test-tiny: AdamW, the fused MLM loss,
    TrainStep; three steps' losses and the parameters after them."""
    jm, tm = _pair(fused_mlm_loss=True, max_predictions=8)
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=jm.parameters())
    topt = toptim.AdamW(learning_rate=1e-3, parameters=tm.parameters())
    jstep = paddle.jit.TrainStep(jm, jopt, lambda o, y: jm.loss(o, y))
    tstep = TrainStep(tm, topt, lambda o, y: tm.loss(o, y))
    ids, _, mlm, sop = _batch(6)
    for _ in range(3):
        jl = jstep(_j(ids), (paddle.to_tensor(mlm),
                             paddle.to_tensor(sop)))
        tl = tstep(_t(ids), (_t(mlm), _t(sop)))
        np.testing.assert_allclose(tl.item(), float(jl), **TOL)
    for (name, p), (_, q) in zip(tm.named_parameters(),
                                 jm.named_parameters()):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(q._data),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("granularity", ["core_attn", "full", "selective"])
def test_recompute_is_bitwise_to_none(granularity):
    _, plain = _pair(fused_mlm_loss=True)
    _, rec = _pair(fused_mlm_loss=True, use_recompute=True,
                   recompute_granularity=granularity)
    plain.train()
    rec.train()
    ids, tt, mlm, sop = _batch(7)
    y = (_t(mlm), _t(sop))
    la = plain.loss(plain(_t(ids), _t(tt)), y)
    la.backward()
    lb = rec.loss(rec(_t(ids), _t(tt)), y)
    lb.backward()
    assert torch.equal(la, lb)
    for (n, p), (_, q) in zip(plain.named_parameters(),
                              rec.named_parameters()):
        assert torch.equal(p.grad, q.grad), n


# ------------------------------------------------ incremental encoding

def test_incremental_encoding_matches_jax_and_single_token_appends(pair):
    jm, tm = pair
    ids = np.random.RandomState(0).randint(0, 512, (2, 10))
    _, jpool, jc = jm.ernie(_j(ids[:, :6]), use_cache=True,
                            cache_max_len=128)
    jblock, jnone, _ = jm.ernie(_j(ids[:, 6:10]), cache=jc)
    assert jnone is None
    with torch.no_grad():
        rl.reset_counts()
        _, pool, c1 = tm.ernie(_t(ids[:, :6]), use_cache=True,
                               cache_max_len=128)
        assert rl.row_linear_plain.calls == 2 * 4 + 1   # and the pooler
        rl.reset_counts()
        block, none, c1 = tm.ernie(_t(ids[:, 6:10]), cache=c1)
        assert rl.row_linear_plain.calls == 2 * 4
        assert none is None and pool is not None
        _, _, c2 = tm.ernie(_t(ids[:, :6]), use_cache=True,
                            cache_max_len=128)
        steps = []
        for t in range(6, 10):
            h, none, c2 = tm.ernie(_t(ids[:, t:t + 1]), cache=c2)
            assert none is None
            steps.append(h[:, 0].numpy())
    np.testing.assert_allclose(pool.numpy(), _np(jpool), **TOL)
    np.testing.assert_allclose(block.numpy(), _np(jblock), **TOL)
    np.testing.assert_allclose(block.numpy(), np.stack(steps, axis=1),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(c2.kv_len.numpy(), [10, 10])
    np.testing.assert_array_equal(c1.kv_len.numpy(), [10, 10])
    assert not rl.route_on()


# ------------------------------------------------------- the A2 pieces

def test_initializers_draw_from_the_generator():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = Linear(8, 4, device="cpu", generator=g1, weight_attr=I.ParamAttr(
        initializer=I.Normal(0.0, 0.5)), bias_attr=I.ParamAttr(
            initializer=I.Constant(0.25)))
    b = Linear(8, 4, device="cpu", generator=g2,
               weight_attr=I.Normal(0.0, 0.5))
    assert torch.equal(a.weight, b.weight)
    assert torch.equal(a.bias, torch.full((4,), 0.25))
    assert Linear(8, 4, device="cpu", bias_attr=False).bias is None
    e = Embedding(10, 4, device="cpu", weight_attr=I.ParamAttr(
        initializer=I.Constant(1.5), trainable=False))
    assert torch.equal(e.weight, torch.full((10, 4), 1.5))
    assert not e.weight.requires_grad
    # name, learning_rate and need_clip are accepted and applied nowhere,
    # as in the JAX package (ROADMAP C23)
    named = Linear(2, 2, device="cpu", weight_attr=I.ParamAttr(
        name="w", learning_rate=0.5, need_clip=False))
    assert not named.weight.stop_gradient


def test_layer_list_keys_and_activations():
    ll = LayerList([Linear(2, 2, device="cpu") for _ in range(2)])
    assert [k for k in ll.state_dict()] == ["0.weight", "0.bias",
                                            "1.weight", "1.bias"]
    x = np.linspace(-4, 4, 33).astype(np.float32)
    np.testing.assert_allclose(
        F.gelu(torch.as_tensor(x), approximate=True).numpy(),
        np.asarray(jax.nn.gelu(x, approximate=True)), atol=1e-6)
    np.testing.assert_allclose(F.gelu(torch.as_tensor(x)).numpy(),
                               np.asarray(jax.nn.gelu(x, approximate=False)),
                               atol=1e-6)
    np.testing.assert_allclose(F.tanh(torch.as_tensor(x)).numpy(),
                               np.tanh(x), atol=1e-6)
    t = torch.ones(3)
    assert sharded_constraint(t, ("dp", None)) is t


def test_keys_and_parameter_order_equal_the_jax_model(pair):
    """``state_dict`` keys (parameters, then buffers) and
    ``named_parameters`` order equal the JAX model's: ``convert.py``
    maps the optimizer state's ``param_{i}`` by that order."""
    jm, tm = pair
    assert list(tm.state_dict()) == list(jm.state_dict())
    assert [n for n, _ in tm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    assert [tuple(p.shape) for p in tm.parameters()] == \
        [tuple(p.shape) for p in jm.parameters()]
