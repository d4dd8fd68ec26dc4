"""The port's ``nn/transformer.py`` against the JAX package's on the CPU,
at d_model 32, nhead 2 (head_dim 16, a kernel head dim), 2 + 2 layers,
with the JAX weights carried across by ``convert.load_reference_state``.

``MultiHeadAttention`` for self-attention, cross-attention with sq !=
sk and ``kdim`` / ``vdim``, bool and additive masks and ``cache`` steps;
``Transformer`` with both ``normalize_before`` settings in eval and in
train at dropout 0, outputs and every gradient against ``jax.grad``.
The route: an unmasked attention reaches ``kernels.flash_attention``
(its plain version here: ``flash_attention_plain.calls`` and, in
training, ``flash_attention_bwd_plain.calls``), a masked one
``sdpa_xla`` (``sdpa_xla.calls``). The JAX package runs plain XLA here:
its flash gate needs a TPU. Tolerances: fp32 outputs within 1e-5,
gradients within 1e-4.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
from paddle_tpu.jit.api import functional_call
import paddle_tpu_torch as tp
from paddle_tpu_torch import convert
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.nn.functional import attention as tattn

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
D, H, FF = 32, 2, 64


def _arrays(jm):
    return {k: np.asarray(v._data) for k, v in jm.state_dict().items()}


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np(x):
    return np.asarray(x._data) if hasattr(x, "_data") else \
        x.detach().as_subclass(torch.Tensor).numpy()


def _counts():
    return (fa.flash_attention_plain.calls,
            fa.flash_attention_bwd_plain.calls, tattn.sdpa_xla.calls)


def _reset():
    fa.reset_counts()
    tattn.sdpa_xla.calls = 0


def _mha_pair(seed=0, **kw):
    jp.seed(seed)
    jm = jnn.MultiHeadAttention(D, H, **kw)
    tm = tnn.MultiHeadAttention(D, H, device="cpu", **kw)
    convert.load_reference_state(tm, _arrays(jm))
    return jm, tm


def _call(m, pkg, *arrays, **kw):
    """``m`` on ``arrays`` (and an ``attn_mask`` array) as the package's
    tensors; the JAX layer through one jitted ``functional_call`` (XLA
    compiles the call once instead of each op), its output as an
    array."""
    if pkg is jp:
        state = {k: v._data for k, v in m.state_dict().items()}

        @jax.jit
        def run(st, arrays, kw):
            wrap = jax.tree_util.tree_map(jp.Tensor, (arrays, kw))
            return functional_call(m, st, *wrap[0], **wrap[1])._data

        return np.asarray(run(state, arrays, kw))
    args = [tp.to_tensor(a, place="cpu") for a in arrays]
    mask = kw.pop("attn_mask", None)
    if mask is not None:
        kw["attn_mask"] = tp.to_tensor(mask, place="cpu")
    return m(*args, **kw)


def test_self_attention_matches_and_reaches_the_kernel():
    jm, tm = _mha_pair()
    q = _rand((2, 6, D), 1)
    _reset()
    got = _call(tm, tp, q)
    assert type(got) is tp.Tensor
    np.testing.assert_allclose(_np(got), _call(jm, jp, q), **TOL)
    assert _counts() == (1, 0, 0)


def test_cross_attention_kdim_vdim():
    jm, tm = _mha_pair(1, kdim=24, vdim=20)
    assert list(tm.state_dict()) == list(jm.state_dict())
    q, k, v = _rand((2, 5, D), 2), _rand((2, 7, 24), 3), _rand((2, 7, 20), 4)
    _reset()
    np.testing.assert_allclose(_np(_call(tm, tp, q, k, v)),
                               _call(jm, jp, q, k, v), **TOL)
    assert _counts() == (1, 0, 0)


@pytest.mark.parametrize("kind", ["bool", "additive"])
def test_masked_attention_takes_sdpa_xla(kind):
    jm, tm = _mha_pair(2)
    q, k = _rand((2, 5, D), 5), _rand((2, 7, D), 6)
    if kind == "bool":
        mask = np.random.RandomState(7).rand(5, 7) > 0.3
        mask[:, 0] = True
    else:
        mask = np.where(np.random.RandomState(7).rand(2, 1, 5, 7) > 0.3,
                        0.0, -1e4).astype(np.float32)
    _reset()
    got = _call(tm, tp, q, k, k, attn_mask=mask)
    np.testing.assert_allclose(_np(got),
                               _call(jm, jp, q, k, k, attn_mask=mask),
                               **TOL)
    assert _counts() == (0, 0, 1)


def test_cache_steps_match():
    jm, tm = _mha_pair(3)
    caches = {"j": None, "t": None}
    prev = (_rand((2, 3, H, D // H), 8), _rand((2, 3, H, D // H), 9))
    caches["j"] = tuple(jp.to_tensor(a) for a in prev)
    caches["t"] = tuple(tp.to_tensor(a, place="cpu") for a in prev)
    for step in range(2):
        x = _rand((2, 1, D), 10 + step)
        jo, caches["j"] = jm(jp.to_tensor(x), cache=caches["j"])
        to, caches["t"] = tm(tp.to_tensor(x, place="cpu"),
                             cache=caches["t"])
        assert all(type(c) is tp.Tensor for c in caches["t"])
        assert caches["t"][0].shape == [2, 4 + step, H, D // H]
        np.testing.assert_allclose(_np(to), _np(jo), **TOL)
        for a, b in zip(caches["t"], caches["j"]):
            np.testing.assert_allclose(_np(a), _np(b), **TOL)


def _transformer_pair(normalize_before, seed=4):
    jp.seed(seed)
    kw = dict(d_model=D, nhead=H, num_encoder_layers=2,
              num_decoder_layers=2, dim_feedforward=FF, dropout=0.0,
              normalize_before=normalize_before)
    jm = jnn.Transformer(**kw)
    tm = tnn.Transformer(device="cpu", **kw)
    assert [n for n, _ in tm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    convert.load_reference_state(tm, _arrays(jm))
    return jm, tm


def _jax_value_and_grads(jm, src, tgt, mask, ct):
    names = [n for n, _ in jm.named_parameters()]
    vals = [p._data for _, p in jm.named_parameters()]

    def loss_of(pvals):
        out = functional_call(jm, dict(zip(names, pvals)),
                              jp.to_tensor(src), jp.to_tensor(tgt),
                              tgt_mask=jp.to_tensor(mask))
        return (out._data * ct).sum(), out._data

    (loss, out), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        vals)
    return np.asarray(out), dict(zip(names, (np.asarray(g)
                                             for g in grads)))


@pytest.mark.parametrize("normalize_before", [False, True])
def test_transformer_eval_and_train_match_jax(normalize_before):
    jm, tm = _transformer_pair(normalize_before)
    src, tgt = _rand((2, 6, D), 20), _rand((2, 5, D), 21)
    ct = _rand((2, 5, D), 22)
    mask = np.asarray(_np(jnn.Transformer.generate_square_subsequent_mask(5)))
    tmask = tnn.Transformer.generate_square_subsequent_mask(5, device="cpu")
    assert type(tmask) is tp.Tensor and tmask.dtype == torch.bool
    np.testing.assert_array_equal(tmask.numpy(), mask)
    # the JAX output and gradients in train mode; at dropout 0 its
    # output is the eval output too
    jm.train()
    ref_out, ref_grads = _jax_value_and_grads(jm, src, tgt, mask, ct)
    # eval
    tm.eval()
    _reset()
    with tp.no_grad():
        got = tm(tp.to_tensor(src, place="cpu"),
                 tp.to_tensor(tgt, place="cpu"), tgt_mask=tmask)
    np.testing.assert_allclose(_np(got), ref_out, **TOL)
    # 2 encoder self-attentions and 2 cross-attentions unmasked, 2
    # masked decoder self-attentions
    assert _counts() == (4, 0, 2)
    # train at dropout 0: outputs and every gradient
    tm.train()
    _reset()
    out = tm(tp.to_tensor(src, place="cpu"), tp.to_tensor(tgt, place="cpu"),
             tgt_mask=tmask)
    (out * tp.to_tensor(ct, place="cpu")).sum().backward()
    assert _counts() == (4, 4, 2)
    np.testing.assert_allclose(_np(out), ref_out, **TOL)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(_np(p.grad), ref_grads[name],
                                   err_msg=name, **GRAD_TOL)


def test_encoder_from_a_list_and_a_final_norm():
    jp.seed(5)
    jl = [jnn.TransformerEncoderLayer(D, H, FF, dropout=0.0,
                                      activation="gelu") for _ in range(2)]
    jm = jnn.TransformerEncoder(jl, norm=jnn.LayerNorm(D))
    tl = [tnn.TransformerEncoderLayer(D, H, FF, dropout=0.0,
                                      activation="gelu", device="cpu")
          for _ in range(2)]
    tm = tnn.TransformerEncoder(tl, norm=tnn.LayerNorm(D, device="cpu"))
    convert.load_reference_state(tm, _arrays(jm))
    x = _rand((2, 4, D), 30)
    np.testing.assert_allclose(_np(_call(tm, tp, x)), _call(jm, jp, x),
                               **TOL)
    # the copies of a stack start equal to its first layer
    stack = tnn.TransformerDecoder(
        tnn.TransformerDecoderLayer(D, H, FF, device="cpu"), 3)
    w = [l.linear1.weight for l in stack.layers]
    assert torch.equal(w[0], w[2]) and w[0] is not w[2]
