"""The port's activations (``paddle_tpu_torch.nn.functional``: the 27
ops the JAX package's ``nn/functional/activation.py`` registers, from
``relu`` through ``maxout``) and their layers, against the JAX package
on the CPU, from one table of parametrised cases.

Each op's value on seeded inputs within 1e-5 of the JAX op's, through
the plain function and through the port's op registry (which dispatches
the same function and returns a ``Tensor``); its gradient, by torch's
autograd on the plain function, within 1e-4 of ``jax.vjp`` of the JAX
op's impl with the same cotangent. ``gumbel_softmax`` draws from the
port's generator, so it is held by its statistics, never by its bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.ops.op_registry import OPS as JOPS
import paddle_tpu_torch as tp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops.op_registry import OPS as TOPS

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)

# name: (keyword options, input shape); inputs are N(0, 2) from a seed
CASES = {
    "relu": ({}, (4, 9)),
    "relu6": ({}, (4, 9)),
    "sigmoid": ({}, (4, 9)),
    "log_sigmoid": ({}, (4, 9)),
    "silu": ({}, (4, 9)),
    "softsign": ({}, (4, 9)),
    "tanh_act": ({}, (4, 9)),
    "mish": ({}, (4, 9)),
    "gelu": ({"approximate": True}, (4, 9)),
    "elu": ({"alpha": 0.7}, (4, 9)),
    "selu": ({}, (4, 9)),
    "celu": ({"alpha": 1.3}, (4, 9)),
    "leaky_relu": ({"negative_slope": 0.2}, (4, 9)),
    "prelu": ({"data_format": "NCHW"}, (2, 3, 4, 5)),
    "hardtanh": ({"min": -0.5, "max": 1.5}, (4, 9)),
    "hardshrink": ({"threshold": 0.7}, (4, 9)),
    "softshrink": ({"threshold": 0.4}, (4, 9)),
    "hardsigmoid": ({"slope": 0.25, "offset": 0.4}, (4, 9)),
    "hardswish": ({}, (4, 9)),
    "softplus": ({"beta": 2.0, "threshold": 3.0}, (4, 9)),
    "tanhshrink": ({}, (4, 9)),
    "thresholded_relu": ({"threshold": 0.3}, (4, 9)),
    "softmax": ({"axis": 0}, (4, 9)),
    "log_softmax": ({"axis": -1}, (4, 9)),
    "glu": ({"axis": 1}, (4, 10)),
    "maxout": ({"groups": 2, "axis": 1}, (2, 6, 3)),
}


def _input(shape, seed=0):
    return (2.0 * np.random.RandomState(seed).randn(*shape)) \
        .astype(np.float32)


def _prelu_weight():
    return np.array([0.1, -0.3, 0.5], np.float32)


def _args(name, x):
    """Positional operands beside x: prelu's weight."""
    return (_prelu_weight(),) if name == "prelu" else ()


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_value_and_gradient(name):
    kw, shape = CASES[name]
    x = _input(shape)
    extra = _args(name, x)
    jimpl = JOPS[name].impl
    ref, vjp = jax.vjp(lambda a, *e: jimpl(a, *e, **kw), jnp.asarray(x),
                       *map(jnp.asarray, extra))
    ct = np.random.RandomState(1).randn(*ref.shape).astype(np.float32)
    ref_grads = vjp(jnp.asarray(ct))
    # the plain function, with torch's autograd
    tx = torch.tensor(x, requires_grad=True)
    te = [torch.tensor(e, requires_grad=True) for e in extra]
    out = getattr(TF, name)(tx, *te, **kw)
    assert type(out) is torch.Tensor
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    out.backward(torch.as_tensor(ct))
    for got, want in zip([tx] + te, ref_grads):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   **GRAD_TOL)
    # through the registry: the JAX op's public wrapper and the port's
    jout = JOPS[name].public(jp.to_tensor(x), *map(jp.to_tensor, extra),
                             **kw)
    pout = TOPS[name].public(tp.to_tensor(x, place="cpu"),
                             *[tp.to_tensor(e, place="cpu") for e in extra],
                             **kw)
    assert type(pout) is tp.Tensor
    np.testing.assert_allclose(pout.numpy(), np.asarray(jout._data), **TOL)


def test_the_registry_holds_the_slice_ops():
    """The 27 activations and scaled_dot_product_attention, linear and
    embedding: the 30 ``nn`` ops of the JAX registry this slice ports,
    under the same names."""
    names = set(CASES) | {"gumbel_softmax", "scaled_dot_product_attention",
                          "linear", "embedding"}
    assert len(names) == 30
    assert names <= set(JOPS) and names <= set(TOPS)
    x = _input((3, 4))
    w = _input((4, 5), 1)
    np.testing.assert_allclose(
        TOPS["linear"].public(tp.to_tensor(x, place="cpu"),
                              tp.to_tensor(w, place="cpu")).numpy(),
        np.asarray(JF.linear(jp.to_tensor(x), jp.to_tensor(w))._data),
        **TOL)
    ids = np.array([[0, 2, 1], [2, 2, 0]], np.int32)
    table = _input((3, 4), 2)
    np.testing.assert_allclose(
        TOPS["embedding"].public(tp.to_tensor(ids, place="cpu"),
                                 tp.to_tensor(table, place="cpu"),
                                 padding_idx=2).numpy(),
        np.asarray(JF.embedding(jp.to_tensor(ids), jp.to_tensor(table),
                                padding_idx=2)._data), **TOL)


def test_gelu_exact_and_swish_alias():
    x = _input((5, 7))
    np.testing.assert_allclose(
        TF.gelu(torch.as_tensor(x)).numpy(),
        np.asarray(JF.gelu(jp.to_tensor(x))._data), **TOL)
    assert TF.swish is TF.silu


def test_gumbel_softmax_statistics():
    """Soft samples sum to 1 along the axis; the argmax of 20,000 draws
    lands on each class at its softmax probability (within 5 standard
    errors); hard samples are one-hot with the soft gradient."""
    logits = np.array([0.5, -1.0, 1.5, 0.0], np.float32)
    x = torch.as_tensor(np.tile(logits, (20000, 1)))
    g = torch.Generator().manual_seed(0)
    y = TF.gumbel_softmax(x, temperature=0.5, generator=g)
    np.testing.assert_allclose(y.sum(-1).numpy(), 1.0, atol=1e-5)
    freq = np.bincount(y.argmax(-1).numpy(), minlength=4) / len(x)
    p = np.exp(logits) / np.exp(logits).sum()
    assert np.all(np.abs(freq - p) < 5 * np.sqrt(p * (1 - p) / len(x)))
    xs = torch.tensor(logits[None].repeat(3, 0), requires_grad=True)
    yh = TF.gumbel_softmax(xs, hard=True, axis=-1,
                           generator=torch.Generator().manual_seed(1))
    hard = yh.detach().numpy()
    np.testing.assert_allclose(hard.sum(-1), 1.0, atol=1e-6)
    np.testing.assert_allclose(hard, np.round(hard), atol=1e-6)
    (yh * torch.arange(4.0)).sum().backward()
    assert xs.grad is not None and torch.isfinite(xs.grad).all()
    # the JAX op at the same statistics
    jy = JF.gumbel_softmax(jp.to_tensor(x.numpy()[:2000]), temperature=0.5)
    np.testing.assert_allclose(np.asarray(jy._data).sum(-1), 1.0, atol=1e-5)


# layer name: (constructor args, JAX keyword options), as both packages
# take them
LAYERS = {
    "ReLU": ((), {}), "GELU": ((True,), {}), "Sigmoid": ((), {}),
    "Tanh": ((), {}), "Softmax": ((0,), {}), "LogSoftmax": ((1,), {}),
    "LeakyReLU": ((0.3,), {}), "Silu": ((), {}), "Swish": ((), {}),
    "Hardswish": ((), {}), "Hardsigmoid": ((), {}), "ReLU6": ((), {}),
    "ELU": ((0.5,), {}), "Mish": ((), {}), "CELU": ((0.8,), {}),
    "Hardshrink": ((0.6,), {}), "Hardtanh": ((-0.4, 0.9), {}),
    "LogSigmoid": ((), {}), "SELU": ((), {}), "Softplus": ((1.5, 4.0), {}),
    "Softshrink": ((0.3,), {}), "Softsign": ((), {}),
    "Tanhshrink": ((), {}), "ThresholdedReLU": ((0.2,), {}),
    "Maxout": ((3,), {}), "Softmax2D": ((), {}),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_activation_layer_matches(name):
    args, _ = LAYERS[name]
    x = _input((2, 6, 3, 2), 3)
    jl = getattr(jnn, name)(*args)
    tl = getattr(tnn, name)(*args)
    assert isinstance(tl, tnn.Layer)
    want = np.asarray(jl(jp.to_tensor(x))._data)
    got = tl(tp.to_tensor(x, place="cpu"))
    assert type(got) is tp.Tensor
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    plain = tl(torch.as_tensor(x))
    assert type(plain) is torch.Tensor
    np.testing.assert_allclose(plain.numpy(), want, **TOL)


def test_prelu_layer_and_flatten_dropout():
    x = _input((2, 3, 4, 4), 4)
    jl = jnn.PReLU(3, init=0.1)
    tl = tnn.PReLU(3, init=0.1, device="cpu")
    assert list(tl.state_dict()) == list(jl.state_dict())
    np.testing.assert_allclose(tl(tp.to_tensor(x, place="cpu")).numpy(),
                               np.asarray(jl(jp.to_tensor(x))._data), **TOL)
    np.testing.assert_allclose(
        tnn.Flatten()(tp.to_tensor(x, place="cpu")).numpy(),
        np.asarray(jnn.Flatten()(jp.to_tensor(x))._data))
    d2 = tnn.Dropout2D(0.5)
    y = d2(torch.ones(4, 6, 3, 3)).numpy()
    # whole channels drop together: each (n, c) map is all 0 or all 2
    per_map = y.reshape(24, 9)
    assert np.all((per_map == 0).all(1) | (per_map == 2).all(1))
    d2.eval()
    assert torch.equal(d2(torch.ones(2, 2, 2, 2)), torch.ones(2, 2, 2, 2))
    d = tnn.Dropout(0.25, mode="downscale_in_infer")
    kept = d(torch.ones(1000)).numpy()
    assert set(np.unique(kept)) <= {0.0, 1.0}
