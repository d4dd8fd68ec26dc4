"""The port's ``ops/linalg.py`` and ``ops/creation.py`` against the JAX
package's, and the registry's coverage.

Registered ops: as ``tests/test_torch_port_ops_math.py`` (the harness
and its tolerances are ``tests/_port_op_parity.py``). The decompositions
outside the registry (``qr``, ``svd``, ``eig``, ``eigh``) are held
through their reconstructions, 1e-5, signs being free. The creation
functions: values and dtypes equal the JAX package's (``arange``,
``to_tensor`` of ints and ``randint`` are int32, as JAX without x64
makes them). The random ones are held by shape, dtype, range and
moments (mean and variance within 0.1 over 4000 draws) and by
repeating after ``seed``, never by bits: the two packages' generators
differ.
"""

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as P
from paddle_tpu.ops.op_registry import OPS as JAX_OPS
from paddle_tpu_torch.core import device as port_device
from paddle_tpu_torch.ops.op_registry import OPS as PORT_OPS

import _port_op_parity as H

NAMES = H.registered_by("linalg") + H.registered_by("creation")
MODULES = ("creation", "math", "manipulation", "linalg")


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    monkeypatch.setattr(port_device, "_CURRENT", torch.device("cpu"))


@pytest.mark.parametrize("name", NAMES)
def test_op_matches_jax(name):
    assert name not in H.EXCEPTIONS
    H.compare(name, H.run(paddle_tpu, name, True),
              H.run(P, name, True))


def test_every_registered_op_has_a_port_counterpart_and_a_case():
    names = [n for m in MODULES for n in H.registered_by(m)]
    assert len(names) == len(set(names)) == 218
    assert not [n for n in names if n not in PORT_OPS]
    assert not [n for n in names if n not in H.CASES
                and n not in H.EXCEPTIONS]
    assert len(H.EXCEPTIONS) < 10
    for n in names:
        assert PORT_OPS[n].differentiable == JAX_OPS[n].differentiable, n


def _np(t):
    return t.numpy()


def _recon_close(a, b):
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_decompositions_reconstruct():
    rng = np.random.RandomState(1)
    m = rng.randn(5, 4).astype(np.float32)
    s = (lambda a: a @ a.T + 4 * np.eye(4, dtype=np.float32))(
        rng.randn(4, 4).astype(np.float32))
    for pkg in (paddle_tpu, P):
        q, r = pkg.ops.linalg.qr(pkg.to_tensor(m))
        _recon_close(_np(q) @ _np(r), m)
        u, sv, vt = pkg.ops.linalg.svd(pkg.to_tensor(m))
        _recon_close((_np(u) * _np(sv)) @ _np(vt), m)
        w, v = pkg.ops.linalg.eigh(pkg.to_tensor(s))
        _recon_close((_np(v) * _np(w)) @ _np(v).T, s)
        w, v = pkg.ops.linalg.eig(pkg.to_tensor(s))
        _recon_close(((_np(v) * _np(w)) @ np.linalg.inv(_np(v))).real, s)
    jw = _np(paddle_tpu.ops.linalg.svd(paddle_tpu.to_tensor(m))[1])
    pw = _np(P.ops.linalg.svd(P.to_tensor(m))[1])
    _recon_close(pw, jw)
    jq, _ = paddle_tpu.ops.linalg.qr(paddle_tpu.to_tensor(m))
    pq, _ = P.ops.linalg.qr(P.to_tensor(m))
    _recon_close(np.abs(_np(pq)), np.abs(_np(jq)))


def test_decomposition_gradient_matches_jax():
    rng = np.random.RandomState(2)
    m = rng.randn(4, 3).astype(np.float32)
    grads = []
    for pkg in (paddle_tpu, P):
        x = pkg.to_tensor(m, stop_gradient=False)
        _, sv, _ = pkg.ops.linalg.svd(x)
        q, r = pkg.ops.linalg.qr(x)
        (sv.sum() + (r * r).sum()).backward()
        grads.append(_np(x.grad))
    _recon_close(grads[1], grads[0])


CREATIONS = [
    ("zeros", ([2, 3],), {}),
    ("ones", ([4],), {"dtype": "int64"}),
    ("full", ([2, 2], 3), {}),
    ("full", ([2], 1.5), {"dtype": "float16"}),
    ("empty", ([3],), {}),
    ("arange", (5,), {}),
    ("arange", (1, 7, 2), {}),
    ("arange", (0.0, 1.0, 0.25), {}),
    ("linspace", (0, 1, 5), {}),
    ("logspace", (0, 2, 3), {}),
    ("eye", (3, 4), {}),
    ("tril_indices", (3, 3), {}),
    ("triu_indices", (3, 4, 1), {}),
    ("to_tensor", ([1, 2],), {}),
    ("to_tensor", (np.arange(3),), {}),
    ("to_tensor", (np.arange(3.0),), {}),
    ("to_tensor", (2.5,), {}),
    ("to_tensor", (True,), {}),
    ("to_tensor", ([[1.0, 2.0]],), {"dtype": "float64"}),
    ("to_tensor", (np.arange(4, dtype=np.uint8),), {}),
]


@pytest.mark.parametrize("name,args,kwargs", CREATIONS,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(CREATIONS)])
def test_creation_matches_jax(name, args, kwargs):
    j = getattr(paddle_tpu, name)(*args, **kwargs)
    p = getattr(P, name)(*args, **kwargs)
    assert H._dtype_name(p) == H._dtype_name(j)
    np.testing.assert_array_equal(_np(p), _np(j))


def test_diag_meshgrid_assign_match_jax():
    v = np.array([1.0, 2.0, 3.0], np.float32)
    m = np.arange(12, dtype=np.float32).reshape(3, 4)
    for fn, args in ((lambda pkg, a: pkg.diag(pkg.to_tensor(a), 1, 9.0),
                      (v,)),
                     (lambda pkg, a: pkg.diag(pkg.to_tensor(a), -1), (m,)),
                     (lambda pkg, a: pkg.diagflat(pkg.to_tensor(a)), (v,)),
                     (lambda pkg, a: pkg.assign(pkg.to_tensor(a)), (m,))):
        j, p = fn(paddle_tpu, *args), fn(P, *args)
        np.testing.assert_array_equal(_np(p), _np(j))
        assert H._dtype_name(p) == H._dtype_name(j)
    jg = paddle_tpu.meshgrid(paddle_tpu.to_tensor(v), paddle_tpu.to_tensor(
        v[:2]))
    pg = P.meshgrid(P.to_tensor(v), P.to_tensor(v[:2]))
    for a, b in zip(jg, pg):
        np.testing.assert_array_equal(_np(b), _np(a))
    out = P.zeros([3])
    assert P.assign(np.ones(3, np.float32), out) is out
    np.testing.assert_array_equal(_np(out), np.ones(3))


RANDOM = [
    ("rand", lambda pkg: pkg.rand([4000]), 0.5, 1 / 12, (0.0, 1.0)),
    ("randn", lambda pkg: pkg.randn([4000]), 0.0, 1.0, None),
    ("standard_normal", lambda pkg: pkg.standard_normal([4000]), 0.0, 1.0,
     None),
    ("uniform", lambda pkg: pkg.uniform([4000], min=2.0, max=4.0), 3.0,
     1 / 3, (2.0, 4.0)),
    ("normal", lambda pkg: pkg.normal(1.0, 2.0, [4000]), 1.0, 4.0, None),
    ("randint", lambda pkg: pkg.randint(0, 10, [4000]), 4.5, 8.25,
     (0, 9)),
    ("randint_like", lambda pkg: pkg.randint_like(
        pkg.zeros([4000], "int32"), 0, 10), 4.5, 8.25, (0, 9)),
    ("randperm", lambda pkg: pkg.randperm(4000), 1999.5, 1333333.25,
     (0, 3999)),
    ("bernoulli", lambda pkg: pkg.bernoulli(pkg.full([4000], 0.3)), 0.3,
     0.21, (0.0, 1.0)),
    ("poisson", lambda pkg: pkg.poisson(pkg.full([4000], 3.0)), 3.0, 3.0,
     (0.0, None)),
    ("multinomial", lambda pkg: pkg.multinomial(
        pkg.to_tensor(np.array([0.2, 0.3, 0.5], np.float32)), 4000, True),
     1.3, 0.61, (0, 2)),
]


@pytest.mark.parametrize("name,fn,mean,var,rng_",
                         RANDOM, ids=[r[0] for r in RANDOM])
def test_random_op_shape_dtype_range_moments(name, fn, mean, var, rng_):
    paddle_tpu.seed(11)
    P.seed(11)
    j, p = fn(paddle_tpu), fn(P)
    assert p.shape == j.shape
    assert H._dtype_name(p) == H._dtype_name(j)
    a = _np(p).astype(np.float64)
    if rng_ is not None:
        assert a.min() >= rng_[0]
        assert rng_[1] is None or a.max() <= rng_[1]
    scale = max(abs(mean), np.sqrt(var), 1.0)
    assert abs(a.mean() - mean) < 0.1 * scale
    assert abs(a.var() - var) < 0.1 * max(var, 1.0)
    P.seed(7)
    first = _np(fn(P))
    P.seed(7)
    np.testing.assert_array_equal(_np(fn(P)), first)


def test_uniform_seed_argument_repeats():
    a = P.uniform([16], seed=3)
    b = P.uniform([16], seed=3)
    np.testing.assert_array_equal(_np(a), _np(b))


def test_create_parameter_defaults_match_jax():
    P.seed(0)
    for shape, is_bias in (([64, 32], False), ([32], True)):
        j = paddle_tpu.create_parameter(shape, "float32", is_bias=is_bias)
        p = P.create_parameter(shape, "float32", is_bias=is_bias)
        assert isinstance(p, P.Parameter) and isinstance(p, P.Tensor)
        assert isinstance(p, torch.nn.Parameter)
        assert p.shape == j.shape and not p.stop_gradient
        assert p.persistable and p.trainable
        np.testing.assert_allclose(_np(p).std(), _np(j).std(), rtol=0.1,
                                   atol=1e-12)
    from paddle_tpu_torch.nn.initializer import Constant
    c = P.create_parameter([3], "float32",
                           default_initializer=Constant(0.5))
    np.testing.assert_array_equal(_np(c), np.full(3, 0.5, np.float32))


def test_creation_without_a_card_raises(monkeypatch):
    """No ``place`` and no ``set_device``: the card, and without one a
    RuntimeError naming CUDA, never a CPU fallback."""
    monkeypatch.setattr(port_device, "_CURRENT", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for f in (lambda: P.to_tensor([1.0]), lambda: P.zeros([2]),
              lambda: P.randn([2])):
        with pytest.raises(RuntimeError, match="CUDA"):
            f()
