"""The port's ``ops/manipulation.py`` against the JAX package's, op by op.

Each op the JAX ``ops/manipulation.py`` registers runs through both
registries on the same numpy inputs (``tests/_port_op_parity.py``):
values and dtypes, and the gradient of a differentiable op by each
package's own ``backward``. Tolerances, stated there: bitwise for data
movement, comparisons and arithmetic both do in one order; 1e-6 for
other fp32 values and gradients; 1e-5 for transcendentals, row
reductions and linear algebra.
"""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch.core import device as port_device

import _port_op_parity as H

NAMES = H.registered_by("manipulation")


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    monkeypatch.setattr(port_device, "_CURRENT", torch.device("cpu"))


@pytest.mark.parametrize("name", NAMES)
def test_op_matches_jax(name):
    assert name not in H.EXCEPTIONS
    H.compare(name, H.run(paddle_tpu, name, True),
              H.run(paddle_tpu_torch, name, True))


# ---- the functions outside the registry: each against the JAX one ----

R = np.random.RandomState(3)
X = R.randn(4, 6).astype(np.float32)
Y = R.randn(6).astype(np.float32)
M = X > 0
IDS = np.array([3, 1, 3, 0, 1, 3], np.int64)

FUNCS = [
    ("split_int", lambda pkg, t: pkg.split(t(X), 3, axis=1)),
    ("split_sections", lambda pkg, t: pkg.split(t(X), [2, -1, 1], axis=1)),
    ("chunk", lambda pkg, t: pkg.chunk(t(X), 2, axis=0)),
    ("unbind", lambda pkg, t: pkg.unbind(t(X), axis=1)),
    ("broadcast_tensors", lambda pkg, t: pkg.broadcast_tensors(
        [t(X), t(Y)])),
    ("scatter_nd", lambda pkg, t: pkg.scatter_nd(
        t(np.array([[1], [3], [1]], np.int64)), t(X[:3]), [5, 6])),
    ("nonzero", lambda pkg, t: pkg.nonzero(t(M))),
    ("nonzero_tuple", lambda pkg, t: pkg.nonzero(t(M), as_tuple=True)),
    ("masked_select", lambda pkg, t: pkg.masked_select(t(X), t(M))),
    ("unique", lambda pkg, t: pkg.unique(t(IDS))),
    ("unique_all", lambda pkg, t: pkg.unique(
        t(IDS), return_index=True, return_inverse=True,
        return_counts=True)),
    ("numel", lambda pkg, t: pkg.numel(t(X))),
    ("shape", lambda pkg, t: pkg.shape(t(X))),
    ("one_hot", lambda pkg, t: pkg.one_hot(t(IDS), 5)),
    ("topk", lambda pkg, t: pkg.topk(t(X), 2, axis=1)),
    ("topk_smallest", lambda pkg, t: pkg.topk(t(X), 3, largest=False)),
    ("rank", lambda pkg, t: pkg.rank(t(X))),
    ("is_empty", lambda pkg, t: pkg.is_empty(t(X))),
]


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("name,fn", FUNCS, ids=[f[0] for f in FUNCS])
def test_function_matches_jax(name, fn):
    outs = []
    for pkg in (paddle_tpu, paddle_tpu_torch):
        def t(a, pkg=pkg):
            return pkg.to_tensor(a, stop_gradient=False) \
                if a.dtype == np.float32 else pkg.to_tensor(a)
        outs.append(_flat(fn(pkg, t)))
    j, p = outs
    assert len(j) == len(p)
    for a, b in zip(j, p):
        assert H._dtype_name(b) == H._dtype_name(a)
        np.testing.assert_array_equal(b.numpy(), a.numpy())


@pytest.mark.parametrize("name", ["split", "unbind", "broadcast_tensors",
                                  "topk", "scatter_nd"])
def test_function_gradient_matches_jax(name):
    fn = dict(FUNCS)[{"split": "split_sections"}.get(name, name)]
    grads = []
    for pkg in (paddle_tpu, paddle_tpu_torch):
        xs = {}

        def t(a, pkg=pkg):
            if a.dtype != np.float32:
                return pkg.to_tensor(a)
            xs[id(a)] = pkg.to_tensor(a, stop_gradient=False)
            return xs[id(a)]

        outs = _flat(fn(pkg, t))
        loss = None
        for k, o in enumerate(outs):
            if H._dtype_name(o) != "float32":
                continue
            w = np.random.RandomState(k).randn(*o.shape).astype(np.float32)
            term = (o * pkg.to_tensor(w)).sum()
            loss = term if loss is None else loss + term
        loss.backward()
        grads.append([v.grad.numpy() for v in xs.values()])
    for a, b in zip(*grads):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)
