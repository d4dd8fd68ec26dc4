"""The port's autograd surface against the JAX package's, on the CPU:
``backward`` with hooks and ``retain_graph``, ``autograd.backward``,
``paddle.grad`` (``create_graph`` to third order, ``grad_outputs``,
``allow_unused``, ``no_grad_vars``, ``retain_graph``) with the same
error messages, ``PyLayer``, ``functional_call``, the functional
``grad`` and ``value_and_grad``.

Same numpy inputs (one seed) through both packages; gradients within
1e-6 (fp32; the two tapes sum in other orders), or equal where a test
says so.
"""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as P
from paddle_tpu import nn as jnn
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.core import device as port_device

rng = np.random.RandomState(0)
A = rng.randn(3, 4).astype(np.float32)
W = rng.randn(4, 2).astype(np.float32)
X = rng.randn(5, 4).astype(np.float32)
PKGS = (paddle_tpu, P)


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    monkeypatch.setattr(port_device, "_CURRENT", torch.device("cpu"))


def _x(pkg, vals, stop_gradient=False):
    t = pkg.to_tensor(np.asarray(vals, np.float32))
    t.stop_gradient = stop_gradient
    return t


def _close(a, b):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-6,
                               atol=1e-6)


def _each(fn):
    """fn(pkg) for both packages; its results compared pairwise."""
    j, p = fn(paddle_tpu), fn(P)
    j = j if isinstance(j, (list, tuple)) else [j]
    p = p if isinstance(p, (list, tuple)) else [p]
    assert len(j) == len(p)
    for a, b in zip(j, p):
        if a is None or b is None:
            assert a is None and b is None
        else:
            _close(a, b)


# --------------------------------------------------------------- backward

def test_backward_accumulates_and_retains():
    def run(pkg):
        x = _x(pkg, A)
        y = (pkg.tanh(x) * x).sum()
        y.backward(retain_graph=True)
        first = x.grad.numpy().copy()
        y.backward()
        return [first, x.grad.numpy()]
    _each(run)


def test_hooks_see_and_replace_gradients():
    def run(pkg):
        x = _x(pkg, A)
        h = x * 3.0
        seen = []

        def hook(g):
            seen.append(g.numpy().copy())
            return g * 2.0

        remove = h.register_hook(hook)
        pkg.sin(h).sum().backward()
        g1 = x.grad.numpy().copy()
        remove()
        x.clear_grad()
        assert x.grad is None
        pkg.sin(x * 3.0).sum().backward()
        return [seen[0], g1, x.grad.numpy()]
    _each(run)


def test_hook_on_a_tensor_used_twice_c22():
    """The JAX tape calls a hook once per consuming edge with that edge's
    part of the gradient; torch calls it once with the sum (ROADMAP
    C22). With a linear hook the leaf's gradient is the same."""
    res = []
    for pkg in PKGS:
        x = _x(pkg, A)
        h = x * 3.0
        seen = []
        h.register_hook(lambda g: seen.append(g.numpy().copy()) or g * 2.0)
        (h * h).sum().backward()
        res.append((seen, x.grad.numpy()))
    (jseen, jg), (pseen, pg) = res
    assert len(jseen) == 2 and len(pseen) == 1
    _close(jseen[0] + jseen[1], pseen[0])
    _close(jg, pg)


def test_leaf_hook_and_handle_remove():
    x = _x(P, A)
    handle = x.register_hook(lambda g: g * 0.0)
    (x * 2.0).sum().backward()
    assert not np.any(x.grad.numpy())
    handle.remove()
    x.clear_gradient()
    (x * 2.0).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.full_like(A, 2.0))


def test_autograd_backward_with_grad_tensors():
    def run(pkg):
        x = _x(pkg, A)
        y1, y2 = x * 2.0, pkg.exp(x)
        pkg.autograd.backward([y1, y2], [pkg.to_tensor(np.ones_like(A)),
                                         pkg.to_tensor(A)])
        return x.grad.numpy()
    _each(run)


@pytest.mark.parametrize("case", ["no_graph", "non_scalar", "leaf"])
def test_backward_errors_match_jax(case):
    msgs = []
    for pkg in PKGS:
        if case == "no_graph":
            t = pkg.to_tensor(A).sum()
        elif case == "non_scalar":
            t = _x(pkg, A) * 2.0
        else:
            t = _x(pkg, A)
        with pytest.raises(RuntimeError) as e:
            t.backward()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ------------------------------------------------------------ paddle.grad

GRADS = {
    "first_order": lambda pkg: (lambda x: [
        pkg.grad((x * x).sum(), [x])[0].numpy(), x.grad is None])(
        _x(pkg, [1.0, 2.0, 3.0])),
    "nonscalar_seed_ones": lambda pkg: (lambda x: pkg.grad(
        x * 3.0, [x])[0].numpy())(_x(pkg, [1.0, 2.0])),
    "grad_outputs": lambda pkg: (lambda x: pkg.grad(
        x * x, [x], grad_outputs=[pkg.to_tensor(np.array(
            [10.0, 100.0], np.float32))])[0].numpy())(_x(pkg, [1.0, 2.0])),
    "intermediate": lambda pkg: (lambda x: (lambda h: pkg.grad(
        (h * h).sum(), [h])[0].numpy())(x * 3.0))(_x(pkg, [1.0, 2.0])),
    "no_grad_vars": lambda pkg: (lambda x: (lambda h: pkg.grad(
        (h * x).sum(), [x], no_grad_vars=[h])[0].numpy())(x * 2.0))(
        _x(pkg, [1.0, 2.0])),
    "multiple_outputs": lambda pkg: (lambda x: pkg.grad(
        [(x * x).sum(), (x * 3.0).sum()], [x])[0].numpy())(
        _x(pkg, [1.0, 2.0])),
    "allow_unused": lambda pkg: (lambda x, z: pkg.grad(
        (x * 2.0).sum(), [x, z], allow_unused=True))(
        _x(pkg, [1.0]), _x(pkg, [1.0])),
    "retain": lambda pkg: (lambda x: (lambda y: [
        pkg.grad(y, [x], retain_graph=True)[0].numpy(),
        pkg.grad(y, [x])[0].numpy()])((x * x).sum()))(_x(pkg, [1.0, 2.0])),
}


@pytest.mark.parametrize("name", sorted(GRADS))
def test_grad_matches_jax(name):
    j, p = GRADS[name](paddle_tpu), GRADS[name](P)
    j = j if isinstance(j, (list, tuple)) else [j]
    p = p if isinstance(p, (list, tuple)) else [p]
    for a, b in zip(j, p):
        if a is None or isinstance(a, bool):
            assert a == b
        else:
            _close(getattr(a, "numpy", lambda: a)(),
                   getattr(b, "numpy", lambda: b)())


def test_first_order_grad_is_detached():
    x = _x(P, [1.0, 2.0])
    (gx,) = P.grad((x * x).sum(), [x])
    assert gx.stop_gradient and type(gx) is P.Tensor


def test_double_and_third_order_match_jax():
    def run(pkg):
        x = _x(pkg, [2.0, -1.0])
        y = (x ** 3).sum()
        (dx,) = pkg.grad(y, [x], create_graph=True)
        assert not dx.stop_gradient
        (ddx,) = pkg.grad(dx.sum(), [x], create_graph=True)
        (dddx,) = pkg.grad(ddx.sum(), [x])
        z = _x(pkg, [1.0, 2.0, 3.0])
        (dz,) = pkg.grad((z * z).sum(), [z], create_graph=True)
        (dz * dz).sum().backward()
        return [dx.numpy(), ddx.numpy(), dddx.numpy(), z.grad.numpy()]
    _each(run)


def test_gradient_penalty_through_matmul_matches_jax():
    def run(pkg):
        w = _x(pkg, W)
        x = _x(pkg, X)
        out = pkg.tanh(pkg.matmul(x, w)).sum()
        (gx,) = pkg.grad(out, [x], create_graph=True)
        penalty = ((gx * gx).sum() - 1.0) ** 2
        penalty.backward()
        return [gx.numpy(), w.grad.numpy()]
    _each(run)


@pytest.mark.parametrize("case", ["unused", "freed", "only_inputs",
                                  "lengths", "empty"])
def test_grad_errors_match_jax(case):
    got = []
    for pkg in PKGS:
        x, z = _x(pkg, [1.0]), _x(pkg, [1.0])
        y = (x * x).sum()
        try:
            if case == "unused":
                pkg.grad(y, [z])
            elif case == "freed":
                pkg.grad(y, [x])
                pkg.grad(y, [x])
            elif case == "only_inputs":
                pkg.grad(y, [x], only_inputs=False)
            elif case == "lengths":
                pkg.grad([y], [x], grad_outputs=[None, None])
            else:
                pkg.grad([], [x])
        except (RuntimeError, ValueError) as e:
            got.append((type(e), str(e)))
        else:
            got.append(None)
    assert got[0] is not None and got[1] is not None
    assert got[0][0] is got[1][0]
    if case != "freed":                 # torch words its own
        assert got[0][1] == got[1][1]


# ---------------------------------------------------------------- PyLayer

def _layers(pkg):
    class Cube(pkg.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, k=1.0):
            ctx.save_for_backward(x)
            ctx.extra["k"] = k
            return x * x * x * k

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensor
            return g * 3.0 * x * x * ctx.extra["k"]

    class Split(pkg.autograd.PyLayer):
        @staticmethod
        def forward(ctx, a, scale, b):
            return a * scale, a + b

        @staticmethod
        def backward(ctx, ga, gb):
            return ga * 2.0, gb

    return Cube, Split


def test_pylayer_matches_jax():
    def run(pkg):
        Cube, Split = _layers(pkg)
        x = _x(pkg, A)
        y = Cube.apply(x, k=0.5)
        u, v = Split.apply(x, 2.0, _x(pkg, A * 0.0 + 1.0))
        (y.sum() + (u * v).sum()).backward()
        with pkg.no_grad():
            plain = Cube.apply(x)
        return [y.numpy(), x.grad.numpy(), plain.numpy(),
                np.float32(plain.stop_gradient)]
    _each(run)


def test_pylayer_construction_raises():
    for pkg in PKGS:
        Cube, _ = _layers(pkg)
        with pytest.raises(RuntimeError, match=r"Use Cube.apply"):
            Cube()


# --------------------------------------- functional_call, grad, v_and_g

def _linears():
    paddle_tpu.seed(0)
    jl = jnn.Linear(4, 3)
    tl = tnn.Linear(4, 3, device="cpu")
    load_reference_state(tl, {k: np.asarray(v.numpy())
                              for k, v in jl.state_dict().items()})
    return jl, tl


def test_functional_call_matches_jax():
    jl, tl = _linears()
    new = {"weight": rng.randn(4, 3).astype(np.float32)}
    jo = paddle_tpu.jit.api.functional_call(jl, {
        k: paddle_tpu.to_tensor(v) for k, v in new.items()},
        paddle_tpu.to_tensor(X))
    to = P.jit.functional_call(tl, new, P.to_tensor(X))
    _close(jo.numpy(), to.detach().numpy())
    assert not to.requires_grad
    # the layer itself is unchanged
    _close(jl(paddle_tpu.to_tensor(X)).numpy(),
           tl(torch.from_numpy(X)).detach().numpy())


def test_grad_of_functional_call_matches_jax():
    jl, tl = _linears()
    wt = rng.randn(4, 3).astype(np.float32)

    def jloss(w):
        return (paddle_tpu.jit.api.functional_call(
            jl, {"weight": w}, paddle_tpu.to_tensor(X)) ** 2).mean()

    def tloss(w):
        return (P.jit.functional_call(tl, {"weight": w}, P.to_tensor(X))
                ** 2).mean()

    _close(paddle_tpu.grad(jloss)(paddle_tpu.to_tensor(wt)).numpy(),
           P.grad(tloss)(P.to_tensor(wt)).numpy())
    jv, jg = paddle_tpu.value_and_grad(jloss)(paddle_tpu.to_tensor(wt))
    tv, tg = P.value_and_grad(tloss)(P.to_tensor(wt))
    _close(jv.numpy(), tv.numpy())
    _close(jg.numpy(), tg.numpy())


def test_functional_grad_argnums_and_aux_match_jax():
    def run(pkg):
        def f(w, x, scale):
            y = pkg.matmul(x, w)
            return (y * y).sum() * scale, y.mean()

        w, x = pkg.to_tensor(W), pkg.to_tensor(X)
        (gw, gx), aux = pkg.grad(f, argnums=(0, 1), has_aux=True)(w, x, 0.5)
        (v, aux2), g = pkg.value_and_grad(f, has_aux=True)(w, x, 0.5)
        unused = pkg.grad(lambda a, b: (a * 2.0).sum(), argnums=1)(w, w)
        return [gw.numpy(), gx.numpy(), aux.numpy(), v.numpy(),
                aux2.numpy(), g.numpy(), unused.numpy()]
    _each(run)


def test_functional_grad_matches_the_tape():
    w = P.to_tensor(W, stop_gradient=False)
    x = P.to_tensor(X)

    def loss_fn(wt):
        return (P.matmul(x, wt) ** 2).mean()

    g = P.grad(loss_fn)(w)
    loss_fn(w).backward()
    np.testing.assert_allclose(g.numpy(), w.grad.numpy(), rtol=1e-6)
    with pytest.raises(TypeError, match="scalar-output"):
        P.grad(lambda t: t * 2.0)(w)
