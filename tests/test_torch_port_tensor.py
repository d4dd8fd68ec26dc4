"""The port's eager ``Tensor`` and ``Parameter`` against the JAX
package's, on the CPU.

Both packages get the same numpy inputs (one seed); values and dtypes
are compared, bitwise where both do the same arithmetic in the same
order, else within 1e-6 (fp32). Covered: the attributes (``shape`` a
list, ``size``, ``stop_gradient``, ``place``), ``Parameter``, the grad
modes, the operator sugar with tensors and Python scalars, indexing and
``__setitem__``, the in-place methods (including the leaf that requires
grad, ROADMAP C20), the integer dtypes (int32 where JAX without x64
gives int32), the method surface of ``tests/data_ref_tensor_methods.txt``,
torch's own code on a ``Tensor`` (ROADMAP C21) and that importing the
port changes neither ``torch.Tensor`` nor ``torch.nn.Parameter`` and
loads no JAX.
"""
import copy
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as P
from paddle_tpu_torch.convert import load_reference_tensor
from paddle_tpu_torch.core import device as port_device

_HERE = os.path.dirname(os.path.abspath(__file__))
rng = np.random.RandomState(0)
A = rng.randn(3, 4).astype(np.float32)
B = rng.randn(3, 4).astype(np.float32)
POS = (np.abs(rng.randn(3, 4)) + 0.5).astype(np.float32)
I = rng.randint(1, 5, (3, 4)).astype(np.int64)


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    monkeypatch.setattr(port_device, "_CURRENT", torch.device("cpu"))


def _dt(t):
    d = t.dtype
    return str(d).replace("torch.", "") if isinstance(d, torch.dtype) \
        else np.dtype(d).name


def _same(p, j, exact=True):
    assert _dt(p) == _dt(j)
    if exact:
        np.testing.assert_array_equal(p.numpy(), j.numpy())
    else:
        np.testing.assert_allclose(p.numpy(), j.numpy(), rtol=1e-6,
                                   atol=1e-6)


def _both(fn):
    return fn(P), fn(paddle_tpu)


# ------------------------------------------------------------- attributes

def test_tensor_is_a_torch_tensor_with_paddle_attributes():
    p, j = _both(lambda pkg: pkg.to_tensor(A))
    assert isinstance(p, torch.Tensor) and isinstance(p, P.Tensor)
    assert type(p.shape) is list and p.shape == j.shape == [3, 4]
    assert p.size == j.size == 12 and p.size() == torch.Size([3, 4])
    assert p.size(1) == 4
    assert p.ndim == j.ndim == 2
    assert p.stop_gradient and j.stop_gradient
    assert p.place == torch.device("cpu")
    assert p.name is None and not p.persistable and p.trainable
    _same(p.T, j.T)
    assert p.item if False else True
    assert p[0, 0].item() == j[0, 0].item()
    assert p.tolist() == j.tolist()
    assert len(p) == len(j) == 3
    assert [r.shape for r in p] == [r.shape for r in j]
    assert float(p[1, 1]) == float(j[1, 1])
    assert int(P.to_tensor(3)) == 3 and bool(P.to_tensor(True))
    assert repr(p).startswith("Tensor(shape=[3, 4], dtype=float32")


def test_stop_gradient_maps_to_requires_grad():
    p = P.to_tensor(A, stop_gradient=False)
    assert p.requires_grad and not p.stop_gradient and p.is_leaf
    p.stop_gradient = True
    assert not p.requires_grad
    y = P.to_tensor(A, stop_gradient=False) * 2.0
    assert not y.stop_gradient
    y.stop_gradient = True           # cut from the graph, as in JAX
    z = (y * 3.0).sum()
    assert z.stop_gradient
    i = P.to_tensor(I)
    i.stop_gradient = False          # integers keep the flag only
    assert not i.stop_gradient and not i.requires_grad


def test_int_dtypes_follow_jax_without_x64():
    for fn in (lambda pkg: pkg.to_tensor([1, 2]),
               lambda pkg: pkg.to_tensor(np.arange(3)),
               lambda pkg: pkg.arange(5),
               lambda pkg: pkg.to_tensor(I).astype("int64"),
               lambda pkg: pkg.to_tensor(I).sum(),
               lambda pkg: pkg.to_tensor(A).argmax(axis=1),
               lambda pkg: pkg.to_tensor(A).astype("float64"),
               lambda pkg: pkg.to_tensor(np.arange(3.0))):
        p, j = _both(fn)
        _same(p, j)
    assert P.randint(0, 4, [3]).dtype == torch.int32
    assert paddle_tpu.randint(0, 4, [3]).dtype == np.int32


def test_numpy_of_bf16_and_of_a_zero_gradient():
    b = P.to_tensor(A).astype("bfloat16")
    assert b.numpy().dtype == np.float32
    x = P.to_tensor(A, stop_gradient=False)
    P.sgn(x).sum().backward()        # torch's gradient is a ZeroTensor
    np.testing.assert_array_equal(x.grad.numpy(), np.zeros_like(A))


def test_parameter():
    w = P.Parameter(A, name="w")
    jw = paddle_tpu.Parameter(A, name="w")
    assert isinstance(w, torch.nn.Parameter) and isinstance(w, P.Tensor)
    assert not w.stop_gradient and w.persistable and w.trainable
    assert w.name == jw.name == "w"
    assert repr(w).startswith("Parameter containing:\nTensor(")
    frozen = P.Parameter(A, trainable=False)
    assert frozen.stop_gradient and not frozen.trainable
    c = copy.deepcopy(w)
    assert c is not w and c.name == "w" and not c.stop_gradient
    np.testing.assert_array_equal(c.numpy(), A)
    m = torch.nn.Module()
    m.w = w                           # an nn.Module takes it as a parameter
    assert [n for n, _ in m.named_parameters()] == ["w"]
    out = w * 2.0
    assert type(out) is P.Tensor and not out.stop_gradient
    # torch ops on a Parameter give plain tensors, as on nn.Parameter
    assert type(torch.matmul(w, torch.ones(4, 1))) is torch.Tensor


def test_port_optimizer_takes_parameters_unchanged():
    """The port's AdamW on Parameters gives the bits it gives on plain
    nn.Parameters."""
    from paddle_tpu_torch.optimizer import AdamW
    runs = []
    for make in (lambda a: P.Parameter(a),
                 lambda a: torch.nn.Parameter(torch.from_numpy(a.copy()))):
        w = make(A)
        opt = AdamW(learning_rate=0.1, parameters=[w])
        x = torch.from_numpy(B)
        for _ in range(3):
            loss = torch.sum(torch.tanh(torch.as_tensor(x) * w) ** 2)
            loss.backward()
            opt.step()
            opt.clear_grad()
        runs.append(w.detach().numpy().copy() if not isinstance(w, P.Tensor)
                    else w.numpy())
    np.testing.assert_array_equal(runs[0], runs[1])


def test_convert_carries_a_jax_tensor_and_parameter():
    jt = paddle_tpu.to_tensor(A, stop_gradient=False)
    jt.name = "h"
    pt = load_reference_tensor(np.asarray(jt.numpy()), jt.stop_gradient,
                               jt.name, jt.trainable)
    assert type(pt) is P.Tensor and not pt.stop_gradient and pt.name == "h"
    _same(pt, jt)
    jp = paddle_tpu.Parameter(A, name="w", trainable=False)
    pp = load_reference_tensor(np.asarray(jp.numpy()), jp.stop_gradient,
                               jp.name, jp.trainable, parameter=True)
    assert isinstance(pp, P.Parameter) and pp.name == "w"
    assert pp.stop_gradient == jp.stop_gradient and not pp.trainable
    _same(pp, jp)


# ---------------------------------------------------------- grad modes

def test_grad_modes_match_jax():
    for pkg in (P, paddle_tpu):
        x = pkg.to_tensor(A, stop_gradient=False)
        with pkg.no_grad():
            assert not pkg.is_grad_enabled()
            assert (x * 2.0).stop_gradient
            with pkg.enable_grad():
                assert not (x * 2.0).stop_gradient
        assert pkg.is_grad_enabled()

        @pkg.no_grad()
        def f(t):
            return t * 2.0

        assert f(x).stop_gradient
        pkg.set_grad_enabled(False)
        try:
            assert (x * 2.0).stop_gradient
        finally:
            pkg.set_grad_enabled(True)
        assert not (x * 2.0).stop_gradient


# ------------------------------------------------------- operator sugar

SUGAR = [
    ("add", lambda a, b: a + b), ("radd", lambda a, b: 2.5 + a),
    ("sub", lambda a, b: a - b), ("rsub", lambda a, b: 1 - a),
    ("mul", lambda a, b: a * b), ("rmul", lambda a, b: 3 * a),
    ("div", lambda a, b: a / b), ("rdiv", lambda a, b: 2.0 / b),
    ("floordiv", lambda a, b: a // b), ("mod", lambda a, b: a % b),
    ("pow", lambda a, b: a ** 2), ("rpow", lambda a, b: 2.0 ** a),
    ("matmul", lambda a, b: a @ b.T), ("neg", lambda a, b: -a),
    ("abs", lambda a, b: abs(a)), ("eq", lambda a, b: a == b),
    ("ne", lambda a, b: a != b), ("lt", lambda a, b: a < b),
    ("le", lambda a, b: a <= b), ("gt", lambda a, b: a > 0.0),
    ("ge", lambda a, b: a >= b),
]


@pytest.mark.parametrize("name,fn", SUGAR, ids=[s[0] for s in SUGAR])
@pytest.mark.parametrize("kind", ["float", "int"])
def test_operator_sugar_matches_jax(name, fn, kind):
    a, b = (A, POS) if kind == "float" else (I, I + 1)
    p = fn(P.to_tensor(a), P.to_tensor(b))
    j = fn(paddle_tpu.to_tensor(a), paddle_tpu.to_tensor(b))
    _same(p, j, exact=name not in ("matmul", "div", "rdiv", "pow", "rpow"))


def test_bitwise_sugar_matches_jax():
    for fn in (lambda a, b: a & b, lambda a, b: a | b,
               lambda a, b: a ^ b, lambda a, b: ~a):
        p = fn(P.to_tensor(I), P.to_tensor(I + 3))
        j = fn(paddle_tpu.to_tensor(I), paddle_tpu.to_tensor(I + 3))
        _same(p, j)


def test_torch_ops_on_a_tensor_return_a_tensor():
    x = P.to_tensor(A)
    assert type(torch.tanh(x)) is P.Tensor
    y = (x + 1).astype("float16")
    assert type(y) is P.Tensor and y.dtype == torch.float16


def test_ops_take_plain_torch_tensors_and_leave_them_plain():
    plain = torch.from_numpy(B.copy())
    w = torch.nn.Parameter(torch.from_numpy(A.copy()))
    out = P.add(plain, w)
    assert type(out) is P.Tensor and not out.stop_gradient
    assert type(plain) is torch.Tensor and type(w) is torch.nn.Parameter
    same = P.squeeze(plain, axis=0)  # an impl that returns its operand
    assert type(same) is P.Tensor and type(plain) is torch.Tensor
    np.testing.assert_array_equal(same.numpy(), B)
    out.sum().backward()
    np.testing.assert_array_equal(w.grad.numpy(), np.ones_like(A))


# ------------------------------------------------------------ indexing

INDEXES = [
    ("int", lambda t, pkg: t[1]),
    ("slice", lambda t, pkg: t[1:3, ::2]),
    ("neg", lambda t, pkg: t[-1, -2:]),
    ("list", lambda t, pkg: t[[0, 2]]),
    ("tensor", lambda t, pkg: t[pkg.to_tensor(np.array([2, 0]))]),
    ("mask", lambda t, pkg: t[pkg.to_tensor(A > 0)]),
    ("none", lambda t, pkg: t[None, ..., 1]),
]


@pytest.mark.parametrize("name,fn", INDEXES, ids=[i[0] for i in INDEXES])
def test_getitem_and_its_gradient_match_jax(name, fn):
    grads = []
    for pkg in (P, paddle_tpu):
        x = pkg.to_tensor(A, stop_gradient=False)
        out = fn(x, pkg)
        grads.append((out, x))
    (po, px), (jo, jx) = grads
    _same(po, jo)
    w = rng.randn(*po.shape).astype(np.float32)
    (po * P.to_tensor(w)).sum().backward()
    (jo * paddle_tpu.to_tensor(w)).sum().backward()
    _same(px.grad, jx.grad)


SETS = [
    ("row", lambda t, pkg: t.__setitem__(0, 7.0)),
    ("slice", lambda t, pkg: t.__setitem__((slice(1, 3), 1), 2.0)),
    ("tensor_value", lambda t, pkg: t.__setitem__(
        1, pkg.to_tensor(B[0]))),
    ("mask", lambda t, pkg: t.__setitem__(pkg.to_tensor(A > 0), 0.0)),
]


@pytest.mark.parametrize("name,fn", SETS, ids=[s[0] for s in SETS])
def test_setitem_values_and_gradient_match_jax(name, fn):
    res = []
    for pkg in (P, paddle_tpu):
        x = pkg.to_tensor(A, stop_gradient=False)
        t = x * 2.0
        fn(t, pkg)
        res.append((t, x))
    (pt, px), (jt, jx) = res
    _same(pt, jt)
    pt.sum().backward()
    jt.sum().backward()
    _same(px.grad, jx.grad)


def test_setitem_on_a_leaf_that_requires_grad_c20():
    """JAX re-points the leaf at the scatter's output; torch refuses an
    in-place write to such a leaf, so the port writes the value outside
    autograd and the tensor stays a leaf (ROADMAP C20)."""
    px = P.to_tensor(A, stop_gradient=False)
    jx = paddle_tpu.to_tensor(A, stop_gradient=False)
    px[0] = 5.0
    jx[0] = 5.0
    _same(px, jx)
    assert px.is_leaf and not px.stop_gradient
    (px * 3.0).sum().backward()
    assert px.grad is not None          # the JAX leaf would get none
    (jx * 3.0).sum().backward()
    assert jx.grad is None


# ---------------------------------------------------------- in place

INPLACE = [
    ("add_", lambda t, pkg: t.add_(pkg.to_tensor(B))),
    ("subtract_", lambda t, pkg: t.subtract_(pkg.to_tensor(B))),
    ("scale_", lambda t, pkg: t.scale_(2.0, 1.0)),
    ("clip_", lambda t, pkg: t.clip_(-0.5, 0.5)),
    ("exp_", lambda t, pkg: t.exp_()),
    ("sqrt_", lambda t, pkg: (t * t + 1.0).sqrt_()),
    ("lerp_", lambda t, pkg: t.lerp_(pkg.to_tensor(B), 0.25)),
    ("tanh_", lambda t, pkg: pkg.tanh_(t)),
    ("put_along_axis_", lambda t, pkg: t.put_along_axis_(
        pkg.to_tensor(np.array([[0], [1], [2]])), 9.0, 1)),
]


@pytest.mark.parametrize("name,fn", INPLACE, ids=[i[0] for i in INPLACE])
def test_inplace_on_a_computed_tensor_matches_jax(name, fn):
    res = []
    for pkg in (P, paddle_tpu):
        y = pkg.to_tensor(A, stop_gradient=False)
        z = y * 3.0
        out = fn(z, pkg)
        res.append((out, y))
    (po, py), (jo, jy) = res
    _same(po, jo, exact=name not in ("exp_", "sqrt_", "tanh_", "lerp_"))
    po.sum().backward()
    jo.sum().backward()
    np.testing.assert_allclose(py.grad.numpy(), jy.grad.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_inplace_on_a_leaf_that_requires_grad_c20():
    """``x.add_(x)`` on a leaf that requires grad: the JAX package's
    value; torch keeps the tensor a leaf (ROADMAP C20)."""
    p, j = _both(lambda pkg: pkg.to_tensor(np.ones(3, np.float32),
                                           stop_gradient=False))
    p.add_(p)
    j.add_(j)
    _same(p, j)
    assert p.is_leaf and not p.stop_gradient


def test_shape_changing_inplace_matches_jax():
    for fn in (lambda t, pkg: t.reshape_([4, 3]),
               lambda t, pkg: pkg.unsqueeze_(t, 0),
               lambda t, pkg: t.unsqueeze_(1).squeeze_(1),
               lambda t, pkg: t.flatten_()):
        res = []
        for pkg in (P, paddle_tpu):
            y = pkg.to_tensor(A, stop_gradient=False)
            z = y * 2.0
            out = fn(z, pkg)
            assert out is z
            res.append((z, y))
        (pz, py), (jz, jy) = res
        _same(pz, jz)
        pz.sum().backward()
        jz.sum().backward()
        _same(py.grad, jy.grad)


def test_refills_keep_shape_dtype_and_range():
    r = P.zeros([2000])
    assert r.uniform_(0.0, 1.0) is r
    assert 0.45 < float(r.mean()) < 0.55 and float(r.min()) >= 0.0
    e = P.zeros([2000]).exponential_(2.0)
    assert e.dtype == torch.float32 and float(e.min()) > 0.0
    assert 0.4 < float(e.mean()) < 0.6
    assert P.Tensor.floor_mod is P.Tensor.remainder


# --------------------------------------------------------- the surface

def test_method_surface_resolves_as_on_the_jax_tensor():
    ref = set(open(os.path.join(
        _HERE, "data_ref_tensor_methods.txt")).read().split())
    j = paddle_tpu.ones([2, 2])
    p = P.ones([2, 2])
    want = sorted(n for n in ref if hasattr(j, n))
    assert len(want) > 200
    assert not [n for n in want if not hasattr(p, n)]


def test_torch_code_on_a_tensor_c21():
    """torch's own code on a Tensor: its functions and modules run (they
    reach C++ through the default ``__torch_function__``), and so do
    repr, pickling, ``torch.save``, ``deepcopy`` and numpy. A torch
    Python function that calls a Tensor method by name gets Paddle's
    method, and a torch-style method call gets Paddle's signature
    (ROADMAP C21): ``torch.split(x, 1, dim)`` splits into one part
    (Paddle's count), ``x.transpose(0, 1)`` raises."""
    import io

    import torch.nn.functional as F
    x = P.to_tensor(rng.randn(2, 3, 4).astype(np.float32))
    w = P.to_tensor(rng.randn(4, 4).astype(np.float32))
    for out in (F.layer_norm(x, (4,)), F.softmax(x, -1), F.linear(x, w),
                F.gelu(x), F.pad(x, (1, 1)), torch.nn.Linear(4, 2)(x),
                torch.nn.LayerNorm(4)(x), torch.einsum("abc,cd->abd", x, w),
                F.scaled_dot_product_attention(x, x, x), x.float(),
                x.view(6, 4), torch.cat([x, x])):
        assert isinstance(out, P.Tensor)
    torch.testing.assert_close(x, x.clone())
    assert isinstance(copy.deepcopy(x), P.Tensor)
    assert isinstance(pickle.loads(pickle.dumps(x)), P.Tensor)
    buf = io.BytesIO()
    torch.save(x, buf)
    buf.seek(0)
    np.testing.assert_array_equal(
        torch.load(buf, weights_only=False).numpy(), x.numpy())
    np.testing.assert_array_equal(np.asarray(x), x.numpy())
    assert len(torch.split(x, 1, dim=2)) == 1       # torch: 4 parts
    with pytest.raises(TypeError, match="op 'transpose'"):
        x.transpose(0, 1)


def test_import_installs_nothing_on_torch_and_loads_no_jax():
    code = (
        "import sys, torch\n"
        "before = (dir(torch.Tensor), dir(torch.nn.Parameter))\n"
        "import paddle_tpu_torch\n"
        f"sys.path.insert(0, {_HERE!r})\n"
        "import _port_op_cases  # the op cases chip_smoke.py runs\n"
        "after = (dir(torch.Tensor), dir(torch.nn.Parameter))\n"
        "assert before == after, 'torch changed'\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not any(m.startswith('paddle_tpu.') or m == 'paddle_tpu'\n"
        "               for m in sys.modules), 'paddle_tpu imported'\n"
        "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(_HERE)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr
