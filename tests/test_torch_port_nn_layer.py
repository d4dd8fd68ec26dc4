"""The port's ``nn.Layer`` (on ``torch.nn.Module``), its containers and
initializers, against the JAX package's ``nn/layer.py``,
``nn/container.py`` and ``nn/initializer.py`` on the CPU.

One script of ``Layer`` calls runs against both packages: the registry,
traversal order, ``state_dict`` (non-persistable buffers left out),
``set_state_dict``'s lists and messages, hooks and their ``remove``,
``train`` / ``eval``, ``apply``'s order, ``to(dtype)``,
``clear_gradients``, ``create_parameter`` with ``ParamAttr`` (ROADMAP
C23) and ``deepcopy``. Values go through both with the JAX weights
carried across by ``set_state_dict``. Tolerances: fp32 within 1e-5,
gradients within 1e-4. Random initializers are held by shape, dtype,
mean, std, bounds and fan (JAX's PRNG and torch's differ); ``Assign``,
``Constant`` and ``Dirac`` exactly.
"""
import collections
import copy

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu.nn.initializer as jinit
import paddle_tpu_torch as tp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import initializer as tinit

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def _np(x):
    if hasattr(x, "_data"):
        return np.asarray(x._data)
    return x.detach().as_subclass(torch.Tensor).float().numpy()


def _build(nn, pkg, cpu=None):
    """The same user-defined model in either package."""
    kw = {} if cpu is None else dict(device=cpu)

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(6, 5, **kw)
            self.scale = self.create_parameter(
                [5], default_initializer=nn.initializer.Constant(1.5),
                **kw)
            self.register_buffer("steps", pkg.to_tensor(
                np.arange(3, dtype=np.float32)) if cpu is None else
                torch.arange(3, dtype=torch.float32))
            self.register_buffer("scratch", pkg.to_tensor(
                np.zeros(2, np.float32)) if cpu is None else
                torch.zeros(2), persistable=False)

        def forward(self, x):
            return self.fc(x) * self.scale

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.block = Block()
            self.seq = nn.Sequential(("first", nn.Linear(5, 4, **kw)),
                                     ("act", nn.ReLU()))
            self.heads = nn.LayerList([nn.Linear(4, 3, **kw)
                                       for _ in range(2)])
            self.extra = nn.ParameterList([self.create_parameter(
                [3], default_initializer=nn.initializer.Constant(0.5),
                **kw)])

        def forward(self, x):
            h = self.seq(self.block(x))
            return self.heads[0](h) + self.heads[1](h) * self.extra[0]

    return Net()


@pytest.fixture(scope="module")
def pair():
    jp.seed(0)
    jm = _build(jnn, jp)
    tm = _build(tnn, tp, cpu="cpu")
    missing, unexpected = tm.set_state_dict(
        {k: np.asarray(v._data) for k, v in jm.state_dict().items()})
    assert missing == [] and unexpected == []
    return jm, tm


def _x(seed=0, shape=(3, 6)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_registry_and_traversal_match(pair):
    jm, tm = pair
    assert isinstance(tm, torch.nn.Module)
    assert [n for n, _ in tm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    assert list(tm.state_dict()) == list(jm.state_dict())
    assert "block.scratch" not in tm.state_dict()
    assert [n for n, _ in tm.named_buffers()] == \
        [n for n, _ in jm.named_buffers()]
    assert [(n, type(m).__name__) for n, m in
            tm.named_sublayers(include_self=True)] == \
        [(n, type(m).__name__) for n, m in
         jm.named_sublayers(include_self=True)]
    assert len(tm.parameters()) == len(jm.parameters())
    assert len(tm.parameters(include_sublayers=False)) == 0
    assert len(tm.block.parameters(include_sublayers=False)) == 1
    assert [type(m).__name__ for m in tm.children()] == \
        [type(m).__name__ for m in jm.children()]
    assert tm._sub_layers is tm._modules
    assert all(isinstance(p, tp.Parameter) for p in tm.parameters())
    # the JAX package keeps a non-persistable buffer when given a prefix
    # (it matches the buffer's name without it); the port leaves it out
    assert list(tm.state_dict(structured_name_prefix="net")) == \
        [k for k in jm.state_dict(structured_name_prefix="net.")
         if k != "net.block.scratch"]
    assert list(tm.block.state_dict(include_sublayers=False)) == \
        list(jm.block.state_dict(include_sublayers=False))


def test_forward_backward_and_boundary(pair):
    jm, tm = pair
    x = _x()
    jx = jp.to_tensor(x, stop_gradient=False)
    jy = jm(jx)
    jy.sum().backward()
    tx = tp.to_tensor(x, stop_gradient=False, place="cpu")
    ty = tm(tx)
    assert type(ty) is tp.Tensor
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    ty.sum().backward()
    np.testing.assert_allclose(_np(tx.grad), _np(jx.grad), **GRAD_TOL)
    for (n, jpar), (_, tpar) in zip(jm.named_parameters(),
                                    tm.named_parameters()):
        np.testing.assert_allclose(_np(tpar.grad), _np(jpar.grad),
                                   err_msg=n, **GRAD_TOL)
    # a plain call stays plain
    out = tm(torch.as_tensor(x))
    assert type(out) is torch.Tensor
    np.testing.assert_allclose(out.detach().numpy(), _np(jy), **TOL)
    tm.clear_gradients()
    jm.clear_gradients()
    assert all(p.grad is None for p in tm.parameters())
    assert all(p.grad is None for p in jm.parameters())


def test_functional_call_and_load_state_dict(pair):
    _, tm = pair
    x = torch.as_tensor(_x(1))
    params = {n: torch.zeros_like(p) for n, p in tm.named_parameters()}
    out = torch.func.functional_call(tm, params, (x,))
    assert torch.equal(out, torch.zeros_like(out))
    other = _build(tnn, tp, cpu="cpu")
    other.load_state_dict(tm.state_dict())
    assert torch.equal(other(x), tm(x))


def test_hooks_see_tensors_and_remove(pair):
    jm, tm = pair
    x = _x(2)
    seen = {}

    def make(tag):
        def pre(layer, inputs):
            seen[tag + "pre"] = type(inputs[0]).__name__
            return (inputs[0] * 2.0,)

        def post(layer, inputs, outputs):
            seen[tag + "post"] = type(outputs).__name__
            return outputs + 1.0

        return pre, post

    outs = {}
    for tag, m, xin in (("j", jm, jp.to_tensor(x)),
                        ("t", tm, tp.to_tensor(x, place="cpu"))):
        pre, post = make(tag)
        h1 = m.block.register_forward_pre_hook(pre)
        h2 = m.seq.register_forward_post_hook(post)
        outs[tag] = _np(m(xin))
        h1.remove()
        h2.remove()
        outs[tag + "_after"] = _np(m(xin))
    np.testing.assert_allclose(outs["t"], outs["j"], **TOL)
    np.testing.assert_allclose(outs["t_after"], outs["j_after"], **TOL)
    assert seen["tpre"] == "Tensor" and seen["tpost"] == "Tensor"
    # hooks on a plain call see Tensors too; the result stays plain
    pre, _ = make("p")
    h = tm.block.register_forward_pre_hook(pre)
    assert type(tm(torch.as_tensor(x))) is torch.Tensor
    assert seen["ppre"] == "Tensor"
    h.remove()


def test_train_eval_and_apply_order(pair):
    jm, tm = pair
    for m in (jm, tm):
        m.eval()
    assert not any(m.training for m in tm.sublayers(include_self=True))
    tm.train()
    assert all(m.training for m in tm.sublayers(include_self=True))
    jm.train()
    order = {}
    for tag, m in (("j", jm), ("t", tm)):
        names = []
        m.apply(lambda layer: names.append(type(layer).__name__))
        order[tag] = names
    assert order["t"] == order["j"]
    assert order["t"][0] == "Net"


def test_set_state_dict_lists_and_messages(pair):
    jm, tm = pair
    sd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    sd.pop("block.fc.bias")
    sd["nope"] = np.zeros(2, np.float32)
    j_lists = jm.set_state_dict(sd)
    t_lists = tm.set_state_dict(sd)
    assert t_lists == j_lists == (["block.fc.bias"], ["nope"])
    bad = dict(sd, **{"block.fc.weight": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError) as je:
        jm.set_state_dict(bad)
    with pytest.raises(ValueError) as te:
        tm.set_state_dict(bad)
    assert str(te.value) == str(je.value)
    # nothing was written by the failed call
    np.testing.assert_allclose(_np(tm.block.fc.weight),
                               np.asarray(jm.block.fc.weight._data))
    assert tm.load_dict(tm.state_dict()) == ([], [])


def test_to_dtype_astype_and_deepcopy():
    jp.seed(1)
    jm = _build(jnn, jp)
    tm = _build(tnn, tp, cpu="cpu")
    tm.set_state_dict({k: np.asarray(v._data)
                       for k, v in jm.state_dict().items()})
    snapshot = copy.deepcopy(tm)
    assert all(isinstance(p, tp.Parameter) for p in snapshot.parameters())
    assert snapshot.block.fc.weight is not tm.block.fc.weight
    keep = tm.block.fc.weight
    jm.to(dtype="bfloat16")
    tm.to(dtype="bfloat16")
    assert tm.block.fc.weight is keep
    assert [str(p.dtype).split(".")[-1] for p in tm.parameters()] == \
        [str(p.dtype) for p in jm.parameters()]
    assert tm.block.steps.dtype == torch.bfloat16
    tm.astype("float32")
    tm.to(torch.device("cpu"))
    tm.to("cpu", "float32")
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    x = torch.as_tensor(_x(3))
    np.testing.assert_allclose(tm(x).detach().numpy(),
                               snapshot(x).detach().numpy(), atol=2e-2)
    with torch.no_grad():
        snapshot.block.fc.weight.add_(1.0)
    assert not torch.equal(snapshot.block.fc.weight, tm.block.fc.weight)


def test_create_parameter_with_param_attr_c23():
    """``ParamAttr(name=, learning_rate=, need_clip=)`` is accepted and
    applied nowhere, in both packages (ROADMAP C23); ``trainable`` and
    ``regularizer`` are applied."""
    from paddle_tpu.regularizer import L2Decay as JL2
    from paddle_tpu_torch.regularizer import L2Decay as TL2
    got = {}
    for tag, nn, reg, kw in (("j", jnn, JL2(0.1), {}),
                             ("t", tnn, TL2(0.1), dict(device="cpu"))):
        layer = nn.Layer()
        attr = nn.ParamAttr(name="w", learning_rate=0.5, need_clip=False,
                            trainable=False, regularizer=reg,
                            initializer=nn.initializer.Constant(2.0))
        p = layer.create_parameter([2, 3], attr=attr, **kw)
        b = layer.create_parameter([3], is_bias=True, **kw)
        w = layer.create_parameter([4, 6], **kw)
        got[tag] = (p.stop_gradient, _np(p), getattr(p, "regularizer", None)
                    is reg, b.stop_gradient, _np(b), tuple(w.shape),
                    str(w.dtype).split(".")[-1])
    assert got["t"][0] is True and got["j"][0] is True
    for a, b in zip(got["t"][1:], got["j"][1:]):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    lin = tnn.Linear(3, 2, device="cpu", weight_attr=tnn.ParamAttr(
        name="lin_w", learning_rate=2.0, need_clip=False))
    assert lin.weight.shape == [3, 2]


def test_register_buffer_persistent_keyword():
    m = tnn.Layer()
    m.register_buffer("a", torch.zeros(1), persistable=False)
    m.register_buffer("b", torch.zeros(1), persistent=False)
    m.register_buffer("c", torch.zeros(1))
    assert list(m.state_dict()) == ["c"]
    assert [n for n, _ in m.named_buffers()] == ["a", "b", "c"]


# ---------------------------------------------------------- containers

def _container_script(nn, kw):
    out = {}
    seq = nn.Sequential(collections.OrderedDict(
        [("a", nn.Linear(2, 2, **kw)), ("b", nn.ReLU())]))
    out["seq_keys"] = list(seq.state_dict())
    out["seq_len"] = len(seq)
    out["seq_slice"] = type(seq[0:1]).__name__
    ll = nn.LayerList([nn.Linear(2, 2, **kw)])
    ll.append(nn.Linear(2, 3, **kw))
    ll.extend([nn.Linear(3, 1, **kw)])
    ll.insert(1, nn.ReLU())
    ll[0] = nn.Linear(2, 4, **kw)
    out["ll_keys"] = list(ll.state_dict())
    out["ll_types"] = [type(m).__name__ for m in ll]
    out["ll_slice"] = len(ll[1:])
    ld = nn.LayerDict({"x": nn.Linear(2, 2, **kw)})
    ld["y"] = nn.ReLU()
    ld.update([("z", nn.Linear(1, 1, **kw))])
    del ld["x"]
    out["ld"] = (list(ld.keys()), len(ld), "y" in ld, list(ld))
    out["ld_keys"] = list(ld.state_dict())
    return out


def test_containers_match():
    jp.seed(2)
    assert _container_script(tnn, dict(device="cpu")) == \
        _container_script(jnn, {})


def test_parameter_list_and_sequential_forward():
    jp.seed(3)
    jm = jnn.Sequential(jnn.Linear(4, 3), jnn.ReLU(), jnn.Linear(3, 2))
    tm = tnn.Sequential(tnn.Linear(4, 3, device="cpu"), tnn.ReLU(),
                        tnn.Linear(3, 2, device="cpu"))
    tm.set_state_dict({k: np.asarray(v._data)
                       for k, v in jm.state_dict().items()})
    x = _x(4, (5, 4))
    np.testing.assert_allclose(_np(tm(tp.to_tensor(x, place="cpu"))),
                               _np(jm(jp.to_tensor(x))), **TOL)
    assert [type(m).__name__ for m in tm] == ["Linear", "ReLU", "Linear"]
    pl = tnn.ParameterList([tp.Parameter(torch.ones(2))])
    pl.append(tp.Parameter(torch.zeros(3)))
    assert len(pl) == 2 and list(pl.state_dict()) == ["0", "1"]
    assert [tuple(p.shape) for p in pl] == [(2,), (3,)]


# ---------------------------------------------------------- initializers

FAN_SHAPES = [(), (7,), (5, 9), (8, 3, 5), (8, 4, 3, 3), (6, 2, 3, 3, 3),
              (4, 2, 2, 2, 2, 2)]


@pytest.mark.parametrize("shape", FAN_SHAPES, ids=str)
def test_fan_in_out_matches(shape):
    assert tinit._fan_in_out(shape) == jinit._fan_in_out(shape)


def _draw(init, shape, seed=0, dtype="float32"):
    return init(shape, dtype, device="cpu",
                generator=torch.Generator().manual_seed(seed))


RANDOM_CASES = [
    # name, port initializer, shape, (mean, std, low, high)
    ("uniform", tinit.Uniform(-0.5, 1.5), (200, 300),
     (0.5, 2.0 / np.sqrt(12), -0.5, 1.5)),
    ("normal", tinit.Normal(0.3, 2.0), (200, 300), (0.3, 2.0, None, None)),
    ("truncated_normal", tinit.TruncatedNormal(0.1, 0.5), (200, 300),
     (0.1, 0.5 * 0.8796, 0.1 - 1.0, 0.1 + 1.0)),
    ("xavier_uniform", tinit.XavierUniform(), (300, 200),
     (0.0, np.sqrt(6.0 / 500) / np.sqrt(3), -np.sqrt(6.0 / 500),
      np.sqrt(6.0 / 500))),
    ("xavier_normal_conv", tinit.XavierNormal(gain=2.0), (64, 32, 3, 3),
     (0.0, 2.0 * np.sqrt(2.0 / (32 * 9 + 64 * 9)), None, None)),
    ("kaiming_uniform", tinit.KaimingUniform(), (400, 100),
     (0.0, np.sqrt(2.0) * np.sqrt(3.0 / 400) / np.sqrt(3),
      -np.sqrt(2.0) * np.sqrt(3.0 / 400), np.sqrt(2.0) * np.sqrt(3.0 / 400))),
    ("kaiming_normal_leaky", tinit.KaimingNormal(
        negative_slope=0.2, nonlinearity="leaky_relu"), (64, 16, 5, 5),
     (0.0, np.sqrt(2.0 / 1.04) / np.sqrt(16 * 25), None, None)),
    ("kaiming_fan_in", tinit.KaimingNormal(fan_in=10), (300, 200),
     (0.0, np.sqrt(2.0) / np.sqrt(10), None, None)),
]


@pytest.mark.parametrize("case", RANDOM_CASES, ids=lambda c: c[0])
def test_random_initializers_statistics(case):
    """The port's draw at the reference's statistics; the JAX draw of
    the same initializer (by name) at the same ones."""
    name, init, shape, (mean, std, low, high) = case
    t = _draw(init, shape)
    assert t.shape == torch.Size(shape) and t.dtype == torch.float32
    arr = t.numpy().astype(np.float64)
    jinit_obj = getattr(jinit, type(init).__name__)(**{
        k: v for k, v in vars(init).items()})
    ref = np.asarray(jinit_obj(shape, "float32"), np.float64)
    n = arr.size
    for a in (arr, ref):
        assert abs(a.mean() - mean) < 5 * std / np.sqrt(n) + 1e-7
        assert abs(a.std() - std) < 0.03 * std
        if low is not None:
            assert a.min() >= low - 1e-6 and a.max() <= high + 1e-6
    # the same generator state gives the same bits
    assert torch.equal(_draw(init, shape), t)
    assert _draw(init, (4, 4), dtype="bfloat16").dtype == torch.bfloat16


@pytest.mark.parametrize("shape", [(6, 4), (4, 6), (8, 3, 2, 2)], ids=str)
def test_orthogonal_is_orthonormal(shape):
    gain = 1.5
    w = _draw(tinit.Orthogonal(gain), shape).numpy().astype(np.float64)
    j = np.asarray(jinit.Orthogonal(gain)(shape, "float32"), np.float64)
    for a in (w, j):
        m = a.reshape(-1, shape[-1]) / gain
        if m.shape[0] >= m.shape[1]:
            np.testing.assert_allclose(m.T @ m, np.eye(m.shape[1]),
                                       atol=1e-5)
        else:
            np.testing.assert_allclose(m @ m.T, np.eye(m.shape[0]),
                                       atol=1e-5)


@pytest.mark.parametrize("case", ["constant", "assign", "dirac",
                                  "dirac_groups"])
def test_exact_initializers_match(case):
    shape, t_init, j_init = {
        "constant": ((3, 4), tinit.Constant(0.75), jinit.Constant(0.75)),
        "assign": ((2, 3), tinit.Assign(np.arange(6.0).reshape(3, 2)),
                   jinit.Assign(np.arange(6.0).reshape(3, 2))),
        "dirac": ((4, 3, 3, 3), tinit.Dirac(), jinit.Dirac()),
        "dirac_groups": ((6, 2, 3), tinit.Dirac(groups=2),
                         jinit.Dirac(groups=2)),
    }[case]
    np.testing.assert_array_equal(_draw(t_init, shape).numpy(),
                                  np.asarray(j_init(shape, "float32")))


def test_layer_defaults_use_the_reference_initializers():
    """Linear's XavierNormal, Conv2D's KaimingUniform bound and bias,
    LayerNorm's ones and zeros, Embedding's Normal(0, 1)."""
    g = torch.Generator().manual_seed(0)
    lin = tnn.Linear(300, 200, device="cpu", generator=g)
    assert abs(lin.weight.detach().as_subclass(torch.Tensor).std().item()
               - np.sqrt(2.0 / 500)) < 0.03 * np.sqrt(2.0 / 500)
    assert not lin.bias.detach().as_subclass(torch.Tensor).any()
    conv = tnn.Conv2D(8, 16, 3, device="cpu", generator=g,
                      weight_attr=tnn.ParamAttr(
                          initializer=tinit.Constant(0.1)))
    assert torch.equal(conv.weight, torch.full((16, 8, 3, 3), 0.1))
    bound = 1.0 / np.sqrt(8 * 9)
    assert conv.bias.abs().max().item() <= bound
    conv2 = tnn.Conv2D(8, 16, 3, device="cpu", generator=g)
    assert conv2.weight.abs().max().item() <= bound * (1 + 1e-6)
    ln = tnn.LayerNorm(5, device="cpu")
    assert torch.equal(ln.weight, torch.ones(5)) and \
        torch.equal(ln.bias, torch.zeros(5))
    with pytest.raises(NotImplementedError, match="A2b-2"):
        tnn.Conv2D(2, 2, 3, padding_mode="reflect", device="cpu")
