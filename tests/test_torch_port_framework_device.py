"""The port's ``framework``, ``device``, top-level exports, validators
and dispatch hooks against the JAX package's, on the CPU.

- Exports: every name of ``tests/data_ref_paddle_exports.txt`` that
  ``paddle_tpu`` resolves resolves in ``paddle_tpu_torch``, but the
  names listed in ``LATER`` with their ROADMAP queue item.
- Validators: the messages of ``tests/test_enforce.py``'s cases on the
  ops of this slice are equal, word for word.
- Hooks: ``prof_hook`` spans are ``op::<name>``, in the same sequence as
  the JAX dispatch's, while a Profiler records, and never begin while it
  does not; under ``amp.auto_cast`` (O1) the cast decisions per op name
  equal the JAX dispatch's; ``check_nan_inf`` raises naming the op.
- framework and device: predicates, ``iinfo``/``finfo``, Places as
  ``torch.device``s, the RNG state, ``batch``, ``check_shape``,
  ``DataParallel``'s delegation; the memory API on the CPU (no device
  allocator: 0) and the build queries (ROADMAP C20: ``is_compiled_with_
  cuda`` is False in the JAX package and follows torch's build here).
"""
import importlib
import os

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as P
from paddle_tpu.core import prof_hook as jax_prof_hook
from paddle_tpu.core.enforce import EnforceError as JaxEnforceError
from paddle_tpu_torch.core import device as port_device
from paddle_tpu_torch.core import prof_hook as port_prof_hook
from paddle_tpu_torch.core.enforce import EnforceError

_HERE = os.path.dirname(os.path.abspath(__file__))
rng = np.random.RandomState(0)
A = rng.randn(3, 4).astype(np.float32)

# exports of paddle_tpu that this slice leaves to a later queue item
LATER = {
    "Model": "A9 (hapi)", "summary": "A9 (hapi)", "flops": "A9 (hapi)",
    "save": "A9 (framework_io)", "load": "A9 (framework_io)",
}


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    monkeypatch.setattr(port_device, "_CURRENT", torch.device("cpu"))


def test_exports_resolve_as_in_the_jax_package():
    ref = open(os.path.join(_HERE, "data_ref_paddle_exports.txt")).read()
    names = [n for n in ref.split() if hasattr(paddle_tpu, n)]
    missing = sorted(n for n in names if not hasattr(P, n))
    assert missing == sorted(LATER)
    for n in ("get_default_dtype", "set_default_dtype", "dtype",
              "in_dynamic_mode", "enable_static", "disable_static",
              "get_cudnn_version", "grad", "value_and_grad", "autograd",
              "device", "jit"):
        assert hasattr(P, n), n


def test_mode_toggles_and_default_dtype():
    assert P.in_dynamic_mode()
    P.enable_static()
    try:
        assert not P.in_dynamic_mode()
    finally:
        P.disable_static()
    assert P.get_default_dtype() == torch.float32
    P.set_default_dtype("float16")
    try:
        assert P.to_tensor(1.5).dtype == torch.float16
        assert P.ones([2]).dtype == torch.float16
    finally:
        P.set_default_dtype("float32")
    with pytest.raises(TypeError):
        P.set_default_dtype("int32")
    assert P.dtype("float32") is torch.float32


# ------------------------------------------------------------ validators

def _ones(pkg, shape):
    return pkg.ones(shape)


ENFORCE = [
    ("matmul", lambda p: p.matmul(_ones(p, [2, 3]), _ones(p, [4, 5]))),
    ("add", lambda p: p.add(_ones(p, [2, 3]), _ones(p, [4]))),
    ("concat_axis", lambda p: p.concat([_ones(p, [2, 2])], axis=5)),
    ("concat_shape", lambda p: p.concat([_ones(p, [2, 2]),
                                         _ones(p, [2, 3])], axis=0)),
    ("reshape_count", lambda p: p.reshape(_ones(p, [2, 3]), [4, 2])),
    ("reshape_two", lambda p: p.reshape(_ones(p, [2, 3]), [-1, -1])),
    ("transpose", lambda p: p.transpose(_ones(p, [2, 3]), perm=[0, 0])),
    ("topk", lambda p: p.topk(_ones(p, [3]), k=9)),
    ("expand", lambda p: p.expand(_ones(p, [2, 3]), [2, 5])),
    ("stack", lambda p: p.stack([_ones(p, [2]), _ones(p, [3])])),
    ("bmm_rank", lambda p: p.bmm(_ones(p, [2, 2]), _ones(p, [2, 2]))),
    ("bmm_batch", lambda p: p.bmm(_ones(p, [2, 3, 4]),
                                  _ones(p, [5, 4, 3]))),
    ("slice", lambda p: p.slice(_ones(p, [4, 4]), axes=[0, 1],
                                starts=[0], ends=[2, 2])),
    ("strided_slice", lambda p: p.strided_slice(
        _ones(p, [4]), axes=[0], starts=[0], ends=[4], strides=[0])),
    ("pad", lambda p: p.ops.manipulation.pad(_ones(p, [2, 2]), [1, 0, 1])),
    ("pad_mode", lambda p: p.ops.manipulation.pad(_ones(p, [2, 2]), [1, 1],
                                                  mode="bogus")),
    ("gather_nd", lambda p: p.gather_nd(
        _ones(p, [2, 2]), p.to_tensor(np.zeros((1, 3), np.int64)))),
    ("scatter", lambda p: p.scatter(
        _ones(p, [4, 3]), p.to_tensor(np.array([0], np.int64)),
        _ones(p, [1, 5]))),
    ("scatter_nd_add", lambda p: p.scatter_nd_add(
        _ones(p, [4, 3]), p.to_tensor(np.zeros((2, 1), np.int64)),
        _ones(p, [2, 7]))),
    ("kthvalue", lambda p: p.kthvalue(_ones(p, [4]), k=9)),
    ("cross_size", lambda p: p.cross(_ones(p, [2, 4]), _ones(p, [2, 4]),
                                     axis=1)),
    ("cross_shapes", lambda p: p.cross(_ones(p, [2, 2]), _ones(p, [5]))),
    ("dot", lambda p: p.dot(_ones(p, [3]), _ones(p, [4]))),
    ("diagonal", lambda p: p.diagonal(_ones(p, [3, 3]), axis1=0, axis2=0)),
    ("one_hot", lambda p: p.one_hot(p.to_tensor(np.array([1])), 0)),
    ("take_along_axis", lambda p: p.take_along_axis(
        _ones(p, [2, 2]), p.to_tensor(np.zeros(2, np.int64)), 0)),
    ("multi_dot", lambda p: p.ops.linalg.multi_dot(
        [_ones(p, [2, 3]), _ones(p, [4, 2])])),
    ("renorm", lambda p: p.renorm(_ones(p, [2, 2]), -1.0, 0, 1.0)),
]


@pytest.mark.parametrize("name,fn", ENFORCE, ids=[e[0] for e in ENFORCE])
def test_validator_message_equals_jax(name, fn):
    with pytest.raises(JaxEnforceError) as j:
        fn(paddle_tpu)
    with pytest.raises(EnforceError) as p:
        fn(P)
    assert str(p.value) == str(j.value)


def test_valid_calls_pass_the_validators():
    assert P.matmul(P.ones([2, 3]), P.ones([3, 4])).shape == [2, 4]
    assert P.concat([P.ones([1, 2]), P.ones([3, 2])], axis=0).shape == [4, 2]
    assert P.reshape(P.ones([2, 3]), [-1]).shape == [6]
    assert P.expand(P.ones([1, 3]), [4, 3]).shape == [4, 3]
    assert P.slice(P.ones([4, 4]), [0], [1], [3]).shape == [2, 4]


def test_an_impl_error_names_the_op_and_operands():
    with pytest.raises(TypeError) as e:
        P.ops.math.clip(P.ones([2]), min="a")
    assert "op 'clip' failed" in str(e.value)
    assert "float32[2]" in str(e.value)


# --------------------------------------------------------------- hooks

def _program(pkg):
    x = pkg.to_tensor(A)
    y = pkg.matmul(x, x.T)
    z = pkg.tanh(y + 1.0).sum(axis=1)
    return pkg.concat([z, pkg.exp(z)])


def test_prof_hook_spans_follow_the_jax_dispatch():
    seqs = []
    for pkg, hook in ((paddle_tpu, jax_prof_hook), (P, port_prof_hook)):
        names = []
        hook.enable(lambda n: names.append(n.decode()), lambda: None)
        try:
            _program(pkg)
        finally:
            hook.disable()
        seqs.append(names)
    assert seqs[1] == seqs[0]
    assert seqs[1][:2] == ["op::transpose_last2", "op::matmul"]


def test_prof_hook_begins_nothing_while_off():
    def boom(*_):
        raise AssertionError("span opened while the profiler is off")

    port_prof_hook.enable(boom, boom)
    port_prof_hook.disable()
    _program(P)


def test_profiler_records_op_spans():
    from paddle_tpu_torch import profiler
    p = profiler.Profiler(targets=[profiler.ProfilerTarget.CPU])
    p.start()
    _program(P)
    p.stop()
    names = [e[0] for e in p.result.events]
    assert "op::matmul" in names and "op::concat" in names


def test_amp_casts_per_op_name_match_the_jax_dispatch(monkeypatch):
    jamp = importlib.import_module("paddle_tpu.amp.auto_cast")
    from paddle_tpu_torch.ops import op_registry
    seen = {"jax": [], "port": []}
    jax_cast, port_cast = jamp.maybe_cast_args, op_registry.maybe_cast

    def jrec(name, leaves):
        out = jax_cast(name, leaves)
        seen["jax"].append((name, [np.dtype(getattr(o, "dtype", "O")).name
                                   for o in out if hasattr(o, "dtype")]))
        return out

    def prec(name, *tensors):
        out = port_cast(name, *tensors)
        seen["port"].append((name, [str(o.dtype).replace("torch.", "")
                                    for o in out]))
        return out

    monkeypatch.setattr(jamp, "maybe_cast_args", jrec)
    monkeypatch.setattr(op_registry, "maybe_cast", prec)
    outs = {}
    for key, pkg in (("jax", paddle_tpu), ("port", P)):
        with pkg.amp.auto_cast(level="O1", dtype="bfloat16"):
            x = pkg.to_tensor(A)
            y = pkg.matmul(x, x.T)              # white: bf16
            s = pkg.sum(y)                      # black: fp32
            e = pkg.einsum("ij,jk->ik", x, x.T)
            m = pkg.mean(pkg.exp(e))            # black
            a = y + 1.0                         # neither: as it comes
            outs[key] = [str(t.dtype).replace("torch.", "")
                         for t in (y, s, e, m, a)]
    assert len(seen["jax"]) >= 6
    assert seen["port"] == seen["jax"]
    assert outs["port"] == outs["jax"]
    assert outs["port"][:2] == ["bfloat16", "float32"]


def test_check_nan_inf_names_the_op():
    msgs = []
    for pkg in (paddle_tpu, P):
        pkg.set_flags({"check_nan_inf": True})
        try:
            with pytest.raises(FloatingPointError) as e:
                pkg.divide(pkg.to_tensor(np.array([1.0, 0.0], np.float32)),
                           pkg.to_tensor(np.zeros(2, np.float32)))
            msgs.append(str(e.value))
        finally:
            pkg.set_flags({"check_nan_inf": False})
    assert msgs[0] == msgs[1] and "'divide'" in msgs[1]


# ---------------------------------------------------- framework, device

def test_predicates_and_dtype_queries_match_jax():
    for pkg in (paddle_tpu, P):
        f, i = pkg.to_tensor(A), pkg.to_tensor(np.arange(3))
        assert pkg.is_tensor(f) and not pkg.is_tensor(A)
        assert pkg.is_floating_point(f) and not pkg.is_floating_point(i)
        assert pkg.is_integer(i) and not pkg.is_integer(f)
        assert not pkg.is_complex(f)
        assert f.is_floating_point() and i.is_integer()
        assert int(pkg.rank(f)) == 2 and not bool(pkg.is_empty(f))
        assert pkg.tolist(i) == [0, 1, 2]
    for d in ("int8", "int32", "uint8"):
        a, b = paddle_tpu.iinfo(d), P.iinfo(d)
        assert (a.min, a.max, a.bits, a.dtype) == (b.min, b.max, b.bits,
                                                   b.dtype)
    for d in ("float16", "bfloat16", "float32"):
        a, b = paddle_tpu.finfo(d), P.finfo(d)
        assert (a.min, a.max, a.eps, a.tiny, a.smallest_normal, a.bits,
                a.dtype) == (b.min, b.max, b.eps, b.tiny,
                             b.smallest_normal, b.bits, b.dtype)


def test_places_rng_state_and_wrappers():
    assert P.CPUPlace() == torch.device("cpu")
    assert P.CUDAPlace(1) == torch.device("cuda", 1)
    assert P.CUDAPinnedPlace() == torch.device("cpu")
    assert P.NPUPlace(0) == torch.device("cuda", 0)
    assert P.to_tensor(A, place=P.CPUPlace()).place == torch.device("cpu")
    P.randn([2])
    state = P.get_cuda_rng_state()
    a = P.randn([4]).numpy()
    P.set_cuda_rng_state(state)
    np.testing.assert_array_equal(P.randn([4]).numpy(), a)
    state = P.get_rng_state()
    b = P.rand([3]).numpy()
    P.set_rng_state(state)
    np.testing.assert_array_equal(P.rand([3]).numpy(), b)
    reader = P.batch(lambda: iter(range(5)), 2)
    jreader = paddle_tpu.batch(lambda: iter(range(5)), 2)
    assert list(reader()) == list(jreader()) == [[0, 1], [2, 3], [4]]
    assert list(P.batch(lambda: iter(range(5)), 2, drop_last=True)()) \
        == [[0, 1], [2, 3]]
    P.check_shape([2, -1])
    for bad in ([0], [-2]):
        with pytest.raises(ValueError) as e:
            P.check_shape(bad)
        with pytest.raises(ValueError) as je:
            paddle_tpu.check_shape(bad)
        assert str(e.value) == str(je.value)
    with P.LazyGuard():
        pass
    P.set_printoptions(precision=3)
    np.set_printoptions(precision=8)
    P.disable_signal_handler()


def test_dataparallel_delegates():
    lin = torch.nn.Linear(2, 2)
    dp = P.DataParallel(lin)
    x = torch.ones(1, 2)
    torch.testing.assert_close(dp(x), lin(x))
    assert dp.weight is lin.weight
    assert dp.scale_loss(3.0) == 3.0
    with dp.no_sync():
        pass
    dp.apply_collective_grads()
    assert dp.state_dict().keys() == lin.state_dict().keys()


def test_device_queries_on_the_cpu():
    from paddle_tpu_torch import device
    P.set_device("cpu")
    try:
        assert P.get_device() == "cpu"
        assert device.current_place() == torch.device("cpu")
        for fn in (device.memory_allocated, device.max_memory_allocated,
                   device.memory_reserved, device.max_memory_reserved,
                   device.reset_peak_memory_stats,
                   device.reset_max_memory_allocated,
                   device.reset_max_memory_reserved):
            assert fn() == 0
        assert device.memory_stats() == {}
        device.synchronize()
    finally:
        port_device._CURRENT = torch.device("cpu")
    assert device.device_count() == torch.cuda.device_count()
    assert not device.is_compiled_with_tpu()
    assert not device.is_compiled_with_xpu()
    assert device.is_compiled_with_rocm() == (torch.version.hip is not None)


def test_is_compiled_with_cuda_follows_torch_c20():
    """The JAX package answers False (its accelerator is a TPU); the
    port answers whether torch was built with CUDA (ROADMAP C20)."""
    from paddle_tpu import device as jdevice
    from paddle_tpu_torch import device
    assert jdevice.is_compiled_with_cuda() is False
    assert device.is_compiled_with_cuda() == torch.backends.cuda.is_built()
