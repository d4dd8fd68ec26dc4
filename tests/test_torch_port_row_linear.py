"""The row-invariant product of the cached forward
(``paddle_tpu_torch.kernels.row_linear``, ``csrc/row_gemm.cu``) and its
route, on the CPU.

``row_linear_plain`` must equal PyTorch's linear within fp32 rounding
(1e-5; bf16 within one bf16 ulp of the fp32 product, since both round
once). The kernel's launch geometry must come from K and N alone: the
split count is checked for its arguments and its values, the tile
constants against the CUDA source, the ctypes signature against the
``extern "C"`` entry. The route must be on only inside a cached forward:
off for the uncached forward and a training step, off again after an
exception inside one, off on other threads, and skipped while a
gradient is recorded. A cached test-tiny GPT forward calls the plain
version 2 x 4 + 1 times (its Linears and the tied head). Greedy streams
of ``generate`` (sequential and ngram-speculative), the serving engine
and the Predictor on the route must still equal JAX ``generate``'s on
test-tiny with the JAX weights carried across. The kernel itself is
held to the plain version, and for row invariance, in
``tests/test_torch_port_cuda.py``.
"""
import inspect
import os
import re
import threading

import numpy as np
import pytest
import torch
import torch.nn.functional as TF

import paddle_tpu as paddle
from paddle_tpu.generation import SpeculativeConfig as JaxSpeculativeConfig
from paddle_tpu.generation import generate as jax_generate
from paddle_tpu.models.gpt import gpt as jax_gpt
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.generation import SpeculativeConfig, generate
from paddle_tpu_torch.inference import precision
from paddle_tpu_torch.kernels import row_linear as rl
from paddle_tpu_torch.models.gpt import gpt
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers_common import Linear

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "paddle_tpu_torch", "csrc", "row_gemm.cu")
#: gpt2-small's five cached-forward products (K, N): qkv, out_proj, fc1,
#: fc2, the tied head
GPT2_SHAPES = ((768, 2304), (768, 768), (768, 3072), (3072, 768),
               (768, 50257))


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    jm = jax_gpt("test-tiny")
    jm.eval()
    tm = gpt("test-tiny", device="cpu")
    load_reference_state(tm, {k: np.asarray(v._data)
                              for k, v in jm.state_dict().items()})
    return jm, tm.eval()


# ------------------------------------------------------------ plain

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(5, 64, 96), (2, 3, 48, 37), (1, 8, 16)])
@pytest.mark.parametrize("bias", [True, False])
def test_plain_matches_linear(dtype, shape, bias):
    rng = np.random.RandomState(len(shape) + shape[-1])
    *lead, k, n = shape
    x = torch.as_tensor(rng.randn(*lead, k), dtype=dtype)
    w = torch.as_tensor(rng.randn(k, n) / np.sqrt(k), dtype=dtype)
    b = torch.as_tensor(rng.randn(n), dtype=dtype) if bias else None
    got = rl.row_linear(x, w, b)
    assert got.dtype == dtype and got.shape == (*lead, n)
    ref = x.double() @ w.double()
    if bias:
        ref = ref + b.double()
    if dtype == torch.float32:
        torch.testing.assert_close(got.double(), ref, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(got, TF.linear(x, w.t(), b), atol=1e-5,
                                   rtol=1e-5)
    else:
        # one rounding of the fp32 value: within one bf16 ulp of it
        assert ((got.double() - ref).abs()
                <= ref.abs() * 2.0 ** -8 + 1e-6).all()


def test_plain_takes_the_transposed_head_weight():
    rng = np.random.RandomState(1)
    x = torch.as_tensor(rng.randn(3, 16), dtype=torch.float32)
    wte = torch.as_tensor(rng.randn(40, 16), dtype=torch.float32)
    torch.testing.assert_close(rl.row_linear(x, wte.t()), x @ wte.t(),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("fault", ["dtype", "bias_dtype", "shape",
                                   "bias_shape", "int"])
def test_wrapper_refuses(fault):
    x = torch.zeros(2, 8)
    w = torch.zeros(8, 4)
    b = torch.zeros(4)
    err = TypeError
    if fault == "dtype":
        w = w.bfloat16()
    elif fault == "bias_dtype":
        b = b.double()
    elif fault == "shape":
        w, err = torch.zeros(6, 4), ValueError
    elif fault == "bias_shape":
        b, err = torch.zeros(5), ValueError
    else:
        x, w, b = x.long(), w.long(), b.long()
    with pytest.raises(err):
        rl.row_linear(x, w, b)


# ---------------------------------------------------------- geometry

def test_split_count_reads_only_k_and_n():
    assert list(inspect.signature(rl.split_count).parameters) == ["k", "n"]
    for k, n in GPT2_SHAPES:
        s = rl.split_count(k, n)
        slices = -(-k // rl.TILE_K)
        assert 1 <= s <= max(1, slices // rl.MIN_SLICES_PER_SPLIT)
    # the decode shapes fill the card: column tiles x splits >= 132 where
    # the contraction is long enough; the head needs no split
    assert rl.split_count(768, 50257) == 1
    assert [rl.split_count(k, n) for k, n in GPT2_SHAPES[:4]] == \
        [6, 6, 6, 22]
    assert rl.split_count(0, 768) == 1


def _constexpr(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_tile_constants_mirror_the_source():
    src = open(SRC).read()
    assert (_constexpr(src, "kBM"), _constexpr(src, "kBN"),
            _constexpr(src, "kBK")) == (rl.TILE_M, rl.TILE_N, rl.TILE_K)
    # every product the route sends has the tile's 16-deep steps
    assert rl.TILE_K % 16 == 0


def test_signature_matches_the_extern_c_entry():
    src = open(SRC).read()
    body = re.search(r"int paddle_row_gemm\(([^)]*)\)", src).group(1)
    params = [p.strip() for p in body.split(",")]
    argtypes = rl._SIG["paddle_row_gemm"][1]
    assert len(params) == len(argtypes) == 12
    for p, t in zip(params, argtypes):
        if "*" in p:
            assert t is rl._P, p
        else:
            assert t is rl._I, p


# ------------------------------------------------------------- route

def _counted(fn):
    rl.reset_counts()
    out = fn()
    return out, rl.row_linear_plain.calls


def test_route_is_on_only_inside_a_cached_forward(pair):
    _, tm = pair
    ids = torch.as_tensor(np.random.RandomState(2).randint(0, 512, (2, 9)))
    assert not rl.route_on()
    with torch.no_grad():
        _, calls = _counted(lambda: tm(ids))
        assert calls == 0
        (logits, cache), calls = _counted(
            lambda: tm(ids, use_cache=True, cache_max_len=32))
        assert calls == 2 * 4 + 1
        _, calls = _counted(lambda: tm(ids[:, :1], cache=cache))
        assert calls == 2 * 4 + 1
    assert not rl.route_on()
    # a training step keeps PyTorch's product
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.jit import TrainStep
    m = gpt("test-tiny", device="cpu")
    step = TrainStep(m, optimizer.AdamW(1e-3, parameters=m.parameters()),
                     lambda out, y: m.loss(out, y))
    _, calls = _counted(lambda: step(ids, ids))
    assert calls == 0


def test_route_turns_off_after_an_exception(pair, monkeypatch):
    _, tm = pair
    ids = torch.zeros((1, 4), dtype=torch.int64)
    seen = []

    def boom(*a, **k):
        seen.append(rl.route_on())
        raise RuntimeError("boom")
    monkeypatch.setattr(tm.gpt.blocks[1], "forward", boom)
    with torch.no_grad(), pytest.raises(RuntimeError, match="boom"):
        tm(ids, use_cache=True, cache_max_len=16)
    assert seen == [True]
    assert not rl.route_on()


def test_route_is_per_thread():
    seen = []
    with rl.cached_forward():
        t = threading.Thread(target=lambda: seen.append(rl.route_on()))
        t.start()
        t.join(timeout=30)
        with rl.cached_forward():
            assert rl.route_on()
        assert rl.route_on()
    assert seen == [False] and not rl.route_on()


def test_route_skips_products_that_record_a_gradient():
    lin = Linear(8, 4, device="cpu")
    x = torch.randn(2, 8)
    with rl.cached_forward():
        _, calls = _counted(lambda: lin(x))
        assert calls == 0           # lin.weight requires grad
        with torch.no_grad():
            _, calls = _counted(lambda: lin(x))
        assert calls == 1
        _, calls = _counted(lambda: F.linear(x, lin.weight.detach()))
        assert calls == 1


def test_weight_only_linear_follows_the_route():
    rng = np.random.RandomState(3)
    lin = Linear(16, 8, device="cpu", dtype=torch.bfloat16)
    q = torch.as_tensor(rng.randint(-127, 128, (16, 8)), dtype=torch.int8)
    scale = torch.as_tensor(rng.rand(8) / 127, dtype=torch.float32)
    layer = precision.WeightOnlyLinear(lin, q, scale, None,
                                       lin.bias.detach())
    x = torch.as_tensor(rng.randn(3, 16), dtype=torch.bfloat16)
    with torch.no_grad():
        ref, calls = _counted(lambda: layer(x))
        assert calls == 0
        with rl.cached_forward():
            got, calls = _counted(lambda: layer(x))
    assert calls == 1
    torch.testing.assert_close(got.float(), ref.float(), atol=0.05,
                               rtol=0.02)


# ----------------------------------------------------- streams vs JAX

def test_streams_on_the_route_equal_jax(pair):
    """Sequential and ngram-speculative generate, the dense engine and
    the Predictor's bucketed generate, all through the route, give the
    JAX package's greedy tokens."""
    jm, tm = pair
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.serving import RequestParams, ServingEngine
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 512, (2, 12))
    ref = np.asarray(jax_generate(jm, ids.astype(np.int32), 10)._data)
    rl.reset_counts()
    np.testing.assert_array_equal(generate(tm, ids, 10).numpy(), ref)
    assert rl.row_linear_plain.calls == 10 * (2 * 4 + 1)
    spec = np.asarray(jax_generate(
        jm, ids.astype(np.int32), 10,
        speculative=JaxSpeculativeConfig(k=2))._data)
    np.testing.assert_array_equal(spec, ref)
    np.testing.assert_array_equal(
        generate(tm, ids, 10, speculative=SpeculativeConfig(k=2)).numpy(),
        ref)
    cfg = (Config().from_layer(tm, None).disable_gpu()
           .enable_generation(max_new_tokens=10, prefill_buckets=(16,),
                              max_batch=2))
    engine = ServingEngine(cfg.enable_serving(max_queue=8))
    handles = engine.serve_forever(
        (p, RequestParams(max_new_tokens=10)) for p in ids)
    for h, r in zip(handles, ref):
        np.testing.assert_array_equal(h.tokens, r)
    pred = create_predictor(
        Config().from_layer(tm, None).disable_gpu()
        .enable_generation(max_new_tokens=10, prefill_buckets=(16,),
                           max_batch=2))
    got = pred.generate([p.tolist() for p in ids])
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(g), r)
