"""The row-invariant product of the cached forward
(``paddle_tpu_torch.kernels.row_linear``, ``csrc/row_gemm.cu``) and its
route, on the CPU.

``row_linear_plain`` must equal PyTorch's linear within fp32 rounding
(1e-5; bf16 within one bf16 ulp of the fp32 product, since both round
once). The kernel's launch choices must come from K, N, the dtype and
W's layout and alignment alone: the route, tile and split functions are
checked for their arguments and for their values at gpt2-small's,
ERNIE-base's and BERT-large's products, the tile constants against the
CUDA source, the ctypes signature against the ``extern "C"`` entry; the
wrapper's launch (with the C entry replaced by a recorder) allocates y
and nothing else, and copies an unaligned view of x rather than route
it elsewhere. The route must be on only inside a cached forward:
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

#: ERNIE-base's cached-forward products (its head is tied, as GPT's) and
#: BERT-large's
ERNIE_BASE_SHAPES = ((768, 2304), (768, 768), (768, 3072), (3072, 768),
                     (768, 40000))
BERT_LARGE_SHAPES = ((1024, 3072), (1024, 1024), (1024, 4096),
                     (4096, 1024), (1024, 30522))


def test_split_count_reads_only_k_and_n():
    """The split (the cluster's blocks) reads K, N and the route, and the
    route reads K, N, the dtype and W's layout and alignment: never M."""
    assert list(inspect.signature(rl.split_count).parameters) == \
        ["k", "n", "route"]
    for route in ("wgmma", "fma"):
        _, _, tk = rl.tile(route)
        for k, n in GPT2_SHAPES + BERT_LARGE_SHAPES:
            s = rl.split_count(k, n, route)
            slices = -(-k // tk)
            assert 1 <= s <= rl.MAX_SPLITS and s & (s - 1) == 0
            assert s == 1 or s * rl.MIN_SLICES[route] <= slices
    # the per-layer shapes split 4 or 8 ways, the head not at all
    assert [rl.split_count(k, n, "wgmma") for k, n in GPT2_SHAPES] == \
        [4, 4, 4, 8, 1]
    assert [rl.split_count(k, n, "fma") for k, n in GPT2_SHAPES] == \
        [4, 4, 4, 8, 1]
    assert rl.split_count(0, 768, "fma") == 1


@pytest.mark.parametrize("fn", ["route", "tile", "split_count", "plan"])
def test_launch_choices_take_no_row_count(fn):
    """Every launch-choosing function takes K, N, the dtype, W's layout
    and alignment (or the route those choose), and nothing of x."""
    allowed = {"k", "n", "dtype", "w_nk", "w_aligned", "route"}
    params = set(inspect.signature(getattr(rl, fn)).parameters)
    assert params <= allowed, params


def _expected_plan(k, n, dtype):
    """(route, splits, blocks of one row tile) from the tiles' sizes"""
    route = "wgmma" if dtype != torch.float32 else "fma"
    _, tn, _ = rl.tile(route)
    s = rl.split_count(k, n, route)
    return route, s, -(-n // tn) * s


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("model,k,n,splits", [
    *[("gpt2-small", k, n, s) for (k, n), s in
      zip(GPT2_SHAPES, (4, 4, 4, 8, 1))],
    *[("ernie-3.0-base", k, n, s) for (k, n), s in
      zip(ERNIE_BASE_SHAPES, (4, 4, 4, 8, 1))],
    *[("bert-large", k, n, s) for (k, n), s in
      zip(BERT_LARGE_SHAPES, (4, 4, 4, 8, 1))]])
def test_plan_at_model_shapes(model, k, n, splits, dtype):
    """The plan of each cached-forward product of gpt2-small, ERNIE-base
    and BERT-large: bf16 and fp16 on the warpgroup route with a 64 x 128
    tile, fp32 on the CUDA-core tile, the head ([N, K], tied) unsplit
    (its column tiles alone fill the card)."""
    head = n > 10000
    p = rl.plan(k, n, dtype, head, True)
    route, s, blocks = _expected_plan(k, n, dtype)
    assert (p.route, p.splits) == (route, s)
    assert p.tile == ((64, 128, 64) if route == "wgmma" else (64, 64, 32))
    if dtype == torch.float32:
        assert p.splits in (1, 4, 8)
    else:
        assert p.splits == splits
    assert p.code == (rl._DTYPE_CODES[dtype] | head << 2
                      | (route == "wgmma") << 3 | p.splits << 8)
    assert blocks >= rl.TARGET_BLOCKS or not head


@pytest.mark.parametrize("k,n,w_nk,w_aligned,route", [
    (768, 2304, False, True, "wgmma"), (768, 50257, True, True, "wgmma"),
    (200, 328, False, True, "wgmma"),      # ragged to the box: TMA fills
    (60, 37, False, True, "fma"),          # K not a multiple of 8
    (64, 37, False, True, "fma"),          # N of [K, N] not one
    (64, 37, True, True, "wgmma"),         # [N, K]: only K's rows matter
    (768, 2304, False, False, "fma"),      # W not 16-byte aligned
    (0, 16, False, True, "fma")])
def test_route_from_k_n_layout_and_alignment(k, n, w_nk, w_aligned, route):
    for dtype in (torch.bfloat16, torch.float16):
        assert rl.route(k, n, dtype, w_nk, w_aligned) == route
    assert rl.route(k, n, torch.float32, w_nk, w_aligned) == "fma"


def _fake_entry(monkeypatch):
    """The C entry replaced by a recorder (the CPU has no card), and every
    allocation the launch makes counted."""
    from paddle_tpu_torch.kernels import _build
    calls, allocs = [], []
    lib = type("Lib", (), {"paddle_row_gemm": staticmethod(
        lambda *a: calls.append(a) or 0)})
    monkeypatch.setitem(_build._LIBS, "row_gemm", lib)
    for owner, name in ((torch.Tensor, "new_empty"), (torch, "empty"),
                        (torch, "zeros"), (torch.Tensor, "new_zeros")):
        real = getattr(owner, name)

        def counted(*a, _real=real, **k):
            out = _real(*a, **k)
            allocs.append(tuple(out.shape))
            return out
        monkeypatch.setattr(owner, name, counted)
    return calls, allocs


@pytest.mark.parametrize("k,n,head", [(768, 2304, False), (3072, 768, False),
                                      (768, 50257, True)])
def test_wrapper_allocates_no_partial_buffer(monkeypatch, k, n, head):
    """The launch allocates y and nothing else, whatever the split (it
    fits a cluster): no fp32 partials in device memory, and one call of
    the entry with x, W, b, y, M, N, K, the plan's code and the stream."""
    calls, allocs = _fake_entry(monkeypatch)
    x = torch.zeros((2, 4, k), dtype=torch.bfloat16)
    w = torch.zeros((n, k), dtype=torch.bfloat16).t() if head else \
        torch.zeros((k, n), dtype=torch.bfloat16)
    b = None if head else torch.zeros(n, dtype=torch.bfloat16)
    allocs.clear()
    rl.reset_counts()
    y = rl._launch(x, w, b, 1234)
    p = rl.plan_for(w)
    assert p.splits > 1 or head
    assert allocs == [(2, 4, n)] and tuple(y.shape) == (2, 4, n)
    assert len(calls) == 1 and rl.row_linear.launches == 1
    xp, wp, bp, yp, m, nn, kk, code, stream = calls[0]
    assert (xp, wp, yp) == (x.data_ptr(), w.data_ptr(), y.data_ptr())
    assert bp == (None if b is None else b.data_ptr())
    assert (m, nn, kk, code, stream) == (8, n, k, p.code, 1234)


def test_unaligned_view_is_copied_not_rerouted(monkeypatch):
    """A view of x at an address TMA cannot take is copied into fresh,
    aligned memory (``aligned_rows``, the wrapper's decision) and the
    launch keeps the layer's one plan; an aligned view is used as it is."""
    flat = torch.arange(9 * 64 + 1, dtype=torch.bfloat16)
    view = flat[1:].view(9, 64)
    assert view.data_ptr() % 16
    got = rl.aligned_rows(view)
    assert got.data_ptr() % 16 == 0 and got.is_contiguous()
    assert torch.equal(got, view) and got.data_ptr() != view.data_ptr()
    aligned = flat[8:8 + 64 * 8].view(8, 64)
    assert aligned.data_ptr() % 16 == 0
    assert rl.aligned_rows(aligned) is aligned
    strided = torch.zeros((9, 128), dtype=torch.bfloat16)[:, ::2]
    assert rl.aligned_rows(strided).is_contiguous()
    calls, _ = _fake_entry(monkeypatch)
    w = torch.zeros((64, 256), dtype=torch.bfloat16)
    rl._launch(view, w, None, 0)
    rl._launch(view.clone(), w, None, 0)
    assert calls[0][0] % 16 == 0 and calls[0][0] != view.data_ptr()
    assert calls[0][4:8] == calls[1][4:8] == (9, 256, 64, rl.plan_for(w).code)


def _constexpr(src, name):
    return int(re.search(rf"\b{name} = (\d+)[;,]", src).group(1))


def test_tile_constants_mirror_the_source():
    src = open(SRC).read()
    assert (_constexpr(src, "kBM"), _constexpr(src, "kBN"),
            _constexpr(src, "kBK")) == (rl.WG_TILE_M, rl.WG_TILE_N,
                                        rl.WG_TILE_K)
    assert (_constexpr(src, "kFM"), _constexpr(src, "kFN"),
            _constexpr(src, "kFK")) == (rl.FMA_TILE_M, rl.FMA_TILE_N,
                                        rl.FMA_TILE_K)
    assert _constexpr(src, "kMaxSplits") == rl.MAX_SPLITS
    # every product the route sends has the tile's 16-deep steps, and a
    # cluster's ranks split a tile's columns into float4 groups
    assert rl.WG_TILE_K % 16 == 0 and rl.FMA_TILE_K % 16 == 0
    assert min(rl.WG_TILE_N, rl.FMA_TILE_N) // rl.MAX_SPLITS % 4 == 0


def test_one_kernel_a_product_in_the_source():
    """The source folds the splits in a cluster: no second kernel, no
    device atomics, no device-memory partials."""
    src = open(SRC).read()
    code = re.sub(r"//[^\n]*", "", src)
    assert len(re.findall(r"__global__", code)) == 2   # one per route
    assert not re.search(r"\batomic[A-Z]|\batom\.|\bred\.", code)
    assert "combine" not in code and "part[" not in code


def test_signature_matches_the_extern_c_entry():
    src = open(SRC).read()
    body = re.search(r"int paddle_row_gemm\(([^)]*)\)", src).group(1)
    params = [p.strip() for p in body.split(",")]
    argtypes = rl._SIG["paddle_row_gemm"][1]
    assert len(params) == len(argtypes) == 9
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
