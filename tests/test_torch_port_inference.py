"""The port's Predictor, benchmark and int8/int4 weight serving against
the JAX package's, on the CPU.

``Predictor.run`` on the same converted weights: fp32 within 1e-5 of the
JAX Predictor's. An MLP in bf16 and the int8 precisions within one bf16
ulp of the element plus 1e-3 of the output's largest magnitude (both
round the same fp32 sums, taken in other orders, to bf16); test-tiny GPT,
which re-rounds its residual stream in every layer, within twice the
JAX bf16 run's own gap to fp32. Generation
mode on test-tiny with its matrices doubled (streams that vary): greedy
streams equal to the JAX Predictor's, token for token, over ragged
prompts with dummy rows, a chunked request list, eos truncation, a
smaller budget and ngram speculation; ``generate(live_rows=)``'s
``gen.tokens`` equal to the JAX count.

The weight-only engines (int8 and int4, dense, and paged with the int8
KV cache) and the int8 compute engine are held to the JAX engine itself:
it cannot be built in the pytest process (ROADMAP C1), so a child
process (``python tests/test_torch_port_inference.py --oracle OUT``)
builds it after giving ``jax.extend.core`` a dummy ``DropVar``, as
``tests/test_torch_port_serving_telemetry.py`` does, and writes its
token streams.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MAX_NEW = 8
BUCKETS = (16, 32)
MAX_BATCH = 2
#: the engines the child serves: enable_serving options, int8 compute
ENGINES = {
    "w8": dict(serving=dict(weight_bits=8)),
    "w4": dict(serving=dict(weight_bits=4)),
    "w4_paged_int8kv": dict(serving=dict(weight_bits=4, paged=True,
                                         kv_page_size=8,
                                         kv_cache_dtype="int8")),
    "int8_compute": dict(serving={}, int8_compute=True),
}
ENV_CLEARED = ("PADDLE_KV_CACHE_DTYPE", "PADDLE_KV_PAGE_SIZE",
               "PADDLE_PREFILL_CHUNK_TOKENS", "PADDLE_HBM_BUDGET",
               "PADDLE_TELEMETRY_PORT", "PADDLE_FLEET_STORE")
BF16_ULP = 2.0 ** -7     # one bf16 ulp of an element, at most
SCALED = 1e-3            # of the output's largest magnitude


def _traffic():
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 512, n) for n in (5, 12, 20, 7, 3, 31)]
    budgets = (8, 3, 6, 5, 8, 7)
    return prompts, budgets


def _double_matrices(state):
    """test-tiny with its non-embedding matrices doubled: streams that
    vary (random test-tiny repeats one token)."""
    return {k: (v * 2 if v.ndim == 2 and "wte" not in k else v)
            for k, v in state.items()}


def _engine_config(Config, model, name):
    opts = ENGINES[name]
    cfg = (Config().from_layer(model, None).disable_gpu()
           .enable_generation(max_new_tokens=MAX_NEW,
                              prefill_buckets=BUCKETS, max_batch=MAX_BATCH)
           .enable_serving(**opts["serving"]))
    cfg.precision = "int8"
    if opts.get("int8_compute"):
        cfg.enable_int8_compute()
    return cfg


def _serve(engine, request_params):
    prompts, budgets = _traffic()
    handles = [engine.submit(p.astype(np.int32),
                             request_params(max_new_tokens=b))
               for p, b in zip(prompts, budgets)]
    while engine.busy:
        engine.step()
    return [[int(t) for t in h.result(timeout=60)] for h in handles]


def _oracle(out_path: str):
    """The JAX engines (child process only: it patches jax)."""
    import jax.extend.core as jcore
    if not hasattr(jcore, "DropVar"):
        # analysis/memory.py imports DropVar, which this jax dropped;
        # the engine's memory planner never runs without an HBM budget
        jcore.DropVar = type("DropVar", (), {})
    import paddle_tpu as paddle
    from paddle_tpu.inference import Config
    from paddle_tpu.models.gpt import gpt
    from paddle_tpu.serving import RequestParams, ServingEngine
    paddle.seed(0)
    model = gpt("test-tiny")
    model.eval()
    state = _double_matrices({k: np.asarray(v._data)
                              for k, v in model.state_dict().items()})
    model.set_state_dict(state)
    np.savez(out_path + ".npz", **state)
    out = {}
    for name in ENGINES:
        eng = ServingEngine(_engine_config(Config, model, name),
                            poll_every=2, seed=0)
        out[name] = _serve(eng, RequestParams)
        eng.shutdown()
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--oracle"]:
        _oracle(sys.argv[2])
    sys.exit(0)


import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu.generation import SpeculativeConfig as JaxSpecConfig  # noqa: E402,E501
from paddle_tpu.generation import generate as jax_generate  # noqa: E402
from paddle_tpu.inference import Config as JaxConfig  # noqa: E402
from paddle_tpu.inference import create_predictor as jax_predictor  # noqa: E402,E501
from paddle_tpu.models.gpt import gpt as jax_gpt  # noqa: E402
from paddle_tpu_torch import nn as tnn  # noqa: E402
from paddle_tpu_torch.convert import load_reference_state  # noqa: E402
from paddle_tpu_torch.generation import SpeculativeConfig, generate  # noqa: E402,E501
from paddle_tpu_torch.inference import (Benchmark, Config,  # noqa: E402
                                        PrecisionType, create_predictor,
                                        device_time_per_run)
from paddle_tpu_torch.models.gpt import gpt  # noqa: E402


@pytest.fixture(scope="module")
def oracle_proc(tmp_path_factory):
    """The child starts with the module's first test and runs beside the
    in-process ones; the engine tests wait for it."""
    out = tmp_path_factory.mktemp("oracle") / "oracle.json"
    env = {k: v for k, v in os.environ.items() if k not in ENV_CLEARED}
    env.update(JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--oracle", str(out)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        yield proc, out
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def _start_oracle(oracle_proc):
    return oracle_proc


@pytest.fixture(scope="module")
def oracle(oracle_proc):
    proc, out = oracle_proc
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    with open(out) as f:
        got = json.load(f)
    with np.load(str(out) + ".npz") as w:
        got["weights"] = {k: w[k] for k in w.files}
    return got


def _state(jm):
    return {k: np.asarray(v._data) for k, v in jm.state_dict().items()}


@pytest.fixture(scope="module")
def varied():
    """(JAX, port) test-tiny with doubled matrices, same weights."""
    paddle.seed(0)
    jm = jax_gpt("test-tiny")
    jm.eval()
    state = _double_matrices(_state(jm))
    jm.set_state_dict(state)
    tm = gpt("test-tiny", device="cpu")
    load_reference_state(tm, state)
    return jm, tm.eval()


def _mlp_pair():
    paddle.seed(7)
    jm = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    jm.eval()
    tm = tnn.Sequential(tnn.Linear(8, 16, device="cpu"), tnn.ReLU(),
                        tnn.Linear(16, 4, device="cpu"))
    load_reference_state(tm, _state(jm))
    return jm, tm.eval()


def _jax_cfg(layer, x, precision, weight_bits=None, int8_compute=False):
    cfg = JaxConfig().from_layer(layer, input_spec=[paddle.to_tensor(x)])
    if precision != "float32":
        cfg.enable_tpu(precision)
    if weight_bits:
        cfg.enable_serving(weight_bits=weight_bits)
    if int8_compute:
        cfg.enable_int8_compute()
    return cfg


def _port_cfg(layer, x, precision, weight_bits=None, int8_compute=False):
    cfg = Config().from_layer(layer, input_spec=[x]) \
        .enable_use_gpu(precision).disable_gpu()
    if weight_bits:
        cfg.enable_serving(weight_bits=weight_bits)
    if int8_compute:
        cfg.enable_int8_compute()
    return cfg


RUN_CASES = [("float32", None, False), ("bfloat16", None, False),
             ("int8", 8, False), ("int8", 4, False), ("int8", None, True)]


@pytest.mark.parametrize("model", ["mlp", "gpt"])
@pytest.mark.parametrize("precision,weight_bits,int8_compute", RUN_CASES,
                         ids=["fp32", "bf16", "w8", "w4", "int8_compute"])
def test_predictor_run_matches_jax(varied, model, precision, weight_bits,
                                   int8_compute):
    if model == "mlp":
        jm, tm = _mlp_pair()
        x = np.random.RandomState(0).randn(3, 8).astype(np.float32)
    else:
        jm, tm = varied
        x = np.random.RandomState(0).randint(0, 512, (2, 12)) \
            .astype(np.int64)
    want = jax_predictor(_jax_cfg(jm, x, precision, weight_bits,
                                  int8_compute)).run([x])[0]
    want = np.asarray(want).astype(np.float32)
    got = create_predictor(_port_cfg(tm, x, precision, weight_bits,
                                     int8_compute)).run([x])[0]
    assert got.shape == want.shape and got.dtype == np.float32
    if precision == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    elif model == "mlp":
        tol = BF16_ULP * np.abs(want) + SCALED * np.abs(want).max()
        assert (np.abs(got - want) <= tol).all(), \
            float(np.abs(got - want).max())
    else:
        # GPT rounds its residual stream to bf16 in every layer and each
        # package rounds on its own: their gap is of the order of either
        # one's gap to fp32 (about 4e-3 on this model). Held within
        # twice the JAX bf16 run's largest gap to the JAX fp32 run. Int8
        # compute requantizes every Linear's input with a per-tensor
        # scale, which turns an ulp of difference into a step of the
        # int8 grid: held within twice the JAX int8 compute run's gap to
        # the JAX bf16 run (about 1.4e-2).
        base = _jax_cfg(jm, x, "bfloat16") if int8_compute \
            else _jax_cfg(jm, x, "float32")
        low = want if int8_compute else \
            jax_predictor(_jax_cfg(jm, x, "bfloat16")).run([x])[0]
        floor = np.abs(np.asarray(low).astype(np.float32) - np.asarray(
            jax_predictor(base).run([x])[0]).astype(np.float32)).max()
        assert 0 < floor < 0.05
        assert np.abs(got - want).max() <= 2 * floor, \
            (float(np.abs(got - want).max()), float(floor))


def test_bf16_output_is_widened_to_float32(varied):
    """ROADMAP C15: the JAX Predictor returns bf16 outputs as ml_dtypes
    bfloat16 arrays; the port returns the same bf16 values widened
    exactly to float32."""
    jm, tm = varied
    x = np.random.RandomState(1).randint(0, 512, (2, 9)).astype(np.int64)
    jout = jax_predictor(_jax_cfg(jm, x, "bfloat16")).run([x])[0]
    assert np.asarray(jout).dtype.name == "bfloat16"
    pred = create_predictor(_port_cfg(tm, x, "bfloat16"))
    out = pred.run([x])[0]
    assert out.dtype == np.float32
    served = pred._serving_params.layer
    with torch.no_grad():
        direct = served(torch.from_numpy(x))
    assert direct.dtype == torch.bfloat16
    np.testing.assert_array_equal(out, direct.float().numpy())
    h = pred.get_output_handle(pred.get_output_names()[0])
    np.testing.assert_array_equal(h.copy_to_cpu(), out)


def test_handles_clone_and_external_data():
    jm, tm = _mlp_pair()
    rng = np.random.RandomState(2)
    x1, x2 = (rng.randn(2, 8).astype(np.float32) for _ in range(2))
    pred = create_predictor(_port_cfg(tm, x1, "float32"))
    names = pred.get_input_names()
    assert names == ["x0"]
    h = pred.get_input_handle(names[0])
    assert h.shape is None
    h.copy_from_cpu(x1)
    assert h.shape == (2, 8)
    with pytest.raises(RuntimeError, match="run\\(\\) the predictor"):
        pred.get_output_names()
    assert pred.run() is True
    out_h = pred.get_output_handle(pred.get_output_names()[0])
    assert out_h.shape == (2, 4)
    ref1 = jm(paddle.to_tensor(x1)).numpy()
    np.testing.assert_allclose(out_h.copy_to_cpu(), ref1, rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(RuntimeError, match="output handle"):
        out_h.copy_from_cpu(x1)
    with pytest.raises(RuntimeError, match="input handle"):
        h.copy_to_cpu()
    # a torch tensor fed without a host copy
    h.share_external_data(torch.from_numpy(x2))
    pred.run()
    np.testing.assert_allclose(out_h.copy_to_cpu(),
                               jm(paddle.to_tensor(x2)).numpy(), rtol=1e-5,
                               atol=1e-5)
    # clones share the module, not the feeds or the fetches
    twin = pred.clone()
    with pytest.raises(RuntimeError, match="inputs not set"):
        twin.run()
    o1 = pred.run([x1])[0]
    o2 = twin.run([x2])[0]
    np.testing.assert_allclose(o1, ref1, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(o2, jm(paddle.to_tensor(x2)).numpy(),
                               rtol=1e-5, atol=1e-5)
    assert twin._serving_params.layer is pred._serving_params.layer
    assert pred._feeds["x0"].shape == (2, 8)


def test_predictor_errors(tmp_path, varied):
    _, tm = varied
    with pytest.raises(ValueError):
        create_predictor(Config())
    with pytest.raises(FileNotFoundError):
        create_predictor(Config(str(tmp_path / "nope")))
    (tmp_path / "m.pdmodel").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="A9"):
        create_predictor(Config(str(tmp_path / "m")))
    assert Config(str(tmp_path / "m")).model_dir() == str(tmp_path)
    pred = create_predictor(Config().from_layer(tm).disable_gpu())
    with pytest.raises(KeyError):
        pred.get_input_handle("bogus")
    with pytest.raises(RuntimeError, match="inputs not set"):
        pred.run()
    pred.run([np.zeros((1, 4), np.int64)])
    with pytest.raises(KeyError):
        pred.get_output_handle("bogus")
    for audit in (pred.audit_generation, pred.audit_forward):
        with pytest.raises(NotImplementedError, match="A12"):
            audit()
    with pytest.raises(RuntimeError, match="generation mode"):
        pred.generate([[1, 2, 3]])
    with pytest.raises(NotImplementedError, match="A9"):
        Config().set_compile_cache_dir(str(tmp_path / "cache"))
    with pytest.raises(NotImplementedError, match="A9"):
        Config().enable_compile_cache(str(tmp_path / "cache"))
    with pytest.raises(ValueError, match="weight_bits"):
        Config().enable_serving(weight_bits=3)
    with pytest.raises(ValueError, match="precision"):
        Config().enable_use_gpu("int3")
    # the reference's recorded knobs
    cfg = (Config().from_layer(tm).enable_memory_optim(False)
           .switch_ir_optim(False).set_cpu_math_library_num_threads(4)
           .enable_int8_compute())
    assert (cfg._memory_optim, cfg._ir_optim, cfg._math_threads,
            cfg._int8_compute) == (False, False, 4, True)
    assert "memory_optim=False" in cfg.summary()
    gcfg = Config().from_layer(tm).disable_gpu().enable_generation(
        max_new_tokens=6, prefill_buckets=(16,), max_batch=1)
    gp = create_predictor(gcfg)
    with pytest.raises(ValueError, match="bucket"):
        gp.generate([list(range(17))])
    with pytest.raises(ValueError, match="max_new_tokens"):
        gp.generate([[1, 2]], max_new_tokens=60)
    with pytest.raises(ValueError, match="empty prompt"):
        gp.generate([[]])
    with pytest.raises(ValueError, match="no prefill bucket"):
        create_predictor(Config().from_layer(tm).disable_gpu()
                         .enable_generation(max_new_tokens=6,
                                            prefill_buckets=(512,)))


# ----------------------------------------------------------- generation

def _gen_pair(varied, **gen):
    jm, tm = varied
    opts = dict(max_new_tokens=MAX_NEW, prefill_buckets=(16, 32, 512),
                max_batch=MAX_BATCH)
    opts.update(gen)
    jspec = opts.pop("jax_speculative", None)
    jc = JaxConfig().from_layer(
        jm, [paddle.to_tensor(np.zeros((1, 4), np.int32))])
    jc.enable_generation(**dict(opts, speculative=jspec))
    tc = Config().from_layer(tm).disable_gpu().enable_generation(**opts)
    return jax_predictor(jc), create_predictor(tc)


def _prompts():
    rng = np.random.RandomState(4)
    return [rng.randint(0, 512, n).tolist() for n in (5, 12, 30)]


@pytest.mark.parametrize("mode", ["greedy", "eos", "ngram"])
def test_generation_mode_matches_jax(varied, mode):
    """Three ragged prompts at max_batch 2: two chunks, the second with a
    dummy row; buckets past the position table dropped; the streams
    equal the JAX Predictor's, at the full and at a smaller budget."""
    gen = {}
    if mode == "eos":
        free = create_predictor(Config().from_layer(varied[1]).disable_gpu()
                                .enable_generation(max_new_tokens=MAX_NEW,
                                                   prefill_buckets=(16, 32),
                                                   max_batch=MAX_BATCH))
        gen["eos_token_id"] = int(free.generate(_prompts())[1][3])
    if mode == "ngram":
        gen["speculative"] = SpeculativeConfig(k=3, ngram=2)
        gen["jax_speculative"] = JaxSpecConfig(k=3, ngram=2)
    jp, tp = _gen_pair(varied, **gen)
    assert tp._gen_buckets == jp._gen_buckets == [16, 32]
    assert tp._gen_cache_lens == jp._gen_cache_lens
    prompts = _prompts()
    for budget in (5, None):
        want = jp.generate(prompts, max_new_tokens=budget)
        got = tp.generate(prompts, max_new_tokens=budget)
        assert [g.dtype for g in got] == [np.int32] * 3
        assert [g.tolist() for g in got] == [w.tolist() for w in want]
    if mode == "greedy":
        assert sum(len(set(g.tolist())) > 2 for g in got) >= 2
        # the Model-level greedy path on the same padded row
        ref = generate(varied[1], np.asarray(prompts[0])[None, :],
                       MAX_NEW, cache_max_len=tp._gen_cache_lens[16])
        np.testing.assert_array_equal(tp.generate(prompts[:1])[0],
                                      ref.numpy()[0])
    if mode == "eos":
        assert any(len(g) < MAX_NEW for g in want)
    if mode == "ngram":
        sess = tp._gen_session.speculative(tp._gen_spec)
        jsess = jp._gen_session.speculative(jp._gen_spec, None)
        for b, width in ((MAX_BATCH, 3), (MAX_BATCH, MAX_NEW),
                         (MAX_BATCH, MAX_NEW + 1), (1, 3)):
            for cl in tp._gen_cache_lens.values():
                assert sess.registered_buf_width(b, cl, tp._gen_cfg,
                                                 width) == \
                    jsess.registered_buf_width(b, cl, jp._gen_cfg, width)
        assert sess.registered_buf_width(MAX_BATCH, 128, tp._gen_cfg,
                                         3) == MAX_NEW


def _gen_tokens(metrics_mod):
    snap = metrics_mod.snapshot().get("gen.tokens")
    return int(snap["value"]) if snap else 0


@pytest.mark.parametrize("speculative", [False, True])
def test_generate_live_rows_counts_match_jax(varied, speculative):
    from paddle_tpu.core import monitor as jmon
    from paddle_tpu.profiler import metrics as jmet
    from paddle_tpu_torch.core import monitor as tmon
    from paddle_tpu_torch.profiler import metrics as tmet
    jm, tm = varied
    ids = np.random.RandomState(0).randint(0, 512, (3, 12))
    spec = (dict(speculative=SpeculativeConfig(k=2, ngram=2)),
            dict(speculative=JaxSpecConfig(k=2, ngram=2))) \
        if speculative else ({}, {})
    base = generate(tm, ids, 6).numpy()
    eos = int(base[0, 1])
    cases = [dict(live_rows=1), dict(live_rows=2, eos_token_id=eos,
                                     pad_token_id=499),
             dict(eos_token_id=eos), dict(live_rows=7)]
    got, want = [], []
    jmon.enable()
    tmon.enable()
    try:
        for kw in cases:
            t0, j0 = _gen_tokens(tmet), _gen_tokens(jmet)
            out = generate(tm, ids, 6, **kw, **spec[0]).numpy()
            jout = np.asarray(jax_generate(jm, ids.astype(np.int32), 6,
                                           **kw, **spec[1])._data)
            np.testing.assert_array_equal(out, jout)
            got.append(_gen_tokens(tmet) - t0)
            want.append(_gen_tokens(jmet) - j0)
    finally:
        jmon.disable()
        tmon.disable()
    assert got == want
    assert got[0] == 6 and got[3] == 18


# ------------------------------------------------------------ benchmark

def test_device_time_per_run_extraction():
    """The two-point slope is finite and >= 0 and leaves the outputs as
    they were; an all-integer feed (token ids) is timed too."""
    paddle.seed(0)
    jm = jnn.Sequential(jnn.Linear(64, 256), jnn.ReLU(), jnn.Linear(256, 10))
    jm.eval()
    tm = tnn.Sequential(tnn.Linear(64, 256, device="cpu"), tnn.ReLU(),
                        tnn.Linear(256, 10, device="cpu"))
    load_reference_state(tm, _state(jm))
    x1 = np.random.RandomState(0).randn(4, 64).astype(np.float32)
    pred = create_predictor(_port_cfg(tm.eval(), x1, "float32"))
    t = device_time_per_run(pred, [x1], iters=(4, 16), repeats=2)
    assert t >= 0.0 and np.isfinite(t)
    want = jm(paddle.to_tensor(x1)).numpy()
    np.testing.assert_allclose(pred.run([x1])[0], want, rtol=1e-5,
                               atol=1e-5)
    bm = Benchmark("mlp", batch_size=4)
    bm.measure(pred, [x1], iters=(4, 16), repeats=2)
    line = bm.report()
    assert "name=mlp" in line and "batch=4" in line
    assert bm.qps is None or bm.qps > 0
    with pytest.raises(ValueError, match="distinct"):
        device_time_per_run(pred, [x1], iters=(4, 4))
    ids = np.random.RandomState(1).randint(0, 512, (2, 8))
    gp = create_predictor(Config().from_layer(
        gpt("test-tiny", device="cpu").eval()).disable_gpu())
    before = gp.run([ids])[0]
    t = device_time_per_run(gp, [ids], iters=(2, 4), repeats=1)
    assert t >= 0.0 and np.isfinite(t)
    np.testing.assert_array_equal(gp.run([ids])[0], before)


# ------------------------------------------------ weight-only engines

@pytest.mark.parametrize("name", list(ENGINES))
def test_quantized_engine_matches_the_jax_engine(oracle, name):
    """Greedy streams of the int8 / int4 weight-only and int8 compute
    engines equal the JAX engine's on the same traffic; the weight-only
    streams also equal batch-1 ``generate`` on the engine's own served
    module."""
    from paddle_tpu_torch.serving import RequestParams, ServingEngine
    tm = gpt("test-tiny", device="cpu")
    load_reference_state(tm, oracle["weights"])
    eng = ServingEngine(_engine_config(Config, tm.eval(), name),
                        poll_every=2, seed=0)
    streams = _serve(eng, RequestParams)
    want = oracle[name]
    assert [len(s) for s in streams] == list(_traffic()[1])
    assert sum(len(set(s)) > 2 for s in want) >= 3
    kv = ENGINES[name]["serving"].get("kv_cache_dtype")
    if name == "int8_compute":
        # int8 compute requantizes each Linear's input with a scale over
        # the whole batch tensor, so an ulp of bf16 difference between
        # the packages can move a value across the int8 grid and flip a
        # later token (test-tiny's Predictor.run flips 1 of 24 argmaxes).
        # The prefill tokens are held equal and the streams mostly so.
        assert [s[0] for s in streams] == [w[0] for w in want]
        same = sum(a == b for s, w in zip(streams, want)
                   for a, b in zip(s, w))
        assert same >= 0.5 * sum(len(w) for w in want)
    else:
        assert streams == want
        prompts, budgets = _traffic()
        for p, b, s in zip(prompts, budgets, streams):
            bucket = next(bk for bk in eng.buckets if bk >= p.size)
            ids = np.zeros((1, bucket), np.int64)
            ids[0, :p.size] = p
            ref = generate(eng.network, ids, b, prompt_len=[p.size],
                           cache_max_len=eng.max_len, kv_cache_dtype=kv)
            assert ref.numpy()[0].tolist() == s
    assert eng.network is not tm
    assert all(p.dtype == torch.bfloat16 for p in eng.network.parameters())
    eng.shutdown()
