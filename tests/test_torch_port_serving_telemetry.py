"""The port's telemetry through ``generate`` and the ``ServingEngine``,
held to the JAX package's own engine and ``generate`` on test-tiny.

The JAX ``ServingEngine`` imports ``paddle_tpu.analysis.memory``, which
does not import under this jax (ROADMAP C3). So the JAX engines run in a
child process (``python tests/test_torch_port_serving_telemetry.py
--oracle OUT``) that first gives ``jax.extend.core`` a dummy ``DropVar``:
the dummy exists only in that child, never in the pytest process, where
ROADMAP C1's tests keep failing as they do. The child builds test-tiny
from seed 0, writes its parameters, serves one fixed traffic on the
dense, paged (with a shared prefix), chunked, int8 and ngram-speculative
engines with the registry on, and writes each engine's token streams,
``metrics.snapshot()``, ``stats`` and flight-recorder event counts.

The port builds the same model through ``convert.py``, serves the same
traffic on the CPU, and must give equal greedy token streams, equal
snapshot key sets (``jit.*`` aside: the eager port has no retraces),
every counter equal (``serve.goodput.seconds`` counts wall time: its
keys are compared, its values are times) and every histogram's count
equal. Times are never compared. The time-series ring samples once
(``PADDLE_TS_PERIOD_S`` set past the run) so the SLO families do not
depend on the run's speed.
"""
import json
import os
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the generation and serving setup both packages build
MAX_NEW = 8
BUCKETS = (16, 32)
MAX_BATCH = 2
POLL_EVERY = 2
SPEC_K, SPEC_NGRAM = 3, 2
ENGINES = {
    "dense": dict(),
    "paged": dict(serving=dict(paged=True, kv_page_size=8)),
    "chunked": dict(serving=dict(prefill_chunk_tokens=8)),
    "int8": dict(kv_cache_dtype="int8"),
    "spec": dict(speculative=True),
}
# environment both sides run under: one time-series sample per run, so
# no SLO burn rate depends on wall time; every request traced
ENV = {"PADDLE_TS_PERIOD_S": "3600", "PADDLE_TRACE_SAMPLE": "1"}
ENV_CLEARED = ("PADDLE_KV_CACHE_DTYPE", "PADDLE_KV_PAGE_SIZE",
               "PADDLE_PREFILL_CHUNK_TOKENS", "PADDLE_FLIGHT_RECORDER",
               "PADDLE_HBM_BUDGET", "PADDLE_TELEMETRY_PORT",
               "PADDLE_FLEET_STORE")
# environment values that are not digits: each is recorded as a swallow
BAD_ENV = {"PADDLE_KV_PAGE_SIZE": "big", "PADDLE_PREFILL_CHUNK_TOKENS": "x8",
           "PADDLE_TRACE_SAMPLE": "often"}
#: counters whose values are wall seconds (compared by key only)
TIME_COUNTERS = ("serve.goodput.seconds",)
#: the flight-recorder point events both engines record
EVENTS = ("serve.submit", "serve.admit", "serve.prefill_chunk",
          "serve.evict", "serve.finish")


def _looping_prompt(n=24):
    motif = np.array([11, 7, 42, 99, 3, 5], np.int64)
    return np.tile(motif, n // motif.size + 1)[:n]


def _traffic():
    """Ragged prompts and budgets: two share a 16-token prefix (two full
    8-token pages), one loops (real draft acceptances), several are
    longer than one 8-token chunk."""
    rng = np.random.RandomState(0)
    prefix = rng.randint(0, 512, 16)
    prompts = [rng.randint(0, 512, n) for n in (5, 12, 20, 7, 3, 31)]
    prompts += [np.r_[prefix, rng.randint(0, 512, 4)],
                np.r_[prefix, rng.randint(0, 512, 9)], _looping_prompt()]
    budgets = (8, 3, 6, 5, 8, 1, 8, 7, 8)
    return prompts, budgets


def _config(Config, spec_cls, model, engine):
    opts = ENGINES[engine]
    speculative = spec_cls(k=SPEC_K, ngram=SPEC_NGRAM) \
        if opts.get("speculative") else None
    cfg = (Config().from_layer(model, None).disable_gpu()
           .enable_generation(max_new_tokens=MAX_NEW,
                              prefill_buckets=BUCKETS, max_batch=MAX_BATCH,
                              speculative=speculative,
                              kv_cache_dtype=opts.get("kv_cache_dtype")))
    return cfg.enable_serving(**opts["serving"]) if "serving" in opts \
        else cfg


def _serve(engine, request_params):
    prompts, budgets = _traffic()
    handles = [engine.submit(p.astype(np.int32),
                             request_params(max_new_tokens=b))
               for p, b in zip(prompts, budgets)]
    while engine.busy:
        engine.step()
    return [[int(t) for t in h.result(timeout=60)] for h in handles]


def _event_counts(events):
    counts = Counter(kind for _, kind, _ in events if kind in EVENTS)
    return {k: counts[k] for k in EVENTS}


# ------------------------------------------------------------ the child

def _oracle(out_path: str):
    """Run the JAX engines (child process only: it patches jax)."""
    import jax.extend.core as jcore
    if not hasattr(jcore, "DropVar"):
        # analysis/memory.py imports DropVar, which this jax dropped;
        # the engine's memory planner never runs without an HBM budget
        jcore.DropVar = type("DropVar", (), {})
    import paddle_tpu as paddle
    from paddle_tpu.core import flight_recorder, metrics, monitor, slo
    from paddle_tpu.core import timeseries
    from paddle_tpu.generation.speculative import SpeculativeConfig
    from paddle_tpu.inference import Config
    from paddle_tpu.models.gpt import gpt
    from paddle_tpu.serving import RequestParams, ServingEngine

    def fresh():
        monitor.disable()
        with metrics._registry_lock:
            metrics._metrics.clear()
        timeseries._reset_for_tests()
        slo._reset_for_tests()
        flight_recorder.configure(capacity=flight_recorder.DEFAULT_CAPACITY,
                                  on=True)

    paddle.seed(0)
    model = gpt("test-tiny")
    model.eval()
    np.savez(out_path + ".npz", **{k: np.asarray(v._data)
                                   for k, v in model.state_dict().items()})
    out = {"engines": {}}
    for name in ENGINES:
        fresh()
        monitor.enable()
        eng = ServingEngine(_config(Config, SpeculativeConfig, model, name),
                            poll_every=POLL_EVERY, seed=0)
        streams = _serve(eng, RequestParams)
        out["engines"][name] = dict(
            streams=streams, snapshot=metrics.snapshot(),
            stats=dict(eng.stats),
            events=_event_counts(flight_recorder.events()))
        eng.shutdown()
    fresh()
    monitor.enable()
    os.environ.update(BAD_ENV)
    ServingEngine(_config(Config, SpeculativeConfig, model, "paged"),
                  poll_every=POLL_EVERY, seed=0).shutdown()
    out["swallowed"] = sorted(k for k in metrics.snapshot()
                              if k.startswith("errors.swallowed"))
    monitor.disable()
    with open(out_path, "w") as f:
        json.dump(out, f)


# ------------------------------------------------------------ the tests

@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    out = tmp_path_factory.mktemp("oracle") / "oracle.json"
    env = {k: v for k, v in os.environ.items() if k not in ENV_CLEARED}
    env.update(ENV, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--oracle", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out) as f:
        got = json.load(f)
    with np.load(str(out) + ".npz") as w:
        got["weights"] = {k: w[k] for k in w.files}
    return got


@pytest.fixture(scope="module")
def model(oracle):
    from paddle_tpu_torch.convert import load_reference_state
    from paddle_tpu_torch.models.gpt import gpt
    m = gpt("test-tiny", device="cpu")
    load_reference_state(m, oracle["weights"])
    return m.eval()


@pytest.fixture
def port_telemetry(monkeypatch):
    """A clean port registry, ring, watchtower and recorder, under the
    child's environment; the monitor is off again afterwards."""
    from paddle_tpu_torch.core import (flight_recorder, metrics, monitor,
                                       slo, timeseries)
    for k in ENV_CLEARED:
        monkeypatch.delenv(k, raising=False)
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)

    def fresh():
        monitor.disable()
        metrics._reset_for_tests()
        timeseries._reset_for_tests()
        slo._reset_for_tests()
        flight_recorder.configure(capacity=flight_recorder.DEFAULT_CAPACITY,
                                  on=True)

    fresh()
    try:
        yield monitor
    finally:
        fresh()


def _port_engine(model, name, **kw):
    from paddle_tpu_torch.generation import SpeculativeConfig
    from paddle_tpu_torch.inference import Config
    from paddle_tpu_torch.serving import ServingEngine
    return ServingEngine(_config(Config, SpeculativeConfig, model, name),
                         poll_every=POLL_EVERY, seed=0, **kw)


def _compare_snapshots(got, want):
    """Equal key sets (jit.* aside), counters, histogram counts."""
    keys = lambda snap: {k for k in snap if not k.startswith("jit.")}
    assert keys(got) == keys(want), (sorted(keys(got) - keys(want)),
                                     sorted(keys(want) - keys(got)))
    for k in keys(want):
        w, g = want[k], got[k]
        assert g["kind"] == w["kind"], k
        if w["kind"] == "counter" and not k.startswith(TIME_COUNTERS):
            assert g["value"] == w["value"], (k, g["value"], w["value"])
        elif w["kind"] == "histogram":
            assert g["count"] == w["count"], (k, g["count"], w["count"])


@pytest.mark.parametrize("name", list(ENGINES))
def test_engine_matches_the_jax_engine(oracle, model, port_telemetry, name):
    from paddle_tpu_torch.core import flight_recorder, metrics
    from paddle_tpu_torch.serving import RequestParams
    want = oracle["engines"][name]
    port_telemetry.enable()
    eng = _port_engine(model, name)
    streams = _serve(eng, RequestParams)
    snap = metrics.snapshot()
    assert streams == want["streams"]
    _compare_snapshots(snap, want["snapshot"])
    assert dict(eng.stats) == want["stats"]
    assert _event_counts(flight_recorder.events()) == want["events"]
    # the registry agrees with the handles and the engine's own stats
    n_tokens = sum(len(s) for s in streams)
    assert snap["gen.tokens"]["value"] == n_tokens
    assert snap["gen.decode_steps"]["value"] == eng.stats["decode_steps"]
    assert snap["serve.requests{status=completed}"]["value"] == \
        len(streams)
    assert snap["serve.ttft"]["count"] == len(streams)
    if name == "spec":
        assert snap["gen.spec.proposed"]["value"] == \
            eng.stats["spec_proposed"] > 0
        assert snap["gen.spec.accepted"]["value"] == \
            eng.stats["spec_accepted"] > 0
    if name == "paged":
        assert snap["gen.cache.pages_allocated"]["value"] > 0
        assert snap["serve.cache.prefix_hits"]["value"] >= 1
    if name == "int8":
        assert "serve.cache.kv_dtype{dtype=int8}" in snap
        assert snap["gen.cache.quant.bytes_saved"]["value"] > 0


def test_request_spans_reach_the_flight_recorder(model, port_telemetry):
    """Every request traced (PADDLE_TRACE_SAMPLE=1): queue-wait, prefill
    and decode spans per request, each inside the engine's lifetime."""
    from paddle_tpu_torch.core import flight_recorder
    from paddle_tpu_torch.serving import RequestParams
    eng = _port_engine(model, "chunked")
    assert eng.trace_sample == 1
    t0 = flight_recorder.now_ns()
    streams = _serve(eng, RequestParams)
    spans = flight_recorder.spans_between(t0, flight_recorder.now_ns())
    names = Counter(name.split(".", 1)[1] for name, *_ in spans)
    assert names["queue_wait"] == len(streams)
    assert names["prefill"] + names["prefill_chunk"] >= len(streams)
    assert names["decode"] >= 1
    assert all(t0 <= s <= e for _, s, e, _, _ in spans)


def test_environment_swallows_are_recorded_as_the_jax_engine(
        oracle, model, port_telemetry, monkeypatch):
    for k, v in BAD_ENV.items():
        monkeypatch.setenv(k, v)
    from paddle_tpu_torch.core import metrics
    port_telemetry.enable()
    eng = _port_engine(model, "paged")
    assert eng.trace_sample == 8 and eng.page_size == 8
    assert eng.prefill_chunk_tokens is None
    got = sorted(k for k in metrics.snapshot()
                 if k.startswith("errors.swallowed"))
    assert got == oracle["swallowed"]
    assert got == ["errors.swallowed{where=serving.kv_page_size}",
                   "errors.swallowed{where=serving.prefill_chunk_tokens}",
                   "errors.swallowed{where=serving.trace_sample}"]


def test_kv_cache_dtype_swallow_matches_jax(port_telemetry, monkeypatch):
    from paddle_tpu.generation.kv_cache import \
        resolve_cache_dtype as jax_resolve
    from paddle_tpu_torch.core import metrics
    from paddle_tpu_torch.generation.kv_cache import resolve_cache_dtype
    monkeypatch.setenv("PADDLE_KV_CACHE_DTYPE", "int3")
    port_telemetry.enable()
    resolved, want = _jax_metrics_run(jax_resolve)
    assert resolved is None and resolve_cache_dtype() is None
    got = metrics.snapshot()
    key = "errors.swallowed{where=generation.kv_cache_dtype}"
    assert got == want and got[key]["value"] == 1


def test_registry_off_costs_no_metric(model, port_telemetry):
    """With the monitor off the engine creates no metric at all, and
    its streams equal the ones served with it on."""
    from paddle_tpu_torch.core import metrics
    from paddle_tpu_torch.serving import RequestParams
    off = _serve(_port_engine(model, "spec"), RequestParams)
    assert metrics.snapshot() == {}
    port_telemetry.enable()
    on = _serve(_port_engine(model, "spec"), RequestParams)
    assert on == off and metrics.snapshot()


def test_pytest_process_never_loads_the_memory_planner():
    """The DropVar dummy lives only in the oracle's child: here the JAX
    package's memory planner still cannot import (ROADMAP C1, C3)."""
    import jax.extend.core as jcore
    assert "paddle_tpu.analysis.memory" not in sys.modules
    assert not hasattr(jcore, "DropVar")


@pytest.mark.chaos
def test_fail_admission_cancels_and_serves_on(model, port_telemetry):
    from paddle_tpu_torch.core import flight_recorder, metrics
    from paddle_tpu_torch.serving import RequestParams, RequestStatus
    from paddle_tpu_torch.utils.fault_injection import fail_admission
    port_telemetry.enable()
    eng = _port_engine(model, "dense")
    prompts, budgets = _traffic()
    with fail_admission(eng, n=2) as fa:
        hs = [eng.submit(p, RequestParams(max_new_tokens=b))
              for p, b in zip(prompts, budgets)]
        while eng.busy:
            eng.step()
    assert fa.triggered == 2
    cancelled = [h for h in hs if h.status is RequestStatus.CANCELLED]
    assert [h.id for h in cancelled] == [hs[0].id, hs[1].id]
    assert all(h.detail.startswith("admission error: RuntimeError")
               for h in cancelled)
    assert all(h.status is RequestStatus.COMPLETED for h in hs[2:])
    snap = metrics.snapshot()
    assert snap["errors.swallowed{where=serving.admit}"]["value"] == 2
    assert snap["serve.cancellations{reason=error}"]["value"] == 2
    assert snap["serve.requests{status=completed}"]["value"] == len(hs) - 2
    assert eng.stats["cancelled"] == 2
    d = flight_recorder.dump_dict("test")
    assert any("admission error" in line for line in d["tail"])


# ------------------------------------------------------------- generate

def _jax_metrics_run(fn):
    """Run ``fn`` with a clean, enabled JAX registry; restore the
    process's registry afterwards. Returns (fn's result, snapshot)."""
    from paddle_tpu.core import metrics as jmetrics
    saved, was_on = jmetrics.all_metrics(), jmetrics.is_enabled()
    with jmetrics._registry_lock:
        jmetrics._metrics.clear()
    jmetrics.enable()
    try:
        out = fn()
        return out, jmetrics.snapshot()
    finally:
        (jmetrics.enable if was_on else jmetrics.disable)()
        with jmetrics._registry_lock:
            jmetrics._metrics.clear()
            jmetrics._metrics.update(saved)


@pytest.fixture(scope="module")
def pair():
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt import gpt as jax_gpt
    from paddle_tpu_torch.convert import load_reference_state
    from paddle_tpu_torch.models.gpt import gpt
    paddle.seed(0)
    jm = jax_gpt("test-tiny")
    jm.eval()
    tm = gpt("test-tiny", device="cpu")
    load_reference_state(
        tm, {k: np.asarray(v._data) for k, v in jm.state_dict().items()})
    return jm, tm.eval()


GENERATE_CASES = {
    "sequential": dict(),
    "sequential_eos": dict(eos=True),
    "int8": dict(kv_cache_dtype="int8"),
    "ngram": dict(speculative=True),
    "ngram_eos": dict(speculative=True, eos=True),
}


@pytest.mark.parametrize("case", list(GENERATE_CASES))
def test_generate_matches_jax_generate(pair, port_telemetry, case):
    from paddle_tpu.generation import generate as jax_generate
    from paddle_tpu.generation.speculative import \
        SpeculativeConfig as JaxSpec
    from paddle_tpu_torch.core import metrics
    from paddle_tpu_torch.generation import SpeculativeConfig, generate
    jm, tm = pair
    opts = GENERATE_CASES[case]
    ids = np.stack([_looping_prompt(12),
                    np.random.RandomState(1).randint(0, 512, 12)])
    kw = dict(prompt_len=np.array([12, 9]), max_new_tokens=10,
              kv_cache_dtype=opts.get("kv_cache_dtype"))

    def jax_run():
        return np.asarray(jax_generate(
            jm, ids.astype(np.int32), eos_token_id=eos,
            speculative=JaxSpec(k=SPEC_K, ngram=SPEC_NGRAM)
            if opts.get("speculative") else None, **kw)._data)

    eos = None
    if opts.get("eos"):
        # an eos the streams really emit: the second row's third token
        eos = int(_jax_metrics_run(jax_run)[0][1, 2])
    want, want_snap = _jax_metrics_run(jax_run)
    port_telemetry.enable()
    got = generate(tm, torch.as_tensor(ids), eos_token_id=eos,
                   speculative=SpeculativeConfig(k=SPEC_K, ngram=SPEC_NGRAM)
                   if opts.get("speculative") else None, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    _compare_snapshots(metrics.snapshot(), want_snap)
    snap = metrics.snapshot()
    assert snap["gen.prefill_steps"]["value"] == 1
    if opts.get("speculative"):
        assert snap["gen.spec.proposed"]["value"] > 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--oracle"]:
        _oracle(sys.argv[2])
