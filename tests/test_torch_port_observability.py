"""The port's observability core, flags and enforce against the JAX
package's modules, call for call on the CPU.

Each test feeds the same calls, with a fixed ``now`` or clock wherever a
module takes one, through the JAX module and its port and compares what
comes out: registry snapshots and percentiles, the monitor's schema
(``DECLARED_METRICS``, ``METRIC_DOC``, every ``record_*`` signature and
what each records), flight-recorder dumps (timestamps aside), time-series
rates, goodput decompositions, SLO burn rates, states and transitions,
straggler detection, flags, enforce errors and messages, the profiler's
scheduler states and summary tables. No test depends on wall time.

The JAX package's registry is a process global other test files use too:
every test here clears it for itself and puts the process's metrics back
afterwards.
"""
import inspect
import json
import os

import numpy as np
import pytest
import torch

from paddle_tpu.core import enforce as jenforce
from paddle_tpu.core import flags as jflags
from paddle_tpu.core import flight_recorder as jfr
from paddle_tpu.core import goodput as jgoodput
from paddle_tpu.core import metrics as jmetrics
from paddle_tpu.core import monitor as jmonitor
from paddle_tpu.core import slo as jslo
from paddle_tpu.core import timeseries as jts
from paddle_tpu.profiler import profiler as jprofiler
from paddle_tpu.profiler import statistic as jstatistic
from paddle_tpu_torch.core import enforce, flags, flight_recorder, goodput
from paddle_tpu_torch.core import metrics, monitor, slo, timeseries
from paddle_tpu_torch.profiler import profiler, statistic

JAX = dict(metrics=jmetrics, monitor=jmonitor, fr=jfr, goodput=jgoodput,
           slo=jslo, ts=jts, flags=jflags, enforce=jenforce,
           profiler=jprofiler, statistic=jstatistic)
PORT = dict(metrics=metrics, monitor=monitor, fr=flight_recorder,
            goodput=goodput, slo=slo, ts=timeseries, flags=flags,
            enforce=enforce, profiler=profiler, statistic=statistic)


@pytest.fixture(autouse=True)
def clean_registries():
    """Both registries empty and off; the JAX process registry and both
    rings and watchtowers restored afterwards."""
    saved, was_on = jmetrics.all_metrics(), jmetrics.is_enabled()

    def clear():
        for m in (jmetrics, metrics):
            m.disable()
            while m.is_sampling():
                m.stop_sampling()
            with m._registry_lock:
                m._metrics.clear()
        for mod in (jts, timeseries, jslo, slo):
            mod._reset_for_tests()

    clear()
    try:
        yield
    finally:
        clear()
        with jmetrics._registry_lock:
            jmetrics._metrics.update(saved)
        if was_on:
            jmetrics.enable()


def _both(fn):
    """``fn(pkg)`` on the JAX modules, then on the port's."""
    return fn(JAX), fn(PORT)


# ------------------------------------------------------------- metrics

def _drive_registry(pkg):
    m = pkg["metrics"]
    m.enable()
    m.counter("t.c").inc()
    m.counter("t.c", op="x", axis="dp").inc(5)
    g = m.gauge("t.g")
    g.set(3)
    g.add(-1.5)
    g.set(7)
    g.set(2)
    h = m.histogram("t.h", bounds=(1, 2, 4, 8))
    for v in (0.5, 1.5, 3, 3, 9, 100, float("nan"), float("inf")):
        h.observe(v)
    hb = m.histogram("t.bytes")
    for v in (10, 300, 5000, 2 ** 20, 2 ** 31):
        hb.observe(v)
    m.histogram("t.empty", bounds=(1.0, 2.0))
    state0, full = m.snapshot_delta()
    m.disable()
    m.counter("t.c").inc(100)             # off: nothing records
    h.observe(1.0)
    m.enable()
    m.counter("t.c").inc(2)
    h.observe(1.2)
    state1, delta = m.snapshot_delta(state0)
    applied = m.apply_delta(json.loads(json.dumps(state0)), delta)
    pct = [h.percentile(q) for q in (-5, 0, 10, 50, 90, 99, 100, 150)]
    pct += [hb.percentile(q) for q in (50, 99)]
    pct += [m.histogram("t.empty").percentile(50)]
    return dict(snap=m.snapshot(), full=full, delta=delta,
                applied=applied, state1=state1, pct=pct,
                report=m.report(), report_t=m.report("t.h"),
                peak=g.peak, buckets=h.buckets(), raw=h.raw())


def test_registry_snapshots_deltas_and_percentiles_match():
    want, got = _both(_drive_registry)
    assert got == want
    assert want["applied"] == want["state1"]


def test_registry_sampling_matches():
    def run(pkg):
        m = pkg["metrics"]
        m.enable()
        m.start_sampling()
        m.start_sampling()               # nests
        for i in range(5):
            m.counter("s.c").inc(i)
            m.gauge("s.g").set(i * 0.5)
        inner = m.stop_sampling()
        still = m.is_sampling()
        m.counter("s.c").inc(7)
        outer = m.stop_sampling()
        values = lambda d: {k: [v for _, v in s] for k, s in d.items()}
        return values(inner), still, values(outer), m.is_sampling()

    want, got = _both(run)
    assert got == want and want[1] is True and want[3] is False


def test_metric_kind_conflict_raises_the_same_error():
    def run(pkg):
        m = pkg["metrics"]
        m.counter("k.x")
        with pytest.raises(TypeError) as ei:
            m.gauge("k.x")
        return str(ei.value)

    want, got = _both(run)
    assert got == want


# ------------------------------------------------------------- monitor

def test_declared_metrics_and_docs_equal_the_jax_schema():
    assert monitor.DECLARED_METRICS == jmonitor.DECLARED_METRICS
    assert monitor.METRIC_DOC == jmonitor.METRIC_DOC
    assert len(monitor.DECLARED_METRICS) == 90
    assert set(monitor.METRIC_DOC) == set(monitor.DECLARED_METRICS)
    assert flight_recorder.DECLARED_EVENTS == jfr.DECLARED_EVENTS
    assert flight_recorder.EVENT_DOC == jfr.EVENT_DOC


def _recorders(mod):
    return {n: f for n, f in vars(mod).items()
            if n.startswith("record_") and callable(f)}


def test_every_recorder_has_the_jax_signature():
    want, got = _recorders(jmonitor), _recorders(monitor)
    assert set(got) == set(want)
    for name in want:
        assert inspect.signature(got[name]) == \
            inspect.signature(want[name]), name


_ARG = {"str": "a", "int": 3, "float": 0.25, "bool": True,
        "BaseException": ValueError("boom")}
_UNTYPED = {"buckets": {"compute": 1.5, "idle": 0.5, "compile": 0.0},
            "step": 4, "target": "jit"}


def _args(fn):
    kw = {p.name: _UNTYPED.get(p.name, _ARG.get(p.annotation, 2))
          for p in inspect.signature(fn).parameters.values()}
    if "family" in kw:
        kw["family"] = "serve"
    return kw


def _call_every_recorder(pkg):
    mon = pkg["monitor"]
    mon.enable()
    for _, fn in sorted(_recorders(mon).items()):
        fn(**_args(fn))
        fn(**_args(fn))
    snap = pkg["metrics"].snapshot()
    mon.disable()
    for fn in _recorders(mon).values():   # off: every site a no-op
        fn(**_args(fn))
    return snap, pkg["metrics"].snapshot(), mon.report()


def test_every_recorder_records_what_the_jax_one_records():
    want, got = _both(_call_every_recorder)
    assert got == want
    assert want[0] == want[1]
    families = {k.split("{")[0] for k in want[0]}
    assert families <= monitor.DECLARED_METRICS
    assert len(families) > 60


def test_enable_disable_mirror_the_registry():
    for pkg in (JAX, PORT):
        pkg["metrics"].enable()
        assert pkg["monitor"].enabled is True
        pkg["monitor"].disable()
        assert pkg["metrics"].is_enabled() is False
        assert pkg["monitor"].enabled is False


def test_device_memory_sampling_needs_a_card():
    """The port reads the card's caching allocator; a process without a
    card has none, and the gauges stay unset (nothing is swallowed)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    monitor.enable()
    monitor.sample_device_memory()
    assert metrics.snapshot() == {}


# ------------------------------------------------------ flight recorder

def _drive_recorder(pkg):
    fr = pkg["fr"]
    rec = fr.FlightRecorder(capacity=6)
    for i in range(4):
        rec.record("serve.submit", t_ns=1_000 * (i + 1), req=i,
                   prompt_len=5 + i)
    rec.record_span("req1.prefill", 2_500, 4_000, trace_id="t.1",
                    tid=1001, req=1, bucket=16)
    rec.record_span("req2.decode", 9_000, 12_000, req=2)
    rec.record("serve.evict", t_ns=13_000, req=3, reason="deadline")
    spans = rec.spans_between(3_000, 10_000)
    d = rec.dump_dict("manual")
    meta = d["metadata"]
    for k in ("wall_time_ns", "anchor_wall_ns", "anchor_perf_ns"):
        meta.pop(k)
    # the tail's first field is a wall-clock stamp from the module's
    # own anchor
    d["tail"] = [line.split(" ", 1)[1] for line in d["tail"]]
    rec.clear()
    return d, spans, rec.events(), rec.capacity


def test_flight_recorder_dump_matches_apart_from_timestamps():
    want, got = _both(_drive_recorder)
    assert got == want
    d = want[0]
    assert d["metadata"]["dropped_events"] == 1
    assert [e["ph"] for e in d["traceEvents"]].count("X") == 2


def test_flight_recorder_dump_files_and_auto_dump(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_FLIGHT_RECORDER_DIR", str(tmp_path))

    def run(pkg):
        fr = pkg["fr"]
        rec = fr.FlightRecorder(capacity=8)
        rec.record("serve.crash", t_ns=5, error="x")
        path = rec.dump(str(tmp_path / pkg["fr"].__name__), reason="test")
        with open(path) as f:
            body = json.load(f)
        first = rec.auto_dump("serve_crash")
        second = rec.auto_dump("serve_crash")   # rate-limited
        return ([e["name"] for e in body["traceEvents"]], body["tail"][0]
                .split(" ", 1)[1], first is not None, second)

    want, got = _both(run)
    assert got == want and want[2] is True and want[3] is None


def test_flight_recorder_is_on_by_default_and_env_sized(monkeypatch):
    assert flight_recorder.DEFAULT_CAPACITY == jfr.DEFAULT_CAPACITY
    for raw in ("", "off", "0", "17", "junk"):
        monkeypatch.setenv("PADDLE_FLIGHT_RECORDER", raw)
        assert flight_recorder._env_capacity() == jfr._env_capacity(), raw


# ---------------------------------------------------- timeseries + slo

def _slo_stream(pkg):
    """A 150 s synthetic serving stream at one sample a second: TTFTs
    turn bad from t=40 to t=100, errors burst at t=60-70."""
    m, mon, ts, slo_mod = pkg["metrics"], pkg["monitor"], pkg["ts"], \
        pkg["slo"]
    m.enable()
    ring = ts.TimeSeriesRing(period_s=1.0, retention=400)
    ev = slo_mod.SLOEvaluator(ring, scope="process")
    trace = []
    for t in range(150):
        bad = 40 <= t < 100
        for i in range(4):
            mon.record_serve_ttft(0.9 if bad and i < 2 else 0.05)
            mon.record_serve_token_latency(0.01)
            mon.record_serve_request(
                "cancelled" if 60 <= t < 70 and i == 0 else "completed")
        mon.record_goodput("serve", {"compute": 0.6, "idle": 0.4}, 1.0)
        assert ring.maybe_sample(float(t))
        assert not ring.maybe_sample(t + 0.5)
        states = ev.evaluate(float(t))
        rep = ev.report()
        trace.append((states, [(s["name"], s["burn_fast"], s["burn_slow"])
                               for s in rep["slos"]],
                      ring.rate("serve.requests", 10.0),
                      ring.delta("serve.requests", 30.0),
                      ring.hist_percentile_over("serve.ttft", 99, 20.0),
                      ring.hist_fraction_above("serve.ttft", 0.5, 20.0)))
    hist = [{k: v for k, v in h.items()} for h in ev.history]
    snap = {k: v for k, v in m.snapshot().items() if k.startswith("slo.")}
    return trace, hist, snap, len(ring), ring.span()


def test_slo_burn_rates_states_and_transitions_match():
    want, got = _both(_slo_stream)
    assert got == want
    to = [h["to"] for h in want[1]]
    assert "firing" in to and "resolved" in to


def test_straggler_detector_matches():
    def run(pkg):
        det = pkg["slo"].StragglerDetector(z_threshold=3.0, min_ranks=3)
        out = []
        totals = {r: (0, 0.0) for r in range(4)}
        for t in range(12):
            slow = 4 <= t < 8
            totals = {r: (c + 10, s + 10 * (0.5 if r == 2 and slow
                                            else 0.1))
                      for r, (c, s) in totals.items()}
            out.append(det.observe(totals, now=float(t)))
            out.append(det.straggler_ranks())
        return out

    want, got = _both(run)
    assert got == want
    assert any(e and e[0]["phase"] == "detected" for e in want if
               isinstance(e, list) and e and isinstance(e[0], dict))


def test_default_slos_read_the_same_environment(monkeypatch):
    monkeypatch.setenv("PADDLE_SLO_TTFT_P99", "0.25")
    monkeypatch.setenv("PADDLE_SLO_ERROR_RATE", "off")
    want, got = _both(lambda pkg: [
        (s.name, s.kind, s.objective, s.window_s, s.fast_window_s)
        for s in pkg["slo"].default_slos()])
    assert got == want


# -------------------------------------------------------------- goodput

class _Clock:
    """A perf_counter the test moves by hand."""
    t = 0.0

    def perf_counter(self):
        return self.t


def _drive_goodput(pkg, monkeypatch):
    gp = pkg["goodput"]
    clock = _Clock()
    monkeypatch.setattr(gp, "time", clock)
    pkg["metrics"].enable()
    led = gp.GoodputLedger("serve", default_bucket="idle").start()
    led.charge("compute", 2.0)
    led.charge("compile", 0.5)
    led.charge("compute", -1.0)           # ignored
    clock.t = 5.0
    s1, f1 = led.snapshot(), led.flush()
    with led.timed("checkpoint"):
        clock.t = 6.25
    clock.t = 8.0
    with led:
        gp.charge("data_stall", 0.75)
        with gp.timed("preemption_recovery"):
            clock.t = 9.0
        inner = gp.active() is led
    clock.t = 10.0
    led.close()
    s2 = led.snapshot()
    led.close()                           # idempotent
    errors = []
    for bad in (lambda: gp.GoodputLedger("eval"),
                lambda: gp.GoodputLedger("train", default_bucket="x"),
                lambda: led.charge("nap", 1.0)):
        with pytest.raises(ValueError) as ei:
            bad()
        errors.append(str(ei.value))
    gp.charge("compute", 1.0)              # no ledger active: a no-op
    return (s1, f1, s2, inner, gp.active(), led.bucket_total("compute"),
            led.wall_s(), errors, pkg["metrics"].snapshot())


def test_goodput_decomposition_and_flushes_match(monkeypatch):
    want = _drive_goodput(JAX, monkeypatch)
    got = _drive_goodput(PORT, monkeypatch)
    assert got == want
    assert goodput.BUCKETS == jgoodput.BUCKETS
    s2 = want[2]
    assert sum(s2["buckets"].values()) == pytest.approx(s2["wall_s"])


# ---------------------------------------------------------------- flags

def test_flags_names_defaults_and_errors_match():
    assert set(flags._REGISTRY) == set(jflags._REGISTRY)
    for name, d in jflags._REGISTRY.items():
        p = flags._REGISTRY[name]
        assert (p.default, p.type, p.validator) == \
            (d.default, d.type, d.validator), name
    assert flags.get_flags() == jflags.get_flags()

    def errors(pkg):
        f = pkg["flags"]
        out = []
        for bad in ({"no_such_flag": 1}, {"FLAGS_nope": 1},
                    {"seed": "abc"}):
            with pytest.raises((KeyError, ValueError)) as ei:
                f.set_flags(bad)
            out.append((type(ei.value).__name__, str(ei.value)))
        with pytest.raises(KeyError) as ei:
            f.get_flag("nope")
        out.append(str(ei.value))
        return out

    want, got = _both(errors)
    assert got == want


def test_flags_set_get_and_environment_match(monkeypatch):
    saved = (dict(jflags._VALUES), dict(flags._VALUES))
    monkeypatch.setenv("FLAGS_log_level", "DEBUG")
    monkeypatch.setenv("FLAGS_eager_op_profile", "yes")
    try:
        for f in (jflags, flags):
            f._VALUES.clear()

        def run(pkg):
            f = pkg["flags"]
            f.set_flags({"FLAGS_seed": "7", "check_nan_inf": "on",
                         "default_dtype": "bfloat16"})
            return f.get_flags()

        want, got = _both(run)
        assert got == want
        assert want["seed"] == 7 and want["eager_op_profile"] is True
        assert want["log_level"] == "DEBUG"
    finally:
        for f, vals in zip((jflags, flags), saved):
            f._VALUES.clear()
            f._VALUES.update(vals)


# the JAX side of the NaN flag runs in a child process: jax_debug_nans
# is process-wide jax configuration, and a TrainStep another test file
# left compiled (or stored) in this worker would not be checked
_JAX_NAN_STEP = """
import json, numpy as np
import paddle_tpu as paddle
from paddle_tpu import nn, optimizer
from paddle_tpu.core import flags
from paddle_tpu.jit import TrainStep
paddle.seed(0)
m = nn.Linear(4, 2)
step = TrainStep(m, optimizer.SGD(0.1, parameters=m.parameters()),
                 lambda out, lab: (out * lab).sum() * float("nan"),
                 donate=False)
x, y = np.ones((3, 4), np.float32), np.ones((3, 2), np.float32)
off = bool(np.isnan(float(np.asarray(step(x, y)._data))))
flags.set_flags({"check_nan_inf_in_program": True})
try:
    step(x, y)
    raised = None
except FloatingPointError as e:
    raised = type(e).__name__
print(json.dumps({"off_nan": off, "raised": raised}))
"""


def test_nan_check_flag_raises_where_the_jax_flag_raises():
    """check_nan_inf_in_program: JAX's TrainStep raises
    FloatingPointError through jax_debug_nans (undonated, so its
    de-optimized rerun can read the inputs); the port's eager TrainStep
    raises it before the update, and leaves the parameters as they
    were."""
    import subprocess
    import sys
    from paddle_tpu_torch import optimizer as toptim
    from paddle_tpu_torch.jit import TrainStep

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=repo)
    env.pop("FLAGS_check_nan_inf_in_program", None)
    proc = subprocess.run([sys.executable, "-c", _JAX_NAN_STEP], cwd=repo,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    assert want == {"off_nan": True, "raised": "FloatingPointError"}

    x = np.ones((3, 4), np.float32)
    y = np.ones((3, 2), np.float32)
    tm = torch.nn.Linear(4, 2)
    tstep = TrainStep(tm, toptim.SGD(0.1, parameters=tm.parameters()),
                      lambda out, lab: (out * lab).sum() * float("nan"))
    before = tm.weight.detach().clone()
    # off: the step runs through (the update takes the NaN)
    assert torch.isnan(tstep(x, y))
    with torch.no_grad():
        tm.weight.copy_(before)
    flags.set_flags({"check_nan_inf_in_program": True})
    try:
        with pytest.raises(FloatingPointError, match="the loss"):
            tstep(x, y)
    finally:
        flags.set_flags({"check_nan_inf_in_program": False})
    assert torch.equal(tm.weight.detach(), before)
    assert flags.get_flag("check_nan_inf_in_program") is False


def test_nan_check_names_a_nonfinite_gradient():
    from paddle_tpu_torch import optimizer as toptim
    from paddle_tpu_torch.jit import TrainStep
    tm = torch.nn.Linear(4, 2)
    with torch.no_grad():
        tm.weight.zero_()
        tm.bias.zero_()
    # the loss is 0, but sqrt's slope at 0 is inf: 0 * inf gives the
    # weight's gradient nan
    step = TrainStep(tm, toptim.SGD(0.1, parameters=tm.parameters()),
                     lambda out, lab: (out.abs().sqrt() * 0.0).sum())
    flags.set_flags({"check_nan_inf_in_program": True})
    try:
        with pytest.raises(FloatingPointError, match="parameter 0"):
            step(np.ones((3, 4), np.float32), np.ones((3, 2), np.float32))
    finally:
        flags.set_flags({"check_nan_inf_in_program": False})


# -------------------------------------------------------------- enforce

def test_enforce_errors_and_messages_match():
    assert issubclass(enforce.EnforceError, ValueError)
    assert enforce.__all__ == jenforce.__all__

    def run(pkg):
        e = pkg["enforce"]
        out = []
        with pytest.raises(e.EnforceError) as ei:
            e.enforce(False, "matmul", "x.shape[-1] (3) != y.shape[0] (4)")
        out.append(str(ei.value))
        e.enforce(True, "matmul", "never")

        @e.infer_check("port_parity_op")
        def check(x, y):
            e.enforce(x.shape == y.shape, "port_parity_op",
                      f"shapes {x.shape} vs {y.shape}")

        a, b = np.zeros((2, 3), np.float32), np.zeros((3,), np.int32)
        with pytest.raises(e.EnforceError) as ei:
            e.run_check("port_parity_op", a, b)
        out.append(str(ei.value))
        e.run_check("port_parity_op", a)   # validator bug: swallowed
        e.run_check("no_such_op", a)
        out.append(e.get_check("port_parity_op") is check)
        leaves = [a, b, 2.5, "s"] + [a] * 6
        out.append(e.signature_of(leaves))
        for err in (ValueError("bad"), TypeError("t"), IndexError("i"),
                    RuntimeError("r")):
            new = e.augment_error(err, "conv2d", [a, b])
            out.append((type(new).__name__, str(new)))
        e._CHECKS.pop("port_parity_op")
        return out

    want, got = _both(run)
    assert got == want


# ------------------------------------------------------------- profiler

STATES = ("CLOSED", "READY", "RECORD", "RECORD_AND_RETURN")


def test_scheduler_state_sequences_match():
    import itertools
    assert [s.name for s in profiler.ProfilerState] == list(STATES)
    grid = itertools.product(range(3), range(3), range(1, 4), range(3),
                             range(3))
    for closed, ready, record, repeat, skip in grid:
        kw = dict(closed=closed, ready=ready, record=record, repeat=repeat,
                  skip_first=skip)
        want = [s.name for s in map(jprofiler.make_scheduler(**kw),
                                    range(40))]
        got = [s.name for s in map(profiler.make_scheduler(**kw),
                                   range(40))]
        assert got == want, kw

    def errors(pkg):
        p = pkg["profiler"]
        out = []
        for kw in (dict(closed=-1, ready=0, record=1),
                   dict(closed=0, ready=0, record=0)):
            with pytest.raises(ValueError) as ei:
                p.make_scheduler(**kw)
            out.append(str(ei.value))
        for sched in ((3, 1), (1.5, 4), "x"):
            with pytest.raises((ValueError, TypeError)) as ei:
                p.Profiler(scheduler=sched)
            out.append((type(ei.value).__name__, str(ei.value)))
        return out

    want, got = _both(errors)
    assert got == want


def _profile_on_cpu(pkg, path):
    """A (1, 4) window over 5 steps with RecordEvent spans, a counter
    that moves while recording, and a flight-recorder span inside the
    window; returns the exported trace and the summary tables."""
    p, fr = pkg["profiler"], pkg["fr"]
    fr.configure(capacity=fr.DEFAULT_CAPACITY, on=True)
    prof = p.Profiler(targets=[p.ProfilerTarget.CPU], scheduler=(1, 4),
                      trace_dir=os.path.dirname(path))
    prof.start()
    for step in range(5):
        with p.RecordEvent("train_step"):
            with p.RecordEvent("forward"):
                pkg["metrics"].counter("t.steps").inc()
        if step == 2:
            t = fr.now_ns()
            fr.record_span("req7.decode", t, t + 1000, tid=1007)
        prof.step()
    prof.stop()
    res = prof.result
    res.export_chrome_tracing(path)
    with open(path) as f:
        trace = json.load(f)["traceEvents"]
    spans = sorted(e["name"] for e in trace if e["ph"] == "X")
    counters = sorted({e["name"] for e in trace if e["ph"] == "C"})
    table = pkg["statistic"].summary_table(
        [(n, 0, 10, 1, 0) for n in spans])
    return spans, "t.steps" in counters, res.metrics_snapshot.get(
        "t.steps"), table, pkg["metrics"].is_enabled()


def test_cpu_profile_exports_host_spans_and_counter_tracks(tmp_path):
    want = _profile_on_cpu(JAX, str(tmp_path / "jax" / "trace.json"))
    got = _profile_on_cpu(PORT, str(tmp_path / "port" / "trace.json"))
    assert got == want
    spans = got[0]
    assert spans.count("train_step") == 3 and spans.count("forward") == 3
    assert "req7.decode" in spans and got[1] is True
    assert got[4] is False     # the window turned the registry back off


def test_summary_views_match():
    events = [("matmul", 0, 4_000_000, 1, 0), ("matmul", 5, 1_000_005, 1, 0),
              ("relu", 10, 500_010, 2, 0), ("all_reduce", 0, 250, 1, 0)]
    snap = {"comm.bytes{axis=dp,op=all_reduce}": {"kind": "counter",
                                                   "value": 4096},
            "device.memory.allocated": {"kind": "gauge", "value": 2.0e9,
                                        "peak": 3.0e9},
            "io.batch_bytes": {"kind": "histogram", "count": 2,
                               "sum": 64.0, "mean": 32.0, "buckets": {}}}

    def run(pkg):
        st = pkg["statistic"]
        out = [st.summary_table(events, sorted_by=k, time_unit=u)
               for k in [None] + list(st.SortedKeys)
               for u in ("ms", "us")]
        out.append(st.summary_report(events, snap))
        out += [st.view_table(v, events, snap)
                for v in ("OverView", "OperatorView", "MemoryView",
                          "DistributedView")]
        return out

    want, got = _both(run)
    assert got == want
    assert [k.name for k in statistic.SortedKeys] == \
        [k.name for k in jstatistic.SortedKeys]


def test_gpu_target_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="CUDA card"):
        profiler.Profiler(targets=[profiler.ProfilerTarget.GPU])
    # timer_only takes no trace, so it needs no card
    profiler.Profiler(targets=[profiler.ProfilerTarget.GPU],
                      timer_only=True)
    assert [t.name for t in profiler.ProfilerTarget] == ["CPU", "GPU"]


def test_profiler_result_round_trips(tmp_path):
    res = profiler.ProfilerResult(
        [("a", 0, 5, 1, 0)], None, {"t.c": [(1, 2.0)]}, {"t.c": {}},
        device_events=[{"name": "paddle_flash_decode", "ph": "X",
                        "cat": "kernel", "ts": 1.0, "dur": 2.0}])
    path = str(tmp_path / "r.pkl")
    profiler.export_protobuf(res, path)
    back = profiler.load_profiler_result(path)
    assert back.events == res.events
    assert back.device_events == res.device_events
    out = back.export_chrome_tracing(str(tmp_path / "t.json"))
    with open(out) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]]
    assert "paddle_flash_decode" in names and "a" in names
