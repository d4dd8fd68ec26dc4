"""The port's fleet router (``serving/router.py``) on test-tiny: the
circuit-breaker state machine, health-scored admission over live
engines, zero-drop drain re-homing, bounded re-routes, deadline
propagation, the ``serve.router.*`` metrics and events, the
``PADDLE_ROUTER_*`` knobs, the ``/router`` endpoint, rolling deploys
(inline and in thread mode) and the chaos faults (admission failures,
wedged replicas, SIGTERM mid-stream).

The JAX ``FleetRouter`` is the oracle for placement: a child process
(``python tests/test_torch_port_router.py --oracle OUT``, with the same
dummy ``DropVar`` as ``test_torch_port_serving_ops.py``, confined to
it) routes fixed traffic over two inline-pumped JAX replicas, a dense
and a paged one, through saturation and a drain of one replica, and
writes each request's placement, hops and end, the router's ``stats``
and its ``describe()`` documents (scores included). The port's router
over the port's engines must write equal ones. The sequential
reference elsewhere is the port's batch-1 ``generate``.
"""
import json
import os
import random
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MAX_NEW = 8
BUCKETS = (16, 32)
#: the oracle fleet: replica name -> enable_serving options
FLEET = {"a": dict(max_queue=2),
         "b": dict(max_queue=2, paged=True, kv_page_size=8)}
ENV_CLEARED = ("PADDLE_KV_CACHE_DTYPE", "PADDLE_KV_PAGE_SIZE",
               "PADDLE_PREFILL_CHUNK_TOKENS", "PADDLE_FLIGHT_RECORDER",
               "PADDLE_HBM_BUDGET", "PADDLE_TELEMETRY_PORT",
               "PADDLE_FLEET_STORE", "PADDLE_TRACE_SAMPLE",
               "PADDLE_ROUTER_MAX_REROUTES",
               "PADDLE_ROUTER_BREAKER_THRESHOLD",
               "PADDLE_ROUTER_BREAKER_BASE_S", "PADDLE_ROUTER_BREAKER_CAP_S")


def _prompts(n=8, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 512, k).astype(np.int32)
            for k in (5, 12, 20, 9, 7, 30, 14, 11)[:n]]


def _config(Config, model, *, max_batch=2, buckets=BUCKETS, **serving):
    cfg = (Config().from_layer(model, None)
           .enable_generation(max_new_tokens=MAX_NEW,
                              prefill_buckets=buckets, max_batch=max_batch))
    cfg.disable_gpu()
    return cfg.enable_serving(**serving)


def _router_run(router, engines, QueueFull, RequestFailed):
    """Fixed traffic through one router (both packages): five submits
    (the fleet saturates), one step of each replica, three more submits
    (the last queues on "a", whose lanes are full), a drain of replica
    "a", then every handle awaited (inline pumping, re-homing the
    drained queue onto "b")."""
    P = _prompts()
    placed, rejected, describes, handles = [], [], [], []

    def submit(p):
        try:
            h = router.submit(p)
        except QueueFull as e:
            rejected.append(e.reason)
            placed.append(None)
            return
        handles.append(h)
        placed.append(h.replica)

    for p in P[:5]:
        submit(p)
    describes.append(router.describe())
    for name in sorted(engines):
        engines[name].step()
    describes.append(router.describe())
    for p in P[5:]:
        submit(p)
    describes.append(router.describe())
    router.drain_replica("a")
    describes.append(router.describe())
    ends = []
    for h in handles:
        try:
            toks = [int(t) for t in h.result(timeout=120)]
            end = [h.status.value, toks]
        except RequestFailed as e:
            end = [e.status.value, e.detail]
        ends.append([h.replica, [list(x) for x in h.hops], h.reroutes]
                    + end)
    describes.append(router.describe())
    return dict(placed=placed, rejected=rejected, describes=describes,
                ends=ends, stats=router.stats)


# ------------------------------------------------------------ the child

def _oracle(out_path: str):
    """Route the fixed traffic over JAX replicas (child process only: it
    patches jax)."""
    import jax.extend.core as jcore
    if not hasattr(jcore, "DropVar"):
        # analysis/memory.py imports DropVar, which this jax dropped;
        # the engine's memory planner never runs without an HBM budget
        jcore.DropVar = type("DropVar", (), {})
    import paddle_tpu as paddle
    from paddle_tpu.inference import Config
    from paddle_tpu.models.gpt import gpt
    from paddle_tpu.serving import (FleetRouter, QueueFull, RequestFailed,
                                    ServingEngine)

    paddle.seed(0)
    model = gpt("test-tiny")
    model.eval()
    np.savez(out_path + ".npz", **{k: np.asarray(v._data)
                                   for k, v in model.state_dict().items()})
    engines = {name: ServingEngine(_config(Config, model, **opts),
                                   poll_every=1, seed=0)
               for name, opts in FLEET.items()}
    router = FleetRouter(engines, seed=0)
    out = _router_run(router, engines, QueueFull, RequestFailed)
    for e in engines.values():
        e.shutdown()
    with open(out_path, "w") as f:
        json.dump(out, f)


# ------------------------------------------------------------ fixtures

@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    out = tmp_path_factory.mktemp("router_oracle") / "oracle.json"
    env = {k: v for k, v in os.environ.items() if k not in ENV_CLEARED}
    env.update(JAX_PLATFORMS="cpu",
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


@pytest.fixture(scope="module")
def reference(model):
    from paddle_tpu_torch.generation import generate
    memo = {}

    def ref(p):
        key = tuple(int(t) for t in p)
        if key not in memo:
            memo[key] = generate(model, np.asarray(key)[None, :],
                                 MAX_NEW).numpy()[0]
        return memo[key]

    return ref


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    from paddle_tpu_torch.core import flight_recorder, metrics, monitor
    for k in ENV_CLEARED:
        monkeypatch.delenv(k, raising=False)

    def fresh():
        monitor.disable()
        metrics._reset_for_tests()
        flight_recorder.configure(capacity=flight_recorder.DEFAULT_CAPACITY,
                                  on=True)

    fresh()
    yield
    fresh()


def _engine(model, *, start=False, **kw):
    """The reference tests' replica: batch 1, bucket 16, queue 4."""
    from paddle_tpu_torch.inference import Config
    from paddle_tpu_torch.serving import ServingEngine
    kw.setdefault("max_batch", 1)
    kw.setdefault("buckets", (16,))
    kw.setdefault("max_queue", 4)
    drain = kw.pop("drain_timeout_s", None)
    eng = ServingEngine(_config(Config, model, **kw), poll_every=1,
                        drain_timeout_s=drain)
    return eng.start() if start else eng


def _counter(name):
    from paddle_tpu_torch.core import metrics
    snap = metrics.snapshot().get(name)
    return int(snap["value"]) if snap else 0


def _shutdown(router, engines):
    router.shutdown()
    for e in engines:
        e.shutdown()


# -------------------------------------------------- held to the JAX router

def test_placements_stats_and_describe_match_the_jax_router(oracle, model):
    from paddle_tpu_torch.inference import Config
    from paddle_tpu_torch.serving import (FleetRouter, QueueFull,
                                          RequestFailed, ServingEngine)
    engines = {name: ServingEngine(_config(Config, model, **opts),
                                   poll_every=1, seed=0)
               for name, opts in FLEET.items()}
    router = FleetRouter(engines, seed=0)
    try:
        got = _router_run(router, engines, QueueFull, RequestFailed)
    finally:
        _shutdown(router, engines.values())
    want = {k: v for k, v in oracle.items() if k != "weights"}
    assert got["placed"] == want["placed"]
    assert got["rejected"] == want["rejected"]
    assert got["ends"] == want["ends"]
    assert got["stats"] == want["stats"]
    assert len(got["describes"]) == len(want["describes"])
    for g, w in zip(got["describes"], want["describes"]):
        assert g == w
    # the traffic covers what it is meant to: both replicas, the
    # saturation, the drain's re-homing
    assert {"a", "b"} <= set(want["placed"]) and None in want["placed"]
    assert want["stats"]["rehomed"] >= 1
    engines["b"]._alloc.assert_conserved()


# --------------------------------------------- breaker state machine

class TestCircuitBreaker:
    def _mk(self, **kw):
        from paddle_tpu_torch.serving import CircuitBreaker
        self.now = [0.0]
        kw.setdefault("rng", random.Random(7))
        return CircuitBreaker(clock=lambda: self.now[0], **kw)

    def test_opens_at_threshold_only_on_consecutive(self):
        from paddle_tpu_torch.serving.router import BREAKER_OPEN
        b = self._mk(threshold=3)
        assert b.record_failure() is None
        assert b.record_failure() is None
        assert b.record_success() is False     # streak broken
        assert b.failures == 0
        assert b.record_failure() is None
        assert b.record_failure() is None
        assert b.record_failure() is not None
        assert b.state == BREAKER_OPEN and not b.admissible()

    def test_backoff_full_jitter_bounds(self):
        base, cap = 0.05, 2.0
        draws = []
        for seed in range(40):
            b = self._mk(threshold=1, base_s=base, cap_s=cap,
                         rng=random.Random(seed))
            for trips in range(8):
                bound = min(cap, base * (2 ** trips))
                assert b.backoff_bound() == pytest.approx(bound)
                back = b.record_failure()
                assert 0.0 <= back < bound
                draws.append(back)
                self.now[0] = b.open_until
                assert b.admissible()
                b.begin()
        assert len(set(draws)) > 20

    def test_half_open_admits_exactly_one_probe(self):
        from paddle_tpu_torch.serving.router import (BREAKER_CLOSED,
                                                     BREAKER_HALF_OPEN,
                                                     BREAKER_OPEN)
        b = self._mk(threshold=1, base_s=0.5, cap_s=0.5)
        b.record_failure()
        assert b.state == BREAKER_OPEN and not b.admissible()
        self.now[0] = b.open_until + 0.001
        assert b.admissible() and b.state == BREAKER_HALF_OPEN
        b.begin()
        assert not b.admissible()
        assert b.record_success() is True
        assert b.state == BREAKER_CLOSED and b.trips == 0
        assert b.admissible()

    def test_probe_failure_reopens_with_longer_bound(self):
        from paddle_tpu_torch.serving.router import BREAKER_OPEN
        b = self._mk(threshold=2, base_s=0.1, cap_s=10.0)
        b.record_failure(), b.record_failure()
        assert b.state == BREAKER_OPEN and b.trips == 1
        self.now[0] = b.open_until
        assert b.admissible()
        b.begin()
        assert b.record_failure() is not None
        assert b.state == BREAKER_OPEN and b.trips == 2
        assert b.backoff_bound() == pytest.approx(0.4)

    def test_threshold_validated(self):
        from paddle_tpu_torch.serving import CircuitBreaker
        with pytest.raises(ValueError, match="threshold"):
            CircuitBreaker(threshold=0)

    def test_matches_the_jax_breaker_draw_for_draw(self):
        """The same seed and clock give the same states, backoffs and
        bounds as the JAX package's CircuitBreaker."""
        from paddle_tpu.serving import CircuitBreaker as JaxBreaker
        from paddle_tpu_torch.serving import CircuitBreaker
        trace = []
        for cls in (JaxBreaker, CircuitBreaker):
            now = [0.0]
            b = cls(threshold=2, base_s=0.1, cap_s=1.0,
                    rng=random.Random(11), clock=lambda: now[0])
            seen = []
            for i in range(12):
                if i % 3 == 2:
                    now[0] = b.open_until + 0.01
                    seen.append(("adm", b.admissible(), b.state))
                    b.begin()
                seen.append(("fail", b.record_failure(), b.state,
                             b.trips, b.backoff_bound()))
            seen.append(("ok", b.record_success(), b.state))
            trace.append(seen)
        assert trace[0] == trace[1]


# ----------------------------------------------------- knobs, scoring

def test_env_knobs(model, monkeypatch):
    from paddle_tpu_torch.core import metrics, monitor
    from paddle_tpu_torch.serving import FleetRouter
    eng = _engine(model)
    monitor.enable()
    monkeypatch.setenv("PADDLE_ROUTER_MAX_REROUTES", "5")
    monkeypatch.setenv("PADDLE_ROUTER_BREAKER_THRESHOLD", "not-a-number")
    monkeypatch.setenv("PADDLE_ROUTER_BREAKER_BASE_S", "0.25")
    monkeypatch.setenv("PADDLE_ROUTER_BREAKER_CAP_S", "9")
    r = FleetRouter([eng])
    assert r.max_reroutes == 5
    assert r.breaker_threshold == 3        # garbage -> default, recorded
    assert r.breaker_base_s == 0.25 and r.breaker_cap_s == 9.0
    assert "errors.swallowed{where=serving.router.env}" in \
        metrics.snapshot()
    r2 = FleetRouter([eng], max_reroutes=1, breaker_base_s=0.5)
    assert r2.max_reroutes == 1 and r2.breaker_base_s == 0.5
    assert list(r2.engines()) == ["r0"]
    with pytest.raises(ValueError, match="at least one"):
        FleetRouter({})
    with pytest.raises(ValueError, match="already in rotation"):
        r2.add_replica("r0", eng)
    eng.shutdown()


def test_score_matches_the_jax_score():
    from paddle_tpu.serving import FleetRouter as JaxRouter
    from paddle_tpu_torch.serving import FleetRouter
    base = {"ready": True, "free_tokens": 100, "queue_depth": 2}
    docs = [base, dict(base, prefill_chunks_queued=6),
            dict(base, queue_depth=8), dict(base, prefill_chunks_queued=0),
            dict(base, ready=False, prefill_chunks_queued=6), {}]
    assert [FleetRouter._score(d) for d in docs] == \
        [JaxRouter._score(d) for d in docs]
    # the HBM-headroom factor waits for the memory planner (A12): the
    # port's health() emits neither key, and the score ignores them
    for headroom in (250, -5):
        assert FleetRouter._score(dict(
            base, hbm_budget=1000, predicted_headroom_bytes=headroom)) == \
            FleetRouter._score(base)
    busy = dict(base, prefill_chunks_queued=6)
    assert FleetRouter._score(busy) < FleetRouter._score(base)
    assert FleetRouter._score(busy) == \
        FleetRouter._score(dict(base, queue_depth=8))


# ------------------------------------------------- routing over engines

def test_routes_complete_bitwise(model, reference):
    from paddle_tpu_torch.serving import FleetRouter, RequestStatus
    from paddle_tpu_torch.core import monitor
    engines = {"a": _engine(model), "b": _engine(model)}
    router = FleetRouter(engines, seed=0)
    monitor.enable()
    try:
        rng = np.random.RandomState(2)
        prompts = [rng.randint(0, 512, 3 + i).astype(np.int32)
                   for i in range(4)]
        handles = [router.submit(p) for p in prompts]
        assert {h.replica for h in handles} == {"a", "b"}
        for h, p in zip(handles, prompts):
            np.testing.assert_array_equal(h.result(timeout=120),
                                          reference(p))
            assert h.status is RequestStatus.COMPLETED and h.done()
            assert h.tokens is not None and h.ttft is not None
        assert router.stats["admissions"] == 4
        assert router.stats["reroutes"] == 0
        assert _counter("serve.router.admissions") == 4
        assert _counter("serve.router.admissions{replica=a}") > 0
        assert _counter("serve.router.admissions{replica=b}") > 0
    finally:
        _shutdown(router, engines.values())


def test_drain_rehomes_queued_work(model, reference):
    from paddle_tpu_torch.core import flight_recorder
    from paddle_tpu_torch.serving import FleetRouter
    engines = {"a": _engine(model, max_queue=8),
               "b": _engine(model, max_queue=8)}
    router = FleetRouter(engines, seed=0)
    try:
        rng = np.random.RandomState(3)
        prompts = [rng.randint(0, 512, 4 + i).astype(np.int32)
                   for i in range(4)]
        handles = [router.submit(p) for p in prompts]
        victim = "a" if any(h.replica == "a" for h in handles) else "b"
        doomed = [h for h in handles if h.replica == victim]
        assert doomed
        router.drain_replica(victim)
        for h, p in zip(handles, prompts):
            np.testing.assert_array_equal(h.result(timeout=120),
                                          reference(p))
        survivor = "b" if victim == "a" else "a"
        for h in doomed:
            assert h.replica == survivor
            assert h.hops and h.hops[-1] == (victim, "shutdown")
        assert router.stats["rehomed"] == len(doomed)
        kinds = [(k, f) for _, k, f in flight_recorder.events()
                 if k.startswith("serve.router.")]
        assert any(k == "serve.router.drain" and f["replica"] == victim
                   for k, f in kinds)
        reroutes = [f for k, f in kinds if k == "serve.router.reroute"]
        assert len(reroutes) == len(doomed)
        assert all(f["src"] == victim and f["dst"] == survivor
                   and f["reason"] == "shutdown" for f in reroutes)
    finally:
        _shutdown(router, engines.values())


def test_all_replicas_saturated_rejects(model):
    from paddle_tpu_torch.core import monitor
    from paddle_tpu_torch.serving import (FleetRouter, QueueFull,
                                          RequestFailed, RequestStatus)
    eng = _engine(model, max_queue=1)
    router = FleetRouter({"only": eng}, seed=0)
    monitor.enable()
    try:
        first = router.submit([1, 2, 3])       # queue now at its bound
        with pytest.raises(QueueFull) as ei:
            router.submit([4, 5])
        rr = ei.value.request
        assert rr is not None and rr.done()
        assert rr.status is RequestStatus.REJECTED
        assert rr.detail == "no_admissible_replica"
        with pytest.raises(RequestFailed):
            rr.result(timeout=1)
        assert router.stats["rejected"] == 1
        assert _counter("serve.router.rejected") == 1
        assert first.result(timeout=120).size == MAX_NEW
    finally:
        _shutdown(router, [eng])


def test_reroute_budget_bounds_rehoming(model):
    from paddle_tpu_torch.serving import FleetRouter, RequestFailed
    engines = {"a": _engine(model), "b": _engine(model)}
    router = FleetRouter(engines, max_reroutes=0, seed=0)
    try:
        h = router.submit([1, 2, 3])
        router.drain_replica(h.replica)
        with pytest.raises(RequestFailed, match="shutdown"):
            h.result(timeout=30)
        assert router.stats["rehomed"] == 0
    finally:
        _shutdown(router, engines.values())


def test_deadline_propagates_remaining_budget(model):
    from paddle_tpu_torch.serving import FleetRouter, RequestParams
    eng = _engine(model)
    now = [1000.0]
    router = FleetRouter({"a": eng}, clock=lambda: now[0], seed=0)
    try:
        h = router.submit([1, 2, 3], RequestParams(deadline_s=30.0))
        assert h.deadline == pytest.approx(1030.0)
        now[0] += 12.5
        assert router._params_for(h).deadline_s == pytest.approx(17.5)
        now[0] += 40.0
        assert router._params_for(h).deadline_s == 0.0
        assert not router._reroutable(h)
        h.result(timeout=120)
    finally:
        _shutdown(router, [eng])


def test_half_open_probe_routes_to_recovering_replica(model):
    from paddle_tpu_torch.core import flight_recorder, monitor
    from paddle_tpu_torch.serving import FleetRouter
    from paddle_tpu_torch.serving.router import BREAKER_CLOSED, BREAKER_OPEN
    engines = {"a": _engine(model), "b": _engine(model)}
    router = FleetRouter(engines, breaker_threshold=1, breaker_base_s=0.0,
                         breaker_cap_s=0.0, seed=0)
    monitor.enable()
    try:
        rec = router._replicas["a"]
        with router._lock:
            router._note_failure(rec, "test")
        assert rec.breaker.state == BREAKER_OPEN
        assert router.stats["breaker_trips"] == 1
        assert _counter("serve.router.breaker.trips{replica=a}") == 1
        h = router.submit([1, 2, 3])
        assert h.replica == "a" and rec.breaker.probe_in_flight
        assert h.result(timeout=120).size == MAX_NEW
        assert rec.breaker.state == BREAKER_CLOSED
        kinds = [k for _, k, _ in flight_recorder.events()]
        for k in ("serve.router.breaker_open", "serve.router.breaker_probe",
                  "serve.router.breaker_close"):
            assert k in kinds
    finally:
        _shutdown(router, engines.values())


def test_client_error_not_rerouted(model):
    from paddle_tpu_torch.serving import FleetRouter
    engines = [_engine(model), _engine(model)]
    router = FleetRouter(engines, seed=0)
    try:
        with pytest.raises(ValueError):
            router.submit(np.arange(100, dtype=np.int32))  # > bucket 16
        assert router.stats["reroutes"] == 0
    finally:
        _shutdown(router, engines)


def test_router_endpoint(model):
    from paddle_tpu_torch.core.telemetry_server import TelemetryServer
    from paddle_tpu_torch.serving import FleetRouter
    from paddle_tpu_torch.serving.router import BREAKER_CLOSED
    eng = _engine(model)
    router = FleetRouter({"a": eng}, seed=0)
    server = TelemetryServer(port=0).start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/router", timeout=10)
        assert e.value.code == 404             # nothing attached yet
        server.attach_router(router)
        h = router.submit([1, 2, 3])
        with urllib.request.urlopen(base + "/router", timeout=10) as r:
            assert r.status == 200
            doc = json.loads(r.read().decode())
        assert doc["submitted"] == 1 and doc["admissions"] == 1
        (row,) = doc["replicas"]
        assert row["name"] == "a" and row["breaker"] == BREAKER_CLOSED
        assert "score" in row and "ready" in row["health"]
        assert doc["breaker"]["threshold"] == router.breaker_threshold
        assert doc == json.loads(json.dumps(router.describe()))
        h.result(timeout=120)
    finally:
        server.stop()
        _shutdown(router, [eng])


# ------------------------------------------------------------- chaos

@pytest.mark.chaos
def test_rolling_deploy_zero_drop(model, reference):
    """Three replicas, a SIGTERM mid-stream, one replica drained and
    relaunched while its queue holds work: every handle COMPLETED with
    the sequential tokens, the drained queue re-homed, no kernel built
    by the rejoin, the fresh replica warm and serving."""
    from paddle_tpu_torch.core import flight_recorder
    from paddle_tpu_torch.distributed.resilience import GracefulShutdown
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.serving import InProcessFleet, RequestStatus
    from paddle_tpu_torch.utils.fault_injection import KillAfter
    fleet = InProcessFleet(
        lambda name: _engine(model, max_queue=8, drain_timeout_s=60.0),
        n=3, router_kw=dict(seed=0))
    try:
        rng = np.random.RandomState(19)
        prompts = [rng.randint(0, 512, 3 + int(rng.poisson(3.0)))
                   .astype(np.int32) for _ in range(6)]
        killer = KillAfter(4, signal.SIGTERM)
        with GracefulShutdown(exit_on_save=False) as gs:
            handles = []
            for p in prompts:
                handles.append(fleet.router.submit(p))
                killer.step()
            assert killer.fired and gs.preempted
            victim = handles[0].replica
            assert any(h.replica == victim and not h.done()
                       for h in handles)
            builds = _build.build_count()
            fresh = fleet.rolling_deploy(victim)
            assert _build.build_count() == builds
            assert fresh._warm and fresh.health()["ready"]
            assert fleet[victim] is fresh
            prompts += [rng.randint(0, 512, 4 + i).astype(np.int32)
                        for i in range(3)]
            handles += [fleet.router.submit(p) for p in prompts[6:]]
        for h, p in zip(handles, prompts):
            np.testing.assert_array_equal(h.result(timeout=180),
                                          reference(p))
            assert h.status is RequestStatus.COMPLETED
        stats = fleet.router.stats
        assert stats["rehomed"] >= 1 and stats["rejected"] == 0
        kinds = [k for _, k, _ in flight_recorder.events()]
        for k in ("serve.router.drain", "serve.router.rejoin",
                  "serve.router.reroute"):
            assert k in kinds
        probe = fleet.router.submit([7, 7, 7])
        assert probe.result(timeout=120).size == MAX_NEW
    finally:
        fleet.shutdown()


@pytest.mark.chaos
def test_rolling_deploy_in_thread_mode(model, reference):
    """Two replicas each on its own pump thread, a dense and a paged
    one, traffic submitted from the test thread, a rolling deploy of the
    dense one while its queue holds work: every handle COMPLETED with
    the sequential tokens, pages conserved on the paged replica."""
    from paddle_tpu_torch.serving import InProcessFleet, RequestStatus
    opts = {"r0": dict(max_queue=8, max_batch=2),
            "r1": dict(max_queue=8, max_batch=2, paged=True,
                       kv_page_size=8, buckets=BUCKETS)}
    fleet = InProcessFleet(
        lambda name: _engine(model, start=True, **opts[name]),
        names=["r0", "r1"], router_kw=dict(seed=0))
    try:
        prompts = _prompts(7, seed=5)[:6] + [np.arange(1, 12,
                                                       dtype=np.int32)]
        prompts = [p[:16] for p in prompts]
        handles = [fleet.router.submit(p) for p in prompts[:5]]
        old = fleet["r0"]
        fresh = fleet.rolling_deploy("r0")
        assert old._thread is None and fresh._thread.is_alive()
        assert old._cache is None          # freed before the relaunch
        handles += [fleet.router.submit(p) for p in prompts[5:]]
        for h, p in zip(handles, prompts):
            np.testing.assert_array_equal(h.result(timeout=180),
                                          reference(p))
            assert h.status is RequestStatus.COMPLETED
        assert fleet.router.stats["rejected"] == 0
        paged = fleet["r1"]
        deadline = time.monotonic() + 30
        while paged.busy and time.monotonic() < deadline:
            time.sleep(0.01)
        paged._alloc.drop_registry()
        paged._alloc.assert_conserved()
        assert paged._alloc.used_pages() == 0
    finally:
        fleet.shutdown()
    assert all(e._thread is None for e in fleet.router.engines().values())


@pytest.mark.chaos
def test_breaker_gate_survives_admission_failures(model, reference):
    """Two injected admission failures on r0 trip its breaker OPEN within
    the threshold; the request completes on r1 with no caller-visible
    error, later traffic stays on r1, and after the backoff the
    half-open probe restores r0."""
    from paddle_tpu_torch.core import flight_recorder
    from paddle_tpu_torch.serving import InProcessFleet, RequestStatus
    from paddle_tpu_torch.serving.router import BREAKER_CLOSED, BREAKER_OPEN
    from paddle_tpu_torch.utils.fault_injection import fail_admission
    fleet = InProcessFleet(
        lambda name: _engine(model, max_queue=8, drain_timeout_s=60.0),
        n=2, router_kw=dict(breaker_threshold=2, breaker_base_s=30.0,
                            breaker_cap_s=60.0, seed=7))
    try:
        router = fleet.router
        rec = router._replicas["r0"]
        prompts = _prompts(6, seed=5)
        prompts = [p[:16] for p in prompts]
        with fail_admission(fleet["r0"], n=2) as fault:
            h0 = router.submit(prompts[0])
            np.testing.assert_array_equal(h0.result(timeout=120),
                                          reference(prompts[0]))
            assert fault.triggered == 2
        assert rec.breaker.state == BREAKER_OPEN and rec.breaker.trips == 1
        assert h0.replica == "r1" and h0.reroutes == 2
        handles = [router.submit(p) for p in prompts[1:]]
        assert all(h.replica == "r1" for h in handles)
        for h, p in zip(handles, prompts[1:]):
            np.testing.assert_array_equal(h.result(timeout=120),
                                          reference(p))
            assert h.status is RequestStatus.COMPLETED
        assert rec.breaker.state == BREAKER_OPEN
        assert router.stats["breaker_trips"] == 1
        assert router.stats["rejected"] == 0
        reroutes = [f for _, k, f in flight_recorder.events()
                    if k == "serve.router.reroute"]
        assert sum(f["reason"] == "admission_error" for f in reroutes) == 2
        rec.breaker.open_until = time.monotonic() - 0.001
        probe = router.submit([9, 9])
        assert probe.replica == "r0"
        assert probe.result(timeout=120).size == MAX_NEW
        assert rec.breaker.state == BREAKER_CLOSED
    finally:
        fleet.shutdown()


@pytest.mark.chaos
def test_wedge_replica_standalone(model):
    from paddle_tpu_torch.utils.fault_injection import wedge_replica
    eng = _engine(model)
    try:
        h = eng.submit([1, 2, 3])
        with wedge_replica(eng):
            with pytest.raises(TimeoutError):
                h.result(timeout=0.3)
            assert not h.done()
        assert h.result(timeout=120).size == MAX_NEW
    finally:
        eng.shutdown()


@pytest.mark.chaos
def test_wedged_pump_thread_sleeps(model):
    """A wedged engine in thread mode keeps its pump thread looping on
    a busy queue; each swallowed step sleeps, so the loop yields the
    GIL instead of spinning (about one pass a millisecond)."""
    from paddle_tpu_torch.utils.fault_injection import wedge_replica
    eng = _engine(model, start=True)
    try:
        with wedge_replica(eng) as wedge:
            h = eng.submit([1, 2, 3])
            time.sleep(0.2)
            assert not h.done()
            assert 0 < wedge.stalled <= 200
        assert h.result(timeout=120).size == MAX_NEW
    finally:
        eng.shutdown()


@pytest.mark.chaos
def test_wedge_replica_router_routes_around(model):
    from paddle_tpu_torch.serving import FleetRouter
    from paddle_tpu_torch.utils.fault_injection import wedge_replica
    a = _engine(model, max_queue=1)
    b = _engine(model, max_queue=4)
    router = FleetRouter({"a": a, "b": b}, seed=0)
    try:
        wedge = wedge_replica(a).wedge()
        stuck = a.submit([1, 2, 3])
        assert not a.health()["ready"]
        routed = [router.submit([4, 5]), router.submit([6, 7, 8])]
        assert all(rr.replica == "b" for rr in routed)
        for rr in routed:
            assert rr.result(timeout=120).size == MAX_NEW
        assert a.health()["queue_depth"] == 1
        wedge.release()
        assert stuck.result(timeout=120).size == MAX_NEW
    finally:
        _shutdown(router, [a, b])


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--oracle":
        _oracle(sys.argv[2])
    else:
        sys.exit(__doc__)
