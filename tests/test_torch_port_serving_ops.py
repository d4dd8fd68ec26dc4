"""The port's serving operations surface on test-tiny: ``health()``,
``warmup()``, drain, thread mode, preemption through ``serve_forever``,
and the telemetry server, held to the JAX package's engine where it can
be run and to the JAX package's own tests' invariants where it is the
port's own behaviour.

The JAX ``ServingEngine`` imports ``paddle_tpu.analysis.memory``, which
does not import under this jax (ROADMAP C3), so it runs in a child
process (``python tests/test_torch_port_serving_ops.py --oracle OUT``)
that gives ``jax.extend.core`` a dummy ``DropVar`` there and nowhere
else. The child builds test-tiny from seed 0, writes its parameters,
and drives four engines (dense, paged with a five-page pool, chunked on
a paged cache, int8) through fixed traffic, writing their ``health()``
documents after construction, with the queue at its bound (blocked on
nothing yet, on slots, on pages), mid chunked prefill and after
``drain()``, the rejection reasons and every handle's end. The port
must give equal documents, reasons and handles. No time is compared.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MAX_NEW = 8
BUCKETS = (16, 32)
MAX_BATCH = 2
#: the oracle's engines: enable_serving options
HEALTH_ENGINES = {
    "dense": dict(max_queue=1),
    # 5 allocatable pages of 8: one 20-token prompt (4 pages with its
    # budget) leaves too few for a second
    "paged": dict(max_queue=1, paged=True, kv_page_size=8, kv_pages=6),
    "chunked": dict(max_queue=2, paged=True, kv_page_size=8,
                    prefill_chunk_tokens=8),
    "int8": dict(max_queue=2, kv_cache_dtype="int8"),
}
ENV_CLEARED = ("PADDLE_KV_CACHE_DTYPE", "PADDLE_KV_PAGE_SIZE",
               "PADDLE_PREFILL_CHUNK_TOKENS", "PADDLE_FLIGHT_RECORDER",
               "PADDLE_HBM_BUDGET", "PADDLE_TELEMETRY_PORT",
               "PADDLE_FLEET_STORE", "PADDLE_TRACE_SAMPLE")


def _prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(0, 512, n).astype(np.int32)
            for n in (5, 12, 20, 20, 7, 30, 9)]


def _config(Config, model, *, max_new=MAX_NEW, buckets=BUCKETS,
            max_batch=MAX_BATCH, eos=None, **serving):
    cfg = (Config().from_layer(model, None)
           .enable_generation(max_new_tokens=max_new,
                              prefill_buckets=buckets, max_batch=max_batch,
                              eos_token_id=eos))
    if hasattr(cfg, "disable_gpu"):
        cfg.disable_gpu()
    return cfg.enable_serving(**serving) if serving else cfg


def _health_run(name, engine, QueueFull):
    """Fixed traffic on one engine (both packages): the health documents
    at each point, the reasons of the rejected submits, and every
    handle's status, detail and tokens after the drain."""
    P = _prompts()
    docs, rejected, handles = {"built": engine.health()}, [], []

    def submit(p):
        try:
            handles.append(engine.submit(p))
        except QueueFull as e:
            rejected.append(e.reason)
            handles.append(e.request)

    if name in ("dense", "int8"):
        burst = 1 if name == "dense" else 2
        for p in P[:burst]:
            submit(p)
        docs["burst"] = engine.health()      # at bound, blocker unknown
        submit(P[6])
        for _ in range(2):
            engine.step()
        if name == "dense":
            submit(P[1])
            engine.step()
        for p in P[2:2 + burst]:
            submit(p)
        docs["slots"] = engine.health()      # at bound, every lane busy
        submit(P[4])
    elif name == "paged":
        submit(P[2])
        engine.step()
        docs["admitted"] = engine.health()
        submit(P[3])
        engine.step()
        docs["pages"] = engine.health()      # head waits on pool pages
        submit(P[4])
    else:   # chunked
        submit(P[5])
        engine.step()
        docs["mid_prefill"] = engine.health()
        submit(P[0])
        engine.step()
        docs["mid_prefill_2"] = engine.health()
    engine.drain()
    docs["drained"] = engine.health()
    ends = [[h.status.value, h.detail,
             None if h.tokens is None else [int(t) for t in h.tokens]]
            for h in handles]
    return dict(docs=docs, rejected=rejected, handles=ends)


# ------------------------------------------------------------ the child

def _oracle(out_path: str):
    """Run the JAX engines (child process only: it patches jax)."""
    import jax.extend.core as jcore
    if not hasattr(jcore, "DropVar"):
        # analysis/memory.py imports DropVar, which this jax dropped;
        # the engine's memory planner never runs without an HBM budget
        jcore.DropVar = type("DropVar", (), {})
    import paddle_tpu as paddle
    from paddle_tpu.inference import Config
    from paddle_tpu.models.gpt import gpt
    from paddle_tpu.serving import QueueFull, ServingEngine

    paddle.seed(0)
    model = gpt("test-tiny")
    model.eval()
    np.savez(out_path + ".npz", **{k: np.asarray(v._data)
                                   for k, v in model.state_dict().items()})
    out = {}
    for name, opts in HEALTH_ENGINES.items():
        eng = ServingEngine(_config(Config, model, **opts), poll_every=1,
                            seed=0)
        out[name] = _health_run(name, eng, QueueFull)
        eng.shutdown()
    with open(out_path, "w") as f:
        json.dump(out, f)


# ------------------------------------------------------------ fixtures

@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    out = tmp_path_factory.mktemp("ops_oracle") / "oracle.json"
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


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """No stray environment knob; a clean registry, ring, watchtower and
    recorder, with the monitor off again afterwards."""
    from paddle_tpu_torch.core import (flight_recorder, metrics, monitor,
                                       slo, timeseries)
    for k in ENV_CLEARED:
        monkeypatch.delenv(k, raising=False)

    def fresh():
        monitor.disable()
        metrics._reset_for_tests()
        timeseries._reset_for_tests()
        slo._reset_for_tests()
        flight_recorder.configure(capacity=flight_recorder.DEFAULT_CAPACITY,
                                  on=True)

    fresh()
    yield
    fresh()


def _engine(model, *, warmup=True, poll_every=1, seed=0, **kw):
    from paddle_tpu_torch.inference import Config
    from paddle_tpu_torch.serving import ServingEngine
    cfg_kw = {k: kw.pop(k) for k in ("max_new", "buckets", "max_batch",
                                     "eos") if k in kw}
    serving = {k: kw.pop(k) for k in list(kw)
               if k not in ("telemetry_port", "drain_timeout_s")}
    return ServingEngine(_config(Config, model, **cfg_kw, **serving),
                         warmup=warmup, poll_every=poll_every, seed=seed,
                         **kw)


def _sequential(model, prompt, n=MAX_NEW):
    """The port's batch-1 greedy ``generate`` (the sequential
    reference)."""
    from paddle_tpu_torch.generation import generate
    out = generate(model, np.asarray(prompt)[None, :].astype(np.int64), n)
    return out.numpy()[0]


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode()


# -------------------------------------------------- held to the JAX engine

@pytest.mark.parametrize("name", list(HEALTH_ENGINES))
def test_health_documents_match_the_jax_engine(oracle, model, name):
    from paddle_tpu_torch.serving import QueueFull
    want = oracle[name]
    eng = _engine(model, **HEALTH_ENGINES[name])
    try:
        got = _health_run(name, eng, QueueFull)
    finally:
        eng.shutdown()
    assert list(got["docs"]) == list(want["docs"])
    for label, doc in want["docs"].items():
        assert got["docs"][label] == doc, label
    assert got["rejected"] == want["rejected"]
    assert got["handles"] == want["handles"]
    if name == "paged":
        assert want["docs"]["pages"]["queue_blocked_on"] == "pages"
        eng._alloc.assert_conserved()
    if name == "chunked":
        assert want["docs"]["mid_prefill"]["prefill_chunks_queued"] > 0
        assert eng._alloc.used_pages() == 0
        eng._alloc.assert_conserved()


# ------------------------------------------------ C14: rejection reasons

def test_rejection_reason_dense(model):
    from paddle_tpu_torch.serving import QueueFull, RequestFailed, \
        RequestStatus
    eng = _engine(model, buckets=(16,), max_batch=1, max_queue=1)
    running = eng.submit([1, 2, 3])
    eng.step()
    queued = eng.submit([4, 5])
    with pytest.raises(QueueFull) as ei:
        eng.submit([6, 7])
    assert ei.value.reason == "queue_full:no_free_slots"
    handle = ei.value.request
    assert handle.done() and handle.status is RequestStatus.REJECTED
    assert handle.detail == "queue_full:no_free_slots"
    with pytest.raises(RequestFailed, match="no_free_slots"):
        handle.result(timeout=1)
    assert running.result(timeout=60).size == MAX_NEW
    assert queued.result(timeout=60).size == MAX_NEW
    eng.shutdown()
    # queue at bound with lanes still free -> bare queue_full
    eng2 = _engine(model, buckets=(16,), max_batch=2, max_queue=1)
    first = eng2.submit([1, 2, 3])
    with pytest.raises(QueueFull) as ei2:
        eng2.submit([4, 5])
    assert ei2.value.reason == "queue_full"
    assert ei2.value.request.detail == "queue_full"
    assert first.result(timeout=60).size == MAX_NEW
    eng2.shutdown()


def test_rejection_reason_paged(model):
    """The queue head blocked on pool pages stamps its rejections
    ``queue_full:no_free_pages`` on the QueueFull and on the handle (a
    bare ``queue_full`` before the repair)."""
    from paddle_tpu_torch.serving import QueueFull, RequestStatus
    eng = _engine(model, buckets=(16,), max_batch=2, paged=True,
                  kv_page_size=16, kv_pages=3, max_queue=1)
    a = eng.submit(np.arange(1, 16, dtype=np.int32))   # 2 pages
    eng.step()
    b = eng.submit(np.arange(2, 17, dtype=np.int32))   # blocked on pages
    eng.step()
    assert eng._page_blocked
    assert eng.health()["queue_blocked_on"] == "pages"
    with pytest.raises(QueueFull) as ei:
        eng.submit(np.arange(3, 10, dtype=np.int32))
    assert ei.value.reason == "queue_full:no_free_pages"
    assert ei.value.request.status is RequestStatus.REJECTED
    assert ei.value.request.detail == "queue_full:no_free_pages"
    while eng.busy:
        eng.step()
    assert a.status is RequestStatus.COMPLETED
    assert b.status is RequestStatus.COMPLETED
    eng._alloc.assert_conserved()
    eng.shutdown()


def test_health_distinguishes_pages_from_slots(model):
    eng = _engine(model, buckets=(16,), max_batch=2, paged=True,
                  kv_page_size=16, kv_pages=3, max_queue=2)
    eng.submit(np.arange(1, 16, dtype=np.int32))
    eng.step()
    eng.submit(np.arange(2, 17, dtype=np.int32))
    eng.submit(np.arange(3, 10, dtype=np.int32))
    eng.step()
    h = eng.health()
    assert h["queue_blocked_on"] == "pages"
    assert not h["ready"] and h["reason"] == "queue_full:no_free_pages"
    assert h["free_pages"] == 0 and h["total_pages"] == 2
    eng.shutdown()
    eng._alloc.assert_conserved()
    eng2 = _engine(model, buckets=(16,), max_batch=1, max_queue=1)
    eng2.submit(np.arange(1, 8, dtype=np.int32))
    eng2.step()
    eng2.submit(np.arange(1, 5, dtype=np.int32))
    h2 = eng2.health()
    assert h2["queue_blocked_on"] == "slots"
    assert not h2["ready"] and h2["reason"] == "queue_full:no_free_slots"
    eng2.shutdown()


@pytest.mark.parametrize("paged", [False, True])
def test_health_capacity_tokens_int8(model, paged):
    kw = dict(kv_cache_dtype="int8")
    if paged:
        kw.update(paged=True, kv_page_size=8)
    eng = _engine(model, **kw)
    h = eng.health()
    assert h["kv_cache_dtype"] == "int8"
    if paged:
        assert h["capacity_tokens"] == (eng._alloc.n_pages - 1) * 8
        assert h["free_tokens"] == eng._alloc.free_pages() * 8
    else:
        assert h["capacity_tokens"] == eng.max_batch * eng.max_len
        assert h["free_tokens"] == h["capacity_tokens"]
    eng.submit(np.arange(1, 12, dtype=np.int32))
    eng.step()
    assert eng.health()["free_tokens"] < h["free_tokens"]
    eng.shutdown()


# ------------------------------------------------------------- warmup

SPEC_ENGINES = {
    "dense": {}, "paged": dict(paged=True, kv_page_size=8),
    "chunked": dict(paged=True, kv_page_size=8, prefill_chunk_tokens=8),
    "int8": dict(kv_cache_dtype="int8"),
    "spec": dict(speculative=True),
}


def _spec_engine(model, name, **kw):
    from paddle_tpu_torch.generation import SpeculativeConfig
    from paddle_tpu_torch.inference import Config
    from paddle_tpu_torch.serving import ServingEngine
    opts = dict(SPEC_ENGINES[name])
    spec = SpeculativeConfig(k=3, ngram=2) if opts.pop("speculative",
                                                       False) else None
    cfg = (Config().from_layer(model).disable_gpu()
           .enable_generation(max_new_tokens=MAX_NEW, prefill_buckets=BUCKETS,
                              max_batch=MAX_BATCH, speculative=spec,
                              do_sample=spec is None, top_k=8)
           .enable_serving(**opts))
    return ServingEngine(cfg, poll_every=2, seed=3, **kw)


def _state(eng):
    """Every tensor of the engine's device state, cloned, and its host
    state."""
    tensors = {}
    for name, t in vars(eng).items():
        if isinstance(t, torch.Tensor):
            tensors[name] = t.clone()
    for cname in ("_cache", "_row_cache"):
        c = getattr(eng, cname)
        if c is not None:
            for f in ("k", "v", "kv_len", "k_scale", "v_scale", "clips",
                      "page_table"):
                t = getattr(c, f, None)
                if isinstance(t, torch.Tensor):
                    tensors[f"{cname}.{f}"] = t.clone()
    host = dict(stats=dict(eng.stats), slots=list(eng._slots),
                used=list(eng._slot_used), queue=len(eng._queue))
    if eng._alloc is not None:
        host.update(alloc=dict(eng._alloc.stats),
                    free=eng._alloc.free_pages())
    gen = None if eng._gen is None else eng._gen.get_state().clone()
    return tensors, host, gen


@pytest.mark.parametrize("name", list(SPEC_ENGINES))
def test_warmup_leaves_the_engine_as_it_found_it(model, name):
    """warmup() touches no live tensor, no host state, not the sampling
    generator, records no metric and no flight-recorder event."""
    from paddle_tpu_torch.core import flight_recorder, metrics, monitor
    monitor.enable()
    eng = _spec_engine(model, name, warmup=False)
    assert not eng._warm and eng.health()["reason"] == "warming"
    snap0 = metrics.snapshot()
    events0 = len(flight_recorder.events())
    tensors, host, gen = _state(eng)
    gp0 = eng.goodput()["buckets"]
    assert eng.warmup() is eng and eng._warm and eng.health()["ready"]
    t2, h2, g2 = _state(eng)
    assert t2.keys() == tensors.keys()
    for k, t in tensors.items():
        assert torch.equal(t, t2[k]), k
    assert h2 == host
    assert (gen is None) == (g2 is None)
    if gen is not None:
        assert torch.equal(gen, g2)
    assert metrics.snapshot() == snap0
    assert len(flight_recorder.events()) == events0
    gp = eng.goodput()["buckets"]
    assert {b for b, v in gp.items() if v and b != "idle"} == \
        {b for b, v in gp0.items() if v and b != "idle"}
    eng.shutdown()


@pytest.mark.parametrize("name", list(SPEC_ENGINES))
def test_warmup_changes_no_stream_metric_or_goodput_bucket(
        model, name, monkeypatch):
    """The same sampled traffic on a warmed engine and on one built with
    warmup=False: equal streams bit for bit, equal stats, equal metric
    keys and counters, equal goodput bucket keys (one time-series sample
    a run, so no SLO family depends on the run's speed)."""
    from paddle_tpu_torch.core import metrics, monitor, slo, timeseries
    from paddle_tpu_torch.serving import RequestParams
    monkeypatch.setenv("PADDLE_TS_PERIOD_S", "3600")
    runs = []
    for warm in (True, False):
        metrics._reset_for_tests()
        timeseries._reset_for_tests()
        slo._reset_for_tests()
        monitor.enable()
        eng = _spec_engine(model, name, warmup=warm)
        hs = [eng.submit(p, RequestParams(max_new_tokens=MAX_NEW))
              for p in _prompts()]
        while eng.busy:
            eng.step()
        snap = metrics.snapshot()
        counters = {k: v["value"] for k, v in snap.items()
                    if v["kind"] == "counter"
                    and not k.startswith("serve.goodput")}
        gp = eng.goodput()["buckets"]
        runs.append(dict(streams=[h.result(timeout=10).tolist() for h in hs],
                         stats=dict(eng.stats), keys=sorted(snap),
                         counters=counters,
                         buckets=sorted(b for b, v in gp.items() if v)))
        eng.shutdown()
        monitor.disable()
    assert runs[0] == runs[1]


def test_warmup_runs_every_program(model, monkeypatch):
    """One prefill per bucket, the decode forward, and on a chunked
    engine the chunk and final-chunk forwards: each program once."""
    calls = []
    eng = _spec_engine(model, "chunked", warmup=False)
    orig = eng.network.forward

    def spy(ids, *a, **kw):
        calls.append((tuple(ids.shape), "cache" in kw and
                      kw["cache"] is not None, "prompt_len" in kw))
        return orig(ids, *a, **kw)

    monkeypatch.setattr(eng.network, "forward", spy)
    eng.warmup()
    prefills = [c for c in calls if not c[1]]
    assert sorted(c[0][1] for c in prefills) == list(BUCKETS)
    assert ((1, 1), True, False) in calls                  # decode step
    assert ((1, 8), True, False) in calls                  # a chunk
    assert ((1, 8), True, True) in calls                   # final chunk
    eng.shutdown()


@pytest.mark.parametrize("name", ["dense", "paged", "chunked", "int8"])
def test_warmup_scratch_is_one_row(model, name, monkeypatch):
    """warmup's scratch caches hold one row (a paged pool of that row's
    pages and the null page), never the live cache's batch or pool."""
    made = []
    eng = _spec_engine(model, name, warmup=False)
    orig = eng._new_cache

    def spy(*a, **kw):
        made.append(orig(*a, **kw))
        return made[-1]

    monkeypatch.setattr(eng, "_new_cache", spy)
    eng.warmup()
    assert made
    for c in made:
        if eng._alloc is not None and c.k.shape[1] > 1:
            # a paged pool: one row's pages and the null page
            assert c.k.shape[1] == eng.pages_per_row + 1 and c.batch == 1
        else:
            assert c.k.shape[1] == 1                  # a dense row
        assert c.k.numel() < eng._cache.k.numel()
    eng.shutdown()
    assert eng._cache is None and eng._row_cache is None


def test_loaded_library_never_waits_on_a_build(monkeypatch):
    """A launch of a library already loaded takes no lock: it returns
    while another thread holds the build lock (a lazy nvcc build)."""
    from paddle_tpu_torch.kernels import _build
    lib = object()
    monkeypatch.setitem(_build._LIBS, "loaded_lib", lib)
    got = []
    with _build._LOCK:
        t = threading.Thread(
            target=lambda: got.append(_build.library("loaded_lib")))
        t.start()
        t.join(timeout=5)
    assert got == [lib]


def test_warmup_failure_releases_telemetry_port(model):
    """A constructor abort (warmup raises) stops the telemetry server it
    started: the port is free for the retried engine."""
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.inference import Config
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    class Boom(ServingEngine):
        def warmup(self):
            raise RuntimeError("injected warmup failure")

    cfg = _config(Config, model)
    with pytest.raises(RuntimeError, match="injected warmup"):
        Boom(cfg, telemetry_port=port)
    with socket.socket() as s:
        s.bind(("127.0.0.1", port))       # nothing leaked on it
    eng = ServingEngine(cfg, telemetry_port=port)
    assert eng.telemetry is not None and eng.telemetry.port == port
    eng.shutdown()


# --------------------------------------------------------------- drains

def test_drain_with_no_traffic_is_clean(model):
    from paddle_tpu_torch.core import flight_recorder
    eng = _engine(model, warmup=False)
    eng.drain()
    eng.drain()                                     # idempotent
    with pytest.raises(RuntimeError, match="shut down"):
        eng.submit([1, 2])
    kinds = [k for _, k, _ in flight_recorder.events()]
    assert kinds.count("serve.drain_begin") == 1
    assert kinds.count("serve.drain_end") == 1
    assert eng.stats["rejected"] == 1


def test_submit_after_shutdown_rejects_the_handle(model, monkeypatch):
    from paddle_tpu_torch.serving import RequestStatus
    from paddle_tpu_torch.serving import request as request_mod
    eng = _engine(model)
    eng.shutdown()
    made = []
    orig = request_mod.Request.__init__

    def keep(self, *a, **kw):
        orig(self, *a, **kw)
        made.append(self)

    monkeypatch.setattr(request_mod.Request, "__init__", keep)
    with pytest.raises(RuntimeError, match="shut down"):
        eng.submit([1, 2, 3])
    assert made[-1].status is RequestStatus.REJECTED
    assert made[-1].detail == "shutdown"


def test_drain_completes_rows_finished_since_last_poll(model):
    from paddle_tpu_torch.serving import RequestParams, RequestStatus
    eng = _engine(model, buckets=(16,), max_batch=1, poll_every=4,
                  drain_timeout_s=0.0)
    h = eng.submit([1, 2, 3], RequestParams(max_new_tokens=2))
    eng.step()   # admitted + one decode step: the budget is reached but
    #              the poll cadence (4) has not come round
    eng.drain()  # zero window: only the final poll can complete it
    assert h.status is RequestStatus.COMPLETED
    assert h.result().size == 2


@pytest.mark.chaos
def test_drain_timeout_cancels_stragglers(model):
    from paddle_tpu_torch.serving import RequestStatus
    eng = _engine(model, buckets=(16,), max_batch=1, drain_timeout_s=0.0)
    h = eng.submit([1, 2, 3])
    eng.step()
    eng.drain()
    assert h.done() and h.status is RequestStatus.CANCELLED
    assert h.detail == "shutdown"
    assert h.tokens is not None and 1 <= h.tokens.size < MAX_NEW
    assert eng.health()["slots_busy"] == 0


def test_drain_mid_chunked_prefill_returns_its_pages(model):
    from paddle_tpu_torch.serving import RequestStatus
    eng = _engine(model, paged=True, kv_page_size=8,
                  prefill_chunk_tokens=8, drain_timeout_s=30.0)
    h = eng.submit(np.arange(1, 25, dtype=np.int32))
    eng.step()
    assert h.status is RequestStatus.PENDING_PREFILL
    eng.drain()
    assert h.done() and h.status is RequestStatus.CANCELLED
    assert h.detail == "shutdown"
    assert eng._alloc.used_pages() == 0
    eng._alloc.assert_conserved()


def test_drain_records_and_zeroes_the_gauges(model):
    from paddle_tpu_torch.core import flight_recorder, metrics, monitor
    monitor.enable()
    eng = _engine(model, paged=True, kv_page_size=8, max_queue=8)
    hs = [eng.submit(p) for p in _prompts()[:4]]
    eng.step()
    eng.drain()
    snap = metrics.snapshot()
    assert snap["serve.slot_occupancy"]["value"] == 0.0
    assert snap["serve.queue_depth"]["value"] == 0.0
    assert snap["gen.cache.pages_allocated"]["value"] > 0
    assert any(k.startswith("serve.goodput.seconds") for k in snap)
    ev = {k: f for _, k, f in flight_recorder.events()
          if k.startswith("serve.drain")}
    assert ev["serve.drain_begin"] == dict(queued=2, in_flight=2)
    assert "serve.drain_end" in ev
    assert sum(h.detail == "shutdown" for h in hs) == 2


# ---------------------------------------------------------- thread mode

def test_thread_mode_and_shutdown(model):
    eng = _engine(model, buckets=(16,), max_batch=1, max_new=4)
    eng.start()
    try:
        assert eng._thread.name == "serving-engine" and eng._thread.daemon
        assert eng.start() is eng                      # one thread
        assert not eng._try_pump()     # the thread owns the engine
        hs = [eng.submit(np.arange(1, 4 + i, dtype=np.int32))
              for i in range(3)]
        outs = [h.result(timeout=60) for h in hs]
        assert all(o.size == 4 for o in outs)
        for h in hs:
            np.testing.assert_array_equal(
                h.tokens, _sequential(model, h.prompt, 4))
    finally:
        eng.shutdown()
    assert eng._thread is None
    with pytest.raises(RuntimeError, match="shut down"):
        eng.submit([1, 2])
    eng.shutdown()                                     # idempotent


def test_thread_mode_submits_from_many_threads(model):
    eng = _engine(model, max_queue=64).start()
    out = {}
    try:
        def client(i):
            p = _prompts()[i]
            out[i] = eng.submit(p).result(timeout=60)

        ts = [threading.Thread(target=client, args=(i,)) for i in range(6)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        eng.shutdown()
    for i, toks in out.items():
        np.testing.assert_array_equal(toks,
                                      _sequential(model, _prompts()[i]))
    assert len(out) == 6 and eng.stats["completed"] == 6


# ------------------------------------------------ serve_forever, preemption

@pytest.mark.chaos
def test_graceful_shutdown_drains_serving(model):
    """SIGTERM mid-serve_forever: in-flight requests complete within the
    drain window, queued ones end REJECTED("shutdown"), nothing hangs,
    the engine takes no new work; serve.preempted is recorded, the
    flight recorder dumped, and goodput has a preemption_recovery
    bucket."""
    from paddle_tpu_torch.core import flight_recorder
    from paddle_tpu_torch.distributed.resilience import GracefulShutdown
    from paddle_tpu_torch.serving import RequestStatus
    from paddle_tpu_torch.utils.fault_injection import KillAfter
    eng = _engine(model, max_queue=8, drain_timeout_s=60.0, poll_every=2)
    traffic = _prompts()[:5]
    killer = KillAfter(4, signal.SIGTERM)
    dumps = []
    orig_dump = flight_recorder.auto_dump
    with GracefulShutdown(exit_on_save=False) as gs:
        try:
            flight_recorder.auto_dump = lambda reason, **kw: \
                dumps.append(reason)
            handles = eng.serve_forever(iter(traffic),
                                        on_step=lambda e: killer.step())
        finally:
            flight_recorder.auto_dump = orig_dump
        assert gs.preempted
    assert killer.fired and len(handles) == 5
    assert all(h.done() and h.status.terminal for h in handles)
    done = [h for h in handles if h.status is RequestStatus.COMPLETED]
    rejected = [h for h in handles if h.status is RequestStatus.REJECTED]
    assert done and all(h.tokens.size == MAX_NEW for h in done)
    assert rejected and all(h.detail == "shutdown" for h in rejected)
    for h in done:
        np.testing.assert_array_equal(h.tokens,
                                      _sequential(model, h.prompt))
    assert dumps == ["preemption"]
    kinds = [k for _, k, _ in flight_recorder.events()]
    assert kinds.index("serve.preempted") < kinds.index("serve.drain_begin")
    assert eng.goodput()["buckets"]["preemption_recovery"] > 0.0
    with pytest.raises(RuntimeError, match="shut down"):
        eng.submit(traffic[0])


def test_serve_forever_without_iterator_ends_on_shutdown(model):
    """request_iter=None serves submit() traffic from another thread
    until shutdown() from a third ends the loop."""
    eng = _engine(model)
    got = {}

    def loop():
        got["handles"] = eng.serve_forever()

    t = threading.Thread(target=loop, daemon=True)
    t.start()
    try:
        h = eng.submit(_prompts()[1])
        deadline = time.monotonic() + 60
        while not h.done() and time.monotonic() < deadline:
            time.sleep(0.005)
        assert h.done()
    finally:
        eng.shutdown()
        t.join(timeout=30)
    assert not t.is_alive() and got["handles"] == []
    np.testing.assert_array_equal(h.tokens,
                                  _sequential(model, _prompts()[1]))


def test_serve_forever_preempted_by_trigger_rejects_the_queue(model):
    from paddle_tpu_torch.distributed.resilience import GracefulShutdown
    from paddle_tpu_torch.serving import RequestStatus
    eng = _engine(model, max_queue=8)
    gs = GracefulShutdown(exit_on_save=False)
    steps = [0]

    def on_step(e):
        steps[0] += 1
        if steps[0] == 3:
            gs.trigger()

    handles = eng.serve_forever(iter(_prompts()), shutdown=gs,
                                on_step=on_step)
    assert all(h.status.terminal for h in handles)
    queued = [h for h in handles if h.status is RequestStatus.REJECTED]
    assert queued and all(h.detail == "shutdown" for h in queued)
    assert all(h.detail == "shutdown" for h in handles
               if h.status is RequestStatus.CANCELLED)


def test_serve_forever_crash_records_and_reraises(model):
    from paddle_tpu_torch.core import flight_recorder
    eng = _engine(model)

    def boom(e):
        raise ValueError("injected scheduler fault")

    with pytest.raises(ValueError, match="injected scheduler fault"):
        eng.serve_forever(iter(_prompts()[:2]), on_step=boom)
    crash = [f for _, k, f in flight_recorder.events() if k == "serve.crash"]
    assert crash and "injected scheduler fault" in crash[0]["error"]
    eng.shutdown()


def test_serve_forever_positional_iterator_still_serves(model):
    eng = _engine(model)
    handles = eng.serve_forever(_prompts()[:3])
    for h, p in zip(handles, _prompts()):
        np.testing.assert_array_equal(h.result(timeout=10),
                                      _sequential(model, p))
    eng.shutdown()


# ---------------------------------------------------------- resilience

def test_graceful_shutdown_check_runs_saves_and_restores_handlers():
    from paddle_tpu_torch.distributed import resilience
    prev = signal.getsignal(signal.SIGTERM)
    saved = []
    unregister = resilience.register_emergency(saved.append)
    try:
        assert resilience.active() is None and not resilience.preempted()
        assert resilience.poll(1) is False
        with resilience.GracefulShutdown(exit_on_save=False) as gs:
            assert resilience.active() is gs
            assert signal.getsignal(signal.SIGTERM) == gs._handler
            assert gs.check(3) is False
            gs.trigger()
            assert resilience.preempted()
            assert resilience.poll(7) is True
        assert saved == [7]
        assert signal.getsignal(signal.SIGTERM) == prev
        assert resilience.active() is None
        with resilience.GracefulShutdown(exit_code=77) as gs:
            gs.trigger()
            with pytest.raises(SystemExit) as ei:
                gs.check(9)
            assert ei.value.code == 77
        assert saved == [7, 9]
    finally:
        unregister()
    assert resilience.ELASTIC_EXIT_CODE == 101
    assert resilience.PREEMPT_KEY == "__resilience/preempted"
    with pytest.raises(NotImplementedError, match="A11"):
        resilience.GracefulShutdown(store=object())


@pytest.mark.chaos
def test_kill_after_signals_this_process():
    from paddle_tpu_torch.distributed.resilience import GracefulShutdown
    from paddle_tpu_torch.utils.fault_injection import KillAfter
    with pytest.raises(ValueError):
        KillAfter(0)
    killer = KillAfter(2, signal.SIGTERM)
    with GracefulShutdown(exit_on_save=False) as gs:
        assert killer.step() is False and not gs.preempted
        assert killer.step() is True
        assert gs.preempted and killer.fired
        assert killer.step() is False


# ------------------------------------------------------------- config

def test_config_takes_telemetry_port_and_drain_timeout(model):
    from paddle_tpu_torch.inference import Config
    from paddle_tpu_torch.serving import ServingEngine
    cfg = _config(Config, model, drain_timeout_s=1.5, telemetry_port=0)
    eng = ServingEngine(cfg)
    try:
        assert eng.drain_timeout_s == 1.5
        assert eng.telemetry is not None and eng.telemetry.running
        code, _ = _get(f"http://127.0.0.1:{eng.telemetry.port}/healthz")
        assert code == 200
    finally:
        eng.shutdown()
    assert eng.telemetry is None
    assert ServingEngine(cfg, drain_timeout_s=4.0,
                         telemetry_port=None).drain_timeout_s == 4.0
    assert _engine(model).drain_timeout_s == 30.0
    with pytest.raises(NotImplementedError, match="A12"):
        Config().enable_serving(hbm_budget=1 << 30)


def test_environment_telemetry_port(model, monkeypatch):
    from paddle_tpu_torch.core import metrics, monitor
    monkeypatch.setenv("PADDLE_TELEMETRY_PORT", "0")
    eng = _engine(model)
    try:
        assert eng.telemetry is not None and eng.telemetry.running
    finally:
        eng.shutdown()
    monkeypatch.setenv("PADDLE_TELEMETRY_PORT", "not-a-port")
    monitor.enable()
    eng = _engine(model)
    assert eng.telemetry is None
    assert "errors.swallowed{where=telemetry.port}" in metrics.snapshot()
    eng.shutdown()


# ---------------------------------------------------- telemetry server

def parse_prometheus(text):
    """Minimal exposition-format parser: {"types": {family: kind},
    "samples": {(name, labels-frozenset): float}}. Raises on malformed
    lines: the round trip is the test."""
    types, samples = {}, {}
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            assert parts[0] == "#" and parts[1] == "TYPE", line
            assert parts[3] in ("counter", "gauge", "histogram"), line
            types[parts[2]] = parts[3]
            continue
        metric, _, value = line.rpartition(" ")
        assert metric and value, line
        if "{" in metric:
            name, _, rest = metric.partition("{")
            assert rest.endswith("}"), line
            labels = []
            for kv in rest[:-1].split(","):
                k, _, v = kv.partition("=")
                assert v.startswith('"') and v.endswith('"'), line
                labels.append((k, v[1:-1]))
            key = (name, frozenset(labels))
        else:
            key = (metric, frozenset())
        v = float(value)
        assert v == v and abs(v) != float("inf"), f"non-finite: {line}"
        samples[key] = v
    return {"types": types, "samples": samples}


def test_prometheus_render_matches_the_jax_render():
    """The same registry contents render to the same text as the JAX
    package's ``prometheus_text``, line for line, the build-info line
    compared by its name only (its labels name torch and CUDA there)."""
    from paddle_tpu.core import metrics as jmetrics
    from paddle_tpu.core import monitor as jmonitor
    from paddle_tpu.core.telemetry_server import \
        prometheus_text as jax_text
    from paddle_tpu_torch.core import metrics, monitor
    from paddle_tpu_torch.core.telemetry_server import prometheus_text

    def record(mon):
        mon.record_serve_request("completed")
        mon.record_serve_request("completed")
        mon.record_serve_request("cancelled")
        mon.record_serve_queue_depth(3)
        mon.record_serve_ttft(0.003)
        mon.record_serve_ttft(0.2)
        mon.record_router_admission("r0")
        mon.record_swallowed("weird\"place", ValueError("x"))

    def lines(text):
        return [ln for ln in text.splitlines()
                if not ln.startswith(("paddle_build_info",
                                      "process_uptime_seconds"))]

    with jmetrics._registry_lock:
        saved = dict(jmetrics._metrics)
        jmetrics._metrics.clear()
    was_on = jmetrics.is_enabled()
    try:
        jmetrics.enable()
        record(jmonitor)
        want = jax_text()
    finally:
        jmetrics.enable() if was_on else jmetrics.disable()
        with jmetrics._registry_lock:
            jmetrics._metrics.clear()
            jmetrics._metrics.update(saved)
    metrics.enable()
    record(monitor)
    got = prometheus_text()
    assert lines(got) == lines(want)
    info = [ln for ln in got.splitlines()
            if ln.startswith("paddle_build_info")]
    assert len(info) == 1 and info[0].endswith(" 1")
    assert 'torch="' in info[0] and 'cuda="' in info[0] \
        and 'platform="' in info[0] and "jax" not in info[0]
    parsed = parse_prometheus(got)
    s = parsed["samples"]
    assert parsed["types"]["serve_ttft"] == "histogram"
    assert s[("serve_requests", frozenset({("status", "completed")}))] == 2
    buckets = sorted(((dict(k[1])["le"], v) for k, v in s.items()
                      if k[0] == "serve_ttft_bucket"),
                     key=lambda kv: float("inf") if kv[0] == "+Inf"
                     else float(kv[0]))
    assert [v for _, v in buckets] == sorted(v for _, v in buckets)
    assert buckets[-1] == ("+Inf", 2)
    assert 'where="weird\\"place"' in got


def test_non_finite_never_rendered():
    from paddle_tpu_torch.core import metrics
    from paddle_tpu_torch.core.telemetry_server import prometheus_text
    metrics.enable()
    h = metrics.histogram("t.poison", bounds=(1.0, 2.0))
    h.observe(0.5)
    h.observe(float("nan"))
    h.observe(float("inf"))
    metrics.gauge("t.gone").set(float("nan"))
    s = parse_prometheus(prometheus_text())["samples"]
    assert s[("t_poison_count", frozenset())] == 3
    assert s[("t_poison_sum", frozenset())] == 0.5
    assert s[("t_poison_bucket", frozenset({("le", "+Inf")}))] == 3
    assert s[("t_poison_bucket", frozenset({("le", "2")}))] == 1
    assert s[("t_gone", frozenset())] == 0.0


def test_endpoints_without_engine():
    from paddle_tpu_torch.core import metrics
    from paddle_tpu_torch.core.telemetry_server import TelemetryServer
    server = TelemetryServer(port=0).start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        code, body = _get(base + "/healthz")
        assert code == 200 and json.loads(body)["status"] == "ok"
        code, body = _get(base + "/readyz")
        assert code == 200 and json.loads(body)["ready"]
        code, body = _get(base + "/metrics")
        assert code == 200
        parse_prometheus(body)
        code, body = _get(base + "/flightrecorder")
        assert code == 200 and "traceEvents" in json.loads(body)
        code, body = _get(base + "/slo")
        assert code == 200 and isinstance(json.loads(body), dict)
        for path in ("/nope", "/router", "/fleet/metrics",
                     "/fleet/healthz"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(base + path)
            assert e.value.code == 404, path
        # starting the server turned recording on; scrapes are metered
        assert metrics.is_enabled()
        snap = metrics.snapshot()
        assert snap["telemetry.scrapes{endpoint=metrics}"]["value"] == 1
        assert snap["telemetry.scrapes{endpoint=fleet_metrics}"][
            "value"] == 1
    finally:
        server.stop()
    assert not server.running
    server.stop()                                   # idempotent


def test_readiness_is_503_while_warming_and_draining(model):
    """The server starts before warmup: /healthz answers and /readyz is
    503 ``warming`` during it; 200 once warm; /metrics serves the
    serve.* families under traffic; 503 ``draining`` the moment the
    drain starts, /metrics still 200 after it; 503 ``preempted`` under
    a preempted GracefulShutdown."""
    from paddle_tpu_torch.distributed.resilience import GracefulShutdown
    from paddle_tpu_torch.inference import Config
    from paddle_tpu_torch.serving import ServingEngine
    seen = {}

    class Probe(ServingEngine):
        def warmup(self):
            base = f"http://127.0.0.1:{self.telemetry.port}"
            seen["healthz"] = _get(base + "/healthz")[0]
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(base + "/readyz")
            seen["readyz"] = (e.value.code,
                              json.loads(e.value.read().decode()))
            return super().warmup()

    eng = Probe(_config(Config, model, telemetry_port=0), poll_every=1)
    server = eng.telemetry
    base = f"http://127.0.0.1:{server.port}"
    try:
        assert seen["healthz"] == 200
        assert seen["readyz"][0] == 503
        assert seen["readyz"][1]["reason"] == "warming"
        code, body = _get(base + "/readyz")
        assert code == 200 and json.loads(body)["warm"]
        assert eng.submit(_prompts()[0]).result(timeout=60).size == MAX_NEW
        parsed = parse_prometheus(_get(base + "/metrics")[1])
        assert parsed["types"]["serve_ttft"] == "histogram"
        assert parsed["samples"][("serve_ttft_count", frozenset())] >= 1
        with GracefulShutdown(exit_on_save=False) as gs:
            gs.trigger()
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(base + "/readyz")
            assert json.loads(e.value.read().decode())["reason"] == \
                "preempted"
        eng.drain()
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base + "/readyz")
        assert e.value.code == 503
        assert json.loads(e.value.read().decode())["reason"] == "draining"
        assert _get(base + "/metrics")[0] == 200
        doc = json.loads(_get(base + "/slo")[1])
        assert doc["top_cost"] and doc["top_cost"][0]["req"] >= 0
    finally:
        eng.shutdown()
    assert not server.running


def test_fixed_port_rebuild_never_crashes_engine(model):
    """A drained predecessor still holds the fixed port: the successor
    serves un-scraped (the bind swallow recorded); once the predecessor
    shut down, the next engine binds the port."""
    from paddle_tpu_torch.core import metrics, monitor
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    first = _engine(model, warmup=False, telemetry_port=port)
    assert first.telemetry is not None and first.telemetry.port == port
    first.drain()
    monitor.enable()
    second = _engine(model, warmup=False, telemetry_port=port)
    assert second.telemetry is None
    assert "errors.swallowed{where=serving.telemetry_bind}" in \
        metrics.snapshot()
    assert second.submit(_prompts()[0]).result(timeout=60).size == MAX_NEW
    second.shutdown()
    first.shutdown()
    assert first.telemetry is None
    third = _engine(model, warmup=False, telemetry_port=port)
    assert third.telemetry is not None and third.telemetry.port == port
    third.shutdown()


def test_scrape_racing_shutdown_never_truncates(model):
    eng = _engine(model, warmup=False, telemetry_port=0)
    port = eng.telemetry.port
    base = f"http://127.0.0.1:{port}"
    stop = threading.Event()
    failures, completed = [], []

    def scraper():
        while not stop.is_set():
            try:
                code, body = _get(base + "/metrics")
            except (urllib.error.URLError, OSError):
                continue   # refused or reset once the listener closed
            if code != 200:
                failures.append(f"status {code}")
                continue
            try:
                parse_prometheus(body)
            except AssertionError as e:
                failures.append(f"unparseable scrape: {e}")
            completed.append(code)

    threads = [threading.Thread(target=scraper, daemon=True)
               for _ in range(4)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 10
    while not completed and time.monotonic() < deadline:
        time.sleep(0.01)
    eng.shutdown()
    stop.set()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert not failures, failures[:5]
    assert completed
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=1).close()


def test_start_from_env(monkeypatch):
    from paddle_tpu_torch.core import telemetry_server
    assert telemetry_server.start_from_env() is None
    monkeypatch.setenv("PADDLE_TELEMETRY_PORT", "not-a-port")
    assert telemetry_server.start_from_env() is None
    monkeypatch.setenv("PADDLE_TELEMETRY_PORT", "0")
    server = telemetry_server.start_from_env()
    try:
        assert server is not None and server.running
        assert server.readiness() == (True, {"ready": True,
                                             "engine": None})
    finally:
        server.stop()


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--oracle":
        _oracle(sys.argv[2])
    else:
        sys.exit(__doc__)
