"""Runtime metrics: a process-global counter/gauge/histogram registry.

The port's copy of the JAX package's ``core/metrics.py``: the same names, schema and
behaviour, kept here because importing the JAX package loads jax.

Reference analog: the reference scatters observability over several C++
singletons — HostEventRecorder counters, memory/stats.h StatRegistry
(paddle.device.cuda.memory_allocated reads it), and the per-collective
stats the Fleet executor keeps. Here one registry serves every subsystem
(jit retraces, collective bytes, dataloader throughput, AMP skips,
device memory), and the profiler drains it into the Chrome trace as
`"ph": "C"` counter events so spans + memory + comm share one timeline.

Design constraints:

- near-zero overhead when disabled: every mutator's first action is a
  plain module-global bool check (no lock, no dict lookup);
- thread-safe when enabled: one lock per metric instance, registry
  creation guarded by a registry lock;
- values survive enable()/disable() cycles — disable stops *recording*,
  it does not zero history (reset() does that explicitly);
- optional time-series sampling while a Profiler records: each mutation
  appends (perf_counter_ns, value) to a bounded ring so the trace shows
  counters evolving, capped so a hot loop can't balloon memory.

The module deliberately imports nothing else of the package — it sits below
every other layer (core.monitor is the instrumentation facade over it;
profiler.metrics re-exports it as the user-facing address).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

_enabled = False      # module-global fast path; read unlocked on purpose
_sampling = False
_SAMPLE_CAP = 16384   # per-metric ring bound while sampling

_registry_lock = threading.Lock()
_metrics: "Dict[str, _Metric]" = {}

# listeners told on enable/disable so facades (core.monitor) can mirror
# the flag into their own module global without importing us on the
# hot path
_listeners: List = []


def _now_ns() -> int:
    return time.perf_counter_ns()


class _Metric:
    kind = "metric"

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._samples: List[Tuple[int, float]] = []

    def _sample(self, value: float):
        # caller holds self._lock
        if _sampling and len(self._samples) < _SAMPLE_CAP:
            self._samples.append((_now_ns(), float(value)))

    def drain_samples(self) -> List[Tuple[int, float]]:
        with self._lock:
            out, self._samples = self._samples, []
        return out


class Counter(_Metric):
    """Monotonic counter (ops, bytes, retraces, skips)."""
    kind = "counter"

    def __init__(self, name: str):
        super().__init__(name)
        self._value = 0

    def inc(self, n: int = 1):
        if not _enabled:
            return
        with self._lock:
            self._value += n
            self._sample(self._value)

    @property
    def value(self) -> int:
        return self._value

    def reset(self):
        with self._lock:
            self._value = 0
            self._samples = []


class Gauge(_Metric):
    """Point-in-time value with a high-water mark (memory, loss scale)."""
    kind = "gauge"

    def __init__(self, name: str):
        super().__init__(name)
        self._value = 0.0
        self._peak = 0.0

    def set(self, v: float):
        if not _enabled:
            return
        with self._lock:
            self._value = float(v)
            if self._value > self._peak:
                self._peak = self._value
            self._sample(self._value)

    def add(self, dv: float):
        if not _enabled:
            return
        with self._lock:
            self._value += float(dv)
            if self._value > self._peak:
                self._peak = self._value
            self._sample(self._value)

    @property
    def value(self) -> float:
        return self._value

    @property
    def peak(self) -> float:
        return self._peak

    def reset_peak(self):
        """Drop the high-water mark to the current value (works even
        while disabled — it is an explicit management call, not a
        hot-path mutation)."""
        with self._lock:
            self._peak = self._value

    def reset(self):
        with self._lock:
            self._value = 0.0
            self._peak = 0.0
            self._samples = []


class Histogram(_Metric):
    """Power-of-two bucketed distribution (batch bytes, span durations).
    Buckets are upper bounds; observations above the last bound land in
    the overflow bucket."""
    kind = "histogram"

    DEFAULT_BOUNDS = tuple(2 ** i for i in range(4, 31, 2))  # 16 .. 1 GiB

    def __init__(self, name: str, bounds: Optional[Tuple[float, ...]] = None):
        super().__init__(name)
        self.bounds = tuple(bounds) if bounds else self.DEFAULT_BOUNDS
        self._counts = [0] * (len(self.bounds) + 1)
        self._count = 0
        self._sum = 0.0

    def observe(self, v: float):
        if not _enabled:
            return
        v = float(v)
        finite = v - v == 0.0  # False for nan/±inf, no math import
        with self._lock:
            self._count += 1
            if finite:
                # a single poisoned observation (nan/inf latency from a
                # broken clock) must not turn _sum/mean — and every
                # /metrics render after it — non-finite forever; the
                # observation still counts (overflow bucket below)
                self._sum += v
            for i, b in enumerate(self.bounds):
                if finite and v <= b:
                    self._counts[i] += 1
                    break
            else:
                self._counts[-1] += 1
            if finite:  # never fabricate a 0.0 sample for poison
                self._sample(v)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def percentile(self, q: float) -> float:
        """Estimate the ``q``-th percentile (0..100) from the bucket
        counts: linear interpolation inside the bucket that holds the
        target rank (lower edge = previous bound, first bucket starts
        at 0). Observations in the overflow bucket clamp to the last
        bound — the estimate is only as fine as the bounds, so latency
        histograms should be created with latency-scaled bounds (the
        serve.* recorders do). Read-side only: never on a hot path.

        Pinned edge cases (a /metrics render must never show NaN/inf):
        empty histogram -> 0.0; q clamped to [0, 100]; all mass in the
        overflow bucket -> the last finite bound; a non-finite bound
        (user-supplied inf sentinel) -> its bucket's lower edge."""
        with self._lock:
            total = self._count
            if not total:
                return 0.0
            target = total * min(max(float(q), 0.0), 100.0) / 100.0
            cum = 0
            lo = 0.0
            for bound, c in zip(self.bounds, self._counts):
                if c and cum + c >= target:
                    if bound - bound != 0.0:  # inf bound: clamp at lo
                        return lo
                    return lo + (bound - lo) * (target - cum) / c
                cum += c
                if bound - bound == 0.0:
                    lo = bound
            return lo  # overflow bucket: clamp at the last finite bound

    def buckets(self) -> Dict[str, int]:
        with self._lock:
            out = {f"le_{b}": c for b, c in zip(self.bounds, self._counts)}
            out["overflow"] = self._counts[-1]
        return out

    def raw(self) -> Tuple[Tuple[float, ...], List[int], int, float]:
        """(bounds, per-bucket counts incl. trailing overflow, count,
        sum) as one consistent snapshot — what the Prometheus text
        renderer cumulates into ``_bucket{le=...}`` lines."""
        with self._lock:
            return self.bounds, list(self._counts), self._count, self._sum

    def reset(self):
        with self._lock:
            self._counts = [0] * (len(self.bounds) + 1)
            self._count = 0
            self._sum = 0.0
            self._samples = []


# ------------------------------------------------------------- registry

def _labeled(name: str, labels: Optional[dict]) -> str:
    if not labels:
        return name
    tag = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{tag}}}"


def _get(name: str, cls, labels=None, **kwargs):
    key = _labeled(name, labels)
    m = _metrics.get(key)
    if m is None:
        with _registry_lock:
            m = _metrics.get(key)
            if m is None:
                m = cls(key, **kwargs)
                _metrics[key] = m
    if not isinstance(m, cls):
        raise TypeError(f"metric {key!r} is a {m.kind}, not "
                        f"{cls.__name__.lower()}")
    return m


def counter(name: str, **labels) -> Counter:
    return _get(name, Counter, labels)


def gauge(name: str, **labels) -> Gauge:
    return _get(name, Gauge, labels)


def histogram(name: str, bounds: Optional[Tuple[float, ...]] = None,
              **labels) -> Histogram:
    h = _get(name, Histogram, labels, bounds=bounds)
    if bounds is not None and tuple(bounds) != h.bounds:
        # registry creation is first-caller-wins; a bounds-less reader
        # (dashboard polling percentile() before traffic) must not pin
        # a latency histogram to the byte-scaled defaults. An EMPTY
        # instance rebinds to the explicit bounds; a populated one
        # under different bounds is a schema conflict — surfaced as a
        # once-per-instance warning, never an exception: this call sits
        # on recording hot paths (the serving scheduler), and telemetry
        # must not crash the thing it measures.
        with h._lock:
            if h._count == 0:
                h.bounds = tuple(bounds)
                h._counts = [0] * (len(h.bounds) + 1)
            elif not getattr(h, "_bounds_conflict_warned", False):
                h._bounds_conflict_warned = True
                import warnings
                warnings.warn(
                    f"histogram {h.name!r} already holds {h._count} "
                    "observations under different bounds; keeping the "
                    "existing bounds (percentiles use the original "
                    "resolution)", stacklevel=2)
    return h


# ------------------------------------------------------------ lifecycle

def enable():
    global _enabled
    _enabled = True
    for fn in list(_listeners):
        fn(True)


def disable():
    global _enabled
    _enabled = False
    for fn in list(_listeners):
        fn(False)


def is_enabled() -> bool:
    return _enabled


def on_state_change(fn):
    """Register fn(enabled: bool), called from enable()/disable(); fires
    immediately with the current state so late registrants sync up."""
    _listeners.append(fn)
    fn(_enabled)
    return fn


def reset():
    """Zero every metric (explicit management call; enable/disable never
    clears history)."""
    with _registry_lock:
        for m in _metrics.values():
            m.reset()


_sampling_depth = 0


def start_sampling():
    """Begin time-series capture. Nests: capture stays ON until every
    start has been matched by a stop, so an inner Profiler cycle cannot
    switch off an outer recorder's capture. Draining is shared, though:
    each stop takes the samples accumulated since the previous drain,
    so with nested recorders the sample stream is split between them
    rather than duplicated."""
    global _sampling, _sampling_depth
    _sampling_depth += 1
    _sampling = True


def is_sampling() -> bool:
    return _sampling


def stop_sampling() -> Dict[str, List[Tuple[int, float]]]:
    """Drain every metric's samples ({name: [(perf_counter_ns, value)]})
    and, when this stop matches the outermost start, turn capture off."""
    global _sampling, _sampling_depth
    _sampling_depth = max(0, _sampling_depth - 1)
    if _sampling_depth == 0:
        _sampling = False
    with _registry_lock:
        metrics = list(_metrics.values())
    out = {}
    for m in metrics:
        s = m.drain_samples()
        if s:
            out[m.name] = s
    return out


def _reset_for_tests() -> None:
    """Forget every metric (keys included) and stop sampling: what a
    test that compares whole snapshots starts from. ``reset()`` keeps
    the keys and zeroes their values."""
    global _sampling, _sampling_depth
    with _registry_lock:
        _metrics.clear()
    _sampling = False
    _sampling_depth = 0


def all_metrics() -> Dict[str, _Metric]:
    """Consistent copy of the live registry ({labeled name -> metric
    instance}) — the read surface the telemetry server renders from
    (snapshot() flattens histograms; the renderer needs their raw
    bounds)."""
    with _registry_lock:
        return dict(_metrics)


def snapshot() -> Dict[str, dict]:
    """Point-in-time view of the whole registry, cheap enough to call
    per epoch: {name: {kind, value, ...}}."""
    with _registry_lock:
        metrics = list(_metrics.items())
    out = {}
    for name, m in metrics:
        if isinstance(m, Counter):
            out[name] = {"kind": "counter", "value": m.value}
        elif isinstance(m, Gauge):
            out[name] = {"kind": "gauge", "value": m.value, "peak": m.peak}
        elif isinstance(m, Histogram):
            out[name] = {"kind": "histogram", "count": m.count,
                         "sum": m.sum, "mean": m.mean,
                         "buckets": m.buckets()}
    return out


def _metric_state(m) -> dict:
    """One metric's mergeable wire state (what ``snapshot_delta``
    diffs and the fleet aggregator applies): histograms carry raw
    bounds/counts arrays, not the display-shaped ``buckets()`` dict."""
    if isinstance(m, Counter):
        return {"kind": "counter", "value": m.value}
    if isinstance(m, Gauge):
        return {"kind": "gauge", "value": m.value, "peak": m.peak}
    bounds, counts, count, total = m.raw()
    return {"kind": "histogram", "bounds": list(bounds),
            "counts": counts, "count": count, "sum": total}


def snapshot_delta(prev: Optional[Dict[str, dict]] = None):
    """Delta-encoded registry snapshot for cross-process publishing:
    returns ``(state, delta)`` where ``state`` is the full mergeable
    view (feed it back as ``prev`` next time) and ``delta`` is the
    wire payload — ``{"full": bool, "metrics": {...}}``.

    With ``prev=None`` the delta IS the full state (a new subscriber's
    baseline). Otherwise each entry carries only what changed since
    ``prev``: counters a ``{"d": increment}``, histograms per-bucket
    count increments + ``d_count``/``d_sum``, gauges their absolute
    ``value``/``peak`` (gauges don't accumulate). Unchanged metrics
    are omitted — the steady-state payload of a quiet process is near
    empty. A metric that went BACKWARDS (an explicit ``reset()``, or
    a histogram re-bound) is re-sent absolute, so an aggregator
    applying the delta can never drift negative."""
    state = {key: _metric_state(m) for key, m in all_metrics().items()}
    if prev is None:
        return state, {"full": True, "metrics": state}
    out: Dict[str, dict] = {}
    for key, cur in state.items():
        old = prev.get(key)
        if old is None or old.get("kind") != cur["kind"]:
            out[key] = cur
            continue
        kind = cur["kind"]
        if kind == "counter":
            d = cur["value"] - old["value"]
            if d < 0:
                out[key] = cur          # reset: re-baseline absolute
            elif d:
                out[key] = {"kind": "counter", "d": d}
        elif kind == "gauge":
            if cur["value"] != old["value"] or cur["peak"] != old["peak"]:
                out[key] = cur          # gauges publish absolute
        else:
            if cur["bounds"] != old["bounds"]:
                out[key] = cur          # re-bound: absolute
                continue
            d_counts = [c - o for c, o in zip(cur["counts"],
                                              old["counts"])]
            d_count = cur["count"] - old["count"]
            if d_count < 0 or any(d < 0 for d in d_counts):
                out[key] = cur          # reset: absolute
            elif d_count or cur["sum"] != old["sum"]:
                out[key] = {"kind": "histogram",
                            "d_counts": d_counts, "d_count": d_count,
                            "d_sum": cur["sum"] - old["sum"]}
    return state, {"full": False, "metrics": out}


def apply_delta(state: Dict[str, dict], delta: dict) -> Dict[str, dict]:
    """Apply one ``snapshot_delta`` wire payload to a mergeable state
    dict (the aggregator side). A ``full`` payload replaces the state
    outright; absolute per-metric records replace their entry; ``d``/
    ``d_counts`` records accumulate. Returns the updated state (the
    input dict, mutated)."""
    if delta.get("full"):
        state.clear()
        state.update({k: dict(v) for k, v in delta["metrics"].items()})
        return state
    for key, rec in delta["metrics"].items():
        cur = state.get(key)
        if "d" not in rec and "d_counts" not in rec:
            state[key] = dict(rec)      # absolute record replaces
        elif cur is None:
            # a delta for a metric we never saw absolute: a payload
            # was missed — drop it; the caller requests a resync and
            # the next full publish re-baselines this key
            continue
        elif rec["kind"] == "counter":
            cur["value"] += rec["d"]
        else:
            cur["counts"] = [c + d for c, d in zip(cur["counts"],
                                                   rec["d_counts"])]
            cur["count"] += rec["d_count"]
            cur["sum"] += rec["d_sum"]
    return state


def state_metric(key: str, rec: dict) -> _Metric:
    """Materialize one mergeable-state record back into a metric
    instance (what ``prometheus_text`` renders) — the fleet
    aggregator's bridge from wire state to the exposition format."""
    if rec["kind"] == "counter":
        m = Counter(key)
        m._value = rec["value"]
    elif rec["kind"] == "gauge":
        m = Gauge(key)
        m._value = float(rec["value"])
        m._peak = float(rec.get("peak", rec["value"]))
    else:
        m = Histogram(key, bounds=tuple(rec["bounds"]))
        m._counts = list(rec["counts"])
        m._count = int(rec["count"])
        m._sum = float(rec["sum"])
    return m


class Registry:
    """Facade object over the module-global registry — the handle the
    fleet-telemetry publisher holds (``snapshot_delta`` with its own
    ``prev`` state per publisher, reads through the same module
    functions everything else uses)."""

    counter = staticmethod(counter)
    gauge = staticmethod(gauge)
    histogram = staticmethod(histogram)
    all_metrics = staticmethod(all_metrics)
    snapshot = staticmethod(snapshot)
    snapshot_delta = staticmethod(snapshot_delta)
    apply_delta = staticmethod(apply_delta)


REGISTRY = Registry()


def report(prefix: str = "") -> str:
    """Plain-text dump of the registry (one line per metric), optionally
    filtered by name prefix."""
    snap = snapshot()
    lines = []
    for name in sorted(snap):
        if prefix and not name.startswith(prefix):
            continue
        d = snap[name]
        if d["kind"] == "counter":
            lines.append(f"{name} = {d['value']}")
        elif d["kind"] == "gauge":
            lines.append(f"{name} = {d['value']:g} (peak {d['peak']:g})")
        else:
            lines.append(f"{name}: count={d['count']} mean={d['mean']:g}")
    return "\n".join(lines)
