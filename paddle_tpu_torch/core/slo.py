"""SLO watchtower: burn-rate evaluation over the time-series ring.

The port's copy of the JAX package's ``core/slo.py``: the same names, schema and
behaviour, kept here because importing the JAX package loads jax.

``core.timeseries`` answers "what happened over the last N seconds";
this module decides whether that is *acceptable*. Each declarative
:class:`SLO` spec names a metric family, an objective, and a window
pair, and is reduced to one normalized signal — the **error-budget
burn rate**: the fraction of events that violated the objective,
divided by the budget the objective leaves (1% for a p99). Burn 1.0
means the budget is being spent exactly as fast as it accrues; 10
means a 10x burst is eating it ten times too fast.

Multi-window rule (the SRE-workbook shape): an alert needs BOTH a
fast window (reacts in seconds, noisy) and a slow window (confirms the
burn is sustained) above 1.0 to fire. The per-SLO state machine:

    ok ──fast>1──> pending ──fast&slow>1──> firing ──fast<=1──> resolved
         (fast cools first: pending quietly returns to ok)

Every transition emits a flight-recorder event (``slo.pending`` /
``slo.firing`` / ``slo.resolved``), bumps ``slo.transitions``, and
appends to a bounded alert history that ``/slo`` (telemetry server)
serves and ``tools/slo_report.py`` renders post-mortem. Evaluation is
driven by :func:`tick` from the serving poll loop and the fit loop —
at most once per ring sample period.

A second scope ("fleet") runs the same specs over the aggregator's
merged per-rank snapshots in ``distributed/fleet_telemetry.py``; the
:class:`StragglerDetector` below consumes the same fleet plane.

Knobs (all ``PADDLE_SLO_*``; a value of ``off`` disables that SLO):
``PADDLE_SLO_TTFT_P99`` (s, default 0.5), ``PADDLE_SLO_TOKEN_P99``
(s, default 0.1), ``PADDLE_SLO_ERROR_RATE`` (fraction, default 0.01),
``PADDLE_SLO_GOODPUT_COMPUTE`` (min compute fraction, default 0.2),
``PADDLE_SLO_STEP_TIME_P99`` (s, default 1.0),
``PADDLE_SLO_WINDOW_S`` / ``PADDLE_SLO_FAST_WINDOW_S`` (evaluation
windows, default 300 / 60).
"""
from __future__ import annotations

import collections
import dataclasses
import os
import threading
from typing import Dict, List, Optional, Tuple

from . import flight_recorder, monitor, timeseries

# alert states (gauge encoding for slo.state)
OK, PENDING, FIRING, RESOLVED = "ok", "pending", "firing", "resolved"
_STATE_CODE = {OK: 0, PENDING: 1, FIRING: 2, RESOLVED: 0}

HISTORY_LIMIT = 256


@dataclasses.dataclass(frozen=True)
class SLO:
    """One declarative objective.

    kind:
      * ``latency`` — ``metric`` is a cumulative histogram; objective
        is the max acceptable value at ``percentile``. Bad fraction =
        fraction of the window's observations above the objective
        (sub-bucket interpolated); budget = 1 - percentile/100.
      * ``error_rate`` — bad fraction = sum(bad_metrics deltas) /
        sum(total_metrics deltas); budget = objective.
      * ``fraction_min`` — ``good_metric`` over ``metric`` (both
        counter deltas) must stay >= objective; bad fraction = 1 -
        measured; budget = 1 - objective.
    """
    name: str
    kind: str
    metric: str
    objective: float
    window_s: float = 300.0
    fast_window_s: float = 60.0
    percentile: float = 99.0
    bad_metrics: Tuple[str, ...] = ()
    total_metrics: Tuple[str, ...] = ()
    good_metric: str = ""

    @property
    def budget(self) -> float:
        if self.kind == "latency":
            return max(1.0 - self.percentile / 100.0, 1e-6)
        if self.kind == "error_rate":
            return max(self.objective, 1e-6)
        return max(1.0 - self.objective, 1e-6)

    def measure(self, ring: "timeseries.TimeSeriesRing",
                window_s: float):
        """(measured value, bad fraction) over the window, or None if
        the ring has no evidence for this metric yet."""
        if self.kind == "latency":
            hd = ring.hist_delta(self.metric, window_s)
            if hd is None:
                return None
            bounds, d_counts, d_count, _ = hd
            if d_count <= 0:
                return None
            measured = timeseries.percentile_of(
                bounds, d_counts, d_count, self.percentile)
            bad = timeseries.fraction_above(
                bounds, d_counts, d_count, self.objective)
            return measured, bad
        if self.kind == "error_rate":
            total = 0.0
            seen = False
            for m in self.total_metrics:
                d = ring.delta(m, window_s)
                if d is not None:
                    total += d
                    seen = True
            if not seen or total <= 0:
                return None
            bad_n = sum(ring.delta(m, window_s) or 0.0
                        for m in self.bad_metrics)
            measured = max(0.0, bad_n) / total
            return measured, measured
        # fraction_min
        den = ring.delta(self.metric, window_s)
        if den is None or den <= 0:
            return None
        num = ring.delta(self.good_metric, window_s) or 0.0
        measured = max(0.0, min(1.0, num / den))
        return measured, 1.0 - measured

    def burn(self, bad_fraction: float) -> float:
        return bad_fraction / self.budget


def _env_objective(var: str, default: float) -> Optional[float]:
    raw = os.environ.get(var, "").strip().lower()
    if raw in ("off", "none", "disabled"):
        return None
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def default_slos() -> List[SLO]:
    """The stock objectives (env-tunable; ``off`` drops one)."""
    window = float(os.environ.get("PADDLE_SLO_WINDOW_S", 300.0))
    fast = float(os.environ.get("PADDLE_SLO_FAST_WINDOW_S", 60.0))
    out: List[SLO] = []

    def add(slo):
        out.append(dataclasses.replace(slo, window_s=window,
                                       fast_window_s=fast))

    obj = _env_objective("PADDLE_SLO_TTFT_P99", 0.5)
    if obj is not None:
        add(SLO("serve-ttft-p99", "latency", "serve.ttft", obj))
    obj = _env_objective("PADDLE_SLO_TOKEN_P99", 0.1)
    if obj is not None:
        add(SLO("serve-token-p99", "latency", "serve.token_latency", obj))
    obj = _env_objective("PADDLE_SLO_ERROR_RATE", 0.01)
    if obj is not None:
        # totals enumerate the labeled terminal statuses: the unlabeled
        # serve.requests series double-counts (recorders bump both)
        add(SLO("serve-error-rate", "error_rate", "serve.requests", obj,
                bad_metrics=("serve.requests{status=cancelled}",
                             "serve.requests{status=rejected}"),
                total_metrics=("serve.requests{status=completed}",
                               "serve.requests{status=cancelled}",
                               "serve.requests{status=rejected}")))
    obj = _env_objective("PADDLE_SLO_GOODPUT_COMPUTE", 0.2)
    if obj is not None:
        add(SLO("serve-goodput-compute", "fraction_min",
                "serve.goodput.seconds", obj,
                good_metric="serve.goodput.seconds{bucket=compute}"))
    obj = _env_objective("PADDLE_SLO_STEP_TIME_P99", 1.0)
    if obj is not None:
        add(SLO("train-step-p99", "latency", "train.step_time", obj))
    return out


class _AlertState:
    __slots__ = ("state", "since", "since_ns", "burn_fast", "burn_slow",
                 "measured", "transitions")

    def __init__(self):
        self.state = OK
        self.since: Optional[float] = None
        self.since_ns: Optional[int] = None
        self.burn_fast = 0.0
        self.burn_slow = 0.0
        self.measured: Optional[float] = None
        self.transitions = 0


class SLOEvaluator:
    """Drives every spec's burn-rate state machine over one ring.

    ``scope`` labels the emitted metrics/events: "process" for the
    in-process watchtower, "fleet" for the aggregator's merged view."""

    def __init__(self, ring: "timeseries.TimeSeriesRing",
                 slos: Optional[List[SLO]] = None, scope: str = "process"):
        self.ring = ring
        self.slos = list(slos) if slos is not None else default_slos()
        self.scope = scope
        self._st: Dict[str, _AlertState] = {
            s.name: _AlertState() for s in self.slos}
        self.history: collections.deque = collections.deque(
            maxlen=HISTORY_LIMIT)
        self._lock = threading.Lock()

    # ------------------------------------------------------- evaluation

    def _transition(self, slo: SLO, st: _AlertState, to: str,
                    now: float):
        prev = st.state
        st.state = to
        st.transitions += 1
        now_ns = flight_recorder.now_ns()
        event = {PENDING: "slo.pending", FIRING: "slo.firing",
                 RESOLVED: "slo.resolved"}.get(to)
        if event is not None:
            fields = dict(slo=slo.name, scope=self.scope,
                          burn_fast=round(st.burn_fast, 4),
                          burn_slow=round(st.burn_slow, 4))
            if st.measured is not None:
                fields["measured"] = round(st.measured, 6)
            if to == RESOLVED and st.since is not None:
                fields["firing_s"] = round(now - st.since, 3)
            flight_recorder.record(event, **fields)
        if to == FIRING and st.since_ns is not None:
            # the pending->firing escalation as a span, so a mid-fire
            # post-mortem dump shows the alert's build-up window
            flight_recorder.record_span(
                f"slo:{slo.name}", st.since_ns, now_ns,
                scope=self.scope, phase="escalation")
        if to == RESOLVED and st.since_ns is not None:
            flight_recorder.record_span(
                f"slo:{slo.name}", st.since_ns, now_ns,
                scope=self.scope, phase="firing")
        st.since = now
        st.since_ns = now_ns
        monitor.record_slo_transition(self.scope, slo.name, to)
        self.history.append({
            "t": now, "slo": slo.name, "from": prev, "to": to,
            "burn_fast": st.burn_fast, "burn_slow": st.burn_slow,
            "measured": st.measured})

    def evaluate(self, now: Optional[float] = None) -> Dict[str, str]:
        """One evaluation pass over every spec; returns name->state."""
        if now is None:
            span = self.ring.span()
            now = span[1] if span else 0.0
        with self._lock:
            for slo in self.slos:
                st = self._st[slo.name]
                fast = slo.measure(self.ring, slo.fast_window_s)
                slow = slo.measure(self.ring, slo.window_s)
                st.burn_fast = slo.burn(fast[1]) if fast else 0.0
                st.burn_slow = slo.burn(slow[1]) if slow else 0.0
                st.measured = fast[0] if fast else None
                if st.burn_fast > 1.0 and st.burn_slow > 1.0:
                    target = FIRING
                elif st.burn_fast > 1.0:
                    target = PENDING
                else:
                    target = OK
                cur = st.state
                if cur in (OK, RESOLVED):
                    if target in (PENDING, FIRING):
                        self._transition(slo, st, target, now)
                elif cur == PENDING:
                    if target == FIRING:
                        self._transition(slo, st, FIRING, now)
                    elif target == OK:
                        self._transition(slo, st, OK, now)
                elif cur == FIRING:
                    if target == OK:
                        self._transition(slo, st, RESOLVED, now)
                monitor.record_slo_state(self.scope, slo.name,
                                         _STATE_CODE[st.state])
                monitor.record_slo_burn_rate(self.scope, slo.name,
                                             "fast", st.burn_fast)
                monitor.record_slo_burn_rate(self.scope, slo.name,
                                             "slow", st.burn_slow)
            return {s.name: self._st[s.name].state for s in self.slos}

    # ------------------------------------------------------- read side

    def states(self) -> Dict[str, str]:
        with self._lock:
            return {name: st.state for name, st in self._st.items()}

    def report(self) -> dict:
        """The ``/slo`` document body for this scope."""
        with self._lock:
            slos = []
            for slo in self.slos:
                st = self._st[slo.name]
                slos.append({
                    "name": slo.name, "kind": slo.kind,
                    "metric": slo.metric, "objective": slo.objective,
                    "percentile": slo.percentile,
                    "window_s": slo.window_s,
                    "fast_window_s": slo.fast_window_s,
                    "state": st.state, "since": st.since,
                    "burn_fast": st.burn_fast,
                    "burn_slow": st.burn_slow,
                    "measured": st.measured,
                })
            return {"scope": self.scope, "slos": slos,
                    "alerts": list(self.history)}


# --------------------------------------------------- straggler detector

class StragglerDetector:
    """Robust cross-rank step-time outlier detector.

    Fed cumulative per-rank ``train.step_time`` (count, sum) pairs each
    fleet poll; diffs them into windowed mean step times and flags any
    rank whose robust z-score — ``(mean - median) / scale`` with
    ``scale = max(1.4826*MAD, 5% of median)`` — exceeds ``z_threshold``
    on the slow side. The flag latches (one ``train.straggler``
    detected event per episode) and clears with hysteresis at
    ``clear_z``."""

    def __init__(self, z_threshold: float = 3.5,
                 clear_z: Optional[float] = None, min_ranks: int = 3):
        self.z_threshold = float(z_threshold)
        self.clear_z = float(clear_z) if clear_z is not None \
            else self.z_threshold / 2.0
        self.min_ranks = int(min_ranks)
        self._last: Dict[int, Tuple[float, float]] = {}
        self._flagged: Dict[int, dict] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _median(vals: List[float]) -> float:
        s = sorted(vals)
        n = len(s)
        mid = n // 2
        return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])

    def observe(self, totals: Dict[int, Tuple[float, float]],
                now: Optional[float] = None) -> List[dict]:
        """One fleet poll's cumulative (count, sum) per rank. Returns
        the transitions that happened (dicts with rank/phase/z)."""
        events: List[dict] = []
        with self._lock:
            means: Dict[int, float] = {}
            for rank, (count, total_s) in totals.items():
                pc, ps = self._last.get(rank, (0.0, 0.0))
                dc, ds = count - pc, total_s - ps
                if dc < 0 or ds < 0:  # restarted rank: counters reset
                    dc, ds = count, total_s
                self._last[rank] = (count, total_s)
                if dc > 0:
                    means[rank] = ds / dc
            if len(means) < self.min_ranks:
                return events
            med = self._median(list(means.values()))
            mad = self._median([abs(v - med) for v in means.values()])
            scale = max(1.4826 * mad, 0.05 * med, 1e-9)
            for rank, mean in means.items():
                z = (mean - med) / scale
                flagged = rank in self._flagged
                if not flagged and z > self.z_threshold:
                    info = {"rank": rank, "phase": "detected",
                            "z": round(z, 2), "mean_s": mean,
                            "median_s": med, "since": now}
                    self._flagged[rank] = info
                    events.append(info)
                    flight_recorder.record(
                        "train.straggler", rank=rank, phase="detected",
                        z=round(z, 2), mean_s=round(mean, 6),
                        median_s=round(med, 6))
                    monitor.record_straggler(rank)
                elif flagged and z < self.clear_z:
                    del self._flagged[rank]
                    info = {"rank": rank, "phase": "resolved",
                            "z": round(z, 2), "mean_s": mean,
                            "median_s": med, "since": now}
                    events.append(info)
                    flight_recorder.record(
                        "train.straggler", rank=rank, phase="resolved",
                        z=round(z, 2), mean_s=round(mean, 6),
                        median_s=round(med, 6))
        return events

    def straggler_ranks(self) -> List[int]:
        with self._lock:
            return sorted(self._flagged)

    def flags(self) -> Dict[int, dict]:
        with self._lock:
            return {r: dict(i) for r, i in self._flagged.items()}


# ------------------------------------------------- process watchtower

_watchtower: Optional[SLOEvaluator] = None
_watchtower_lock = threading.Lock()


def watchtower() -> SLOEvaluator:
    """The process-scope evaluator over the global time-series ring."""
    global _watchtower
    w = _watchtower
    if w is None:
        with _watchtower_lock:
            if _watchtower is None:
                _watchtower = SLOEvaluator(timeseries.ring(),
                                           scope="process")
            w = _watchtower
    return w


def tick(now: Optional[float] = None) -> bool:
    """The record-path hook (serving poll loop, fit loop): sample the
    ring if a period elapsed, and evaluate every SLO on fresh samples.
    Costs one enabled check + one float compare when not due."""
    if not monitor.enabled:
        return False
    if not timeseries.maybe_sample(now):
        return False
    watchtower().evaluate(now)
    return True


def report() -> dict:
    """The process-scope ``/slo`` body (used by the telemetry server)."""
    return watchtower().report()


def _reset_for_tests() -> None:
    global _watchtower
    with _watchtower_lock:
        _watchtower = None
