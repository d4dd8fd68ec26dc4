"""In-process time-series history: a bounded ring of registry snapshots.

The port's copy of the JAX package's ``core/timeseries.py``: the same names, schema and
behaviour, kept here because importing the JAX package loads jax.

The metrics registry (``core.metrics``) only ever answers "what is the
value *now*" — cumulative counters and histogram buckets since process
start. Nothing in the tree could answer "what was the TTFT p99 over the
last five minutes" or "how fast is the error counter moving", which is
exactly what burn-rate SLO evaluation (``core.slo``) needs.

This module keeps a ring of periodic snapshots of the registry's
mergeable state (the same ``snapshot_delta`` representation the fleet
publisher wires over the TCPStore) and derives windowed signals on the
read side:

    rate(name, window)                counter increments / second
    delta(name, window)               counter increments over the window
    hist_delta(name, window)          histogram bucket deltas
    hist_percentile_over(name, q, w)  percentile of the window's
                                      observations, interpolated from
                                      cumulative bucket deltas

Memory stays bounded two ways: the ring holds at most ``retention``
entries, and consecutive entries share the per-metric record dicts of
every metric that did not change between samples (the delta encoding
from the fleet publisher, applied in-memory) — an idle process's ring
is a list of pointers to one snapshot.

The record path is zero-alloc: ``maybe_sample()`` is a couple of
attribute reads and a float compare until a period boundary passes
(gated in ``tests/test_overhead_gate.py``); the actual snapshot runs at
most once per ``period_s``.

Knobs: ``PADDLE_TS_PERIOD_S`` (sample period, seconds, default 1.0;
``<= 0`` disables the shared ring), ``PADDLE_TS_RETENTION`` (ring
capacity in snapshots, default 600 — ten minutes of history at the
default period).
"""
from __future__ import annotations

import collections
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from . import metrics

DEFAULT_PERIOD_S = 1.0
DEFAULT_RETENTION = 600


def _split_key(key: str) -> Tuple[str, Dict[str, str]]:
    """``"name{k=v,k2=v2}"`` -> (base name, label dict)."""
    if key.endswith("}") and "{" in key:
        base, _, rest = key.partition("{")
        labels = dict(p.split("=", 1) for p in rest[:-1].split(",") if p)
        return base, labels
    return key, {}


def _matches(key: str, want_base: str, want_labels: Dict[str, str]) -> bool:
    base, labels = _split_key(key)
    if base != want_base:
        return False
    for k, v in want_labels.items():
        if labels.get(k) != v:
            return False
    return True


def percentile_of(bounds, counts, total, q: float) -> float:
    """``Histogram.percentile`` over raw (bounds, counts, total) —
    the same linear interpolation and pinned edge cases, usable on
    windowed bucket *deltas* where no Histogram object exists."""
    if not total:
        return 0.0
    target = total * min(max(float(q), 0.0), 100.0) / 100.0
    cum = 0
    lo = 0.0
    for bound, c in zip(bounds, counts):
        if c and cum + c >= target:
            if bound - bound != 0.0:  # inf bound: clamp at lo
                return lo
            return lo + (bound - lo) * (target - cum) / c
        cum += c
        if bound - bound == 0.0:
            lo = bound
    return lo  # overflow bucket: clamp at the last finite bound


def fraction_above(bounds, counts, total, threshold: float) -> float:
    """Fraction of the observations behind (bounds, counts, total)
    that exceeded ``threshold``, interpolating inside the bucket that
    straddles it — the "bad events" numerator of a latency SLO."""
    if not total:
        return 0.0
    x = float(threshold)
    cum_le = 0.0
    lo = 0.0
    for bound, c in zip(bounds, counts):
        if bound - bound != 0.0:  # inf bound: everything here is above x
            break
        if x >= bound:
            cum_le += c
            lo = bound
            continue
        if x > lo and c:
            cum_le += c * (x - lo) / (bound - lo)
        break
    return max(0.0, min(1.0, 1.0 - cum_le / total))


class TimeSeriesRing:
    """Bounded ring of (t, mergeable-state) snapshots with windowed
    read-side queries. All query windows anchor at the NEWEST snapshot
    (not wall now) so replayed synthetic traces evaluate
    deterministically."""

    def __init__(self, period_s: Optional[float] = None,
                 retention: Optional[int] = None):
        if period_s is None:
            period_s = float(os.environ.get("PADDLE_TS_PERIOD_S",
                                            DEFAULT_PERIOD_S))
        if retention is None:
            retention = int(os.environ.get("PADDLE_TS_RETENTION",
                                           DEFAULT_RETENTION))
        self.disabled = period_s <= 0 or retention <= 0
        self.period_s = max(period_s, 1e-3) if not self.disabled else 0.0
        self.retention = max(int(retention), 2) if not self.disabled else 2
        self._entries: collections.deque = collections.deque(
            maxlen=self.retention)
        self._prev: Optional[Dict[str, dict]] = None
        self._next_due = 0.0  # monotonic; 0 -> first maybe_sample fires
        self._lock = threading.Lock()

    # ------------------------------------------------------ record side

    def maybe_sample(self, now: Optional[float] = None) -> bool:
        """Snapshot the process registry if a period boundary passed.
        The common case — not due — is a few attribute reads and one
        compare (zero-alloc; gated in test_overhead_gate)."""
        if self.disabled:
            return False
        t = time.monotonic() if now is None else now
        if t < self._next_due:
            return False
        self.sample(t)
        return True

    def sample(self, now: Optional[float] = None) -> None:
        """Unconditionally snapshot the process registry at time
        ``now`` (monotonic seconds; defaults to the real clock)."""
        t = time.monotonic() if now is None else now
        with self._lock:
            state, delta = metrics.snapshot_delta(self._prev)
            if self._prev is not None and not delta.get("full"):
                changed = delta["metrics"]
                prev = self._prev
                # share the record dicts of unchanged metrics with the
                # previous snapshot: an idle window costs one dict of
                # pointers, not a deep copy of the registry
                state = {k: (prev[k] if k not in changed and k in prev
                             else v) for k, v in state.items()}
            self._prev = state
            self._entries.append((t, state))
            self._next_due = t + self.period_s

    def sample_state(self, state: Dict[str, dict],
                     now: Optional[float] = None) -> None:
        """Append a pre-built mergeable state (``metrics.snapshot()``
        shape) — the fleet aggregator feeds its merged per-rank view
        through this. The caller must not mutate ``state`` afterwards."""
        t = time.monotonic() if now is None else now
        with self._lock:
            self._prev = None  # foreign state: no delta baseline
            self._entries.append((t, dict(state)))
            self._next_due = t + self.period_s

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._prev = None
            self._next_due = 0.0

    # -------------------------------------------------------- read side

    def __len__(self) -> int:
        return len(self._entries)

    def span(self) -> Optional[Tuple[float, float]]:
        """(oldest t, newest t) or None if fewer than 2 snapshots."""
        with self._lock:
            if len(self._entries) < 2:
                return None
            return self._entries[0][0], self._entries[-1][0]

    def _window(self, window_s: float):
        """(t_a, state_a, t_b, state_b): newest snapshot and the most
        recent one at least ``window_s`` older (oldest available if the
        ring doesn't reach back that far). None if < 2 snapshots."""
        if len(self._entries) < 2:
            return None
        entries = list(self._entries)
        t_b, state_b = entries[-1]
        cutoff = t_b - float(window_s)
        t_a, state_a = entries[0]
        for t, state in entries[:-1]:
            if t <= cutoff + 1e-9:
                t_a, state_a = t, state
            else:
                break
        if t_b <= t_a:
            return None
        return t_a, state_a, t_b, state_b

    @staticmethod
    def _scalar(rec: Optional[dict]) -> float:
        if rec is None:
            return 0.0
        if rec.get("kind") == "histogram":
            return float(rec.get("count", 0))
        return float(rec.get("value", 0.0))

    def _delta_span(self, name: str, window_s: float):
        """(summed increments, actual span seconds) or None — one
        consistent locked pass for delta() and rate()."""
        want_base, want_labels = _split_key(name)
        with self._lock:
            win = self._window(window_s)
            if win is None:
                return None
            t_a, state_a, t_b, state_b = win
            total = 0.0
            seen = False
            for key, rec_b in state_b.items():
                if rec_b.get("kind") == "gauge":
                    continue
                if not _matches(key, want_base, want_labels):
                    continue
                seen = True
                total += self._scalar(rec_b) - self._scalar(state_a.get(key))
            if not seen:
                return None
            return total, t_b - t_a

    def delta(self, name: str, window_s: float) -> Optional[float]:
        """Sum of counter increments (histogram: observation count)
        over the window, across every series matching ``name`` —
        ``name`` may carry labels (``"serve.requests{status=failed}"``)
        which match as a subset, so an unlabeled name sums all its
        labeled series."""
        ds = self._delta_span(name, window_s)
        return None if ds is None else ds[0]

    def rate(self, name: str, window_s: float) -> Optional[float]:
        """``delta / actual window span`` — increments per second."""
        ds = self._delta_span(name, window_s)
        return None if ds is None else ds[0] / ds[1]

    def latest(self, name: str) -> Optional[float]:
        """Newest snapshot's value of the first series matching
        ``name`` (gauge/counter value; histogram count)."""
        want_base, want_labels = _split_key(name)
        with self._lock:
            if not self._entries:
                return None
            _, state = self._entries[-1]
            for key, rec in state.items():
                if _matches(key, want_base, want_labels):
                    return self._scalar(rec)
        return None

    def hist_delta(self, name: str, window_s: float):
        """(bounds, bucket-count deltas incl. overflow, count delta,
        sum delta) of the window's observations, summed across every
        histogram series matching ``name``. Series whose bounds changed
        mid-window (re-bound deploy) restart from zero at the new
        bounds. None if no matching histogram or < 2 snapshots."""
        want_base, want_labels = _split_key(name)
        with self._lock:
            win = self._window(window_s)
            if win is None:
                return None
            _, state_a, _, state_b = win
            bounds = None
            d_counts: List[float] = []
            d_count = 0
            d_sum = 0.0
            for key, rec_b in state_b.items():
                if rec_b.get("kind") != "histogram":
                    continue
                if not _matches(key, want_base, want_labels):
                    continue
                b_bounds = tuple(rec_b.get("bounds", ()))
                if bounds is None:
                    bounds = b_bounds
                    d_counts = [0.0] * (len(bounds) + 1)
                elif b_bounds != bounds:
                    continue  # mixed bounds across label sets: skip
                rec_a = state_a.get(key)
                if rec_a is None or rec_a.get("kind") != "histogram" or \
                        tuple(rec_a.get("bounds", ())) != bounds:
                    rec_a = None  # (re)appeared mid-window: from zero
                counts_b = rec_b.get("counts", ())
                counts_a = rec_a.get("counts", ()) if rec_a else ()
                for i, c in enumerate(counts_b):
                    prev = counts_a[i] if i < len(counts_a) else 0
                    if i < len(d_counts):
                        d_counts[i] += c - prev
                d_count += rec_b.get("count", 0) - \
                    (rec_a.get("count", 0) if rec_a else 0)
                d_sum += rec_b.get("sum", 0.0) - \
                    (rec_a.get("sum", 0.0) if rec_a else 0.0)
            if bounds is None:
                return None
            return bounds, d_counts, d_count, d_sum

    def hist_percentile_over(self, name: str, q: float,
                             window_s: float) -> Optional[float]:
        """Percentile of the observations that landed in the window,
        interpolated from cumulative bucket deltas (the windowed
        counterpart of ``Histogram.percentile``)."""
        hd = self.hist_delta(name, window_s)
        if hd is None:
            return None
        bounds, d_counts, d_count, _ = hd
        if d_count <= 0:
            return None
        return percentile_of(bounds, d_counts, d_count, q)

    def hist_fraction_above(self, name: str, threshold: float,
                            window_s: float) -> Optional[float]:
        """Fraction of the window's observations above ``threshold``
        (sub-bucket interpolated) — the latency-SLO bad fraction."""
        hd = self.hist_delta(name, window_s)
        if hd is None:
            return None
        bounds, d_counts, d_count, _ = hd
        if d_count <= 0:
            return None
        return fraction_above(bounds, d_counts, d_count, threshold)


# ------------------------------------------------- process-global ring

_ring: Optional[TimeSeriesRing] = None
_ring_lock = threading.Lock()


def ring() -> TimeSeriesRing:
    """The process-global ring (created from the PADDLE_TS_* env on
    first use). A disabled ring (period <= 0) still answers queries on
    explicitly fed samples; only maybe_sample() becomes a no-op."""
    global _ring
    r = _ring
    if r is None:
        with _ring_lock:
            if _ring is None:
                _ring = TimeSeriesRing()
            r = _ring
    return r


def maybe_sample(now: Optional[float] = None) -> bool:
    """Module fast path: sample the global ring if a period elapsed."""
    r = _ring
    if r is None:
        r = ring()
    return r.maybe_sample(now)


def _reset_for_tests() -> None:
    global _ring
    with _ring_lock:
        _ring = None
