"""Goodput accounting: a step-time ledger that decomposes wall time
into named buckets — where did the seconds actually go?

The port's copy of the JAX package's ``core/goodput.py``: the same names, schema and
behaviour, kept here because importing the JAX package loads jax.

Reference analog: the reference's fleet controllers track per-stage
timings (data feed vs op run vs communication) through the profiler's
statistic views; cluster operators, though, need ONE number per job —
goodput, the fraction of wall time spent computing — and its complement
broken down by cause. This module is that ledger:

    compute               device-productive dispatch windows
    compile               dispatches during which a kernel was built
                          at its first use (``kernels/_build.py``
                          runs nvcc synchronously inside the first
                          dispatch; the eager port has no retraces)
    data_stall            host waiting on the input pipeline
    checkpoint            save/commit time (periodic + emergency)
    preemption_recovery   emergency saves, restore-on-resume, and
                          preemption drains
    idle                  nothing to do (empty serving queue, drained
                          gaps)

Invariant: the buckets sum to the measured wall time (gated in tier-1
within tolerance) — time not explicitly charged folds into the
ledger's ``default_bucket`` (``compute`` for training, where the loop
is dispatch-bound; ``idle`` for serving, where an un-pumped engine is
simply waiting). Exported as the ``train.goodput.*`` /
``serve.goodput.*`` metric families through ``monitor.record_goodput``
on every ``flush()``.

The ledger is ambient: deep call sites that cannot see the loop's
ledger (ModelCheckpoint saves, resilience emergency saves) charge
through the module-level ``charge()``/``timed()``, which hit the
innermost active ledger — and cost one truthiness check when none is
active (the ``core.metrics`` disabled-path contract, gated in
``test_overhead_gate``).
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

__all__ = ["BUCKETS", "GoodputLedger", "active", "charge", "timed"]

BUCKETS = ("compute", "compile", "data_stall", "checkpoint",
           "preemption_recovery", "idle")

# innermost-active stack (module global, not thread-local: the serving
# engine's ledger must be chargeable from the scheduler thread AND the
# telemetry/drain paths; charges are lock-protected per ledger)
_ACTIVE: List["GoodputLedger"] = []


class GoodputLedger:
    """One loop's wall-time decomposition. Use as a context manager
    (pushes onto the ambient stack so deep call sites' ``charge()``
    land here) or drive ``start()``/``close()`` explicitly."""

    def __init__(self, family: str, default_bucket: str = "compute"):
        if family not in ("train", "serve"):
            raise ValueError(
                f"goodput family must be 'train' or 'serve', "
                f"got {family!r}")
        if default_bucket not in BUCKETS:
            raise ValueError(f"unknown bucket {default_bucket!r}; "
                             f"one of {BUCKETS}")
        self.family = family
        self.default_bucket = default_bucket
        self._lock = threading.Lock()
        self._charges: Dict[str, float] = {b: 0.0 for b in BUCKETS}
        self._t0: Optional[float] = None
        self._closed_wall: Optional[float] = None
        # flush() records DELTAS into the monotone counters; remember
        # what was already recorded so repeated flushes never
        # double-count
        self._flushed: Dict[str, float] = {b: 0.0 for b in BUCKETS}
        self._flushed_wall = 0.0

    # ------------------------------------------------------- lifecycle
    def start(self) -> "GoodputLedger":
        if self._t0 is None:
            self._t0 = time.perf_counter()
        return self

    def __enter__(self) -> "GoodputLedger":
        self.start()
        _ACTIVE.append(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        try:
            _ACTIVE.remove(self)
        except ValueError:
            pass
        self.close()
        return False

    def close(self):
        """Freeze the wall clock and flush the final window into the
        metrics registry. Idempotent."""
        if self._t0 is None:
            return
        if self._closed_wall is None:
            self._closed_wall = time.perf_counter() - self._t0
        self.flush()

    # --------------------------------------------------------- charges
    def charge(self, bucket: str, seconds: float):
        """Attribute ``seconds`` of wall time to ``bucket``. Charges
        must not overlap (each wall second belongs to one bucket) —
        the residual fold assumes it."""
        if bucket not in self._charges:
            raise ValueError(f"unknown goodput bucket {bucket!r}; "
                             f"one of {BUCKETS}")
        if seconds > 0:
            with self._lock:
                self._charges[bucket] += float(seconds)

    @contextmanager
    def timed(self, bucket: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.charge(bucket, time.perf_counter() - t)

    # ----------------------------------------------------------- reads
    def bucket_total(self, bucket: str) -> float:
        """Explicit charges to one bucket so far (no residual fold) —
        what a caller diffs around a compound phase to avoid charging
        the same wall second twice."""
        with self._lock:
            return self._charges[bucket]

    def wall_s(self) -> float:
        if self._t0 is None:
            return 0.0
        if self._closed_wall is not None:
            return self._closed_wall
        return time.perf_counter() - self._t0

    def snapshot(self) -> Dict:
        """The decomposition right now: ``{"wall_s", "buckets",
        "goodput_fraction"}`` with the unattributed residual folded
        into ``default_bucket`` so the buckets ALWAYS sum to wall_s
        (the tier-1 invariant). A tiny negative residual (overlapping
        charges at float precision) clamps to zero — the tolerance
        gate absorbs it."""
        wall = self.wall_s()
        with self._lock:
            buckets = dict(self._charges)
        residual = wall - sum(buckets.values())
        buckets[self.default_bucket] += max(residual, 0.0)
        frac = buckets["compute"] / wall if wall > 0 else 0.0
        return {"wall_s": wall,
                "buckets": {b: buckets[b] for b in BUCKETS},
                "goodput_fraction": frac}

    def flush(self) -> Dict:
        """Record the window since the previous flush into the
        ``{family}.goodput.*`` metrics (counters stay monotone across
        repeated flushes) and return the full snapshot."""
        from . import monitor
        snap = self.snapshot()
        window = {b: snap["buckets"][b] - self._flushed[b]
                  for b in BUCKETS}
        window = {b: v for b, v in window.items() if v > 0}
        wall_d = snap["wall_s"] - self._flushed_wall
        if window or wall_d > 0:
            monitor.record_goodput(self.family, window, wall_d)
            for b, v in window.items():
                self._flushed[b] += v
            self._flushed_wall = snap["wall_s"]
        return snap


# ------------------------------------------------------- ambient charge

def active() -> Optional[GoodputLedger]:
    return _ACTIVE[-1] if _ACTIVE else None


def charge(bucket: str, seconds: float):
    """Charge the innermost active ledger (no-op — one truthiness
    check — when none is active): how ModelCheckpoint saves and
    resilience emergency paths attribute their time without plumbing
    a ledger handle through every layer."""
    if not _ACTIVE:
        return
    _ACTIVE[-1].charge(bucket, seconds)


@contextmanager
def timed(bucket: str):
    """Ambient ``timed`` block; skips the clock reads entirely when no
    ledger is active."""
    if not _ACTIVE:
        yield
        return
    ledger = _ACTIVE[-1]
    t = time.perf_counter()
    try:
        yield
    finally:
        ledger.charge(bucket, time.perf_counter() - t)
