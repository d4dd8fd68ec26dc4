"""Flight recorder: a bounded, thread-safe ring of structured runtime
events — what the process was doing in the seconds before it died.

The port's copy of the JAX package's ``core/flight_recorder.py``: the same names, schema and
behaviour, kept here because importing the JAX package loads jax.

Reference analog: the reference's platform layer keeps always-on
host-event recorders (HostEventRecorder) that production debugging tools
drain after the fact; the Profiler answers questions only when someone
attached it BEFORE the incident. This module is the black box that is
always on: step boundaries, jit compiles with cause, serving admissions
and evictions, checkpoint commits, collective dispatches, watchdog and
anomaly trips all land in one capacity-bounded ring, and the ring is
auto-dumped (Perfetto-compatible JSON + plaintext tail) when something
dies — Watchdog expiry, AnomalyGuard restore, GracefulShutdown
preemption, an uncaught exception in ``serve_forever``/``fit`` — or on
demand (``dump()``, the telemetry server's ``/flightrecorder``).

Design constraints (the ``core.metrics`` contract):

- sub-microsecond disabled path: every recorder's first action is a
  plain module-global bool check (enforced by
  ``tests/test_overhead_gate.py``);
- enabled cost is one ``perf_counter_ns`` + one locked deque append —
  cheap enough for per-step / per-request / per-collective call sites,
  and the ring bound means a hot loop can never balloon memory;
- the module imports nothing else of the package at import time (it sits
  below core.monitor; ``monitor`` lazily counts dumps through it).

Spans (request traces) ride in the same ring as point events: a span is
an event whose kind is ``"span"`` carrying (name, start_ns, end_ns,
trace id). ``spans_between()`` hands them to the Profiler in its host-
event tuple format, so sampled serving-request spans appear in the same
Perfetto timeline as RecordEvent spans and metric counter tracks.

Knobs: ``PADDLE_FLIGHT_RECORDER`` = ring capacity (int), or ``off``/
``0`` to disable; ``PADDLE_FLIGHT_RECORDER_DIR`` = dump directory
(default: a per-process dir under the system tempdir — every dump also
prints its path to stderr, so the artifact is findable post-mortem).
"""
from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = [
    "DECLARED_EVENTS", "EVENT_DOC", "FlightRecorder", "auto_dump",
    "capacity", "clear", "clock_offset_ns", "configure", "disable",
    "dump", "dump_dict", "enable", "enabled", "events", "identity",
    "is_enabled", "now_ns", "record", "record_span",
    "set_clock_offset_ns", "spans_between", "tail",
]

# The declared event-name families. Every point event recorded through
# this module from inside the package must use a name from this set —
# the tools/lint rule `event-name` parses this literal (the
# DECLARED_METRICS precedent) and rejects undeclared literals, so a
# typo'd event name can't silently record a stream nobody greps for in
# a post-mortem. Span names (request traces) are dynamic per request
# and exempt. docs/events.md is generated from EVENT_DOC below.
DECLARED_EVENTS = frozenset({
    "jit.compile", "comm.dispatch",
    "train.step_begin", "train.step_end",
    "train.anomaly", "train.anomaly_restore",
    "fit.crash",
    "serve.submit", "serve.admit", "serve.evict", "serve.finish",
    "serve.prefill_chunk",
    "serve.preempted", "serve.crash",
    "serve.drain_begin", "serve.drain_end",
    "serve.router.reroute", "serve.router.breaker_open",
    "serve.router.breaker_probe", "serve.router.breaker_close",
    "serve.router.drain", "serve.router.rejoin",
    "watchdog.timeout",
    "resilience.preemption",
    "checkpoint.commit",
    "fleet.clock_sync", "fleet.rank_stale",
    "slo.pending", "slo.firing", "slo.resolved",
    "train.straggler",
})

# name -> one-line description; `python -m tools.metrics_doc` renders
# docs/events.md from this table and a tier-1 drift test keeps the
# committed doc in sync (keys must == DECLARED_EVENTS).
EVENT_DOC = {
    "jit.compile": "a jax.jit cache miss (retrace), with cause/target",
    "comm.dispatch": "an eager collective/p2p dispatch (op, axis, "
                     "bytes)",
    "train.step_begin": "fit() dispatched a train step (step, epoch)",
    "train.step_end": "a loss matured out of the async window (step, "
                      "loss)",
    "train.anomaly": "non-finite loss skipped by the anomaly guard",
    "train.anomaly_restore": "anomaly guard restored the last good "
                             "snapshot",
    "fit.crash": "uncaught exception aborted Model.fit (error)",
    "serve.submit": "a request entered the serving queue (req)",
    "serve.admit": "a request was admitted to a decode slot (req, "
                   "slot, bucket)",
    "serve.evict": "an in-flight request was evicted (req, slot, "
                   "reason, tokens)",
    "serve.finish": "a request reached a terminal status (req, "
                    "status, tokens)",
    "serve.prefill_chunk": "one chunked-prefill chunk landed in the KV "
                           "cache (req, slot, chunk, start, tokens, "
                           "remaining)",
    "serve.preempted": "preemption observed mid-serve (in_flight)",
    "serve.crash": "uncaught exception in serve_forever (error)",
    "serve.drain_begin": "graceful drain started (queued, in_flight)",
    "serve.drain_end": "graceful drain finished",
    "serve.router.reroute": "the router re-routed a request to the "
                            "next-best replica (rid, src, dst, reason)",
    "serve.router.breaker_open": "a replica's circuit breaker tripped "
                                 "OPEN (replica, cause, backoff_s, "
                                 "trips)",
    "serve.router.breaker_probe": "a half-open breaker admitted its "
                                  "single probe request (replica, rid)",
    "serve.router.breaker_close": "a probe succeeded; the breaker "
                                  "closed and the replica rejoined "
                                  "rotation (replica)",
    "serve.router.drain": "the router drained a replica for a rolling "
                          "deploy (replica, queued, in_flight)",
    "serve.router.rejoin": "a replica (re)joined the router's rotation "
                           "(replica, replicas)",
    "watchdog.timeout": "a hang watchdog expired (label, timeout_s)",
    "resilience.preemption": "preemption landed at a step boundary "
                             "(step, source=signal|store)",
    "checkpoint.commit": "a checkpoint step's commit marker was "
                         "written (step)",
    "fleet.clock_sync": "fleet clock handshake result (offset_ns, "
                        "rtt_ns vs the TCPStore master clock)",
    "fleet.rank_stale": "the fleet aggregator marked a rank stale "
                        "(rank, incarnation, age_s)",
    "slo.pending": "an SLO's fast-window burn rate crossed 1.0 (slo, "
                   "scope, burn_fast, burn_slow, measured)",
    "slo.firing": "an SLO's fast AND slow burn rates crossed 1.0 — "
                  "the alert pages (slo, scope, burn_fast, burn_slow, "
                  "measured)",
    "slo.resolved": "a firing SLO's fast window went clean (slo, "
                    "scope, firing_s)",
    "train.straggler": "the robust z-score straggler detector flagged "
                       "or cleared a rank (rank, phase, z, mean_s, "
                       "median_s)",
}

DEFAULT_CAPACITY = 4096
# auto-dumps are capped per process: a watchdog storm must not write
# hundreds of files or spend its dying seconds serializing JSON
MAX_AUTO_DUMPS = 16

enabled = True  # module-global fast path; read unlocked on purpose

# wall-clock anchor so dumps can print absolute times while events carry
# the monotonic perf_counter_ns the profiler's host spans use
_ANCHOR_WALL_NS = time.time_ns()
_ANCHOR_PERF_NS = time.perf_counter_ns()


def now_ns() -> int:
    return time.perf_counter_ns()


def _wall_ns(t_ns: int) -> int:
    return _ANCHOR_WALL_NS + (t_ns - _ANCHOR_PERF_NS)


# this process's measured wall-clock offset vs the fleet's shared
# reference clock (the TCPStore master), in ns — set once by the fleet
# telemetry clock handshake; rides in every dump's metadata so
# tools/trace_merge can align N ranks' timelines
_clock_offset_ns = 0


def set_clock_offset_ns(ns: int) -> None:
    global _clock_offset_ns
    _clock_offset_ns = int(ns)


def clock_offset_ns() -> int:
    return _clock_offset_ns


def identity():
    """This process's fleet identity ``(rank, restart_count, pid)``,
    read from the launcher env contract (both 0 outside a launched
    job). Stamped on dumps — filenames and metadata — NOT on every
    event: identity is constant per process, so per-event stamping
    would only spend ring bytes repeating it (and the disabled-record
    sub-µs gate stays untouched)."""
    def _int(name):
        try:
            return int(os.environ.get(name, "0").strip() or 0)
        except ValueError:
            return 0
    return (_int("PADDLE_TRAINER_ID"), _int("PADDLE_RESTART_COUNT"),
            os.getpid())


class FlightRecorder:
    """The ring itself. One process-global instance (module functions
    below) serves every subsystem; separate instances exist only for
    tests."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self._buf: "collections.deque[Tuple[int, str, Optional[dict]]]" \
            = collections.deque(maxlen=max(int(capacity), 1))
        self._dropped = 0  # events evicted by the ring bound
        self._auto_dumps = 0
        self._last_auto: Dict[str, float] = {}  # reason -> monotonic ts

    @property
    def capacity(self) -> int:
        return self._buf.maxlen or 0

    # ------------------------------------------------------------ record
    def record(self, kind: str, t_ns: Optional[int] = None, **fields):
        """One structured point event. ``fields`` must be cheap,
        JSON-friendly scalars (ints, floats, short strings)."""
        t = time.perf_counter_ns() if t_ns is None else t_ns
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self._dropped += 1
            self._buf.append((t, kind, fields or None))

    def record_span(self, name: str, start_ns: int, end_ns: int,
                    trace_id: Optional[str] = None, tid: int = 0,
                    **fields):
        """One completed span (request-trace segment). Stored as a
        ``"span"`` event at its START time so the ring stays roughly
        time-ordered and the plaintext tail reads chronologically."""
        f = dict(fields)
        f["name"] = name
        f["end_ns"] = int(end_ns)
        f["tid"] = int(tid)
        if trace_id is not None:
            f["trace"] = trace_id
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self._dropped += 1
            self._buf.append((int(start_ns), "span", f))

    # -------------------------------------------------------------- read
    def events(self) -> List[Tuple[int, str, Optional[dict]]]:
        with self._lock:
            return list(self._buf)

    def clear(self):
        with self._lock:
            self._buf.clear()
            self._dropped = 0

    def spans_between(self, t0_ns: int, t1_ns: int) \
            -> List[Tuple[str, int, int, int, int]]:
        """Completed spans overlapping [t0_ns, t1_ns], in the profiler's
        host-event tuple format (name, start_ns, end_ns, tid, 0) — how
        sampled request traces join the Profiler's Perfetto export."""
        out = []
        for t, kind, f in self.events():
            if kind != "span" or f is None:
                continue
            end = f["end_ns"]
            if end < t0_ns or t > t1_ns:
                continue
            out.append((f["name"], t, end, f.get("tid", 0), 0))
        return out

    # -------------------------------------------------------------- dump
    def to_perfetto(self) -> dict:
        """The ring as a chrome://tracing / Perfetto JSON dict: point
        events become ``"ph": "i"`` instants, spans become ``"ph": "X"``
        slices, all under this process's real pid (multi-host dumps stay
        mergeable, the PR-2 exporter contract)."""
        rank, restart, pid = identity()
        trace_events = [
            {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": f"rank{rank}.{restart} "
                              f"flightrecorder_{pid}"}}]
        for t, kind, f in self.events():
            if kind == "span" and f is not None:
                args = {k: v for k, v in f.items()
                        if k not in ("name", "end_ns", "tid")}
                trace_events.append(
                    {"name": f["name"], "ph": "X", "cat": "flight",
                     "ts": t / 1000.0,
                     "dur": max(f["end_ns"] - t, 0) / 1000.0,
                     "pid": pid, "tid": f.get("tid", 0),
                     **({"args": args} if args else {})})
            else:
                trace_events.append(
                    {"name": kind, "ph": "i", "s": "p", "cat": "flight",
                     "ts": t / 1000.0, "pid": pid, "tid": 0,
                     **({"args": f} if f else {})})
        return {"traceEvents": trace_events,
                "metadata": {"dropped_events": self._dropped,
                             "capacity": self.capacity,
                             # fleet identity + clock mapping: what
                             # tools/trace_merge keys tracks on and
                             # uses to convert perf ts -> aligned wall
                             "rank": rank, "restart_count": restart,
                             "clock_offset_ns": _clock_offset_ns,
                             "anchor_wall_ns": _ANCHOR_WALL_NS,
                             "anchor_perf_ns": _ANCHOR_PERF_NS}}

    def tail(self, n: int = 64) -> str:
        """Plaintext rendering of the last ``n`` events — the part of a
        dump a human reads first."""
        evs = self.events()[-n:]
        lines = []
        for t, kind, f in evs:
            wall = _wall_ns(t) / 1e9
            frac = f"{wall % 1:.6f}"[1:]
            stamp = time.strftime("%H:%M:%S", time.localtime(wall)) + frac
            if kind == "span" and f is not None:
                dur_ms = max(f["end_ns"] - t, 0) / 1e6
                extra = " ".join(
                    f"{k}={v}" for k, v in f.items()
                    if k not in ("name", "end_ns", "tid"))
                lines.append(f"{stamp} span {f['name']} "
                             f"dur={dur_ms:.3f}ms {extra}".rstrip())
            else:
                extra = " ".join(f"{k}={v}" for k, v in (f or {}).items())
                lines.append(f"{stamp} {kind} {extra}".rstrip())
        return "\n".join(lines)

    def dump_dict(self, reason: str = "manual") -> dict:
        """The dump as one JSON-friendly dict (what ``/flightrecorder``
        serves): Perfetto trace + plaintext tail + bookkeeping."""
        d = self.to_perfetto()
        d["metadata"].update(reason=reason, pid=os.getpid(),
                             wall_time_ns=time.time_ns(),
                             events=len(self._buf))
        d["tail"] = self.tail().splitlines()
        return d

    def dump(self, path_prefix: Optional[str] = None,
             reason: str = "manual") -> str:
        """Write ``{prefix}.json`` (Perfetto-compatible) and
        ``{prefix}.txt`` (plaintext tail); returns the JSON path. The
        default prefix lands in ``PADDLE_FLIGHT_RECORDER_DIR`` (or a
        per-process tempdir) and is announced on stderr — a dying
        process must leave a findable artifact."""
        if path_prefix is None:
            d = os.environ.get("PADDLE_FLIGHT_RECORDER_DIR", "").strip() \
                or os.path.join(tempfile_dir(),
                                f"paddle_flightrecorder_{os.getpid()}")
            # (rank, restart_count, pid) in the name: N processes
            # sharing one PADDLE_FLIGHT_RECORDER_DIR (the fleet
            # post-mortem layout trace_merge consumes) never clobber
            # each other's dumps, and a relaunched incarnation never
            # clobbers its predecessor's
            rank, restart, pid = identity()
            path_prefix = os.path.join(
                d, f"flightrecorder_{reason}_r{rank}i{restart}"
                   f"_p{pid}_{time.time_ns()}")
        os.makedirs(os.path.dirname(os.path.abspath(path_prefix)),
                    exist_ok=True)
        json_path = path_prefix + ".json"
        with open(json_path, "w") as f:
            json.dump(self.dump_dict(reason), f)
        with open(path_prefix + ".txt", "w") as f:
            rank, restart, pid = identity()
            f.write(f"flight recorder dump — reason: {reason}, "
                    f"rank: {rank}, incarnation: {restart}, "
                    f"pid: {pid}, "
                    f"dropped: {self._dropped}\n")
            f.write(self.tail())
            f.write("\n")
        sys.stderr.write(f"flight recorder dumped ({reason}) to "
                         f"{json_path}\n")
        return json_path

    def auto_dump(self, reason: str, min_interval_s: float = 5.0) \
            -> Optional[str]:
        """Crash-path dump: rate-limited per reason and capped per
        process, and NEVER raises — the recorder must not turn a dying
        process's last act into a second failure. Counts through
        ``monitor.record_flight_dump`` so dashboards see that a dump
        happened even if nobody fetches the file."""
        if not enabled:
            return None
        now = time.monotonic()
        with self._lock:
            if self._auto_dumps >= MAX_AUTO_DUMPS:
                return None
            last = self._last_auto.get(reason)
            if last is not None and now - last < min_interval_s:
                return None
            self._auto_dumps += 1
            self._last_auto[reason] = now
        try:
            path = self.dump(reason=reason)
            from . import monitor
            # counted only AFTER the file exists: the metric documents
            # dumps WRITTEN, and an operator chasing it must find one
            monitor.record_flight_dump(reason)
            return path
        except Exception as e:  # noqa: BLE001 — crash path, observably
            try:
                from . import monitor
                monitor.record_swallowed("flight_recorder.dump", e)
            except Exception:
                pass  # lint: bare-except-ok — nothing below us to tell
            return None


def tempfile_dir() -> str:
    import tempfile
    return tempfile.gettempdir()


# ------------------------------------------------------ process singleton

def _env_capacity() -> Tuple[bool, int]:
    raw = os.environ.get("PADDLE_FLIGHT_RECORDER", "").strip().lower()
    if raw in ("off", "0", "false", "no"):
        return False, DEFAULT_CAPACITY
    try:
        cap = int(raw) if raw else DEFAULT_CAPACITY
    except ValueError:
        cap = DEFAULT_CAPACITY
    return True, max(cap, 1)


_on, _cap = _env_capacity()
enabled = _on
_recorder = FlightRecorder(_cap)


def configure(capacity: Optional[int] = None,
              on: Optional[bool] = None) -> FlightRecorder:
    """Re-size / toggle the process recorder. Passing a capacity builds
    a FRESH ring (drops history and the auto-dump rate-limit state —
    what tests want between scenarios)."""
    global _recorder, enabled
    if capacity is not None:
        _recorder = FlightRecorder(capacity)
    if on is not None:
        enabled = bool(on)
    return _recorder


def recorder() -> FlightRecorder:
    return _recorder


def enable():
    global enabled
    enabled = True


def disable():
    global enabled
    enabled = False


def is_enabled() -> bool:
    return enabled


def record(kind: str, **fields):
    """Module-level fast path: ``flight_recorder.record("serve.admit",
    req=3, slot=1)``. First action is the bool check — the disabled
    cost is the call itself."""
    if not enabled:
        return
    _recorder.record(kind, **fields)


def record_span(name: str, start_ns: int, end_ns: int,
                trace_id: Optional[str] = None, tid: int = 0, **fields):
    if not enabled:
        return
    _recorder.record_span(name, start_ns, end_ns, trace_id=trace_id,
                          tid=tid, **fields)


def events() -> List[Tuple[int, str, Optional[dict]]]:
    return _recorder.events()


def clear():
    _recorder.clear()


def capacity() -> int:
    return _recorder.capacity


def spans_between(t0_ns: int, t1_ns: int):
    return _recorder.spans_between(t0_ns, t1_ns)


def tail(n: int = 64) -> str:
    return _recorder.tail(n)


def dump(path_prefix: Optional[str] = None, reason: str = "manual") -> str:
    return _recorder.dump(path_prefix, reason=reason)


def dump_dict(reason: str = "manual") -> dict:
    return _recorder.dump_dict(reason)


def auto_dump(reason: str, min_interval_s: float = 5.0) -> Optional[str]:
    return _recorder.auto_dump(reason, min_interval_s=min_interval_s)
