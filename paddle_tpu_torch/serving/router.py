"""Fleet serving router: failure-aware admission over N replicas (the
JAX package's ``serving/router.py``).

It routes on signals the engine already exports: the structured
rejection reasons (``queue_full:no_free_pages`` vs ``no_free_slots`` vs
``shutdown``), the capacity remainder ``free_tokens`` and the
chunked-prefill backlog of ``ServingEngine.health()``.

**Admission on health.** Each ``submit()`` scores every replica from
its ``health()`` document — ``ready × (1 + free_tokens) / (1 +
queue_depth + prefill_chunks_queued)`` — and places the request on the
best (the reference's HBM-headroom factor returns with the memory
planner, ROADMAP A12). Draining replicas and replicas whose
health probe raises are skipped; replicas at their queue bound score
themselves out through ``ready=False``.

**Survival.** A per-replica circuit breaker counts consecutive
admission/poll failures; at the threshold it trips OPEN for a
full-jittered exponential backoff window (uniform in ``[0, min(cap,
base * 2^trips))``, so N routers don't re-stampede a recovering replica
in lockstep), then admits exactly one half-open probe whose outcome
closes or re-opens it. A rejected or failed placement re-routes
(bounded by ``max_reroutes``) to the next-best replica — admission is
idempotent before the prefill: the doomed request never touched a KV
page — and an explicit deadline is propagated as the REMAINING budget.

**Zero-drop rolling deploys.** ``drain_replica()`` flips a replica out
of rotation and drains it: in-flight decodes finish inside the drain
window, queued requests come back REJECTED("shutdown") and are re-homed
onto survivors by the handle's ``result()``. A replica relaunched in
the same process loads no kernel library anew (they are loaded once per
process, ``kernels._build``), so its warmup builds nothing, and
``add_replica()`` puts it back in rotation.

Observability: the ``serve.router.*`` metrics family (admissions per
replica, reroutes by reason, breaker trips/state), the
``serve.router.*`` flight-recorder events, and the telemetry server's
``/router`` endpoint (``TelemetryServer.attach_router``) serving
``describe()``. Knobs: ``PADDLE_ROUTER_MAX_REROUTES``,
``PADDLE_ROUTER_BREAKER_THRESHOLD``, ``PADDLE_ROUTER_BREAKER_BASE_S``,
``PADDLE_ROUTER_BREAKER_CAP_S`` (constructor kwargs win).

``InProcessFleet`` is N engines in ONE process, with
``rolling_deploy()`` wiring the drain → relaunch → rejoin protocol end
to end.
"""
from __future__ import annotations

import itertools
import os
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..core import flight_recorder, monitor
from .request import (QueueFull, RequestFailed, RequestParams,
                      RequestStatus)

__all__ = ["CircuitBreaker", "FleetRouter", "InProcessFleet",
           "RouterRequest"]

BREAKER_CLOSED = "closed"
BREAKER_HALF_OPEN = "half_open"
BREAKER_OPEN = "open"
_STATE_CODE = {BREAKER_CLOSED: 0, BREAKER_HALF_OPEN: 1, BREAKER_OPEN: 2}


def _env_num(name: str, default, cast):
    """``PADDLE_ROUTER_*`` env knob with the garbage-must-not-
    reconfigure contract the engine's env knobs follow."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return cast(raw)
    except ValueError:
        monitor.record_swallowed(
            "serving.router.env", ValueError(f"{name}={raw!r}"))
        return default


class CircuitBreaker:
    """Per-replica failure gate. Not thread-safe on its own — the
    owning router mutates it under its lock.

    State machine::

        CLOSED ──(threshold consecutive failures)──► OPEN
          ▲                                            │ backoff:
          │ probe success                              │ uniform[0,
          │                                            ▼  min(cap,
        HALF_OPEN ◄──(backoff elapsed; admits ONE probe) base·2^trips))
          │
          └──(probe failure)──► OPEN (trips+1: longer backoff cap)

    ``trips`` counts consecutive OPEN transitions and is the backoff
    exponent; any success resets both it and the failure count.
    ``clock`` is injectable so the state machine is testable without
    sleeping.
    """

    def __init__(self, threshold: int = 3, base_s: float = 0.05,
                 cap_s: float = 2.0, rng: Optional[random.Random] = None,
                 clock: Callable[[], float] = time.monotonic):
        if threshold < 1:
            raise ValueError("breaker threshold must be >= 1")
        self.threshold = int(threshold)
        self.base_s = base_s
        self.cap_s = cap_s
        self._rng = rng if rng is not None else random.Random()
        self._clock = clock
        self.state = BREAKER_CLOSED
        self.failures = 0        # consecutive, while CLOSED
        self.trips = 0           # consecutive OPEN transitions
        self.open_until = 0.0
        self.probe_in_flight = False

    def admissible(self) -> bool:
        """May a request route here right now? An OPEN breaker past
        its backoff deadline transitions to HALF_OPEN; HALF_OPEN
        admits exactly one probe at a time."""
        if self.state == BREAKER_OPEN and self._clock() >= self.open_until:
            self.state = BREAKER_HALF_OPEN
            self.probe_in_flight = False
        if self.state == BREAKER_CLOSED:
            return True
        if self.state == BREAKER_HALF_OPEN:
            return not self.probe_in_flight
        return False

    def begin(self):
        """A request was routed here (call after ``admissible()``):
        in HALF_OPEN it becomes THE probe."""
        if self.state == BREAKER_HALF_OPEN:
            self.probe_in_flight = True

    def record_success(self) -> bool:
        """An admission on this replica succeeded. Returns True when
        this was the half-open probe closing the breaker."""
        closed = self.state == BREAKER_HALF_OPEN
        self.state = BREAKER_CLOSED
        self.failures = 0
        self.trips = 0
        self.probe_in_flight = False
        return closed

    def record_failure(self) -> Optional[float]:
        """An admission/poll failure. Returns the backoff seconds when
        this failure tripped the breaker OPEN (half-open probe failure
        trips immediately; CLOSED trips at the threshold)."""
        if self.state == BREAKER_HALF_OPEN:
            return self._trip()
        if self.state == BREAKER_CLOSED:
            self.failures += 1
            if self.failures >= self.threshold:
                return self._trip()
        return None

    def backoff_bound(self) -> float:
        """The full-jitter upper bound the NEXT trip would draw from
        (exposed for tests and the /router document)."""
        return min(self.cap_s, self.base_s * (2 ** self.trips))

    def _trip(self) -> float:
        backoff = self._rng.uniform(0.0, self.backoff_bound())
        self.trips += 1
        self.failures = 0
        self.state = BREAKER_OPEN
        self.open_until = self._clock() + backoff
        self.probe_in_flight = False
        return backoff


_router_ids = itertools.count()


class RouterRequest:
    """The caller's handle on a routed request: wraps the engine-level
    :class:`Request` currently carrying it, and survives re-homing —
    when a placement is rejected (queue bound, drain) or fails
    (admission error, pre-prefill) the router swaps a fresh engine
    request in underneath and ``result()`` keeps waiting. ``hops``
    records every placement that re-routed, ``replica`` the current
    home."""

    def __init__(self, router: "FleetRouter", prompt, params: RequestParams,
                 deadline: Optional[float]):
        self.rid = next(_router_ids)
        self.prompt = prompt
        self.params = params
        self.deadline = deadline        # absolute monotonic, or None
        self.inner = None               # the current engine Request
        self.replica: Optional[str] = None
        self.hops: List[Tuple[str, str]] = []   # (replica, reason)
        self.reroutes = 0
        self._router = router
        self._failed: Optional[Tuple[RequestStatus, str]] = None

    @property
    def status(self) -> RequestStatus:
        if self._failed is not None:
            return self._failed[0]
        return self.inner.status if self.inner is not None \
            else RequestStatus.QUEUED

    @property
    def detail(self) -> str:
        if self._failed is not None:
            return self._failed[1]
        return self.inner.detail if self.inner is not None else ""

    @property
    def tokens(self):
        return self.inner.tokens if self.inner is not None else None

    @property
    def ttft(self):
        return self.inner.ttft if self.inner is not None else None

    def done(self) -> bool:
        """Terminal AND not re-routable — a rejected inner request the
        router would still re-home does not count as done."""
        if self._failed is not None:
            return True
        return self.inner is not None and self.inner.done() \
            and not self._router._reroutable(self)

    def result(self, timeout: Optional[float] = None):
        """Block until terminal across every re-route; returns the
        generated token ids for COMPLETED, raises
        :class:`RequestFailed` otherwise."""
        return self._router._await(self, timeout)

    def __repr__(self):
        return (f"RouterRequest(rid={self.rid}, replica={self.replica}, "
                f"status={self.status.value}, reroutes={self.reroutes})")


class _Replica:
    __slots__ = ("name", "engine", "breaker", "draining")

    def __init__(self, name, engine, breaker):
        self.name = name
        self.engine = engine
        self.breaker = breaker
        self.draining = False


class FleetRouter:
    """Failure-aware admission over N ``ServingEngine`` replicas (see
    module docstring). ``replicas`` is a ``{name: engine}`` mapping or
    a list (named ``r0..rN-1``); every mutation of the replica table
    and the totals happens under ``_lock`` — submit() callers, the
    ``result()`` re-route path, and the telemetry thread's ``/router``
    scrape all race here."""

    def __init__(self, replicas, *, max_reroutes: Optional[int] = None,
                 breaker_threshold: Optional[int] = None,
                 breaker_base_s: Optional[float] = None,
                 breaker_cap_s: Optional[float] = None,
                 seed: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.max_reroutes = int(
            max_reroutes if max_reroutes is not None
            else _env_num("PADDLE_ROUTER_MAX_REROUTES", 2, int))
        self.breaker_threshold = int(
            breaker_threshold if breaker_threshold is not None
            else _env_num("PADDLE_ROUTER_BREAKER_THRESHOLD", 3, int))
        self.breaker_base_s = (
            breaker_base_s if breaker_base_s is not None
            else _env_num("PADDLE_ROUTER_BREAKER_BASE_S", 0.05, float))
        self.breaker_cap_s = (
            breaker_cap_s if breaker_cap_s is not None
            else _env_num("PADDLE_ROUTER_BREAKER_CAP_S", 2.0, float))
        self._rng = random.Random(seed)
        self._clock = clock
        self._lock = threading.RLock()
        self._replicas: Dict[str, _Replica] = {}
        self._stats = {"submitted": 0, "admissions": 0, "reroutes": 0,
                       "rehomed": 0, "rejected": 0, "breaker_trips": 0}
        if not isinstance(replicas, dict):
            replicas = {f"r{i}": eng for i, eng in enumerate(replicas)}
        if not replicas:
            raise ValueError("FleetRouter needs at least one replica")
        for name, engine in replicas.items():
            self.add_replica(name, engine)

    # ----------------------------------------------------- replica table
    def add_replica(self, name: str, engine) -> "FleetRouter":
        """Put a replica in rotation (a relaunched one rejoins here)."""
        with self._lock:
            if name in self._replicas:
                raise ValueError(f"replica {name!r} already in rotation")
            self._replicas[name] = _Replica(
                name, engine,
                CircuitBreaker(self.breaker_threshold, self.breaker_base_s,
                               self.breaker_cap_s, rng=self._rng,
                               clock=self._clock))
            n = len(self._replicas)
            monitor.record_router_replicas(n)
            monitor.record_router_breaker_state(name, 0)
        if flight_recorder.enabled:
            flight_recorder.record("serve.router.rejoin", replica=name,
                                   replicas=n)
        return self

    def remove_replica(self, name: str):
        """Drop a replica from the table entirely (rolling deploy:
        after its drain, before its relaunch). Returns the engine."""
        with self._lock:
            rec = self._replicas.pop(name)
            monitor.record_router_replicas(len(self._replicas))
        return rec.engine

    def drain_replica(self, name: str):
        """Rolling-deploy step 1: flip ``name`` out of rotation, then
        drain it — in-flight decodes finish inside the engine's drain
        window, queued requests come back REJECTED("shutdown") and are
        re-homed onto survivors the next time their handle is awaited.
        Returns the (drained) engine."""
        with self._lock:
            rec = self._replicas[name]
            rec.draining = True
            engine = rec.engine
        h = {}
        try:
            h = engine.health()
        except Exception as e:
            monitor.record_swallowed("serving.router.health", e)
        if flight_recorder.enabled:
            flight_recorder.record(
                "serve.router.drain", replica=name,
                queued=h.get("queue_depth", -1),
                in_flight=h.get("slots_busy", -1))
        engine.drain()   # outside the lock: it blocks on live decodes
        return engine

    def engines(self) -> Dict[str, object]:
        with self._lock:
            return {name: rec.engine
                    for name, rec in self._replicas.items()}

    def shutdown(self):
        """Drain every replica (all handles terminal, re-homing
        disabled by virtue of nowhere to go) — the fleet-wide stop."""
        for name in list(self.engines()):
            try:
                self.drain_replica(name)
            except KeyError:
                pass   # removed concurrently

    # ---------------------------------------------------------- scoring
    @staticmethod
    def _score(health: dict) -> float:
        """Admission score: ``ready × (1 + free_tokens) / (1 +
        queue_depth + prefill_chunks_queued)``. ``free_tokens`` is the
        engine's dtype-adjusted capacity remainder (an int8 pool at
        equal HBM scores ~2× the bf16 one — comparable across
        precisions); the queue+chunk divisor spreads ties so a burst
        doesn't pile onto one replica before its occupancy moves —
        pending chunked-prefill work counts like queued requests,
        since every outstanding chunk steals a scheduler iteration
        from decode on that replica."""
        if not health.get("ready", False):
            return 0.0
        free_tokens = health.get("free_tokens") or 0
        depth = health.get("queue_depth") or 0
        chunks = health.get("prefill_chunks_queued") or 0
        return (1.0 + free_tokens) / (1.0 + depth + chunks)

    def _candidates(self) -> List[_Replica]:
        """Placement order (callers hold the lock): half-open probes
        first — a recovering replica's single probe must actually
        reach it even while healthy peers outscore it — then ready
        replicas by score descending, insertion order breaking ties
        deterministically. Draining, OPEN, and not-ready replicas are
        skipped; a health() probe that RAISES counts as a poll failure
        on that replica's breaker."""
        probes, scored = [], []
        for idx, rec in enumerate(self._replicas.values()):
            if rec.draining:
                continue
            if not rec.breaker.admissible():
                continue
            try:
                h = rec.engine.health()
            except Exception as e:
                monitor.record_swallowed("serving.router.health", e)
                self._note_failure(rec, "health_error")
                continue
            if h.get("draining"):
                rec.draining = True   # drained behind our back
                continue
            if rec.breaker.state == BREAKER_HALF_OPEN:
                probes.append((idx, rec))
                continue
            s = self._score(h)
            if s <= 0.0:
                continue   # warming or at its queue bound
            scored.append((-s, idx, rec))
        probes.sort()
        scored.sort()
        return [rec for _, rec in probes] + [rec for _, _, rec in scored]

    # ------------------------------------------------ breaker accounting
    def _note_failure(self, rec: _Replica, kind: str):
        """One admission/poll failure on ``rec`` (callers hold the
        lock); trips the breaker at the threshold."""
        backoff = rec.breaker.record_failure()
        monitor.record_router_breaker_state(
            rec.name, _STATE_CODE[rec.breaker.state])
        if backoff is not None:
            self._stats["breaker_trips"] += 1
            monitor.record_router_breaker_trip(rec.name)
            if flight_recorder.enabled:
                flight_recorder.record(
                    "serve.router.breaker_open", replica=rec.name,
                    cause=kind, backoff_s=round(backoff, 4),
                    trips=rec.breaker.trips)

    def _note_success(self, name: Optional[str]):
        """A request admitted (prefilled or completed) on ``name``."""
        if name is None:
            return
        with self._lock:
            rec = self._replicas.get(name)
            if rec is None:
                return
            closed = rec.breaker.record_success()
            monitor.record_router_breaker_state(rec.name, 0)
        if closed and flight_recorder.enabled:
            flight_recorder.record("serve.router.breaker_close",
                                   replica=name)

    # -------------------------------------------------------- admission
    def submit(self, prompt, params: Optional[RequestParams] = None) \
            -> RouterRequest:
        """Route one prompt to the best replica; returns the re-homing
        Future-style handle immediately. Raises :class:`QueueFull`
        (with the aggregated reason and the terminal handle attached)
        when NO replica can admit, and ``ValueError`` for prompts no
        replica's buckets hold — client errors are not
        re-routed."""
        params = params if params is not None else RequestParams()
        deadline = None if params.deadline_s is None \
            else self._clock() + params.deadline_s
        rr = RouterRequest(self, prompt, params, deadline)
        with self._lock:
            self._stats["submitted"] += 1
        if not self._place(rr):
            reason = rr.hops[-1][1] if rr.hops else "no_admissible_replica"
            rr._failed = (RequestStatus.REJECTED, reason)
            with self._lock:
                self._stats["rejected"] += 1
            monitor.record_router_rejected()
            raise QueueFull(
                f"no replica could admit request {rr.rid} "
                f"({len(self._replicas)} in table): {reason}",
                reason=reason, request=rr)
        return rr

    def _params_for(self, rr: RouterRequest) -> RequestParams:
        """Per-placement params: an explicit deadline propagates as the
        REMAINING budget (absolute deadline pinned at first submit), so
        a re-routed request can never exceed what its submitter asked
        for. Without one, each replica applies its own default window."""
        if rr.deadline is None:
            return rr.params
        remaining = max(0.0, rr.deadline - self._clock())
        return RequestParams(max_new_tokens=rr.params.max_new_tokens,
                             deadline_s=remaining)

    def _place(self, rr: RouterRequest, prev: Optional[str] = None,
               reason: Optional[str] = None) -> bool:
        """Try candidates in order until one admits ``rr``; each failed
        candidate past the first attempt burns one of the request's
        bounded re-routes. Returns False when nothing admitted (the
        caller decides whether that surfaces as QueueFull or as the
        prior placement's failure)."""
        with self._lock:
            for rec in self._candidates():
                if rr.deadline is not None \
                        and self._clock() > rr.deadline:
                    return False
                probe = rec.breaker.state == BREAKER_HALF_OPEN
                try:
                    inner = rec.engine.submit(rr.prompt,
                                              self._params_for(rr))
                except QueueFull as e:
                    if not self._burn_reroute(rr, rec.name, e.reason):
                        return False
                    continue
                except (ValueError, TypeError):
                    raise   # client error: identical on every replica
                except RuntimeError as e:
                    if "shut down" in str(e):
                        rec.draining = True   # drained behind our back
                        kind = "shutdown"
                    else:
                        self._note_failure(rec, "submit_error")
                        monitor.record_swallowed("serving.router.submit",
                                                 e)
                        kind = "error"
                    if not self._burn_reroute(rr, rec.name, kind):
                        return False
                    continue
                rec.breaker.begin()
                rr.inner = inner
                src, rr.replica = rr.replica, rec.name
                self._stats["admissions"] += 1
                monitor.record_router_admission(rec.name)
                if flight_recorder.enabled:
                    if probe:
                        flight_recorder.record("serve.router.breaker_probe",
                                               replica=rec.name, rid=rr.rid)
                    if prev is not None:
                        flight_recorder.record(
                            "serve.router.reroute", rid=rr.rid,
                            src=prev, dst=rec.name,
                            reason=reason or "reroute")
                return True
        return False

    def _burn_reroute(self, rr: RouterRequest, name: str,
                      reason: str) -> bool:
        """Account one failed placement attempt; False once the
        request's re-route budget is spent (callers hold the lock)."""
        rr.hops.append((name, reason))
        if rr.reroutes >= self.max_reroutes:
            return False
        rr.reroutes += 1
        self._stats["reroutes"] += 1
        monitor.record_router_reroute(reason)
        return True

    # ---------------------------------------------------------- waiting
    def _reroutable(self, rr: RouterRequest) -> bool:
        """Would the router re-home this handle's current terminal
        state instead of surfacing it? Retryable: rejected at the
        queue bound, rejected by a drain ("shutdown" — the zero-drop
        re-home), or a failed admission that never emitted a token
        (idempotent pre-prefill). Bounded by the re-route budget and
        the original deadline."""
        inner = rr.inner
        if inner is None or not inner.done() or rr._failed is not None:
            return False
        if rr.reroutes >= self.max_reroutes:
            return False
        if rr.deadline is not None and self._clock() > rr.deadline:
            return False
        st, detail = inner.status, inner.detail
        if st is RequestStatus.REJECTED and (
                detail.startswith("queue_full") or detail == "shutdown"):
            return True
        return st is RequestStatus.CANCELLED \
            and detail.startswith("admission error") \
            and inner.n_emitted == 0

    def _failure_reason(self, detail: str) -> str:
        return "admission_error" if detail.startswith("admission error") \
            else detail

    def _await(self, rr: RouterRequest, timeout: Optional[float]):
        """The re-homing wait loop behind ``RouterRequest.result()``."""
        wait_deadline = None if timeout is None \
            else self._clock() + timeout
        while True:
            if rr._failed is not None:
                raise RequestFailed(*rr._failed)
            inner = rr.inner
            remaining = None if wait_deadline is None \
                else max(0.0, wait_deadline - self._clock())
            try:
                tokens = inner.result(timeout=remaining)
            except RequestFailed:
                if not self._handle_failure(rr):
                    raise
                continue
            self._note_success(rr.replica)
            return tokens

    def _handle_failure(self, rr: RouterRequest) -> bool:
        """Classify a terminal failure on the current placement; True
        when the request was re-homed (the await loop continues)."""
        inner = rr.inner
        detail = inner.detail
        if inner.status is RequestStatus.CANCELLED \
                and detail.startswith("admission error"):
            # a failed admission is a replica failure — breaker food —
            # whether or not the request still has re-route budget
            with self._lock:
                rec = self._replicas.get(rr.replica)
                if rec is not None:
                    self._note_failure(rec, "admission_error")
        if not self._reroutable(rr):
            return False
        prev, reason = rr.replica, self._failure_reason(detail)
        with self._lock:
            if not self._burn_reroute(rr, prev, reason):
                return False
            if detail == "shutdown":
                self._stats["rehomed"] += 1
        # _burn_reroute already spent the budget for this attempt;
        # _place itself only burns on its own subsequent rejections
        placed = self._place(rr, prev=prev, reason=reason)
        if not placed:
            with self._lock:
                self._stats["rejected"] += 1
            monitor.record_router_rejected()
        return placed

    # ---------------------------------------------------------- surface
    def describe(self) -> Dict:
        """The ``/router`` telemetry document: routing totals plus the
        live replica table — breaker state/failure counts/backoff
        remaining, drain flag, the health fields scoring reads, and
        the current score."""
        with self._lock:
            now = self._clock()
            replicas = []
            for name, rec in self._replicas.items():
                row = {
                    "name": name,
                    "breaker": rec.breaker.state,
                    "failures": rec.breaker.failures,
                    "trips": rec.breaker.trips,
                    "draining": rec.draining,
                }
                if rec.breaker.state == BREAKER_OPEN:
                    row["open_for_s"] = round(
                        max(0.0, rec.breaker.open_until - now), 4)
                try:
                    h = rec.engine.health()
                    row["health"] = {
                        k: h[k] for k in
                        ("ready", "reason", "queue_depth", "free_slots",
                         "free_tokens", "capacity_tokens",
                         "pending_prefill_tokens",
                         "prefill_chunks_queued")
                        if k in h}
                    row["score"] = round(self._score(h), 4)
                except Exception as e:
                    monitor.record_swallowed("serving.router.health", e)
                    row["health"] = {"error": type(e).__name__}
                    row["score"] = 0.0
                replicas.append(row)
            return {"replicas": replicas, "max_reroutes": self.max_reroutes,
                    "breaker": {"threshold": self.breaker_threshold,
                                "base_s": self.breaker_base_s,
                                "cap_s": self.breaker_cap_s},
                    **dict(self._stats)}

    @property
    def stats(self) -> Dict:
        with self._lock:
            return dict(self._stats)

    def __repr__(self):
        with self._lock:
            return (f"FleetRouter({len(self._replicas)} replicas, "
                    f"admissions={self._stats['admissions']}, "
                    f"reroutes={self._stats['reroutes']})")


class InProcessFleet:
    """N-replica fleet in one process. ``engine_factory`` is called once
    per replica name, and again by ``rolling_deploy`` for the
    relaunch::

        fleet = InProcessFleet(lambda name: ServingEngine(cfg), n=3)
        h = fleet.router.submit(prompt)
        fleet.rolling_deploy("r1")      # drain → relaunch → rejoin
        h.result()                      # zero-drop: re-homed if queued
    """

    def __init__(self, engine_factory: Callable[[str], object],
                 n: int = 3, *, names: Optional[List[str]] = None,
                 router_kw: Optional[dict] = None):
        self.factory = engine_factory
        names = list(names) if names is not None \
            else [f"r{i}" for i in range(n)]
        self.router = FleetRouter(
            {name: engine_factory(name) for name in names},
            **(router_kw or {}))

    def __getitem__(self, name: str):
        return self.router.engines()[name]

    def rolling_deploy(self, name: str):
        """One zero-drop rolling-deploy step: drain ``name`` under live
        traffic (the router re-homes its queued work; in-flight decodes
        finish inside the drain window), shut the old engine down,
        relaunch from the factory (its warmup loads nothing anew) and
        rejoin. Returns the fresh engine. The old engine's caches are
        freed before the factory builds the fresh one's."""
        old = self.router.drain_replica(name)
        self.router.remove_replica(name)
        old.shutdown()
        del old
        fresh = self.factory(name)
        self.router.add_replica(name, fresh)
        return fresh

    def shutdown(self):
        self.router.shutdown()
        for engine in self.router.engines().values():
            engine.shutdown()
