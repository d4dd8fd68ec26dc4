"""Serving request front-end: Future-style handles and admission types
(the JAX package's ``serving/request.py``), with its per-request trace
spans and cost attribution.

A :class:`Request` is both the scheduler's record and the caller's
handle: ``submit()`` returns it at once, ``result()`` blocks until it is
terminal, pumping the engine inline when no pump thread owns it
(``ServingEngine.start()``), so a single-threaded ``submit(); result()``
makes progress.

Terminal statuses:

    COMPLETED   decoded to eos or its token budget
    CANCELLED   deadline expired (queued, mid-prefill or mid-decode), or
                the drain timeout hit during a graceful shutdown
    REJECTED    queue at bound when submitted, or still queued when a
                drain started
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import os
import threading
import time
from typing import Optional

import numpy as np

from ..core import flight_recorder

__all__ = ["QueueFull", "Request", "RequestFailed", "RequestParams",
           "RequestStatus"]


class RequestStatus(str, enum.Enum):
    QUEUED = "queued"
    #: chunked prefill in flight: the request owns a slot (and its
    #: committed pages) but its prompt is only partly written; the
    #: scheduler never decodes a PENDING_PREFILL slot, and the final
    #: chunk's admission flips it to RUNNING
    PENDING_PREFILL = "pending_prefill"
    RUNNING = "running"
    COMPLETED = "completed"
    CANCELLED = "cancelled"
    REJECTED = "rejected"

    @property
    def terminal(self) -> bool:
        return self in (RequestStatus.COMPLETED, RequestStatus.CANCELLED,
                        RequestStatus.REJECTED)


@dataclasses.dataclass(frozen=True)
class RequestParams:
    """Per-request knobs. ``max_new_tokens`` must not exceed the
    engine's budget; ``deadline_s`` is relative to submit time — a
    request still queued or decoding past it is cancelled."""
    max_new_tokens: Optional[int] = None
    deadline_s: Optional[float] = None


class QueueFull(RuntimeError):
    """Admission control: the request queue is at its depth bound.
    ``reason`` is ``queue_full:no_free_pages`` when the paged queue head
    waits on pool pages, ``queue_full:no_free_slots`` when every decode
    lane is busy, bare ``queue_full`` otherwise; ``request`` is the
    already REJECTED handle (a router re-routes on the reason)."""

    def __init__(self, msg: str = "", *, reason: str = "queue_full",
                 request: Optional["Request"] = None):
        super().__init__(msg)
        self.reason = reason
        self.request = request


class RequestFailed(RuntimeError):
    """result() on a request that did not complete."""

    def __init__(self, status: RequestStatus, detail: str):
        super().__init__(f"request {status.value}: {detail}")
        self.status = status
        self.detail = detail


_ids = itertools.count()


class Request:
    """One submitted prompt: scheduler record + caller handle."""

    def __init__(self, prompt: np.ndarray, params: RequestParams,
                 budget: int, deadline: Optional[float], engine=None):
        self.id = next(_ids)
        self.prompt = prompt                  # [plen] int64
        self.params = params
        self.budget = int(budget)             # tokens incl. the prefill one
        self.deadline = deadline              # absolute monotonic, or None
        self.status = RequestStatus.QUEUED
        self.detail = ""
        self.tokens: Optional[np.ndarray] = None   # eos-trimmed on success
        self.n_emitted = 0                    # raw tokens incl. eos
        self.submitted_at = time.monotonic()
        self.admitted_at: Optional[float] = None
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self._engine = engine
        self._event = threading.Event()
        # per-request tracing: every request carries a trace id; the
        # ones the engine samples (traced, 1 in trace_sample) record
        # queue-wait, prefill and decode spans into the flight
        # recorder, and through it into the Profiler's chrome trace
        self.trace_id = f"{os.getpid():x}.{self.id}"
        self.traced = False
        self._t_submit_ns = 0   # set by the engine when traced
        self._t_seg_ns = 0      # rolling decode-segment anchor
        # cost attribution: prefill wall at admission, this request's
        # share of every poll window it was live in, and page*seconds
        # held in the paged pool (read back through cost())
        self._cost_prefill_s = 0.0
        self._cost_decode_s = 0.0
        self._cost_page_s = 0.0

    def span(self, name: str, start_ns: int, end_ns: int, **fields):
        """Record one trace span for this request (no-op unless the
        engine sampled it); the tid keys each request onto its own
        trace row."""
        if not self.traced:
            return
        flight_recorder.record_span(
            f"req{self.id}.{name}", start_ns, end_ns,
            trace_id=self.trace_id, tid=1000 + self.id % 64,
            req=self.id, **fields)

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until terminal, pumping the engine inline when no pump
        thread owns it."""
        deadline = None if timeout is None \
            else time.monotonic() + float(timeout)
        while not self._event.is_set():
            pumped = self._engine._try_pump() \
                if self._engine is not None else False
            if not pumped:
                self._event.wait(0.005)
            if deadline is not None and time.monotonic() > deadline \
                    and not self._event.is_set():
                raise TimeoutError(
                    f"request {self.id} not finished within {timeout}s "
                    f"(status {self.status.value})")
        if self.status is RequestStatus.COMPLETED:
            return self.tokens
        raise RequestFailed(self.status, self.detail)

    def _finish(self, status: RequestStatus, detail: str = ""):
        """Terminal transition; idempotent (the first outcome stays)."""
        if self._event.is_set():
            return
        self.status = status
        self.detail = detail
        self.finished_at = time.monotonic()
        if flight_recorder.enabled:
            flight_recorder.record(
                "serve.finish", req=self.id, status=status.value,
                tokens=self.n_emitted,
                **({"detail": detail} if detail else {}))
            if self.traced:
                t = flight_recorder.now_ns()
                if self.admitted_at is None and self._t_submit_ns:
                    # never admitted: its whole life was queue wait
                    self.span("queue_wait", self._t_submit_ns, t,
                              status=status.value)
                elif self._t_seg_ns:
                    self.span("decode", self._t_seg_ns, t,
                              tokens=self.n_emitted, status=status.value)
        self._event.set()

    @property
    def ttft(self) -> Optional[float]:
        """Submit -> first token (seconds), queue wait included."""
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    @property
    def per_token_latency(self) -> Optional[float]:
        """Mean decode seconds per token after the first (None until
        terminal or when the request never decoded)."""
        if self.first_token_at is None or self.finished_at is None \
                or self.n_emitted <= 1:
            return None
        return (self.finished_at - self.first_token_at) / \
            (self.n_emitted - 1)

    def cost(self) -> dict:
        """Attributed resource cost so far: prefill wall seconds, this
        request's share of every decode poll window it was live in
        (window wall / live slots: the shares of one window sum to the
        window, so costs reconcile against the goodput ledger's compute
        bucket), and KV page*seconds held in the paged pool (0.0 on a
        dense cache)."""
        return {
            "prefill_s": self._cost_prefill_s,
            "decode_s": self._cost_decode_s,
            "page_s": self._cost_page_s,
            "total_s": self._cost_prefill_s + self._cost_decode_s,
        }

    def __repr__(self):
        return (f"Request(id={self.id}, status={self.status.value}, "
                f"prompt={self.prompt.size} toks, budget={self.budget})")
