"""Deterministic in-process fault injection — the chaos-test harness
(the JAX package's ``utils/fault_injection.py``).

Faults fire on exact call counts, never on wall-clock races, so a chaos
test that passes once passes always. Tests built on this module carry
the ``chaos`` marker.

Ported so far:

- ``KillAfter(n)``              — deliver a signal to this process on the
                                  n-th ``step()`` call (preemption).
- ``wedge_replica(engine)``     — suspend a ServingEngine's scheduler
                                  until released (wedged replica: alive,
                                  answers health(), makes zero progress).
- ``fail_admission(engine, n)`` — inject ``n`` consecutive admission
                                  failures into a ServingEngine
                                  (pre-prefill, so the failed request
                                  is re-routable).

The reference's other injectors aim at modules the port does not have
yet (checkpoint, store, dataloader, compile cache); each comes with its
target module (ROADMAP A9, A11).
"""
from __future__ import annotations

import os
import signal
import time

__all__ = ["KillAfter", "fail_admission", "wedge_replica"]


class KillAfter:
    """Preemption injector: ``step()`` each step; the ``n``-th call
    sends ``sig`` (default SIGTERM) to this very process — what a
    maintenance event looks like from inside the job."""

    def __init__(self, n: int, sig: int = signal.SIGTERM):
        if n < 1:
            raise ValueError("KillAfter fires on the n-th step, n >= 1")
        self.n = int(n)
        self.sig = sig
        self.calls = 0
        self.fired = False

    def step(self) -> bool:
        """Returns True on the call that delivered the signal."""
        self.calls += 1
        if self.calls == self.n and not self.fired:
            self.fired = True
            os.kill(os.getpid(), self.sig)
            return True
        return False


class wedge_replica:
    """Suspend a ServingEngine's scheduler until released: the engine
    stays alive and keeps answering ``submit()``/``health()``, but
    ``step()`` and the inline ``result()`` pump make zero progress, so
    its queue only grows. A router must see the mounting backpressure
    (``queue_full`` health reasons, falling score) and steer traffic to
    survivors. Each swallowed ``step()`` sleeps ``idle_s`` (counted in
    ``stalled``), so a pump thread spinning on the wedged engine does
    not starve the other replicas' threads of the GIL. Context manager,
    or ``wedge()``/``release()``::

        with wedge_replica(engine):
            ...                      # engine frozen
        # scheduler restored; queued work resumes
    """

    def __init__(self, engine, idle_s: float = 0.001):
        self.engine = engine
        self.idle_s = float(idle_s)
        self.stalled = 0
        self._saved = None

    def _stalled_step(self):
        self.stalled += 1
        time.sleep(self.idle_s)

    def wedge(self) -> "wedge_replica":
        if self._saved is None:
            self._saved = (self.engine.step, self.engine._try_pump)
            self.engine.step = self._stalled_step
            self.engine._try_pump = lambda: False
        return self

    def release(self):
        if self._saved is not None:
            self.engine.step, self.engine._try_pump = self._saved
            self._saved = None

    def __enter__(self) -> "wedge_replica":
        return self.wedge()

    def __exit__(self, exc_type, exc, tb):
        self.release()
        return False


class fail_admission:
    """Inject ``n`` consecutive admission failures into a
    ServingEngine: the next ``n`` requests popped for inline admission
    raise at the prefill-call fetch (``engine._exe_prefill``) — BEFORE
    any prefill dispatch or KV write, so the failed admission is
    idempotent and a router may re-route the request to another
    replica. The engine's own handling cancels each doomed handle with
    an ``admission error: ...`` detail (its handle never hangs) and
    records the swallow; ``triggered`` counts faults actually fired::

        with fail_admission(engine, n=3):
            ...   # the next 3 admissions on this engine fail
    """

    def __init__(self, engine, n: int = 1):
        if n < 1:
            raise ValueError("fail_admission fires on n >= 1 admissions")
        self.engine = engine
        self.n = int(n)
        self.triggered = 0
        self._orig = None

    def __enter__(self) -> "fail_admission":
        orig = self.engine._exe_prefill

        def flaky(bucket):
            if self.triggered < self.n:
                self.triggered += 1
                raise RuntimeError(
                    f"fail_admission: injected admission failure "
                    f"{self.triggered}/{self.n}")
            return orig(bucket)

        self._orig = orig
        self.engine._exe_prefill = flaky
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._orig is not None:
            self.engine._exe_prefill = self._orig
            self._orig = None
        return False
