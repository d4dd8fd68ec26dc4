"""Deterministic in-process fault injection — the chaos-test harness
(the JAX package's ``utils/fault_injection.py``).

Faults fire on exact call counts, never on wall-clock races, so a chaos
test that passes once passes always. Tests built on this module carry
the ``chaos`` marker.

Ported so far:

- ``fail_admission(engine, n)`` — inject ``n`` consecutive admission
                                  failures into a ServingEngine
                                  (pre-prefill, so the failed request
                                  is re-routable).

The reference's other injectors aim at modules the port does not have
yet (checkpoint, store, dataloader, compile cache, router); each comes
with its target module (ROADMAP A9, A11).
"""
from __future__ import annotations

__all__ = ["fail_admission"]


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
