"""Preemption-safe shutdown (the JAX package's
``distributed/resilience.py``, its preemption part).

- ``GracefulShutdown``: SIGTERM/SIGINT set a flag; ``check(step)`` at
  the next step boundary runs every registered emergency save
  synchronously and exits with ``ELASTIC_EXIT_CODE`` so a launcher
  relaunches the job. ``ServingEngine.serve_forever`` reads
  ``preempted`` on every loop iteration and drains instead.
- ``register_emergency``: process-wide ``save_fn(step)`` callbacks.
- ``active()``, ``preempted()``, ``poll()``: the innermost live context,
  for loops (and the telemetry server's ``/readyz``) that did not
  create it themselves.

Not ported yet (ROADMAP A11): the cross-host broadcast through a
TCPStore (``GracefulShutdown(store=...)`` raises), ``Watchdog``,
``AnomalyGuard`` and ``guarded_call``.
"""
from __future__ import annotations

import os
import signal
import sys
import threading
import time
from typing import Callable, List, Optional, Tuple

from ..core import flight_recorder, monitor

__all__ = ["ELASTIC_EXIT_CODE", "GracefulShutdown", "PREEMPT_KEY",
           "active", "poll", "preempted", "register_emergency"]

#: the launcher's "relaunch me" exit code (the JAX package's
#: ``distributed.elastic.ELASTIC_EXIT_CODE``)
ELASTIC_EXIT_CODE = 101
PREEMPT_KEY = "__resilience/preempted"


# ---------------------------------------------------- emergency checkpoint

# (save_fn(step) -> None) registered process-wide; GracefulShutdown runs
# every entry synchronously when a preemption lands
_EMERGENCY: List[Tuple[int, Callable[[int], None]]] = []
_EMERGENCY_LOCK = threading.Lock()
_EMERGENCY_SEQ = 0


def register_emergency(save_fn: Callable[[int], None]) -> Callable[[], None]:
    """Register ``save_fn(step)`` to run on preemption; returns an
    unregister callable."""
    global _EMERGENCY_SEQ
    with _EMERGENCY_LOCK:
        _EMERGENCY_SEQ += 1
        entry = (_EMERGENCY_SEQ, save_fn)
        _EMERGENCY.append(entry)

    def unregister():
        with _EMERGENCY_LOCK:
            try:
                _EMERGENCY.remove(entry)
            except ValueError:
                pass

    return unregister


def _run_emergency_saves(step: int) -> int:
    with _EMERGENCY_LOCK:
        entries = list(_EMERGENCY)
    done = 0
    for _, fn in entries:
        try:
            fn(step)
            done += 1
        except Exception as e:
            # one broken saver must not stop the others from committing
            monitor.record_swallowed("emergency_save", e)
    if done:
        monitor.record_emergency_save(step)
    return done


# ------------------------------------------------------- graceful shutdown

_ACTIVE: List["GracefulShutdown"] = []


class GracefulShutdown:
    """Preemption-safe shutdown context for a training or serving loop.

    ::

        register_emergency(lambda step: save(model, step))
        with GracefulShutdown() as gs:
            for step, batch in enumerate(loader):
                train_step(batch)
                gs.check(step)   # preempted? -> emergency save + exit 101

    The signal handler only sets a flag (no locks: the signal may land
    while this very thread holds one). ``check(step)`` at the next step
    boundary does the work. ``incarnation`` (default
    ``PADDLE_RESTART_COUNT``) namespaces the flag key, so a relaunched
    job never reads its predecessor's flag."""

    def __init__(self, store=None,
                 signals=(signal.SIGTERM, signal.SIGINT),
                 exit_code: int = ELASTIC_EXIT_CODE,
                 exit_on_save: bool = True,
                 key: str = PREEMPT_KEY,
                 incarnation: Optional[str] = None):
        if store is not None:
            raise NotImplementedError(
                "GracefulShutdown(store=...) broadcasts the preemption "
                "through a TCPStore, which is not ported yet (ROADMAP A11)")
        self.store = None
        self.signals = tuple(signals)
        self.exit_code = exit_code
        self.exit_on_save = exit_on_save
        if incarnation is None:
            incarnation = os.environ.get("PADDLE_RESTART_COUNT", "0")
        self.key = f"{key}/{incarnation}"
        self._signaled = threading.Event()
        self._prev_handlers = {}
        self._installed = False

    # --------------------------------------------------------------- signals
    def _handler(self, signum, frame):
        # async-signal-safe by construction: set a flag, nothing else
        self._signaled.set()

    def __enter__(self) -> "GracefulShutdown":
        if threading.current_thread() is threading.main_thread():
            for sig in self.signals:
                self._prev_handlers[sig] = signal.signal(sig, self._handler)
            self._installed = True
        else:
            monitor.record_swallowed(
                "graceful_shutdown.install",
                RuntimeError("signal handlers need the main thread; "
                             "only trigger() can preempt"))
        _ACTIVE.append(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._installed:
            for sig, prev in self._prev_handlers.items():
                try:
                    signal.signal(sig, prev)
                except (ValueError, OSError) as e:
                    monitor.record_swallowed("graceful_shutdown.restore", e)
            self._prev_handlers.clear()
            self._installed = False
        try:
            _ACTIVE.remove(self)
        except ValueError:
            pass
        return False

    # ------------------------------------------------------------- preempted
    @property
    def preempted(self) -> bool:
        """True once this process was signaled or ``trigger()`` ran."""
        return self._signaled.is_set()

    def trigger(self) -> None:
        """Programmatic preemption (tests, cluster-notice pollers)."""
        self._signaled.set()

    # ----------------------------------------------------------------- check
    def check(self, step: int) -> bool:
        """Call at every step boundary. Returns False in the happy path;
        on preemption: dump, emergency saves, exit."""
        if not self.preempted:
            return False
        from ..core import goodput
        t_recover = time.perf_counter()
        monitor.record_preemption()
        # the dump comes BEFORE the saves: if a save wedges, the black
        # box already shows the step the process reached
        flight_recorder.record("resilience.preemption", step=int(step),
                               source="signal")
        flight_recorder.auto_dump("preemption")
        _run_emergency_saves(int(step))
        goodput.charge("preemption_recovery",
                       time.perf_counter() - t_recover)
        if self.exit_on_save:
            sys.exit(self.exit_code)
        return True


def active() -> Optional[GracefulShutdown]:
    """The innermost live GracefulShutdown context, if any."""
    return _ACTIVE[-1] if _ACTIVE else None


def preempted() -> bool:
    gs = active()
    return gs.preempted if gs is not None else False


def poll(step: int) -> bool:
    """Step-boundary hook for loops that did not create the context
    themselves: the active GracefulShutdown's ``check()``, a no-op when
    none is installed."""
    gs = active()
    return gs.check(step) if gs is not None else False
