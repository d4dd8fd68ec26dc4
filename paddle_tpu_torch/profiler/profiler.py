"""Profiler core: scheduler states, RecordEvent, host+device capture.

The port's copy of the JAX package's ``profiler/profiler.py``. Host
spans come from its pure-Python recorder. ``ProfilerTarget.GPU`` (the
reference's ``TPU``) drives ``torch.profiler`` with CUDA activities
over each record window: torch's chrome trace is written to
``trace_dir`` (where the reference writes its XPlane) and the card's
kernel, memcpy and memset events join the exported trace on their own
track. A GPU target without a card raises, and so does a device trace
that fails to start or stop: nothing is skipped silently.
"""
from __future__ import annotations

import enum
import json
import os
import threading
import time
from typing import Callable, Iterable, List, Optional

from ..core import prof_hook
from . import metrics


class ProfilerState(enum.Enum):
    """≈ python/paddle/profiler/profiler.py:74 ProfilerState."""
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3   # last record step of a cycle: trace is handed
    # to on_trace_ready


class ProfilerTarget(enum.Enum):
    CPU = 0   # host spans (pure-Python recorder)
    GPU = 1   # torch.profiler device trace (CUDA activities)


def make_scheduler(*, closed: int, ready: int, record: int,
                   repeat: int = 0, skip_first: int = 0) -> Callable:
    """Step-number -> ProfilerState cycle (≈ profiler.py make_scheduler):
    skip_first CLOSED steps once, then cycles of [closed, ready, record]
    with the last record step RECORD_AND_RETURN; repeat=0 cycles forever."""
    if closed < 0 or ready < 0 or record <= 0:
        raise ValueError("closed/ready must be >=0 and record >= 1")
    span = closed + ready + record

    def schedule(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        step -= skip_first
        cycle = step // span
        if repeat > 0 and cycle >= repeat:
            return ProfilerState.CLOSED
        pos = step % span
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == span - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return schedule


def _default_scheduler(step: int) -> ProfilerState:
    return ProfilerState.RECORD


# ------------------------------------------------------------ host events

class _PyRecorder:
    """The host-span recorder (the reference's pure-Python fallback;
    the port has no native tracer)."""

    def __init__(self):
        self.events: List[tuple] = []
        self._stack = threading.local()
        self.enabled = False

    def begin(self, name: str):
        if not self.enabled:
            return
        stack = getattr(self._stack, "s", None)
        if stack is None:
            stack = self._stack.s = []
        stack.append((name, time.perf_counter_ns()))

    def end(self):
        if not self.enabled:
            return
        stack = getattr(self._stack, "s", None)
        if stack:
            name, start = stack.pop()
            self.events.append(
                (name, start, time.perf_counter_ns(),
                 threading.get_ident() % 100000, 0))

    def collect(self):
        out, self.events = self.events, []
        return out


_py_recorder = _PyRecorder()


class RecordEvent:
    """User-facing span (≈ paddle.profiler.RecordEvent): context manager
    and decorator. Events only record while a Profiler is in a RECORD
    state (or after RecordEvent.begin() when used manually)."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    def begin(self):
        _py_recorder.begin(self.name)

    def end(self):
        _py_recorder.end()

    def __call__(self, fn):
        import functools

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with RecordEvent(self.name):
                return fn(*args, **kwargs)

        return wrapped


def _host_enable():
    _py_recorder.enabled = True
    prof_hook.enable(
        lambda name: _py_recorder.begin(name.decode()),
        _py_recorder.end)


def _host_disable():
    _py_recorder.enabled = False
    prof_hook.disable()


def _host_collect() -> List[tuple]:
    """[(name, start_ns, end_ns, tid, mem_bytes)]"""
    return _py_recorder.collect()


#: chrome-trace categories of torch.profiler's device-side events
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _require_card():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError(
            "ProfilerTarget.GPU needs a CUDA card and none is visible; "
            "profile the host with targets=[ProfilerTarget.CPU]")


class _DeviceTrace:
    """One record window's ``torch.profiler`` session with CUDA
    activities. ``stop`` writes torch's chrome trace to ``path`` and
    returns its device-side events (chrome-trace dicts)."""

    def __init__(self):
        _require_card()
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()

    def stop(self, path: str) -> List[dict]:
        import torch
        torch.cuda.synchronize()
        self._prof.stop()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
        return [e for e in trace.get("traceEvents", [])
                if e.get("ph") == "X"
                and e.get("cat") in DEVICE_CATEGORIES]


# ---------------------------------------------------------------- results

class ProfilerResult:
    def __init__(self, events: List[tuple], device_trace_dir: Optional[str],
                 counter_samples: Optional[dict] = None,
                 metrics_snapshot: Optional[dict] = None,
                 device_events: Optional[List[dict]] = None):
        #: [(name, start_ns, end_ns, tid, mem_bytes)]
        self.events = events
        #: directory holding torch.profiler's device trace, if captured
        self.device_trace_dir = device_trace_dir
        #: the card's kernel/memcpy/memset events of the record window
        #: (torch.profiler chrome-trace dicts, ``ts``/``dur`` in us on
        #: torch's clock)
        self.device_events = device_events or []
        #: {metric_name: [(perf_counter_ns, value)]} captured while
        #: recording — becomes "ph": "C" counter tracks in the trace
        self.counter_samples = counter_samples or {}
        #: metrics registry snapshot at end-of-record — feeds the
        #: Memory/Distributed summary views
        self.metrics_snapshot = metrics_snapshot or {}

    def export_chrome_tracing(self, path: str):
        """Write a chrome://tracing / Perfetto JSON: "ph": "X" span
        events for host spans plus "ph": "C" counter events for every
        sampled metric (memory, collective bytes, ...), all under this
        process's real pid so merged multi-host traces stay
        distinguishable (≈ chrometracing_logger.cc output)."""
        pid = os.getpid()
        trace_events = [
            {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": f"host_{pid}"}}]
        trace_events += [
            {"name": name, "ph": "X", "cat": "host",
             "ts": start / 1000.0, "dur": max(end - start, 0) / 1000.0,
             "pid": pid, "tid": tid,
             **({"args": {"bytes": mem}} if mem else {})}
            for name, start, end, tid, mem in self.events]
        for metric, samples in self.counter_samples.items():
            trace_events += [
                {"name": metric, "ph": "C", "cat": "metric",
                 "ts": ts / 1000.0, "pid": pid,
                 "args": {metric: value}}
                for ts, value in samples]
        if self.device_events:
            # the card's events on a track of their own (torch's clock:
            # the host spans above use perf_counter_ns)
            trace_events.append(
                {"name": "process_name", "ph": "M", "pid": f"gpu_{pid}",
                 "tid": 0, "args": {"name": f"gpu_{pid}"}})
            trace_events += [
                {"name": e["name"], "ph": "X", "cat": e["cat"],
                 "ts": e["ts"], "dur": e.get("dur", 0),
                 "pid": f"gpu_{pid}", "tid": e.get("tid", 0)}
                for e in self.device_events]
        trace = {"traceEvents": trace_events}
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(trace, f)
        return path

    def summary(self, sorted_by=None, time_unit: str = "ms") -> str:
        from . import statistic
        if isinstance(sorted_by, SummaryView):
            return statistic.view_table(
                sorted_by.name, self.events, self.metrics_snapshot,
                time_unit=time_unit)
        if sorted_by is None and self.metrics_snapshot:
            return statistic.summary_report(
                self.events, self.metrics_snapshot, time_unit=time_unit)
        return statistic.summary_table(self.events, sorted_by=sorted_by,
                                       time_unit=time_unit)


def export_chrome_tracing(dir_name: str,
                          worker_name: Optional[str] = None) -> Callable:
    """on_trace_ready factory (≈ profiler.py:210): writes
    {dir}/{worker}_{cycle}.json per completed record cycle."""

    def handler(prof: "Profiler"):
        result = prof.result
        if result is None:
            return
        worker = worker_name or f"host_{os.getpid()}"
        path = os.path.join(dir_name, f"{worker}_{prof._cycle}.json")
        result.export_chrome_tracing(path)

    return handler


# --------------------------------------------------------------- profiler

class Profiler:
    """Scheduler-driven profiler combining the host-span recorder with
    torch.profiler device capture (≈ paddle.profiler.Profiler)."""

    def __init__(self, *, targets: Optional[Iterable] = None,
                 scheduler: Optional[Callable] = None,
                 on_trace_ready: Optional[Callable] = None,
                 trace_dir: Optional[str] = None,
                 timer_only: bool = False):
        self.targets = list(targets) if targets is not None else \
            [ProfilerTarget.CPU]
        if ProfilerTarget.GPU in self.targets and not timer_only:
            _require_card()
        if callable(scheduler):
            self.scheduler = scheduler
        elif scheduler is None:
            self.scheduler = _default_scheduler
        elif isinstance(scheduler, (tuple, list)) and len(scheduler) == 2:
            start, end = scheduler
            if not all(isinstance(v, int) for v in (start, end)) \
                    or start < 0 or end <= start:
                raise ValueError(
                    f"scheduler={tuple(scheduler)!r}: a (start, end) "
                    f"tuple needs integers with 0 <= start < end "
                    f"(records steps [start, end))")
            self.scheduler = make_scheduler(
                closed=start, ready=0, record=end - start, repeat=1)
        else:
            raise TypeError(f"bad scheduler {scheduler!r}")
        self.on_trace_ready = on_trace_ready
        self.timer_only = timer_only
        self.trace_dir = trace_dir or os.path.join(
            os.getcwd(), "profiler_log")
        self.result: Optional[ProfilerResult] = None
        self.current_state = ProfilerState.CLOSED
        self._step = 0
        self._cycle = 0
        self._device_trace: Optional[_DeviceTrace] = None
        self._started = False
        self._pending_events: List[tuple] = []  # drained mid-cycle by
        # summary(); folded into the next _finish_record

    # -- lifecycle
    def start(self):
        self._started = True
        self._transition(self.scheduler(self._step))

    def stop(self):
        if not self._started:
            return
        if self.current_state in (ProfilerState.RECORD,
                                  ProfilerState.RECORD_AND_RETURN):
            self._finish_record()
        self._started = False
        self.current_state = ProfilerState.CLOSED

    def step(self):
        """Advance one iteration; drives the state machine. While
        recording, each step boundary also polls device memory into the
        metrics gauges so the trace gets a per-step memory track."""
        if not self._started:
            return
        if not self.timer_only and \
                self.current_state in (ProfilerState.RECORD,
                                       ProfilerState.RECORD_AND_RETURN):
            from ..core import monitor
            monitor.sample_device_memory()
        self._step += 1
        self._transition(self.scheduler(self._step))

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- state machine
    def _transition(self, new: ProfilerState):
        """Called at each step boundary with the next step's state. A
        RECORD_AND_RETURN step flushes when we LEAVE it (its work has
        run by then); leaving RECORD for a non-recording state flushes
        too."""
        old = self.current_state
        rec_old = old in (ProfilerState.RECORD,
                          ProfilerState.RECORD_AND_RETURN)
        rec_new = new in (ProfilerState.RECORD,
                          ProfilerState.RECORD_AND_RETURN)
        if rec_old and (old is ProfilerState.RECORD_AND_RETURN
                        or not rec_new):
            self._finish_record()
            rec_old = False
        if not rec_old and rec_new:
            self._begin_record()
        self.current_state = new

    def _begin_record(self):
        if not self.timer_only:
            _host_enable()
        # drive the metrics registry for the duration of the record
        # window (leave it alone if the user enabled it themselves);
        # timer_only keeps its minimal-overhead contract: no registry,
        # no sampling, no memory polling
        self._metrics_were_enabled = metrics.is_enabled()
        if not self.timer_only:
            metrics.enable()
            metrics.start_sampling()
            from ..core import monitor
            monitor.sample_device_memory()
        if ProfilerTarget.GPU in self.targets and not self.timer_only:
            # a trace that cannot start raises: no silent skip
            self._device_trace = _DeviceTrace()
        self._record_t0 = time.perf_counter()

    def _finish_record(self):
        device_dir, device_events = None, None
        if self._device_trace is not None:
            trace, self._device_trace = self._device_trace, None
            device_events = trace.stop(os.path.join(
                self.trace_dir,
                f"device_{os.getpid()}_{self._cycle}.json"))
            device_dir = self.trace_dir
        if not self.timer_only:
            _host_disable()
            events = self._pending_events + _host_collect()
            self._pending_events = []
            # sampled serving-request spans (flight recorder) that
            # completed inside the record window join the same trace:
            # queue-wait/prefill/decode segments render as "ph": "X"
            # slices next to RecordEvent spans and counter tracks
            from ..core import flight_recorder
            t0_ns = int(getattr(self, "_record_t0", 0) * 1e9)
            events += flight_recorder.spans_between(
                t0_ns, time.perf_counter_ns())
        else:
            events = []
        if not self.timer_only:
            from ..core import monitor
            monitor.sample_device_memory()
            snapshot = metrics.snapshot()
            counter_samples = metrics.stop_sampling()
            if not getattr(self, "_metrics_were_enabled", False):
                metrics.disable()
        else:
            snapshot, counter_samples = None, None
        self.result = ProfilerResult(events, device_dir,
                                     counter_samples, snapshot,
                                     device_events)
        self._cycle += 1
        if self.on_trace_ready is not None:
            self.on_trace_ready(self)

    def summary(self, sorted_by=None, time_unit: str = "ms"):
        """Print the aggregated span table. Read-only with respect to the
        cycle state machine: calling it mid-recording peeks at the events
        recorded so far (they still appear in the final trace) and does
        NOT fire on_trace_ready or advance the cycle counter."""
        result = self.result
        if self.current_state in (ProfilerState.RECORD,
                                  ProfilerState.RECORD_AND_RETURN) \
                and not self.timer_only:
            self._pending_events += _host_collect()
            result = ProfilerResult(list(self._pending_events), None,
                                    None, metrics.snapshot())
        if result is None:
            print("No profiler data recorded.")
            return
        print(result.summary(sorted_by=sorted_by, time_unit=time_unit))


class SummaryView(enum.Enum):
    """Which table summary() prints (reference profiler/profiler.py
    SummaryView)."""
    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    MemoryView = 6
    MemoryManipulationView = 7
    UDFView = 8


def export_protobuf(result: "ProfilerResult", path: str):
    """Persist a ProfilerResult (reference export_protobuf writes the
    profiler protobuf dump; here a self-contained pickle of the host
    spans + device-trace pointer — load_profiler_result reads it)."""
    import pickle
    with open(path, "wb") as f:
        pickle.dump({"events": result.events,
                     "device_trace_dir": result.device_trace_dir,
                     "counter_samples": result.counter_samples,
                     "metrics_snapshot": result.metrics_snapshot,
                     "device_events": result.device_events}, f)


def load_profiler_result(path: str) -> "ProfilerResult":
    """Reload a dump written by export_protobuf (reference
    load_profiler_result)."""
    import pickle
    with open(path, "rb") as f:
        d = pickle.load(f)
    return ProfilerResult(d["events"], d.get("device_trace_dir"),
                          d.get("counter_samples"),
                          d.get("metrics_snapshot"),
                          d.get("device_events"))
