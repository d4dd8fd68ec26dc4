"""Op-level profiling hook: a near-zero-cost global the op dispatcher
checks so RecordEvent spans wrap every op only while a Profiler records
(≈ the RecordEvent calls inside the reference's executors,
fluid/framework/new_executor/interpretercore.cc op-run instrumentation).

The profiler installs begin/end callables (the pure-Python recorder;
the port has no native tracer); they need no shared mutable state, so
concurrent op dispatch from multiple threads records correct names.
The port's op registry (ROADMAP A2) is what will call ``begin``/``end``;
until then only the profiler toggles the hook.
"""
from __future__ import annotations

enabled = False
_begin = None
_end = None


def enable(begin_fn, end_fn):
    """begin_fn(name: bytes) opens a span on the calling thread;
    end_fn() closes the innermost open span of the calling thread."""
    global enabled, _begin, _end
    _begin = begin_fn
    _end = end_fn
    enabled = True


def disable():
    global enabled
    enabled = False


def begin(name: bytes):
    _begin(name)


def end():
    _end()
