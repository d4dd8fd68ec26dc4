"""Profiler subsystem.

Reference analog: python/paddle/profiler/profiler.py (Profiler with
scheduler states :74, export_chrome_tracing :210, RecordEvent
instrumentation) over the C++ HostTracer/CudaTracer pair
(paddle/fluid/platform/profiler/). Here:

- host spans come from the pure-Python recorder (the JAX package's
  fallback; the port has no native tracer);
- device traces come from ``torch.profiler`` with CUDA activities
  (``ProfilerTarget.GPU``, the reference's ``TPU`` target), started and
  stopped by the same scheduler states; the card's kernels join the
  exported chrome trace, and torch's own trace lands in ``trace_dir``;
- op-level spans will be emitted through prof_hook by the op registry
  (ROADMAP A2) when a Profiler is recording.

Usage (reference API shape):

    import paddle_tpu_torch.profiler as profiler
    p = profiler.Profiler(
        targets=[profiler.ProfilerTarget.CPU, profiler.ProfilerTarget.GPU],
        scheduler=profiler.make_scheduler(closed=1, ready=1, record=3),
        on_trace_ready=profiler.export_chrome_tracing('./log'))
    p.start()
    for it, batch in enumerate(loader()):
        train_step(batch)
        p.step()
    p.stop()
    p.summary()
"""
from . import metrics  # noqa: F401
from .profiler import (Profiler, ProfilerResult, ProfilerState,  # noqa: F401
                       ProfilerTarget, RecordEvent, SummaryView,
                       export_chrome_tracing, export_protobuf,
                       load_profiler_result, make_scheduler)
from .statistic import (SortedKeys, summary_report,  # noqa: F401
                        summary_table, view_table)
