"""User-facing address of the runtime metrics registry.

The implementation lives in core.metrics (below every instrumented
layer, imports nothing else of the package); this module is the same
registry re-exported where users expect it, next to Profiler:

    from paddle_tpu_torch.profiler import metrics
    metrics.enable()
    metrics.counter("my.counter").inc()
    print(metrics.report())
"""
from ..core.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                            counter, disable, enable, gauge, histogram,
                            is_enabled, is_sampling, on_state_change,
                            report, reset, snapshot, start_sampling,
                            stop_sampling)
