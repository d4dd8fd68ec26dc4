"""Inference benchmarking (the JAX package's ``inference/benchmark.py``):
``Benchmark``, the reference's name / batch size / latency bookkeeping,
and ``device_time_per_run``, the two-point slope.

``device_time_per_run`` runs ``predictor.run`` N times in a dependent
chain (each run's first float input multiplied by ``1 + 0 * sum(the
previous run's float outputs)``), times the chain at two values of N and
returns the difference over the difference in N, so the fixed cost of
starting and ending a chain cancels. On a CUDA card the chain is timed
with CUDA events recorded around its N runs; on the CPU with
``perf_counter``.

What the slope measures: PyTorch launches each kernel from the host, so
the events span the card's stream from the first launch to the last
kernel's end. When the card outruns the host (a small decode step: many
short kernels), the stream waits for launches and the slope is the
HOST's time per run, not the card's busy time; when the card is the
slower side it is the card's time per run. Read it beside a profiler's
device busy time for the same run (``chip_smoke.py`` prints both).
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

__all__ = ["Benchmark", "device_time_per_run"]


def _tie(feeds: List[torch.Tensor], outs: List[torch.Tensor]):
    """``feeds`` with the first float feed made to depend on ``outs``
    (same values: ``x * (1 + 0 * tie)``). An all-integer feed list (token
    ids) ties its first feed through ``x + 0 * isnan(tie)``, which adds 0
    whatever ``tie`` holds; the JAX function raises for such a list."""
    floats = [o.sum(dtype=torch.float32) for o in outs
              if o.is_floating_point()]
    if not floats:
        return feeds
    tie = sum(floats)
    new, tied = [], False
    for f in feeds:
        if not tied and f.is_floating_point():
            f = f * (1 + 0 * tie).to(f.dtype)
            tied = True
        new.append(f)
    if not tied:
        new[0] = new[0] + 0 * torch.isnan(tie).to(new[0].dtype)
    return new


def device_time_per_run(predictor, inputs: Sequence, iters: Sequence[int] =
                        (8, 40), repeats: int = 3) -> float:
    """Seconds per ``predictor.run(inputs)``, by the two-point slope of
    the module docstring (best of ``repeats`` at each N)."""
    dev = predictor.device
    feeds = [a.to(dev) if isinstance(a, torch.Tensor)
             else torch.as_tensor(np.asarray(a), device=dev) for a in inputs]
    n_lo, n_hi = min(iters), max(iters)
    if n_hi == n_lo:
        raise ValueError("need two distinct iteration counts")
    cuda = dev.type == "cuda"

    def chain(n):
        f = feeds
        for _ in range(n):
            f = _tie(f, predictor._run_fn(f))
        return f

    times = {}
    for n in (n_lo, n_hi):
        chain(n)                                   # warm
        if cuda:
            torch.cuda.synchronize(dev)
        best = float("inf")
        for _ in range(repeats):
            if cuda:
                s, e = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                s.record()
                chain(n)
                e.record()
                e.synchronize()
                t = s.elapsed_time(e) / 1e3
            else:
                t0 = time.perf_counter()
                chain(n)
                t = time.perf_counter() - t0
            best = min(best, t)
        times[n] = best
    return max((times[n_hi] - times[n_lo]) / (n_hi - n_lo), 0.0)


class Benchmark:
    """Latency / QPS bookkeeping, as the reference's Benchmark: a name,
    a batch size, recorded latencies, a one-line report."""

    def __init__(self, name: str = "", batch_size: int = 1):
        self.name = name
        self.batch_size = batch_size
        self.latency_ms: Optional[float] = None
        self._records: List[float] = []

    def set_name(self, name: str):
        self.name = name

    def set_batch_size(self, batch_size: int):
        self.batch_size = batch_size

    def record(self, seconds: float):
        self._records.append(seconds)
        self.latency_ms = float(np.mean(self._records)) * 1e3

    def measure(self, predictor, inputs, **kw):
        """Record ``device_time_per_run`` of a predictor."""
        self.record(device_time_per_run(predictor, inputs, **kw))
        return self.latency_ms

    @property
    def qps(self) -> Optional[float]:
        if not self.latency_ms:
            return None
        return self.batch_size / (self.latency_ms / 1e3)

    def report(self) -> str:
        lat = f"{self.latency_ms:.3f} ms" if self.latency_ms else "n/a"
        qps = f"{self.qps:.1f}" if self.qps else "n/a"
        line = (f"[benchmark] name={self.name} batch={self.batch_size} "
                f"latency={lat} qps={qps}")
        print(line)
        return line
