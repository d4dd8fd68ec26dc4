"""Runtime monitor: the near-zero-cost instrumentation facade hot paths
call into (same pattern as core.prof_hook — a module-global bool guards
every entry point, so a disabled monitor costs one attribute load and a
branch per call site).

The port's copy of the JAX package's ``core/monitor.py``.
``DECLARED_METRICS``, ``METRIC_DOC`` and every ``record_*`` signature
are the reference's, so a module ported later records into a name
already declared. The port has no retraces: ``record_retrace`` and
``retrace_count`` stay for the schema and nothing calls them; the
goodput ``compile`` bucket is charged when a dispatch built a kernel
at its first use (``kernels/_build.py`` ``build_count``).

Reference analog: the reference wires its stat singletons straight into
the executors (interpretercore op counters, ProcessGroup collective
stats, AmpScaler's found_inf bookkeeping). Here those call sites go
through this one module, which forwards to the generic registry in
profiler.metrics; the profiler drains that registry into the Chrome
trace and the summary views.

Metric name scheme (what the summary views group by):

    jit.compile{cause=...}      retraces by cause (first/new_shape/...)
    jit.compile.total           all retraces
    jit.compile_cache.hits      executable-store loads (zero XLA compiles)
    jit.compile_cache.misses{cause=...}   absent | corrupt | stale_ref
    jit.compile_cache.bytes     serialized-executable bytes moved
    jit.compile_cache.load_ms / .save_ms  store latency histograms (ms)
    static.program_builds       program_guard graph captures
    static.ops_recorded         ops appended to static programs
    comm.ops{axis=...,op=...}   collective launches per mesh axis
    comm.bytes{axis=...,op=...} payload bytes per mesh axis
    io.batches / io.samples / io.bytes    dataloader throughput
    io.worker.deaths / io.worker.respawns{worker=...}   pool supervision
    io.sample.quarantined       bad/non-finite samples skipped
    io.host2device.placed / .skipped / .bytes   device placements (a
                                skip = the leaf already sat on the
                                target sharding, placement idempotent)
    train.loss_fetches          loss scalars read back by the async loop
    train.host_syncs            the subset that BLOCKED (device not done)
    amp.scaler.steps / amp.scaler.skipped / amp.loss_scale
    device.memory.allocated / device.memory.reserved   gauges (bytes)
    resilience.preemptions / resilience.emergency_saves
    resilience.watchdog.timeouts{label=...}   hang-watchdog expiries
    resilience.ckpt.fallback    corrupt checkpoint steps skipped on restore
    train.anomalies / train.anomaly_restores  non-finite-loss guard
    errors.swallowed{where=...} deliberately swallowed exceptions
    gen.tokens / gen.prefill_steps / gen.decode_steps   generation loop
    gen.cache_occupancy         gauge: KV cache fraction in use
    gen.cache.pages_allocated / .pages_freed   paged-pool allocator churn
    gen.cache.quant.bytes_saved HBM bytes the int8 KV cache saved vs wide
    gen.cache.quant.scale_clips int8 saturations during cache quantization
    serve.cache.page_occupancy  gauge: referenced pages / pool
    serve.cache.kv_dtype        info gauge: the served cache dtype label
    serve.cache.prefix_hits / .prefix_shared_pages / .cow_copies
                                shared-prefix reuse at admission
    gen.spec.proposed / .accepted   speculative draft tokens in/out of
                                the single-dispatch verify
    gen.spec.accept_rate        gauge: accepted/proposed, last window
    serve.requests{status=...}  terminal request outcomes (completed/
                                cancelled/rejected) — QPS = rate of this
    serve.queue_depth           gauge: requests waiting for a slot
    serve.ttft                  histogram (s): submit -> first token
    serve.token_latency         histogram (s): per-token decode cadence
    serve.slot_occupancy        gauge: busy decode slots / max_batch
    serve.cancellations{reason=...}   deadline/shutdown cancellations
    analysis.findings{check=,severity=}   static-audit findings
    analysis.mem.peak_bytes     gauge: planned peak HBM per program
    analysis.mem.budget_violations   programs over their HBM budget
    telemetry.scrapes{endpoint=...}   telemetry-server HTTP requests
    flightrecorder.dumps{reason=...}  flight-recorder dump files written
    fleet.publishes             metric snapshots published to the store
    fleet.ranks_total / fleet.ranks_stale   aggregator's rank census
    fleet.clock_skew_ns{rank=...}   per-rank clock offset vs the store
    train.goodput.seconds{bucket=...} / serve.goodput.seconds{bucket=...}
                                step-time ledger buckets (compute |
                                compile | data_stall | checkpoint |
                                preemption_recovery | idle)
    train.goodput.fraction / serve.goodput.fraction   compute/wall
    train.step_time             per-step wall-time histogram (s)
    train.straggler{rank=...}   straggler detections per rank
    serve.cost.*                per-request cost attribution (prefill
                                ms, decode-window share ms, page*s)
    slo.state / slo.burn_rate / slo.transitions   watchtower SLO
                                evaluation (per scope+slo)
"""
from __future__ import annotations

from . import flight_recorder, metrics

# The declared metric-name families. Every hot-path call site records
# through this module's recorders, so this set IS the schema; the
# framework lint (tools/lint rule `metric-name`) parses this literal
# and rejects any `metrics.counter("...")` elsewhere in the package
# whose name is not declared here — an undeclared name is either a typo
# (a counter nobody will ever read) or a missing schema entry.
DECLARED_METRICS = frozenset({
    "jit.compile", "jit.compile.total",
    "jit.compile_cache.hits", "jit.compile_cache.misses",
    "jit.compile_cache.bytes", "jit.compile_cache.load_ms",
    "jit.compile_cache.save_ms",
    "static.program_builds", "static.ops_recorded",
    "comm.ops", "comm.bytes",
    "io.batches", "io.samples", "io.bytes", "io.batch_bytes",
    "io.worker.deaths", "io.worker.respawns", "io.sample.quarantined",
    "io.host2device.placed", "io.host2device.skipped",
    "io.host2device.bytes",
    "train.loss_fetches", "train.host_syncs",
    "amp.scaler.steps", "amp.scaler.skipped", "amp.loss_scale",
    "device.memory.allocated", "device.memory.reserved",
    "resilience.preemptions", "resilience.emergency_saves",
    "resilience.emergency_save_step", "resilience.watchdog.timeouts",
    "resilience.ckpt.fallback", "resilience.ckpt.last_skipped_step",
    "train.anomalies", "train.anomaly_restores",
    "errors.swallowed",
    "gen.tokens", "gen.prefill_steps", "gen.decode_steps",
    "gen.cache_occupancy",
    "gen.cache.pages_allocated", "gen.cache.pages_freed",
    "gen.cache.quant.bytes_saved", "gen.cache.quant.scale_clips",
    "gen.spec.proposed", "gen.spec.accepted", "gen.spec.accept_rate",
    "serve.requests", "serve.queue_depth", "serve.ttft",
    "serve.token_latency", "serve.slot_occupancy", "serve.cancellations",
    "serve.prefill.chunks", "serve.prefill.chunk_tokens",
    "serve.prefill.interleave_ratio",
    "serve.cache.page_occupancy", "serve.cache.kv_dtype",
    "serve.cache.prefix_hits",
    "serve.cache.prefix_shared_pages", "serve.cache.cow_copies",
    "serve.router.admissions", "serve.router.reroutes",
    "serve.router.rejected", "serve.router.breaker.trips",
    "serve.router.breaker.state", "serve.router.replicas",
    "analysis.findings",
    "analysis.mem.peak_bytes", "analysis.mem.budget_violations",
    "telemetry.scrapes", "flightrecorder.dumps",
    "fleet.publishes", "fleet.ranks_total", "fleet.ranks_stale",
    "fleet.rank_up", "fleet.clock_skew_ns",
    "train.goodput.seconds", "train.goodput.fraction",
    "serve.goodput.seconds", "serve.goodput.fraction",
    "train.step_time", "train.straggler",
    "serve.cost.prefill_ms", "serve.cost.decode_ms", "serve.cost.page_s",
    "slo.state", "slo.burn_rate", "slo.transitions",
})

# The human-facing schema behind DECLARED_METRICS: name -> (kind,
# label names, one-line description). `python -m tools.metrics_doc`
# renders docs/metrics.md from this table, and a tier-1 drift test
# asserts (a) its keys == DECLARED_METRICS and (b) the generated doc
# matches the committed one — the schema cannot silently diverge from
# its documentation. (DECLARED_METRICS stays a separate frozenset
# literal because tools/lint parses it by AST without importing us.)
METRIC_DOC = {
    "jit.compile": ("counter", ("cause",),
                    "jax.jit cache misses (retraces) by cause: first | "
                    "new_shape | new_dtype | new_structure | "
                    "donation_miss"),
    "jit.compile.total": ("counter", (),
                          "all retraces across every jitted entry point"),
    "jit.compile_cache.hits": ("counter", (),
                               "executable-store loads (a compiled "
                               "program deserialized instead of "
                               "XLA-compiled)"),
    "jit.compile_cache.misses": ("counter", ("cause",),
                                 "executable-store misses: absent | "
                                 "corrupt | stale_ref"),
    "jit.compile_cache.bytes": ("counter", (),
                                "serialized-executable bytes moved "
                                "(loads + saves)"),
    "jit.compile_cache.load_ms": ("histogram", (),
                                  "executable deserialize+load latency "
                                  "(ms)"),
    "jit.compile_cache.save_ms": ("histogram", (),
                                  "executable serialize+commit latency "
                                  "(ms)"),
    "static.program_builds": ("counter", (),
                              "program_guard static-graph captures"),
    "static.ops_recorded": ("counter", (),
                            "ops appended to static programs"),
    "comm.ops": ("counter", ("axis", "op"),
                 "eager collective launches per mesh axis"),
    "comm.bytes": ("counter", ("axis", "op"),
                   "eager collective payload bytes per mesh axis"),
    "io.batches": ("counter", (), "DataLoader batches produced"),
    "io.samples": ("counter", (), "DataLoader samples produced"),
    "io.bytes": ("counter", (), "DataLoader bytes produced"),
    "io.batch_bytes": ("histogram", (),
                       "per-batch byte-size distribution"),
    "io.worker.deaths": ("counter", ("worker",),
                         "DataLoader workers found dead "
                         "(crash/OOM/SIGKILL)"),
    "io.worker.respawns": ("counter", ("worker",),
                           "dead DataLoader workers respawned"),
    "io.sample.quarantined": ("counter", (),
                              "bad/non-finite samples skipped by the "
                              "quarantine"),
    "io.host2device.placed": ("counter", (),
                              "batch leaves transferred host->device"),
    "io.host2device.skipped": ("counter", (),
                               "leaves already resident on their target "
                               "sharding (idempotent placement)"),
    "io.host2device.bytes": ("counter", (),
                             "host->device bytes transferred"),
    "train.loss_fetches": ("counter", (),
                           "loss scalars read back by the async train "
                           "loop"),
    "train.host_syncs": ("counter", (),
                         "loss read-backs that actually blocked (true "
                         "pipeline stalls; gated by "
                         "test_host_sync_gate)"),
    "amp.scaler.steps": ("counter", (), "GradScaler steps"),
    "amp.scaler.skipped": ("counter", (),
                           "GradScaler steps skipped on found_inf"),
    "amp.loss_scale": ("gauge", (), "current loss scale"),
    "device.memory.allocated": ("gauge", (),
                                "live device bytes (peak tracked)"),
    "device.memory.reserved": ("gauge", (),
                               "reserved device bytes (peak tracked)"),
    "resilience.preemptions": ("counter", (),
                               "preemptions observed at a step boundary"),
    "resilience.emergency_saves": ("counter", (),
                                   "emergency checkpoint rounds run"),
    "resilience.emergency_save_step": ("gauge", (),
                                       "step id of the last emergency "
                                       "save"),
    "resilience.watchdog.timeouts": ("counter", ("label",),
                                     "hang-watchdog expiries by guarded "
                                     "region"),
    "resilience.ckpt.fallback": ("counter", (),
                                 "corrupt/uncommitted checkpoint steps "
                                 "skipped on restore"),
    "resilience.ckpt.last_skipped_step": ("gauge", (),
                                          "step id last skipped as "
                                          "corrupt"),
    "train.anomalies": ("counter", (),
                        "non-finite losses skipped by the anomaly "
                        "guard"),
    "train.anomaly_restores": ("counter", (),
                               "anomaly-guard restores from the last "
                               "good snapshot"),
    "errors.swallowed": ("counter", ("where",),
                         "deliberately swallowed exceptions (always "
                         "logged)"),
    "gen.tokens": ("counter", (),
                   "real generated tokens (live rows, up to eos)"),
    "gen.prefill_steps": ("counter", (), "prefill dispatches"),
    "gen.decode_steps": ("counter", (), "decode dispatches"),
    "gen.cache_occupancy": ("gauge", (),
                            "KV-cache fraction in use (max over rows)"),
    "gen.cache.pages_allocated": ("counter", (),
                                  "paged-KV pool pages taken from the "
                                  "free list (admission installs)"),
    "gen.cache.pages_freed": ("counter", (),
                              "paged-KV pool pages returned to the "
                              "free list (request completion/eviction "
                              "and prefix-registry reclaims)"),
    "gen.cache.quant.bytes_saved": ("counter", (),
                                    "HBM bytes the int8 KV cache "
                                    "avoided holding vs the wide dtype "
                                    "(values + bf16 scale sidecars "
                                    "accounted; per cache build)"),
    "gen.cache.quant.scale_clips": ("counter", (),
                                    "KV values that saturated the int8 "
                                    "range during cache quantization — "
                                    "structurally 0 under the absmax "
                                    "scale scheme (gated in tier-1); "
                                    "nonzero means a scale scheme "
                                    "change started clipping"),
    "gen.spec.proposed": ("counter", (),
                          "draft tokens proposed to speculative verify "
                          "(k per live row per window)"),
    "gen.spec.accepted": ("counter", (),
                          "draft tokens accepted by speculative verify "
                          "(emitted without a correction)"),
    "gen.spec.accept_rate": ("gauge", (),
                             "accepted/proposed over the last recorded "
                             "speculative window batch"),
    "serve.requests": ("counter", ("status",),
                       "requests reaching a terminal status: completed "
                       "| cancelled | rejected (QPS = rate of this)"),
    "serve.queue_depth": ("gauge", (),
                          "requests waiting for a decode slot"),
    "serve.ttft": ("histogram", (),
                   "time-to-first-token (s), submit -> prefill token, "
                   "includes queue wait"),
    "serve.token_latency": ("histogram", (),
                            "per-token decode cadence (s) per scheduler "
                            "poll window"),
    "serve.slot_occupancy": ("gauge", (),
                             "busy decode slots / max_batch"),
    "serve.cancellations": ("counter", ("reason",),
                            "requests cancelled before completing: "
                            "deadline | shutdown | error"),
    "serve.prefill.chunks": ("counter", (),
                             "chunked-prefill chunks dispatched (one "
                             "per scheduler iteration a long prompt "
                             "filled its KV incrementally)"),
    "serve.prefill.chunk_tokens": ("counter", (),
                                   "prompt tokens written via chunked "
                                   "prefill (rate vs gen.tokens shows "
                                   "the prefill/decode interleave mix)"),
    "serve.prefill.interleave_ratio": ("gauge", (),
                                       "decode steps dispatched per "
                                       "prefill chunk over the last "
                                       "chunked admission (0 = the "
                                       "chunks ran back-to-back, i.e. "
                                       "no decode traffic to protect)"),
    "serve.cache.page_occupancy": ("gauge", (),
                                   "paged-KV pool pressure: pages "
                                   "referenced by live rows / pool "
                                   "size (excl. the null page)"),
    "serve.cache.kv_dtype": ("gauge", ("dtype",),
                             "info gauge (value 1): the KV-cache "
                             "storage dtype this engine serves (int8 "
                             "| float32 | bfloat16 | ...)"),
    "serve.cache.prefix_hits": ("counter", (),
                                "admissions whose prompt prefix "
                                "hash-matched registered pages (shared "
                                "instead of re-stored)"),
    "serve.cache.prefix_shared_pages": ("counter", (),
                                        "pages REFERENCED instead of "
                                        "allocated at admission (the "
                                        "HBM the sharing saved, in "
                                        "pages)"),
    "serve.cache.cow_copies": ("counter", (),
                               "copy-on-write page privatizations: a "
                               "prompt diverged inside a shared page "
                               "and got a private copy at admission"),
    "serve.router.admissions": ("counter", ("replica",),
                                "requests the FleetRouter placed, by "
                                "replica — the rebalance evidence when "
                                "a replica is drained or broken"),
    "serve.router.reroutes": ("counter", ("reason",),
                              "re-route attempts after a rejected or "
                              "failed placement, by trigger: "
                              "queue_full[:no_free_{pages,slots}] | "
                              "shutdown | admission_error | error"),
    "serve.router.rejected": ("counter", (),
                              "requests the router could place on NO "
                              "replica (every candidate draining, "
                              "broken, or at bound)"),
    "serve.router.breaker.trips": ("counter", ("replica",),
                                   "circuit-breaker OPEN transitions "
                                   "by replica (consecutive failures "
                                   "reached the threshold, or a "
                                   "half-open probe failed)"),
    "serve.router.breaker.state": ("gauge", ("replica",),
                                   "per-replica breaker state: "
                                   "0=closed 1=half_open 2=open"),
    "serve.router.replicas": ("gauge", (),
                              "replicas currently in the router's "
                              "rotation (drained/removed ones "
                              "excluded)"),
    "analysis.findings": ("counter", ("check", "severity"),
                          "static-audit findings by detector and "
                          "severity"),
    "analysis.mem.peak_bytes": ("gauge", ("program",),
                                "statically planned peak live HBM "
                                "bytes of one audited program "
                                "(MemoryPlan.peak_bytes)"),
    "analysis.mem.budget_violations": ("counter", ("program",),
                                       "audited programs whose "
                                       "planned peak exceeded the "
                                       "declared HBM budget "
                                       "(mem.budget ERROR findings)"),
    "telemetry.scrapes": ("counter", ("endpoint",),
                          "telemetry-server HTTP requests by endpoint "
                          "(metrics | healthz | readyz | "
                          "flightrecorder | fleet_metrics | "
                          "fleet_healthz | slo)"),
    "flightrecorder.dumps": ("counter", ("reason",),
                             "flight-recorder dump files written "
                             "(watchdog | preemption | anomaly_restore "
                             "| serve_crash | fit_crash | manual)"),
    "fleet.publishes": ("counter", (),
                        "metric snapshots this process published to "
                        "the fleet TCPStore (delta-encoded)"),
    "fleet.ranks_total": ("gauge", (),
                          "ranks the fleet aggregator has ever seen "
                          "publish (stale ranks stay counted — never "
                          "silently dropped)"),
    "fleet.ranks_stale": ("gauge", (),
                          "ranks past the publish deadline at the "
                          "last aggregator poll"),
    "fleet.rank_up": ("gauge", ("rank", "incarnation"),
                      "1 while the rank publishes within the "
                      "deadline, 0 once stale (the per-rank face of "
                      "fleet.ranks_stale)"),
    "fleet.clock_skew_ns": ("gauge", ("rank",),
                            "per-rank wall-clock offset vs the fleet "
                            "store's master clock (the trace-merge "
                            "alignment term), from the ping "
                            "handshake"),
    "train.goodput.seconds": ("counter", ("bucket",),
                              "train wall time by ledger bucket: "
                              "compute | compile | data_stall | "
                              "checkpoint | preemption_recovery | "
                              "idle (buckets sum to wall time)"),
    "train.goodput.fraction": ("gauge", (),
                               "train goodput over the last ledger "
                               "flush window: compute seconds / wall "
                               "seconds"),
    "serve.goodput.seconds": ("counter", ("bucket",),
                              "serve wall time by ledger bucket: "
                              "compute | compile | data_stall | "
                              "checkpoint | preemption_recovery | "
                              "idle (buckets sum to wall time)"),
    "serve.goodput.fraction": ("gauge", (),
                               "serve goodput over the last ledger "
                               "flush window: compute seconds / wall "
                               "seconds"),
    "train.step_time": ("histogram", (),
                        "per-step wall time (s) measured around the "
                        "dispatched train step — the series the fleet "
                        "straggler detector and the step-time SLO "
                        "evaluate"),
    "train.straggler": ("counter", ("rank",),
                        "straggler detections: a rank's windowed mean "
                        "step time crossed the robust (median/MAD) "
                        "z-score threshold vs its peers"),
    "serve.cost.prefill_ms": ("histogram", (),
                              "per-request attributed prefill wall "
                              "time (ms), recorded at the request's "
                              "terminal status"),
    "serve.cost.decode_ms": ("histogram", (),
                             "per-request attributed decode time "
                             "(ms): the request's share of every poll "
                             "window it was live in (window wall / "
                             "live slots), recorded at terminal "
                             "status"),
    "serve.cost.page_s": ("histogram", (),
                          "per-request KV page*seconds held (paged "
                          "pool): pages resident x window wall, "
                          "recorded at terminal status"),
    "slo.state": ("gauge", ("scope", "slo"),
                  "alert state per SLO (0 ok/resolved | 1 pending | "
                  "2 firing); scope: process | fleet"),
    "slo.burn_rate": ("gauge", ("scope", "slo", "window"),
                      "error-budget burn rate over the fast/slow "
                      "evaluation window (1.0 = burning exactly the "
                      "budget)"),
    "slo.transitions": ("counter", ("scope", "slo", "to"),
                        "alert state-machine transitions (to: pending "
                        "| firing | resolved | ok)"),
}

enabled = False  # mirrored from metrics.enable()/disable()


def _sync(on: bool):
    global enabled
    enabled = on


metrics.on_state_change(_sync)

enable = metrics.enable
disable = metrics.disable


# ------------------------------------------------------------ jit layer

# always-on retrace census (plain int += under the GIL): the goodput
# ledger attributes a dispatch's wall time to the `compile` bucket by
# diffing this around the call — it must advance whether or not the
# registry is enabled, the same reason retraces feed the flight
# recorder unconditionally
_retraces_seen = 0


def retrace_count() -> int:
    """Monotonic count of every retrace this process observed,
    independent of the registry's enabled state."""
    return _retraces_seen


def record_retrace(cause: str, target: str = "jit"):
    """One jax.jit cache miss. cause: first | new_shape | new_dtype |
    new_structure | donation_miss. Also lands in the flight recorder
    (its own enable flag): a post-mortem must show what compiled in the
    seconds before death even when nobody enabled the registry."""
    global _retraces_seen
    _retraces_seen += 1
    if flight_recorder.enabled:
        flight_recorder.record("jit.compile", cause=cause, target=target)
    if not enabled:
        return
    metrics.counter(f"{target}.compile", cause=cause).inc()
    metrics.counter("jit.compile.total").inc()


def record_compile_cache_hit(nbytes: int, load_ms: float):
    """One executable-store hit: a compiled program deserialized from
    disk instead of compiled — the warm-restart fast path. The tier-1
    warm gate asserts a rebuilt engine hits for EVERY program."""
    if not enabled:
        return
    metrics.counter("jit.compile_cache.hits").inc()
    metrics.counter("jit.compile_cache.bytes").inc(int(nbytes))
    metrics.histogram("jit.compile_cache.load_ms").observe(float(load_ms))


def record_compile_cache_miss(cause: str):
    """One executable-store miss. cause: absent (cold — the entry will
    be written) | corrupt (bad entry dropped, fresh compile rewrites
    it) | stale_ref (verify mode caught a manifest entry disagreeing
    with the real program fingerprint)."""
    if not enabled:
        return
    metrics.counter("jit.compile_cache.misses", cause=cause).inc()
    metrics.counter("jit.compile_cache.misses").inc()


def record_compile_cache_save(nbytes: int, save_ms: float):
    """One executable serialized + atomically committed to the store."""
    if not enabled:
        return
    metrics.counter("jit.compile_cache.bytes").inc(int(nbytes))
    metrics.histogram("jit.compile_cache.save_ms").observe(float(save_ms))


def record_static_build():
    if not enabled:
        return
    metrics.counter("static.program_builds").inc()


def record_static_op():
    if not enabled:
        return
    metrics.counter("static.ops_recorded").inc()


# ----------------------------------------------------- distributed layer

def record_collective(op: str, axis: str, nbytes: int):
    if flight_recorder.enabled:
        flight_recorder.record("comm.dispatch", op=op, axis=axis,
                               bytes=int(nbytes))
    if not enabled:
        return
    metrics.counter("comm.ops", axis=axis, op=op).inc()
    metrics.counter("comm.bytes", axis=axis, op=op).inc(int(nbytes))
    metrics.counter("comm.bytes").inc(int(nbytes))


def record_p2p(op: str, nbytes: int):
    if flight_recorder.enabled:
        flight_recorder.record("comm.dispatch", op=op, axis="p2p",
                               bytes=int(nbytes))
    if not enabled:
        return
    metrics.counter("comm.ops", axis="p2p", op=op).inc()
    metrics.counter("comm.bytes", axis="p2p", op=op).inc(int(nbytes))
    metrics.counter("comm.bytes").inc(int(nbytes))


# -------------------------------------------------------------- io layer

def record_dataloader_batch(nsamples: int, nbytes: int):
    if not enabled:
        return
    metrics.counter("io.batches").inc()
    metrics.counter("io.samples").inc(int(nsamples))
    metrics.counter("io.bytes").inc(int(nbytes))
    metrics.histogram("io.batch_bytes").observe(float(nbytes))


def record_worker_death(worker_id: int):
    """A DataLoader worker process was found dead (crash/OOM/SIGKILL)."""
    if not enabled:
        return
    metrics.counter("io.worker.deaths").inc()
    metrics.counter("io.worker.deaths", worker=str(worker_id)).inc()


def record_worker_respawn(worker_id: int):
    """A dead DataLoader worker was respawned (its in-flight batches
    re-dispatched)."""
    if not enabled:
        return
    metrics.counter("io.worker.respawns").inc()
    metrics.counter("io.worker.respawns", worker=str(worker_id)).inc()


def record_sample_quarantined(n: int = 1):
    """Samples skipped by the DataLoader's bad-sample quarantine
    (raised during fetch, or contained non-finite data)."""
    if not enabled:
        return
    metrics.counter("io.sample.quarantined").inc(int(n))


def record_host2device(placed: int, skipped: int = 0, nbytes: int = 0):
    """Host->device batch placements: ``placed`` leaves transferred,
    ``skipped`` leaves already resident on their target sharding (the
    idempotent-placement fast path)."""
    if not enabled:
        return
    if placed:
        metrics.counter("io.host2device.placed").inc(int(placed))
    if skipped:
        metrics.counter("io.host2device.skipped").inc(int(skipped))
    if nbytes:
        metrics.counter("io.host2device.bytes").inc(int(nbytes))


# ------------------------------------------------------------- amp layer

def record_scaler_step(skipped: bool, scale: float):
    if not enabled:
        return
    metrics.counter("amp.scaler.steps").inc()
    if skipped:
        metrics.counter("amp.scaler.skipped").inc()
    metrics.gauge("amp.loss_scale").set(float(scale))


# ------------------------------------------------------ resilience layer

def record_preemption():
    if not enabled:
        return
    metrics.counter("resilience.preemptions").inc()


def record_emergency_save(step: int):
    if not enabled:
        return
    metrics.counter("resilience.emergency_saves").inc()
    metrics.gauge("resilience.emergency_save_step").set(float(step))


def record_watchdog_timeout(label: str):
    if not enabled:
        return
    metrics.counter("resilience.watchdog.timeouts", label=label).inc()
    metrics.counter("resilience.watchdog.timeouts").inc()


def record_ckpt_fallback(step):
    """One checkpoint step skipped as corrupt/uncommitted on restore."""
    if not enabled:
        return
    metrics.counter("resilience.ckpt.fallback").inc()
    metrics.gauge("resilience.ckpt.last_skipped_step").set(float(step))


def record_loss_fetch(blocking: bool):
    """One loss scalar read back by the async train loop; ``blocking``
    means the device had not finished the step when the host asked (a
    true pipeline stall, counted in ``train.host_syncs`` — the number
    the host-sync regression gate bounds)."""
    if not enabled:
        return
    metrics.counter("train.loss_fetches").inc()
    if blocking:
        metrics.counter("train.host_syncs").inc()


def record_anomaly():
    if not enabled:
        return
    metrics.counter("train.anomalies").inc()


def record_anomaly_restore():
    if not enabled:
        return
    metrics.counter("train.anomaly_restores").inc()


def record_swallowed(where: str, exc: BaseException):
    """A deliberately swallowed exception: always logged (rare, cheap,
    and silence here is how fault-tolerance bugs hide), counted when the
    monitor is enabled."""
    import logging
    logging.getLogger("paddle_tpu_torch.monitor").warning(
        "swallowed exception in %s: %s: %s", where, type(exc).__name__, exc)
    if not enabled:
        return
    metrics.counter("errors.swallowed", where=where).inc()


# ------------------------------------------------------ generation layer

def record_generation(prefill_steps: int = 0, decode_steps: int = 0,
                      tokens: int = 0):
    """Generation loop progress: one prefill dispatch / decode dispatch
    (= one token per row) and the tokens it produced. MetricsCallback
    surfaces gen.tokens deltas as tokens/sec."""
    if not enabled:
        return
    if prefill_steps:
        metrics.counter("gen.prefill_steps").inc(int(prefill_steps))
    if decode_steps:
        metrics.counter("gen.decode_steps").inc(int(decode_steps))
    if tokens:
        metrics.counter("gen.tokens").inc(int(tokens))


def record_speculative(proposed: int, accepted: int):
    """Speculative-decoding progress: draft tokens proposed to (and
    accepted by) the single-dispatch verify since the last record —
    generate() records once per call, the serving engine once per
    scheduler poll. accept_rate is the ratio of this record's window
    (the counters carry the lifetime totals)."""
    if not enabled:
        return
    if proposed:
        metrics.counter("gen.spec.proposed").inc(int(proposed))
        metrics.gauge("gen.spec.accept_rate").set(
            float(accepted) / float(proposed))
    if accepted:
        metrics.counter("gen.spec.accepted").inc(int(accepted))


def record_cache_occupancy(frac: float):
    """Fraction of the KV cache in use at the end of a generate() call
    (max over batch rows) — headroom before the ring would wrap."""
    if not enabled:
        return
    metrics.gauge("gen.cache_occupancy").set(float(frac))


def record_paged_cache(allocated: int = 0, freed: int = 0,
                       prefix_hits: int = 0, shared_pages: int = 0,
                       cow_copies: int = 0):
    """Paged-KV allocator progress since the last record (the serving
    engine drains its host-side page stats at the poll cadence):
    pages allocated/freed, admissions that hash-matched a registered
    prompt prefix, the pages those hits referenced instead of storing,
    and copy-on-write privatizations of partially-shared pages."""
    if not enabled:
        return
    if allocated:
        metrics.counter("gen.cache.pages_allocated").inc(int(allocated))
    if freed:
        metrics.counter("gen.cache.pages_freed").inc(int(freed))
    if prefix_hits:
        metrics.counter("serve.cache.prefix_hits").inc(int(prefix_hits))
    if shared_pages:
        metrics.counter("serve.cache.prefix_shared_pages").inc(
            int(shared_pages))
    if cow_copies:
        metrics.counter("serve.cache.cow_copies").inc(int(cow_copies))


def record_kv_quant(bytes_saved: int = 0, scale_clips: int = 0):
    """Quantized-KV-cache accounting: HBM bytes the int8 storage saved
    vs the wide dtype (recorded once per cache build/admission — host
    arithmetic over shapes), and int8 saturations observed since the
    last record (the engine drains the in-cache counter at its poll
    cadence; generate() records once per call)."""
    if not enabled:
        return
    if bytes_saved:
        metrics.counter("gen.cache.quant.bytes_saved").inc(
            int(bytes_saved))
    if scale_clips:
        metrics.counter("gen.cache.quant.scale_clips").inc(
            int(scale_clips))


def record_kv_dtype(dtype_label: str):
    """Info gauge naming the KV-cache storage dtype an engine serves
    (value pinned 1; the label carries the information — the item-1
    router reads it beside the capacity numbers)."""
    if not enabled:
        return
    metrics.gauge("serve.cache.kv_dtype",
                  dtype=str(dtype_label)).set(1.0)


def record_page_occupancy(frac: float):
    """Paged-KV pool pressure at the last scheduler poll: pages
    referenced by live rows over the allocatable pool (the memory-side
    capacity signal beside serve.slot_occupancy's admission side)."""
    if not enabled:
        return
    metrics.gauge("serve.cache.page_occupancy").set(float(frac))


# --------------------------------------------------------- serving layer

# Latency-scaled histogram bounds (seconds): 100µs .. ~88s in 2^(1/4)
# (~19%) steps. The SLO watchtower gates burn rates on p99 of these
# histograms, so the interpolation error of a percentile estimate must
# be smaller than any objective worth alerting on: with quarter-power
# spacing the estimate is off by at most one bucket width, i.e. a
# worst-case relative error of 2^(1/4)-1 ~= 19% (vs ~41% for the old
# sqrt(2) spacing) — tier-1 gates this against exact quantiles.
_SERVE_LATENCY_BOUNDS = tuple(1e-4 * 2 ** (i / 4.0) for i in range(80))

# Step times live on a coarser scale (ms .. minutes); same quarter-power
# spacing so the fleet straggler detector's per-rank means interpolate
# tightly.
_STEP_TIME_BOUNDS = tuple(1e-3 * 2 ** (i / 4.0) for i in range(80))

# Cost histograms are capacity-planning aggregates, not SLO gates:
# sqrt(2) spacing over a wide range is enough.
_COST_MS_BOUNDS = tuple(1e-1 * 2 ** (i / 2.0) for i in range(40))
_COST_PAGE_S_BOUNDS = tuple(1e-3 * 2 ** (i / 2.0) for i in range(48))


def record_serve_request(status: str):
    """One request reaching a terminal status (completed | cancelled |
    rejected). QPS is the rate of this counter."""
    if not enabled:
        return
    metrics.counter("serve.requests", status=status).inc()
    metrics.counter("serve.requests").inc()


def record_serve_queue_depth(depth: int):
    if not enabled:
        return
    metrics.gauge("serve.queue_depth").set(float(depth))


def record_serve_ttft(seconds: float):
    """Time-to-first-token: request submitted -> prefill's sampled
    token on host (includes queue wait — the SLA the client sees)."""
    if not enabled:
        return
    metrics.histogram("serve.ttft", bounds=_SERVE_LATENCY_BOUNDS) \
        .observe(float(seconds))


def record_serve_token_latency(seconds: float):
    """Per-token decode cadence, observed once per scheduler poll
    window (wall time across the window / decode steps in it)."""
    if not enabled:
        return
    metrics.histogram("serve.token_latency",
                      bounds=_SERVE_LATENCY_BOUNDS).observe(float(seconds))


def record_serve_slot_occupancy(frac: float):
    """Busy decode slots / max_batch at the last scheduler poll."""
    if not enabled:
        return
    metrics.gauge("serve.slot_occupancy").set(float(frac))


def record_serve_cancellation(reason: str):
    """A request cancelled before completing (reason: deadline |
    shutdown)."""
    if not enabled:
        return
    metrics.counter("serve.cancellations", reason=reason).inc()
    metrics.counter("serve.cancellations").inc()


def record_prefill_chunk(tokens: int):
    """One chunked-prefill chunk dispatched (``tokens`` = prompt tokens
    it wrote, excluding pad; the final, right-padded chunk reports its
    real token count)."""
    if not enabled:
        return
    metrics.counter("serve.prefill.chunks").inc()
    metrics.counter("serve.prefill.chunk_tokens").inc(int(tokens))


def record_prefill_interleave(ratio: float):
    """Decode steps dispatched per prefill chunk across the chunked
    admission that just completed — the interleaving evidence (0 means
    no decode ran between chunks)."""
    if not enabled:
        return
    metrics.gauge("serve.prefill.interleave_ratio").set(float(ratio))


def record_request_cost(prefill_s: float, decode_s: float, page_s: float):
    """One request's attributed cost at its terminal status: prefill
    wall, its share of every decode poll window it was live in, and
    KV page*seconds held (paged pool; 0.0 for contiguous caches)."""
    if not enabled:
        return
    metrics.histogram("serve.cost.prefill_ms",
                      bounds=_COST_MS_BOUNDS).observe(prefill_s * 1e3)
    metrics.histogram("serve.cost.decode_ms",
                      bounds=_COST_MS_BOUNDS).observe(decode_s * 1e3)
    metrics.histogram("serve.cost.page_s",
                      bounds=_COST_PAGE_S_BOUNDS).observe(float(page_s))


# --------------------------------------------------------- router layer

def record_router_admission(replica: str):
    """The FleetRouter placed one request on ``replica`` (its rate per
    replica is the routed-QPS split; a drained or OPEN replica's series
    going flat while the survivors' rise is the rebalance proof)."""
    if not enabled:
        return
    metrics.counter("serve.router.admissions", replica=replica).inc()
    metrics.counter("serve.router.admissions").inc()


def record_router_reroute(reason: str):
    """One bounded re-route: a placement was rejected (queue_full*,
    shutdown) or failed (admission_error, error) and the router tried
    the next-best replica."""
    if not enabled:
        return
    metrics.counter("serve.router.reroutes", reason=reason).inc()
    metrics.counter("serve.router.reroutes").inc()


def record_router_rejected():
    """A request the router could place on no replica at all."""
    if not enabled:
        return
    metrics.counter("serve.router.rejected").inc()


def record_router_breaker_trip(replica: str):
    """One circuit-breaker OPEN transition on ``replica``."""
    if not enabled:
        return
    metrics.counter("serve.router.breaker.trips", replica=replica).inc()
    metrics.counter("serve.router.breaker.trips").inc()


def record_router_breaker_state(replica: str, state_code: int):
    """Current breaker state of one replica (0 closed | 1 half_open |
    2 open)."""
    if not enabled:
        return
    metrics.gauge("serve.router.breaker.state",
                  replica=replica).set(float(state_code))


def record_router_replicas(n: int):
    """Replicas currently in the router's rotation."""
    if not enabled:
        return
    metrics.gauge("serve.router.replicas").set(float(n))


# ------------------------------------------------------- training layer

def record_train_step_time(seconds: float):
    """One dispatched train step's wall time — the cumulative series
    the fleet straggler detector diffs per rank and the step-time SLO
    evaluates."""
    if not enabled:
        return
    metrics.histogram("train.step_time",
                      bounds=_STEP_TIME_BOUNDS).observe(float(seconds))


def record_straggler(rank: int):
    """One straggler detection: ``rank``'s windowed mean step time
    crossed the robust z-score threshold vs its peers."""
    if not enabled:
        return
    metrics.counter("train.straggler", rank=str(rank)).inc()
    metrics.counter("train.straggler").inc()


# ------------------------------------------------------ watchtower layer

def record_slo_state(scope: str, slo: str, state_code: int):
    """Current alert state of one SLO (0 ok/resolved | 1 pending |
    2 firing); scope: process | fleet."""
    if not enabled:
        return
    metrics.gauge("slo.state", scope=scope, slo=slo).set(float(state_code))


def record_slo_burn_rate(scope: str, slo: str, window: str, burn: float):
    """Error-budget burn rate measured over one evaluation window
    (window: fast | slow)."""
    if not enabled:
        return
    metrics.gauge("slo.burn_rate", scope=scope, slo=slo,
                  window=window).set(float(burn))


def record_slo_transition(scope: str, slo: str, to: str):
    """One alert state-machine transition (to: pending | firing |
    resolved | ok)."""
    if not enabled:
        return
    metrics.counter("slo.transitions", scope=scope, slo=slo, to=to).inc()
    metrics.counter("slo.transitions").inc()


# ------------------------------------------------------- analysis layer

def record_analysis_finding(check: str, severity: str, n: int = 1):
    """One static-analysis finding (program auditor): counted per
    detector check id and severity so CI can trend audit debt the way
    it trends retraces."""
    if not enabled:
        return
    metrics.counter("analysis.findings", check=check,
                    severity=severity).inc(int(n))
    metrics.counter("analysis.findings").inc(int(n))


def record_memory_plan(program: str, peak_bytes: int):
    """One program's statically planned peak HBM (the memory pass of
    the auditor) — a gauge per program name so dashboards trend the
    footprint of each flagship program across deploys."""
    if not enabled:
        return
    # labeled series only: gauges don't aggregate — an unlabeled
    # last-writer-wins series would flap between unrelated programs
    metrics.gauge("analysis.mem.peak_bytes",
                  program=program).set(int(peak_bytes))


def record_budget_violation(program: str, n: int = 1):
    """Audited programs whose planned peak exceeded the declared HBM
    budget (``mem.budget`` ERROR findings)."""
    if not enabled:
        return
    metrics.counter("analysis.mem.budget_violations",
                    program=program).inc(int(n))
    metrics.counter("analysis.mem.budget_violations").inc(int(n))


# ------------------------------------------------------- telemetry layer

def record_scrape(endpoint: str):
    """One telemetry-server HTTP request (endpoint: metrics | healthz |
    readyz | flightrecorder)."""
    if not enabled:
        return
    metrics.counter("telemetry.scrapes", endpoint=endpoint).inc()
    metrics.counter("telemetry.scrapes").inc()


def record_flight_dump(reason: str):
    """One flight-recorder dump written (watchdog | preemption |
    anomaly_restore | serve_crash | fit_crash | manual)."""
    if not enabled:
        return
    metrics.counter("flightrecorder.dumps", reason=reason).inc()
    metrics.counter("flightrecorder.dumps").inc()


# ----------------------------------------------------------- fleet layer

def record_fleet_publish():
    """One delta-encoded snapshot published to the fleet store."""
    if not enabled:
        return
    metrics.counter("fleet.publishes").inc()


def record_fleet_ranks(total: int, stale: int):
    """The aggregator's rank census at one poll: every rank it has
    ever seen publish, and how many are past the publish deadline
    (stale ranks are MARKED, never dropped — the count is the alarm a
    fleet dashboard pages on)."""
    if not enabled:
        return
    metrics.gauge("fleet.ranks_total").set(float(total))
    metrics.gauge("fleet.ranks_stale").set(float(stale))


def record_fleet_rank_up(rank: int, incarnation: int, up: bool):
    """Per-rank liveness at the aggregator's last poll (the labeled
    face of the ``fleet.ranks_stale`` census)."""
    if not enabled:
        return
    metrics.gauge("fleet.rank_up", rank=str(rank),
                  incarnation=str(incarnation)).set(1.0 if up else 0.0)


def record_clock_skew(rank: int, offset_ns: int):
    """One rank's measured wall-clock offset vs the fleet store's
    master clock (the trace-merge alignment term)."""
    if not enabled:
        return
    metrics.gauge("fleet.clock_skew_ns", rank=str(rank)).set(
        float(offset_ns))


# --------------------------------------------------------- goodput layer

def record_goodput(family: str, buckets, wall_s: float):
    """One goodput-ledger flush window: per-bucket wall seconds
    (family: train | serve) accumulated into the
    ``{family}.goodput.seconds{bucket=...}`` counters, plus the window
    fraction gauge (compute / wall)."""
    if not enabled:
        return
    for bucket, seconds in buckets.items():
        if seconds:
            metrics.counter(f"{family}.goodput.seconds",
                            bucket=bucket).inc(float(seconds))
    if wall_s > 0:
        metrics.gauge(f"{family}.goodput.fraction").set(
            float(buckets.get("compute", 0.0)) / float(wall_s))


# ---------------------------------------------------------- device layer

def sample_device_memory():
    """Poll the current card's caching allocator
    (``torch.cuda.memory_allocated`` / ``memory_reserved`` through
    ``core.device``) into the memory gauges (the profiler calls this at
    every step boundary while recording, so the trace shows memory as a
    counter track). A process with no card has no device allocator:
    the gauges stay unset. A failed read is recorded, never raised:
    telemetry must not break a training step."""
    if not enabled:
        return
    try:
        import torch

        from . import device as device_ns
        if not torch.cuda.is_available():
            return
        metrics.gauge("device.memory.allocated").set(
            device_ns.memory_allocated())
        metrics.gauge("device.memory.reserved").set(
            device_ns.memory_reserved())
    except Exception as e:
        record_swallowed("monitor.sample_device_memory", e)


def report() -> str:
    return metrics.report()
