"""Live telemetry export: the HTTP surface a fleet scrapes and probes
(the JAX package's ``core/telemetry_server.py``).

A stdlib ``ThreadingHTTPServer`` (no new dependencies) exposing:

    /metrics          Prometheus text rendering of the FULL registry —
                      counters, gauges (+ ``_peak``), histograms with
                      cumulative ``_bucket{le=...}`` lines
    /healthz          200 while the process is alive (liveness probe)
    /readyz           200/503 from ``ServingEngine.health()`` — warm,
                      not draining, queue below bound; flips 503 the
                      moment a drain starts, so a multi-replica router
                      stops sending traffic BEFORE the queue rejects
    /flightrecorder   the flight recorder's dump (Perfetto JSON +
                      plaintext tail) on demand, no file writes
    /router           the fleet router's ``describe()`` document (404
                      when no router is attached)
    /slo              the SLO watchtower document and the attached
                      engine's top-K most expensive requests
    /fleet/metrics    404: the fleet aggregator is not ported yet
    /fleet/healthz    (ROADMAP A11), as the JAX server answers with no
                      aggregator attached

Every ``/metrics`` render also carries two scrape-hygiene series: a
``paddle_build_info`` info-gauge (value pinned 1) and
``process_uptime_seconds``. Where the JAX server labels the info-gauge
``version``, ``jax``, ``jaxlib`` and ``platform``, this one labels it
``version``, ``torch``, ``cuda`` (``torch.version.cuda``) and
``platform`` (``cuda`` with a card, else ``cpu``).

Opt-in: ``PADDLE_TELEMETRY_PORT`` (the ServingEngine reads it; any other
process can call ``start_from_env()``/``TelemetryServer`` directly), or
``ServingEngine(telemetry_port=...)`` / ``Config.enable_serving(
telemetry_port=...)``. Port 0 binds an ephemeral port (``server.port``
reports the real one).

The render reads through ``metrics.all_metrics()``: a scrape never
mutates, never locks the whole registry, and works whether or not the
monitor is enabled (a disabled monitor scrapes as its last values).
"""
from __future__ import annotations

import json
import os
import threading
import time
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

from . import flight_recorder, metrics, monitor

__all__ = ["TelemetryServer", "prometheus_text", "start_from_env"]


# ---------------------------------------------------- prometheus render

def _prom_name(name: str) -> str:
    out = []
    for i, ch in enumerate(name):
        if ch.isalnum() or ch == "_" or (ch == ":" and i):
            out.append(ch)
        else:
            out.append("_")
    s = "".join(out)
    return "_" + s if s[:1].isdigit() else s


def _prom_labels(labels: str) -> str:
    """Our ``k=v,k2=v2`` label tail -> ``{k="v",k2="v2"}``."""
    if not labels:
        return ""
    parts = []
    for kv in labels.split(","):
        k, _, v = kv.partition("=")
        v = v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
        parts.append(f'{_prom_name(k)}="{v}"')
    return "{" + ",".join(parts) + "}"


def _split_key(key: str) -> Tuple[str, str]:
    """Registry key -> (base name, raw label tail): ``serve.requests``
    or ``serve.requests{status=completed}``."""
    if key.endswith("}") and "{" in key:
        base, _, rest = key.partition("{")
        return base, rest[:-1]
    return key, ""


def _finite(v: float) -> float:
    # the render must never emit NaN/inf (the Histogram.percentile
    # contract, applied to every exported number)
    v = float(v)
    return v if v - v == 0.0 else 0.0


# ------------------------------------------------- scrape hygiene lines

_START_MONOTONIC = time.monotonic()   # ≈ process start (core imports
#                                       run before any serving loop)
_BUILD_INFO_LINE: Optional[str] = None


def _build_info_line() -> str:
    """The ``paddle_build_info`` info-gauge sample line (computed once:
    versions don't change mid-process). Value pinned 1 — the labels
    carry the information, the standard Prometheus *_info idiom."""
    global _BUILD_INFO_LINE
    if _BUILD_INFO_LINE is None:
        labels = {}
        try:
            from .. import __version__
            labels["version"] = str(__version__)
        except Exception:
            labels["version"] = "unknown"
        try:
            import torch
            labels["torch"] = str(torch.__version__)
            labels["cuda"] = str(torch.version.cuda or "none")
            labels["platform"] = "cuda" if torch.cuda.is_available() \
                else "cpu"
        except Exception:
            labels.setdefault("torch", "unavailable")
            labels.setdefault("cuda", "unavailable")
            labels.setdefault("platform", "unknown")
        tail = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
        _BUILD_INFO_LINE = f"paddle_build_info{_prom_labels(tail)} 1"
    return _BUILD_INFO_LINE


def _hygiene_lines() -> list:
    """Appended to every /metrics render: the build-info gauge and the
    process uptime, the scrape hygiene dashboards key on."""
    return [
        "# TYPE paddle_build_info gauge",
        _build_info_line(),
        "# TYPE process_uptime_seconds gauge",
        f"process_uptime_seconds "
        f"{_finite(time.monotonic() - _START_MONOTONIC)!r}",
    ]


def prometheus_text(registry: Optional[dict] = None) -> str:
    """Render the metrics registry in the Prometheus text exposition
    format (version 0.0.4): one ``# TYPE`` line per metric family, then
    one sample line per label set. Histograms export cumulative
    ``_bucket`` lines (``+Inf`` == ``_count``), ``_sum`` and
    ``_count``; gauges also export a ``_peak`` companion gauge."""
    reg = registry if registry is not None else metrics.all_metrics()
    families: dict = {}
    for key in sorted(reg):
        base, labels = _split_key(key)
        families.setdefault(base, []).append((labels, reg[key]))
    lines = []
    for base in sorted(families):
        name = _prom_name(base)
        entries = families[base]
        kind = entries[0][1].kind
        lines.append(f"# TYPE {name} {kind}")
        for labels, m in entries:
            lab = _prom_labels(labels)
            if isinstance(m, metrics.Counter):
                lines.append(f"{name}{lab} {m.value}")
            elif isinstance(m, metrics.Gauge):
                # repr, not %g: a byte-scale gauge must not lose the
                # low digits a leak detector diffs between scrapes
                lines.append(f"{name}{lab} {_finite(m.value)!r}")
            elif isinstance(m, metrics.Histogram):
                bounds, counts, count, total = m.raw()
                cum = 0
                inner = labels.split(",") if labels else []
                for b, c in zip(bounds, counts):
                    cum += c
                    le = ",".join(inner + [f"le={b:g}"])
                    lines.append(
                        f"{name}_bucket{_prom_labels(le)} {cum}")
                le = ",".join(inner + ["le=+Inf"])
                lines.append(f"{name}_bucket{_prom_labels(le)} {count}")
                lines.append(f"{name}_sum{lab} {_finite(total)!r}")
                lines.append(f"{name}_count{lab} {count}")
        gauges = [(labels, m) for labels, m in entries
                  if isinstance(m, metrics.Gauge)]
        if gauges:
            lines.append(f"# TYPE {name}_peak gauge")
            for labels, m in gauges:
                lines.append(f"{name}_peak{_prom_labels(labels)} "
                             f"{_finite(m.peak)!r}")
    lines.extend(_hygiene_lines())
    return "\n".join(lines) + "\n"


# ------------------------------------------------------------- handlers

class _Handler(BaseHTTPRequestHandler):
    server_version = "paddle-telemetry/1"

    def _send(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — http.server API
        owner: "TelemetryServer" = self.server.telemetry  # type: ignore
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        try:
            if path == "/metrics":
                monitor.record_scrape("metrics")
                self._send(200, prometheus_text().encode(),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/healthz":
                monitor.record_scrape("healthz")
                body = json.dumps({"status": "ok",
                                   "pid": os.getpid()}).encode()
                self._send(200, body, "application/json")
            elif path == "/readyz":
                monitor.record_scrape("readyz")
                ready, detail = owner.readiness()
                body = json.dumps(detail).encode()
                self._send(200 if ready else 503, body,
                           "application/json")
            elif path == "/flightrecorder":
                monitor.record_scrape("flightrecorder")
                body = json.dumps(
                    flight_recorder.dump_dict("http")).encode()
                self._send(200, body, "application/json")
            elif path in ("/fleet/metrics", "/fleet/healthz"):
                monitor.record_scrape(path[1:].replace("/", "_"))
                self._send(404, b'{"error": "no fleet aggregator '
                                b'attached"}', "application/json")
            elif path == "/slo":
                monitor.record_scrape("slo")
                self._send(200, json.dumps(owner.slo_document()).encode(),
                           "application/json")
            elif path == "/router":
                monitor.record_scrape("router")
                router = owner.router
                if router is None:
                    self._send(404, b'{"error": "no router attached"}',
                               "application/json")
                else:
                    self._send(200, json.dumps(router.describe()).encode(),
                               "application/json")
            else:
                self._send(404, b'{"error": "not found"}',
                           "application/json")
        except Exception as e:  # telemetry must never kill its server
            monitor.record_swallowed("telemetry.handler", e)
            try:
                self._send(500, b'{"error": "internal"}',
                           "application/json")
            except Exception:
                pass  # client already gone

    def log_message(self, fmt, *args):
        pass  # probes every few seconds must not spam stderr


# --------------------------------------------------------------- server

class _TrackingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that can JOIN its in-flight handlers.

    The stock mixin only tracks handler threads when they are
    non-daemon (``block_on_close`` path); with ``daemon_threads = True``
    — which this server needs so a wedged scrape can't block process
    exit — ``server_close()`` joins nothing, so ``stop()`` could return
    while a handler was still mid-response and the scrape raced
    whatever teardown followed (``ServingEngine.shutdown()`` closing
    the registry's producers). Track the threads explicitly and let
    ``stop()`` wait them out with a bound."""

    daemon_threads = True

    def __init__(self, *args, **kwargs):
        self._handler_threads: set = set()
        self._handler_lock = threading.Lock()
        super().__init__(*args, **kwargs)

    def process_request_thread(self, request, client_address):
        t = threading.current_thread()
        with self._handler_lock:
            self._handler_threads.add(t)
        try:
            super().process_request_thread(request, client_address)
        finally:
            with self._handler_lock:
                self._handler_threads.discard(t)

    def join_handlers(self, timeout: float) -> bool:
        """Wait (bounded) for every in-flight handler to finish;
        True if none remain."""
        deadline = time.monotonic() + timeout
        while True:
            with self._handler_lock:
                live = [t for t in self._handler_threads if t.is_alive()]
            if not live:
                return True
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            live[0].join(timeout=min(0.05, remaining))


class TelemetryServer:
    """The export surface. ``start()`` binds and serves on a daemon
    thread; ``attach_engine()`` (weakly) wires ``/readyz`` to a
    ServingEngine's health; ``stop()`` shuts down cleanly (idempotent).
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self._requested_port = int(port)
        self.host = host
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._engine_ref = None
        self._router_ref = None

    # ------------------------------------------------------ lifecycle
    @property
    def port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "TelemetryServer":
        if self.running:
            return self
        # opting into the export surface means opting into recording:
        # a scrapeable replica with a frozen registry answers every
        # probe with stale zeros. (enable() is idempotent and never
        # clears history; disable() later stops recording, and the
        # server keeps serving the last recorded values.)
        metrics.enable()
        self._httpd = _TrackingHTTPServer(
            (self.host, self._requested_port), _Handler)
        self._httpd.telemetry = self  # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"telemetry:{self.port}")
        self._thread.start()
        return self

    def stop(self):
        httpd, self._httpd = self._httpd, None
        thread, self._thread = self._thread, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
            # drain in-flight handlers BEFORE returning: callers tear
            # down the things handlers read (engine slots, registry
            # producers) the moment stop()
            # returns, and a daemon handler thread still writing its
            # response would race that teardown
            httpd.join_handlers(timeout=5.0)
        if thread is not None:
            thread.join(timeout=5.0)

    # ------------------------------------------------------ readiness
    def attach_engine(self, engine) -> "TelemetryServer":
        """Weakly reference a ServingEngine: ``/readyz`` reflects its
        health, and a collected engine reads as not-ready (the replica
        should be rotated out, not probed forever)."""
        self._engine_ref = weakref.ref(engine)
        return self

    def attach_router(self, router) -> "TelemetryServer":
        """Weakly reference a ``serving.FleetRouter``: ``/router``
        serves its ``describe()`` document (weak for the same reason
        as the engine — a collected router must read as absent, not
        pin the whole replica table alive)."""
        self._router_ref = weakref.ref(router)
        return self

    @property
    def router(self):
        return self._router_ref() if self._router_ref is not None \
            else None

    def slo_document(self) -> dict:
        """The ``/slo`` body: the process-scope watchtower report and
        the attached engine's top-K request-cost table."""
        from . import slo as slo_mod
        doc = slo_mod.report()
        engine = self._engine_ref() if self._engine_ref is not None \
            else None
        if engine is not None and hasattr(engine, "cost_table"):
            try:
                doc["top_cost"] = engine.cost_table()
            except Exception as e:
                monitor.record_swallowed("telemetry.cost_table", e)
        return doc

    def readiness(self) -> Tuple[bool, dict]:
        from ..distributed import resilience  # lazy: core below distributed
        if resilience.preempted():
            return False, {"ready": False, "reason": "preempted"}
        if self._engine_ref is None:
            return True, {"ready": True, "engine": None}
        engine = self._engine_ref()
        if engine is None:
            return False, {"ready": False, "reason": "engine gone"}
        health = engine.health()
        return bool(health["ready"]), health

    def __repr__(self):
        return (f"TelemetryServer(host={self.host!r}, port={self.port}, "
                f"running={self.running})")


def start_from_env(engine=None) -> Optional[TelemetryServer]:
    """The ``PADDLE_TELEMETRY_PORT`` opt-in: start a server on the
    configured port (empty/unset -> None). The ServingEngine calls this
    at construction; a training job can call it directly."""
    raw = os.environ.get("PADDLE_TELEMETRY_PORT", "").strip()
    if not raw:
        return None
    try:
        port = int(raw)
    except ValueError:
        monitor.record_swallowed(
            "telemetry.port", ValueError(f"PADDLE_TELEMETRY_PORT={raw!r}"))
        return None
    server = TelemetryServer(port=port).start()
    if engine is not None:
        server.attach_engine(engine)
    return server
