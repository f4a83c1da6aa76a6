"""Health and metrics endpoint over the metrics registry
(utils/metrics.py).

Port of the JAX package's `utils/healthz.py`: an opt-in stdlib
`http.server` daemon thread bound to 127.0.0.1 (`GS_METRICS_PORT`; port
0 in code binds an ephemeral port, what tests use) serving

  GET /metrics   the registry in Prometheus text exposition format
  GET /healthz   JSON: status (`ok` / `degraded`), per-engine tier,
                 last-finalized-window age, backlog, throughput, the
                 demotion-log tail, the shape watch, the run-ledger
                 path, and the `latency` section — HTTP 200 while ok,
                 503 degraded

plus the staleness watchdog: a daemon thread calling
`metrics.check_staleness()` every quarter of `GS_HEALTH_STALE_S`, so a
stream whose windows stop finalizing flips `/healthz` to `degraded`
(durable `health_degraded` event) within one interval; the next
finalize recovers it. The server comes up lazily when an engine marks
its stream (metrics.on_stream_start / mark_window consult
GS_METRICS_PORT), or through `start()`. No handler touches stream
state.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from . import knobs
from . import metrics
from . import telemetry


class _Handler(BaseHTTPRequestHandler):
    server_version = "gs-healthz/1"

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (http.server API)
        try:
            if self.path.split("?")[0] == "/metrics":
                body = metrics.render_prometheus().encode()
                self._send(200, body,
                           "text/plain; version=0.0.4; charset=utf-8")
            elif self.path.split("?")[0] == "/healthz":
                metrics.check_staleness()  # request-time freshness
                snap = metrics.health_snapshot()
                code = 200 if snap["status"] == "ok" else 503
                self._send(code, (json.dumps(snap, default=str)
                                  + "\n").encode(), "application/json")
            else:
                self._send(404, b"not found\n", "text/plain")
        except Exception as e:
            # a probe must never crash the serving thread; the failure
            # is recorded, the prober sees a 500
            telemetry.event("healthz_request_failed",
                            error="%s: %s" % (type(e).__name__, e))
            try:
                self._send(500, b"internal error\n", "text/plain")
            except OSError:
                pass  # client went away mid-error: nothing to do

    def log_message(self, fmt, *args):
        pass  # probes are high-frequency; stderr is not a log sink


class HealthServer:
    """One HTTP daemon thread + one watchdog daemon thread."""

    def __init__(self, port: int):
        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True,
            name="gs-healthz")
        self._thread.start()
        self._stop = threading.Event()
        self._watchdog = threading.Thread(
            target=self._watch, daemon=True, name="gs-health-watchdog")
        self._watchdog.start()

    def _watch(self) -> None:
        while not self._stop.is_set():
            stale = metrics.stale_after_s()
            tick = min(max(stale / 4.0, 0.05), 1.0) if stale > 0 else 1.0
            if self._stop.wait(tick):
                return
            metrics.check_staleness()

    def close(self) -> None:
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()


_SERVER: Optional[HealthServer] = None
_SERVER_LOCK = threading.Lock()


def start(port: Optional[int] = None) -> HealthServer:
    """Bring up (or return) the process's health server. `port` None
    reads GS_METRICS_PORT; pass 0 for an OS-assigned ephemeral port
    (tests) — the bound port is `.port`."""
    global _SERVER
    with _SERVER_LOCK:
        if _SERVER is None:
            if port is None:
                port = knobs.get_int("GS_METRICS_PORT")
            _SERVER = HealthServer(port)
        return _SERVER


def maybe_start() -> Optional[HealthServer]:
    """Idempotent lazy start used by the instrumented layers: a
    server comes up only when GS_METRICS_PORT names a port."""
    if _SERVER is not None:
        return _SERVER
    if knobs.get_int("GS_METRICS_PORT") <= 0:
        return None
    return start()


def stop() -> None:
    """Shut the server down (tests / operator teardown)."""
    global _SERVER
    with _SERVER_LOCK:
        if _SERVER is not None:
            _SERVER.close()
            _SERVER = None
