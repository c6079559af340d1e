"""Trainer-side /metrics sidecar — Prometheus scrape for processes that
are not HTTP servers.  Counterpart of paddle_tpu/observability/sidecar.py
(a copy: it is pure Python, over the port's core/monitor.py).

The inference server exposes /metrics itself; a trainer has no HTTP
surface, so the sidecar is a tiny background ThreadingHTTPServer that
serves the process monitor registry in exposition format:

    GET /metrics  -> core.monitor.prometheus_text() (text/plain 0.0.4)
    GET /healthz  -> {"status": "ok"}

Arming: ``PADDLE_TPU_METRICS_PORT=<port>`` (0 = ephemeral; the bound
port is logged to the journal) auto-starts it at the first training
step, or call `start_metrics_server` explicitly.  Every series carries
a ``rank`` label so a pod-level scrape distinguishes trainers.
"""
from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

__all__ = ["METRICS_PORT_ENV", "MetricsSidecar", "start_metrics_server",
           "maybe_start_from_env"]

METRICS_PORT_ENV = "PADDLE_TPU_METRICS_PORT"


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet
        pass

    def do_GET(self):
        if self.path == "/metrics":
            from ..core.monitor import prometheus_text
            rank = os.environ.get("PADDLE_TRAINER_ID", "0")
            body = prometheus_text(labels={"rank": rank}).encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif self.path == "/healthz":
            body = json.dumps({"status": "ok"}).encode()
            ctype = "application/json"
        else:
            body = json.dumps({"error": f"no route {self.path}"}).encode()
            self.send_response(404)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class MetricsSidecar:
    """start() binds and serves on a daemon thread; stop() closes."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricsSidecar":
        t = threading.Thread(target=self._httpd.serve_forever,
                             kwargs={"poll_interval": 0.2}, daemon=True)
        t.start()
        self._thread = t
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread = None
        self._httpd.server_close()


def start_metrics_server(port: int = 0,
                         host: str = "127.0.0.1") -> MetricsSidecar:
    """Start a /metrics sidecar; returns it with ``.port`` bound."""
    return MetricsSidecar(host, port).start()


_sidecar: Optional[MetricsSidecar] = None
_checked = False


def maybe_start_from_env() -> Optional[MetricsSidecar]:
    """Start the sidecar once iff ``PADDLE_TPU_METRICS_PORT`` is set
    (called from the executor's first training step; cached no-op
    otherwise).

    A launcher exports ONE env to every local trainer, so a fixed base
    port is offset by trainer rank (base 9400, 8 ranks -> 9400-9407,
    the workerlog.N pattern); 0 stays "ephemeral, port in the journal".
    If the computed port is taken anyway, the sidecar falls back to an
    ephemeral port rather than silently leaving the rank unscrapeable —
    either way the bound port is journaled."""
    global _sidecar, _checked
    if _checked:
        return _sidecar
    _checked = True
    raw = os.environ.get(METRICS_PORT_ENV, "")
    if not raw:
        return None
    try:
        port = int(raw)
    except ValueError:
        return None
    if port:
        try:
            port += int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        except ValueError:
            pass
    from .journal import emit
    try:
        _sidecar = start_metrics_server(port)
    except OSError:
        try:
            _sidecar = start_metrics_server(0)
        except OSError:  # no ports at all: telemetry never kills a run
            emit("metrics_sidecar", port=None, error="bind failed")
            return None
    emit("metrics_sidecar", port=_sidecar.port)
    return _sidecar
