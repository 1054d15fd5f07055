"""Live status endpoints: /metrics, /healthz, /statusz, /varz.

Extends what used to be ``serve.py``'s bare Prometheus listener into a
small operational surface on the same port:

- ``/metrics`` — Prometheus text exposition (unchanged scrape target).
- ``/healthz`` — ``{"status": "ok"|"degraded"|"critical", ...}`` from the
  health monitor's firing set; HTTP 503 when a critical rule is firing,
  200 otherwise (load-balancer friendly).
- ``/statusz`` — one JSON document assembled from registered *providers*
  (in-flight queries, per-tenant budgets, tick rate, log generation/size,
  stream lag, recent alerts); append ``?format=html`` (or send
  ``Accept: text/html``) for a minimal human-readable page.
- ``/varz`` — the raw registry snapshot as JSON.

Providers are late-bound through a ``StatusHub`` so the server can start
before the service exists: ``serve.py`` boots the listener first, then the
service/watcher register their sections as they come up.  Every provider
call is defensive — a crashing section renders as an error string, never a
500.
"""
from __future__ import annotations

import html
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

from repro_torch.obs.export import _jsonable, registry_to_prometheus
from repro_torch.utils.timing import monotonic


class StatusHub:
    """Late-bound data sources for the status endpoints."""

    def __init__(self, monitor=None, flight=None):
        self.monitor = monitor
        self.flight = flight
        self._providers: Dict[str, Callable[[], Any]] = {}
        self._lock = threading.Lock()
        self.started_wall = time.time()  # noqa: TID251 — operator-facing
        self._started_mono = monotonic()

    def add_provider(self, name: str, fn: Callable[[], Any]) -> "StatusHub":
        with self._lock:
            self._providers[name] = fn
        return self

    # ------------------------------------------------------------- views
    def healthz(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"status": "ok", "firing": [], "rules": 0}
        if self.monitor is not None:
            out.update(self.monitor.status())
        out["uptime_s"] = monotonic() - self._started_mono
        return out

    def statusz(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "uptime_s": monotonic() - self._started_mono,
            "started_wall": self.started_wall,
            "health": self.healthz(),
        }
        if self.monitor is not None:
            out["recent_alerts"] = [a.to_dict()
                                    for a in self.monitor.recent(20)]
        with self._lock:
            providers = dict(self._providers)
        for name, fn in sorted(providers.items()):
            try:
                out[name] = fn()
            except Exception as e:  # a dead section must not kill the page
                out[name] = {"error": repr(e)}
        return out


def _statusz_html(doc: Dict[str, Any]) -> str:
    """Minimal human-readable rendering of the statusz document."""
    health = doc.get("health", {})
    rows = "".join(
        f"<tr><td>{html.escape(str(k))}</td>"
        f"<td><pre>{html.escape(json.dumps(_jsonable(v), indent=2, sort_keys=True))}"
        f"</pre></td></tr>"
        for k, v in doc.items() if k != "health")
    return (
        "<!doctype html><html><head><title>statusz</title></head><body>"
        f"<h1>statusz — {html.escape(str(health.get('status', '?')))}</h1>"
        f"<p>uptime {doc.get('uptime_s', 0):.1f}s · firing: "
        f"{html.escape(', '.join(health.get('firing', [])) or 'none')}</p>"
        f"<table border=1 cellpadding=4>{rows}</table>"
        "<p><a href='/healthz'>/healthz</a> · <a href='/varz'>/varz</a> · "
        "<a href='/metrics'>/metrics</a></p>"
        "</body></html>")


def start_status_server(registry, port: int, host: str = "127.0.0.1",
                        hub: Optional[StatusHub] = None,
                        label: str = "status"):
    """Serve the status endpoints on a daemon thread; returns the server.

    ``port=0`` binds an ephemeral port (tests); the actual address is
    ``server.server_address``.  The bound address is logged exactly once.
    """
    hub = hub if hub is not None else StatusHub()

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, body: str, ctype: str) -> None:
            data = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _send_json(self, code: int, doc: Any) -> None:
            self._send(code, json.dumps(_jsonable(doc), indent=2,
                                        sort_keys=True) + "\n",
                       "application/json")

        def do_GET(self):
            path, _, query = self.path.partition("?")
            if path in ("/", "/metrics"):
                self._send(200, registry_to_prometheus(registry),
                           "text/plain; version=0.0.4")
            elif path == "/healthz":
                doc = hub.healthz()
                code = 503 if doc.get("status") == "critical" else 200
                self._send_json(code, doc)
            elif path == "/varz":
                self._send_json(200, registry.snapshot())
            elif path == "/statusz":
                doc = hub.statusz()
                wants_html = ("format=html" in query
                              or "text/html" in self.headers.get("Accept",
                                                                 ""))
                if wants_html:
                    self._send(200, _statusz_html(doc), "text/html")
                else:
                    self._send_json(200, doc)
            else:
                self._send_json(404, {"error": f"unknown path {path!r}",
                                      "paths": ["/metrics", "/healthz",
                                                "/statusz", "/varz"]})

        def log_message(self, fmt, *args):  # silence per-request stderr spam
            pass

    srv = ThreadingHTTPServer((host, port), Handler)
    srv.hub = hub  # tests and callers reach the hub through the server
    bound_host, bound_port = srv.server_address[0], srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True,
                     name="status-server").start()
    print(f"[{label}] status endpoints at http://{bound_host}:{bound_port}"
          "/statusz (/healthz /varz /metrics)")
    return srv
