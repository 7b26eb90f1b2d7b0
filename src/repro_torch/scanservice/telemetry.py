"""HTTP telemetry front: ``/metrics``, ``/healthz``, ``/traces``.

A serving process needs to be *scrapeable* — Prometheus pulls, load
balancers probe, operators curl. :class:`TelemetryServer` is that front:
a stdlib ``http.server`` (no new dependencies) running on its own daemon
thread, serving three read-only endpoints over the process-wide
:mod:`repro_torch.obs` state:

* ``GET /metrics`` — ``obs.render_prometheus`` of the live registry
  snapshot (with registered ``# HELP`` descriptions). Scrapes are safe at
  any moment — every metric read takes its own lock, so a scrape during an
  active coalesced scheduler burst sees a consistent per-metric view
  without ever blocking the burst.
* ``GET /healthz`` — liveness + the service's operational state as JSON:
  scheduler counters (the atomic :class:`SchedulerStats` copy), two-tier
  cache counters with the derived hit rate, and artifact-store occupancy.
  A server constructed without a service still answers (process identity
  and uptime only), as a corpus-shard worker's does.
* ``GET /traces`` — recent span activity grouped per trace id (newest
  first, ``?limit=N`` traces): span count, wall, and the span names in
  start order — the "what were the last requests doing" drill-down.

Ownership: :meth:`repro_torch.scanservice.ScanService.serve_telemetry` starts
one bound to the service and ``ScanService.close()`` stops it; a bare
``TelemetryServer().start()`` serves registry + traces for any process
(e.g. a corpus-shard worker). ``port=0`` binds an ephemeral port,
published as ``server.port`` / ``server.url`` after :meth:`start`.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from collections import OrderedDict
from dataclasses import asdict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

from .. import obs

#: Prometheus text exposition content type (version pinned per spec).
PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class TelemetryServer:
    """One process's scrape endpoint. See module docstring."""

    def __init__(self, service=None, *, host: str = "127.0.0.1",
                 port: int = 0):
        self.service = service
        self.host = host
        self._port_req = port
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._t_start: float | None = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "TelemetryServer":
        """Bind and serve on a daemon thread (idempotent). -> self."""
        if self._httpd is not None:
            return self
        handler = type("_BoundHandler", (_Handler,), {"telemetry": self})
        self._httpd = ThreadingHTTPServer((self.host, self._port_req),
                                          handler)
        self._httpd.daemon_threads = True
        self._t_start = time.time()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="telemetry", daemon=True
        )
        self._thread.start()
        return self

    @property
    def running(self) -> bool:
        return self._httpd is not None

    @property
    def port(self) -> int | None:
        """The bound port (the real one when constructed with ``port=0``),
        or None before :meth:`start`."""
        return self._httpd.server_address[1] if self._httpd else None

    @property
    def url(self) -> str | None:
        return f"http://{self.host}:{self.port}" if self._httpd else None

    def close(self) -> None:
        """Stop serving and release the port (idempotent). In-flight
        requests finish; new connections are refused."""
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._thread.join()
        self._httpd.server_close()
        self._httpd = None
        self._thread = None

    def __enter__(self) -> "TelemetryServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- endpoint payloads (also callable directly, e.g. from tests) ---------

    def metrics_text(self) -> str:
        return obs.render_prometheus(obs.snapshot())

    def healthz(self) -> dict:
        payload = {
            "status": "ok",
            "host": socket.gethostname(),
            "pid": os.getpid(),
            "uptime_s": (time.time() - self._t_start
                         if self._t_start is not None else 0.0),
            "obs_enabled": obs.enabled(),
        }
        svc = self.service
        if svc is None:
            return payload
        sched = asdict(svc.scheduler.stats)
        sched["driver"] = svc.scheduler.driver
        sched["closed"] = svc.scheduler.closed
        if sched["closed"]:
            payload["status"] = "closing"
        info = svc.cache.info.snapshot()
        looked = info["hits"] + info["misses"]
        payload["scheduler"] = sched
        payload["cache"] = {
            **info, "hit_rate": info["hits"] / looked if looked else 0.0,
        }
        if svc.store is not None:
            payload["store"] = {
                "root": str(svc.store.root),
                "entries": len(svc.store),
                "bytes": svc.store.total_bytes(),
                "max_bytes": svc.store.max_bytes,
            }
        return payload

    def traces(self, limit: int = 20) -> dict:
        """Recent span activity summarized per trace, newest trace first."""
        by_trace: OrderedDict = OrderedDict()
        for s in obs.recent_spans(4096):
            t = by_trace.setdefault(s.trace_id, {
                "trace_id": s.trace_id, "n_spans": 0,
                "t_start": s.t_start, "t_end": s.t_end, "names": [],
            })
            t["n_spans"] += 1
            t["t_start"] = min(t["t_start"], s.t_start)
            t["t_end"] = max(t["t_end"], s.t_end)
            if s.name not in t["names"]:
                t["names"].append(s.name)
        traces = []
        for t in reversed(by_trace.values()):
            if len(traces) >= max(limit, 0):
                break
            traces.append({
                "trace_id": t["trace_id"], "n_spans": t["n_spans"],
                "wall_s": t["t_end"] - t["t_start"], "names": t["names"],
            })
        return {"traces": traces, "retained_traces": len(by_trace)}


class _Handler(BaseHTTPRequestHandler):
    """Routes one GET; the bound :class:`TelemetryServer` rides the class
    attribute ``telemetry`` (set by ``start()``'s subclass-per-server)."""

    server_version = "repro-telemetry"
    telemetry: TelemetryServer

    def log_message(self, *args) -> None:   # scrapes are not access-log news
        pass

    def do_GET(self) -> None:
        url = urlsplit(self.path)
        route = url.path.rstrip("/") or "/"
        try:
            if route == "/metrics":
                self._send(200, self.telemetry.metrics_text(),
                           PROM_CONTENT_TYPE)
            elif route == "/healthz":
                self._send_json(200, self.telemetry.healthz())
            elif route == "/traces":
                try:
                    limit = int(parse_qs(url.query).get("limit", ["20"])[0])
                except ValueError:
                    self._send_json(400, {"error": "limit must be an int"})
                    return
                self._send_json(200, self.telemetry.traces(limit))
            else:
                self._send_json(404, {
                    "error": f"no route {route!r}",
                    "routes": ["/metrics", "/healthz", "/traces"],
                })
        except Exception as e:   # a broken scrape must not kill the server
            try:
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
            except OSError:
                pass   # client hung up mid-reply

    def _send(self, code: int, body: str, content_type: str) -> None:
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send_json(self, code: int, payload: dict) -> None:
        self._send(code, json.dumps(payload, indent=1, sort_keys=True),
                   "application/json")
