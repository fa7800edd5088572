"""Observability HTTP surface of a torch replica: the part of the
reference's ``k8s_gpu_tpu/utils/obs.py`` that a serving or training
process of the port needs.

``MetricsServer`` serves, on a daemon thread:

- ``/metrics``: the registry's text exposition;
- ``/healthz``, ``/readyz`` (``ready_check`` gates readiness);
- ``/debug/traces``: the tracer's assembled traces, filtered by
  ``trace_id=``, ``min_ms=``, ``name=``, ``limit=`` and ``since=`` (the
  completion cursor, echoed as ``cursor``);
- ``/debug/requests``: the request journal, filtered by ``tenant=``,
  ``reason=``, ``trace_id=``, ``limit=``, ``since=`` and ``probes=0``;
- ``/debug/profile``: the phase profiler's ``profile_snapshot``;
- ``/debug/goodput``: the goodput ledger's ``goodput_snapshot``.

Each body is the reference's, byte for byte, so the reference's
``FleetTraceAssembler`` (``utils/waterfall.py``), federation collector
and ``obs`` views read a torch replica as they read a JAX one.
``RequestMetricsMixin`` instruments a ``BaseHTTPRequestHandler`` as the
reference's does: ``http_requests_total{server,method,route,code}``,
``http_request_seconds{server,route}`` and one ``http <METHOD> <route>``
span a request (probe routes open none unless the caller sent a
``traceparent``), whose context the handler reads as ``self.trace_ctx``.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from .goodput import goodput_snapshot
from .metrics import MetricsRegistry, global_metrics
from .profiler import profile_snapshot
from .tracing import Tracer, global_tracer, parse_traceparent


class RequestMetricsMixin:
    """Request counts, latencies and a server span for a stdlib handler.
    Subclasses set ``metrics_server_label`` and ``known_routes`` (an
    unknown path counts as ``"other"``: a path scan must not mint
    series), implement ``_get``/``_post`` and set ``self._last_code``
    when they answer."""

    metrics_server_label = "http"
    known_routes: tuple[str, ...] = ()
    trace_ctx = None
    # Probe traffic would churn real traces out of the bounded ring.
    trace_exempt_routes: tuple[str, ...] = ("/healthz", "/readyz",
                                            "/metrics")

    def _route(self) -> str:
        path = self.path.split("?")[0]
        for r in self.known_routes:
            if path == r:
                return r
            if r != "/" and path.startswith(r.rstrip("/") + "/"):
                return r
        return "other"

    def _timed(self, method: str, impl) -> None:
        self._last_code = 0
        # A keep-alive connection's next request must not inherit this
        # one's context.
        self.trace_ctx = None
        route = self._route()
        t0 = time.time()
        inbound = parse_traceparent(self.headers.get("traceparent"))
        try:
            if route in self.trace_exempt_routes and inbound is None:
                impl()
            else:
                with global_tracer.span(f"http {method} {route}",
                                        parent=inbound,
                                        server=self.metrics_server_label
                                        ) as sp:
                    self.trace_ctx = sp.context
                    impl()
                    sp.attributes["code"] = self._last_code
        finally:
            global_metrics.inc(
                "http_requests_total", server=self.metrics_server_label,
                method=method, route=route, code=str(self._last_code))
            global_metrics.observe(
                "http_request_seconds", time.time() - t0,
                server=self.metrics_server_label, route=route)

    def do_GET(self):  # noqa: N802 (stdlib API name)
        self._timed("GET", self._get)

    def do_POST(self):  # noqa: N802
        self._timed("POST", self._post)


class MetricsServer:
    """port=0 binds an ephemeral port; ``.port`` is the bound one.
    ``tracer`` defaults to the port's ``global_tracer``; ``journal`` (a
    ``serve.journal.RequestJournal``), ``profile`` (a ``PhaseProfiler``)
    and ``goodput`` (a ``GoodputLedger``) are optional, and a route
    whose source is absent answers 404."""

    def __init__(self, registry: MetricsRegistry | None = None,
                 host: str = "127.0.0.1", port: int = 0, ready_check=None,
                 tracer: Tracer | None = None, journal=None, profile=None,
                 goodput=None):
        self.registry = registry or global_metrics
        self.tracer = tracer or global_tracer
        self.journal = journal
        self.profile = profile
        self.goodput = goodput
        self.started_at = time.time()
        self._ready_check = ready_check
        outer = self

        class Handler(RequestMetricsMixin, BaseHTTPRequestHandler):
            metrics_server_label = "obs"
            known_routes = ("/debug/goodput", "/debug/profile",
                            "/debug/requests", "/debug/traces", "/metrics",
                            "/healthz", "/readyz")

            def _get(self):
                route = {
                    "/metrics": self._metrics,
                    "/healthz": self._healthz,
                    "/readyz": self._readyz,
                    "/debug/traces": self._traces,
                    "/debug/requests": self._requests,
                    "/debug/profile": self._profile,
                    "/debug/goodput": self._goodput,
                }.get(self.path.split("?")[0])
                if route is None:
                    return self._send(404, b"not found", "text/plain")
                return route()

            def _post(self):
                self._send(404, b"not found", "text/plain")

            def _query(self):
                q = parse_qs(urlparse(self.path).query)
                return lambda key, default="": (q.get(key) or [default])[0]

            def _json(self, code: int, payload) -> None:
                self._send(code, json.dumps(payload).encode(),
                           "application/json")

            def _absent(self, what: str) -> None:
                self._json(404, {"error": f"no {what} attached"})

            def _metrics(self):
                self._send(200, outer.registry.render().encode(),
                           "text/plain; version=0.0.4")

            def _healthz(self):
                self._json(200, {"ok": True,
                                 "uptime_s": time.time() - outer.started_at})

            def _readyz(self):
                ready = outer._ready_check() if outer._ready_check else True
                self._json(200 if ready else 503, {"ready": bool(ready)})

            def _profile(self):
                if outer.profile is None:
                    return self._absent("phase profiler")
                # sort_keys: the reference's body, byte for byte.
                body = json.dumps(profile_snapshot(outer.profile,
                                                   outer.registry),
                                  sort_keys=True).encode()
                self._send(200, body, "application/json")

            def _goodput(self):
                if outer.goodput is None:
                    return self._absent("goodput ledger")
                body = json.dumps(goodput_snapshot(outer.goodput,
                                                   outer.registry),
                                  sort_keys=True).encode()
                self._send(200, body, "application/json")

            def _requests(self):
                if outer.journal is None:
                    return self._absent("request journal")
                one = self._query()
                try:
                    limit = int(one("limit", "100"))
                    since = int(one("since", "0"))
                except ValueError:
                    return self._json(400,
                                      {"error": "limit/since must be ints"})
                # Cursor first: a record appended between the snapshot
                # and the cursor read would be skipped by the next pass.
                cursor = outer.journal.cursor
                origin = outer.journal.origin
                recs = outer.journal.snapshot(
                    limit=limit, tenant=one("tenant"), reason=one("reason"),
                    trace_id=one("trace_id"),
                    probes=one("probes", "1") != "0", since=since)
                self._json(200, {"requests": recs, "cursor": cursor,
                                 "origin": origin})

            def _traces(self):
                one = self._query()
                try:
                    min_ms = float(one("min_ms", "0"))
                    limit = int(one("limit", "50"))
                    since = int(one("since", "0"))
                except ValueError:
                    return self._json(400, {
                        "error": "min_ms/limit/since must be numeric"})
                cursor = outer.tracer.cursor      # first, as above
                traces = outer.tracer.traces(
                    trace_id=one("trace_id") or None, min_ms=min_ms,
                    name=one("name"), limit=limit, since=since)
                self._json(200, {"traces": traces, "cursor": cursor})

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self._last_code = code
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # no per-request stderr
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-server",
            daemon=True)

    def start(self) -> "MetricsServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=2)
