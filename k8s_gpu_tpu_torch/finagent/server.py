"""HTTP surface — the FastAPI role, stdlib-only: the port's own copy of
``k8s_gpu_tpu/finagent/server.py``.

Same routes and JSON shapes as the reference (智能风控解决方案.md:309-331,
curl acceptance :500-520):

- ``POST /chat``  {"query": ..., "user_id": ...} → {"agent", "response"}
- ``GET  /``      → {"status": "Fin-Agent-Suite is running."}

``serve_background`` runs the server on a daemon thread and returns
(server, port) for tests and demos.
"""

from __future__ import annotations

import json
import threading
from dataclasses import asdict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .agents import FinAgentApp, QueryRequest


def make_handler(app: FinAgentApp):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload, ensure_ascii=False).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/":
                self._send(200, {"status": "Fin-Agent-Suite is running."})
            else:
                self._send(404, {"detail": "Not Found"})

        def do_POST(self):
            if self.path != "/chat":
                self._send(404, {"detail": "Not Found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                data = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(data, dict) or "query" not in data:
                    self._send(422, {"detail": "field 'query' is required"})
                    return
                req = QueryRequest(
                    query=data["query"],
                    user_id=data.get("user_id", "user_123"),
                )
                self._send(200, asdict(app.chat(req)))
            except json.JSONDecodeError:
                self._send(400, {"detail": "invalid JSON"})
            except Exception as e:  # pragma: no cover - defensive 500
                self._send(500, {"detail": str(e)})

        def log_message(self, *a):  # quiet test output
            pass

    return Handler


def serve_background(app: FinAgentApp, port: int = 0):
    srv = ThreadingHTTPServer(("127.0.0.1", port), make_handler(app))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, srv.server_address[1]
