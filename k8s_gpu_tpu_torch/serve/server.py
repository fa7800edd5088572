"""LM serving over HTTP: the port of ``k8s_gpu_tpu/serve/server.py``.

POST /generate  {"prompt": "text" | "prompt_ids": [...], "max_new_tokens": N,
                 "temperature", "top_p", "seed"[, "stream": true]
                 [, "logprobs": true]}
                -> {"text", "ids", "prompt_tokens", "generated_tokens",
                    "tokens_per_s"[, "logprobs"]}, or newline-delimited JSON
                   token events then a summary; 429 + Retry-After when the
                   pending queue is full
POST /tokenize  {"text": "..."} -> {"ids": [...], "count": n}
POST /precache  {"prompt": "text"} -> {"cached_tokens": n}: later prompts
                that start with it prefill only their suffix; 400 on an
                empty prompt or an unusable length
GET  /healthz, /readyz

Requests go into one ContinuousBatcher: the dense KV pool by default,
the paged pool with ``paged_blocks`` > 0.  Not ported yet (ROADMAP queue
1 item 5): /prefill, /admin/*, /debug/*, deadlines, tenants, adapters,
constraints, request metrics and tracing.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..data.tokenizer import BpeTokenizer
from .batcher import ContinuousBatcher
from .scheduler import Overloaded

RETRY_AFTER_S = 1


class LmServer:
    """port=0 binds an ephemeral port; ``.port`` is the bound one.  The
    batcher runs on ``device`` (the card unless the caller asks for the
    CPU), on the dense pool unless ``paged_blocks`` > 0."""

    def __init__(self, model, params, tokenizer: BpeTokenizer,
                 host: str = "127.0.0.1", port: int = 0,
                 max_new_tokens_cap: int = 256, slots: int = 4,
                 eos_id: int = -1, kv_quant: bool = False,
                 attn_impl: str | None = None, paged_blocks: int = 0,
                 page_size: int = 64, max_pending: int = 64,
                 name: str = "", device="cuda"):
        self.batcher = ContinuousBatcher(
            model, params, slots=slots, eos_id=eos_id, logprobs=True,
            kv_quant=kv_quant, attn_impl=attn_impl,
            paged_blocks=paged_blocks, page_size=page_size,
            max_pending=max_pending, device=device,
        )
        self.tokenizer = tokenizer
        self.name = str(name)
        self.started_at = time.time()
        self.cap = max_new_tokens_cap
        self._draining = False
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path == "/healthz":
                    self._json(200, {
                        "ok": True,
                        "uptime_s": time.time() - outer.started_at,
                        "replica": outer.name,
                        "inflight": outer.batcher.inflight_requests,
                    })
                elif self.path == "/readyz":
                    r = outer.readiness()
                    self._json(200 if r["ready"] else 503, r)
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                except (ValueError, json.JSONDecodeError):
                    return self._json(400, {"error": "invalid JSON body"})
                if not isinstance(body, dict):
                    return self._json(400, {"error": "body must be an object"})
                if self.path == "/generate":
                    return self._generate(body)
                if self.path == "/tokenize":
                    text = body.get("text", "")
                    if not isinstance(text, str):
                        return self._json(
                            400, {"error": "text must be a string"})
                    ids = outer.tokenizer.encode(text)
                    return self._json(200, {"ids": ids.tolist(),
                                            "count": int(ids.size)})
                if self.path == "/precache":
                    text = body.get("prompt", "")
                    if not isinstance(text, str) or not text:
                        return self._json(
                            400, {"error": "prompt (string) required"})
                    ids = outer.tokenizer.encode(text)
                    try:
                        outer.batcher.precache_prefix(ids)
                    except ValueError as e:
                        return self._json(400, {"error": str(e)})
                    return self._json(200, {"cached_tokens": int(ids.size)})
                return self._json(404, {"error": "not found"})

            def _generate(self, body):
                prompt = body.get("prompt", "")
                prompt_ids = body.get("prompt_ids")
                if prompt_ids is not None:
                    if (not isinstance(prompt_ids, list) or not prompt_ids
                            or not all(isinstance(i, int)
                                       and not isinstance(i, bool)
                                       for i in prompt_ids)):
                        return self._json(400, {
                            "error": "prompt_ids must be a non-empty "
                                     "list of ints"})
                    vocab = outer.batcher.engine.cfg.vocab_size
                    if not all(0 <= i < vocab for i in prompt_ids):
                        return self._json(400, {
                            "error": "prompt_ids out of vocabulary range"})
                elif not isinstance(prompt, str) or not prompt:
                    return self._json(
                        400, {"error": "prompt (string) required"})
                try:
                    want = int(body.get("max_new_tokens", 32))
                    temperature = float(body.get("temperature", 0.0))
                    top_p = float(body.get("top_p", 0.0))
                    seed = int(body.get("seed", 0))
                except (TypeError, ValueError) as e:
                    return self._json(400, {"error": f"bad parameter: {e}"})
                stream = bool(body.get("stream", False))
                want_lp = bool(body.get("logprobs", False))
                ids = (np.asarray(prompt_ids, np.int32)
                       if prompt_ids is not None
                       else outer.tokenizer.encode(prompt))
                t0 = time.perf_counter()
                try:
                    handle = outer.batcher.submit(
                        ids, max_new_tokens=max(1, min(want, outer.cap)),
                        temperature=temperature, top_p=top_p, seed=seed,
                    )
                except ValueError as e:
                    return self._json(400, {"error": str(e)})
                except Overloaded as e:
                    return self._json(
                        429, {"error": str(e)},
                        headers={"Retry-After": str(RETRY_AFTER_S)})
                except RuntimeError as e:  # scheduler stopped
                    return self._json(
                        503, {"error": str(e)},
                        headers={"Retry-After": str(RETRY_AFTER_S)})
                if stream:
                    return self._stream(handle, ids, t0, want_lp)
                gen_ids = handle.result()
                if handle.aborted:
                    return self._json(503, {
                        "error": "generation aborted: server shutting down "
                                 "or batcher failed",
                        "ids": gen_ids,
                    }, headers={"Retry-After": str(RETRY_AFTER_S)})
                dt = time.perf_counter() - t0
                out = {
                    "text": outer.tokenizer.decode(gen_ids),
                    "ids": gen_ids,
                    "prompt_tokens": int(ids.size),
                    "generated_tokens": len(gen_ids),
                    "tokens_per_s": (round(len(gen_ids) / dt, 2)
                                     if dt > 0 else 0.0),
                }
                if want_lp:
                    out["logprobs"] = handle.logprobs
                return self._json(200, out)

            def _stream(self, handle, prompt_ids, t0, want_lp):
                """One {"id": ...} event per token as the batcher emits
                it, then a summary event; the connection closes at the
                end (no Content-Length)."""
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.end_headers()
                gen_ids = []
                try:
                    for tok in handle:
                        gen_ids.append(tok)
                        event = {"id": tok}
                        if want_lp:
                            event["logprob"] = handle.last_logprob
                        self.wfile.write((json.dumps(event) + "\n").encode())
                        self.wfile.flush()
                except OSError:
                    for _ in handle:  # client gone: let the slot retire
                        pass
                    return
                dt = time.perf_counter() - t0
                if handle.aborted:
                    summary = {"done": False,
                               "error": "generation aborted: server "
                                        "shutting down or batcher failed"}
                else:
                    summary = {
                        "done": True,
                        "text": outer.tokenizer.decode(gen_ids),
                        "prompt_tokens": int(len(prompt_ids)),
                        "generated_tokens": len(gen_ids),
                        "tokens_per_s": (round(len(gen_ids) / dt, 2)
                                         if dt > 0 else 0.0),
                    }
                try:
                    self.wfile.write((json.dumps(summary) + "\n").encode())
                    self.wfile.flush()
                except OSError:
                    pass

            def _json(self, code, payload, headers=None):
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):  # no per-request stderr
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="lm-server", daemon=True
        )

    def readiness(self) -> dict:
        """/readyz: ready when the scheduler is alive, has served a token,
        and the replica is not draining."""
        alive = self.batcher.scheduler_alive
        warmed = self.batcher.past_first_compile
        return {
            "ready": alive and warmed and not self._draining,
            "scheduler_alive": alive,
            "warmed": warmed,
            "draining": self._draining,
            "replica": self.name,
            "inflight": self.batcher.inflight_requests,
        }

    def drain(self) -> None:
        """Report NotReady without stopping work."""
        self._draining = True

    def undrain(self) -> None:
        self._draining = False

    def start(self) -> "LmServer":
        self.batcher.start()
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=2)
        self.batcher.stop()
