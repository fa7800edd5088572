"""LM serving over HTTP: the port of ``k8s_gpu_tpu/serve/server.py``, with
the reference's fleet contract, so the reference gateway, migrator,
disaggregated-prefill gateway and replayer drive a torch replica as they
drive a JAX one.

POST /generate  {"prompt": "text" | "prompt_ids": [...], "max_new_tokens": N,
                 "temperature", "top_p", "seed", "tenant", "adapter",
                 "constraint"[, "stream": true][, "logprobs": true]}
                -> {"text", "ids", "prompt_tokens", "generated_tokens",
                    "tokens_per_s", "trace_id"[, "logprobs"]}, or
                   newline-delimited JSON token events then a summary (a
                   stream cut by an export ends in {"done": false,
                   "error": "migrated", "resume": true}); 429 +
                   Retry-After when the pending queue is full; 504 when
                   the deadline passes; 400 for an adapter or
                   constraint that is not a string or not served.
                   Headers: ``x-tenant`` (when the
                   body has no tenant), ``x-request-deadline-ms`` (a
                   relative budget; 0 or less sheds at the door),
                   ``x-route-replica``/``x-route-reason`` (a front-end's
                   stamp), ``x-migrated-from`` (a resumed request) and
                   ``traceparent`` (continued, else a trace is minted;
                   the id comes back in ``x-trace-id``)
POST /tokenize  {"text": "..."} -> {"ids": [...], "count": n}
POST /precache  {"prompt": "text"} -> {"cached_tokens": n}
POST /prefill   {"prompt_ids", "seed", "temperature", "top_p", "tenant"}
                -> the migration payload of exactly that prompt's page
                   chain, plus "chain" (hex hashes) and "prefill_s": the
                   disaggregated prefill worker's half of a handover
POST /admin/export {"abort_live", "include_blocks"} -> the payload of
                   every registered block (``/readyz`` reports
                   ``migrating`` meanwhile); ``abort_live`` cuts the live
                   streams as migrated
POST /admin/import <payload> -> {"imported": n}; 400 for a malformed
                   payload, before the pool changes
POST /admin/role {"role": "both"|"prefill"|"decode"}: 409 with requests
                   in flight, 400 for an unknown role
GET  /debug/chains -> {"replica", "page_size", "chains"}: the gateway's
                   owner-map scrape
GET  /healthz, /readyz (with ``replica``, ``inflight``, ``role``,
                   ``migrating``)

Requests go into one ContinuousBatcher: the dense KV pool by default,
the paged pool with ``paged_blocks`` > 0 (migration and ``/prefill`` need
it).  Every request but a probe runs under an ``http <METHOD> <route>``
span (``utils.obs.RequestMetricsMixin``) that continues an inbound
``traceparent``; a ``/generate`` request's ``serve.*`` spans parent to
it.  ``journal`` (the batcher's record ring) and ``profiler`` (its phase
profiler) are what a ``utils.obs.MetricsServer`` serves at
``/debug/requests`` and ``/debug/profile``, beside the tracer's
``/debug/traces``.  ``/admin/export`` and ``/admin/import`` fire the
``migrate.export``/``migrate.import`` fault sites (``error``/``timeout``:
503 + Retry-After).

On a serving mesh (``mesh=``, ``params`` this rank's shards) every rank
builds the server, but only global rank 0, the batcher's leader, binds
the HTTP port (``port`` is None elsewhere); the other ranks' ``start()``
runs the batcher's follower loop, and ``wait()`` or ``stop()`` there
returns once the leader stops.  Every route answers there as on one
rank: ``/admin/export`` and ``/prefill`` send whole heads (the seam
gathers them over tp), ``/admin/import`` hands every rank its heads.
"""

from __future__ import annotations

import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..data.tokenizer import BpeTokenizer
from ..utils.faults import global_faults
from ..utils.obs import RequestMetricsMixin
from .batcher import ContinuousBatcher
from .constrain import ConstraintBank
from .journal import PROBE_TENANT, RequestRecord
from .kv_blocks import chunk_hashes, shareable_depth
from .migrate import pack as migrate_pack
from .migrate import unpack as migrate_unpack
from .scheduler import Overloaded

RETRY_AFTER_S = 1


def _ids_ok(ids) -> bool:
    return (isinstance(ids, list) and bool(ids)
            and all(isinstance(i, int) and not isinstance(i, bool)
                    for i in ids))


class LmServer:
    """port=0 binds an ephemeral port; ``.port`` is the bound one.  The
    batcher runs on ``device`` (the card unless the caller asks for the
    CPU), on the dense pool unless ``paged_blocks`` > 0.  ``name`` is the
    replica's fleet name; ``metrics`` the registry of its serve-plane
    series; ``role`` its disaggregated role (flippable through
    ``/admin/role`` while idle); ``draft`` and ``spec_k`` its
    speculative rounds (``ContinuousBatcher``).  ``adapters``: name ->
    (LoRA tree, ``LoraConfig``), picked by a request's ``"adapter"``.
    ``constraints``: name -> regex, compiled against this tokenizer's
    vocabulary (``tokenizer.decode([i])`` for every id) into a
    ``ConstraintBank``, picked by a request's ``"constraint"``; give
    ``eos_id`` with them, so dead-ended rows retire.  ``mesh``: serve on
    a dp x tp mesh (module docstring)."""

    def __init__(self, model, params, tokenizer: BpeTokenizer,
                 host: str = "127.0.0.1", port: int = 0,
                 max_new_tokens_cap: int = 256, slots: int = 4,
                 eos_id: int = -1, adapters: dict | None = None,
                 constraints: dict | None = None, draft=None,
                 spec_k: int = 4, kv_quant: bool = False,
                 attn_impl: str | None = None, paged_blocks: int = 0,
                 page_size: int = 64, max_pending: int = 64,
                 metrics=None, name: str = "", role: str = "both",
                 mesh=None, device="cuda"):
        cbank = None
        if constraints:
            token_strings = [tokenizer.decode([i])
                             for i in range(tokenizer.vocab_size)]
            cbank = ConstraintBank(constraints, token_strings)
        self.batcher = ContinuousBatcher(
            model, params, slots=slots, eos_id=eos_id, logprobs=True,
            adapters=adapters, constraints=cbank,
            draft=draft, spec_k=spec_k, kv_quant=kv_quant,
            attn_impl=attn_impl,
            paged_blocks=paged_blocks, page_size=page_size,
            max_pending=max_pending, metrics=metrics, role=role,
            mesh=mesh, device=device,
        )
        self.mesh = mesh
        self.journal = self.batcher.journal
        self.profiler = self.batcher.profiler
        self.tokenizer = tokenizer
        self.name = str(name)
        self.started_at = time.time()
        self.cap = max_new_tokens_cap
        # Drain latch: NotReady while in-flight and direct work go on.
        self._draining = False
        # Migration latch: NotReady while an export holds the scheduler.
        self._migrating = False
        outer = self

        class Handler(RequestMetricsMixin, BaseHTTPRequestHandler):
            metrics_server_label = "lm-server"
            known_routes = ("/generate", "/tokenize", "/precache",
                            "/prefill", "/healthz", "/readyz",
                            "/debug/chains", "/admin/export",
                            "/admin/import", "/admin/role")

            def _get(self):
                if self.path == "/debug/chains":
                    return self._json(200, outer.chain_state())
                if self.path == "/healthz":
                    return self._json(200, {
                        "ok": True,
                        "uptime_s": time.time() - outer.started_at,
                        "replica": outer.name,
                        "inflight": outer.batcher.inflight_requests,
                    })
                if self.path == "/readyz":
                    r = outer.readiness()
                    return self._json(200 if r["ready"] else 503, r)
                return self._json(404, {"error": "not found"})

            def _post(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                except (ValueError, json.JSONDecodeError):
                    return self._json(400, {"error": "invalid JSON body"})
                if not isinstance(body, dict):
                    return self._json(400, {"error": "body must be an object"})
                route = {
                    "/generate": self._generate,
                    "/tokenize": self._tokenize,
                    "/precache": self._precache,
                    "/prefill": self._prefill,
                    "/admin/export": self._admin_export,
                    "/admin/import": self._admin_import,
                    "/admin/role": self._admin_role,
                }.get(self.path)
                if route is None:
                    return self._json(404, {"error": "not found"})
                return route(body)

            def _tokenize(self, body):
                text = body.get("text", "")
                if not isinstance(text, str):
                    return self._json(400, {"error": "text must be a string"})
                ids = outer.tokenizer.encode(text)
                return self._json(200, {"ids": ids.tolist(),
                                        "count": int(ids.size)})

            def _precache(self, body):
                text = body.get("prompt", "")
                if not isinstance(text, str) or not text:
                    return self._json(
                        400, {"error": "prompt (string) required"})
                ids = outer.tokenizer.encode(text)
                try:
                    outer.batcher.precache_prefix(ids)
                except ValueError as e:
                    return self._json(400, {"error": str(e)})
                except (RuntimeError, TimeoutError) as e:
                    return self._unavailable(e)
                return self._json(200, {"cached_tokens": int(ids.size)})

            def _unavailable(self, e):
                return self._json(503, {"error": str(e)},
                                  headers={"Retry-After": str(RETRY_AFTER_S)})

            def _prefill(self, body):
                """Admit and prefill the prompt into the paged pool, then
                export exactly its registered page chain.  The one
                sampled token is discarded: the decode worker recomputes
                it from the imported chain (sampling is seeded per
                request).  No ``migrating`` latch: a per-chain export on
                a worker the gateway routes no decode to."""
                prompt_ids = body.get("prompt_ids")
                if not _ids_ok(prompt_ids):
                    return self._json(400, {
                        "error": "prompt_ids must be a non-empty list of "
                                 "ints"})
                if not outer.batcher.paged:
                    return self._json(400, {
                        "error": "disaggregated prefill requires paged KV "
                                 "mode"})
                ids = np.asarray(prompt_ids, np.int32)
                page = int(outer.batcher.page_size)
                depth = shareable_depth(int(ids.size), page)
                if depth <= 0:
                    return self._json(400, {
                        "error": "prompt too short for page-aligned "
                                 f"handover (needs > {page} tokens)"})
                try:
                    seed = int(body.get("seed", 0))
                    temperature = float(body.get("temperature", 0.0))
                    top_p = float(body.get("top_p", 0.0))
                except (TypeError, ValueError) as e:
                    return self._json(400, {"error": f"bad parameter: {e}"})
                tenant = body.get("tenant")
                if tenant is not None and not isinstance(tenant, str):
                    return self._json(400,
                                      {"error": "tenant must be a string"})
                t0 = time.perf_counter()
                try:
                    handle = outer.batcher.submit(
                        ids, max_new_tokens=1, temperature=temperature,
                        top_p=top_p, seed=seed, tenant=tenant,
                        trace_ctx=self.trace_ctx,
                    )
                except ValueError as e:
                    return self._json(400, {"error": str(e)})
                except Overloaded as e:
                    return self._json(
                        429, {"error": str(e)},
                        headers={"Retry-After": str(RETRY_AFTER_S)})
                except RuntimeError as e:
                    return self._unavailable(e)
                handle.result()
                if handle.aborted:
                    return self._unavailable(
                        "prefill aborted: server shutting down or batcher "
                        "failed")
                chain = chunk_hashes(ids, page)[:depth]
                try:
                    snap = outer.batcher.run_quiesced(
                        lambda: outer.batcher.migrate_export(hashes=chain))
                except (RuntimeError, TimeoutError) as e:
                    return self._unavailable(e)
                payload = migrate_pack(snap)
                payload["replica"] = outer.name
                payload["chain"] = [h.hex() for h in chain]
                payload["prefill_s"] = round(time.perf_counter() - t0, 6)
                return self._json(200, payload)

            def _admin_role(self, body):
                """Flip the executor's role; refused with requests in
                flight (a prefill-only executor raises on any round)."""
                role = body.get("role")
                if role not in ("both", "prefill", "decode"):
                    return self._json(400, {"error": f"unknown role {role!r}"})
                if outer.batcher.inflight_requests > 0:
                    return self._json(
                        409, {"error": "role flip refused: requests in "
                                       "flight"},
                        headers={"Retry-After": str(RETRY_AFTER_S)})
                outer.batcher.role = role
                return self._json(200, {"replica": outer.name, "role": role})

            def _admin_export(self, body):
                """Every registered block as a wire payload, through a
                quiesce barrier; ``abort_live`` also cuts the live
                streams as migrated, ``include_blocks=false`` skips the
                bodies.  400 on the dense pool, 503 when the scheduler
                is stopped or no boundary comes."""
                abort_live = bool(body.get("abort_live", False))
                include_blocks = bool(body.get("include_blocks", True))
                try:
                    # error/timeout only: no clock here for a "slow".
                    global_faults.fire("migrate.export",
                                       error_type=RuntimeError,
                                       only=("error", "timeout"))
                    outer._migrating = True
                    try:
                        snap = outer.batcher.run_quiesced(
                            lambda: outer.batcher.migrate_export(
                                abort_live=abort_live,
                                include_blocks=include_blocks))
                    finally:
                        outer._migrating = False
                except ValueError as e:
                    return self._json(400, {"error": str(e)})
                except (RuntimeError, TimeoutError) as e:
                    return self._unavailable(e)
                payload = migrate_pack(snap)
                payload["replica"] = outer.name
                return self._json(200, payload)

            def _admin_import(self, body):
                """Splice a payload's blocks into the pool through a
                quiesce barrier; a malformed payload answers 400 before
                the pool changes."""
                try:
                    global_faults.fire("migrate.import",
                                       error_type=RuntimeError,
                                       only=("error", "timeout"))
                    parsed = migrate_unpack(body)
                    n = outer.batcher.run_quiesced(
                        lambda: outer.batcher.migrate_import(parsed))
                except ValueError as e:
                    return self._json(400, {"error": str(e)})
                except (RuntimeError, TimeoutError) as e:
                    return self._unavailable(e)
                return self._json(200, {"imported": n, "replica": outer.name})

            def _door_shed(self, ids, tenant, route, want, temperature,
                           top_p, seed, budget_ms):
                """A deadline of 0 or less: shed before the batcher, on
                the same counter and journal as the batcher's sheds."""
                outer.batcher.metrics.inc("serve_shed_total",
                                          reason="deadline", tenant=tenant)
                now = time.monotonic()
                outer.journal.append(RequestRecord(
                    tenant=tenant,
                    trace_id=self.trace_ctx.trace_id,
                    reason="deadline",
                    prompt_ids=[int(t) for t in ids],
                    max_new=max(1, min(want, outer.cap)),
                    temperature=temperature, top_p=top_p, seed=seed,
                    deadline_s=budget_ms / 1000.0,
                    prompt_tokens=int(len(ids)),
                    replica=route[0] if route else "",
                    route_reason=route[1] if route else "",
                    deadline_expired=True, t_submit=now, t_done=now,
                    extra={"probe": True} if tenant == PROBE_TENANT else {},
                ))
                return self._json(504, {"error": "deadline exceeded"})

            def _generate(self, body):
                # prompt_ids is the resume path: a client failing a
                # migrated stream over sends the prompt plus the tokens
                # already emitted, as ids.
                prompt = body.get("prompt", "")
                prompt_ids = body.get("prompt_ids")
                if prompt_ids is not None:
                    if not _ids_ok(prompt_ids):
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
                adapter = body.get("adapter")
                if adapter is not None and not isinstance(adapter, str):
                    return self._json(400,
                                      {"error": "adapter must be a string"})
                constraint = body.get("constraint")
                if constraint is not None and not isinstance(constraint,
                                                             str):
                    return self._json(
                        400, {"error": "constraint must be a string"})
                # Tenant: the body's, else x-tenant; capped, it is a
                # metric label.
                tenant = body.get("tenant")
                if tenant is None:
                    tenant = self.headers.get("x-tenant") or ""
                if not isinstance(tenant, str):
                    return self._json(400,
                                      {"error": "tenant must be a string"})
                tenant = tenant.strip()[:64] or "default"
                route = None
                route_replica = self.headers.get("x-route-replica")
                if route_replica:
                    route = (route_replica.strip()[:64],
                             (self.headers.get("x-route-reason") or ""
                              ).strip()[:16] or "forwarded")
                stream = bool(body.get("stream", False))
                want_lp = bool(body.get("logprobs", False))
                ids = (np.asarray(prompt_ids, np.int32)
                       if prompt_ids is not None
                       else outer.tokenizer.encode(prompt))
                # x-request-deadline-ms is relative (clients do not share
                # this clock); it becomes an absolute deadline.
                deadline = None
                budget_ms = self.headers.get("x-request-deadline-ms")
                if budget_ms is not None:
                    try:
                        budget_ms = float(budget_ms)
                    except (TypeError, ValueError):
                        budget_ms = None
                    if budget_ms is None or not math.isfinite(budget_ms):
                        return self._json(400, {
                            "error": "x-request-deadline-ms must be a "
                                     "finite number"})
                    if budget_ms <= 0:
                        return self._door_shed(ids, tenant, route, want,
                                               temperature, top_p, seed,
                                               budget_ms)
                    deadline = time.monotonic() + budget_ms / 1000.0
                migrated_from = (self.headers.get("x-migrated-from")
                                 or "").strip()[:64]
                t0 = time.perf_counter()
                try:
                    handle = outer.batcher.submit(
                        ids, max_new_tokens=max(1, min(want, outer.cap)),
                        temperature=temperature, top_p=top_p, seed=seed,
                        adapter=adapter, constraint=constraint,
                        deadline=deadline, tenant=tenant, route=route,
                        migrated_from=migrated_from,
                        trace_ctx=self.trace_ctx,
                    )
                except ValueError as e:
                    return self._json(400, {"error": str(e)})
                except KeyError as e:  # unknown adapter or constraint
                    return self._json(400, {"error": e.args[0]})
                except Overloaded as e:
                    return self._json(
                        429, {"error": str(e)},
                        headers={"Retry-After": str(RETRY_AFTER_S)})
                except RuntimeError as e:  # scheduler stopped
                    return self._unavailable(e)
                if stream:
                    return self._stream(handle, ids, t0, want_lp)
                gen_ids = handle.result()
                if handle.deadline_expired:
                    return self._json(504, {"error": "deadline exceeded",
                                            "ids": gen_ids})
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
                    "trace_id": self.trace_ctx.trace_id,
                }
                if want_lp:
                    out["logprobs"] = handle.logprobs
                return self._json(200, out)

            def _stream(self, handle, prompt_ids, t0, want_lp):
                """One {"id": ...} event per token as the batcher emits
                it, then a summary event; the connection closes at the
                end (no Content-Length)."""
                self._last_code = 200
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("X-Accel-Buffering", "no")
                self.send_header("x-trace-id", self.trace_ctx.trace_id)
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
                    # Client gone (a migrating gateway cuts its upstream
                    # leg on purpose): let the slot retire.
                    for _ in handle:
                        pass
                    return
                dt = time.perf_counter() - t0
                if handle.deadline_expired:
                    summary = {"done": False, "error": "deadline exceeded"}
                elif handle.migrated:
                    # Resumable: the client re-submits prompt + these
                    # tokens to the replica that took the blocks.
                    summary = {"done": False, "error": "migrated",
                               "resume": True}
                elif handle.aborted:
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
                        "trace_id": self.trace_ctx.trace_id,
                    }
                try:
                    self.wfile.write((json.dumps(summary) + "\n").encode())
                    self.wfile.flush()
                except OSError:
                    pass

            def _json(self, code, payload, headers=None):
                data = json.dumps(payload).encode()
                self._last_code = code
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                hdrs = dict(headers or {})
                if self.trace_ctx is not None:
                    hdrs.setdefault("x-trace-id", self.trace_ctx.trace_id)
                for k, v in hdrs.items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):  # no per-request stderr
                pass

        self._httpd = self._thread = None
        self.port = None
        if self.batcher.is_leader:
            self._httpd = ThreadingHTTPServer((host, port), Handler)
            self.port = self._httpd.server_address[1]
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, name="lm-server",
                daemon=True
            )

    def readiness(self) -> dict:
        """/readyz: ready when the scheduler is alive, has served a token,
        and the replica is neither draining nor mid-export."""
        alive = self.batcher.scheduler_alive
        warmed = self.batcher.past_first_compile
        draining, migrating = self._draining, self._migrating
        return {
            "ready": alive and warmed and not draining and not migrating,
            "scheduler_alive": alive,
            "warmed": warmed,
            "draining": draining,
            "migrating": migrating,
            "replica": self.name,
            "inflight": self.batcher.inflight_requests,
            "role": self.batcher.role,
        }

    def chain_state(self) -> dict:
        """The ``GET /debug/chains`` body: identity, page size and the
        sorted hex hashes warm in the paged pool."""
        return {"replica": self.name,
                "page_size": int(self.batcher.page_size),
                "chains": self.batcher.warm_chain_hashes}

    def drain(self) -> None:
        """Report NotReady without stopping work (a front-end's drain
        hook)."""
        self._draining = True

    def undrain(self) -> None:
        self._draining = False

    def start(self) -> "LmServer":
        self.batcher.start()
        if self._thread is not None:
            self._thread.start()
        return self

    def wait(self) -> None:
        """Block until the batcher stops (a mesh's follower: until the
        leader stops)."""
        self.batcher.wait()

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=2)
        self.batcher.stop()
