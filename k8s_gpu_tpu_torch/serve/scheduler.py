"""Admission, queueing and round policy of the continuous batcher: the
port of ``k8s_gpu_tpu/serve/scheduler.py`` for the dense and the paged
pool.

The scheduler thread admits requests into free slots (block planning in
``allocator.py``, device work in ``executor.py``), dispatches decode
rounds of ``steps_per_round`` steps over every slot, and consumes a
round's tokens only once ``pipeline_depth`` rounds are in flight: on the
card, launches are asynchronous, so the host queues the next round while
the previous one runs and blocks only when it fetches tokens.

The reference's compile buckets stay: ``t_hi`` (the attention-read
bound) grows in powers of two from 256, and round lengths come from the
``steps_per_round`` ladder.  PyTorch does not compile, but the buckets
fix what each step reads, so streams compare with the reference's under
the same rounds.

Admission paths, counted by name in ``admission_paths`` and in
``serve_admissions_total{path}``: ``cold`` (a left-padded prefill; on the
paged pool its row splices into the blocks), ``cold_fused`` (the same
with the first round in one dispatch, when the dense batcher is idle),
``prefix_exact`` and ``prefix_suffix`` (the dense pool's prefix-entry
cache, filled by ``precache_prefix``), and ``paged_cold``/``paged_shared``
(the paged pool's block-sharing suffix extend), and ``precomputed`` (a
row prefilled elsewhere, ``submit_precomputed``: the disaggregated
handover of ``disagg.py``, spliced with no forward).

Adapter rows (``adapter=``, ``aidx`` > 0) never touch the prefix planes:
cached entries and shared blocks hold base-model K/V, so an adapter row
neither looks them up nor registers its blocks, and is not counted as a
prefix hit or miss.

The fleet contract, as in the reference: a request may carry a deadline
(dropped at admission or between rounds once it passes, never computed
on), a tenant (the SLO series' label), a route stamp and the replica it
resumed from; every terminal outcome writes one journal record; and
``run_quiesced`` runs a thunk on the scheduler thread with no round in
flight, the pause that block migration exports and imports through.

Speculative rounds (``draft=``, as in the reference): a dispatch runs
``n_rounds`` sub-rounds of K draft steps (none for the n-gram draft) and
one (K+1)-wide verify.  K adapts to the measured rolling acceptance
(``_adaptive_k``), the n-gram draft must earn its dispatches against
timed plain rounds (``_spec_gate``), and the budget gate charges each
spec dispatch its expected tokens while ``pos_hint`` (and so ``t_hi``)
takes the worst case, every draft accepted: the paged kernel clamps its
reads at ``t_hi``, so an underestimate would truncate attention.  The
fused cold start is off in spec mode.

Phases and spans, as in the reference.  The scheduler thread times its
seams on the batcher's ``profiler`` as disjoint self-time phases:
``admission`` (pop to dispatch, with ``paged_plan`` and
``prefill_dispatch`` nested, and the first-token fetch),
``decode_dispatch`` (the gate, sizing and a plain round's launches, with
``spec_draft``, a spec round's launches, nested), ``decode_consume`` and
``spec_verify`` (a round's fetch and emission) and ``retire``.  A request
with a trace context (the HTTP handler's span, or ``trace_ctx=``) gets
``serve.queue_wait`` (submit to admission), ``serve.prefill`` (admission
to its first token on the host; ``fused=True`` for the fused start) and
one ``serve.round`` a round that emitted to it (dispatch to host, with
its ``tokens``; ``speculative=True`` on spec rounds), each recorded with
the request's context as explicit parent: the scheduler thread never
reads the HTTP thread's context.  Both submits fire the ``serve.submit``
fault site (``error``/``timeout`` only).

On a serving mesh (``meshed.py``) this scheduler runs on the leader
only, and every device program goes through ``_dev_call``, so each
rank runs it; the dense pool's ``precache_prefix`` then runs on the
scheduler thread (``run_quiesced``), never on the caller's, so every
rank issues its collectives in one order.
"""

from __future__ import annotations

import collections
import logging
import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils.faults import global_faults
from ..utils.tracing import global_tracer
from .engine import _empty_cache
from .meshed import HeldRow
from .journal import PROBE_TENANT, RequestRecord, golden_hash

log = logging.getLogger("k8s_gpu_tpu_torch.serve")


class Overloaded(RuntimeError):
    """Admission refused: the pending queue is at ``max_pending``.  A
    server maps it to 429 + Retry-After."""


def _suffix_bucket(n: int) -> int:
    """Width bucket of a right-padded suffix extend: smallest power of two
    >= n (floor 8)."""
    b = 8
    while b < n:
        b *= 2
    return b


def prompt_bucket(n_tokens: int, max_seq: int) -> int | None:
    """Smallest bucket >= n_tokens that still leaves decode room: powers
    of two up to max_seq/2, then 3/4·max_seq and max_seq-8.  None when
    the prompt cannot fit with at least 8 tokens of decode room."""
    candidates = []
    b = 8
    while b <= max_seq // 2:
        candidates.append(b)
        b *= 2
    candidates.append((3 * max_seq // 4) // 8 * 8)
    candidates.append(max_seq - 8)
    for c in sorted(set(candidates)):
        if c >= n_tokens and c < max_seq:
            return c
    return None


@dataclass
class _Request:
    ids: np.ndarray          # prompt token ids, unpadded
    max_new: int
    temperature: float
    top_p: float
    seed: int
    out: queue.Queue = field(default_factory=queue.Queue)
    slot: int = -1
    aidx: int = 0            # adapter bank index (0 = base model)
    cidx: int = 0            # constraint bank index (0 = unconstrained)
    # (row, last_logits, pos, rope, start): K/V computed by a prefill
    # worker (disagg.py); the admission splices them, no forward.
    precomputed: tuple | None = None
    # Called once when the precomputed row is spliced into the pool (or
    # the request ends before): the prefill pool's backpressure release.
    on_admit: object = None
    # CUDA event recorded on the submitting thread's stream after its
    # prefill: the splice's stream waits on it (None on the CPU).
    ready: object = None
    emitted: int = 0
    # Steps dispatched for this row but not yet consumed: no round is
    # dispatched once emitted + inflight_steps covers every live budget.
    inflight_steps: int = 0
    # Host mirror of the row's cache position after in-flight rounds land
    # (the t_hi bucket is computed from it).
    pos_hint: int = 0
    # True when the stream ended because the batcher stopped or failed
    # (or, with ``migrated``, because an export handed it over).
    aborted: bool = False
    # Absolute time.monotonic() deadline (None: none).  Expired work is
    # dropped at admission and between rounds, never computed on.
    deadline: float | None = None
    deadline_expired: bool = False
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    t_last: float = 0.0
    # Paged pool: physical blocks held from admission to retirement; the
    # first prefix_tokens // page_size are shared prefix blocks.  None
    # routes the admission through the dense-row splice (no sharing).
    blocks: list = field(default_factory=list)
    prefix_tokens: int | None = None
    # The request's trace context (``utils.tracing.SpanContext``): the
    # parent of its serve.* spans, its trace id the journal's.  None
    # (no spans) for a submit outside any span.
    trace_ctx: object = None
    # SLO label of the latency, shed and token series; "default" when
    # untagged.
    tenant: str = "default"
    path: str = ""           # admission path; "" when shed before it
    prompt_tokens: int = 0
    # Fleet evidence for the journal: the replica a front-end chose and
    # why; a stream cut by a migration export; the replica a resumed
    # request left.
    route_replica: str = ""
    route_reason: str = ""
    migrated: bool = False
    migrated_from: str = ""
    # Every delivered token id: the journal's golden hash.
    emitted_ids: list = field(default_factory=list)
    # Speculative evidence for the journal: proposals drafted for this
    # row and accepted by the verify.
    spec_drafted: int = 0
    spec_accepted: int = 0


class RequestHandle:
    """Caller's view of an in-flight request: iterate tokens as they
    stream; ``result()`` blocks for the full list.  Tokens are cached, so
    re-iterating replays them.  One consuming thread at a time."""

    def __init__(self, req: _Request):
        self._req = req
        self._tokens: list[int] = []
        self._lps: list[float] = []
        self._done = False

    def __iter__(self):
        yield from self._tokens
        while not self._done:
            item = self._req.out.get()
            if item is None:
                self._done = True
                return
            tok, lp = item
            self._tokens.append(tok)
            self._lps.append(lp)
            yield tok

    def result(self) -> list[int]:
        return list(self)

    @property
    def aborted(self) -> bool:
        return self._req.aborted

    @property
    def deadline_expired(self) -> bool:
        """True when the stream ended because its deadline passed (shed
        at admission or cut between rounds)."""
        return self._req.deadline_expired

    @property
    def migrated(self) -> bool:
        """True when an export handed the stream over: the truncation is
        resumable, not a failure."""
        return self._req.migrated

    @property
    def logprobs(self) -> list:
        """Per-token log-probabilities, parallel to result(); zeros unless
        the batcher collects them."""
        return list(self._lps)

    @property
    def last_logprob(self) -> float:
        return self._lps[-1] if self._lps else 0.0


class SchedulerMixin:
    """Admission/queueing/round-policy half of ``ContinuousBatcher``;
    every attribute it touches is created by ``ContinuousBatcher``."""

    # -- public surface ----------------------------------------------------
    def start(self):
        """Start the scheduler thread (a mesh's follower: its loop of
        the leader's device calls)."""
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the scheduler, which on a mesh also ends every
        follower's loop; a follower waits for that."""
        if self._seam is not None and not self._seam.is_leader:
            self.wait()
            return
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=30)

    def wait(self, timeout: float | None = None) -> None:
        """Block until the scheduler thread (a follower's loop) ends; a
        follower's loop that failed raises its error here."""
        self._thread.join(timeout=timeout)
        if self._thread_error is not None:
            raise RuntimeError("batcher thread failed") from self._thread_error

    @property
    def is_leader(self) -> bool:
        """True off a mesh and on global rank 0: the rank that takes
        requests."""
        return self._seam is None or self._seam.is_leader

    def _dev_call(self, name: str, *args, **kw):
        """Run the executor's device program ``name`` (on every rank of a
        mesh, through the seam)."""
        if self._seam is None:
            return getattr(self, name)(*args, **kw)
        return self._seam.call(name, args, kw)

    def submit(self, ids, max_new_tokens: int = 32, temperature: float = 0.0,
               top_p: float = 0.0, seed: int = 0,
               adapter: str | None = None, constraint: str | None = None,
               deadline: float | None = None, tenant: str | None = None,
               route: tuple | None = None, migrated_from: str = "",
               trace_ctx=None) -> RequestHandle:
        """Queue a request; returns a handle streaming generated ids.
        Raises ValueError when the prompt cannot fit, KeyError for an
        unknown ``adapter`` or ``constraint`` name and ``Overloaded``
        (counted and journalled as a ``queue_full`` shed) when
        ``max_pending`` is set and the queue is full.  ``deadline``: an
        absolute ``time.monotonic()`` instant past which the request is
        dropped.  ``tenant`` labels its SLO series and record (None or ""
        is ``"default"``).  ``route``: ``(replica, reason)`` from a fleet
        front-end.  ``migrated_from``: the replica a resumed request left
        (counted in ``serve_resumed_requests_total``).  ``trace_ctx``:
        the request's trace context (default: the calling thread's
        current span's, if any)."""
        # error/timeout only: this site has no clock for a "slow".
        global_faults.fire("serve.submit", error_type=RuntimeError,
                           only=("error", "timeout"))
        aidx = self.bank.index(adapter)
        cidx = self._constraint_index(constraint)
        ids = np.asarray(ids, np.int32).ravel()
        if ids.size == 0:
            raise ValueError("empty prompt")
        bucket = prompt_bucket(int(ids.size), self.engine.max_seq)
        if bucket is None:
            raise ValueError(
                f"prompt too long ({ids.size} tokens, "
                f"max {self.engine.max_seq - 8})"
            )
        room = self.engine.max_seq - bucket
        if self.role == "prefill":
            # A prefill worker's budget is the one token its admission
            # samples: the request retires at admission, no decode round
            # runs (the executor's _guard_decode enforces it).
            max_new_tokens = 1
        req = _Request(
            ids=ids,
            max_new=max(1, min(int(max_new_tokens), room)),
            temperature=float(temperature),
            top_p=float(top_p),
            seed=int(seed),
            aidx=aidx,
            cidx=cidx,
            deadline=deadline,
            t_submit=time.monotonic(),
            trace_ctx=(trace_ctx if trace_ctx is not None
                       else global_tracer.current()),
            tenant=str(tenant) if tenant else "default",
            prompt_tokens=int(ids.size),
            route_replica=str(route[0]) if route else "",
            route_reason=str(route[1]) if route else "",
            migrated_from=str(migrated_from or ""),
        )
        if req.migrated_from:
            self.metrics.inc("serve_resumed_requests_total")
        return self._enqueue(req)

    def submit_precomputed(self, row_cache, last_logits, n_tokens: int,
                           pad: int, max_new_tokens: int = 32,
                           temperature: float = 0.0, top_p: float = 0.0,
                           seed: int = 0, adapter: str | None = None,
                           on_admit=None, constraint: str | None = None,
                           tenant: str | None = None,
                           route: tuple | None = None) -> RequestHandle:
        """Admit a request whose prefill ran elsewhere (``disagg.py``):
        ``row_cache`` is a [L, 1, KH, max_seq, Dh] K/V row computed at a
        [1, n_tokens] width with ``pad`` leading pad slots, and
        ``last_logits`` [1, V] the logits at the last prompt position.
        The decode side only splices and samples (path ``precomputed``).
        Shapes are checked here, in the caller's thread (ValueError): a
        malformed row must not reach the scheduler.  ``on_admit`` runs
        once when the row is spliced or the request ends unseated.  On
        the card the splice's stream waits for the work this thread
        queued before the call (an event recorded here).  On a serving
        mesh the row is either a ``meshed.HeldRow`` at this rank's KV
        heads (every rank computed its heads of it in one seam call: a
        ``DisaggregatedLm`` on the same mesh; the admission's descriptor
        names it, so each rank splices its own) or a whole row, which the
        descriptor carries to every rank and each cuts to its heads."""
        global_faults.fire("serve.submit", error_type=RuntimeError,
                           only=("error", "timeout"))
        aidx = self.bank.index(adapter)
        cidx = self._constraint_index(constraint)
        n_tokens, pad = int(n_tokens), int(pad)
        room = self.engine.max_seq - n_tokens
        if room < 1:
            raise ValueError("precomputed prompt fills max_seq")
        cfg = self.engine.cfg
        tmpl = _empty_cache(cfg, 1, self.engine.max_seq,
                            self.engine.kv_quant, "meta",
                            self.engine.kv_heads
                            if isinstance(row_cache, HeldRow) else None)
        got_keys = set(row_cache) if isinstance(row_cache, dict) else None
        if got_keys != set(tmpl):
            raise ValueError(
                f"row_cache keys {got_keys} != {set(tmpl)} (was it "
                "prefilled by an engine with a different kv_quant "
                "setting?)"
            )
        for key, leaf in row_cache.items():
            if tuple(leaf.shape) != tuple(tmpl[key].shape):
                raise ValueError(
                    f"row_cache[{key!r}] shape {tuple(leaf.shape)} != "
                    f"{tuple(tmpl[key].shape)} (was it prefilled by an "
                    "engine with a different max_seq?)"
                )
        if tuple(last_logits.shape) != (1, cfg.vocab_size):
            raise ValueError(
                f"last_logits shape {tuple(last_logits.shape)} != "
                f"(1, {cfg.vocab_size})"
            )
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        req = _Request(
            ids=np.zeros(0, np.int32),
            max_new=max(1, min(int(max_new_tokens), room)),
            temperature=float(temperature),
            top_p=float(top_p),
            seed=int(seed),
            aidx=aidx,
            cidx=cidx,
            precomputed=(row_cache, last_logits, n_tokens, n_tokens - pad,
                         pad),
            on_admit=on_admit,
            ready=ready,
            t_submit=time.monotonic(),
            trace_ctx=global_tracer.current(),
            tenant=str(tenant) if tenant else "default",
            prompt_tokens=n_tokens,
            route_replica=str(route[0]) if route else "",
            route_reason=str(route[1]) if route else "",
        )
        return self._enqueue(req)

    def _constraint_index(self, name: str | None) -> int:
        if name is None:
            return 0
        if self.cbank is None:
            raise KeyError(
                f"unknown constraint {name!r}; no ConstraintBank configured"
            )
        return self.cbank.index(name)

    def _enqueue(self, req: _Request) -> RequestHandle:
        """Put a request on the pending queue (the tail of both submits)."""
        if not self.is_leader:
            raise RuntimeError("a follower rank takes no requests: submit "
                               "to global rank 0")
        with self._lifecycle:
            if self._dead:
                raise RuntimeError(
                    "batcher scheduler is stopped; restart the server"
                )
            try:
                self._pending.put_nowait(req)
            except queue.Full:
                self.metrics.inc("serve_shed_total", reason="queue_full",
                                 tenant=req.tenant)
                self._journal(req, "queue_full")
                raise Overloaded(
                    f"pending queue full ({self.max_pending} requests); "
                    "retry later"
                ) from None
        self._wake.set()
        return RequestHandle(req)

    def precache_prefix(self, ids) -> None:
        """Prefill ``ids`` once for reuse: a later prompt that starts with
        them computes only its suffix (``prefix_suffix``), and a prompt
        that is exactly them admits with no model forward
        (``prefix_exact``).  Dense pool: a right-padded ``extend_multi``
        over the power-of-two bucket on a fresh row, kept in an LRU of
        ``_prefix_cap`` entries.  Paged pool: a throwaway one-token
        generation, whose full prompt pages stay registered in the block
        cache (a prefix shorter than a page warms nothing).  Raises
        ValueError for an MoE model or an unusable length."""
        if self.engine.cfg.moe:
            raise ValueError(
                "prefix caching is unavailable for MoE models: "
                "capacity-capped expert dispatch makes chunked prefill "
                "diverge from the one-shot path"
            )
        ids = np.asarray(ids, np.int32).ravel()
        if ids.size == 0 or ids.size > self.engine.max_seq - 8:
            raise ValueError(f"prefix length {ids.size} unusable")
        if self.paged:
            if not self._thread.is_alive():
                raise RuntimeError(
                    "paged precache_prefix rides a throwaway generation "
                    "- start() the batcher first"
                )
            self.submit(ids, max_new_tokens=1).result()
            return
        if self._seam is None:
            # The caller's (HTTP) thread: its own autograd state.
            with torch.inference_mode():
                self._precache_dense(ids)
        else:
            self.run_quiesced(lambda: self._precache_dense(ids))

    def _precache_dense(self, ids: np.ndarray) -> None:
        """The dense pool's precache: the entry prefilled under its key
        (``_prefix_dev``), the LRU's evictions named in the same call;
        synchronised, since the scheduler reads the entry from its own
        thread and the row must have landed before it can match."""
        key = ids.tobytes()
        with self._prefix_lock:
            keep = [k for k in self._prefix if k != key]
            evict = keep[:max(0, len(keep) + 1 - self._prefix_cap)]
        self._dev_call("_prefix_dev", key, self._right_padded(ids),
                       int(ids.size), evict)
        self._sync()

    def _match_prefix(self, ids: np.ndarray):
        """Longest cached prefix of ``ids`` (LRU-touched), or None."""
        if not self.prefix_cache:
            return None
        best_key = best = None
        with self._prefix_lock:
            for key, entry in self._prefix.items():
                n = entry["n"]
                if (n <= ids.size and (best is None or n > best["n"])
                        and ids[:n].tobytes() == key):
                    best, best_key = entry, key
            if best_key is not None:
                self._prefix.move_to_end(best_key)
        return best

    # -- block migration (serve/migrate.py) --------------------------------
    def run_quiesced(self, fn, timeout_s: float = 60.0):
        """Run ``fn()`` on the scheduler thread at the next round boundary
        with no round in flight: every in-flight item consumed and, on
        the card, the stream synchronised, so ``fn`` may read and write
        the pool.  Blocks for the result; ``fn``'s exception is raised
        here and the scheduler lives on.  RuntimeError when the scheduler
        is stopped, TimeoutError when no boundary comes in ``timeout_s``
        (the thunk may still run later)."""
        box = {"done": threading.Event(), "result": None, "error": None}
        with self._lifecycle:
            if self._dead:
                raise RuntimeError(
                    "batcher scheduler is stopped; restart the server"
                )
            self._barriers.put((fn, box))
        self._wake.set()
        if not box["done"].wait(timeout_s):
            raise TimeoutError(f"scheduler did not reach a round boundary "
                               f"in {timeout_s:.1f}s")
        if box["error"] is not None:
            raise box["error"]
        return box["result"]

    def _run_barriers(self, inflight: collections.deque) -> None:
        """Scheduler thread: drain the pipeline, then run every queued
        thunk.  A thunk's exception goes to its waiter, never up here: a
        malformed import must not kill the scheduler."""
        while inflight:
            self._drain_one(inflight)
        self._sync()
        while True:
            try:
                fn, box = self._barriers.get_nowait()
            except queue.Empty:
                return
            try:
                box["result"] = fn()
            except Exception as e:
                box["error"] = e
            box["done"].set()

    @property
    def steps_taken(self) -> int:
        """Decode rounds dispatched (0 on a prefill worker)."""
        return self._round_count

    @property
    def pending_requests(self) -> int:
        """Queued, not yet admitted requests."""
        return self._pending.qsize()

    @property
    def inflight_requests(self) -> int:
        """Queued plus admitted-and-decoding requests (benign racy read)."""
        active = sum(1 for r in self._active if r is not None)
        return self._pending.qsize() + active

    @property
    def warm_chain_hashes(self) -> list[str]:
        """Sorted hex hashes of every registered block: the ``GET
        /debug/chains`` body; [] on the dense pool.  A racy read of the
        pool's registry, retried a few times and [] rather than a stall
        behind a barrier."""
        pool = getattr(self, "_pool", None)
        if pool is None:
            return []
        for _ in range(3):
            try:
                return [h.hex() for h in pool.chain_hashes()]
            except RuntimeError:
                continue
        return []

    @property
    def spec_stats(self) -> dict:
        """Measured speculative acceptance over live rows: drafted and
        accepted proposals and their rate (0.0 when spec is off or nothing
        ran); the n-gram gate's plain fall-back rounds and its evidence,
        the best per-row tokens/s of timed spec and plain rounds."""
        d, a = self._spec_drafted, self._spec_accepted
        return {
            "drafted": d, "accepted": a,
            "acceptance": (a / d) if d else 0.0,
            "fallback_rounds": self._ngram_fallback_rounds,
            "gate_spec_tps": self._mode_tps("spec"),
            "gate_plain_tps": self._mode_tps("plain"),
        }

    @property
    def scheduler_alive(self) -> bool:
        with self._lifecycle:
            dead = self._dead
        return not dead and self._thread.is_alive()

    @property
    def past_first_compile(self) -> bool:
        """True once a token was emitted: the serving path ran end to end
        (the name is the reference's; the port compiles nothing but its
        kernels, which build on first use)."""
        return self._warmed

    # -- scheduler ---------------------------------------------------------
    def _free_slot(self) -> int:
        for i, r in enumerate(self._active):
            if r is None:
                return i
        return -1

    def _hist_row(self, ids: np.ndarray, pos0: int):
        """An n-gram admission's history: the prompt at its cache
        positions [pos0 - n, pos0), -1 elsewhere; None unless the draft
        is the n-gram one."""
        if self.spec_mode != "ngram":
            return None
        h = np.full((self.engine.max_seq,), -1, np.int32)
        h[pos0 - ids.size: pos0] = ids
        return torch.from_numpy(h).to(self.device)

    def _spec_seat(self, ids: np.ndarray, pos0: int):
        """What a spec admission seats beside the row: (the last prompt
        token, ``_hist_row``); None when spec is off."""
        if self.spec_mode is None:
            return None
        return int(ids[-1]), self._hist_row(ids, pos0)

    _ENTRY_UNRESOLVED = object()

    def _dispatch_admit(self, req: _Request, slot: int,
                        entry=_ENTRY_UNRESOLVED) -> tuple:
        """Queue one admission.  ``entry``: the prefix-entry match when the
        caller already looked it up (the fused gate does); left unset, it
        is resolved here."""
        # Queue wait ends when the scheduler commits the request to a
        # slot, before the admission's device work.
        req.t_admit = time.monotonic()
        n = int(req.ids.size)
        if req.precomputed is not None:
            row, logits, pos, rope, start = req.precomputed
            req.pos_hint = pos
            page_row = (self._set_page_row(slot, req.blocks)
                        if self.paged else None)
            if req.ready is not None:
                torch.cuda.current_stream(self.device).wait_event(req.ready)
            spec = None
            if self.spec_mode is not None:
                spec = (0, self._hist_row(req.ids, pos))
            first, lp = self._dev_call(
                "_admit_exact_dev", row, logits, pos, rope, start, slot,
                req.temperature, req.seed, req.top_p, spec, aidx=req.aidx,
                cidx=req.cidx, page_row=page_row)
            # The row now lives in the pool: drop it and release the
            # prefill pool's hold.
            req.precomputed = req.ready = None
            self._release_admit(req)
            return self._seated(req, slot, first, lp, "precomputed")
        if self.paged and req.prefix_tokens is not None:
            # Block-granular paged admission (_paged_plan matched the
            # shared prefix and allocated the tail): a right-padded suffix
            # extend through the slot's page-table row.
            page_row = self._set_page_row(slot, req.blocks)
            s_tok = req.prefix_tokens
            req.pos_hint = n
            first, lp = self._dev_call(
                "_admit_paged_dev", self._right_padded(req.ids[s_tok:]),
                n - s_tok, slot, req.temperature, req.seed, s_tok,
                req.top_p, page_row,
                self._spec_seat(req.ids, n), cidx=req.cidx,
            )
            return self._seated(req, slot, first, lp,
                                "paged_shared" if s_tok else "paged_cold")
        if entry is self._ENTRY_UNRESOLVED:
            entry = self._entry_for(req)
        if entry is not None and entry["n"] == n:
            # The prompt is a cached prefix: splice + sample, no forward.
            req.pos_hint = n
            first, lp = self._dev_call(
                "_admit_entry_dev", entry, slot, req.temperature, req.seed,
                req.top_p, self._spec_seat(req.ids, n), cidx=req.cidx)
            path = "prefix_exact"
        elif entry is not None and (
            entry["n"] + _suffix_bucket(n - entry["n"])
            <= self.engine.max_seq
        ):
            p = entry["n"]
            req.pos_hint = n
            first, lp = self._dev_call(
                "_admit_prefix_dev", entry, self._right_padded(req.ids[p:]),
                n - p, slot, req.temperature, req.seed, p, req.top_p,
                self._spec_seat(req.ids, n), cidx=req.cidx,
            )
            path = "prefix_suffix"
        else:
            padded, pad = self._left_padded(req)
            req.pos_hint = padded.shape[1]
            # Paged pool: the allocation (made by _paged_plan) goes into
            # the host page table, and the prefilled row splices into it.
            page_row = (self._set_page_row(slot, req.blocks)
                        if self.paged else None)
            first, lp = self._dev_call(
                "_admit_dev", padded, slot, req.temperature, req.seed, pad,
                req.top_p, page_row, self._spec_seat(req.ids, padded.shape[1]),
                aidx=req.aidx, cidx=req.cidx,
            )
            # A matched entry whose suffix bucket overruns max_seq
            # prefills cold but counts as a prefix hit, as in the
            # reference.
            path = "prefix_suffix" if entry is not None else "cold"
        return self._seated(req, slot, first, lp, path)

    def _entry_for(self, req: _Request):
        """The dense prefix-entry match of a base-model prompt; None on
        the paged pool, for an adapter row (entries hold base-model K/V)
        and for a precomputed row."""
        if self.paged or req.aidx != 0 or req.precomputed is not None:
            return None
        return self._match_prefix(req.ids)

    def _release_admit(self, req: _Request) -> None:
        """Run a request's ``on_admit`` hook once."""
        hook, req.on_admit = req.on_admit, None
        if hook is not None:
            hook()

    def _right_padded(self, ids: np.ndarray):
        """``ids`` right-padded to their width bucket (at most max_seq),
        [1, W] on the device: the suffix extends' and precache's input."""
        w = min(_suffix_bucket(int(ids.size)), self.engine.max_seq)
        padded = np.zeros((1, w), np.int32)
        padded[0, :ids.size] = ids
        return torch.from_numpy(padded).to(self.device)

    def _left_padded(self, req: _Request):
        """The prompt left-padded to its bucket, [1, bucket] on the
        device, and the pad."""
        n = int(req.ids.size)
        bucket = prompt_bucket(n, self.engine.max_seq)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, bucket - n:] = req.ids
        return torch.from_numpy(padded).to(self.device), bucket - n

    def _dispatch_admit_round(self, req: _Request, slot: int) -> tuple:
        """The fused cold start: the admission and one normal round in
        one dispatch.  The caller guarantees the dense pool, a cold prompt
        (no prefix entry) and an idle batcher.  One round, never more: a
        request arriving a moment later must still share the next
        rounds."""
        req.t_admit = time.monotonic()
        padded, pad = self._left_padded(req)
        n_steps = self.steps_per_round
        req.pos_hint = padded.shape[1]
        t_hi = self._t_hi([(slot, req)], 1 + n_steps)
        first, lp, toks, lps = self._dev_call(
            "_admit_round_dev", padded, slot, req.temperature, req.seed, pad,
            req.top_p, 0.0 < req.top_p < 1.0, n_steps, t_hi, aidx=req.aidx,
            cidx=req.cidx,
        )
        self._seated(req, slot, first, lp, "cold_fused")
        self.dispatched["decode_steps"] += n_steps
        req.inflight_steps += n_steps
        req.pos_hint += n_steps
        self._round_count += 1
        return ("admit_round", self._round_count, req, first, lp, toks, lps,
                time.monotonic())

    def _seated(self, req: _Request, slot: int, first, lp,
                path: str) -> tuple:
        """Common tail of every admission, with the reference's series:
        admissions by path, queue wait, and one prefix-cache hit or miss
        for each admission that consulted a prefix cache."""
        req.slot = slot
        req.path = path
        self._active[slot] = req
        self.admission_paths[path] += 1
        self.metrics.observe("serve_queue_wait_seconds",
                             req.t_admit - req.t_submit)
        if req.trace_ctx is not None:
            global_tracer.add_span(
                "serve.queue_wait", parent=req.trace_ctx,
                start=req.t_submit, end=req.t_admit, slot=slot, path=path)
        # The admission's first token is in flight: the budget gate must
        # count it (_process_admits releases it).
        req.inflight_steps = 1
        self.metrics.inc("serve_admissions_total", path=path)
        # Adapter and precomputed rows route around the prefix lookup.
        consulted = req.aidx == 0 and (
            self._paged_share if self.paged else self.prefix_cache)
        if path in ("prefix_exact", "prefix_suffix", "paged_shared"):
            self.metrics.inc("serve_prefix_cache_hits_total")
        elif consulted and path in ("cold", "cold_fused", "paged_cold"):
            self.metrics.inc("serve_prefix_cache_misses_total")
        self._update_util_gauges()
        return ("admit", req, first, lp)

    def _update_util_gauges(self) -> None:
        """Live slots, on the paged pool the blocks some live row
        references (a shared block counts once; cached blocks are free),
        and the phase shares (``serve_phase_share{phase}``)."""
        live = sum(1 for r in self._active if r is not None)
        self.metrics.set_gauge("serve_slots_active", float(live))
        if self.paged:
            self.metrics.set_gauge("serve_kv_blocks_used",
                                   float(self._pool.pinned_count))
        self.profiler.export_shares()

    def _t_hi(self, live, advance: int) -> int:
        """Attention-read bound of the next round: the live rows' largest
        position after every in-flight step lands, plus ``advance``,
        bucketed in powers of two from 256 up to max_seq."""
        need = max((r.pos_hint for _, r in live), default=0) + advance
        t = min(256, self.engine.max_seq)
        while t < need and t < self.engine.max_seq:
            t *= 2
        return min(t, self.engine.max_seq)

    def _adaptive_k(self) -> int:
        """The draft window from measured rolling acceptance a: a
        sub-round emits about 1 + a(1 - a^K)/(1 - a) tokens at a cost of
        about 1 + K r target steps (r: the draft/target byte ratio); pick
        K in {2, 4, 8} maximizing their ratio.  Adapt only on >= 256
        observed proposals, switch only for a > 5 % modeled win, then
        hold for 512 proposals."""
        drafted = sum(d for d, _ in self._spec_recent)
        if drafted < 256 or self._spec_freeze > 0:
            return self._spec_k_active
        accepted = sum(a for _, a in self._spec_recent)
        a = min(0.98, max(0.02, accepted / drafted))
        r = self._draft_ratio

        def tput(k: int) -> float:
            expected = a * (1.0 - a ** k) / (1.0 - a)
            return (1.0 + expected) / (1.0 + k * r)

        best = max((2, 4, 8), key=tput)
        if (best != self._spec_k_active
                and tput(best) > 1.05 * tput(self._spec_k_active)):
            log.info("adaptive spec_k: %d -> %d (rolling acceptance %.3f)",
                     self._spec_k_active, best, a)
            self._spec_k_active = best
            self._spec_freeze = 512
            self._spec_recent.clear()
        return self._spec_k_active

    def _mode_tps(self, mode: str) -> float:
        """Best per-row rate in the mode's window of timed rounds."""
        win = self._mode_rate[mode]
        return max((t / dt for t, dt in win if dt > 0.0), default=0.0)

    def _spec_gate(self, live) -> tuple[bool, str | None]:
        """(use_spec, timed_mode) for this dispatch.  A neural draft always
        speculates (its K adapts instead).  The n-gram draft must earn
        its dispatches:

        1. when every live slot's rolling acceptance (over at least
           ``ngram_min_obs`` proposals) is below ``ngram_breakeven``, or
        2. when timed spec rounds measure slower a row than timed plain
           ones (two samples of each),

        the dispatch is a plain round.  Timed rounds of each mode run
        every ``ngram_measure_s`` seconds (the first ones at once, until
        each mode has three); while gated the spec measurement is the
        probe, backing off from ``ngram_probe_s`` to 8 times it."""
        self._gate_fallback = False
        if self.spec_mode != "ngram":
            return True, None
        below_floor = True
        for i, _ in live:
            win = self._slot_spec.get(i)
            d = sum(x for x, _ in win) if win else 0
            if d < self.ngram_min_obs:
                below_floor = False
                break
            if sum(a for _, a in win) / d >= self.ngram_breakeven:
                below_floor = False
                break
        gated = below_floor or (
            len(self._mode_rate["spec"]) >= 2
            and len(self._mode_rate["plain"]) >= 2
            and self._mode_tps("spec") < self._mode_tps("plain")
        )
        now = time.monotonic()
        timed = None
        if now >= self._ngram_next_meas["spec"]:
            timed = "spec"
            self._ngram_timed_sched["spec"] += 1
            if self._ngram_timed_sched["spec"] < 3:
                pass  # bootstrap: re-time until two real samples exist
            elif gated:
                self._ngram_probe_scale = min(self._ngram_probe_scale * 2,
                                              8)
                self._ngram_next_meas["spec"] = (
                    now + self.ngram_probe_s * self._ngram_probe_scale)
            else:
                self._ngram_probe_scale = 1
                self._ngram_next_meas["spec"] = now + self.ngram_measure_s
        elif now >= self._ngram_next_meas["plain"]:
            timed = "plain"
            self._ngram_timed_sched["plain"] += 1
            if self._ngram_timed_sched["plain"] >= 3:
                self._ngram_next_meas["plain"] = now + self.ngram_measure_s
        if not gated:
            self._ngram_probe_scale = 1
        use_spec = timed == "spec" or (not gated and timed != "plain")
        # Committed by _dispatch_round once the round really dispatches.
        self._gate_fallback = gated and not use_spec
        return use_spec, timed

    def _sync(self) -> None:
        """Wait for this thread's stream on the card (no-op on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _dispatch_round(self, inflight=None) -> tuple | None:
        # Snapshot (slot, request): by the time this round is consumed the
        # slot may hold a new request, which must not get these tokens.
        live = [(i, r) for i, r in enumerate(self._active) if r is not None]
        rems = [r.max_new - r.emitted - r.inflight_steps for _, r in live]
        rem = max(rems, default=0)
        if rem <= 0:
            return None
        # Past the budget gate a round will dispatch: the point a
        # prefill-only executor refuses.
        self._guard_decode()
        timed_mode = None
        use_spec = self.spec_mode is not None
        if use_spec:
            use_spec, timed_mode = self._spec_gate(live)
        if timed_mode is not None and inflight:
            # A timed round starts on an idle device: drain first.
            while inflight:
                self._drain_one(inflight)
            live = [(i, r) for i, r in enumerate(self._active)
                    if r is not None]
            rems = [r.max_new - r.emitted - r.inflight_steps
                    for _, r in live]
            rem = max(rems, default=0)
            if rem <= 0:
                # Never dispatched: roll its scheduling back.
                self._ngram_next_meas[timed_mode] = 0.0
                self._ngram_timed_sched[timed_mode] -= 1
                if timed_mode == "spec":
                    self._ngram_probe_scale = max(
                        1, self._ngram_probe_scale // 2)
                return None
        if self._gate_fallback:
            self._ngram_fallback_rounds += 1
            self.metrics.inc("serve_spec_fallback_rounds_total")
        t0 = time.monotonic()
        use_top_p = any(
            r is not None and 0.0 < r.top_p < 1.0 for r in self._active
        )
        solo = len(live) == 1 and self._pending.empty()
        shared_rem = min((x for x in rems if x > 0), default=rem)
        stable = self._pending.empty() and not solo and not self._overflow
        # The host owns the page tables; each round takes a snapshot, so a
        # retired slot reads all-trash from the next round on.
        pages = (torch.from_numpy(self._pages.copy()).to(self.device)
                 if self.paged else None)
        if use_spec:
            return self._dispatch_spec(live, rem, shared_rem, solo, stable,
                                       use_top_p, timed_mode, pages, t0)
        n_steps = self.steps_per_round
        if timed_mode == "plain":
            pass  # timed rounds keep the base length
        elif solo:
            n_steps = next((b for b in self.solo_buckets if b >= rem),
                           self.solo_buckets[-1])
        elif stable:
            n_steps = next((b for b in self.solo_buckets if b >= shared_rem),
                           self.solo_buckets[-1])
        t_hi = self._t_hi(live, n_steps)
        toks, lps = self._dev_call("_round_dev", use_top_p, n_steps, t_hi,
                                   pages)
        self.dispatched["decode_steps"] += n_steps
        if self.paged and self.engine.attn_impl == "paged_kernel":
            self.metrics.inc("serve_paged_kernel_rounds_total")
        for _, r in live:
            r.inflight_steps += n_steps
            r.pos_hint += n_steps
        timed_dt = None
        if timed_mode == "plain":
            self._sync()
            timed_dt = time.monotonic() - t0
        self._round_count += 1
        return ("round", self._round_count, live, toks, lps, t0, timed_dt)

    def _dispatch_spec(self, live, rem, shared_rem, solo, stable, use_top_p,
                       timed_mode, pages, t0) -> tuple:
        """The spec branch of ``_dispatch_round``: K from measured
        acceptance, sub-rounds sized for compute parity with a plain
        round (a neural sub-round costs about 1 + K r target steps),
        multiplied to cover the remaining budget when solo or stable."""
        K = self._adaptive_k()
        if self.spec_mode == "ngram":
            base_rounds = self.steps_per_round
        else:
            base_rounds = max(1, int(round(
                self.steps_per_round / (1.0 + K * self._draft_ratio))))
        n_rounds = base_rounds
        if timed_mode != "spec" and (solo or stable):
            per = base_rounds * (K + 1)
            cover = rem if solo else shared_rem
            mult = next((m for m in (1, 2, 4) if m * per >= cover), 4)
            n_rounds = mult * base_rounds
        advance = n_rounds * (K + 1)
        t_hi = self._t_hi(live, advance)
        # The spec round's launches: nested in decode_dispatch, whose
        # self time keeps the gate and the sizing.
        with self.profiler.phase("spec_draft"):
            toks, ns, lps = self._dev_call(
                "_round_spec_ngram_dev" if self.spec_mode == "ngram"
                else "_round_spec_dev", use_top_p, n_rounds, t_hi, K, pages)
        self.dispatched["verify_subrounds"] += n_rounds
        if self.paged and self.engine.attn_impl == "paged_kernel":
            self.metrics.inc("serve_paged_kernel_rounds_total")
        # The budget gate is charged the expected tokens from rolling
        # acceptance (a worst-case charge would stall the device between
        # dispatches); pos_hint takes the worst case, since it sizes t_hi.
        drafted = sum(d for d, _ in self._spec_recent)
        a_hat = (sum(a for _, a in self._spec_recent) / drafted
                 if drafted >= 64 else 0.5)
        expected = max(n_rounds, int(n_rounds * (1.0 + a_hat * K)))
        for _, r in live:
            r.inflight_steps += expected
            r.pos_hint += advance
        timed_dt = None
        if timed_mode == "spec":
            self._sync()
            timed_dt = time.monotonic() - t0
        self._round_count += 1
        return ("spec", self._round_count, live, toks, ns, lps, expected,
                t0, timed_dt)

    def _emit(self, req: _Request, tok: int, lp: float = 0.0) -> None:
        req.emitted += 1
        self._warmed = True
        req.t_last = time.monotonic()
        if req.emitted == 1:
            req.t_first = req.t_last
        req.emitted_ids.append(int(tok))
        req.out.put((int(tok), float(lp)))

    def _retire(self, slot: int) -> None:
        with self.profiler.phase("retire"):
            self._retire_row(slot)

    def _retire_row(self, slot: int) -> None:
        req = self._active[slot]
        if req is not None:
            self._account(req)
            # Journal before the stream closes: a caller that has its
            # result finds its record.
            self._journal(req, self._finish_reason(req))
            req.out.put(None)
            if req.blocks:
                # Point the slot at the trash block and drop its block
                # references: a shared block stays pinned while another
                # slot holds it; a registered block at refcount 0 parks
                # in the LRU.  Rounds already queued carry their own
                # table snapshot and run before any later admission that
                # could reuse these blocks (one stream, in order).
                self._pages[slot, :] = 0
                for blk in req.blocks:
                    self._pool.release(blk)
                req.blocks = []
        self._slot_spec.pop(slot, None)
        self._active[slot] = None
        self._update_util_gauges()

    def _account(self, req: _Request) -> None:
        """The reference's retirement series.  An expired row is a shed,
        not a completion; canary probes (the reserved tenant) stay out of
        the latency and tenant-token series.  Each latency lands twice,
        unlabelled and tenant-labelled; a tenant's token counters are
        minted even at 0."""
        probe = req.tenant == PROBE_TENANT
        if not req.deadline_expired:
            self.metrics.inc("serve_completions_total")
            self.metrics.observe("serve_generated_tokens",
                                 float(req.emitted))
            if req.emitted >= 1 and req.t_first > 0.0 and not probe:
                ttft = req.t_first - req.t_submit
                self.metrics.observe("serve_ttft_seconds", ttft)
                self.metrics.observe("serve_ttft_seconds", ttft,
                                     tenant=req.tenant)
            if req.emitted >= 2 and req.t_first > 0.0 and not probe:
                gap = (req.t_last - req.t_first) / (req.emitted - 1)
                self.metrics.observe("serve_inter_token_seconds", gap)
                self.metrics.observe("serve_inter_token_seconds", gap,
                                     tenant=req.tenant)
        if not probe:
            good = (req.emitted if not (req.deadline_expired or req.aborted)
                    else 0)
            self.metrics.inc("serve_tenant_tokens_total", float(req.emitted),
                             tenant=req.tenant)
            self.metrics.inc("serve_tenant_goodput_tokens_total",
                             float(good), tenant=req.tenant)

    @staticmethod
    def _finish_reason(req: _Request) -> str:
        """deadline beats aborted beats budget; a row retired early with
        budget left stopped on EOS."""
        if req.deadline_expired:
            return "deadline"
        if req.aborted:
            return "aborted"
        if req.emitted >= req.max_new:
            return "budget"
        return "eos"

    def _journal(self, req: _Request, reason: str) -> None:
        """One record per terminal outcome, with the reference's fields
        (the replay tuple, the latency story, the fleet evidence)."""
        self.journal.append(RequestRecord(
            tenant=req.tenant,
            trace_id=(req.trace_ctx.trace_id if req.trace_ctx is not None
                      else ""),
            reason=reason,
            path=req.path,
            prompt_ids=[int(t) for t in req.ids.tolist()],
            max_new=req.max_new,
            temperature=req.temperature,
            top_p=req.top_p,
            seed=req.seed,
            deadline_s=(req.deadline - req.t_submit
                        if req.deadline is not None else 0.0),
            golden_hash=golden_hash(req.emitted_ids),
            replica=req.route_replica,
            route_reason=req.route_reason,
            slot=req.slot,
            prompt_tokens=req.prompt_tokens,
            tokens=req.emitted,
            queue_wait_s=(max(0.0, req.t_admit - req.t_submit)
                          if req.t_admit > 0.0 else 0.0),
            ttft_s=(max(0.0, req.t_first - req.t_submit)
                    if req.t_first > 0.0 else 0.0),
            tpot_s=((req.t_last - req.t_first) / (req.emitted - 1)
                    if req.emitted >= 2 and req.t_first > 0.0 else 0.0),
            prefix_blocks=((req.prefix_tokens or 0) // self.page_size
                           if self.paged else 0),
            spec_drafted=req.spec_drafted,
            spec_accepted=req.spec_accepted,
            deadline_expired=req.deadline_expired,
            t_submit=req.t_submit,
            t_done=time.monotonic(),
            extra={
                **({"probe": True} if req.tenant == PROBE_TENANT else {}),
                **({"migrated": True} if req.migrated else {}),
                **({"migrated_from": req.migrated_from}
                   if req.migrated_from else {}),
            },
        ))

    def _abort(self, req: _Request, reason: str = "aborted") -> None:
        """End a request that holds no slot: journalled, stream closed,
        its ``on_admit`` hook run (a precomputed row is never seated; on
        a live mesh every follower lets its heads of the row go)."""
        self._release_admit(req)
        if (req.precomputed is not None and self._seam is not None
                and not self._seam.closed):
            self._dev_call("_drop_held_dev", req.precomputed[0])
        req.precomputed = req.ready = None
        req.aborted = True
        self._journal(req, reason)
        req.out.put(None)

    def _expired(self, req: _Request) -> bool:
        """True once the request's deadline passed, marked and counted as
        a deadline shed."""
        if req.deadline is None or time.monotonic() <= req.deadline:
            return False
        req.deadline_expired = True
        self.metrics.inc("serve_shed_total", reason="deadline",
                         tenant=req.tenant)
        return True

    def _expire_live(self, slot: int, req: _Request) -> bool:
        """Between rounds: retire a row whose deadline passed before its
        fetched tokens are emitted."""
        if not self._expired(req):
            return False
        req.aborted = True
        self._retire(slot)
        return True

    def _process_admits(self, items: list) -> None:
        """Consume a run of admissions with one host fetch."""
        firsts = torch.stack(
            [torch.stack([it[2].float(), it[3].float()]) for it in items]
        ).cpu().tolist()
        for (_, req, _, _), (first, lp) in zip(items, firsts):
            req.inflight_steps = max(0, req.inflight_steps - 1)
            if req.trace_ctx is not None:
                # Admission dispatch to the first token on the host.
                global_tracer.add_span(
                    "serve.prefill", parent=req.trace_ctx,
                    start=req.t_admit, end=time.monotonic(), slot=req.slot)
            if self._active[req.slot] is not req:
                continue
            if self._expire_live(req.slot, req):
                continue
            first = int(first)
            hit_eos = self.eos_id >= 0 and first == self.eos_id
            if not hit_eos:
                self._emit(req, first, lp)
            if hit_eos or req.emitted >= req.max_new:
                self._retire(req.slot)

    def _process_admit_round(self, item: tuple) -> None:
        """Consume a fused cold start: the admission's token, then the
        round's tokens of its slot."""
        _, round_id, req, first_dev, lp_dev, toks_dev, lps_dev, t_disp = item
        toks = toks_dev.cpu().numpy()                # [T, B]
        lps = lps_dev.cpu().numpy()
        first, lp = torch.stack([first_dev.float(), lp_dev.float()]).tolist()
        req.inflight_steps = max(0, req.inflight_steps - 1 - toks.shape[0])
        if req.trace_ctx is not None:
            # One dispatch ran the prefill and the first round.
            global_tracer.add_span(
                "serve.prefill", parent=req.trace_ctx, start=req.t_admit,
                end=time.monotonic(), slot=req.slot, fused=True)
        if self._active[req.slot] is not req:
            return
        if self._expire_live(req.slot, req):
            return
        first = int(first)
        if self.eos_id >= 0 and first == self.eos_id:
            self._retire(req.slot)
            return
        self._emit(req, first, lp)
        n0 = req.emitted
        done = (req.emitted >= req.max_new
                or self._emit_round(req, req.slot, toks, lps))
        self._round_span(req, t_disp, round_id, n0)
        if done:
            self._retire(req.slot)

    def _emit_round(self, req: _Request, slot: int, toks, lps) -> bool:
        """Emit one row's tokens of a round; True once the request is done
        (EOS or its budget)."""
        for t in range(toks.shape[0]):
            tok = int(toks[t, slot])
            if self.eos_id >= 0 and tok == self.eos_id:
                return True
            self._emit(req, tok, float(lps[t, slot]))
            if req.emitted >= req.max_new:
                return True
        return False

    def _round_span(self, req: _Request, t_disp: float, round_id: int,
                    n0: int, **attrs) -> None:
        """One ``serve.round`` span a (round, traced request) that emitted
        to it: dispatch to host, with the tokens it delivered."""
        if req.trace_ctx is not None and req.emitted > n0:
            global_tracer.add_span(
                "serve.round", parent=req.trace_ctx, start=t_disp,
                end=time.monotonic(), round=round_id,
                tokens=req.emitted - n0, **attrs)

    def _drain_one(self, inflight: collections.deque) -> None:
        """Consume the next in-flight item, in its phase: an admission's
        first-token fetch completes ``admission`` (consecutive admissions
        are fetched together), a spec round's fetch and walk is
        ``spec_verify``, a plain round's ``decode_consume`` (``retire``
        nests inside and subtracts)."""
        item = inflight.popleft()
        if item[0] == "admit":
            batch = [item]
            while inflight and inflight[0][0] == "admit":
                batch.append(inflight.popleft())
            with self.profiler.phase("admission"):
                self._process_admits(batch)
        elif item[0] == "admit_round":
            with self.profiler.phase("admission"):
                self._process_admit_round(item)
        elif item[0] == "spec":
            with self.profiler.phase("spec_verify"):
                self._process_spec(item)
        else:
            with self.profiler.phase("decode_consume"):
                self._process_round(item)
        self._update_util_gauges()

    def _process_round(self, item: tuple) -> None:
        """Consume a plain round: one fetch, each live row's tokens up to
        EOS or its budget."""
        _, round_id, live, toks_dev, lps_dev, t_disp, timed_dt = item
        toks = toks_dev.cpu().numpy()                # [T, B]: one fetch
        lps = lps_dev.cpu().numpy()
        n_steps = toks.shape[0]
        for _, req in live:
            req.inflight_steps = max(0, req.inflight_steps - n_steps)
        e0 = {i: r.emitted for i, r in live}
        for i, req in live:
            if self._active[i] is not req:
                continue  # retired (or the slot re-admitted) mid-flight
            if self._expire_live(i, req):
                continue
            n0 = req.emitted
            done = self._emit_round(req, i, toks, lps)
            self._round_span(req, t_disp, round_id, n0)
            if done:
                self._retire(i)
        if timed_dt is not None:
            self._record_timed("plain", live, e0, timed_dt)

    def _record_timed(self, mode: str, live, e0: dict, dt: float) -> None:
        """A timed round's evidence for the n-gram gate: tokens a row that
        emitted, over the round's wall time.  A mode's first timed round
        is warm-up and is skipped."""
        self._ngram_timed_rec[mode] += 1
        deltas = [r.emitted - e0[i] for i, r in live]
        rows = sum(1 for d in deltas if d > 0)
        if rows and self._ngram_timed_rec[mode] > 1:
            self._mode_rate[mode].append((sum(deltas) / rows, dt))

    def _process_spec(self, item: tuple) -> None:
        """Consume a spec dispatch: release the expected-token charge,
        walk ``pos_hint`` back from the worst case to the real advance,
        emit each row's accepted windows up to EOS or its budget, and
        count drafted and accepted proposals (rows retired mid-flight
        count nothing: their garbage sub-rounds must not steer K)."""
        (_, round_id, live, toks_dev, ns_dev, lps_dev, charged, t_disp,
         timed_dt) = item
        toks = toks_dev.cpu().numpy()                # [R, B, K+1]
        ns = ns_dev.cpu().numpy()                    # [R, B]
        lps = lps_dev.cpu().numpy()
        k_used = toks.shape[2] - 1
        worst = toks.shape[0] * (k_used + 1)
        for i, req in live:
            req.inflight_steps = max(0, req.inflight_steps - charged)
            req.pos_hint -= worst - int(ns[:, i].sum())
        d0, a0 = self._spec_drafted, self._spec_accepted
        e0 = {i: r.emitted for i, r in live}
        for i, req in live:
            if self._active[i] is not req:
                continue
            if self._expire_live(i, req):
                continue
            done = False
            n0 = req.emitted
            row_d = row_a = 0
            for r in range(toks.shape[0]):
                n = int(ns[r, i])
                self._spec_drafted += k_used
                self._spec_accepted += n - 1
                row_d += k_used
                row_a += n - 1
                for t in range(n):
                    tok = int(toks[r, i, t])
                    if self.eos_id >= 0 and tok == self.eos_id:
                        done = True
                        break
                    self._emit(req, tok, float(lps[r, i, t]))
                    if req.emitted >= req.max_new:
                        done = True
                        break
                if done:
                    break
            if row_d:
                self._slot_spec.setdefault(
                    i, collections.deque(maxlen=8)).append((row_d, row_a))
                req.spec_drafted += row_d
                req.spec_accepted += row_a
            self._round_span(req, t_disp, round_id, n0, speculative=True)
            if done:
                self._retire(i)
        drafted_now = self._spec_drafted - d0
        self._spec_recent.append((drafted_now, self._spec_accepted - a0))
        self._spec_freeze = max(0, self._spec_freeze - drafted_now)
        if timed_dt is not None:
            self._record_timed("spec", live, e0, timed_dt)

    def _admit_waiting(self, inflight: collections.deque) -> None:
        """Fill free slots: block-pressure deferrals first (FIFO across the
        stall), then the pending queue; each admission in the
        ``admission`` phase, pop to dispatch."""
        while True:
            slot = self._free_slot()
            if slot < 0:
                return
            if self._overflow:
                req = self._overflow.popleft()
            else:
                try:
                    req = self._pending.get_nowait()
                except queue.Empty:
                    return
            with self.profiler.phase("admission"):
                if not self._admit_one(req, slot, inflight):
                    return

    def _admit_one(self, req: _Request, slot: int,
                   inflight: collections.deque) -> bool:
        """Admit one popped request into ``slot``, or shed or defer it;
        False when it was deferred for blocks (admission stops)."""
        # Deadline gate before any allocation or device work.
        if self._expired(req):
            self._abort(req, "deadline")
            return True
        if self.paged:
            with self.profiler.phase("paged_plan"):
                planned = self._paged_plan(req)
            if not planned:
                if not any(r is not None for r in self._active):
                    # Nothing holds blocks, so the request cannot fit.
                    self._abort(req, "no_capacity")
                    return True
                # Back at the front, holding no references; the retry
                # re-matches against the then-current cache.
                self._overflow.appendleft(req)
                return False
        try:
            # An idle dense batcher fuses a cold admission with its first
            # round.  The prefix lookup runs once and feeds both the gate
            # and the unfused admission.
            entry = self._entry_for(req)
            fused = (
                self.spec_mode is None and req.precomputed is None
                and not self.paged and entry is None and not inflight
                and self.role != "prefill"
                and req.max_new > 1 and self._pending.empty()
                and not any(r is not None for r in self._active)
            )
            with self.profiler.phase("prefill_dispatch"):
                inflight.append(
                    self._dispatch_admit_round(req, slot) if fused
                    else self._dispatch_admit(req, slot, entry))
        except BaseException:
            # In neither _pending nor _active: fail it here, or its
            # caller would block forever.
            self._abort(req)
            raise
        return True

    def _loop(self) -> None:
        inflight: collections.deque = collections.deque()
        try:
            while not self._stop.is_set():
                # Quiesce point (run_quiesced), checked first: barriers
                # run with the pipeline drained.
                if not self._barriers.empty():
                    self._run_barriers(inflight)
                any_active = any(r is not None for r in self._active)
                if (not any_active and self._pending.empty()
                        and not inflight and not self._overflow):
                    # Idle: the shares keep ageing out of the window.
                    self._update_util_gauges()
                    self._wake.wait(timeout=0.1)
                    self._wake.clear()
                    continue
                self._admit_waiting(inflight)
                # Keep the device busy: queue the next round before
                # fetching the previous ones.  None means every live
                # budget is covered in flight — consume instead.  A
                # pending barrier pauses new rounds, so a migration abort
                # finds the stream still live.
                if (any(r is not None for r in self._active)
                        and self._barriers.empty()):
                    with self.profiler.phase("decode_dispatch"):
                        item = self._dispatch_round(inflight)
                    if item is not None:
                        inflight.append(item)
                    elif inflight:
                        self._drain_one(inflight)
                while inflight and (
                    len(inflight) > self.pipeline_depth
                    or not any(r is not None for r in self._active)
                ):
                    self._drain_one(inflight)
        except Exception:
            log.exception("batcher scheduler died; draining requests")
        finally:
            if self._seam is not None:
                # End every follower's loop (the last call on this rank's
                # collectives).
                try:
                    self._seam.close()
                except Exception:
                    log.exception("could not end the followers' loops")
            # Drain on any exit: callers must not block on .result()
            # forever, and their streams are marked aborted.
            with self._lifecycle:
                self._dead = True
                # Fail queued barriers under the lock that sets _dead:
                # run_quiesced either queued before this (failed here) or
                # sees _dead and raises.
                while True:
                    try:
                        _, box = self._barriers.get_nowait()
                    except queue.Empty:
                        break
                    box["error"] = RuntimeError("batcher scheduler stopped")
                    box["done"].set()
                waiting = [r for r in self._active if r is not None]
                waiting += list(self._overflow)
                self._overflow.clear()
                while True:
                    try:
                        waiting.append(self._pending.get_nowait())
                    except queue.Empty:
                        break
                for r in waiting:
                    self._abort(r)
