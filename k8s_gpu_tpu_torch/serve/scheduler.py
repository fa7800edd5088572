"""Admission, queueing and round policy of the continuous batcher: the
port of ``k8s_gpu_tpu/serve/scheduler.py`` for paged-pool serving.

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

Not ported yet (ROADMAP queue 1): speculative rounds, the dense pool and
its prefix-entry cache, disaggregated and precomputed admission, quiesce
barriers and migration, deadlines, tenants, journal, metrics and
tracing.
"""

from __future__ import annotations

import collections
import logging
import queue
import time
from dataclasses import dataclass, field

import numpy as np
import torch

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
    emitted: int = 0
    # Steps dispatched for this row but not yet consumed: no round is
    # dispatched once emitted + inflight_steps covers every live budget.
    inflight_steps: int = 0
    # Host mirror of the row's cache position after in-flight rounds land
    # (the t_hi bucket is computed from it).
    pos_hint: int = 0
    # True when the stream ended because the batcher stopped or failed.
    aborted: bool = False
    t_submit: float = 0.0
    t_first: float = 0.0
    t_last: float = 0.0
    # Physical blocks held from admission to retirement; the first
    # prefix_tokens // page_size are shared prefix blocks.
    blocks: list = field(default_factory=list)
    prefix_tokens: int = 0


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
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=30)

    def submit(self, ids, max_new_tokens: int = 32, temperature: float = 0.0,
               top_p: float = 0.0, seed: int = 0) -> RequestHandle:
        """Queue a request; returns a handle streaming generated ids.
        Raises ValueError when the prompt cannot fit and ``Overloaded``
        when ``max_pending`` is set and the queue is full."""
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
        req = _Request(
            ids=ids,
            max_new=max(1, min(int(max_new_tokens), room)),
            temperature=float(temperature),
            top_p=float(top_p),
            seed=int(seed),
            t_submit=time.monotonic(),
        )
        with self._lifecycle:
            if self._dead:
                raise RuntimeError(
                    "batcher scheduler is stopped; restart the server"
                )
            try:
                self._pending.put_nowait(req)
            except queue.Full:
                raise Overloaded(
                    f"pending queue full ({self.max_pending} requests); "
                    "retry later"
                ) from None
        self._wake.set()
        return RequestHandle(req)

    @property
    def inflight_requests(self) -> int:
        """Queued plus admitted-and-decoding requests (benign racy read)."""
        active = sum(1 for r in self._active if r is not None)
        return self._pending.qsize() + active

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

    def _dispatch_admit(self, req: _Request, slot: int) -> tuple:
        """Block-granular paged admission (``_paged_plan`` matched the
        shared prefix and allocated the tail): a right-padded suffix
        extend through the slot's page-table row."""
        page_row = self._set_page_row(slot, req.blocks)
        s_tok = req.prefix_tokens
        n = int(req.ids.size)
        n_real = n - s_tok
        w = min(_suffix_bucket(n_real), self.engine.max_seq)
        suffix = np.zeros((1, w), np.int32)
        suffix[0, :n_real] = req.ids[s_tok:]
        req.pos_hint = n
        first, lp = self._admit_paged_dev(
            torch.from_numpy(suffix).to(self.device), n_real, slot,
            req.temperature, req.seed, s_tok, req.top_p, page_row,
        )
        req.slot = slot
        self._active[slot] = req
        self.admission_paths["paged_shared" if s_tok else "paged_cold"] += 1
        # The admission's first token is in flight: the budget gate must
        # count it (_process_admits releases it).
        req.inflight_steps = 1
        return ("admit", req, first, lp)

    def _t_hi(self, live, advance: int) -> int:
        """Attention-read bound of the next round: the live rows' largest
        position after every in-flight step lands, plus ``advance``,
        bucketed in powers of two from 256 up to max_seq."""
        need = max((r.pos_hint for _, r in live), default=0) + advance
        t = min(256, self.engine.max_seq)
        while t < need and t < self.engine.max_seq:
            t *= 2
        return min(t, self.engine.max_seq)

    def _dispatch_round(self) -> tuple | None:
        # Snapshot (slot, request): by the time this round is consumed the
        # slot may hold a new request, which must not get these tokens.
        live = [(i, r) for i, r in enumerate(self._active) if r is not None]
        rems = [r.max_new - r.emitted - r.inflight_steps for _, r in live]
        rem = max(rems, default=0)
        if rem <= 0:
            return None
        use_top_p = any(
            r is not None and 0.0 < r.top_p < 1.0 for r in self._active
        )
        solo = len(live) == 1 and self._pending.empty()
        shared_rem = min((x for x in rems if x > 0), default=rem)
        stable = self._pending.empty() and not solo and not self._overflow
        n_steps = self.steps_per_round
        if solo:
            n_steps = next((b for b in self.solo_buckets if b >= rem),
                           self.solo_buckets[-1])
        elif stable:
            n_steps = next((b for b in self.solo_buckets if b >= shared_rem),
                           self.solo_buckets[-1])
        t_hi = self._t_hi(live, n_steps)
        # The host owns the page tables; each round takes a snapshot, so a
        # retired slot reads all-trash from the next round on.
        pages = torch.from_numpy(self._pages.copy()).to(self.device)
        toks, lps = self._round_dev(use_top_p, n_steps, t_hi, pages)
        for _, r in live:
            r.inflight_steps += n_steps
            r.pos_hint += n_steps
        self._round_count += 1
        return ("round", self._round_count, live, toks, lps)

    def _emit(self, req: _Request, tok: int, lp: float = 0.0) -> None:
        req.emitted += 1
        self._warmed = True
        req.t_last = time.monotonic()
        if req.emitted == 1:
            req.t_first = req.t_last
        req.out.put((int(tok), float(lp)))

    def _retire(self, slot: int) -> None:
        req = self._active[slot]
        if req is not None:
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
        self._active[slot] = None

    def _process_admits(self, items: list) -> None:
        """Consume a run of admissions with one host fetch."""
        firsts = torch.stack(
            [torch.stack([it[2].float(), it[3].float()]) for it in items]
        ).cpu().tolist()
        for (_, req, _, _), (first, lp) in zip(items, firsts):
            req.inflight_steps = max(0, req.inflight_steps - 1)
            if self._active[req.slot] is not req:
                continue
            first = int(first)
            hit_eos = self.eos_id >= 0 and first == self.eos_id
            if not hit_eos:
                self._emit(req, first, lp)
            if hit_eos or req.emitted >= req.max_new:
                self._retire(req.slot)

    def _drain_one(self, inflight: collections.deque) -> None:
        """Consume the next in-flight item; consecutive admissions are
        fetched together."""
        item = inflight.popleft()
        if item[0] == "admit":
            batch = [item]
            while inflight and inflight[0][0] == "admit":
                batch.append(inflight.popleft())
            self._process_admits(batch)
            return
        _, _, live, toks_dev, lps_dev = item
        toks = toks_dev.cpu().numpy()                # [T, B]: one fetch
        lps = lps_dev.cpu().numpy()
        n_steps = toks.shape[0]
        for _, req in live:
            req.inflight_steps = max(0, req.inflight_steps - n_steps)
        for i, req in live:
            if self._active[i] is not req:
                continue  # retired (or the slot re-admitted) mid-flight
            done = False
            for t in range(n_steps):
                tok = int(toks[t, i])
                if self.eos_id >= 0 and tok == self.eos_id:
                    done = True
                    break
                self._emit(req, tok, float(lps[t, i]))
                if req.emitted >= req.max_new:
                    done = True
                    break
            if done:
                self._retire(i)

    def _admit_waiting(self, inflight: collections.deque) -> None:
        """Fill free slots: block-pressure deferrals first (FIFO across the
        stall), then the pending queue."""
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
            if not self._paged_plan(req):
                if not any(r is not None for r in self._active):
                    # Nothing holds blocks, so the request cannot fit.
                    req.aborted = True
                    req.out.put(None)
                    continue
                # Back at the front, holding no references; the retry
                # re-matches against the then-current cache.
                self._overflow.appendleft(req)
                return
            try:
                inflight.append(self._dispatch_admit(req, slot))
            except BaseException:
                # In neither _pending nor _active: fail it here, or its
                # caller would block forever.
                req.aborted = True
                req.out.put(None)
                raise

    def _loop(self) -> None:
        inflight: collections.deque = collections.deque()
        try:
            while not self._stop.is_set():
                any_active = any(r is not None for r in self._active)
                if (not any_active and self._pending.empty()
                        and not inflight and not self._overflow):
                    self._wake.wait(timeout=0.1)
                    self._wake.clear()
                    continue
                self._admit_waiting(inflight)
                # Keep the device busy: queue the next round before
                # fetching the previous ones.  None means every live
                # budget is covered in flight — consume instead.
                if any(r is not None for r in self._active):
                    item = self._dispatch_round()
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
            # Drain on any exit: callers must not block on .result()
            # forever, and their streams are marked aborted.
            with self._lifecycle:
                self._dead = True
                waiting = [r for r in self._active if r is not None]
                waiting += list(self._overflow)
                self._overflow.clear()
                while True:
                    try:
                        waiting.append(self._pending.get_nowait())
                    except queue.Empty:
                        break
                for r in waiting:
                    r.aborted = True
                    r.out.put(None)
