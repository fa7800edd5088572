"""Disaggregated prefill/decode serving in one process: the port of
``k8s_gpu_tpu/serve/disagg.py``.

Prefill is one wide burst of products; decode is a trickle a token at a
time.  Served together, a long prompt's prefill stalls every in-flight
decode for its whole length.  ``DisaggregatedLm`` runs prefills on its
own worker threads with its own ``InferenceEngine`` and hands each
finished K/V row to the decode batcher (``submit_precomputed``), whose
admission is then a splice and a sample: the decode side never runs a
prompt-wide forward.

Three prefill forms, as in the reference:

- ``chunk_tokens`` > 0: the prompt runs as ceil(n / C) extends of width
  C on the request's own row, so the decode rounds interleave between
  chunks (bounded stalls instead of one prompt-long stall);
- a paged decode side: one right-padded extend over the power-of-two
  bucket (exact geometry: pos = n, no left pad), so the row splices into
  page-aligned blocks;
- a dense decode side: the left-padded prefill over the prompt's bucket.

An MoE model always takes the last form, whatever ``chunk_tokens`` and
the decode side: capped expert dispatch couples every token of a
prefill, so only the batcher's own whole-prompt prefill drops the same
tokens.

Greedy streams equal the batcher's own (the same computation, run
elsewhere); adapters ride through (the pool prefills with the batcher's
bank); ``stop`` drains.  On the card the workers queue their work on the
device's current stream, and ``submit_precomputed`` records an event
after it that the splice waits on, so a row is never read before its
writes have landed.  Each row waiting for a slot pins a [L, 1, KH,
max_seq, Dh] row of device memory; ``inflight_cap`` bounds them.

On a serving mesh (the batcher's ``mesh``) every rank builds the pool,
before the batcher starts, and its engine runs on the same mesh: every
rank prefills its heads.  The workers run on the leader only, and each
prefill is a seam call (``meshed.Seam``, target ``"pool"``), so it
takes its turn with the scheduler's device calls and every rank issues
its collectives in one order.  The row stays on each rank, its heads
only, as a ``meshed.HeldRow`` that the handover's admission names by
key (a handover that raises names it in a drop, so no rank keeps it).
On the dense pool every dp group prefills the row: whichever group
owns the slot it lands in splices it, and the prefill's expert capacity
is the one row's, as the reference's.  ``stop`` on the leader drains
the workers; the batcher's stop then ends every rank's loop.
"""

from __future__ import annotations

import itertools
import queue
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from .batcher import ContinuousBatcher, RequestHandle, prompt_bucket
from .engine import InferenceEngine
from .meshed import HeldRow
from .scheduler import _suffix_bucket


@dataclass
class _PrefillJob:
    ids: np.ndarray
    max_new: int
    temperature: float
    top_p: float
    seed: int
    adapter: str | None
    # The worker's answer: the decode side's handle, or the exception.
    done: queue.Queue = field(default_factory=queue.Queue)


class DisaggregatedLm:
    """Prefill workers in front of a decode batcher.  ``submit`` returns
    the batcher's own ``RequestHandle``: callers see no difference,
    except that a long prompt no longer blocks everyone's decode."""

    def __init__(self, model, params, *, batcher: ContinuousBatcher,
                 prefill_workers: int = 1, inflight_cap: int | None = None,
                 chunk_tokens: int = 0):
        """``inflight_cap`` bounds rows prefilled but not yet seated
        (default: the batcher's slot count, so prefill runs at most one
        generation of slots ahead); ``on_admit`` releases each.
        ``chunk_tokens`` > 0 (a multiple of 8): chunked prefill."""
        self.batcher = batcher
        self.params = params
        self.chunk_tokens = int(chunk_tokens)
        if self.chunk_tokens < 0 or (
            self.chunk_tokens and self.chunk_tokens % 8 != 0
        ):
            raise ValueError(
                "chunk_tokens must be a non-negative multiple of 8"
            )
        self.inflight_cap = (int(inflight_cap) if inflight_cap is not None
                             else batcher.slots)
        self._inflight = threading.Semaphore(self.inflight_cap)
        # Rows held now, and the most ever held (the cap's evidence).
        self._held = 0
        self.max_inflight = 0
        self._held_lock = threading.Lock()
        # The pool's own engine on the batcher's device and mesh; kv_quant
        # follows the decode side so the row splices leaf for leaf.
        self.engine = InferenceEngine(
            model, max_seq=batcher.engine.max_seq,
            kv_quant=batcher.engine.kv_quant, mesh=batcher.mesh,
            device=batcher.device,
        )
        self.device = batcher.device
        self._seam = batcher._seam
        self._keys = itertools.count(1)
        if self._seam is not None:
            if batcher._thread.is_alive():
                raise RuntimeError(
                    "on a serving mesh build the DisaggregatedLm on every "
                    "rank before the batcher starts")
            self._seam.attach("pool", self)
        self._jobs: queue.Queue = queue.Queue()
        self._dead = False
        self._lifecycle = threading.Lock()
        self._threads = [
            threading.Thread(target=self._worker, name=f"prefill-{i}",
                             daemon=True)
            for i in range(max(1, prefill_workers))
        ]

    def start(self) -> "DisaggregatedLm":
        """Start the workers (on a mesh the leader's only: the other
        ranks run the pool's prefills in the batcher's loop)."""
        if self.batcher.is_leader:
            for t in self._threads:
                t.start()
        return self

    def stop(self) -> None:
        with self._lifecycle:
            self._dead = True
        for _ in self._threads:
            self._jobs.put(None)
        for t in self._threads:
            if t.is_alive():
                t.join(timeout=10)

    def submit(self, ids, max_new_tokens: int = 32, temperature: float = 0.0,
               top_p: float = 0.0, seed: int = 0,
               adapter: str | None = None) -> RequestHandle:
        """Queue a request: prefill on the pool, decode on the batcher.
        Blocks until the row is handed over; raises as
        ``ContinuousBatcher.submit`` does."""
        self.batcher.bank.index(adapter)  # unknown names fail here
        ids = np.asarray(ids, np.int32).ravel()
        if ids.size == 0:
            raise ValueError("empty prompt")
        if prompt_bucket(int(ids.size), self.engine.max_seq) is None:
            raise ValueError(
                f"prompt too long ({ids.size} tokens, "
                f"max {self.engine.max_seq - 8})"
            )
        job = _PrefillJob(ids, int(max_new_tokens), float(temperature),
                          float(top_p), int(seed), adapter)
        with self._lifecycle:
            if self._dead:
                raise RuntimeError("prefill pool is stopped")
            self._jobs.put(job)
        out = job.done.get()
        if isinstance(out, Exception):
            raise out
        return out

    @property
    def inflight(self) -> int:
        """Rows prefilled (or prefilling) and not yet seated."""
        with self._held_lock:
            return self._held

    def _acquire(self) -> None:
        self._inflight.acquire()
        with self._held_lock:
            self._held += 1
            self.max_inflight = max(self.max_inflight, self._held)

    def _release(self) -> None:
        with self._held_lock:
            self._held -= 1
        self._inflight.release()

    def _bank(self, aidx: int) -> dict:
        bank = self.batcher.bank
        if bank.banked is None:
            return {}
        return {"adapters": bank.banked,
                "adapter_idx": torch.full((1,), aidx, dtype=torch.int32,
                                          device=self.device)}

    def _row(self):
        return self.engine.empty_cache(1)

    def _zero(self):
        return torch.zeros(1, dtype=torch.int32, device=self.device)

    def _prefill_chunked(self, ids, aidx: int):
        """ceil(n / C) width-C extends on a fresh row; the last chunk is
        right-padded (its pad lands above the live length).  Returns
        (row, last_logits [1, V]) with exact geometry (pos = n)."""
        C = self.chunk_tokens
        row, logits = self._row(), None
        for i in range(0, int(ids.size), C):
            chunk = ids[i:i + C]
            arr = np.zeros((1, C), np.int32)
            arr[0, :chunk.size] = chunk
            at = torch.full((1,), i, dtype=torch.int32, device=self.device)
            _, lg = self.engine.extend_multi(
                self.params, row, torch.from_numpy(arr).to(self.device),
                at, at, self._zero(), **self._bank(aidx))
            logits = lg[:, chunk.size - 1]
        return row, logits

    def _prefill_exact(self, ids, aidx: int):
        """One right-padded extend over the power-of-two bucket on a fresh
        row: exact geometry (pos = n, no left pad), so a paged decode
        side splices page-aligned blocks."""
        n = int(ids.size)
        w = min(_suffix_bucket(n), self.engine.max_seq)
        arr = np.zeros((1, w), np.int32)
        arr[0, :n] = ids
        row = self._row()
        _, lg = self.engine.extend_multi(
            self.params, row, torch.from_numpy(arr).to(self.device),
            self._zero(), self._zero(), self._zero(), **self._bank(aidx))
        return row, lg[:, n - 1]

    def _prefill_left(self, ids, aidx: int):
        """The dense decode side's form: the left-padded prefill over the
        prompt's bucket.  Returns (row, logits, n_tokens, pad)."""
        n = int(ids.size)
        bucket = prompt_bucket(n, self.engine.max_seq)
        arr = np.zeros((1, bucket), np.int32)
        arr[0, bucket - n:] = ids
        row, logits = self.engine.prefill(
            self.params, torch.from_numpy(arr).to(self.device), bucket - n,
            **self._bank(aidx))
        return row, logits, bucket, bucket - n

    def _worker(self) -> None:
        # Autograd state is per thread: the workers need their own.
        with torch.inference_mode():
            self._serve_jobs()

    def _prefill(self, ids, aidx: int):
        """The prefill form the decode side takes (module docstring) ->
        (row, last_logits [1, V], n_tokens, pad)."""
        n = int(ids.size)
        moe = self.engine.cfg.moe   # whole prompts only
        if self.chunk_tokens and not moe:
            return (*self._prefill_chunked(ids, aidx), n, 0)
        if self.batcher.paged and not moe:
            return (*self._prefill_exact(ids, aidx), n, 0)
        return self._prefill_left(ids, aidx)

    def _prefill_dev(self, key: int, ids, aidx: int):
        """A meshed prefill on every rank: each keeps its heads of the
        row under ``key`` (the leader's comes back as a ``HeldRow``)."""
        row, *rest = self._prefill(ids, aidx)
        if not self._seam.is_leader:
            self._seam.held[key] = row
        return (HeldRow(row, key), *rest)

    def _drop_held(self, row: HeldRow) -> None:
        """A held row that no admission will name (the handover raised:
        a full queue, a stopped batcher, a malformed row): every follower
        lets its heads of it go, or they would stay on the card for
        good."""
        if not self._seam.closed:
            self._seam.call("_drop_held_dev", (row,), {})

    def _serve_jobs(self) -> None:
        bank = self.batcher.bank
        while True:
            job = self._jobs.get()
            if job is None:
                return
            try:
                # Backpressure before the prefill: no compute (and no
                # pinned row) for a row no decode slot can take yet.
                self._acquire()
                released, row = False, None
                try:
                    aidx = bank.index(job.adapter)
                    if self._seam is None:
                        row, logits, n_tokens, pad = self._prefill(job.ids,
                                                                   aidx)
                    else:
                        row, logits, n_tokens, pad = self._seam.call(
                            "pool._prefill_dev",
                            (next(self._keys), job.ids, aidx), {})
                    handle = self.batcher.submit_precomputed(
                        row, logits, n_tokens, pad,
                        max_new_tokens=job.max_new,
                        temperature=job.temperature, top_p=job.top_p,
                        seed=job.seed, adapter=job.adapter,
                        on_admit=self._release,
                    )
                    released = True  # the on_admit hook owns the release
                    job.done.put(handle)
                finally:
                    if not released:
                        self._release()
                        if isinstance(row, HeldRow):
                            self._drop_held(row)
            except Exception as e:  # to the submitter; keep serving
                job.done.put(e)
