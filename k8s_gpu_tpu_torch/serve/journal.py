"""Per-request serving journal: the port's own copy of
``k8s_gpu_tpu/serve/journal.py``.

One compact record per request the batcher finished with (completed,
budget, deadline-shed, queue-shed, aborted, migrated), in a bounded ring,
with the reference's fields, so the reference's ``MetricsServer`` serves
a torch replica's journal at ``/debug/requests`` and its replay plane
records and replays it unchanged.  ``golden_hash`` is the replay golden
over a delivered token stream.  Overflow drops the oldest record;
``dropped`` counts evictions.
"""

from __future__ import annotations

import hashlib
import threading
from collections import deque
from dataclasses import asdict, dataclass, field


def golden_hash(token_ids) -> str:
    """sha256[:16] over a delivered token-id stream — the replay
    golden (the CanaryProber content-hash discipline, applied to every
    journaled request).  Empty stream hashes to "" so "no tokens" and
    "tokens" never compare equal."""
    if not token_ids:
        return ""
    raw = ",".join(str(int(t)) for t in token_ids).encode()
    return hashlib.sha256(raw).hexdigest()[:16]


# The reserved synthetic tenant canary probes ride (the reference's
# serve/canary.py).
# The leading underscore marks the whole "_"-prefix as reserved for
# synthetic traffic: the batcher skips user-facing SLO accounting for
# it and the tenant burn-rate rule skips reserved tenants wholesale.
PROBE_TENANT = "_canary"


# Terminal reasons a record can carry (the ``reason`` vocabulary):
#   eos            the model emitted the stop token
#   budget         max_new_tokens reached
#   deadline       the latency budget expired (at admission or mid-stream)
#   queue_full     shed at the door — max_pending admission control
#   no_capacity    paged mode could not seat the prompt even on an idle pool
#   aborted        batcher crash/shutdown cut the stream
FINISH_REASONS = (
    "eos", "budget", "deadline", "queue_full", "no_capacity", "aborted",
)

# Gateway-side terminal reasons (the reference gateway writes these with
# path="gateway"; replica journals never carry them):
#   admission      the weighted-fair admission controller refused the
#                  ticket — ``extra["admission"]`` narrows it to the
#                  shed cause (quota / burn / queue_full / timeout)
#   overloaded     every candidate replica was saturated
#   rejected       a replica rejected the request (4xx passthrough)
#   error          relay failed after exhausting dispatch attempts
#   ok             delivered (gateway-side mirror of the replica record)
GATEWAY_REASONS = (
    "ok", "admission", "overloaded", "rejected", "error",
    "deadline", "aborted",
)


@dataclass
class RequestRecord:
    """One retired request, flattened for JSON (``to_dict``)."""

    tenant: str = "default"
    trace_id: str = ""
    reason: str = ""
    path: str = ""            # admission path ("" when shed pre-admission)
    # Replay plane (serve/replay.py): the complete reproduction record.
    # Every terminal path must fill these — a journal record that cannot
    # be re-submitted is a gap in the flight recorder.  ``prompt_ids``
    # is empty only when the prompt genuinely never existed at this
    # layer (precomputed-prefill handoff rows).
    prompt_ids: list = field(default_factory=list)
    max_new: int = 0
    temperature: float = 0.0
    top_p: float = 0.0
    seed: int = 0
    # Arrival time relative to the journal's origin (first-appended
    # record's t_submit) — may be negative for a request that arrived
    # before the journal's first terminal event; the recorder re-bases.
    arrival_offset_s: float = 0.0
    # The request's RELATIVE latency budget at submit (seconds; 0.0 =
    # none) — replay re-arms the same budget against its own clock.
    deadline_s: float = 0.0
    # sha256[:16] over the emitted token-id stream (canary discipline);
    # "" when no token was delivered.
    golden_hash: str = ""
    # Journal-global completion index, stamped by append(): the
    # ``/debug/requests?since=`` cursor's unit.
    seq: int = 0
    # Fleet routing evidence (the reference's router): which replica the
    # front-end chose and why ("" when the request reached the batcher
    # without going through a router) — `obs requests` explains
    # placement from these.
    replica: str = ""
    route_reason: str = ""    # affinity | load | fallback | ""
    # Disaggregated prefill/decode handover: the prefill
    # worker that computed this request's KV pages ("" when the
    # request took the fused path) and the handover wall time —
    # prefill + export + wire + import, the gateway's "gateway.handover"
    # span — so replay diffs attribute disagg cost per request.
    prefill_replica: str = ""
    handover: float = 0.0     # seconds; 0.0 on the fused path
    slot: int = -1
    prompt_tokens: int = 0
    tokens: int = 0           # generated tokens actually delivered
    queue_wait_s: float = 0.0
    ttft_s: float = 0.0       # 0.0 when no token was emitted
    tpot_s: float = 0.0       # mean inter-token gap; 0.0 under 2 tokens
    prefix_blocks: int = 0    # shared KV blocks acquired from the cache
    spec_drafted: int = 0     # speculative proposals for this request
    spec_accepted: int = 0    # ...and how many the verify kept
    deadline_expired: bool = False
    t_submit: float = 0.0     # time.monotonic() domain, like spans
    t_done: float = 0.0
    extra: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        d = asdict(self)
        if not d["extra"]:
            d.pop("extra")
        return d


class RequestJournal:
    """Thread-safe bounded ring of ``RequestRecord``s."""

    # The scheduler thread appends while /debug/requests handlers
    # snapshot.
    def __init__(self, maxlen: int = 512):
        self._lock = threading.Lock()
        self._ring: "deque[RequestRecord]" = deque(
            maxlen=max(1, int(maxlen))
        )
        self.dropped = 0
        # Monotonic completion index: +1 per appended record, never
        # reset by ring eviction — the ``?since=`` cursor a periodic
        # scraper (serve/replay.py's recorder) resumes from.
        self._seq = 0
        # Arrival origin: the first appended record's t_submit.  Every
        # later record's arrival_offset_s is relative to it, so one
        # journal's offsets share a zero without leaking absolute
        # monotonic-clock values into the wire format.
        self._origin: float | None = None

    def append(self, rec: RequestRecord) -> None:
        with self._lock:
            if self._origin is None:
                self._origin = rec.t_submit
            rec.arrival_offset_s = rec.t_submit - self._origin
            self._seq += 1
            rec.seq = self._seq
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(rec)

    @property
    def cursor(self) -> int:
        """The current completion index: pass it back as ``since=`` to
        receive only records appended after this read."""
        with self._lock:
            return self._seq

    @property
    def origin(self) -> float | None:
        """This journal's arrival-offset zero (first record's
        t_submit, monotonic domain) — None before any append.  The
        workload recorder aligns multi-journal captures on it."""
        with self._lock:
            return self._origin

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def snapshot(
        self,
        limit: int = 100,
        tenant: str = "",
        reason: str = "",
        trace_id: str = "",
        probes: bool = True,
        since: int = 0,
    ) -> list[dict]:
        """Newest-first records as dicts, optionally filtered; the
        ``/debug/requests`` body.  ``limit <= 0`` returns none (the
        bare ``[-0:]`` hazard the alerts snapshot also guards).
        ``probes=False`` drops canary records (``extra.probe`` — the
        ``obs requests --no-probes`` filter).  ``since`` is a
        completion-index cursor (``RequestJournal.cursor``): only
        records appended AFTER that read are returned, so a periodic
        scraper ships deltas instead of re-fetching the whole ring."""
        if limit <= 0:
            return []
        with self._lock:
            recs = list(self._ring)
        out = []
        for rec in reversed(recs):
            if since and rec.seq <= since:
                break  # the ring is seq-ordered; everything older matches
            if tenant and rec.tenant != tenant:
                continue
            if reason and rec.reason != reason:
                continue
            if trace_id and rec.trace_id != trace_id:
                continue
            if not probes and rec.extra.get("probe"):
                continue
            out.append(rec.to_dict())
            if len(out) >= limit:
                break
        return out
