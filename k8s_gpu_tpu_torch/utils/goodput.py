"""Training goodput ledger and incident recorder: the port's own copy of
``GoodputLedger``, ``SEGMENTS``, ``INCIDENT_KINDS``, ``goodput_snapshot``
and ``goodput_snapshot_from_exposition`` from
``k8s_gpu_tpu/utils/goodput.py``.

- ``GoodputLedger`` partitions a run's wall clock into named segments
  (``SEGMENTS``), one open at a time: ``begin`` closes the open one at
  the same instant, and the time between an ``end`` and the next
  ``begin`` is the residual, so ``sum(segments) + residual == elapsed``
  exactly.  ``step`` is the only productive segment;
  ``train_goodput_ratio`` is its share of a rolling window, and every
  other segment's close adds to
  ``train_nonproductive_seconds_total{segment}``.
- A bounded ring of incidents (preemption, eviction, restart, resize,
  resume), each counted in ``train_incidents_total{kind}`` and stamped
  with the calling thread's active span's trace id
  (``utils.tracing.global_tracer``) unless the caller passes one.
- Per-host step heartbeats: the slowest host's EWMA over the median is
  ``train_step_skew_ratio``, and that host ``train_straggler_host{host}``.

All time flows through an injected ``utils.clock.Clock``, so two runs
under one ``TickingFakeClock`` script give equal snapshots, and equal
to the reference's under the same script.  The checkpoint series
(``train_checkpoint_seconds{op}``, ``train_checkpoint_bytes``,
``train_checkpoint_failures_total{op}``) come from
``train/checkpoint.py``; ``goodput_snapshot`` assembles them.
"""

from __future__ import annotations

import threading
from collections import deque
from contextlib import contextmanager

from .clock import Clock, RealClock
from .metrics import MetricsRegistry, global_metrics, parse_exposition
from .tracing import global_tracer

# Every segment a run's wall clock is split into; ``step`` alone is
# productive (compile and checkpoints are overhead the ratio charges).
SEGMENTS = (
    "init", "compile", "data_wait", "step", "checkpoint_save",
    "checkpoint_restore", "preempted", "reshard", "idle",
)
PRODUCTIVE = ("step",)

# Incident kinds the recorder takes; any other raises.
INCIDENT_KINDS = (
    "preemption", "eviction", "restart", "resize", "resume",
)


class _SegStat:
    __slots__ = ("count", "total_s")

    def __init__(self):
        self.count = 0
        self.total_s = 0.0


class GoodputLedger:
    """Clock-driven wall-clock partition and incident ring for one run.

    ``window_s`` is the rolling window of ``train_goodput_ratio``;
    ``max_incidents``/``max_samples`` bound the incident ring and the
    window's sample ring.  Recording and ``snapshot`` share one lock;
    metric writes happen outside it."""

    def __init__(self, registry: MetricsRegistry | None = None,
                 clock: Clock | None = None, window_s: float = 300.0,
                 max_incidents: int = 256, max_samples: int = 2048,
                 ewma_alpha: float = 0.3):
        self.registry = registry if registry is not None else global_metrics
        self.clock = clock or RealClock()
        self.window_s = max(1e-6, float(window_s))
        self.alpha = min(1.0, max(1e-6, float(ewma_alpha)))
        self._lock = threading.Lock()
        self._t0 = self.clock.now()
        self._totals: dict[str, _SegStat] = {}
        self._open: tuple[str, float] | None = None   # (segment, start)
        # Closed (t_end, segment, dt) samples and their productive sum,
        # kept exact: every eviction subtracts what its append added.
        self._max_samples = max(64, int(max_samples))
        self._window: deque = deque()
        self._win_prod = 0.0
        self._incidents: deque = deque(maxlen=max(8, max_incidents))
        # host -> {"step", "t", "last_s", "ewma_s"}
        self._hosts: dict[str, dict] = {}
        self._straggler: str | None = None

    # -- the segment partition ---------------------------------------------
    def begin(self, segment: str) -> None:
        """Open ``segment``, closing the open one at the same instant."""
        if segment not in SEGMENTS:
            raise ValueError(
                f"unknown goodput segment {segment!r}; one of {SEGMENTS}")
        now = self.clock.now()
        with self._lock:
            closed = self._close_locked(now)
            self._open = (segment, now)
        self._export_closed(closed, now)

    def end(self) -> None:
        """Close the open segment (a no-op when none is open); the time
        until the next ``begin`` is residual."""
        now = self.clock.now()
        with self._lock:
            closed = self._close_locked(now)
            self._open = None
        self._export_closed(closed, now)

    @contextmanager
    def segment(self, name: str):
        """``with ledger.segment("data_wait"): ...``.  Segments are flat:
        entering one closes the one that was open."""
        self.begin(name)
        try:
            yield
        finally:
            self.end()

    def _close_locked(self, now: float):
        """Fold the open segment into the totals and the window; returns
        ``(segment, dt)`` or None.  Lock held."""
        if self._open is None:
            return None
        seg, start = self._open
        dt = max(0.0, now - start)
        st = self._totals.get(seg)
        if st is None:
            st = self._totals[seg] = _SegStat()
        st.count += 1
        st.total_s += dt
        self._evict_locked(now - self.window_s)
        while len(self._window) >= self._max_samples:
            _, old_seg, old_dt = self._window.popleft()
            if old_seg in PRODUCTIVE:
                self._win_prod -= old_dt
        self._window.append((now, seg, dt))
        if seg in PRODUCTIVE:
            self._win_prod += dt
        return (seg, dt)

    def _evict_locked(self, cut: float) -> None:
        while self._window and self._window[0][0] < cut:
            _, seg, dt = self._window.popleft()
            if seg in PRODUCTIVE:
                self._win_prod -= dt

    def _export_closed(self, closed, now: float) -> None:
        if closed is None:
            return
        seg, dt = closed
        if seg not in PRODUCTIVE and dt > 0.0:
            self.registry.inc("train_nonproductive_seconds_total", dt,
                              segment=seg)
        self.registry.set_gauge("train_goodput_ratio",
                                self._windowed_ratio(now))

    # -- goodput -----------------------------------------------------------
    def _windowed_ratio(self, now: float) -> float:
        """Productive share of the trailing window; the open segment's
        time so far counts toward its kind."""
        with self._lock:
            self._evict_locked(now - self.window_s)
            prod = max(0.0, self._win_prod)
            if self._open is not None and self._open[0] in PRODUCTIVE:
                prod += max(0.0, now - self._open[1])
        span = min(self.window_s, max(1e-9, now - self._t0))
        return min(1.0, prod / span)

    def goodput_ratio(self) -> float:
        return self._windowed_ratio(self.clock.now())

    # -- incidents ---------------------------------------------------------
    def incident(self, kind: str, detail: str = "", trace_id: str = "",
                 event: str = "") -> None:
        """Append one incident.  ``event`` names the operator Event that
        caused it; ``trace_id`` defaults to the calling thread's active
        span's ("" outside any span)."""
        if kind not in INCIDENT_KINDS:
            raise ValueError(
                f"unknown incident kind {kind!r}; one of {INCIDENT_KINDS}")
        if not trace_id:
            ctx = global_tracer.current()
            trace_id = ctx.trace_id if ctx is not None else ""
        now = self.clock.now()
        rec = {"t": round(now, 9), "kind": kind, "detail": detail,
               "trace_id": trace_id, "event": event}
        with self._lock:
            self._incidents.append(rec)
        self.registry.inc("train_incidents_total", kind=kind)

    # -- straggler attribution ---------------------------------------------
    def heartbeat(self, host: str, step: int, step_seconds: float) -> None:
        """One host's per-step heartbeat.  With two or more hosts the
        slowest EWMA over the median EWMA is the skew ratio, and the
        slowest host is ``train_straggler_host{host}`` (its EWMA)."""
        now = self.clock.now()
        dt = max(0.0, float(step_seconds))
        with self._lock:
            h = self._hosts.get(host)
            if h is None:
                h = self._hosts[host] = {"step": 0, "t": now, "last_s": 0.0,
                                         "ewma_s": dt}
            else:
                h["ewma_s"] = (self.alpha * dt
                               + (1.0 - self.alpha) * h["ewma_s"])
            h["step"] = int(step)
            h["t"] = now
            h["last_s"] = dt
            skew, slowest, prev = self._skew_locked()
            self._straggler = slowest
        self.registry.set_gauge("train_step_skew_ratio", skew)
        if prev is not None and prev != slowest:
            self.registry.remove_gauge("train_straggler_host", host=prev)
        if slowest is not None:
            with self._lock:
                val = self._hosts[slowest]["ewma_s"]
            self.registry.set_gauge("train_straggler_host", val,
                                    host=slowest)
        self.registry.set_gauge("train_goodput_ratio",
                                self._windowed_ratio(now))

    def _skew_locked(self):
        """(skew ratio, straggler or None, previous straggler).  One host
        reports 1.0 and no straggler.  Lock held."""
        prev = self._straggler
        if len(self._hosts) < 2:
            return 1.0, None, prev
        ewmas = sorted((h["ewma_s"], name)
                       for name, h in sorted(self._hosts.items()))
        slowest_s, slowest = ewmas[-1]
        mid = ewmas[len(ewmas) // 2][0] if len(ewmas) % 2 else (
            (ewmas[len(ewmas) // 2 - 1][0] + ewmas[len(ewmas) // 2][0]) / 2.0)
        return slowest_s / max(1e-9, mid), slowest, prev

    # -- read surface ------------------------------------------------------
    def snapshot(self) -> dict:
        """The ledger's half of the ``/debug/goodput`` body.  The open
        segment's time so far folds into its entry, so ``sum(seconds) +
        residual_s == elapsed_s`` exactly; floats are ``round(x, 9)`` and
        dicts iterate sorted."""
        now = self.clock.now()
        elapsed = max(0.0, now - self._t0)
        with self._lock:
            totals = {seg: (st.count, st.total_s)
                      for seg, st in self._totals.items()}
            open_seg = self._open
            incidents = list(self._incidents)
            hosts = {name: dict(h) for name, h in self._hosts.items()}
            skew, slowest, _ = self._skew_locked()
        if open_seg is not None:
            seg, start = open_seg
            count, total = totals.get(seg, (0, 0.0))
            totals[seg] = (count + 1, total + max(0.0, now - start))
        attributed = sum(t for _, t in totals.values())
        residual = max(0.0, elapsed - attributed)
        productive = sum(totals.get(seg, (0, 0.0))[1] for seg in PRODUCTIVE)
        segments = {}
        for seg in sorted(totals):
            count, total = totals[seg]
            segments[seg] = {
                "count": count,
                "seconds": round(total, 9),
                "share": round(total / elapsed, 9) if elapsed > 0 else 0.0,
            }
        return {
            "now": round(now, 9),
            "started": round(self._t0, 9),
            "elapsed_s": round(elapsed, 9),
            "window_s": self.window_s,
            "segments": segments,
            "open": open_seg[0] if open_seg is not None else None,
            "residual_s": round(residual, 9),
            "residual_share": (round(residual / elapsed, 9)
                               if elapsed > 0 else 0.0),
            "productive_s": round(productive, 9),
            "goodput_ratio": round(self._windowed_ratio(now), 9),
            "goodput_ratio_total": (round(productive / elapsed, 9)
                                    if elapsed > 0 else 0.0),
            "hosts": {
                name: {"step": h["step"], "last_s": round(h["last_s"], 9),
                       "ewma_s": round(h["ewma_s"], 9),
                       "age_s": round(max(0.0, now - h["t"]), 9)}
                for name, h in sorted(hosts.items())
            },
            "straggler": ({"host": slowest, "skew_ratio": round(skew, 9)}
                          if slowest is not None else None),
            "incidents": incidents,
        }


# -- the /debug/goodput body --------------------------------------------------

def goodput_snapshot(ledger: GoodputLedger | None = None,
                     registry: MetricsRegistry | None = None) -> dict:
    """The ``/debug/goodput`` body: the ledger's partition and incidents
    plus the checkpoint series in the registry.  Either half may be
    absent; the shape stays the same."""
    reg = registry if registry is not None else (
        ledger.registry if ledger is not None else global_metrics)
    snap = ledger.snapshot() if ledger is not None else {
        "now": 0.0, "started": 0.0, "elapsed_s": 0.0, "window_s": 0.0,
        "segments": {}, "open": None, "residual_s": 0.0,
        "residual_share": 0.0, "productive_s": 0.0, "goodput_ratio": None,
        "goodput_ratio_total": 0.0, "hosts": {}, "straggler": None,
        "incidents": [],
    }
    ckpt: dict[str, dict] = {}
    for lbls, q in sorted(
            reg.hist_percentiles("train_checkpoint_seconds", 0.95).items()):
        op = dict(lbls).get("op")
        if op:
            ckpt[op] = {"p95_s": round(q, 9)}
    for lbls, v in sorted(
            reg.series("train_checkpoint_failures_total").items()):
        op = dict(lbls).get("op")
        if op:
            ckpt.setdefault(op, {})["failures"] = v
    snap["checkpoint"] = {"ops": ckpt,
                          "last_bytes": reg.gauge("train_checkpoint_bytes")}
    return snap


def _bucket_quantile(series: dict, q: float) -> float | None:
    """``histogram_quantile`` over cumulative ``_bucket`` series: counts
    of one ``le`` summed, then linear interpolation inside the first
    bucket covering rank ``q * n``; None when empty.  (The reference
    keeps this in ``utils/federation.py``.)"""
    merged: dict[float, float] = {}
    for lbls, v in series.items():
        le = dict(lbls).get("le")
        if le is None:
            continue
        try:
            b = float(le)
        except ValueError:
            continue
        merged[b] = merged.get(b, 0.0) + v
    if not merged:
        return None
    bounds = sorted(merged)
    total = merged[bounds[-1]]
    if total <= 0.0:
        return None
    rank = max(0.0, min(1.0, q)) * total
    prev_bound, prev_cum = 0.0, 0.0
    for b in bounds:
        cum = merged[b]
        if cum >= rank:
            if b == float("inf"):
                return prev_bound
            span = cum - prev_cum
            frac = (rank - prev_cum) / span if span > 0 else 1.0
            return prev_bound + (b - prev_bound) * frac
        prev_bound, prev_cum = b, cum
    return bounds[-1]


def goodput_snapshot_from_exposition(text: str) -> dict:
    """A ``/debug/goodput``-shaped snapshot from one text exposition:
    productive seconds from the ``train_step_seconds`` histogram's sum,
    the other segments from their counter, checkpoint percentiles from
    the cumulative buckets.  The incident ring does not ride the
    exposition: ``incidents`` is empty and ``incident_counts`` holds the
    per-kind counters."""
    fams = parse_exposition(text)
    productive = sum(fams.get("train_step_seconds_sum", {}).values())
    step_count = int(sum(fams.get("train_step_seconds_count", {}).values()))
    totals: dict[str, float] = {}
    for lbls, v in sorted(
            fams.get("train_nonproductive_seconds_total", {}).items()):
        seg = dict(lbls).get("segment")
        if seg:
            totals[seg] = totals.get(seg, 0.0) + v
    if productive > 0.0:
        totals["step"] = productive
    elapsed = sum(totals.values())
    segments = {
        seg: {"count": step_count if seg == "step" else 0,
              "seconds": round(t, 9),
              "share": round(t / elapsed, 9) if elapsed > 0 else 0.0}
        for seg, t in sorted(totals.items())
    }
    series = fams.get("train_goodput_ratio", {})
    ratio = next(iter(series.values())) if series else None
    skew_series = fams.get("train_step_skew_ratio", {})
    skew = next(iter(skew_series.values())) if skew_series else None
    straggler = None
    for lbls, v in sorted(fams.get("train_straggler_host", {}).items()):
        host = dict(lbls).get("host")
        if host:
            straggler = {"host": host,
                         "skew_ratio": skew if skew is not None else 0.0}
    ckpt: dict[str, dict] = {}
    for op in ("restore", "save"):
        sub = {l: v for l, v in
               fams.get("train_checkpoint_seconds_bucket", {}).items()
               if dict(l).get("op") == op}
        if sub:
            ckpt[op] = {"p95_s": _bucket_quantile(sub, 0.95) or 0.0}
    for lbls, v in sorted(
            fams.get("train_checkpoint_failures_total", {}).items()):
        op = dict(lbls).get("op")
        if op:
            ckpt.setdefault(op, {})["failures"] = v
    bytes_series = fams.get("train_checkpoint_bytes", {})
    incident_counts = {
        dict(lbls).get("kind", "?"): v
        for lbls, v in sorted(fams.get("train_incidents_total", {}).items())
    }
    return {
        "now": 0.0,
        "started": 0.0,
        "elapsed_s": round(elapsed, 9),
        "window_s": 0.0,
        "segments": segments,
        "open": None,
        "residual_s": 0.0,
        "residual_share": 0.0,
        "productive_s": round(productive, 9),
        "goodput_ratio": ratio,
        "goodput_ratio_total": (round(productive / elapsed, 9)
                                if elapsed > 0 else 0.0),
        "hosts": {},
        "straggler": straggler,
        "incidents": [],
        "incident_counts": incident_counts,
        "checkpoint": {
            "ops": ckpt,
            "last_bytes": (next(iter(bytes_series.values()))
                           if bytes_series else None),
        },
    }
