"""Phase-level time attribution for a hot loop: the port's own copy of
``PhaseProfiler`` and ``profile_snapshot`` from
``k8s_gpu_tpu/utils/profiler.py``.

A per-thread phase stack records self time (entering a nested phase
pauses the enclosing one), so the phases stay disjoint and their shares
a partition of the wall clock, with the unattributed rest reported as
``residual``.  Per phase: a bounded reservoir (p50/p95), an EWMA and its
share of a rolling window.  ``plane`` picks the metric families:
``"serve"`` (the default, as in the reference) writes
``serve_phase_seconds{phase}`` and ``export_shares`` writes
``serve_phase_share{phase}``; ``"train"`` the ``train_`` pair.  Time
flows through an injected ``utils.clock.Clock``.

The batcher's scheduler thread times the reference's serving phases
(``admission`` with ``paged_plan`` and ``prefill_dispatch`` nested,
``decode_dispatch`` with ``spec_draft`` nested, ``decode_consume``,
``spec_verify``, ``retire``); the ``Trainer`` times ``shard_batch``
(the batch's copy to the device), ``step_dispatch`` and ``loss_sync``.
``profile_snapshot`` is the ``/debug/profile`` body, in the reference's
shape.
"""

from __future__ import annotations

import threading
from collections import deque
from contextlib import contextmanager

from .clock import Clock, RealClock
from .metrics import MetricsRegistry, global_metrics


class _PhaseStat:
    __slots__ = ("count", "total_s", "ewma_s", "reservoir")

    def __init__(self, reservoir: int):
        self.count = 0
        self.total_s = 0.0
        self.ewma_s = 0.0
        # This profiler's own window: the registry may be shared.
        self.reservoir: deque = deque(maxlen=reservoir)


class _Seg:
    """One open frame of the per-thread phase stack."""

    __slots__ = ("name", "acc", "last")

    def __init__(self, name: str, now: float):
        self.name = name
        self.acc = 0.0    # self time before the current run
        self.last = now   # start of the current run


class PhaseProfiler:
    """Bounded, clock-driven accounting of one plane's phases (``plane``:
    ``"serve"`` or ``"train"``).  ``window_s`` is the share window,
    ``reservoir`` bounds each phase's percentile reservoir and
    ``max_samples`` the rolling sample ring."""

    def __init__(self, plane: str = "serve",
                 registry: MetricsRegistry | None = None,
                 clock: Clock | None = None, window_s: float = 60.0,
                 reservoir: int = 512, ewma_alpha: float = 0.2,
                 max_samples: int = 2048):
        if plane not in ("serve", "train"):
            raise ValueError(
                f"unknown profiler plane {plane!r}: 'serve' or 'train'")
        self.plane = plane
        self._seconds = f"{plane}_phase_seconds"
        self._share = f"{plane}_phase_share"
        self.registry = registry if registry is not None else global_metrics
        self.clock = clock or RealClock()
        self.window_s = max(1e-6, float(window_s))
        self.reservoir = max(8, int(reservoir))
        self.alpha = min(1.0, max(1e-6, float(ewma_alpha)))
        self._lock = threading.Lock()
        self._stats: dict[str, _PhaseStat] = {}
        # Rolling (t_end, phase, self_seconds) samples and their per-phase
        # sums, kept exact: every eviction subtracts what its append added.
        self._max_samples = max(64, int(max_samples))
        self._window: deque = deque()
        self._win_sums: dict[str, float] = {}
        self._t0 = self.clock.now()
        self._tls = threading.local()

    # -- recording ---------------------------------------------------------
    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def push(self, name: str) -> None:
        """Enter ``name``; the enclosing phase stops accumulating."""
        now = self.clock.now()
        stack = self._stack()
        if stack:
            top = stack[-1]
            top.acc += now - top.last
        stack.append(_Seg(name, now))

    def pop(self) -> float:
        """Leave the current phase, record its self time, resume the
        enclosing one; returns the recorded seconds."""
        now = self.clock.now()
        stack = self._stack()
        seg = stack.pop()
        if stack:
            stack[-1].last = now
        dt = seg.acc + (now - seg.last)
        self.record(seg.name, dt, end=now)
        return dt

    @contextmanager
    def phase(self, name: str):
        """``with profiler.phase("step_dispatch"): ...``"""
        self.push(name)
        try:
            yield
        finally:
            self.pop()

    def record(self, name: str, seconds: float,
               end: float | None = None) -> None:
        """Record one finished sample of ``seconds`` ending at ``end``
        (default: now)."""
        dt = max(0.0, float(seconds))
        now = self.clock.now() if end is None else end
        with self._lock:
            st = self._stats.get(name)
            if st is None:
                st = self._stats[name] = _PhaseStat(self.reservoir)
            st.count += 1
            st.total_s += dt
            st.reservoir.append(dt)
            st.ewma_s = (dt if st.count == 1
                         else self.alpha * dt + (1.0 - self.alpha) * st.ewma_s)
            self._evict_locked(now - self.window_s)
            while len(self._window) >= self._max_samples:
                _, old_name, old_dt = self._window.popleft()
                self._win_sums[old_name] -= old_dt
            self._window.append((now, name, dt))
            self._win_sums[name] = self._win_sums.get(name, 0.0) + dt
        self.registry.observe(self._seconds, dt, phase=name)

    def _evict_locked(self, cut: float) -> None:
        while self._window and self._window[0][0] < cut:
            _, name, dt = self._window.popleft()
            self._win_sums[name] -= dt

    # -- shares ------------------------------------------------------------
    def shares(self, now: float | None = None) -> tuple[dict, float, float]:
        """(per-phase share, residual, span) over the trailing window,
        normalised so the shares sum to at most 1."""
        now = self.clock.now() if now is None else now
        with self._lock:
            self._evict_locked(now - self.window_s)
            per = {name: max(0.0, v) for name, v in self._win_sums.items()}
            phases = sorted(self._stats)
        span = min(self.window_s, max(1e-9, now - self._t0))
        denom = max(span, sum(per.values()))
        out = {ph: per.get(ph, 0.0) / denom for ph in phases}
        residual = max(0.0, 1.0 - sum(out.values()))
        return out, residual, span

    def export_shares(self) -> None:
        """Write the shares as ``{plane}_phase_share{phase}`` gauges,
        ``phase="residual"`` included."""
        per, residual, _ = self.shares()
        for ph, v in per.items():
            self.registry.set_gauge(self._share, v, phase=ph)
        self.registry.set_gauge(self._share, residual, phase="residual")

    # -- read surface ------------------------------------------------------
    @staticmethod
    def _quantile(sorted_vals: list, q: float) -> float:
        if not sorted_vals:
            return 0.0
        k = min(len(sorted_vals) - 1, max(0, int(q * len(sorted_vals))))
        return sorted_vals[k]

    def snapshot(self) -> dict:
        """Per-phase count/total/ewma/p50/p95/share, the residual and the
        rolling sample ring."""
        now = self.clock.now()
        per, residual, span = self.shares(now)
        with self._lock:
            stats = {ph: (st.count, st.total_s, st.ewma_s,
                          sorted(st.reservoir))
                     for ph, st in self._stats.items()}
            samples = [[t, ph, dt] for t, ph, dt in self._window]
        phases = {}
        for ph in sorted(stats):
            count, total_s, ewma_s, res = stats[ph]
            phases[ph] = {
                "count": count,
                "total_s": round(total_s, 9),
                "ewma_s": round(ewma_s, 9),
                "p50_s": round(self._quantile(res, 0.5), 9),
                "p95_s": round(self._quantile(res, 0.95), 9),
                "share": round(per.get(ph, 0.0), 9),
            }
        return {
            "plane": self.plane,
            "now": now,
            "window_s": self.window_s,
            "span_s": round(span, 9),
            "phases": phases,
            "residual_share": round(residual, 9),
            "samples": samples,
        }


def profile_snapshot(profiler: PhaseProfiler | None = None,
                     registry: MetricsRegistry | None = None) -> dict:
    """The ``/debug/profile`` body, in the reference's shape: the
    profiler's snapshot, the compile telemetry families (the kernel
    libraries ``nvcc`` built, ``utils.compat.install_compile_telemetry``)
    and the per-axis collective gauges (none on one card)."""
    reg = registry if registry is not None else (
        profiler.registry if profiler is not None else global_metrics)
    snap = (profiler.snapshot() if profiler is not None else {
        "plane": None, "now": 0.0, "window_s": 0.0, "span_s": 0.0,
        "phases": {}, "residual_share": None, "samples": [],
    })
    hist = reg.histogram("xla_compile_seconds")
    snap["compile"] = {
        "compiles_total": reg.counter("xla_compiles_total"),
        "compile_seconds_sum": round(hist.total, 9) if hist else 0.0,
        "compile_p95_s": round(reg.percentile("xla_compile_seconds", 0.95),
                               9),
    }
    coll: dict[str, dict] = {}
    for lbls, v in sorted(reg.series("collective_bytes_per_second").items()):
        axis = dict(lbls).get("axis")
        if axis:
            coll[axis] = {"bytes_per_second": v}
    for lbls, q in sorted(reg.hist_percentiles("collective_seconds",
                                               0.5).items()):
        d = dict(lbls)
        axis, op = d.get("axis"), d.get("op", "?")
        if axis:
            coll.setdefault(axis, {}).setdefault("p50_s", {})[op] = round(q,
                                                                           9)
    snap["collectives"] = coll
    snap["deep_dive"] = ("per-op device timing: utils.profiling.trace / "
                         "profile_trainer (torch.profiler Chrome trace)")
    return snap
