"""Prometheus-style metrics registry: the port's own copy of
``k8s_gpu_tpu/utils/metrics.py`` (``Histogram``, ``MetricsRegistry`` and
its text exposition), so the batcher mints the reference's serve-plane
series under the reference's names and labels and the reference's
federation collector and ``obs`` views read a torch replica's scrape as
they read a JAX one's.
"""

from __future__ import annotations

import threading
from collections import defaultdict, deque
from dataclasses import dataclass, field

_DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 30, 60,
                    120, 300)


@dataclass
class Histogram:
    buckets: tuple = _DEFAULT_BUCKETS
    counts: list = field(default_factory=list)
    total: float = 0.0
    n: int = 0
    # Bounded window of raw observations for exact percentiles; overflow
    # drops the oldest.
    raw: object = field(default_factory=lambda: deque(maxlen=4096))

    def __post_init__(self):
        if not self.counts:
            self.counts = [0] * (len(self.buckets) + 1)

    def observe(self, v: float) -> None:
        self.total += v
        self.n += 1
        self.raw.append(v)
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def percentile(self, q: float) -> float:
        """Exact q-quantile over the window; 0.0 if empty.  Call it
        through ``MetricsRegistry.percentile``, which holds the lock
        ``observe`` holds."""
        s = sorted(self.raw)
        if not s:
            return 0.0
        return s[min(len(s) - 1, max(0, int(q * len(s))))]

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0


class MetricsRegistry:
    """Thread-safe counters, gauges and histograms with labels.

    ``max_series_per_name`` caps the label sets of one name: writes past
    the cap collapse into the series ``{other="true"}`` and count in
    ``metrics_series_dropped_total{metric}``, so caller-supplied labels
    (a tenant) cannot mint unbounded series."""

    _OVERFLOW = (("other", "true"),)

    def __init__(self, max_series_per_name: int = 256):
        self._lock = threading.Lock()
        self._counters: dict[tuple, float] = defaultdict(float)
        self._gauges: dict[tuple, float] = {}
        self._hists: dict[tuple, Histogram] = {}
        self.max_series_per_name = max(1, int(max_series_per_name))
        self._series_seen: dict[str, set] = defaultdict(set)

    @staticmethod
    def _key(name: str, labels: dict | None) -> tuple:
        return (name, tuple(sorted((labels or {}).items())))

    def _key_write(self, name: str, labels: dict | None) -> tuple:
        """The write path's key: counts the name's label sets and
        collapses overflow.  Lock held by the caller."""
        k = self._key(name, labels)
        if not k[1]:
            return k
        seen = self._series_seen[name]
        if k[1] in seen:
            return k
        if len(seen) >= self.max_series_per_name:
            self._counters[
                ("metrics_series_dropped_total", (("metric", name),))
            ] += 1
            return (name, self._OVERFLOW)
        seen.add(k[1])
        return k

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        with self._lock:
            self._counters[self._key_write(name, labels)] += value

    def set_gauge(self, name: str, value: float, **labels) -> None:
        with self._lock:
            self._gauges[self._key_write(name, labels)] = value

    def observe(self, name: str, value: float, **labels) -> None:
        with self._lock:
            k = self._key_write(name, labels)
            if k not in self._hists:
                self._hists[k] = Histogram()
            self._hists[k].observe(value)

    def counter(self, name: str, **labels) -> float:
        with self._lock:
            return self._counters.get(self._key(name, labels), 0.0)

    def gauge(self, name: str, **labels) -> float | None:
        with self._lock:
            return self._gauges.get(self._key(name, labels))

    def histogram(self, name: str, **labels) -> Histogram | None:
        with self._lock:
            return self._hists.get(self._key(name, labels))

    def percentile(self, name: str, q: float, **labels) -> float:
        with self._lock:
            h = self._hists.get(self._key(name, labels))
            return h.percentile(q) if h is not None else 0.0

    def render(self) -> str:
        """Prometheus text exposition (the reference's subset)."""
        lines = []
        with self._lock:
            for (name, labels), v in sorted(self._counters.items()):
                lines.append(f"{name}{_fmt(labels)} {v}")
            for (name, labels), v in sorted(self._gauges.items()):
                lines.append(f"{name}{_fmt(labels)} {v}")
            for (name, labels), h in sorted(self._hists.items()):
                cum = 0
                for b, c in zip(h.buckets, h.counts):
                    cum += c
                    lines.append(f"{name}_bucket"
                                 f"{_fmt(labels + (('le', f'{b:g}'),))} "
                                 f"{cum}")
                lines.append(f"{name}_bucket"
                             f"{_fmt(labels + (('le', '+Inf'),))} {h.n}")
                lines.append(f"{name}_count{_fmt(labels)} {h.n}")
                lines.append(f"{name}_sum{_fmt(labels)} {h.total}")
        return "\n".join(lines) + "\n"


def escape_label_value(v) -> str:
    """Prometheus label-value escaping: backslash, double quote and
    newline."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(labels: tuple) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{escape_label_value(v)}"'
                          for k, v in labels) + "}"


global_metrics = MetricsRegistry()
