"""Prometheus-style metrics registry: the port's own copy of
``k8s_gpu_tpu/utils/metrics.py`` (``Histogram``, ``MetricsRegistry``, its
text exposition and ``parse_exposition``, which reads that text back),
so the batcher and the trainer mint the reference's series under the
reference's names and labels and the reference's federation collector
and ``obs`` views read a torch replica's scrape as they read a JAX one's.
"""

from __future__ import annotations

import re
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

    def remove_gauge(self, name: str, **labels) -> None:
        """Delete one gauge series (a gauge of an object that is gone),
        freeing its label set's slot unless a counter or histogram still
        holds it."""
        with self._lock:
            k = self._key(name, labels)
            self._gauges.pop(k, None)
            if k not in self._counters and k not in self._hists:
                self._series_seen.get(name, set()).discard(k[1])

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

    def series(self, name: str) -> dict[tuple, float]:
        """Every counter and gauge series of ``name``: {labels: value}."""
        with self._lock:
            out = {lbls: v for (n, lbls), v in self._counters.items()
                   if n == name}
            out.update({lbls: v for (n, lbls), v in self._gauges.items()
                        if n == name})
            return out

    def hist_percentiles(self, name: str, q: float) -> dict[tuple, float]:
        """The exact q-quantile of each histogram series of ``name``."""
        with self._lock:
            return {lbls: h.percentile(q)
                    for (n, lbls), h in self._hists.items() if n == name}

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


def unescape_label_value(v: str) -> str:
    """Inverse of ``escape_label_value``; an unknown escape drops its
    backslash."""
    if "\\" not in v:
        return v
    out = []
    i, n = 0, len(v)
    while i < n:
        c = v[i]
        if c == "\\" and i + 1 < n:
            nxt = v[i + 1]
            out.append({"\\": "\\", '"': '"', "n": "\n"}.get(nxt, nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _fmt(labels: tuple) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{escape_label_value(v)}"'
                          for k, v in labels) + "}"


_EXPO_LINE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$")
# A label value is any run of characters but a bare quote or backslash,
# or an escape pair.
_EXPO_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_exposition(text: str) -> dict[str, dict[tuple, float]]:
    """The text ``render`` writes, read back as {name: {labels: value}}:
    escaped label values round-trip, ``NaN`` and ``+Inf``/``-Inf``
    parse to floats, comments and malformed lines are skipped."""
    out: dict[str, dict[tuple, float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _EXPO_LINE.match(line)
        if m is None:
            continue
        name, raw_labels, raw_value = m.groups()
        try:
            value = float(raw_value)
        except ValueError:
            continue
        labels = tuple(sorted(
            (k, unescape_label_value(v))
            for k, v in _EXPO_LABEL.findall(raw_labels or "")))
        out.setdefault(name, {})[labels] = value
    return out


global_metrics = MetricsRegistry()
