"""Span tracer: the port's own copy of ``k8s_gpu_tpu/utils/tracing.py``.

- ``SpanContext``, ``parse_traceparent``/``format_traceparent``: the W3C
  ``traceparent`` a request carries in and the context children parent
  to.
- ``Span``: trace, span and parent ids, a name, monotonic start and end
  on an injected ``utils.clock.Clock``, attributes and a status.
- ``Tracer``: a per-thread context stack (``span`` nests, ``use``
  attaches a context propagated by hand) and ``add_span`` for spans that
  cross threads: the batcher's scheduler thread records a request's
  ``serve.queue_wait``, ``serve.prefill`` and ``serve.round`` spans with
  the request's context as their explicit parent.
- Finished spans land in a bounded ring of traces (``max_traces``
  buckets of ``max_spans_per_trace``): a full ring evicts its oldest
  trace, a full trace keeps its first spans and a rolling window of its
  latest, and every drop counts in ``tracing_dropped_total{kind}``;
  ``tracing_spans_total`` counts every recorded span.  ``traces`` takes
  a ``since=`` completion cursor (``Tracer.cursor``) so a scraper ships
  only traces that gained spans.

The assembled traces are the reference's dicts, byte for byte, so the
reference's ``MetricsServer``, ``FleetTraceAssembler`` and
``render_trace`` read a torch replica's ring unchanged.  A request that
carries no context records no ``serve.`` span.
"""

from __future__ import annotations

import threading
import uuid
from collections import OrderedDict, deque
from contextlib import contextmanager
from dataclasses import dataclass, field

from .clock import Clock, RealClock
from .metrics import MetricsRegistry, global_metrics

_TRACEPARENT_VERSION = "00"
_HEX = set("0123456789abcdefABCDEF")


@dataclass(frozen=True)
class SpanContext:
    trace_id: str  # 32 lowercase hex chars
    span_id: str   # 16 lowercase hex chars


def new_trace_id() -> str:
    return uuid.uuid4().hex


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def format_traceparent(ctx: SpanContext) -> str:
    """The ``traceparent`` header value (sampled flag set)."""
    return f"{_TRACEPARENT_VERSION}-{ctx.trace_id}-{ctx.span_id}-01"


def _is_hex(s: str) -> bool:
    return bool(s) and all(c in _HEX for c in s)


def parse_traceparent(header: str | None) -> SpanContext | None:
    """``traceparent`` -> SpanContext; None for an absent or malformed
    header (which starts a new trace, never a 500)."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id = parts[0], parts[1], parts[2]
    if version == "ff" or len(version) != 2 or not _is_hex(version):
        return None
    if len(trace_id) != 32 or not _is_hex(trace_id) or trace_id == "0" * 32:
        return None
    if len(span_id) != 16 or not _is_hex(span_id) or span_id == "0" * 16:
        return None
    return SpanContext(trace_id.lower(), span_id.lower())


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: str | None
    start: float                       # Clock.now() (monotonic)
    end: float = 0.0
    ts: float = 0.0                    # wall clock at start (display)
    attributes: dict = field(default_factory=dict)
    status: str = "ok"

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    @property
    def duration_ms(self) -> float:
        return max(0.0, (self.end - self.start) * 1000.0)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start": self.start,
            "duration_ms": round(self.duration_ms, 3),
            "ts": self.ts,
            "attributes": dict(self.attributes),
            "status": self.status,
        }


class _TraceBucket:
    """One trace's spans under the per-trace cap: ``head`` keeps the
    first spans, ``tail`` a rolling window of the latest; ``last_seq`` is
    the tracer's completion index of the newest span recorded here."""

    __slots__ = ("head", "tail", "_head_cap", "last_seq")

    def __init__(self, head_cap: int, tail_cap: int):
        self.head: list[Span] = []
        self.tail: deque = deque(maxlen=max(0, tail_cap))
        self._head_cap = head_cap
        self.last_seq = 0

    def add(self, sp: Span) -> bool:
        """Record ``sp``; True when an older span was dropped."""
        if len(self.head) < self._head_cap:
            self.head.append(sp)
            return False
        dropped = self.tail.maxlen == 0 or len(self.tail) == self.tail.maxlen
        if self.tail.maxlen:
            self.tail.append(sp)
        return dropped

    def spans(self) -> list[Span]:
        return self.head + list(self.tail)


class Tracer:
    """Thread-safe span recorder with a bounded ring of traces."""

    def __init__(self, max_traces: int = 256,
                 max_spans_per_trace: int = 512,
                 registry: MetricsRegistry | None = None,
                 clock: Clock | None = None):
        self.max_traces = max(1, int(max_traces))
        self.max_spans_per_trace = max(1, int(max_spans_per_trace))
        # The first spans (the request and its admission) stay; the rest
        # roll.
        self._head_cap = max(1, min(16, self.max_spans_per_trace // 2))
        self.registry = registry or global_metrics
        self.clock = clock or RealClock()
        self._lock = threading.Lock()
        # trace_id -> bucket, in insertion order for FIFO eviction.
        self._traces: OrderedDict = OrderedDict()
        # +1 per recorded span, never reset: the since= cursor.
        self._seq = 0
        self._tls = threading.local()

    # -- context -----------------------------------------------------------
    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def current(self) -> SpanContext | None:
        """The active context on this thread, or None."""
        stack = getattr(self._tls, "stack", None)
        return stack[-1] if stack else None

    @contextmanager
    def use(self, ctx: SpanContext | None):
        """Make a context propagated by hand this thread's current one
        (no span is recorded); ``use(None)`` does nothing."""
        if ctx is None:
            yield
            return
        stack = self._stack()
        stack.append(ctx)
        try:
            yield
        finally:
            stack.pop()

    @contextmanager
    def span(self, name: str, /, parent: SpanContext | None = None,
             **attributes):
        """A span over the block: a child of ``parent``, else of this
        thread's current context, else a new trace's root.  An exception
        marks it ``error`` and goes on up."""
        parent = parent or self.current()
        sp = Span(
            name=name,
            trace_id=parent.trace_id if parent else new_trace_id(),
            span_id=new_span_id(),
            parent_id=parent.span_id if parent else None,
            start=self.clock.now(),
            ts=self.clock.wall(),
            attributes=dict(attributes),
        )
        stack = self._stack()
        stack.append(sp.context)
        try:
            yield sp
        except BaseException as e:
            sp.status = "error"
            sp.attributes.setdefault("error", repr(e))
            raise
        finally:
            stack.pop()
            sp.end = self.clock.now()
            self._record(sp)

    def add_span(self, name: str, /, parent: SpanContext | None = None,
                 start: float | None = None, end: float | None = None,
                 status: str = "ok", span_id: str | None = None,
                 **attributes) -> SpanContext:
        """Record a finished span with explicit bounds (the cross-thread
        form); returns its context.  ``span_id`` lets a caller mint the
        id beforehand and propagate it before the span ends."""
        now = self.clock.now()
        sp = Span(
            name=name,
            trace_id=parent.trace_id if parent else new_trace_id(),
            span_id=span_id or new_span_id(),
            parent_id=parent.span_id if parent else None,
            start=now if start is None else start,
            ts=self.clock.wall(),
            attributes=dict(attributes),
            status=status,
        )
        sp.end = now if end is None else end
        self._record(sp)
        return sp.context

    # -- storage -----------------------------------------------------------
    def _record(self, sp: Span) -> None:
        with self._lock:
            bucket = self._traces.get(sp.trace_id)
            if bucket is None:
                while len(self._traces) >= self.max_traces:
                    self._traces.popitem(last=False)
                    self.registry.inc("tracing_dropped_total", kind="trace")
                bucket = _TraceBucket(
                    self._head_cap,
                    self.max_spans_per_trace - self._head_cap)
                self._traces[sp.trace_id] = bucket
            if bucket.add(sp):
                self.registry.inc("tracing_dropped_total", kind="span")
            self._seq += 1
            bucket.last_seq = self._seq
            self.registry.inc("tracing_spans_total")

    @property
    def cursor(self) -> int:
        """The completion index now: pass it back as ``since=`` to get
        only traces that recorded spans after this read."""
        with self._lock:
            return self._seq

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()

    # -- assembly ----------------------------------------------------------
    @staticmethod
    def _assemble(trace_id: str, spans: list[Span]) -> dict:
        nodes = {s.span_id: {**s.to_dict(), "children": []} for s in spans}
        roots = []
        for s in sorted(spans, key=lambda x: x.start):
            node = nodes[s.span_id]
            parent = nodes.get(s.parent_id) if s.parent_id else None
            (parent["children"] if parent else roots).append(node)
        t0 = min(s.start for s in spans)
        t1 = max(s.end for s in spans)
        return {
            "trace_id": trace_id,
            "span_count": len(spans),
            "duration_ms": round(max(0.0, (t1 - t0) * 1000.0), 3),
            "start": t0,
            "tree": roots,
        }

    def get_trace(self, trace_id: str) -> dict | None:
        with self._lock:
            bucket = self._traces.get(trace_id)
            spans = bucket.spans() if bucket else []
        return self._assemble(trace_id, spans) if spans else None

    def traces(self, trace_id: str | None = None, min_ms: float = 0.0,
               name: str = "", limit: int = 50,
               since: int = 0) -> list[dict]:
        """Assembled traces, newest first: ``trace_id`` picks one,
        ``name`` matches a substring of any span's name, ``min_ms``
        filters on the trace's duration, ``since`` keeps traces that
        recorded a span after that cursor."""
        with self._lock:
            snap = [(tid, b.spans(), b.last_seq)
                    for tid, b in self._traces.items()]
        out = []
        for tid, spans, last_seq in reversed(snap):
            if not spans or (trace_id and tid != trace_id):
                continue
            if since and last_seq <= since:
                continue
            if name and not any(name in s.name for s in spans):
                continue
            t = self._assemble(tid, spans)
            if t["duration_ms"] < min_ms:
                continue
            out.append(t)
            if len(out) >= max(1, int(limit)):
                break
        return out


def render_trace(trace: dict) -> str:
    """An assembled trace (``Tracer.traces``' dicts) as an indented
    tree, one line a span with its duration and attributes."""
    lines = [
        f"trace {trace['trace_id']}  "
        f"({trace['span_count']} spans, {trace['duration_ms']:.1f} ms)"
    ]

    def walk(node: dict, depth: int) -> None:
        attrs = node.get("attributes") or {}
        extra = " ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
        flag = "" if node.get("status", "ok") == "ok" else "  [ERROR]"
        lines.append(
            f"{'  ' * depth}• {node['name']:<40s} "
            f"{node['duration_ms']:9.1f} ms{flag}"
            + (f"  {{{extra}}}" if extra else "")
        )
        for child in node.get("children", ()):
            walk(child, depth + 1)

    for root in trace.get("tree", ()):
        walk(root, 1)
    return "\n".join(lines)


global_tracer = Tracer()
