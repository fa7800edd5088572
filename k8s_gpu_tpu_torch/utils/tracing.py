"""W3C trace context for the port's HTTP surface: the port's own copy of
``SpanContext``, ``parse_traceparent`` and ``format_traceparent`` from
``k8s_gpu_tpu/utils/tracing.py``.  The port records no spans; it carries
a request's trace id from an inbound ``traceparent`` (or a fresh one)
into the batcher's journal and the response, so a torch replica's
records join the fleet's traces by id."""

from __future__ import annotations

import uuid
from dataclasses import dataclass

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


def request_context(header: str | None) -> SpanContext:
    """The context of one inbound request: the caller's trace continued
    under a new span id, or a new trace when no valid header came."""
    inbound = parse_traceparent(header)
    return SpanContext(inbound.trace_id if inbound else new_trace_id(),
                       new_span_id())
