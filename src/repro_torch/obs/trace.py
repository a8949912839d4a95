"""Request tracing: spans, traceparent propagation, bounded trace ring.

A `Span` is (trace_id, span_id, parent_id, name, monotonic start/stop,
attributes). Root spans are opened only at the HTTP layer (`root_span`);
library code opens children with `span(name)`, which is a NO-OP unless a
current span exists — so engine/catalog calls outside a served request
cost one contextvar read and nothing else.

Propagation follows the W3C traceparent shape
(`00-<32hex trace_id>-<16hex span_id>-01`): carried as an HTTP header on
JSON requests and as an optional tagged section in the wire frame
(`wire.codec._SECTION_TRACE`; unknown-section skip keeps old peers
compatible). The current span rides a `contextvars.ContextVar`, which is
per-thread under `ThreadingHTTPServer` — exactly the granularity we need.

The collector is deliberately flat: finishing a span appends it to one
bounded ring of finished spans and nothing else — no per-trace
registration on the hot path. Grouping spans into traces happens lazily
at `/debug/traces` scrape time, where a full scan of a few thousand
entries is irrelevant. Because parents exit after their children (spans
are context managers), a trace whose root span is in the ring is
complete; a scrape racing an in-flight request may see a rootless
partial trace, which `trace_tree` renders under a synthetic root.

Retention is interest-based: a childless local root (the warm cache-hit
request, which dominates traffic) is NOT retained — its only facts,
latency and status, are already in the request histograms — unless it
errored or was marked with `keep_trace()`. Spans with children, spans
whose parent lives in another process (joined traces), and child spans
always land in the ring.
"""
from __future__ import annotations

import contextvars
import os
import random
import threading
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.obs import _state

TRACEPARENT_HEADER = "Traceparent"

# Ring capacity in SPANS (not traces): warm singleton traces are one span
# each, deep /batch traces a few dozen — ample history either way, with
# one fixed memory bound. Kept modest on purpose: every retained span is
# an object the cyclic GC keeps re-scanning.
_MAX_SPANS = 1024
# Trim in chunks so the hot path never pays the O(ring) compaction.
_TRIM_SLACK = 256

# Span/trace ids need uniqueness, not unpredictability: a private PRNG
# seeded from os.urandom once avoids a syscall per id (two per span, on
# every served request).
_id_rng = random.Random(int.from_bytes(os.urandom(16), "big"))
_id_bits = _id_rng.getrandbits  # C-implemented, atomic under the GIL


def _hex_id(nbytes: int) -> str:
    return f"{_id_bits(nbytes * 8):0{nbytes * 2}x}"


def format_traceparent(trace_id: str, span_id: str) -> str:
    return f"00-{trace_id}-{span_id}-01"


def parse_traceparent(value: Optional[str]) -> Optional[Tuple[str, str]]:
    """`00-<32hex>-<16hex>-<2hex>` -> (trace_id, parent_span_id) or None."""
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, _flags = parts
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if int(trace_id, 16) == 0 or int(span_id, 16) == 0:
        return None
    return trace_id, span_id


class Span:
    """One timed unit of work inside a trace.

    Also its own context manager (enter publishes it as the current span
    and registers with the collector; exit stamps the end time, restores
    the previous current span, and notifies the collector) — one object
    per span on the request hot path, no separate guard wrapper.
    """

    __slots__ = (
        "trace_id", "span_id", "parent_id", "name",
        "start_s", "end_s", "attributes", "_token", "_has_child", "_keep",
    )

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str], name: str,
                 attributes: Optional[Dict[str, object]] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start_s = time.monotonic()
        self.end_s: Optional[float] = None
        self.attributes: Dict[str, object] = (
            attributes if attributes is not None else {}
        )
        self._has_child = False
        self._keep = False

    def keep_trace(self) -> None:
        """Force this span into the ring even if it stays childless
        (callers mark error responses and other must-keep requests)."""
        self._keep = True

    def set_attribute(self, key: str, value) -> None:
        self.attributes[key] = value

    @property
    def duration_s(self) -> float:
        end = self.end_s if self.end_s is not None else time.monotonic()
        return end - self.start_s

    @property
    def traceparent(self) -> str:
        return format_traceparent(self.trace_id, self.span_id)

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start_s": self.start_s,
            "duration_ms": round(self.duration_s * 1000.0, 3),
            "attributes": dict(self.attributes),
        }

    def __enter__(self) -> "Span":
        self._token = _current.set(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.attributes["error"] = repr(exc)
            self._keep = True
        self.end_s = time.monotonic()
        _current.reset(self._token)
        # Childless LOCAL roots are dropped: a warm cache-hit trace is a
        # single span whose only facts (latency, status) the histograms
        # already carry, and such requests dominate traffic — retaining
        # them would just churn the ring. Anything connected (a child, a
        # parent here or in another process) or marked must-keep lands in
        # the ring. Inlined _COLLECTOR.span_ended: this runs once per
        # served request, where an extra call frame is measurable.
        if self._has_child or self.parent_id is not None or self._keep:
            done = _COLLECTOR._done
            done.append(self)
            if len(done) > _COLLECTOR._cap:
                _COLLECTOR._trim()
        return False


class _NullSpan:
    """Absorbs the Span API when telemetry is off or no trace is active."""

    __slots__ = ()
    trace_id = None
    span_id = None
    parent_id = None
    traceparent = None

    def set_attribute(self, key: str, value) -> None:
        pass

    def keep_trace(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()

_current: "contextvars.ContextVar[Optional[Span]]" = contextvars.ContextVar(
    "repro_obs_current_span", default=None
)


class TraceCollector:
    """Bounded ring of finished spans, grouped into traces at read time.

    `span_ended` is the only hot-path entry point: one lock, one deque
    append. Everything trace-shaped (grouping, ordering, limits) runs at
    `/debug/traces` scrape time over a snapshot.
    """

    def __init__(self, max_spans: int = _MAX_SPANS):
        self._mu = threading.Lock()  # guards trims, not appends
        self._max = max_spans
        self._cap = max_spans + _TRIM_SLACK
        self._done: List[Span] = []

    def span_ended(self, span: Span) -> None:
        # list.append is a single C call — atomic under the GIL, so the
        # per-span hot path takes no lock. Only the (rare, chunked) trim
        # serializes; appends racing a trim land after the slice and
        # survive it. (`Span.__exit__` inlines this body.)
        done = self._done
        done.append(span)
        if len(done) > self._cap:
            self._trim()

    def _trim(self) -> None:
        with self._mu:
            excess = len(self._done) - self._max
            if excess > 0:
                del self._done[:excess]

    def _snapshot(self) -> List[Span]:
        return list(self._done)[-self._max:]

    def traces(self, limit: int = 20) -> List[List[Span]]:
        """Most-recently-finished-first traces (spans in end order).

        A trace's recency is its LAST finished span, so the trace still
        being appended to ranks first. Spans evicted by the ring bound
        simply drop out of their trace (oldest requests first).
        """
        snap = self._snapshot()
        order: List[str] = []
        wanted = set()
        for s in reversed(snap):
            if s.trace_id not in wanted:
                wanted.add(s.trace_id)
                order.append(s.trace_id)
                if len(order) == limit:
                    break
        groups: Dict[str, List[Span]] = {tid: [] for tid in order}
        for s in snap:
            if s.trace_id in wanted:
                groups[s.trace_id].append(s)
        return [groups[tid] for tid in order]

    def find(self, trace_id: str) -> Optional[List[Span]]:
        spans = [s for s in self._snapshot() if s.trace_id == trace_id]
        return spans or None

    def clear(self) -> None:
        with self._mu:
            self._done.clear()


_COLLECTOR = TraceCollector()


def collector() -> TraceCollector:
    return _COLLECTOR


def current_span() -> Optional[Span]:
    return _current.get()


def current_traceparent() -> Optional[str]:
    span = _current.get()
    return span.traceparent if span is not None else None


def root_span(name: str, traceparent: Optional[str] = None, **attributes):
    """Open a trace root (HTTP layer only).

    With a valid incoming `traceparent` the new span joins that trace as
    a child of the remote span; otherwise a fresh trace id is minted.
    """
    if not _state.enabled:
        return _NULL
    parsed = parse_traceparent(traceparent)
    if parsed is not None:
        return Span(parsed[0], _hex_id(8), parsed[1], name, attributes)
    # fresh trace: mint trace id + span id with one RNG draw / one format
    ids = f"{_id_bits(192):048x}"
    return Span(ids[:32], ids[32:], None, name, attributes)


def span(name: str, **attributes):
    """Open a child of the current span; NO-OP without an active trace."""
    if not _state.enabled:
        return _NULL
    parent = _current.get()
    if parent is None:
        return _NULL
    parent._has_child = True  # the parent's trace is now worth retaining
    return Span(parent.trace_id, _hex_id(8), parent.span_id, name, attributes)


def trace_tree(spans: List[Span]) -> dict:
    """Span list -> nested JSON tree (children sorted by start time).

    Spans whose parent is not in the list (e.g. the parent lives in the
    client process) become roots. A single synthetic root wraps multiple
    roots so the result is always one tree.
    """
    by_id = {s.span_id: s.to_dict() for s in spans}
    for node in by_id.values():
        node["children"] = []
    roots = []
    for s in spans:
        node = by_id[s.span_id]
        parent = by_id.get(s.parent_id) if s.parent_id else None
        if parent is not None:
            parent["children"].append(node)
        else:
            roots.append(node)
    for node in by_id.values():
        node["children"].sort(key=lambda c: c["start_s"])
    roots.sort(key=lambda c: c["start_s"])
    if len(roots) == 1:
        return roots[0]
    return {
        "trace_id": spans[0].trace_id if spans else None,
        "name": "(multiple roots)",
        "children": roots,
    }
