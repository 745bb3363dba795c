"""Request tracing for the serving gateway and the control plane (the
port's copy of ``kubeflow_rm_tpu/controlplane/tracing.py``).

W3C-traceparent contexts (trace id, span id, parent id) carried across
an HTTP hop (``parse_traceparent`` of the ``traceparent`` header) and a
thread (a thread-local current span that ``start_span`` parents new
spans on); ``record_span`` stamps an interval measured elsewhere (the
gateway's drain thread, submit to done).

Across the control plane's asynchronous hops (write → watch → work
queue → reconcile) the context rides the object: ``stamp`` writes it
under ``TRACE_ANNOTATION`` at create, ``context_of`` reads it back off a
watch event, and ``attach`` adopts it on another thread.

Spans land in one ``SpanCollector`` per process: a bounded ring (the
lock held for an append only) plus tail-sampled slow-trace retention —
when a ROOT span ends slower than the threshold the whole trace is
copied aside before the ring can evict it. ``critical_path`` reduces a
trace to its blocking chain with per-hop self time; the segments
partition the root's interval, so the self times sum to its duration.
``merge_spans`` unions the exports of several processes (each shard's
``/debug/traces``).

Tracing is off by default, and then ``start_span`` returns one shared
no-op context manager after a boolean check.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from kubeflow_rm_tpu_torch.analysis.lockgraph import make_lock

_tls = threading.local()

#: the annotation a persisted object carries its creating request's
#: traceparent under (watch consumers resume the trace from it)
TRACE_ANNOTATION = "tpu.kubeflow.org/trace"
#: the HTTP header a request carries its caller's context in (W3C trace
#: context, version 00, sampled flag 01)
TRACE_HEADER = "traceparent"


def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


class SpanContext:
    """Just enough identity to parent a remote or later child."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def to_traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"


class Span:
    """One timed operation; ``start``/``end`` are epoch seconds."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "kind",
                 "start", "end", "attrs", "process")

    def __init__(self, name: str, *, trace_id: str, span_id: str,
                 parent_id: str | None, kind: str = "internal",
                 start: float | None = None, attrs: dict | None = None,
                 process: str | None = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.kind = kind
        self.start = time.time() if start is None else start
        self.end: float | None = None
        self.attrs = attrs or {}
        # the emitting process (a shard's name), for merged traces
        self.process = _process_name if process is None else process

    def to_traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = value

    def duration_ms(self) -> float | None:
        if self.end is None:
            return None
        return (self.end - self.start) * 1e3

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id, "span_id": self.span_id,
            "parent_id": self.parent_id, "name": self.name,
            "kind": self.kind, "start": self.start, "end": self.end,
            "duration_ms": None if self.end is None
            else round((self.end - self.start) * 1e3, 3),
            "attrs": self.attrs, "process": self.process,
        }


def parse_traceparent(header: str | None) -> SpanContext | None:
    """``00-<32 hex>-<16 hex>-<2 hex>`` → SpanContext, else None (a
    malformed header is dropped, never raised on)."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) != 4:
        return None
    _, trace_id, span_id, _ = parts
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    return SpanContext(trace_id, span_id)


class SpanCollector:
    """The process's span sink.

    ``add`` appends to a bounded ring under a lock held only for the
    append. When a ROOT span (no parent) finishes slower than
    ``slow_threshold_s`` — the tail-sampling decision, made when the
    outcome is known — the whole trace is copied into the slow store,
    itself bounded to the ``slow_keep`` slowest traces.
    """

    def __init__(self, capacity: int = 8192, *,
                 slow_threshold_s: float = 0.25, slow_keep: int = 32):
        self._lock = make_lock("tracing.collector")
        self._ring: deque[Span] = deque(maxlen=capacity)
        self.slow_threshold_s = slow_threshold_s
        self.slow_keep = slow_keep
        # trace_id -> (root duration in s, [span dicts])
        self._slow: dict[str, tuple[float, list[dict]]] = {}
        self.dropped = 0
        self.added = 0

    def add(self, span: Span) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(span)
            self.added += 1
            if (span.parent_id is None and span.end is not None
                    and span.end - span.start >= self.slow_threshold_s):
                self._retain_slow_locked(span)

    def _retain_slow_locked(self, root: Span) -> None:
        dur = root.end - root.start
        if len(self._slow) >= self.slow_keep:
            fastest = min(self._slow, key=lambda t: self._slow[t][0])
            if self._slow[fastest][0] >= dur:
                return  # slower traces already retained
            del self._slow[fastest]
        spans = [s.to_dict() for s in self._ring
                 if s.trace_id == root.trace_id]
        self._slow[root.trace_id] = (dur, spans)

    def spans(self) -> list[dict]:
        """Every span held: the ring ∪ the slow store (deduped)."""
        with self._lock:
            out = {(s.trace_id, s.span_id): s.to_dict() for s in self._ring}
            for _, spans in self._slow.values():
                for d in spans:
                    out.setdefault((d["trace_id"], d["span_id"]), d)
        return list(out.values())

    def traces(self) -> dict[str, list[dict]]:
        grouped: dict[str, list[dict]] = {}
        for d in self.spans():
            grouped.setdefault(d["trace_id"], []).append(d)
        for spans in grouped.values():
            spans.sort(key=lambda d: d["start"])
        return grouped

    def get_trace(self, trace_id: str) -> list[dict]:
        return sorted((d for d in self.spans() if d["trace_id"] == trace_id),
                      key=lambda d: d["start"])

    def slow_traces(self) -> list[dict]:
        """The tail-retained traces, slowest first."""
        with self._lock:
            items = sorted(self._slow.items(),
                           key=lambda kv: kv[1][0], reverse=True)
        return [{"trace_id": tid, "duration_ms": round(dur * 1e3, 3),
                 "spans": spans} for tid, (dur, spans) in items]

    def export_json(self) -> str:
        return json.dumps({"spans": self.spans(),
                           "slow": self.slow_traces(),
                           "added": self.added,
                           "dropped": self.dropped})

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._slow.clear()
            self.dropped = 0
            self.added = 0


_collector = SpanCollector()
_enabled = False
_process_name = ""


def collector() -> SpanCollector:
    return _collector


def set_process(name: str) -> None:
    """Tag every span this process emits (shard name); feeds the
    cross-process view in merged traces."""
    global _process_name
    _process_name = name


def process_name() -> str:
    return _process_name


def set_enabled(on: bool) -> None:
    global _enabled
    _enabled = bool(on)


def enabled() -> bool:
    return _enabled


def current_span() -> Span | None:
    return getattr(_tls, "span", None)


def current_context() -> SpanContext | None:
    """The live span's context, for a header or an annotation; None when
    tracing is off or no span is open on this thread."""
    span = getattr(_tls, "span", None) if _enabled else None
    return span.context() if span is not None else None


def current_traceparent() -> str | None:
    ctx = current_context()
    return ctx.to_traceparent() if ctx is not None else None


class _NullSpan:
    __slots__ = ()

    def set_attr(self, key, value):
        pass


class _NullCtx:
    """The disabled fast path: one shared instance."""

    __slots__ = ()

    def __enter__(self):
        return _NULL_SPAN

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()
_NULL_CTX = _NullCtx()


class _SpanCtx:
    """One live span: the thread's current span while open, collected on
    exit (with the error, if one ended it)."""

    __slots__ = ("span", "_prev")

    def __init__(self, span: Span):
        self.span = span
        self._prev = None

    def __enter__(self) -> Span:
        self._prev = getattr(_tls, "span", None)
        _tls.span = self.span
        return self.span

    def __exit__(self, exc_type, exc, tb):
        _tls.span = self._prev
        self.span.end = time.time()
        if exc_type is not None:
            self.span.attrs["error"] = f"{exc_type.__name__}: {exc}"
        _collector.add(self.span)
        return False


def _ids_under(parent) -> tuple[str, str | None]:
    if isinstance(parent, str):
        parent = parse_traceparent(parent)
    if parent is None:
        return new_trace_id(), None
    return parent.trace_id, parent.span_id


def start_span(name: str, *, kind: str = "internal",
               parent: SpanContext | Span | str | None = None,
               attrs: dict | None = None):
    """Open a span as a context manager, parented on ``parent`` (a
    context, a span or a traceparent string) or else on the thread's
    current span; a new trace when there is neither."""
    if not _enabled:
        return _NULL_CTX
    if parent is None:
        parent = getattr(_tls, "span", None)
    trace_id, parent_id = _ids_under(parent)
    return _SpanCtx(Span(name, trace_id=trace_id, span_id=new_span_id(),
                         parent_id=parent_id, kind=kind, attrs=attrs))


def start_span_if_active(name: str, *, kind: str = "internal",
                         attrs: dict | None = None):
    """A child span only when a trace is in flight on this thread, so
    work with no causal origin mints no orphan trace."""
    if not _enabled or getattr(_tls, "span", None) is None:
        return _NULL_CTX
    return start_span(name, kind=kind, attrs=attrs)


def record_span(name: str, *, start: float, end: float,
                parent: SpanContext | Span | str | None = None,
                kind: str = "internal",
                attrs: dict | None = None) -> SpanContext | None:
    """Record a span whose interval was measured elsewhere. Returns its
    context (None when tracing is off)."""
    if not _enabled:
        return None
    trace_id, parent_id = _ids_under(parent)
    span = Span(name, trace_id=trace_id, span_id=new_span_id(),
                parent_id=parent_id, kind=kind, start=start, attrs=attrs)
    span.end = end
    _collector.add(span)
    return span.context()


class attach:
    """Adopt a remote context as the thread-local current WITHOUT
    opening a span — the workqueue worker uses this so annotation
    stamping inside the reconcile inherits the right trace even before
    the reconcile span opens."""

    __slots__ = ("_ctx", "_prev")

    def __init__(self, ctx: SpanContext | str | None):
        if isinstance(ctx, str):
            ctx = parse_traceparent(ctx)
        self._ctx = ctx
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_tls, "span", None)
        if self._ctx is not None:
            # a context is not a Span; wrap it in an uncollected stub
            # that only exists to parent children
            _tls.span = Span("(attached)", trace_id=self._ctx.trace_id,
                             span_id=self._ctx.span_id, parent_id=None)
        return self._ctx

    def __exit__(self, *exc):
        _tls.span = self._prev
        return False


# ---------------------------------------------------------------------------
# annotation plumbing (async causality across watch/workqueue hops)
# ---------------------------------------------------------------------------

def stamp(obj: dict) -> None:
    """Write the live context into ``metadata.annotations`` of an
    object about to be persisted, so watch consumers can resume the
    trace. No-op when tracing is off or no span is open."""
    if not _enabled:
        return
    tp = current_traceparent()
    if tp is None:
        return
    md = obj.setdefault("metadata", {})
    ann = md.get("annotations")
    if ann is None:
        ann = md["annotations"] = {}
    # first cause wins: an object stamped at creation keeps that
    # context for life — later writers extend the SAME trace via their
    # own spans, they don't rewrite history
    ann.setdefault(TRACE_ANNOTATION, tp)


def context_of(obj: dict | None) -> SpanContext | None:
    """Read a stamped context back off an object (watch event)."""
    if not obj:
        return None
    ann = (obj.get("metadata") or {}).get("annotations") or {}
    return parse_traceparent(ann.get(TRACE_ANNOTATION))


# ---------------------------------------------------------------------------
# critical path and the cross-process merge
# ---------------------------------------------------------------------------

def critical_path(spans: list[dict]) -> list[dict]:
    """Reduce one trace's spans to the ordered blocking chain.

    Walks the span tree backwards from the root's end: at each cursor
    position the blocking span is the deepest descendant still running;
    the gap back to that child's start is charged to the parent as SELF
    time. Children are clipped to their parent, so the segments
    partition the root's interval and ``sum(self_ms)`` is the root's
    duration. A span whose parent is missing (a shard that could not be
    read) counts as a root; the earliest root is the trace's.

    Returns hops ordered by first appearance on the path:
    ``{name, span_id, process, kind, self_ms, start, end}``.
    """
    closed = [dict(s) for s in spans if s.get("end") is not None]
    if not closed:
        return []
    by_id = {s["span_id"]: s for s in closed}
    children: dict[str, list[dict]] = {}
    roots = []
    for s in closed:
        pid = s.get("parent_id")
        if pid and pid in by_id:
            children.setdefault(pid, []).append(s)
        else:
            roots.append(s)
    root = min(roots, key=lambda s: s["start"])

    # (span, segment start, segment end) self-time segments, collected
    # by a backwards walk; recursion depth is the tree's depth
    segments: list[tuple[dict, float, float]] = []

    def walk(span: dict, start_cut: float, end_cut: float) -> None:
        cursor = end_cut
        kids = [c for c in children.get(span["span_id"], [])
                if c["start"] < end_cut and c["end"] > start_cut]
        while kids and cursor > start_cut:
            live = [c for c in kids if c["start"] < cursor]
            if not live:
                break
            # the child whose (clipped) end reaches closest to the
            # cursor is what the parent was blocked on
            c = max(live, key=lambda c: min(c["end"], cursor))
            c_end = min(c["end"], cursor)
            c_start = max(c["start"], start_cut)
            if c_end < cursor:
                segments.append((span, c_end, cursor))
            walk(c, c_start, c_end)
            cursor = c_start
            kids.remove(c)
        if cursor > start_cut:
            segments.append((span, start_cut, cursor))

    walk(root, root["start"], root["end"])

    agg: dict[str, dict] = {}
    for span, s0, s1 in segments:
        hop = agg.get(span["span_id"])
        if hop is None:
            hop = agg[span["span_id"]] = {
                "name": span["name"], "span_id": span["span_id"],
                "process": span.get("process", ""),
                "kind": span.get("kind", "internal"), "self_ms": 0.0,
                "start": span["start"], "end": span["end"], "_first": s0,
            }
        hop["self_ms"] += (s1 - s0) * 1e3
        hop["_first"] = min(hop["_first"], s0)
    hops = sorted(agg.values(), key=lambda h: h["_first"])
    for h in hops:
        del h["_first"]
        h["self_ms"] = round(h["self_ms"], 3)
    return hops


def merge_spans(*span_lists: list[dict]) -> list[dict]:
    """Union span lists from several collectors (processes), deduped on
    (trace_id, span_id) and ordered by start."""
    out: dict[tuple[str, str], dict] = {}
    for spans in span_lists:
        for d in spans or []:
            out.setdefault((d["trace_id"], d["span_id"]), d)
    return sorted(out.values(), key=lambda d: d["start"])
