"""Distributed-tracing spans with device-time attribution.

Capability counterpart of the reference's tracing stack
(GreptimeDB's src/common/telemetry/src/logging.rs:22-67 tracing
subscriber + OTLP export, src/common/telemetry/src/tracing_context.rs
W3C context propagation): timed spans carrying a trace id, parent links
via a context var (so nested spans form a tree across threads when the
context is passed), inbound `traceparent` parsing on every wire the
system speaks (HTTP header, Flight ticket field, DoPut app_metadata),
and an in-memory ring of finished traces served by the HTTP API
(/v1/traces) + `information_schema.traces` for inspection without an
external collector.

Cross-process stitching: a datanode executing a shipped partial plan
collects the spans it produced (`export_spans`) and ships them back in
the Arrow response metadata (`gtdb:spans`); the frontend ingests them
(`ingest_spans`) so ONE trace in its ring covers the whole distributed
query — frontend sched/plan/fan-out spans and per-datanode scan/device
spans under a shared trace_id.

Sampling is TAIL-BASED: every span records while in flight, and the
keep/drop decision happens when the process-local root span finishes —
error traces, slow traces (>= slow_ms) and explicitly marked traces
(`mark_keep`) are ALWAYS kept; the rest keep with probability
`sample_ratio`. `[tracing]` TOML knobs: enable, sample_ratio, capacity
(trace ring size, 0 = unbounded — bench.py refuses that), slow_ms.

Timestamps: `start_ms` is epoch milliseconds (display/correlation);
durations are computed on the MONOTONIC clock (an NTP slew must never
produce negative or absurd span durations — gtlint GT011).
"""

from __future__ import annotations

import contextlib
import contextvars
import random
import secrets

import time
from dataclasses import dataclass, field

from greptimedb_tpu_torch import concurrency

_current_span: contextvars.ContextVar["Span | None"] = (
    contextvars.ContextVar("gtpu_span", default=None)
)

# finished spans additionally append here when a collector is active
# (export_spans) — the cross-process export used by dist/merge.py and
# the EXPLAIN ANALYZE span-tree rendering
_collector: contextvars.ContextVar["list | None"] = (
    contextvars.ContextVar("gtpu_span_collector", default=None)
)

_MAX_TRACES = 256
_MAX_EXPORT_SPANS = 128


class TracingConfig:
    """`[tracing]` options (config.py DEFAULTS documents each knob)."""

    __slots__ = ("enabled", "sample_ratio", "capacity", "slow_ms")

    def __init__(self, *, enable: bool = True, sample_ratio: float = 1.0,
                 capacity: int = _MAX_TRACES,
                 slow_ms: float = 5000.0):
        self.enabled = bool(enable)
        self.sample_ratio = min(1.0, max(0.0, float(sample_ratio)))
        self.capacity = int(capacity)
        self.slow_ms = float(slow_ms)


_config = TracingConfig()


def configure(options: dict | None):
    """Apply the `[tracing]` TOML section to this process."""
    global _config
    o = options or {}
    _config = TracingConfig(
        enable=o.get("enable", True),
        sample_ratio=o.get("sample_ratio", 1.0),
        capacity=o.get("capacity", _MAX_TRACES),
        slow_ms=o.get("slow_ms", 5000.0),
    )
    global_traces.set_cap(_config.capacity)
    return _config


def enabled() -> bool:
    return _config.enabled


def ring_unbounded() -> bool:
    """True when the trace ring has no capacity bound (capacity <= 0):
    a misconfiguration bench.py refuses to measure under."""
    return global_traces.cap <= 0


@dataclass
class Span:
    trace_id: str
    span_id: str
    parent_id: str | None
    name: str
    start_ms: float
    end_ms: float | None = None
    attributes: dict = field(default_factory=dict)
    # True ONLY on the placeholder parent start_remote builds from a
    # traceparent: a span whose parent carries this flag is this
    # process's LOCAL ROOT for the tail-sampling decision (the flag
    # deliberately does not propagate to descendants — a child exit
    # must never roll the sampling dice while the root is in flight)
    remote: bool = False

    def to_json(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start_ms": round(self.start_ms, 3),
            "duration_ms": (
                None if self.end_ms is None
                else round(self.end_ms - self.start_ms, 3)
            ),
            # copied: a reader may serialize while __exit__ mutates
            "attributes": dict(self.attributes),
        }


class _TraceStore:
    """Bounded ring of traces (newest kept). Spans record at START so
    /v1/traces shows in-flight work; the tail-sampling decision at the
    local root's finish either confirms the trace or drops it."""

    def __init__(self, cap: int = _MAX_TRACES):
        self._lock = concurrency.Lock()
        self._spans: dict[str, list[Span]] = {}
        self._order: list[str] = []
        self._kept: set[str] = set()
        # local roots currently in flight per trace (a client may send
        # one traceparent on several concurrent requests): a sampled-
        # out sibling must never drop a trace another root is still
        # writing — the LAST root out makes the final drop decision
        self._active: dict[str, int] = {}
        self.cap = cap
        self.evicted_traces = 0
        from greptimedb_tpu_torch.telemetry import memory as _memory

        _memory.register_pool(
            "trace_ring", "host", self, stats=_TraceStore._mem_stats
        )

    # a client/proxy bug resending one traceparent forever must not
    # grow a single trace unboundedly
    MAX_SPANS_PER_TRACE = 512

    # flat per-span host-byte estimate for the memory accountant (a
    # Span dataclass + ids + a small attribute dict; exact accounting
    # would walk every attribute on every scrape)
    SPAN_EST_BYTES = 512

    def _mem_stats(self) -> dict:
        with self._lock:
            n_spans = sum(len(s) for s in self._spans.values())
            return {
                "bytes": n_spans * self.SPAN_EST_BYTES,
                "entries": n_spans,
                "max_entries": max(self.cap, 0)
                * self.MAX_SPANS_PER_TRACE,
                "evictions": self.evicted_traces,
            }

    def set_cap(self, cap: int):
        with self._lock:
            self.cap = int(cap)
            self._evict_locked()

    def _evict_locked(self):
        if self.cap <= 0:
            return  # unbounded (bench.py refuses to run like this)
        while len(self._order) > self.cap:
            victim = self._order.pop(0)
            self._spans.pop(victim, None)
            self._kept.discard(victim)
            self.evicted_traces += 1

    def record(self, span: Span):
        with self._lock:
            if span.trace_id not in self._spans:
                self._spans[span.trace_id] = []
                self._order.append(span.trace_id)
                self._evict_locked()
            spans = self._spans[span.trace_id]
            if len(spans) < self.MAX_SPANS_PER_TRACE:
                spans.append(span)

    def enter_root(self, trace_id: str):
        with self._lock:
            self._active[trace_id] = self._active.get(trace_id, 0) + 1

    def decide(self, root: Span):
        """Tail-sampling decision at a local root's finish: error spans
        anywhere in the trace, slow roots, and marked traces always
        keep; otherwise keep with probability sample_ratio. A drop only
        happens when NO other local root of the trace is in flight."""
        tid = root.trace_id
        with self._lock:
            remaining = self._active.get(tid, 1) - 1
            if remaining > 0:
                self._active[tid] = remaining
            else:
                self._active.pop(tid, None)
            if tid in self._kept:
                return
            spans = self._spans.get(tid)
            if spans is None:
                return
            keep = False
            for s in spans:
                if "error" in s.attributes or s.attributes.get("keep"):
                    keep = True
                    break
            if not keep and root.end_ms is not None and (
                    root.end_ms - root.start_ms) >= _config.slow_ms:
                keep = True
            if not keep:
                ratio = _config.sample_ratio
                keep = ratio >= 1.0 or random.random() < ratio
            if keep:
                self._kept.add(tid)
            elif remaining <= 0:
                # last root out and nothing remarkable: drop. With
                # siblings still writing, defer — the last one decides
                # over the COMPLETE span set (an error recorded later
                # must still be able to keep the trace).
                self._spans.pop(tid, None)
                self._kept.discard(tid)
                try:
                    self._order.remove(tid)
                except ValueError:
                    pass

    def ingest(self, span_dicts: list, limit: int = _MAX_EXPORT_SPANS):
        """Record spans exported by ANOTHER process (gtdb:spans
        metadata) into this ring so the stitched trace lives in one
        place. No sampling decision — the local root's decision covers
        the whole trace."""
        for doc in span_dicts[:limit]:
            try:
                dur = doc.get("duration_ms")
                start = float(doc.get("start_ms") or 0.0)
                self.record(Span(
                    trace_id=str(doc["trace_id"]),
                    span_id=str(doc.get("span_id") or ""),
                    parent_id=doc.get("parent_id"),
                    name=str(doc.get("name") or "remote"),
                    start_ms=start,
                    end_ms=None if dur is None else start + float(dur),
                    attributes=dict(doc.get("attributes") or {}),
                ))
            except (KeyError, TypeError, ValueError):
                continue  # a malformed remote span must not kill a query

    def traces(self, limit: int = 50) -> list[dict]:
        with self._lock:
            out = []
            for tid in reversed(self._order[-limit:]):
                spans = self._spans.get(tid, [])
                out.append({
                    "trace_id": tid,
                    "spans": [s.to_json() for s in spans],
                })
            return out

    def trace(self, trace_id: str) -> list[dict]:
        with self._lock:
            return [s.to_json() for s in self._spans.get(trace_id, [])]

    def clear(self):
        with self._lock:
            self._spans.clear()
            self._order.clear()
            self._kept.clear()
            self._active.clear()


global_traces = _TraceStore()


# span/trace ids need uniqueness, not cryptographic strength — and
# they are on the hot path of every traced statement. A per-process
# PRNG seeded from the CSPRNG is ~20x faster than secrets.token_hex
# (single C call; the GIL makes getrandbits atomic in CPython).
_idgen = random.Random(secrets.randbits(64))


def _new_id(nbytes: int) -> str:
    return f"{_idgen.getrandbits(nbytes * 8):0{nbytes * 2}x}"


class span:
    """Context manager: `with tracing.span("query.plan", sql=...)`.
    Nests under the current span; starts a new trace at the root."""

    __slots__ = ("name", "attributes", "_parent", "_span", "_token",
                 "_mono0", "_local_root")

    def __init__(self, name: str, _parent: Span | None = None,
                 **attributes):
        self.name = name
        self.attributes = attributes
        self._parent = _parent
        self._span: Span | None = None
        self._token = None
        self._mono0 = 0.0
        self._local_root = False

    def __enter__(self) -> Span:
        if not _config.enabled:
            # inert span: no context, no ring, no ids — zero footprint
            self._span = Span("", "", None, self.name, 0.0,
                              attributes=dict(self.attributes))
            return self._span
        parent = (self._parent if self._parent is not None
                  else _current_span.get())
        self._local_root = parent is None or parent.remote
        self._span = Span(
            trace_id=(parent.trace_id if parent else _new_id(16)),
            span_id=_new_id(8),
            parent_id=parent.span_id if parent else None,
            name=self.name,
            # epoch-ms START timestamp for display/correlation; the
            # duration below comes from the monotonic clock (GT011)
            start_ms=time.time() * 1000.0,
            attributes=dict(self.attributes),
        )
        self._mono0 = time.monotonic()
        self._token = _current_span.set(self._span)
        if self._local_root:
            global_traces.enter_root(self._span.trace_id)
        # recorded at START: /v1/traces shows in-flight spans (duration
        # null) and a span is never missing just because its exit races
        # a reader; __exit__ finalizes the same object in place
        global_traces.record(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb):
        sp = self._span
        if self._token is None:
            return False  # disabled at __enter__ time
        sp.end_ms = sp.start_ms + (time.monotonic() - self._mono0) * 1000.0
        if exc is not None:
            sp.attributes["error"] = f"{type(exc).__name__}: {exc}"
        _current_span.reset(self._token)
        self._token = None
        col = _collector.get()
        if col is not None and len(col) < _MAX_EXPORT_SPANS:
            col.append(sp)
        if self._local_root:
            # this process's outermost span: tail-sampling decision
            global_traces.decide(sp)
        return False


class _noop_span:
    """Context manager yielding an inert Span (attribute writes land
    nowhere); the zero-cost path for child_span with no active trace."""

    __slots__ = ("_span",)

    def __init__(self, name: str, attributes: dict):
        self._span = Span("", "", None, name, 0.0,
                          attributes=dict(attributes))

    def __enter__(self) -> Span:
        return self._span

    def __exit__(self, exc_type, exc, tb):
        return False


def child_span(name: str, _parent: Span | None = None, **attributes):
    """A span ONLY when it can join an existing trace: hot-path
    internals (WAL append, flush, scans, device calls) use this so
    background work with no request context never floods the ring with
    single-span root traces."""
    if not _config.enabled:
        return _noop_span(name, attributes)
    parent = _parent if _parent is not None else _current_span.get()
    if parent is None or not parent.trace_id:
        # no trace to join (or an inert parent from a disabled scope)
        return _noop_span(name, attributes)
    return span(name, _parent=parent, **attributes)


def event_span(name: str, duration_ms: float, **attributes):
    """Record an already-measured stage as a completed child span (the
    dist-query stage clock and recovery stage recorder re-publish the
    SAME numbers they export as gtpu_*_stage_ms metrics, so traces and
    metrics agree). No-op outside an active trace."""
    if not _config.enabled:
        return
    parent = _current_span.get()
    if parent is None:
        return
    now = time.time() * 1000.0
    dur = max(float(duration_ms), 0.0)
    sp = Span(
        trace_id=parent.trace_id, span_id=_new_id(8),
        parent_id=parent.span_id, name=name,
        start_ms=now - dur, end_ms=now,
        attributes=dict(attributes),
    )
    global_traces.record(sp)
    col = _collector.get()
    if col is not None and len(col) < _MAX_EXPORT_SPANS:
        col.append(sp)


def current_span() -> Span | None:
    return _current_span.get()


def current_trace_id() -> str | None:
    sp = _current_span.get()
    return sp.trace_id if sp and sp.trace_id else None


def set_attr(**attributes):
    """Attach attributes to the current span (e.g. the mesh planner's
    replicate-vs-shard decision); no-op outside a span."""
    sp = _current_span.get()
    if sp is not None:
        sp.attributes.update(attributes)


def mark_keep():
    """Force-keep the current trace through tail sampling (shed and
    deadline-expired queries stay inspectable at any sample_ratio)."""
    sp = _current_span.get()
    if sp is not None:
        sp.attributes["keep"] = True


def traceparent() -> str | None:
    """W3C `traceparent` of the current span — what every outbound wire
    (Flight ticket field, DoPut app_metadata, HTTP header) carries so
    the receiving process parents its spans under ours."""
    sp = _current_span.get()
    if sp is None or not sp.trace_id:
        return None
    return f"00-{sp.trace_id}-{sp.span_id}-01"


import re as _re

# strict W3C form: lowercase hex only. The ids are CLIENT-controlled
# and get spliced into hand-built ticket JSON (dist_query.py) and
# stripped by a lowercase-hex regex on the datanode (merge.py) — a
# looser accept here would let a quote-bearing "trace id" corrupt
# tickets or an uppercase one churn the datanode decode memo.
_TRACEPARENT_RE = _re.compile(
    r"00-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}\Z"
)


def start_remote(traceparent: str | None, name: str, **attributes):
    """Span continuing a W3C `traceparent: 00-<trace>-<parent>-<flags>`
    header when present and well-formed (strict lowercase hex); a
    fresh root otherwise. Either way the span is this process's local
    root for the tail-sampling decision."""
    parent = None
    if traceparent:
        m = _TRACEPARENT_RE.match(traceparent.strip())
        if m and m.group(1) != "0" * 32:
            parent = Span(
                trace_id=m.group(1), span_id=m.group(2),
                parent_id=None, name="remote-parent", start_ms=0.0,
                remote=True,
            )
    return span(name, _parent=parent, **attributes)


@contextlib.contextmanager
def export_spans():
    """Collect every span FINISHED inside this context (the list the
    datanode ships back as `gtdb:spans`, and EXPLAIN ANALYZE renders
    inline). Yields the live list; read it after the block."""
    spans: list[Span] = []
    token = _collector.set(spans)
    try:
        yield spans
    finally:
        _collector.reset(token)


def ingest_spans(span_dicts: list | None):
    """Record spans exported by another process into the local ring."""
    if span_dicts:
        global_traces.ingest(span_dicts)


def render_tree(span_dicts: list[dict]) -> list[str]:
    """Indented parent->child rendering of one trace's span dicts (the
    EXPLAIN ANALYZE inline view). Spans whose parent is not in the set
    (remote parents) render as roots; children sort by start time."""
    by_id = {s["span_id"]: s for s in span_dicts if s.get("span_id")}
    children: dict[str | None, list[dict]] = {}
    roots: list[dict] = []
    for s in span_dicts:
        pid = s.get("parent_id")
        if pid in by_id and pid != s.get("span_id"):
            children.setdefault(pid, []).append(s)
        else:
            roots.append(s)

    def fmt(s: dict) -> str:
        dur = s.get("duration_ms")
        dur_s = "..." if dur is None else f"{dur:.3f}ms"
        attrs = {
            k: v for k, v in (s.get("attributes") or {}).items()
            if k != "keep"
        }
        extra = ""
        if attrs:
            inner = ", ".join(f"{k}={v}" for k, v in sorted(
                attrs.items(), key=lambda kv: kv[0]
            ))
            extra = f" {{{inner}}}"
        return f"{s['name']} {dur_s}{extra}"

    lines: list[str] = []

    def walk(s: dict, depth: int):
        lines.append("  " * depth + fmt(s))
        for c in sorted(children.get(s.get("span_id"), []),
                        key=lambda x: x.get("start_ms") or 0.0):
            walk(c, depth + 1)

    for r in sorted(roots, key=lambda x: x.get("start_ms") or 0.0):
        walk(r, 0)
    return lines
