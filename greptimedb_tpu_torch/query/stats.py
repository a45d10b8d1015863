"""Per-query execution statistics (the JAX package's query/stats.py).

Execution sites record stage metrics into a context-local collector:
`with collect() as s: ...` activates one around a query, and `add`,
`note` and `timed` record into it. The relational layer records the
join's host time (`join_ms`) and output rows (`join_rows`) here.

Collection is contextvar-based, so concurrent server threads never mix
stats, and every record call is a no-op when no collector is active
(one ContextVar.get on the hot path)."""

from __future__ import annotations

import contextlib
import contextvars
import time

_current: contextvars.ContextVar = contextvars.ContextVar(
    "query_exec_stats", default=None
)


class ExecStats:
    def __init__(self):
        self.counters: dict[str, float] = {}
        self.notes: dict[str, str] = {}

    def add(self, key: str, n: float = 1):
        self.counters[key] = self.counters.get(key, 0) + n

    def note(self, key: str, value: str):
        self.notes[key] = value

    def lines(self) -> list[str]:
        out = []
        for k in sorted(set(self.counters) | set(self.notes)):
            if k in self.notes:
                out.append(f"    {k}: {self.notes[k]}")
            else:
                v = self.counters[k]
                s = f"{v:.3f}" if isinstance(v, float) and v % 1 else str(int(v))
                out.append(f"    {k}: {s}")
        return out


@contextlib.contextmanager
def collect():
    stats = ExecStats()
    token = _current.set(stats)
    try:
        yield stats
    finally:
        _current.reset(token)


def active() -> ExecStats | None:
    return _current.get()


def add(key: str, n: float = 1):
    s = _current.get()
    if s is not None:
        s.add(key, n)


def note(key: str, value: str):
    s = _current.get()
    if s is not None:
        s.note(key, value)


@contextlib.contextmanager
def timed(key: str):
    """Accumulate wall ms under `key` (no-op when not collecting)."""
    s = _current.get()
    if s is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        s.add(key, (time.perf_counter() - t0) * 1000.0)
