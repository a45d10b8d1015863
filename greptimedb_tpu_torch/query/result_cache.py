"""The result cache: finished query results served at the frontend (the
JAX package's query/result_cache.py).

Where the session registry (query/sessions.py) keeps device result
buffers and the grid caches keep input state on the card, this cache
keeps the finished host result of a statement and serves a repeated poll
without running anything on the card or reading anything back.

Keyed on (database, table id, table name, normalised-plan fingerprint)
and validated against the table's physical version
(catalog/table.Table.physical_version: a write, flush, compaction,
truncate or ALTER changes it). Prepared-statement parameters are
substituted into the text before parsing, so they ride the fingerprint.
Tables with a TTL bypass (their scan window derives from the wall
clock), as do plans with volatile functions (now(), random(), ...) and
EXPLAIN ANALYZE, whose metrics must come from a real execution.

A `since` delta poll is served from the cached full result by a host row
filter on the time-index output column. A miss while `since` is bound
executes the delta (the narrowed device readback) and is not stored:
only full results are.

Bounded by an LRU byte budget. Hits, misses and evictions count in the
process-wide `gtpu_result_cache_*` families; the cache's own tallies
(`hits`, `misses`, `evictions`, `byte_count`, `entry_count`) are what it
reports as the "result_cache" host pool of the memory ledger
(telemetry/memory.py).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np

from greptimedb_tpu_torch import concurrency
from greptimedb_tpu_torch.sql import ast as A
from greptimedb_tpu_torch.telemetry.metrics import global_registry

_HITS = global_registry.counter(
    "gtpu_result_cache_hits_total",
    "frontend result-set cache hits (served without datanode/device)",
)
_MISSES = global_registry.counter(
    "gtpu_result_cache_misses_total",
    "frontend result-set cache misses",
)
_EVICTIONS = global_registry.counter(
    "gtpu_result_cache_evictions_total",
    "frontend result-set cache entries evicted (budget or staleness)",
)
_BYTES = global_registry.gauge(
    "gtpu_result_cache_bytes",
    "bytes held by the frontend result-set cache",
)
_ENTRIES = global_registry.gauge(
    "gtpu_result_cache_entries",
    "entries held by the frontend result-set cache",
)

_DEFAULT_BYTES = 256 * 1024 * 1024

# functions whose value depends on evaluation time or randomness: caching
# the result would freeze them (the planner folds WHERE-clause time bounds
# to concrete ms before the plan gets here, and marks them volatile_bounds)
_VOLATILE_FUNCS = frozenset({
    "now", "current_timestamp", "current_time", "current_date",
    "localtime", "localtimestamp", "random", "rand", "uuid",
})


def _expr_has_volatile(e) -> bool:
    if isinstance(e, A.FuncCall) and e.name.lower() in _VOLATILE_FUNCS:
        return True
    if dataclasses.is_dataclass(e) and not isinstance(e, type):
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            if isinstance(v, A.Expr) and _expr_has_volatile(v):
                return True
            if isinstance(v, (list, tuple)):
                for x in v:
                    if isinstance(x, A.Expr) and _expr_has_volatile(x):
                        return True
                    if (isinstance(x, tuple) and x
                            and isinstance(x[0], A.Expr)
                            and _expr_has_volatile(x[0])):
                        return True
    return False


def plan_volatile(plan) -> bool:
    """True when any expression of the plan depends on evaluation time
    (now(), random(), ... in items, keys, aggregates, range arguments,
    HAVING, ORDER BY or the residual filter)."""
    exprs = [e for e, _ in (plan.items or [])]
    exprs += [e for e, _ in (plan.post_items or [])]
    exprs += [k.expr for k in plan.keys]
    exprs += [a.arg for a in plan.aggs if a.arg is not None]
    exprs += [r.arg for r in plan.range_items if r.arg is not None]
    if plan.having is not None:
        exprs.append(plan.having)
    exprs += [o.expr for o in plan.order_by]
    if plan.scan.residual is not None:
        exprs.append(plan.scan.residual)
    return any(_expr_has_volatile(e) for e in exprs)


def plan_fingerprint(plan) -> str:
    """Deterministic identity of a planned statement: the dataclass repr,
    with the matchers' full regex patterns appended (a re.Pattern's repr
    truncates long patterns)."""
    extra = "".join(str(getattr(m[2], "pattern", ""))
                    for m in plan.scan.matchers or [])
    return repr(plan) + "\x00" + extra


def ts_output_name(plan, table) -> str | None:
    """The time-index output column a `since` filter applies to, or None
    when the projection does not carry it."""
    if plan.kind == "range":
        for e, nm in plan.post_items:
            if isinstance(e, A.Column) and e.name == "__ts":
                return nm
        return None
    if plan.kind == "plain" and table is not None:
        ts = table.ts_name
        for e, nm in plan.items:
            if isinstance(e, A.Column) and e.name == ts:
                return nm
    return None


def filter_since(res, ts_name: str | None, since_ms: int):
    """The rows of `res` whose `ts_name` column is strictly greater than
    the watermark; the whole result when the projection lacks the column
    (without a time column the client cannot be served a delta)."""
    from greptimedb_tpu_torch.query.executor import QueryResult, _slice_result

    if ts_name is None or ts_name not in res.names:
        return res
    col = res.cols[res.names.index(ts_name)]
    keep = np.asarray(col.values, np.int64) > int(since_ms)
    if keep.all():
        return res
    idx = np.flatnonzero(keep)
    return QueryResult(res.names, _slice_result(res.cols, idx), res.types)


def _result_nbytes(res) -> int:
    n = 0
    for c in res.cols:
        v = c.values
        if v.dtype == object:
            n += len(v) * 64    # strings: a conservative estimate
        else:
            n += int(v.nbytes)
        if c.validity is not None:
            n += int(c.validity.nbytes)
    return n


class _Entry:
    __slots__ = ("versions", "result", "ts_name", "exec_path", "nbytes")

    def __init__(self, versions, result, ts_name, exec_path, nbytes):
        self.versions = versions
        self.result = result
        self.ts_name = ts_name
        self.exec_path = exec_path
        self.nbytes = nbytes


class ResultCache:
    """LRU byte-budgeted cache of finished QueryResults, validated by the
    table's physical version."""

    def __init__(self, max_bytes: int = _DEFAULT_BYTES,
                 enabled: bool = False):
        self.max_bytes = int(max_bytes)
        self.enabled = bool(enabled)
        self._lock = concurrency.Lock()
        self._entries: OrderedDict[tuple, _Entry] = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        from greptimedb_tpu_torch.telemetry import memory as _memory

        _memory.register_pool(
            "result_cache", "host", self, stats=ResultCache._mem_stats)

    @classmethod
    def from_options(cls, options: dict | None) -> "ResultCache":
        """The JAX package's `[result_cache]` options (`enable`, `bytes`;
        its `validate_interval_ms` bounds remote tables, which wait for
        ROADMAP A10)."""
        o = options or {}
        return cls(max_bytes=int(o.get("bytes", _DEFAULT_BYTES)),
                   enabled=bool(o.get("enable", False)))

    # ------------------------------------------------------------------
    def eligible(self, plan, table) -> bool:
        if not self.enabled or table is None:
            return False
        if plan.kind not in ("plain", "aggregate", "range"):
            return False
        if table.info.options.get("ttl"):
            return False    # a scan window derived from the wall clock
        if getattr(plan.scan, "volatile_bounds", False):
            # a now()-folded bound fingerprints anew every call: caching
            # would store one entry a poll that never hits
            return False
        return not plan_volatile(plan)

    @staticmethod
    def _key(db: str, table, fingerprint: str) -> tuple:
        # the name too: tables registered without a catalog id share id 0
        return (db, table.info.table_id, table.name, fingerprint)

    def get(self, db: str, table, fingerprint: str, versions):
        key = self._key(db, table, fingerprint)
        with self._lock:
            e = self._entries.get(key)
            if e is not None and e.versions != versions:
                self._drop_locked(key, e)
                e = None
            if e is None:
                _MISSES.inc()
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            _HITS.inc()
            self.hits += 1
            return e

    def put(self, db: str, table, fingerprint: str, versions, result,
            ts_name: str | None, exec_path: str):
        nbytes = _result_nbytes(result)
        if nbytes > self.max_bytes:
            return
        key = self._key(db, table, fingerprint)
        entry = _Entry(versions, result, ts_name, exec_path, nbytes)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[key] = entry
            self._bytes += nbytes
            while self._bytes > self.max_bytes and len(self._entries) > 1:
                k = next(iter(self._entries))
                self._drop_locked(k, self._entries[k])
            self._publish_locked()

    # ------------------------------------------------------------------
    def purge_table(self, db: str, table_id: int) -> None:
        """Drop every entry of the table (a DROP: a recreated table can
        reuse the id and happen to match versions)."""
        with self._lock:
            for k in [k for k in self._entries
                      if k[0] == db and k[1] == table_id]:
                self._drop_locked(k, self._entries[k])
            self._publish_locked()

    def clear(self) -> None:
        with self._lock:
            for k in list(self._entries):
                self._drop_locked(k, self._entries[k])
            self._publish_locked()

    def _drop_locked(self, key, entry) -> None:
        self._entries.pop(key, None)
        self._bytes -= entry.nbytes
        _EVICTIONS.inc()
        self.evictions += 1

    def _publish_locked(self) -> None:
        _BYTES.set(float(self._bytes))
        _ENTRIES.set(float(len(self._entries)))

    def _mem_stats(self) -> dict:
        with self._lock:
            return {
                "bytes": self._bytes, "entries": len(self._entries),
                "budget_bytes": self.max_bytes if self.enabled else 0,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
            }

    @property
    def entry_count(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def byte_count(self) -> int:
        with self._lock:
            return self._bytes
