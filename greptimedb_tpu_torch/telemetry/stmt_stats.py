"""Statement statistics: pg_stat_statements for the TPU query path.

Capability counterpart of the reference's layer-2 `information_schema`
statistics surface (PAPER.md) and PostgreSQL's pg_stat_statements:
every executed statement is folded into a process-wide registry keyed
by a normalized statement FINGERPRINT — literals, timestamps and
IN-lists fold to `?`, multi-row VALUES lists collapse — so every poll
of a dashboard panel lands on ONE row, regardless of the concrete
window bounds each poll carries.

Per fingerprint the registry records: calls, errors by status code,
rows returned, latency + admission-queue-time histograms (p50/p99
derivable), the execution path (device | host | dist), the mesh
replicate-vs-shard decision, device compile vs program-cache hits,
upload/readback bytes (full vs since-cursor delta), session /
result-cache / dist-scan-cache hit attribution, shed + deadline
counts, and the LAST trace id as an exemplar linking the aggregate row
back into `/v1/traces` for one concrete execution.

Collection is contextvar-based like query/stats.py: execution sites
call `add()`/`note()` which are no-ops (one ContextVar.get) unless an
observation is active, so a disabled registry costs nothing on the hot
path. The registry itself is LRU-bounded: past `max_fingerprints` the
least-recently-seen row is MERGED into the `_other` row before the new
fingerprint is admitted, and the `gtpu_stmt_*` metric labels collapse
to `_other` past the (smaller) `metric_fingerprints` knob — Prometheus
series can never be evicted, so their cap is first-come like the sched
tenant labels.

Because the metrics self-export loop (telemetry/export.py) re-ingests
the registry's `gtpu_stmt_*` families, per-fingerprint statistics
become a queryable TIME SERIES in `greptime_metrics` for free:
`SELECT * FROM greptime_metrics.gtpu_stmt_calls_total` is the TSDB
dogfooding its own query history.
"""

from __future__ import annotations

import contextvars
import hashlib
import time
from collections import OrderedDict

from greptimedb_tpu_torch import concurrency
from greptimedb_tpu_torch.telemetry import metrics as _metrics
from greptimedb_tpu_torch.telemetry.metrics import (
    global_registry,
    set_child_value as _set_counter,
)

# ---------------------------------------------------------------------------
# metrics — PULL-model: the gtpu_stmt_* families are published from
# the registry rows at SCRAPE time (a MetricsRegistry collector, like
# the memory accountant's gauges), so the statement hot path never
# touches a prometheus child lock. ADMIN reset folds each row's totals
# into a carried per-label base first, keeping every counter/histogram
# monotone across resets. Fingerprint label cardinality is capped —
# see _metric_fp_locked.
# ---------------------------------------------------------------------------

# latency/queue-time histogram bounds (ms) for the in-registry
# per-fingerprint histograms information_schema derives p50/p99 from;
# gtpu_stmt_latency_seconds exports the same bounds in seconds
_BUCKETS_MS = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 60000.0,
)
# bucket lists carry one extra OVERFLOW slot past the last bound, so
# observations slower than 60s still count toward the percentiles
_N_BUCKETS = len(_BUCKETS_MS) + 1

_CALLS = global_registry.counter(
    "gtpu_stmt_calls_total",
    "statement executions per (db, fingerprint)",
    labels=("db", "fingerprint"),
)
_ERRORS = global_registry.counter(
    "gtpu_stmt_errors_total",
    "failed statement executions per (db, fingerprint, status code)",
    labels=("db", "fingerprint", "code"),
)
_LATENCY = global_registry.histogram(
    "gtpu_stmt_latency_seconds",
    "statement wall time per (db, fingerprint)",
    labels=("db", "fingerprint"),
    buckets=tuple(b / 1000.0 for b in _BUCKETS_MS),
)
_ROWS = global_registry.counter(
    "gtpu_stmt_rows_total",
    "result rows returned (or rows affected) per (db, fingerprint)",
    labels=("db", "fingerprint"),
)
_READBACK = global_registry.counter(
    "gtpu_stmt_readback_bytes_total",
    "device->host readback bytes per (db, fingerprint, mode)",
    labels=("db", "fingerprint", "mode"),
)
_TRACKED = global_registry.gauge(
    "gtpu_stmt_fingerprints",
    "distinct fingerprint rows currently tracked by the registry",
)

OTHER = "_other"


# ---------------------------------------------------------------------------
# fingerprinting
# ---------------------------------------------------------------------------


class StmtFingerprint:
    """One statement's normalized identity: `fp` is the stable hex id,
    `text` the normalized statement (constants folded to `?`),
    `inner_fp` the fingerprint of the statement under an EXPLAIN
    [ANALYZE] wrapper (what EXPLAIN ANALYZE stamps, so the analyzed
    plan joins the PLAIN statement's statistics row)."""

    __slots__ = ("fp", "text", "inner_fp")

    def __init__(self, fp: str, text: str, inner_fp: str | None = None):
        self.fp = fp
        self.text = text
        self.inner_fp = inner_fp


def _normalize_tokens(toks) -> str:
    """Token list -> normalized statement text.

    - NUMBER and STRING literals (so timestamps, interval/RANGE window
      strings, tag values) fold to `?`
    - identifiers lowercase (quoted identifiers keep their case: they
      are case-sensitive)
    - a parenthesized list of only placeholders — an IN-list or a
      VALUES row — collapses to `(?)`, and consecutive `(?), (?), ...`
      row groups collapse to one `(?)` so a 1-row and a 10k-row batch
      INSERT share a fingerprint
    """
    from greptimedb_tpu_torch.sql.lexer import Tok

    out: list[str] = []
    i, n = 0, len(toks)
    while i < n:
        t = toks[i]
        if t.kind in (Tok.NUMBER, Tok.STRING):
            # -? / +? : fold a sign that immediately precedes a folded
            # literal into the placeholder (…WHERE v > -5 and > 5 are
            # one shape)
            if (out and out[-1] in ("-", "+")
                    and (len(out) < 2 or out[-2] in (
                        "(", ",", "=", "<", ">", "<=", ">=", "<>",
                        "!=", "and", "or", "not", "in", "then", "else",
                        "when", "between", "select", "limit", "offset",
                        "values", "by",
                    ))):
                out.pop()
            out.append("?")
            i += 1
            continue
        if t.kind == Tok.IDENT:
            out.append(t.text.lower())
            i += 1
            continue
        if t.kind == Tok.QIDENT:
            out.append(f'"{t.text}"')
            i += 1
            continue
        if t.kind == Tok.OP and t.text == "(":
            # collapse (?, ?, ...) -> (?)
            j = i + 1
            only_ph = False
            while j < n:
                tj = toks[j]
                if tj.kind in (Tok.NUMBER, Tok.STRING):
                    only_ph = True
                    j += 1
                    continue
                if tj.kind == Tok.OP and tj.text in (",", "-", "+"):
                    j += 1
                    continue
                break
            if only_ph and j < n and toks[j].kind == Tok.OP \
                    and toks[j].text == ")":
                if len(out) >= 4 and out[-4:] == ["(", "?", ")", ","]:
                    # consecutive VALUES row groups: drop the repeat
                    out.pop()
                    i = j + 1
                    continue
                out.extend(["(", "?", ")"])
                i = j + 1
                continue
        out.append(t.text)
        i += 1
    return " ".join(out)


def _hash(text: str) -> str:
    return hashlib.blake2b(text.encode(), digest_size=8).hexdigest()


def _fingerprint_tokens(toks) -> StmtFingerprint | None:
    from greptimedb_tpu_torch.sql.lexer import Tok

    toks = [t for t in toks if t.kind != Tok.EOF]
    if not toks:
        return None
    text = _normalize_tokens(toks)
    inner_fp = None
    if toks[0].kind == Tok.IDENT and toks[0].upper == "EXPLAIN":
        k = 1
        while (k < len(toks) and toks[k].kind == Tok.IDENT
               and toks[k].upper in ("ANALYZE", "VERBOSE")):
            k += 1
        if k < len(toks):
            inner_fp = _hash(_normalize_tokens(toks[k:]))
    return StmtFingerprint(_hash(text), text, inner_fp)


# raw-text -> fingerprints memo: a dashboard poll repeats the same SQL
# text, so the steady state is one dict lookup, not a re-tokenize.
# Oversized texts (giant batch INSERTs, each a distinct literal
# payload) are fingerprinted but NOT cached: they would pin megabytes
# of raw SQL per entry for inputs that never repeat
_FP_CACHE_MAX = 512
_FP_CACHE_TEXT_MAX = 8192
_fp_cache: OrderedDict[str, list] = OrderedDict()
_fp_cache_lock = concurrency.Lock()


def fingerprint_sql(sql: str) -> list[StmtFingerprint]:
    """Per-statement fingerprints of a (possibly multi-statement) SQL
    text, aligned with parse_sql's statement order. Unlexable text
    returns [] (the parser will raise its own typed error)."""
    with _fp_cache_lock:
        hit = _fp_cache.get(sql)
        if hit is not None:
            _fp_cache.move_to_end(sql)
            return hit
    from greptimedb_tpu_torch.sql.lexer import Tok, tokenize

    try:
        toks = tokenize(sql)
    except Exception:  # noqa: BLE001 - parser owns syntax errors
        return []
    out: list[StmtFingerprint] = []
    cur: list = []
    for t in toks:
        if t.kind == Tok.OP and t.text == ";":
            fp = _fingerprint_tokens(cur)
            if fp is not None:
                out.append(fp)
            cur = []
        elif t.kind != Tok.EOF:
            cur.append(t)
    fp = _fingerprint_tokens(cur)
    if fp is not None:
        out.append(fp)
    if len(sql) <= _FP_CACHE_TEXT_MAX:
        with _fp_cache_lock:
            _fp_cache[sql] = out
            while len(_fp_cache) > _FP_CACHE_MAX:
                _fp_cache.popitem(last=False)
    return out


# ---------------------------------------------------------------------------
# per-statement observation (contextvar-scoped scratch)
# ---------------------------------------------------------------------------


class _Obs:
    __slots__ = ("fp", "text", "inner_fp", "db", "tenant", "channel",
                 "counters", "notes", "trace_id", "programs")

    def __init__(self, fp: StmtFingerprint, db: str, tenant: str,
                 channel: str, trace_id: str | None):
        self.fp = fp.fp
        self.text = fp.text
        self.inner_fp = fp.inner_fp
        self.db = db
        self.tenant = tenant
        self.channel = channel
        self.counters: dict[str, float] = {}
        self.notes: dict[str, str] = {}
        self.trace_id = trace_id
        # device-program registry ids this statement dispatched
        # (telemetry/device_programs.py; bounded — a statement shape
        # touches a handful of compiled programs)
        self.programs: list[str] | None = None

    def add(self, key: str, n: float = 1):
        self.counters[key] = self.counters.get(key, 0) + n

    def note(self, key: str, value: str):
        self.notes[key] = value


_current: contextvars.ContextVar[_Obs | None] = contextvars.ContextVar(
    "gtpu_stmt_obs", default=None
)
# the statement fingerprint execute_sql resolved for the statement it
# is about to execute (execute_statement has only the AST)
_pending_fp: contextvars.ContextVar[StmtFingerprint | None] = (
    contextvars.ContextVar("gtpu_stmt_fp", default=None)
)


def bind_fingerprint(fp: StmtFingerprint | None):
    return _pending_fp.set(fp)


def reset_fingerprint(token):
    _pending_fp.reset(token)


def active() -> _Obs | None:
    return _current.get()


def add(key: str, n: float = 1):
    obs = _current.get()
    if obs is not None:
        obs.add(key, n)


def note(key: str, value: str):
    obs = _current.get()
    if obs is not None:
        obs.note(key, value)


_MAX_OBS_PROGRAMS = 16


def note_program(prog_id: str):
    """Link the active statement observation to a device-program
    registry row (called by device_trace at the dispatch boundary)."""
    obs = _current.get()
    if obs is None:
        return
    progs = obs.programs
    if progs is None:
        progs = obs.programs = []
    if prog_id not in progs and len(progs) < _MAX_OBS_PROGRAMS:
        progs.append(prog_id)


def note_exec_path(path: str):
    """Executor path attribution ('device' | 'host:<reason>' |
    'dist:partial' ...) -> the row's device/host/dist triple."""
    obs = _current.get()
    if obs is None:
        return
    if path == "device":
        obs.note("exec_path", "device")
    elif path.startswith("dist"):
        obs.note("exec_path", "dist")
    else:
        obs.note("exec_path", "host")


def explain_fingerprint() -> str | None:
    """The fingerprint EXPLAIN ANALYZE stamps: the analyzed statement's
    own fingerprint (so the stamp joins the plain statement's row), or
    the active statement's fingerprint outside an EXPLAIN wrapper."""
    obs = _current.get()
    if obs is None:
        return None
    return obs.inner_fp or obs.fp


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


class StmtStatsConfig:
    """`[stmt_stats]` options (config.py DEFAULTS documents each)."""

    __slots__ = ("enable", "max_fingerprints", "metric_fingerprints")

    def __init__(self, *, enable: bool = True,
                 max_fingerprints: int = 512,
                 metric_fingerprints: int = 64):
        self.enable = bool(enable)
        self.max_fingerprints = max(1, int(max_fingerprints))
        self.metric_fingerprints = max(0, int(metric_fingerprints))


# observation-counter key -> _Row attribute (fold_obs single pass)
_FOLD_ATTRS = {
    "rows": "rows_returned",
    "compile_first": "compile_count",
    "compile_cache_hit": "compile_cache_hits",
    "upload_bytes": "upload_bytes",
    "readback_full_bytes": "readback_full_bytes",
    "readback_delta_bytes": "readback_delta_bytes",
    "session_hits": "session_hits",
    "session_misses": "session_misses",
    "result_cache_hits": "result_cache_hits",
    "result_cache_misses": "result_cache_misses",
    "result_cache_bypass": "result_cache_bypass",
    "scan_cache_hits": "scan_cache_hits",
    "scan_cache_misses": "scan_cache_misses",
    "dist_datanodes": "datanodes",
    "dist_rpc_ms": "rpc_ms",
}


class _Row:
    """Aggregate statistics of one (db, fingerprint)."""

    __slots__ = (
        "fingerprint", "db", "tenant", "channel", "query",
        "calls", "errors", "rows_returned", "total_ms",
        "lat_buckets", "queue_ms", "queue_buckets",
        "path_device", "path_host", "path_dist", "mesh_decision",
        "compile_count", "compile_cache_hits",
        "upload_bytes", "readback_full_bytes", "readback_delta_bytes",
        "session_hits", "session_misses",
        "result_cache_hits", "result_cache_misses", "result_cache_bypass",
        "scan_cache_hits", "scan_cache_misses",
        "shed_count", "deadline_count", "datanodes", "rpc_ms",
        "last_trace_id", "first_seen_ms", "last_seen_ms",
        "metric_fp", "program_ids",
    )

    def __init__(self, fingerprint: str, db: str, tenant: str,
                 channel: str, query: str):
        self.fingerprint = fingerprint
        self.db = db
        self.tenant = tenant
        self.channel = channel
        self.query = query
        self.calls = 0
        self.errors: dict[int, int] = {}
        self.rows_returned = 0
        self.total_ms = 0.0
        self.lat_buckets = [0] * _N_BUCKETS
        self.queue_ms = 0.0
        self.queue_buckets = [0] * _N_BUCKETS
        self.path_device = 0
        self.path_host = 0
        self.path_dist = 0
        self.mesh_decision = ""
        self.compile_count = 0
        self.compile_cache_hits = 0
        self.upload_bytes = 0
        self.readback_full_bytes = 0
        self.readback_delta_bytes = 0
        self.session_hits = 0
        self.session_misses = 0
        self.result_cache_hits = 0
        self.result_cache_misses = 0
        self.result_cache_bypass = 0
        self.scan_cache_hits = 0
        self.scan_cache_misses = 0
        self.shed_count = 0
        self.deadline_count = 0
        self.datanodes = 0
        self.rpc_ms = 0.0
        self.last_trace_id = ""
        # device-program registry ids executions of this shape have
        # dispatched (joins information_schema.device_programs /
        # /debug/prof/device on the `program` column; bounded)
        self.program_ids: list[str] = []
        self.first_seen_ms = int(time.time() * 1000)
        self.last_seen_ms = self.first_seen_ms
        # the /metrics label this row publishes under (its own
        # fingerprint, or "_other" past the metric_fingerprints cap) —
        # decided once at row creation
        self.metric_fp = fingerprint

    # -- folding -------------------------------------------------------
    def fold_obs(self, obs: _Obs, elapsed_ms: float, error_code: int | None):
        self.calls += 1
        self.last_seen_ms = int(time.time() * 1000)
        self.total_ms += elapsed_ms
        _observe_buckets(self.lat_buckets, elapsed_ms)
        if error_code is not None:
            self.errors[error_code] = self.errors.get(error_code, 0) + 1
            if error_code in (6002, 6003):   # overloaded / queue timeout
                self.shed_count += 1
            elif error_code == 6004:         # deadline exceeded
                self.deadline_count += 1
        if obs.notes:
            path = obs.notes.get("exec_path")
            if path == "device":
                self.path_device += 1
            elif path == "dist":
                self.path_dist += 1
            elif path == "host":
                self.path_host += 1
            mesh = obs.notes.get("mesh_decision")
            if mesh:
                self.mesh_decision = mesh
        # one pass over the (small) observation counters instead of a
        # fixed probe per possible key — the hot path typically carries
        # 3-6 of them
        for k, v in obs.counters.items():
            attr = _FOLD_ATTRS.get(k)
            if attr is not None:
                setattr(self, attr, getattr(self, attr) + v)
            elif k == "queue_ms" and v:
                self.queue_ms += v
                _observe_buckets(self.queue_buckets, v)
        if obs.trace_id:
            self.last_trace_id = obs.trace_id
        if obs.programs:
            for pid in obs.programs:
                if (pid not in self.program_ids
                        and len(self.program_ids) < _MAX_OBS_PROGRAMS):
                    self.program_ids.append(pid)

    def fold_row(self, other: "_Row"):
        """Merge another row into this one (LRU eviction into _other)."""
        self.calls += other.calls
        for code, n in other.errors.items():
            self.errors[code] = self.errors.get(code, 0) + n
        self.rows_returned += other.rows_returned
        self.total_ms += other.total_ms
        self.queue_ms += other.queue_ms
        for i in range(_N_BUCKETS):
            self.lat_buckets[i] += other.lat_buckets[i]
            self.queue_buckets[i] += other.queue_buckets[i]
        self.path_device += other.path_device
        self.path_host += other.path_host
        self.path_dist += other.path_dist
        self.compile_count += other.compile_count
        self.compile_cache_hits += other.compile_cache_hits
        self.upload_bytes += other.upload_bytes
        self.readback_full_bytes += other.readback_full_bytes
        self.readback_delta_bytes += other.readback_delta_bytes
        self.session_hits += other.session_hits
        self.session_misses += other.session_misses
        self.result_cache_hits += other.result_cache_hits
        self.result_cache_misses += other.result_cache_misses
        self.result_cache_bypass += other.result_cache_bypass
        self.scan_cache_hits += other.scan_cache_hits
        self.scan_cache_misses += other.scan_cache_misses
        self.shed_count += other.shed_count
        self.deadline_count += other.deadline_count
        self.datanodes += other.datanodes
        self.rpc_ms += other.rpc_ms
        self.first_seen_ms = min(self.first_seen_ms, other.first_seen_ms)
        self.last_seen_ms = max(self.last_seen_ms, other.last_seen_ms)
        if other.last_trace_id:
            self.last_trace_id = other.last_trace_id
        for pid in other.program_ids:
            if (pid not in self.program_ids
                    and len(self.program_ids) < _MAX_OBS_PROGRAMS):
                self.program_ids.append(pid)

    # -- rendering -----------------------------------------------------
    def to_doc(self) -> dict:
        errors = sum(self.errors.values())
        exec_path = ""
        dominant = max(
            ("device", self.path_device), ("dist", self.path_dist),
            ("host", self.path_host), key=lambda kv: kv[1],
        )
        if dominant[1] > 0:
            exec_path = dominant[0]
        return {
            "fingerprint": self.fingerprint,
            "schema_name": self.db,
            "tenant": self.tenant,
            "channel": self.channel,
            "query": self.query,
            "calls": self.calls,
            "errors": errors,
            "errors_by_code": dict(sorted(self.errors.items())),
            "rows_returned": int(self.rows_returned),
            "total_ms": round(self.total_ms, 3),
            "mean_ms": round(self.total_ms / max(self.calls, 1), 3),
            "p50_ms": round(_quantile(self.lat_buckets, 0.50), 3),
            "p99_ms": round(_quantile(self.lat_buckets, 0.99), 3),
            "queue_total_ms": round(self.queue_ms, 3),
            "queue_p99_ms": round(_quantile(self.queue_buckets, 0.99), 3),
            "exec_path": exec_path,
            "mesh_decision": self.mesh_decision,
            "compile_count": int(self.compile_count),
            "compile_cache_hits": int(self.compile_cache_hits),
            "upload_bytes": int(self.upload_bytes),
            "readback_full_bytes": int(self.readback_full_bytes),
            "readback_delta_bytes": int(self.readback_delta_bytes),
            "session_hit_rate": _rate(self.session_hits,
                                      self.session_misses),
            "result_cache_hit_rate": _rate(
                self.result_cache_hits,
                self.result_cache_misses + self.result_cache_bypass,
            ),
            "scan_cache_hit_rate": _rate(self.scan_cache_hits,
                                         self.scan_cache_misses),
            "shed_count": self.shed_count,
            "deadline_count": self.deadline_count,
            "datanodes": int(self.datanodes),
            "rpc_ms": round(self.rpc_ms, 3),
            "last_trace_id": self.last_trace_id,
            "program_ids": list(self.program_ids),
            "first_seen_ms": self.first_seen_ms,
            "last_seen_ms": self.last_seen_ms,
        }


def _rate(hits: int, misses: int) -> float:
    total = hits + misses
    return round(hits / total, 4) if total else 0.0


def _observe_buckets(buckets: list[int], v_ms: float):
    # buckets are NON-cumulative (one increment per observation, with
    # the trailing overflow slot); _quantile accumulates
    _metrics.observe_bucket(buckets, _BUCKETS_MS, v_ms)


def _quantile(buckets: list[int], q: float) -> float:
    return _metrics.bucket_quantile(buckets, _BUCKETS_MS, q)


_ORDER_KEYS = frozenset({
    "calls", "errors", "rows_returned", "total_ms", "mean_ms", "p50_ms",
    "p99_ms", "queue_total_ms", "shed_count", "deadline_count",
    "readback_full_bytes", "readback_delta_bytes", "upload_bytes",
    "rpc_ms", "last_seen_ms",
})


class _MetricBase:
    """Carried totals for one (db, metric_fp) label: what ADMIN reset
    and LRU collapse fold a disappearing row into, so the exported
    prometheus series stay monotone while the queryable registry
    resets/collapses freely."""

    __slots__ = ("calls", "rows", "full", "delta", "total_ms",
                 "lat_buckets", "errors")

    def __init__(self):
        self.calls = 0
        self.rows = 0
        self.full = 0
        self.delta = 0
        self.total_ms = 0.0
        self.lat_buckets = [0] * _N_BUCKETS
        self.errors: dict[int, int] = {}

    def fold_row(self, row: "_Row"):
        self.calls += row.calls
        self.rows += int(row.rows_returned)
        self.full += int(row.readback_full_bytes)
        self.delta += int(row.readback_delta_bytes)
        self.total_ms += row.total_ms
        for i in range(_N_BUCKETS):
            self.lat_buckets[i] += row.lat_buckets[i]
        for code, n in row.errors.items():
            self.errors[code] = self.errors.get(code, 0) + n

    def fold_base(self, other: "_MetricBase"):
        self.calls += other.calls
        self.rows += other.rows
        self.full += other.full
        self.delta += other.delta
        self.total_ms += other.total_ms
        for i in range(_N_BUCKETS):
            self.lat_buckets[i] += other.lat_buckets[i]
        for code, n in other.errors.items():
            self.errors[code] = self.errors.get(code, 0) + n


class _Observation:
    """Context manager for one statement observation (class-based: the
    contextlib generator form costs measurable microseconds per
    statement on the warm-poll path)."""

    __slots__ = ("_reg", "_ctx", "_obs", "_token", "_t0")

    def __init__(self, registry: "StmtStatsRegistry", ctx):
        self._reg = registry
        self._ctx = ctx
        self._obs = None
        self._token = None
        self._t0 = 0.0

    def __enter__(self) -> _Obs | None:
        reg = self._reg
        fp = _pending_fp.get()
        if (not reg.config.enable or fp is None
                or _current.get() is not None):
            return None
        from greptimedb_tpu_torch.telemetry import tracing  # cycle-safe lazy

        ctx = self._ctx
        db = getattr(ctx, "database", "") or "public"
        obs = _Obs(fp, db, getattr(ctx, "username", "") or db,
                   getattr(ctx, "channel", "") or "",
                   tracing.current_trace_id())
        self._obs = obs
        self._token = _current.set(obs)
        self._t0 = time.perf_counter()
        return obs

    def __exit__(self, exc_type, exc, tb):
        obs = self._obs
        if obs is None:
            return False
        code = None
        if exc is not None:
            code = getattr(getattr(exc, "status_code", None), "value",
                           None)
            if code is None:
                code = 1003  # INTERNAL: untyped failure
        _current.reset(self._token)
        self._reg._record(obs, (time.perf_counter() - self._t0)
                          * 1000.0, code)
        return False


class StmtStatsRegistry:
    """Process-wide registry; one per process (`global_stmt_stats`)."""

    def __init__(self, config: StmtStatsConfig | None = None):
        self.config = config or StmtStatsConfig()
        self._lock = concurrency.Lock()
        # serializes whole publish passes (snapshot + child writes):
        # two concurrent scrapes interleaving their writes could expose
        # a STALE aggregate after a newer one — a counter decrease
        self._publish_lock = concurrency.Lock()
        self._rows: OrderedDict[tuple[str, str], _Row] = OrderedDict()
        # fingerprints granted a real /metrics label (prometheus series
        # cannot be evicted, so this cap is first-come like the sched
        # tenant labels; later fingerprints export as "_other")
        self._metric_fps: set[str] = set()
        # carried per-(db, metric label) totals of rows that left the
        # registry (ADMIN reset / LRU collapse): published series must
        # stay monotone even though the queryable rows vanish
        self._metric_base: dict[tuple, _MetricBase] = {}
        # finished observations awaiting their fold. The statement hot
        # path only APPENDS here (one list op — folding touches a
        # 30-field row plus histogram lists, all cache-cold right
        # after a query, and costs ~20us in situ); every reader
        # (snapshot/publish/reset) drains first, and the bound forces
        # a synchronous drain so memory stays fixed under a reader
        # that never scrapes
        self._pending: list = []
        self.evicted_rows = 0

    # -- observation lifecycle ----------------------------------------
    def observe(self, ctx, kind: str) -> "_Observation":
        """Wrap one statement execution (hand-rolled context manager —
        the generator form costs real microseconds on a ~1ms
        statement). Enters as the observation, or None when disabled /
        no fingerprint was bound by execute_sql / an observation is
        already active (nested statement executions — EXECUTE of a
        prepared statement re-dispatching — fold into the OUTER one)."""
        return _Observation(self, ctx)

    _PENDING_MAX = 2048

    # -- folding ------------------------------------------------------
    def _record(self, obs: _Obs, elapsed_ms: float, code: int | None):
        """Queue one finished observation for its fold. The statement
        hot path ends at the append — folding runs when a reader
        drains (snapshot / scrape / reset) or the pending bound hits."""
        with self._lock:
            self._pending.append((obs, elapsed_ms, code))
            if len(self._pending) >= self._PENDING_MAX:
                self._drain_locked()

    def _drain_locked(self):
        for obs, elapsed_ms, code in self._pending:
            key = (obs.db, obs.fp)
            row = self._rows.get(key)
            if row is None:
                # make room INCLUDING the row about to be inserted
                # (collapsing may itself create a db's _other row, so
                # require net progress to terminate)
                while len(self._rows) >= self.config.max_fingerprints:
                    before = len(self._rows)
                    self._collapse_lru_locked()
                    if len(self._rows) >= before:
                        break  # only _other rows remain
                row = _Row(obs.fp, obs.db, obs.tenant, obs.channel,
                           obs.text)
                row.metric_fp = self._metric_fp_locked(obs.fp)
                self._rows[key] = row
            else:
                self._rows.move_to_end(key)
                # tenant/channel track the latest caller of the shape
                row.tenant = obs.tenant
                row.channel = obs.channel
            row.fold_obs(obs, elapsed_ms, code)
        self._pending.clear()

    def _collapse_lru_locked(self):
        """Evict the least-recently-seen row by MERGING it into the
        `_other` row (cardinality collapses, totals never vanish).
        The victim's published metric series freezes at its final
        totals (folded into the carried base under its OWN label —
        prometheus series must stay monotone); only the queryable
        registry row collapses into `_other`."""
        for key in self._rows:
            if key[1] != OTHER:
                victim = self._rows.pop(key)
                break
        else:
            return
        self._fold_base_locked(victim)
        okey = (victim.db, OTHER)
        other = self._rows.get(okey)
        if other is None:
            other = _Row(OTHER, victim.db, victim.tenant,
                         victim.channel, OTHER)
            self._rows[okey] = other
        else:
            self._rows.move_to_end(okey)
        other.fold_row(victim)
        self.evicted_rows += 1

    def _fold_base_locked(self, row: "_Row"):
        """Accumulate a disappearing row's totals into the carried
        metric base so its exported series never decreases."""
        key = (row.db, row.metric_fp)
        base = self._metric_base.get(key)
        if base is None:
            base = self._metric_base[key] = _MetricBase()
        base.fold_row(row)

    # -- scrape-time publishing ---------------------------------------
    def _publish_metrics(self):
        """MetricsRegistry collector: refresh every gtpu_stmt_* family
        from the registry rows + the carried bases. Registry `_other`
        ROWS are excluded — their content is already represented in
        the bases under the collapsed rows' own labels. The publish
        lock covers snapshot AND writes: publishes serialize, so each
        scrape exposes a consistent, never-older aggregate."""
        with self._publish_lock:
            self._publish_locked()

    def _publish_locked(self):
        with self._lock:
            self._drain_locked()
            agg: dict[tuple, _MetricBase] = {}
            for (db, fp), row in self._rows.items():
                if fp == OTHER:
                    continue
                key = (row.db, row.metric_fp)
                b = agg.get(key)
                if b is None:
                    b = agg[key] = _MetricBase()
                b.fold_row(row)
            for key, base in self._metric_base.items():
                b = agg.get(key)
                if b is None:
                    b = agg[key] = _MetricBase()
                b.fold_base(base)
            tracked = len(self._rows)
        _TRACKED.set(tracked)
        for (db, mfp), b in agg.items():
            _set_counter(_CALLS.labels(db, mfp), b.calls)
            _set_counter(_ROWS.labels(db, mfp), b.rows)
            _set_counter(_READBACK.labels(db, mfp, "full"), b.full)
            _set_counter(_READBACK.labels(db, mfp, "delta"), b.delta)
            for code, n in b.errors.items():
                _set_counter(_ERRORS.labels(db, mfp, str(code)), n)
            hist = _LATENCY.labels(db, mfp)
            with hist._lock:
                cum = 0
                # the exported histogram has len(_BUCKETS_MS) bounds;
                # the trailing OVERFLOW slot only reaches the +Inf
                # bucket, which the exposition derives from `count`
                for i in range(len(_BUCKETS_MS)):
                    cum += b.lat_buckets[i]
                    hist.counts[i] = cum
                hist.count = int(b.calls)
                hist.total = b.total_ms / 1000.0

    def _metric_fp_locked(self, fp: str) -> str:
        if fp in self._metric_fps:
            return fp
        if len(self._metric_fps) < self.config.metric_fingerprints:
            self._metric_fps.add(fp)
            return fp
        return OTHER

    # -- surfaces -----------------------------------------------------
    def snapshot(self, *, order_by: str = "total_ms",
                 limit: int = 0) -> list[dict]:
        if order_by not in _ORDER_KEYS:
            order_by = "total_ms"
        with self._lock:
            self._drain_locked()
            docs = [r.to_doc() for r in self._rows.values()]
        docs.sort(key=lambda d: d.get(order_by, 0), reverse=True)
        if limit > 0:
            docs = docs[:limit]
        return docs

    def reset(self) -> int:
        """ADMIN reset_statement_statistics(): drop every row (like
        pg_stat_statements_reset()). The prometheus counters are
        monotone by contract and keep counting: each dropped row's
        totals fold into the carried per-label base the scrape-time
        publisher adds back in."""
        with self._lock:
            self._drain_locked()
            n = len(self._rows)
            for (db, fp), row in self._rows.items():
                if fp != OTHER:
                    # _other rows' content is already in the base
                    # (folded at collapse time)
                    self._fold_base_locked(row)
            self._rows.clear()
            self.evicted_rows = 0
        _TRACKED.set(0)
        return n


global_stmt_stats = StmtStatsRegistry()
# scrape-time publisher: /metrics (and runtime_metrics, and the
# self-export loop) refresh the gtpu_stmt_* families from the registry
# rows on every render — zero prometheus work on the statement hot path
global_registry.register_collector(global_stmt_stats._publish_metrics)


def configure(options: dict | None) -> StmtStatsConfig:
    """Apply the `[stmt_stats]` TOML section to this process. The
    metric-label grant set re-derives under the new cap (already-
    exported prometheus series keep counting regardless)."""
    o = options or {}
    cfg = StmtStatsConfig(
        enable=o.get("enable", True),
        max_fingerprints=o.get("max_fingerprints", 512),
        metric_fingerprints=o.get("metric_fingerprints", 64),
    )
    with global_stmt_stats._lock:
        global_stmt_stats.config = cfg
        global_stmt_stats._metric_fps.clear()
    return cfg


def enabled() -> bool:
    return global_stmt_stats.config.enable
