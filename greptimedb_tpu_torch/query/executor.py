"""Query engine: single-table SELECT plans over a table (the JAX
package's query/executor.py).

`QueryEngine(device=..., mesh=..., mesh_opts=..., prefer_device=...)` is
the seam the JAX package's engine exposes as
`QueryEngine(...).execute(plan, table)`:

- RANGE plans run on the device grid (query/device_range) where it takes
  the shape; where it declines, the scan and the host RANGE path answer
  (per-(group, bucket) partial states combined over windows by stride
  doubling, copied);
- aggregate plans (GROUP BY) group on the host and reduce through
  query/reduce.grouped_reduce: on the card (the fused program with kernel
  G, sharded over a mesh when the planner says so) or on the host;
- plain plans (row filters, projections, ORDER BY/LIMIT) and SELECT
  without a table run on the host; their window functions (OVER) go
  through query/window_fns.py, whose running scans and sharded frames
  run on the engine's device from its DEVICE_THRESHOLD rows.

`prefer_device` has the JAX package's meaning: None decides by the row
count (reduce.DEVICE_THRESHOLD), False keeps everything on the host, True
takes the device path wherever the shape is eligible (the port's
default). `last_exec_path` is "device" or "host" after each query;
`last_window_path` is the path of its last running or sliding window
frame ("host", "device" or "device_mesh"), None when it ran none. Under
query/stats' collector (EXPLAIN ANALYZE) the engine notes the JAX
package's counts and paths: rows and series scanned, groups, and
`exec_path_<kind>`.
Result assembly (fill, group order, HAVING, output expressions, DISTINCT,
ORDER BY, LIMIT/OFFSET) is copied from the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from greptimedb_tpu_torch.datatypes.types import ConcreteDataType
from greptimedb_tpu_torch.device import resolve_device
from greptimedb_tpu_torch.errors import (
    ColumnNotFoundError,
    ExecutionError,
    PlanError,
    UnsupportedError,
)
from greptimedb_tpu_torch.index import tag_index
from greptimedb_tpu_torch.query import device_range, sessions, stats
from greptimedb_tpu_torch.query.expr import (
    Col,
    ColumnSource,
    EmptySource,
    collect_columns,
    eval_expr,
)
from greptimedb_tpu_torch.query.planner import record_scan_path
from greptimedb_tpu_torch.query.reduce import grouped_reduce
from greptimedb_tpu_torch.sql import ast as A
from greptimedb_tpu_torch.storage.memtable import _slice_rows

__all__ = ["Col", "QueryResult", "QueryEngine"]


class QueryResult:
    """Columnar query output."""

    def __init__(self, names: list[str], cols: list[Col],
                 types: dict[str, ConcreteDataType] | None = None):
        self.names = names
        self.cols = cols
        self.types = types or {}
        self.num_rows = len(cols[0]) if cols else 0

    def rows(self) -> list[list]:
        """Row-major Python values (None for nulls): what the wire
        protocols print. Decimal columns render as scale-fixed strings;
        columns convert whole (ndarray.tolist), then transpose."""
        pycols = []
        for j, c in enumerate(self.cols):
            vals = c.values
            dt = self.types.get(self.names[j])
            scale = dt.scale if dt is not None and dt.is_decimal() else None
            if scale is not None:
                lst = [f"{float(v):.{scale}f}" for v in vals.tolist()]
            elif vals.dtype == object:
                lst = [v.item() if isinstance(v, np.generic) else v
                       for v in vals]
            else:
                lst = vals.tolist()
            if c.validity is not None and not c.validity.all():
                for i in np.flatnonzero(~c.validity).tolist():
                    lst[i] = None
            pycols.append(lst)
        if not pycols:
            return [[] for _ in range(self.num_rows)]
        return [list(r) for r in zip(*pycols)]

    def column(self, name: str) -> Col:
        return self.cols[self.names.index(name)]

    def type_name(self, i: int) -> str:
        name = self.names[i]
        if name in self.types:
            return self.types[name].name
        dt = self.cols[i].values.dtype
        if dt == object:
            return "string"
        if dt == np.bool_:
            return "bool"
        return str(dt)


class _WindowOverlay(ColumnSource):
    """A row source plus computed window-function columns (__win_k)."""

    def __init__(self, base, extra: dict):
        self.base = base
        self.extra = extra
        self.num_rows = base.num_rows

    def col(self, name: str) -> Col:
        hit = self.extra.get(name)
        return hit if hit is not None else self.base.col(name)

    def __getattr__(self, name):
        return getattr(self.base, name)


class RowsSource(ColumnSource):
    """Column resolution over a table scan: fields and ts direct, tags
    decoded lazily through the series registry (strings never go to the
    device)."""

    def __init__(self, rows, registry, tag_names: list[str], ts_name: str):
        self.rows = rows
        self.registry = registry
        self.tag_names = tag_names
        self.ts_name = ts_name
        self.num_rows = 0 if rows is None else len(rows)
        self._tag_cache: dict[str, np.ndarray] = {}

    def col(self, name: str) -> Col:
        rows = self.rows
        if rows is None:
            raise ExecutionError("empty scan")
        if name == self.ts_name:
            return Col(rows.ts)
        if name in rows.fields:
            validity = None
            if rows.field_valid is not None and name in rows.field_valid:
                v = rows.field_valid[name]
                validity = None if v.all() else v
            return Col(rows.fields[name], validity)
        if name in self.tag_names:
            if name not in self._tag_cache:
                per_sid = self.registry.tag_values(name)
                self._tag_cache[name] = per_sid[rows.sid]
            return Col(self._tag_cache[name])
        raise ColumnNotFoundError(f"column not found: {name}")

    def tag_codes_per_row(self, name: str) -> tuple[np.ndarray, np.ndarray]:
        """(per-row int32 code, per-code string values) of a tag column:
        the group-by path that never builds strings per row."""
        per_sid = self.registry.tag_codes(name)
        codes = per_sid[self.rows.sid]
        values = np.asarray(self.registry.dicts[
            self.registry.tag_names.index(name)
        ].values, dtype=object)
        return codes, values


class DictSource(ColumnSource):
    """Column source over a plain name -> Col mapping (the assembled
    RANGE cells, the aggregate columns, the output columns)."""

    def __init__(self, cols: dict[str, Col], num_rows: int):
        self.cols = cols
        self.num_rows = num_rows

    def col(self, name: str) -> Col:
        try:
            return self.cols[name]
        except KeyError:
            raise ColumnNotFoundError(f"column not found: {name}") from None


def _sort_indices(cols: list[Col], ascs: list[bool],
                  nulls_first: list[bool | None],
                  primary: np.ndarray | None = None) -> np.ndarray:
    """Stable multi-key sort. Numeric keys via lexsort; object keys ranked
    first. SQL default null placement: last for ASC, first for DESC.
    `primary` (a window partition id) sorts most-significant."""
    n = len(cols[0]) if cols else (
        len(primary) if primary is not None else 0
    )
    keys = []
    for c, asc, nf in zip(reversed(cols), reversed(ascs), reversed(nulls_first)):
        vals = c.values
        if vals.dtype == object or vals.dtype.kind in ("U", "S"):
            # rank-encode strings so lexsort can handle them
            _, inv = np.unique(vals.astype(str), return_inverse=True)
            vals = inv.astype(np.int64)
        elif vals.dtype == np.bool_:
            vals = vals.astype(np.int8)
        elif vals.dtype.kind == "u":
            vals = vals.astype(np.int64)
        vals = vals.astype(np.float64) if vals.dtype.kind not in "if" else vals
        if not asc:
            # negate in the key's own dtype: int64 keys keep exact order
            # above 2^53 (float negation would merge distinct BIGINTs)
            vals = -vals
        null_last = nf is False or (nf is None and asc)
        nullkey = (~c.valid_mask).astype(np.int8)
        if not null_last:
            nullkey = -nullkey
        keys.append(vals)
        keys.append(nullkey)
    if primary is not None:
        keys.append(primary)
    if not keys:
        return np.arange(n)
    return np.lexsort(keys)


def _slice_result(cols: list[Col], idx) -> list[Col]:
    return [
        Col(c.values[idx],
            None if c.validity is None else c.validity[idx])
        for c in cols
    ]


def _distinct_indices(cols: list[Col]) -> np.ndarray:
    if not cols:
        return np.arange(0)
    parts = []
    for c in cols:
        v = c.values
        if v.dtype == object:
            _, inv = np.unique(v.astype(str), return_inverse=True)
            parts.append(inv.astype(np.int64))
        else:
            _, inv = np.unique(v, return_inverse=True)
            parts.append(inv.astype(np.int64))
        parts.append((~c.valid_mask).astype(np.int64))
    stacked = np.stack(parts)
    _, first = np.unique(stacked, axis=1, return_index=True)
    return np.sort(first)


def _group_order(key_cols: dict, keys: list[str], g: int) -> np.ndarray:
    """Permutation sorting groups by their key values (ascending, the
    default RANGE output order)."""
    if not keys:
        return np.arange(g)
    rank_keys = []
    for k in reversed(keys):
        c = key_cols[k]
        v = c.values
        if v.dtype == object or v.dtype.kind in ("U", "S"):
            _, inv = np.unique(v.astype(str), return_inverse=True)
            rank_keys.append(np.ravel(inv).astype(np.int64))
        else:
            rank_keys.append(v)
        # null keys sort last (ASC default)
        rank_keys.append((~c.valid_mask).astype(np.int8))
    return np.lexsort(rank_keys)


def _column_type(table, name: str) -> ConcreteDataType | None:
    """The declared type of a table column (None if it has none)."""
    c = table.schema.maybe_column(name)
    return None if c is None else c.data_type


def _apply_fill(vals, present, fill, step_ts):
    """FILL NULL|PREV|LINEAR|<const> along the step axis per group
    (`step_ts`, the step timestamps, as in the JAX package's signature)."""
    if fill is None or fill == "null":
        return vals, present
    if fill == "prev":
        idx = np.where(present, np.arange(vals.shape[1])[None, :], -1)
        idx = np.maximum.accumulate(idx, axis=1)
        ok = idx >= 0
        out = np.take_along_axis(vals, np.maximum(idx, 0), axis=1)
        return np.where(ok, out, 0.0), ok
    if fill == "linear":
        g, s = vals.shape
        out = vals.copy()
        ok = present.copy()
        x = np.arange(s, dtype=np.float64)
        for gi in range(g):
            p = present[gi]
            if p.sum() >= 2:
                out[gi] = np.interp(x, x[p], vals[gi][p])
                ok[gi] = True
        return out, ok
    try:
        const = float(fill)
    except ValueError:
        raise PlanError(f"unknown FILL: {fill}") from None
    return np.where(present, vals, const), np.ones_like(present, dtype=bool)


class QueryEngine:
    """Executes SELECT plans against a table on `device` (default CUDA).

    `mesh` (parallel/mesh.make_mesh) lets the planner shard large grids
    over the series axis and large GROUP BYs over the row axis;
    `mesh_opts` (parallel/mesh.MeshOptions) holds its thresholds and the
    ring-kernel knob. `x64` is the JAX package's jax_enable_x64 mode, off
    by default as JAX's is; the PromQL engines read it
    (promql/engine.PromEngine states the rule)."""

    def __init__(self, device=None, mesh=None, mesh_opts=None,
                 prefer_device: bool | None = True,
                 byte_budget: int = device_range._BYTE_BUDGET,
                 x64: bool = False):
        self.device = resolve_device(device)
        self.x64 = bool(x64)
        self.prefer_device = prefer_device
        self.mesh = mesh
        self.mesh_opts = mesh_opts
        self.range_cache = device_range.DeviceRangeCache(byte_budget)
        # the last RANGE execution on the device grid: program variant,
        # shard count, mesh decision and declared ring bytes (the JAX
        # package's EXPLAIN ANALYZE notes); None after any other query
        self.last_range = None
        # the last GROUP BY's device program (query/reduce), or None
        self.last_reduce = None
        self.last_exec_path = "host"  # observability: host | device
        self.last_window_path = None  # host | device | device_mesh
        # RANGE grids of durable tables persist as restart snapshots and
        # restore from them (query/device_range); last_grid says whether
        # the last device RANGE query's grid was a cache "hit", "restored"
        # from a snapshot or "built" from a scan
        self.last_grid = None
        # the last device RANGE query's session (query/sessions.py): "hit"
        # (its folded result served from the card, no program ran) or
        # "miss"; None after any other query
        self.last_session = None

    def _record_path(self, kind: str, path: str):
        """The path a query took: `last_exec_path` ("device" or "host")
        and EXPLAIN ANALYZE's `exec_path_<kind>` note ("device" or
        "host:<reason>")."""
        self.last_exec_path = "device" if path == "device" else "host"
        stats.note(f"exec_path_{kind}", path)

    def execute(self, plan, table) -> QueryResult:
        if table is None:
            return self._execute_tableless(plan)
        self.last_exec_path = "host"
        self.last_window_path = None
        self.last_range = self.last_reduce = self.last_session = None
        if plan.kind == "range":
            res = device_range.execute_range_device(self, plan, table)
            if res is not None:
                self._record_path("range", "device")
                return res
            self._record_path("range", "host:shape")
        src = self._scan(plan, table)
        if plan.kind == "plain":
            return self._execute_plain(plan, src, table)
        if plan.kind == "aggregate":
            return self._execute_aggregate(plan, src, table)
        if plan.kind == "range":
            return self._execute_range(plan, src, table)
        raise PlanError(f"unknown plan kind: {plan.kind}")

    def _empty_result(self, names: list[str]) -> QueryResult:
        return QueryResult(names, [Col(np.zeros(0)) for _ in names])

    # ------------------------------------------------------------------
    def _scan(self, plan, table) -> RowsSource:
        """The rows a plan reads: its columns, its ts bounds and tag
        matchers at the scan, then its residual row filter."""
        needed = set()
        for e, _ in plan.items:
            collect_columns(e, needed)
        for k in plan.keys:
            collect_columns(k.expr, needed)
        for a in plan.aggs:
            if a.arg is not None:
                collect_columns(a.arg, needed)
        for r in plan.range_items:
            if r.arg is not None:
                collect_columns(r.arg, needed)
        if plan.scan.residual is not None:
            collect_columns(plan.scan.residual, needed)
        for o in plan.order_by:
            collect_columns(o.expr, needed)
        if plan.having is not None:
            collect_columns(plan.having, needed)
        field_names = [f for f in table.field_names if f in needed]
        ts_min = plan.scan.ts_min
        if plan.kind == "plain":
            # the `since` cursor of a row-returning select is a ts lower
            # bound at the scan (before ORDER BY/LIMIT, like an extra
            # WHERE); aggregate and range states fold the whole row set,
            # and a range emits past the cursor at assembly instead
            since = sessions.current_since()
            if since is not None:
                ts_min = (since + 1 if ts_min is None
                          else max(ts_min, since + 1))
        with stats.timed("scan_ms"):
            ft = None
            if getattr(plan.scan, "fulltext", None):
                from greptimedb_tpu_torch.query.fulltext import required_terms

                ft = [
                    (col, terms) for col, q in plan.scan.fulltext
                    if (terms := required_terms(q))
                ] or None
            data = table.scan(field_names, ts_min=ts_min,
                              ts_max=plan.scan.ts_max,
                              matchers=plan.scan.matchers or None,
                              fulltext=ft)
        record_scan_path(bool(plan.scan.matchers) and tag_index.enabled())
        stats.add("rows_scanned", data.num_rows)
        stats.add("series_total", data.registry.num_series)
        if stats.active() is not None and plan.scan.matchers:
            # selectivity is worth a re-match under EXPLAIN ANALYZE only
            # (the index result cache makes this a dict hit, not a scan)
            stats.add("series_matched", sum(
                len(r.match_sids(plan.scan.matchers))
                for r in table.regions))
        src = RowsSource(data.rows, data.registry, table.tag_names,
                         table.ts_name)
        if plan.scan.residual is not None and src.num_rows:
            cond = eval_expr(plan.scan.residual, src)
            mask = cond.values.astype(bool) & cond.valid_mask
            if not mask.all():
                # one flatnonzero + integer takes beats re-scanning the
                # boolean mask once per column at low selectivity
                idx = np.flatnonzero(mask)
                stats.add("rows_filtered_residual",
                          int(src.num_rows - len(idx)))
                src = RowsSource(_slice_rows(src.rows, idx), data.registry,
                                 table.tag_names, table.ts_name)
        return src

    # ------------------------------------------------------------------
    def _execute_tableless(self, plan) -> QueryResult:
        if plan.kind != "plain":
            raise PlanError("aggregates need a FROM table")
        src = EmptySource()
        names = [n for _, n in plan.items]
        cols = [eval_expr(e, src) for e, _ in plan.items]
        return QueryResult(names, cols)

    # ------------------------------------------------------------------
    def _execute_plain(self, plan, src: RowsSource, table) -> QueryResult:
        names = [n for _, n in plan.items]
        if src.num_rows == 0:
            cols = [Col(np.zeros(0)) for _ in plan.items]
            return QueryResult(names, cols, self._types_hint(plan, table))
        # window functions: compute each OVER() call over the full row
        # set, then project with the results spliced in as columns
        from greptimedb_tpu_torch.query import window_fns as W

        win_calls = []
        for e, _ in plan.items:
            W.collect_window_calls(e, win_calls)
        for o in plan.order_by:
            W.collect_window_calls(o.expr, win_calls)
        # alias resolution can splice the SAME FuncCall object into
        # order_by — dedupe by identity so it's evaluated once
        win_calls = list({id(fc): fc for fc in win_calls}.values())
        if win_calls:
            ctx = W.WindowCtx(self.device, self.x64)
            extra: dict[str, Col] = {}
            mapping: dict[int, str] = {}
            for k, fc in enumerate(win_calls):
                cname = f"__win_{k}"
                mapping[id(fc)] = cname
                extra[cname] = W.eval_window(fc, src, ctx)
            self.last_window_path = ctx.path
            src = _WindowOverlay(src, extra)
            plan = dataclasses.replace(
                plan,
                items=[(W.replace_window_calls(e, mapping), n)
                       for e, n in plan.items],
                order_by=[
                    A.OrderItem(W.replace_window_calls(o.expr, mapping),
                                o.asc, o.nulls_first)
                    for o in plan.order_by
                ],
            )
        cols = [eval_expr(e, src) for e, _ in plan.items]
        if plan.distinct:
            idx = _distinct_indices(cols)
            cols = _slice_result(cols, idx)
        cols = self._order_limit(plan, cols, names, extra_src=src)
        return QueryResult(names, cols, self._types_hint(plan, table))

    def _types_hint(self, plan, table) -> dict:
        hints = {}
        for e, n in (plan.items or plan.post_items):
            if isinstance(e, A.Column) and table is not None:
                dt = _column_type(table, e.name)
                if dt is not None:
                    hints[n] = dt
        return hints

    # ------------------------------------------------------------------
    def _group_ids(self, plan, src: RowsSource):
        """Per-row group ids + per-group key output columns. Bare tag
        columns group through per-sid codes (no strings per row). Returns
        (gid, g, {key: Col})."""
        n = src.num_rows
        if not plan.keys:
            return np.zeros(n, dtype=np.int64), 1, {}
        code_cols = []
        decoders = []  # (vocab array, null_code | None)
        for k in plan.keys:
            e = k.expr
            if isinstance(e, A.Column) and e.name in src.tag_names:
                codes, vocab = src.tag_codes_per_row(e.name)
                code_cols.append(codes.astype(np.int64))
                decoders.append((vocab, None))
                continue
            c = eval_expr(e, src)
            v = c.values
            if v.dtype == object or v.dtype.kind in ("U", "S"):
                uniq, inv = np.unique(v.astype(str), return_inverse=True)
                codes = np.ravel(inv).astype(np.int64)
                vocab = uniq.astype(object)
                null_fill = ""
            else:
                uniq, inv = np.unique(v, return_inverse=True)
                codes = np.ravel(inv).astype(np.int64)
                vocab = uniq
                null_fill = uniq[0] if len(uniq) else 0
            null_code = None
            if c.validity is not None and not c.validity.all():
                # NULL is its own group, distinct from every value
                null_code = len(vocab)
                codes = np.where(c.validity, codes, null_code)
                vocab = np.append(vocab, null_fill)
            code_cols.append(codes)
            decoders.append((vocab, null_code))
        combined = code_cols[0]
        cards = [int(cc.max()) + 1 if len(cc) else 1 for cc in code_cols]
        for cc, card in zip(code_cols[1:], cards[1:]):
            combined = combined * card + cc
        uniq_comb, gid = np.unique(combined, return_inverse=True)
        g = len(uniq_comb)
        # decode group keys from the combined code
        key_cols = {}
        rem = uniq_comb
        for i in range(len(code_cols) - 1, -1, -1):
            card = cards[i]
            code_i = rem % card
            rem = rem // card
            vocab, null_code = decoders[i]
            validity = None
            if null_code is not None:
                validity = code_i != null_code
                if validity.all():
                    validity = None
            key_cols[plan.keys[i].key] = Col(np.asarray(vocab[code_i]),
                                             validity)
        return np.ravel(gid).astype(np.int64), g, key_cols

    def _execute_aggregate(self, plan, src: RowsSource, table) -> QueryResult:
        n = src.num_rows
        if n == 0 and plan.keys:
            names = [nm for _, nm in plan.post_items]
            return self._empty_result(names)
        if n == 0:
            # global aggregate over empty input: one row
            agg_cols = {}
            for a in plan.aggs:
                if a.op in ("count", "count_distinct"):
                    agg_cols[a.key] = Col(np.zeros(1, np.int64))
                else:
                    agg_cols[a.key] = Col(np.zeros(1), np.zeros(1, bool))
            return self._post_project(plan, agg_cols, 1)

        gid, g, key_cols = self._group_ids(plan, src)
        values = {}
        valid_map = {}
        specs = []
        for a in plan.aggs:
            vk = None
            if a.arg is not None:
                vk = f"v{len(values)}"
                c = eval_expr(a.arg, src)
                values[vk] = c.values
                if c.validity is not None:
                    valid_map[vk] = c.validity
            if a.distinct and a.op not in ("count_distinct",):
                raise UnsupportedError(f"DISTINCT {a.op} is not supported")
            specs.append((a.key, a.op, vk, a.q))
        ts = src.rows.ts if src.rows is not None else None
        with stats.timed("reduce_ms"):
            results, path, self.last_reduce = grouped_reduce(
                specs, values, gid, valid_map, g, ts=ts,
                prefer_device=self.prefer_device, device=self.device,
                mesh=self.mesh, mesh_opts=self.mesh_opts,
            )
        stats.add("agg_groups", g)
        self._record_path("aggregate", path)
        agg_cols = dict(key_cols)
        for name, (vals, valid) in results.items():
            agg_cols[name] = Col(
                vals, None if valid is None or valid.all() else valid
            )
        return self._post_project(plan, agg_cols, g)

    def _post_project(self, plan, agg_cols: dict, g: int) -> QueryResult:
        gsrc = DictSource(agg_cols, g)
        if plan.having is not None:
            cond = eval_expr(plan.having, gsrc)
            mask = cond.values.astype(bool) & cond.valid_mask
            agg_cols = {
                k: Col(c.values[mask],
                       None if c.validity is None else c.validity[mask])
                for k, c in agg_cols.items()
            }
            g = int(mask.sum())
            gsrc = DictSource(agg_cols, g)
        names = [nm for _, nm in plan.post_items]
        cols = [eval_expr(e, gsrc) for e, _ in plan.post_items]
        if plan.distinct:
            idx = _distinct_indices(cols)
            cols = _slice_result(cols, idx)
            gsrc = None
        cols = self._order_limit(plan, cols, names, extra_src=gsrc)
        return QueryResult(names, cols)

    def _order_limit(self, plan, cols: list[Col], names: list[str],
                     *, extra_src: ColumnSource | None) -> list[Col]:
        if plan.order_by:
            out_src = DictSource(dict(zip(names, cols)),
                                 len(cols[0]) if cols else 0)
            order_cols = []
            for o in plan.order_by:
                if isinstance(o.expr, A.Column) and o.expr.name in names:
                    order_cols.append(out_src.col(o.expr.name))
                else:
                    src2 = extra_src if extra_src is not None else out_src
                    try:
                        order_cols.append(eval_expr(o.expr, src2))
                    except ColumnNotFoundError:
                        order_cols.append(eval_expr(o.expr, out_src))
            n = len(cols[0]) if cols else 0
            if order_cols and len(order_cols[0]) != n:
                raise ExecutionError("ORDER BY length mismatch")
            idx = _sort_indices(
                order_cols, [o.asc for o in plan.order_by],
                [o.nulls_first for o in plan.order_by],
            )
            cols = _slice_result(cols, idx)
        off = plan.offset or 0
        if off or plan.limit is not None:
            end = None if plan.limit is None else off + plan.limit
            cols = _slice_result(cols, slice(off, end))
        return cols

    # ------------------------------------------------------------------
    # RANGE select on the host
    # ------------------------------------------------------------------
    def _execute_range(self, plan, src: RowsSource, table) -> QueryResult:
        names = [nm for _, nm in plan.post_items]
        if src.num_rows == 0:
            return self._empty_result(names)
        rows = src.rows
        align = plan.align_ms
        if align is None or align <= 0:
            raise PlanError("ALIGN interval must be positive")
        align_to = plan.align_to % align if plan.align_to else 0

        gid, g, key_cols = self._group_ids(plan, src)

        ts = rows.ts
        # distributed fill-grid override: the negotiated global extent
        ts_min = (plan.grid_ts_min if plan.grid_ts_min is not None
                  else int(ts.min()))
        ts_max = (plan.grid_ts_max if plan.grid_ts_max is not None
                  else int(ts.max()))
        max_range = max(r.range_ms for r in plan.range_items)
        # steps t with (t, t+range) ∩ data ≠ ∅:  t > ts_min - range,
        # t <= ts_max
        j_first = -((-(ts_min - max_range + 1 - align_to)) // align)
        j_last = (ts_max - align_to) // align
        n_steps = int(j_last - j_first + 1)
        if n_steps <= 0:
            return self._empty_result(names)
        for item in plan.range_items:
            # the real allocation is g * nb buckets at res = gcd(align,
            # range): guard that, not just g * n_steps
            res_i = int(np.gcd(align, item.range_ms))
            nb_i = (n_steps - 1) * (align // res_i) + item.range_ms // res_i
            if g * nb_i > 64_000_000:
                raise ExecutionError(
                    f"RANGE query too large: {g} groups x {nb_i} buckets "
                    f"(align={align}ms range={item.range_ms}ms gcd={res_i}ms)"
                )
        step_ts = (align_to + (j_first + np.arange(n_steps)) * align).astype(
            np.int64
        )

        item_vals = {}
        item_present = {}
        for item in plan.range_items:
            vals, present = self._range_item(
                item, src, gid, g, ts, align, align_to, j_first, n_steps,
            )
            item_vals[item.key] = vals
            item_present[item.key] = present
        return self._assemble_range_result(
            plan, table, item_vals, item_present, key_cols, step_ts,
            g, n_steps, since_ms=sessions.current_since(),
        )

    def _range_item(self, item, src, gid, g, ts, align, align_to,
                    j_first, n_steps):
        """One `agg(x) RANGE 'r'` item -> (vals, present) shaped
        (g, n_steps). Partial per-bucket states at res = gcd(align,
        range), then the sparse-table window combine."""
        res = int(np.gcd(align, item.range_ms))
        w = item.range_ms // res          # window width in buckets
        stride = align // res             # step stride in buckets
        t0 = align_to + j_first * align   # first window start
        nb = (n_steps - 1) * stride + w   # buckets covering all windows
        bucket = (ts - t0) // res
        in_range = (bucket >= 0) & (bucket < nb)

        if item.arg is not None:
            c = eval_expr(item.arg, src)
            vals = c.values.astype(np.float64, copy=False)
            valid = c.valid_mask & in_range
        else:
            vals = None
            valid = in_range.copy()

        seg = gid * nb + np.clip(bucket, 0, nb - 1)
        nseg = g * nb
        sid = src.rows.sid if src.rows is not None else None
        state = _bucket_partials(item.op, vals, valid, seg, nseg, ts, item.q,
                                 sid=sid)
        state = {k: v.reshape(g, nb) for k, v in state.items()}
        combined = _window_combine(item.op, state, w)
        # sample window starts at stride offsets
        starts = (np.arange(n_steps) * stride).astype(np.int64)
        sampled = {k: v[:, starts] for k, v in combined.items()}
        return _finalize_window(item.op, sampled, item.q)

    def _assemble_range_result(self, plan, table, item_vals, item_present,
                               key_cols, step_ts, g, n_steps,
                               since_ms: int | None = None) -> QueryResult:
        """Fill + output assembly over (g, n_steps) per-item grids, shared
        by the host path and the device grid path. `since_ms` is the delta
        cursor: only cells whose step ts is strictly greater are emitted
        (the fill still runs over the whole grid first, so PREV/LINEAR
        carry from steps before the cursor as in the full result)."""
        ts_type = table.schema.time_index.data_type
        names = [nm for _, nm in plan.post_items]
        any_present = np.zeros((g, n_steps), dtype=bool)
        for item in plan.range_items:
            fill = item.fill if item.fill is not None else plan.fill
            vals, present = _apply_fill(
                item_vals[item.key], item_present[item.key], fill, step_ts
            )
            item_vals[item.key] = vals
            item_present[item.key] = present
            any_present |= present

        # emit (group, step) cells: all cells when filling, else non-empty
        global_fill = plan.fill is not None or any(
            r.fill is not None for r in plan.range_items
        )
        if global_fill:
            cell_mask = np.ones((g, n_steps), dtype=bool)
        else:
            cell_mask = any_present
        if since_ms is not None:
            cell_mask = cell_mask & (step_ts > since_ms)[None, :]
        if not plan.order_by:
            # construct rows already in the default (ts, group keys) order:
            # rank groups once (g keys, not g*steps rows), then emit
            # ts-major — skips the output sort entirely
            perm = _group_order(key_cols, [k.key for k in plan.keys], g)
            nz_s, nz_g = np.nonzero(cell_mask[perm].T)
            gidx = perm[nz_g]
            sidx = nz_s
        else:
            gidx, sidx = np.nonzero(cell_mask)

        out_cols: dict[str, Col] = {}
        out_cols["__ts"] = Col(step_ts[sidx])
        for k, c in key_cols.items():
            out_cols[k] = Col(c.values[gidx],
                              None if c.validity is None else c.validity[gidx])
        for item in plan.range_items:
            v = item_vals[item.key][gidx, sidx]
            p = item_present[item.key][gidx, sidx]
            out_cols[item.key] = Col(v, None if p.all() else p)

        nrows = len(gidx)
        gsrc = DictSource(out_cols, nrows)
        if plan.having is not None:
            cond = eval_expr(plan.having, gsrc)
            hmask = cond.values.astype(bool) & cond.valid_mask
            out_cols = {
                k: Col(c.values[hmask],
                       None if c.validity is None else c.validity[hmask])
                for k, c in out_cols.items()
            }
            nrows = int(hmask.sum())
            gsrc = DictSource(out_cols, nrows)
        cols = [eval_expr(e, gsrc) for e, _ in plan.post_items]
        if plan.distinct:
            didx = _distinct_indices(cols)
            cols = _slice_result(cols, didx)
            out_cols = {
                k: Col(c.values[didx],
                       None if c.validity is None else c.validity[didx])
                for k, c in out_cols.items()
            }
            nrows = len(didx)
            gsrc = DictSource(out_cols, nrows)
        if not plan.order_by:
            # rows were constructed in (ts, group keys) order already
            off = plan.offset or 0
            if off or plan.limit is not None:
                end = None if plan.limit is None else off + plan.limit
                cols = _slice_result(cols, slice(off, end))
        else:
            cols = self._order_limit(plan, cols, names, extra_src=gsrc)
        types = {}
        if plan.ts_out_name:
            for (e, nm) in plan.post_items:
                if isinstance(e, A.Column) and e.name == "__ts":
                    types[nm] = ts_type
        return QueryResult(names, cols, types)


# ----------------------------------------------------------------------
# host RANGE window machinery (copied from the JAX package)
# ----------------------------------------------------------------------

def _bucket_partials(op, vals, valid, seg, nseg, ts, q, *, sid=None):
    """Associative partial state per (group, bucket)."""
    cnt = np.bincount(seg[valid], minlength=nseg).astype(np.float64)
    if op in ("count",):
        return {"n": cnt}
    if vals is None:
        raise PlanError(f"{op} needs an argument")
    vm = np.where(valid, vals, 0.0)
    if op in ("sum", "mean"):
        s = np.bincount(seg, weights=vm, minlength=nseg)
        return {"s": s, "n": cnt}
    if op in ("min", "max"):
        fill = np.inf if op == "min" else -np.inf
        m = np.full(nseg, fill)
        (np.minimum if op == "min" else np.maximum).at(m, seg[valid],
                                                       vals[valid])
        return {"m": m, "n": cnt}
    if op in ("var_pop", "var_samp", "stddev_pop", "stddev_samp"):
        s = np.bincount(seg, weights=vm, minlength=nseg)
        s2 = np.bincount(seg, weights=vm * vm, minlength=nseg)
        return {"s": s, "s2": s2, "n": cnt}
    if op in ("first_value", "last_value"):
        # deterministic tie-break: (ts, sid) lexicographic — last = max ts
        # then max sid, first = min ts then min sid; identical on the
        # device grid path, independent of scan order
        idx = np.arange(len(seg))
        tiebreak = sid if sid is not None else idx
        order = np.lexsort((tiebreak, ts))
        order = order[valid[order]]
        v_last = np.zeros(nseg)
        t_last = np.full(nseg, -(2**62), np.int64)
        v_last[seg[order]] = vals[order]
        t_last[seg[order]] = ts[order]
        v_first = np.zeros(nseg)
        t_first = np.full(nseg, 2**62, np.int64)
        ro = order[::-1]
        v_first[seg[ro]] = vals[ro]
        t_first[seg[ro]] = ts[ro]
        return {"vl": v_last, "tl": t_last.astype(np.float64),
                "vf": v_first, "tf": t_first.astype(np.float64), "n": cnt}
    raise UnsupportedError(f"RANGE aggregate: {op}")


def _combine_states(op, a: dict, b: dict) -> dict:
    """b is the later window half."""
    if op == "count":
        return {"n": a["n"] + b["n"]}
    if op in ("sum", "mean"):
        return {"s": a["s"] + b["s"], "n": a["n"] + b["n"]}
    if op in ("min", "max"):
        f = np.minimum if op == "min" else np.maximum
        return {"m": f(a["m"], b["m"]), "n": a["n"] + b["n"]}
    if op in ("var_pop", "var_samp", "stddev_pop", "stddev_samp"):
        return {"s": a["s"] + b["s"], "s2": a["s2"] + b["s2"],
                "n": a["n"] + b["n"]}
    if op in ("first_value", "last_value"):
        pick_b_last = b["tl"] > a["tl"]
        pick_a_first = a["tf"] <= b["tf"]
        return {
            "vl": np.where(pick_b_last, b["vl"], a["vl"]),
            "tl": np.maximum(a["tl"], b["tl"]),
            "vf": np.where(pick_a_first, a["vf"], b["vf"]),
            "tf": np.minimum(a["tf"], b["tf"]),
            "n": a["n"] + b["n"],
        }
    raise UnsupportedError(op)


def _shift_left(state: dict, k: int, op) -> dict:
    """State array shifted left by k buckets (identity-padded)."""
    out = {}
    for key, v in state.items():
        pad_shape = list(v.shape)
        pad_shape[1] = k
        if key == "m":
            fill = np.inf if op == "min" else -np.inf
        elif key == "tl":
            fill = -(2.0**62)
        elif key == "tf":
            fill = 2.0**62
        else:
            fill = 0.0
        pad = np.full(pad_shape, fill)
        out[key] = np.concatenate([v[:, k:], pad], axis=1)
    return out


def _window_combine(op, state: dict, w: int) -> dict:
    """Sliding combine over w consecutive buckets via stride doubling:
    result[:, i] = combine(buckets i .. i+w-1)."""
    if w == 1:
        return state
    # sparse table: level sizes are powers of two
    levels = []
    size = 1
    cur = state
    while size < w:
        nxt = _combine_states(op, cur, _shift_left(cur, size, op))
        levels.append((size * 2, nxt))
        cur = nxt
        size *= 2
    # decompose w into binary, combining from offset 0
    result = None
    offset = 0
    remaining = w
    tables = {1: state}
    for sz, st in levels:
        tables[sz] = st
    bit = 1
    parts = []
    while remaining:
        if remaining & bit:
            parts.append((offset, bit))
            offset += bit
            remaining &= ~bit
        bit <<= 1
    for off, sz in parts:
        st = tables[sz]
        piece = _shift_left(st, off, op) if off else st
        result = piece if result is None else _combine_states(op, result,
                                                              piece)
    return result


def _finalize_window(op, state: dict, q):
    n = state["n"]
    present = n > 0
    if op == "count":
        return n, present
    if op == "sum":
        return np.where(present, state["s"], 0.0), present
    if op == "mean":
        return state["s"] / np.maximum(n, 1), present
    if op in ("min", "max"):
        return np.where(present, state["m"], 0.0), present
    if op in ("var_pop", "var_samp", "stddev_pop", "stddev_samp"):
        ddof = 1 if op.endswith("_samp") else 0
        mean = state["s"] / np.maximum(n, 1)
        var = state["s2"] / np.maximum(n, 1) - mean * mean
        var = np.maximum(var, 0.0)
        if ddof:
            var = var * n / np.maximum(n - 1, 1)
            present = n > 1
        if op.startswith("stddev"):
            return np.sqrt(var), present
        return var, present
    if op == "last_value":
        return np.where(present, state["vl"], 0.0), present
    if op == "first_value":
        return np.where(present, state["vf"], 0.0), present
    raise UnsupportedError(op)
