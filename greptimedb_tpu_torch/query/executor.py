"""Query engine: RANGE plans over a table, executed on the card.

`QueryEngine(device=..., mesh=..., mesh_opts=...)` is the seam the JAX
package's engine exposes as `QueryEngine(...).execute(plan, table)`. The
port executes RANGE plans through query/device_range; result assembly
(fill, group order, HAVING, output expressions through eval_expr,
DISTINCT, ORDER BY, LIMIT/OFFSET) is copied from the JAX package's
executor. Plain and aggregate plans are later slices and raise
UnsupportedError.
"""

from __future__ import annotations

import numpy as np

from greptimedb_tpu_torch.datatypes.types import ConcreteDataType
from greptimedb_tpu_torch.device import resolve_device
from greptimedb_tpu_torch.errors import (
    ColumnNotFoundError,
    ExecutionError,
    UnsupportedError,
)
from greptimedb_tpu_torch.query import device_range
from greptimedb_tpu_torch.query.expr import Col, ColumnSource, eval_expr
from greptimedb_tpu_torch.sql import ast as A

__all__ = ["Col", "QueryResult", "QueryEngine"]


class QueryResult:
    """Columnar query output."""

    def __init__(self, names: list[str], cols: list[Col],
                 types: dict[str, ConcreteDataType] | None = None):
        self.names = names
        self.cols = cols
        self.types = types or {}
        self.num_rows = len(cols[0]) if cols else 0

    def column(self, name: str) -> Col:
        return self.cols[self.names.index(name)]


class DictSource(ColumnSource):
    """Column source over a plain name -> Col mapping (the assembled
    RANGE cells, the output columns)."""

    def __init__(self, cols: dict[str, Col], num_rows: int):
        self.cols = cols
        self.num_rows = num_rows

    def col(self, name: str) -> Col:
        try:
            return self.cols[name]
        except KeyError:
            raise ColumnNotFoundError(f"column not found: {name}") from None


def _sort_indices(cols: list[Col], ascs: list[bool],
                  nulls_first: list[bool | None]) -> np.ndarray:
    """Stable multi-key sort. Numeric keys via lexsort; object keys ranked
    first. SQL default null placement: last for ASC, first for DESC."""
    n = len(cols[0]) if cols else 0
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


def _apply_fill(vals, present, fill):
    """FILL NULL|PREV|LINEAR|<const> along the step axis per group."""
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
        raise UnsupportedError(f"unknown FILL: {fill}") from None
    return np.where(present, vals, const), np.ones_like(present, dtype=bool)


class QueryEngine:
    """Executes RANGE plans against a table on `device` (default CUDA).

    `mesh` (parallel/mesh.make_mesh) lets the planner shard large grids
    over the series axis; `mesh_opts` (parallel/mesh.MeshOptions) holds
    its thresholds and the ring-kernel knob."""

    def __init__(self, device=None, mesh=None, mesh_opts=None,
                 prefer_device: bool = True,
                 byte_budget: int = device_range._BYTE_BUDGET):
        self.device = resolve_device(device)
        if not prefer_device:
            raise UnsupportedError("the host RANGE path is not ported yet")
        self.mesh = mesh
        self.mesh_opts = mesh_opts
        self.range_cache = device_range.DeviceRangeCache(byte_budget)
        # the last RANGE execution: program variant, shard count, mesh
        # decision and declared ring bytes (the JAX package's EXPLAIN
        # ANALYZE notes)
        self.last_range = None
        # "device" after a query ran on the device grid (the JAX engine's
        # observability field; the port has no host RANGE path)
        self.last_exec_path = None

    def execute(self, plan, table) -> QueryResult:
        self.last_exec_path = None
        if plan.kind != "range":
            raise UnsupportedError(f"{plan.kind} plans are not ported yet")
        res = device_range.execute_range_device(self, plan, table)
        self.last_exec_path = "device"
        return res

    def _empty_result(self, names: list[str]) -> QueryResult:
        return QueryResult(names, [Col(np.zeros(0)) for _ in names])

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

    def _assemble_range_result(self, plan, table, item_vals, item_present,
                               key_cols, step_ts, g, n_steps) -> QueryResult:
        """Fill + output assembly over (g, n_steps) per-item grids (the
        JAX package's, without its `since` delta cursor)."""
        ts_type = ConcreteDataType.timestamp_millisecond()
        names = [nm for _, nm in plan.post_items]
        any_present = np.zeros((g, n_steps), dtype=bool)
        for item in plan.range_items:
            fill = item.fill if item.fill is not None else plan.fill
            vals, present = _apply_fill(
                item_vals[item.key], item_present[item.key], fill
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
