"""Query engine: RANGE plans over a table, executed on the card.

`QueryEngine(device=..., mesh=..., mesh_opts=...)` is the seam the JAX
package's engine exposes as `QueryEngine(...).execute(plan, table)`. The
port executes RANGE plans through query/device_range; result assembly
(fill, group order, output projection) is copied from the JAX package's
executor. Plain and
aggregate plans, ORDER BY, HAVING and DISTINCT are later slices and raise
UnsupportedError.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from greptimedb_tpu_torch.device import resolve_device
from greptimedb_tpu_torch.errors import UnsupportedError
from greptimedb_tpu_torch.query import device_range
from greptimedb_tpu_torch.query.planner import Column


@dataclass
class Col:
    """One evaluated column: values + validity (None == all valid)."""

    values: np.ndarray
    validity: np.ndarray | None = None

    def __len__(self):
        return len(self.values)

    @property
    def valid_mask(self) -> np.ndarray:
        if self.validity is None:
            return np.ones(len(self.values), dtype=bool)
        return self.validity


class QueryResult:
    """Columnar query output."""

    def __init__(self, names: list[str], cols: list[Col],
                 types: dict[str, str] | None = None):
        self.names = names
        self.cols = cols
        self.types = types or {}
        self.num_rows = len(cols[0]) if cols else 0

    def column(self, name: str) -> Col:
        return self.cols[self.names.index(name)]


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

    def execute(self, plan, table) -> QueryResult:
        if plan.kind != "range":
            raise UnsupportedError(f"{plan.kind} plans are not ported yet")
        for what, bad in (("ORDER BY", plan.order_by),
                          ("HAVING", plan.having is not None),
                          ("DISTINCT", plan.distinct)):
            if bad:
                raise UnsupportedError(f"{what} on a RANGE plan")
        return device_range.execute_range_device(self, plan, table)

    def _empty_result(self, names: list[str]) -> QueryResult:
        return QueryResult(names, [Col(np.zeros(0)) for _ in names])

    def _assemble_range_result(self, plan, table, item_vals, item_present,
                               key_cols, step_ts, g, n_steps) -> QueryResult:
        """Fill + output assembly over (g, n_steps) per-item grids."""
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
        cell_mask = (np.ones((g, n_steps), dtype=bool) if global_fill
                     else any_present)
        # rows in the default (ts, group keys) order: rank groups once,
        # then emit ts-major
        perm = _group_order(key_cols, [k.key for k in plan.keys], g)
        nz_s, nz_g = np.nonzero(cell_mask[perm].T)
        gidx = perm[nz_g]
        sidx = nz_s

        out_cols: dict[str, Col] = {"__ts": Col(step_ts[sidx])}
        for k, c in key_cols.items():
            out_cols[k] = Col(c.values[gidx],
                              None if c.validity is None else c.validity[gidx])
        for item in plan.range_items:
            v = item_vals[item.key][gidx, sidx]
            p = item_present[item.key][gidx, sidx]
            out_cols[item.key] = Col(v, None if p.all() else p)
        cols = []
        for e, nm in plan.post_items:
            if not isinstance(e, Column):
                raise UnsupportedError(f"output expression {e} ({nm})")
            cols.append(out_cols[e.name])
        off = plan.offset or 0
        if off or plan.limit is not None:
            end = None if plan.limit is None else off + plan.limit
            cols = [Col(c.values[off:end],
                        None if c.validity is None else c.validity[off:end])
                    for c in cols]
        types = {}
        if plan.ts_out_name:
            for e, nm in plan.post_items:
                if isinstance(e, Column) and e.name == "__ts":
                    types[nm] = "timestamp_ms"
        return QueryResult(names, cols, types)
