"""PromQL evaluation engine over (series x time) grids (the JAX package's
promql/engine.py).

`PromEngine(instance).query_range(promql, start_ms, end_ms, step_ms)`,
`query_instant(promql, time_ms)` and `query_range_result(...)` keep the
JAX signatures. The engine reads `instance.catalog.maybe_table(db, name)`
and `instance.query_engine` (`.device`, `.mesh`, `.mesh_opts`;
query/executor.QueryEngine supplies them).

- Hot shapes go to the grid-cache fast path (promql/fast.py): aggregations
  and topk over a range function or selector, vector/vector binaries and
  histogram_quantile.
- Everything else takes the generic engine: selectors scan the table and
  scatter onto a dense grid on the query engine's device (ops/grid.py),
  instant selection and range functions run as the device window ops
  (ops/window.py, ops/promql.py), cross-series aggregation and
  histogram_quantile as device ops, and label algebra (vector matching,
  by/without grouping, label_replace, set operators) on the host where
  the strings live. This is also the path of every query whose step,
  range or start does not land on a cached grid's cells (instant queries
  step 1 s).

The engine's precision is the JAX package's under jax_enable_x64, which
its tests run with (ROADMAP C2): numbers crossing from the host keep
their numpy dtype on the device (`_up`), so the generic aggregation (G's
float64 sum form on its scatter branch) and histogram_quantile fold
float64 vectors. The generic engine's range functions run with
`fused=False`: the JAX package jits each window function alone with its
scalars as arguments.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass

import numpy as np
import torch

from greptimedb_tpu_torch.errors import (
    ExecutionError,
    PlanError,
    TableNotFoundError,
    UnsupportedError,
)
from greptimedb_tpu_torch.promql import parser as P
from greptimedb_tpu_torch.promql.parser import (
    Agg,
    Binary,
    Call,
    Matcher,
    NumberLit,
    PromExpr,
    StringLit,
    Subquery,
    Unary,
    VectorSelector,
)
from greptimedb_tpu_torch.query import readback
from greptimedb_tpu_torch.query.expr import compile_matcher

DEFAULT_LOOKBACK_MS = 300_000
_MAX_SERIES_GRID = 4096  # series-axis padding bucket cap per grid


@dataclass
class VectorValue:
    """Instant vector sampled at J aligned steps."""

    labels: list[dict]          # S label dicts
    values: np.ndarray          # (S, J) float64
    present: np.ndarray         # (S, J) bool

    @property
    def num_series(self) -> int:
        return len(self.labels)


@dataclass
class ScalarValue:
    values: np.ndarray          # (J,) float64


@dataclass
class StringValue:
    value: str


@dataclass
class MatrixValue:
    """A matrix selector's device grids, consumed by range functions."""

    labels: list[dict]
    vals: object                # (S_pad, T) float32 tensor
    has: object                 # (S_pad, T) bool tensor
    tsg: object                 # (S_pad, T) int32 tensor
    windows: object             # ops.window.Windows
    spec: object                # ops.grid.GridSpec
    num_series: int


@dataclass
class EvalParams:
    start_ms: int
    end_ms: int
    step_ms: int
    lookback_ms: int = DEFAULT_LOOKBACK_MS

    @property
    def num_steps(self) -> int:
        return int((self.end_ms - self.start_ms) // self.step_ms) + 1

    @property
    def step_ts(self) -> np.ndarray:
        return (self.start_ms
                + np.arange(self.num_steps, dtype=np.int64) * self.step_ms)


@dataclass
class _Win:
    """One window plan's tensors on the device, shaped for
    ops/promql.eval_range_function."""

    lo: torch.Tensor
    hi: torch.Tensor
    t_end: torch.Tensor
    range_ticks: int
    l_cells: int


def _series_bucket(s: int) -> int:
    b = 8
    while b < s and b < _MAX_SERIES_GRID:
        b *= 2
    return max(b, s)  # never truncate; beyond the cap pad exactly


class PromEngine:
    def __init__(self, instance, ctx=None):
        self.instance = instance
        self.ctx = ctx
        self._db = getattr(ctx, "database", "public") if ctx else "public"
        # what the last fast-path query ran (promql/fast._note)
        self.last_fast = None

    @property
    def device(self) -> torch.device:
        return self.instance.query_engine.device

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def query_range(self, promql: str, start_ms: int, end_ms: int,
                    step_ms: int, *, lookback_ms: int = DEFAULT_LOOKBACK_MS):
        expr = P.parse_promql(promql)
        ev = EvalParams(start_ms, end_ms, max(int(step_ms), 1), lookback_ms)
        return self._eval(expr, ev), ev

    def query_instant(self, promql: str, time_ms: int, *,
                      lookback_ms: int = DEFAULT_LOOKBACK_MS):
        expr = P.parse_promql(promql)
        ev = EvalParams(time_ms, time_ms, 1000, lookback_ms)
        return self._eval(expr, ev), ev

    def query_range_result(self, promql: str, start_ms: int, end_ms: int,
                           step_ms: int, *,
                           lookback_ms: int = DEFAULT_LOOKBACK_MS):
        """SQL-shaped output (ts, value, labels...), as TQL EVAL returns."""
        from greptimedb_tpu_torch.query.executor import Col, QueryResult

        value, ev = self.query_range(promql, start_ms, end_ms, step_ms,
                                     lookback_ms=lookback_ms)
        step_ts = ev.step_ts
        if isinstance(value, ScalarValue):
            return QueryResult(["ts", "value"],
                               [Col(step_ts), Col(value.values)])
        v = _to_vector(value, ev)
        label_keys = sorted({k for lab in v.labels for k in lab})
        ts_col, val_col = [], []
        lab_cols = {k: [] for k in label_keys}
        for s in range(v.num_series):
            idx = np.nonzero(v.present[s])[0]
            ts_col.append(step_ts[idx])
            val_col.append(v.values[s][idx])
            for k in label_keys:
                lab_cols[k].extend([v.labels[s].get(k, "")] * len(idx))
        ts_all = np.concatenate(ts_col) if ts_col else np.zeros(0, np.int64)
        val_all = np.concatenate(val_col) if val_col else np.zeros(0)
        order = np.argsort(ts_all, kind="stable")
        cols = [Col(ts_all[order]), Col(val_all[order])]
        names = ["ts", "value"]
        for k in label_keys:
            names.append(k)
            cols.append(Col(np.asarray(lab_cols[k], object)[order]))
        return QueryResult(names, cols)

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def _eval(self, e: PromExpr, ev: EvalParams):
        if isinstance(e, NumberLit):
            return ScalarValue(np.full(ev.num_steps, e.value))
        if isinstance(e, StringLit):
            return StringValue(e.value)
        if isinstance(e, VectorSelector):
            if e.range_ms is not None:
                raise PlanError(
                    "matrix selector must be wrapped in a range function")
            return self._eval_instant_selector(e, ev)
        if isinstance(e, Unary):
            v = self._eval(e.expr, ev)
            if isinstance(v, ScalarValue):
                return ScalarValue(-v.values)
            if isinstance(v, VectorValue):
                return VectorValue([_drop_name(lab) for lab in v.labels],
                                   -v.values, v.present)
            raise PlanError("unary - on strings")
        if isinstance(e, Binary):
            return self._eval_binary(e, ev)
        if isinstance(e, Agg):
            from greptimedb_tpu_torch.promql import fast as F

            hit = F.try_fast(self, e, ev)
            if hit is None:
                hit = F.try_fast_topk(self, e, ev)
            if hit is None and isinstance(e.expr, Binary):
                hit = F.try_fast_binary(self, e.expr, ev, agg=e)
            if hit is not None:
                return hit
            return self._eval_agg(e, ev)
        if isinstance(e, Call):
            return self._eval_call(e, ev)
        if isinstance(e, Subquery):
            raise PlanError("subquery must be consumed by a range function")
        raise UnsupportedError(f"cannot evaluate: {e!r}")

    # ------------------------------------------------------------------
    # selectors
    # ------------------------------------------------------------------
    def _resolve_table(self, sel):
        name = sel.name
        field_sel = None
        matchers = []
        for m in sel.matchers:
            if m.name == "__name__":
                if m.op != "=":
                    raise UnsupportedError("__name__ supports = only")
                name = m.value
            elif m.name == "__field__":
                field_sel = m.value
            else:
                matchers.append(m)
        if name is None:
            raise PlanError("selector has no metric name")
        table = self.instance.catalog.maybe_table(self._db, name)
        if table is None and self._db != "public":
            table = self.instance.catalog.maybe_table("public", name)
        return table, field_sel, matchers

    def _value_field(self, table, field_sel: str | None) -> str:
        names = table.field_names
        if field_sel is not None:
            if field_sel not in names:
                raise TableNotFoundError(
                    f"field {field_sel!r} not in {table.name}")
            return field_sel
        if "greptime_value" in names:
            return "greptime_value"
        if "value" in names:
            return "value"
        if len(names) == 1:
            return names[0]
        raise PlanError(
            f"table {table.name} has {len(names)} fields; use "
            '{__field__="..."}')

    def _to_registry_matchers(self, matchers: list[Matcher], table):
        out = []
        for m in matchers:
            if m.op == "=":
                out.append((m.name, "eq", m.value))
            elif m.op == "!=":
                out.append((m.name, "ne", m.value))
            elif m.op == "=~":
                out.append((m.name, "re", compile_matcher(m.value)))
            else:
                out.append((m.name, "nre", compile_matcher(m.value)))
        return out

    def _up(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the query engine's device, dtype kept."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _win(self, windows) -> _Win:
        return _Win(self._up(windows.lo), self._up(windows.hi),
                    self._up(windows.t_end), windows.range_ticks,
                    windows.num_cells_per_window)

    def _scan_grid(self, sel: VectorSelector, ev: EvalParams,
                   range_ms: int) -> MatrixValue | None:
        """Scan and gridify one selector. PromQL's window: samples in
        (t - range, t]; offset shifts the data window."""
        from greptimedb_tpu_torch.ops import grid as G
        from greptimedb_tpu_torch.ops import window as W

        table, field_sel, raw_matchers = self._resolve_table(sel)
        if table is None:
            return None
        fieldname = self._value_field(table, field_sel)
        off = sel.offset_ms
        start = ev.start_ms - off
        end = ev.end_ms - off
        if sel.at_ms is not None:
            start = end = sel.at_ms
        data = table.scan(
            field_names=[fieldname], ts_min=start - range_ms + 1,
            ts_max=end,
            matchers=self._to_registry_matchers(raw_matchers, table) or None)
        if data.rows is None or len(data.rows) == 0:
            spec, windows = W.plan_grid_and_windows(start, end, ev.step_ms,
                                                    range_ms)
            return MatrixValue([], None, None, None, windows, spec, 0)
        rows = data.rows
        # the grid resolution must divide the sample interval, or samples
        # collapse into one cell per window: derive it from the data
        uniq_ts = np.unique(rows.ts)
        interval = (int(np.gcd.reduce(np.diff(uniq_ts)))
                    if len(uniq_ts) > 1 else None)
        spec, windows = W.plan_grid_and_windows(
            start, end, ev.step_ms, range_ms, data_interval_ms=interval)
        uniq_sids, compact = np.unique(rows.sid, return_inverse=True)
        s = len(uniq_sids)
        s_pad = _series_bucket(s)
        labels = []
        visible = set(table.tag_names)
        for sid in uniq_sids:
            lab = dict(data.registry.series_tags(int(sid)))
            # the table's own tags only, never internal (__...) columns
            lab = {k: v for k, v in lab.items()
                   if v != "" and k in visible and not k.startswith("__")}
            lab["__name__"] = table.name
            labels.append(lab)
        mask = np.ones(len(rows), bool)
        if rows.field_valid is not None and fieldname in rows.field_valid:
            mask = rows.field_valid[fieldname].copy()
        gvals, ghas, gtsg = G.gridify(
            self._up(np.ravel(compact).astype(np.int32)),
            self._up(spec.cell_of(rows.ts).astype(np.int32)),
            self._up(spec.device_ts(rows.ts)),
            self._up(rows.fields[fieldname].astype(np.float32)),
            self._up(mask), s_pad, spec.num_cells)
        return MatrixValue(labels, gvals, ghas, gtsg, windows, spec, s)

    def _eval_instant_selector(self, sel: VectorSelector, ev: EvalParams
                               ) -> VectorValue:
        from greptimedb_tpu_torch.ops import window as W

        mat = self._scan_grid(sel, ev, ev.lookback_ms)
        if mat is None or mat.num_series == 0:
            return _empty_vector(ev)
        lookback_ticks = max(int(ev.lookback_ms // mat.spec.unit), 1)
        v, p = W.instant_lookback(mat.vals, mat.has, mat.tsg,
                                  self._up(mat.windows.hi),
                                  self._up(mat.windows.t_end),
                                  lookback_ticks)
        s = mat.num_series
        return VectorValue(mat.labels,
                           readback.read_full(v[:s], np.float64),
                           readback.read_full(p[:s]))

    # ------------------------------------------------------------------
    # range functions and subqueries
    # ------------------------------------------------------------------
    def _eval_matrix(self, e: PromExpr, ev: EvalParams) -> MatrixValue:
        if isinstance(e, VectorSelector):
            if e.range_ms is None:
                raise PlanError("range function needs a matrix selector [d]")
            return self._scan_grid(e, ev, e.range_ms) or MatrixValue(
                [], None, None, None, None, None, 0)
        if isinstance(e, Subquery):
            return self._eval_subquery(e, ev)
        raise PlanError(
            "range function argument must be a matrix selector or subquery")

    def _eval_subquery(self, e: Subquery, ev: EvalParams) -> MatrixValue:
        from greptimedb_tpu_torch.ops import grid as G
        from greptimedb_tpu_torch.ops import window as W

        step = e.step_ms or ev.step_ms
        off = e.offset_ms
        # inner steps aligned to the subquery step (Prometheus floors to a
        # multiple of the step)
        inner_start = ((ev.start_ms - e.range_ms - off) // step) * step
        inner_ev = EvalParams(inner_start, ev.end_ms - off, step,
                              ev.lookback_ms)
        inner = self._eval(e.expr, inner_ev)
        if isinstance(inner, ScalarValue):
            inner = VectorValue([{}], inner.values[None, :],
                                np.ones((1, len(inner.values)), bool))
        if not isinstance(inner, VectorValue):
            raise PlanError("subquery inner expression must be a vector")
        s = inner.num_series
        spec = G.GridSpec.build(inner_start - step, step,
                                inner_ev.num_steps + 1)
        # windows over the inner-step grid: cell i holds the inner step at
        # inner_start + (i - 1) * step
        hi = np.minimum(((ev.step_ts - off) - spec.t0) // spec.res,
                        spec.num_cells - 1).astype(np.int32)
        w_cells = max(e.range_ms // step, 1)
        lo = np.maximum(hi - w_cells, 0).astype(np.int32)
        t_end = (((ev.step_ts - off) - spec.t0) // spec.unit).astype(np.int32)
        windows = W.Windows(lo=lo, hi=hi, t_end=t_end,
                            range_ticks=int(e.range_ms // spec.unit),
                            range_seconds=e.range_ms / 1000.0)
        s_pad = _series_bucket(max(s, 1))
        vals = np.zeros((s_pad, spec.num_cells), np.float32)
        has = np.zeros((s_pad, spec.num_cells), bool)
        tsg = np.zeros((s_pad, spec.num_cells), np.int32)
        cells = spec.cell_of(inner_ev.step_ts).astype(np.int64)
        dts = spec.device_ts(inner_ev.step_ts)
        vals[:s, cells] = inner.values.astype(np.float32)
        has[:s, cells] = inner.present
        tsg[:, cells] = dts[None, :]
        return MatrixValue([_drop_name(lab) for lab in inner.labels],
                           self._up(vals), self._up(has), self._up(tsg),
                           windows, spec, s)

    def _range_function(self, name: str, e: Call, ev: EvalParams
                        ) -> VectorValue:
        from greptimedb_tpu_torch.ops import promql as K

        vec_arg = e.args[-1]
        args: tuple = ()
        if name == "quantile_over_time":
            args = (self._const_scalar(e.args[0], ev),)
            vec_arg = e.args[1]
        elif name == "predict_linear":
            args = (self._const_scalar(e.args[1], ev),)
            vec_arg = e.args[0]
        elif name == "holt_winters":
            args = (self._const_scalar(e.args[1], ev),
                    self._const_scalar(e.args[2], ev))
            vec_arg = e.args[0]
        mat = self._eval_matrix(vec_arg, ev)
        if mat.num_series == 0:
            if name == "absent_over_time":
                return _absent_result(vec_arg, ev)
            return _empty_vector(ev)
        s = mat.num_series
        win = self._win(mat.windows)
        if name == "absent_over_time":
            # joint semantics: 1 where no matching series had samples
            _, pres = K.eval_range_function(
                "present_over_time", mat.vals, mat.has, mat.tsg, win,
                mat.spec.tps, fused=False)
            had = readback.read_full(pres[:s]).any(axis=0)
            return _absent_vector(vec_arg, ev, ~had)
        out, present = K.eval_range_function(
            name, mat.vals, mat.has, mat.tsg, win, mat.spec.tps, args=args,
            fused=False)
        return VectorValue([_drop_name(lab) for lab in mat.labels],
                           readback.read_full(out[:s], np.float64),
                           readback.read_full(present[:s]))

    def _const_scalar(self, e: PromExpr, ev: EvalParams) -> float:
        v = self._eval(e, ev)
        if isinstance(v, ScalarValue):
            return float(v.values[0])
        raise PlanError("expected a scalar parameter")

    # ------------------------------------------------------------------
    # aggregation operators
    # ------------------------------------------------------------------
    def _eval_agg(self, e: Agg, ev: EvalParams) -> VectorValue:
        v = self._eval(e.expr, ev)
        if isinstance(v, ScalarValue):
            v = VectorValue([{}], v.values[None, :],
                            np.ones((1, ev.num_steps), bool))
        if not isinstance(v, VectorValue):
            raise PlanError(f"{e.op} needs an instant vector")
        if v.num_series == 0:
            return _empty_vector(ev)
        out_labels, gid, g = _group_labels(v.labels, e.grouping, e.without)
        if e.op in ("sum", "avg", "min", "max", "count", "group", "stddev",
                    "stdvar"):
            from greptimedb_tpu_torch.ops.promql import (
                aggregate_across_series,
            )

            vals, pres = aggregate_across_series(
                self._up(v.values), self._up(v.present),
                self._up(gid.astype(np.int32)), g, e.op)
            return VectorValue(out_labels,
                               readback.read_full(vals, np.float64),
                               readback.read_full(pres))
        if e.op in ("topk", "bottomk"):
            k = int(self._const_scalar(e.param, ev))
            return _topk(v, gid, g, k, largest=e.op == "topk")
        if e.op == "limitk":
            # k arbitrary series per group, independent of values
            k = int(self._const_scalar(e.param, ev))
            keep_idx = []
            seen: dict[int, int] = {}
            for i in range(v.num_series):
                c = seen.get(int(gid[i]), 0)
                if c < k:
                    keep_idx.append(i)
                    seen[int(gid[i])] = c + 1
            return VectorValue([v.labels[i] for i in keep_idx],
                               v.values[keep_idx], v.present[keep_idx])
        if e.op == "limit_ratio":
            r = self._const_scalar(e.param, ev)
            k = max(int(math.ceil(abs(r) * v.num_series)), 1)
            return _topk(v, gid, g, k, largest=r >= 0)
        if e.op == "quantile":
            phi = self._const_scalar(e.param, ev)
            return _quantile_agg(v, out_labels, gid, g, phi)
        if e.op == "count_values":
            label = self._eval(e.param, ev)
            if not isinstance(label, StringValue):
                raise PlanError("count_values needs a label name string")
            return _count_values(v, label.value, e.grouping, e.without, ev)
        raise UnsupportedError(f"aggregation {e.op}")

    # ------------------------------------------------------------------
    # binary operators
    # ------------------------------------------------------------------
    def _eval_binary(self, e: Binary, ev: EvalParams):
        from greptimedb_tpu_torch.promql import fast as F

        hit = F.try_fast_binary(self, e, ev)
        if hit is not None:
            return hit
        lhs = self._eval(e.lhs, ev)
        rhs = self._eval(e.rhs, ev)
        op = e.op
        if isinstance(lhs, ScalarValue) and isinstance(rhs, ScalarValue):
            out = _apply_op(op, lhs.values, rhs.values)
            if op in P._CMP_OPS:
                out = out.astype(np.float64)
            return ScalarValue(out)
        if isinstance(lhs, VectorValue) and isinstance(rhs, ScalarValue):
            return _vector_scalar(e, lhs, rhs.values, scalar_on_right=True)
        if isinstance(lhs, ScalarValue) and isinstance(rhs, VectorValue):
            return _vector_scalar(e, rhs, lhs.values, scalar_on_right=False)
        if isinstance(lhs, VectorValue) and isinstance(rhs, VectorValue):
            if op in ("and", "or", "unless"):
                return _set_op(e, lhs, rhs)
            return _vector_vector(e, lhs, rhs)
        raise PlanError(f"bad operand types for {op}")

    # ------------------------------------------------------------------
    # function calls
    # ------------------------------------------------------------------
    def _eval_call(self, e: Call, ev: EvalParams):
        from greptimedb_tpu_torch.ops.promql import RANGE_FUNCTIONS

        name = e.name
        if name in RANGE_FUNCTIONS:
            return self._range_function(name, e, ev)
        if name == "histogram_quantile":
            from greptimedb_tpu_torch.promql import fast as F

            phi = self._const_scalar(e.args[0], ev)
            res = F.try_fast_histogram(self, phi, e.args[1], ev)
            if res is not None:
                return res
            return self._histogram_quantile(self._eval(e.args[1], ev), phi,
                                            ev)
        if name == "scalar":
            v = self._eval(e.args[0], ev)
            if not isinstance(v, VectorValue):
                raise PlanError("scalar() needs a vector")
            out = np.full(ev.num_steps, np.nan)
            if v.num_series:
                one = v.present.sum(axis=0) == 1
                idx = np.argmax(v.present, axis=0)
                vals = v.values[idx, np.arange(v.values.shape[1])]
                out = np.where(one, vals, np.nan)
            return ScalarValue(out)
        if name == "vector":
            v = self._eval(e.args[0], ev)
            if isinstance(v, ScalarValue):
                return VectorValue([{}], v.values[None, :],
                                   np.ones((1, ev.num_steps), bool))
            return v
        if name == "time":
            return ScalarValue(ev.step_ts.astype(np.float64) / 1000.0)
        if name == "timestamp":
            v = self._eval(e.args[0], ev)
            if not isinstance(v, VectorValue):
                raise PlanError("timestamp() needs a vector")
            # evaluation-time semantics: the sample's timestamp is the step
            ts = np.broadcast_to(ev.step_ts.astype(np.float64) / 1000.0,
                                 v.values.shape)
            return VectorValue([_drop_name(lab) for lab in v.labels],
                               ts.copy(), v.present.copy())
        if name == "absent":
            v = self._eval(e.args[0], ev)
            if not isinstance(v, VectorValue):
                raise PlanError("absent() needs a vector")
            if v.num_series == 0:
                absent = np.ones(ev.num_steps, bool)
            else:
                absent = ~v.present.any(axis=0)
            return _absent_vector(e.args[0], ev, absent)
        if name in ("sort", "sort_desc"):
            v = self._eval(e.args[0], ev)
            if not isinstance(v, VectorValue) or v.num_series == 0:
                return v
            key = np.where(v.present[:, -1], v.values[:, -1], -np.inf)
            order = np.argsort(key, kind="stable")
            if name == "sort_desc":
                order = order[::-1]
            return VectorValue([v.labels[i] for i in order], v.values[order],
                               v.present[order])
        if name == "label_replace":
            return self._label_replace(e, ev)
        if name == "label_join":
            return self._label_join(e, ev)
        if name == "round":
            v = self._eval(e.args[0], ev)
            to = self._const_scalar(e.args[1], ev) if len(e.args) > 1 else 1.0
            return _map_vector(v, lambda x: np.round(x / to) * to)
        if name == "clamp":
            v = self._eval(e.args[0], ev)
            lo = self._const_scalar(e.args[1], ev)
            hi = self._const_scalar(e.args[2], ev)
            return _map_vector(v, lambda x: np.clip(x, lo, hi))
        if name == "clamp_min":
            v = self._eval(e.args[0], ev)
            lo = self._const_scalar(e.args[1], ev)
            return _map_vector(v, lambda x: np.maximum(x, lo))
        if name == "clamp_max":
            v = self._eval(e.args[0], ev)
            hi = self._const_scalar(e.args[1], ev)
            return _map_vector(v, lambda x: np.minimum(x, hi))
        if name in _MATH_FUNCS:
            if not e.args:
                raise PlanError(f"{name} needs an argument")
            return _map_vector(self._eval(e.args[0], ev), _MATH_FUNCS[name])
        if name in _TIME_COMPONENT_FUNCS:
            fn = _TIME_COMPONENT_FUNCS[name]
            if e.args:
                v = self._eval(e.args[0], ev)
                return _map_vector(v, lambda x: fn(x * 1000.0))
            return ScalarValue(fn(ev.step_ts.astype(np.float64)))
        if name == "pi":
            return ScalarValue(np.full(ev.num_steps, math.pi))
        raise UnsupportedError(f"function {name}")

    def _histogram_quantile(self, v, phi: float, ev: EvalParams
                            ) -> VectorValue:
        """histogram_quantile over any vector: series grouped by their
        labels minus `le`, groups of one bucket layout folded together
        on the device (ops/promql.histogram_quantile)."""
        from greptimedb_tpu_torch.ops.promql import histogram_quantile

        if not isinstance(v, VectorValue) or v.num_series == 0:
            return _empty_vector(ev)
        groups: dict[tuple, list[tuple[float, int]]] = {}
        group_labels: dict[tuple, dict] = {}
        for i, lab in enumerate(v.labels):
            le = lab.get("le")
            if le is None:
                continue
            rest = {k: val for k, val in lab.items()
                    if k not in ("le", "__name__")}
            key = tuple(sorted(rest.items()))
            try:
                le_v = float(le)
            except ValueError:
                continue
            groups.setdefault(key, []).append((le_v, i))
            group_labels[key] = rest
        if not groups:
            return _empty_vector(ev)
        # batch the groups that share one bucket layout
        by_layout: dict[tuple, list[tuple]] = {}
        for key, items in groups.items():
            items.sort()
            by_layout.setdefault(tuple(le for le, _ in items), []).append(key)
        labels_out, vals_out, pres_out = [], [], []
        for layout, keys in by_layout.items():
            le = np.asarray(layout, np.float64)
            if not math.isinf(le[-1]):
                continue  # no +Inf bucket: undefined histogram
            bucket_stack = np.stack([
                np.stack([v.values[i] for _, i in groups[key]], axis=-1)
                for key in keys])                       # (G, J, B)
            mask_stack = np.stack([
                np.stack([v.present[i] for _, i in groups[key]], axis=-1)
                for key in keys])
            out, ok = histogram_quantile(self._up(le), self._up(bucket_stack),
                                         self._up(mask_stack), phi)
            out = readback.read_full(out, np.float64)
            ok = readback.read_full(ok)
            for gi, key in enumerate(keys):
                labels_out.append(group_labels[key])
                vals_out.append(out[gi])
                pres_out.append(ok[gi])
        if not labels_out:
            return _empty_vector(ev)
        return VectorValue(labels_out, np.stack(vals_out), np.stack(pres_out))

    def _label_replace(self, e: Call, ev: EvalParams) -> VectorValue:
        v = self._eval(e.args[0], ev)
        dst = _expect_str(self._eval(e.args[1], ev))
        repl = _expect_str(self._eval(e.args[2], ev))
        src = _expect_str(self._eval(e.args[3], ev))
        regex = re.compile(_expect_str(self._eval(e.args[4], ev)))
        if not isinstance(v, VectorValue):
            raise PlanError("label_replace needs a vector")
        labels = []
        for lab in v.labels:
            m = regex.fullmatch(lab.get(src, ""))
            lab = dict(lab)
            if m:
                new = m.expand(_go_template_to_python(repl))
                if new:
                    lab[dst] = new
                else:
                    lab.pop(dst, None)
            labels.append(lab)
        return VectorValue(labels, v.values.copy(), v.present.copy())

    def _label_join(self, e: Call, ev: EvalParams) -> VectorValue:
        v = self._eval(e.args[0], ev)
        dst = _expect_str(self._eval(e.args[1], ev))
        sep = _expect_str(self._eval(e.args[2], ev))
        srcs = [_expect_str(self._eval(a, ev)) for a in e.args[3:]]
        if not isinstance(v, VectorValue):
            raise PlanError("label_join needs a vector")
        labels = []
        for lab in v.labels:
            lab = dict(lab)
            lab[dst] = sep.join(lab.get(s, "") for s in srcs)
            labels.append(lab)
        return VectorValue(labels, v.values.copy(), v.present.copy())


# ----------------------------------------------------------------------
# helpers (host label algebra, copied from the JAX package)
# ----------------------------------------------------------------------

def _empty_vector(ev: EvalParams) -> VectorValue:
    return VectorValue([], np.zeros((0, ev.num_steps)),
                       np.zeros((0, ev.num_steps), bool))


def _to_vector(v, ev: EvalParams) -> VectorValue:
    if isinstance(v, VectorValue):
        return v
    if isinstance(v, ScalarValue):
        return VectorValue([{}], v.values[None, :],
                           np.ones((1, ev.num_steps), bool))
    raise ExecutionError("expected vector result")


def _drop_name(lab: dict) -> dict:
    return {k: v for k, v in lab.items() if k != "__name__"}


def _group_labels(labels: list[dict], grouping: list[str], without: bool):
    """Group series by by/without label sets: (group label dicts, per-series
    gid, number of groups)."""
    out_labels_map: dict[tuple, int] = {}
    gid = np.zeros(len(labels), np.int32)
    out_labels: list[dict] = []
    for i, lab in enumerate(labels):
        if without:
            g = {k: v for k, v in lab.items()
                 if k not in grouping and k != "__name__"}
        else:
            g = {k: lab[k] for k in grouping if k in lab}
        key = tuple(sorted(g.items()))
        j = out_labels_map.get(key)
        if j is None:
            j = len(out_labels)
            out_labels_map[key] = j
            out_labels.append(g)
        gid[i] = j
    return out_labels, gid, len(out_labels)


def _apply_op(op: str, a, b):
    with np.errstate(divide="ignore", invalid="ignore"):
        if op == "+":
            return a + b
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op == "/":
            return a / b
        if op == "%":
            return np.fmod(a, b)
        if op == "^":
            return np.power(a, b)
        if op == "atan2":
            return np.arctan2(a, b)
        if op == "==":
            return a == b
        if op == "!=":
            return a != b
        if op == "<":
            return a < b
        if op == "<=":
            return a <= b
        if op == ">":
            return a > b
        if op == ">=":
            return a >= b
    raise UnsupportedError(f"operator {op}")


def _vector_scalar(e: Binary, v: VectorValue, s: np.ndarray, *,
                   scalar_on_right: bool):
    a = v.values
    b = s[None, :]
    if not scalar_on_right:
        a, b = b, a
    out = _apply_op(e.op, a, b)
    labels = [_drop_name(lab) for lab in v.labels]
    if e.op in P._CMP_OPS:
        if e.bool_mod:
            return VectorValue(labels, out.astype(np.float64),
                               v.present.copy())
        keep = v.present & np.asarray(out, bool)
        return VectorValue(labels, v.values.copy(), keep)
    return VectorValue(labels, np.asarray(out, np.float64), v.present.copy())


def _match_key(lab: dict, matching) -> tuple:
    if matching.explicit and matching.on:
        return tuple(sorted((k, lab.get(k, "")) for k in matching.labels))
    ignore = set(matching.labels) | {"__name__"}
    return tuple(sorted((k, v) for k, v in lab.items() if k not in ignore))


def _vector_vector(e: Binary, lhs: VectorValue, rhs: VectorValue
                   ) -> VectorValue:
    m = e.matching
    many_side = m.group  # "left" | "right" | None
    one, many = (rhs, lhs) if many_side in (None, "left") else (lhs, rhs)
    one_index: dict[tuple, int] = {}
    for i, lab in enumerate(one.labels):
        k = _match_key(lab, m)
        if k in one_index:
            raise ExecutionError(
                "many-to-many vector matching: duplicate series on the "
                f"'one' side for key {dict(k)}")
        one_index[k] = i
    if many_side is None:
        # one-to-one: duplicate keys on the other side are illegal too
        seen: set[tuple] = set()
        for lab in many.labels:
            k = _match_key(lab, m)
            if k in seen and k in one_index:
                raise ExecutionError(
                    "many-to-many vector matching: duplicate series on "
                    f"both sides for key {dict(k)}")
            seen.add(k)
    labels, vals, pres = [], [], []
    for i, lab in enumerate(many.labels):
        k = _match_key(lab, m)
        j = one_index.get(k)
        if j is None:
            continue
        li = i if many is lhs else j     # index into lhs
        ri = i if many is rhs else j     # index into rhs
        out = _apply_op(e.op, lhs.values[li], rhs.values[ri])
        p = lhs.present[li] & rhs.present[ri]
        if many_side is None:
            out_lab = dict(k)            # one-to-one: the matched key only
        else:
            out_lab = _drop_name(dict(many.labels[i]))
            for inc in m.include:
                if inc in one.labels[j]:
                    out_lab[inc] = one.labels[j][inc]
                else:
                    out_lab.pop(inc, None)
        if e.op in P._CMP_OPS:
            if e.bool_mod:
                vals.append(out.astype(np.float64))
                pres.append(p)
            else:
                # a filtering comparison keeps the LEFT operand's sample
                vals.append(lhs.values[li].astype(np.float64))
                pres.append(p & np.asarray(out, bool))
        else:
            vals.append(np.asarray(out, np.float64))
            pres.append(p)
        labels.append(out_lab)
    if not labels:
        j = lhs.values.shape[1]
        return VectorValue([], np.zeros((0, j)), np.zeros((0, j), bool))
    return VectorValue(labels, np.stack(vals), np.stack(pres))


def _set_op(e: Binary, lhs: VectorValue, rhs: VectorValue) -> VectorValue:
    m = e.matching
    rhs_keys: dict[tuple, int] = {}
    for i, lab in enumerate(rhs.labels):
        rhs_keys.setdefault(_match_key(lab, m), i)
    j_steps = lhs.values.shape[1]
    if e.op in ("and", "unless"):
        labels, vals, pres = [], [], []
        for i, lab in enumerate(lhs.labels):
            j = rhs_keys.get(_match_key(lab, m))
            if e.op == "and":
                if j is None:
                    continue
                p = lhs.present[i] & rhs.present[j]
            else:
                p = lhs.present[i].copy()
                if j is not None:
                    p &= ~rhs.present[j]
            labels.append(lab)
            vals.append(lhs.values[i])
            pres.append(p)
        if not labels:
            return VectorValue([], np.zeros((0, j_steps)),
                               np.zeros((0, j_steps), bool))
        return VectorValue(labels, np.stack(vals), np.stack(pres))
    # or: lhs plus the rhs series whose key has no present lhs point
    lhs_keys: dict[tuple, int] = {}
    for i, lab in enumerate(lhs.labels):
        lhs_keys.setdefault(_match_key(lab, m), i)
    labels = list(lhs.labels)
    vals = [lhs.values[i] for i in range(lhs.num_series)]
    pres = [lhs.present[i] for i in range(lhs.num_series)]
    for i, lab in enumerate(rhs.labels):
        j = lhs_keys.get(_match_key(lab, m))
        p = rhs.present[i].copy()
        if j is not None:
            p &= ~lhs.present[j]
        if p.any():
            labels.append(lab)
            vals.append(rhs.values[i])
            pres.append(p)
    return VectorValue(labels, np.stack(vals), np.stack(pres))


def _topk(v: VectorValue, gid: np.ndarray, g: int, k: int, *,
          largest: bool) -> VectorValue:
    """Per-step top/bottom k within each group; keeps the original series
    labels (Prometheus semantics)."""
    if k <= 0:
        j = v.values.shape[1]
        return VectorValue([], np.zeros((0, j)), np.zeros((0, j), bool))
    keep = np.zeros_like(v.present)
    key = np.where(v.present, v.values, -np.inf if largest else np.inf)
    for grp in range(g):
        sel = np.nonzero(gid == grp)[0]
        if len(sel) == 0:
            continue
        sub = key[sel]  # (Sg, J)
        order = np.argsort(-sub if largest else sub, axis=0, kind="stable")
        topk_rows = order[:k]  # (k, J)
        cols = np.broadcast_to(np.arange(sub.shape[1]), topk_rows.shape)
        mask = np.zeros_like(sub, bool)
        mask[topk_rows, cols] = True
        keep[sel] = mask & v.present[sel]
    nz = keep.any(axis=1)
    return VectorValue([v.labels[i] for i in np.nonzero(nz)[0]],
                       v.values[nz], keep[nz])


def _quantile_agg(v: VectorValue, out_labels, gid, g, phi) -> VectorValue:
    j = v.values.shape[1]
    out = np.zeros((g, j))
    pres = np.zeros((g, j), bool)
    for grp in range(g):
        sel = gid == grp
        sub = v.values[sel]
        sp = v.present[sel]
        cnt = sp.sum(axis=0)
        pres[grp] = cnt > 0
        srt = np.sort(np.where(sp, sub, np.inf), axis=0)
        rank = phi * np.maximum(cnt - 1, 0)
        lo = np.floor(rank).astype(int)
        hi = np.ceil(rank).astype(int)
        cols = np.arange(j)
        n_rows = srt.shape[0]
        v_lo = srt[np.clip(lo, 0, max(n_rows - 1, 0)), cols]
        v_hi = srt[np.clip(hi, 0, max(n_rows - 1, 0)), cols]
        out[grp] = v_lo + (v_hi - v_lo) * (rank - lo)
    return VectorValue(out_labels, out, pres)


def _count_values(v: VectorValue, label: str, grouping, without,
                  ev: EvalParams) -> VectorValue:
    out: dict[tuple, np.ndarray] = {}
    out_labels: dict[tuple, dict] = {}
    base_labels, gid, _ = _group_labels(v.labels, grouping, without)
    for i in range(v.num_series):
        for jj in np.nonzero(v.present[i])[0]:
            lab = dict(base_labels[gid[i]])
            lab[label] = _format_value(v.values[i, jj])
            key = tuple(sorted(lab.items()))
            if key not in out:
                out[key] = np.zeros(ev.num_steps)
                out_labels[key] = lab
            out[key][jj] += 1
    if not out:
        return _empty_vector(ev)
    vals = np.stack([out[k] for k in out])
    return VectorValue([out_labels[k] for k in out], vals, vals > 0)


def _format_value(x: float) -> str:
    if x == int(x) and abs(x) < 1e15:
        return str(int(x))
    return repr(float(x))


def _absent_result(sel, ev: EvalParams) -> VectorValue:
    return _absent_vector(sel, ev, np.ones(ev.num_steps, bool))


def _absent_vector(sel, ev: EvalParams, absent: np.ndarray) -> VectorValue:
    lab = {}
    if isinstance(sel, VectorSelector):
        for m in sel.matchers:
            if m.op == "=" and m.name not in ("__name__", "__field__"):
                lab[m.name] = m.value
    if not absent.any():
        return _empty_vector(ev)
    return VectorValue([lab], np.ones((1, ev.num_steps)), absent[None, :])


def _map_vector(v, fn):
    if isinstance(v, ScalarValue):
        with np.errstate(invalid="ignore", divide="ignore"):
            return ScalarValue(np.asarray(fn(v.values), np.float64))
    if not isinstance(v, VectorValue):
        raise PlanError("expected vector")
    with np.errstate(invalid="ignore", divide="ignore"):
        out = np.asarray(fn(v.values), np.float64)
    return VectorValue([_drop_name(lab) for lab in v.labels], out,
                       v.present.copy())


def _expect_str(v) -> str:
    if isinstance(v, StringValue):
        return v.value
    raise PlanError("expected a string literal")


def _go_template_to_python(repl: str) -> str:
    """Prometheus uses $1-style references; python re.expand uses \\1."""
    return re.sub(r"\$(\d+)", r"\\\1", re.sub(r"\$\{(\d+)\}", r"\\\1", repl))


_MATH_FUNCS = {
    "abs": np.abs, "ceil": np.ceil, "floor": np.floor, "exp": np.exp,
    "sqrt": np.sqrt, "ln": np.log, "log2": np.log2, "log10": np.log10,
    "sin": np.sin, "cos": np.cos, "tan": np.tan, "asin": np.arcsin,
    "acos": np.arccos, "atan": np.arctan, "sinh": np.sinh, "cosh": np.cosh,
    "tanh": np.tanh, "asinh": np.arcsinh, "acosh": np.arccosh,
    "atanh": np.arctanh, "deg": np.degrees, "rad": np.radians,
    "sgn": np.sign,
}


def _dt64(ms):
    return np.asarray(ms, "datetime64[ms]")


def _ms(ms):
    return np.asarray(ms, np.int64)


_TIME_COMPONENT_FUNCS = {
    "minute": lambda ms: ((_ms(ms) // 60_000) % 60).astype(np.float64),
    "hour": lambda ms: ((_ms(ms) // 3_600_000) % 24).astype(np.float64),
    "day_of_week": lambda ms: (
        ((_ms(ms) // 86_400_000) + 4) % 7).astype(np.float64),
    "day_of_month": lambda ms: (
        (_dt64(_ms(ms)).astype("datetime64[D]")
         - _dt64(_ms(ms)).astype("datetime64[M]").astype("datetime64[D]")
         ).astype(np.int64) + 1).astype(np.float64),
    "day_of_year": lambda ms: (
        (_dt64(_ms(ms)).astype("datetime64[D]")
         - _dt64(_ms(ms)).astype("datetime64[Y]").astype("datetime64[D]")
         ).astype(np.int64) + 1).astype(np.float64),
    "month": lambda ms: (
        _dt64(_ms(ms)).astype("datetime64[M]").astype(np.int64) % 12 + 1
    ).astype(np.float64),
    "year": lambda ms: (
        _dt64(_ms(ms)).astype("datetime64[Y]").astype(np.int64) + 1970
    ).astype(np.float64),
    "days_in_month": lambda ms: (
        ((_dt64(_ms(ms)).astype("datetime64[M]") + 1).astype("datetime64[D]")
         - _dt64(_ms(ms)).astype("datetime64[M]").astype("datetime64[D]")
         ).astype(np.int64)).astype(np.float64),
}
