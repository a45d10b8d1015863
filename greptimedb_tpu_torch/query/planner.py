"""SELECT planner: AST -> executable plan (the JAX package's
query/planner.py), and the replicate-vs-shard mesh planner.

- predicate split: WHERE conjuncts become (time-range bounds, tag matchers,
  residual filter); matchers run against the series registry before any
  cell is read;
- RANGE select: per-item `agg(x) RANGE 'r'` windows over ALIGN steps with
  [t, t + range) window semantics; output expressions are rewritten over
  internal column refs (`__ts`, `__key_i`, `__r_i`) and evaluated on the
  host after the device program;
- aggregate and plain plans are built as in the JAX package.

Plans carry the port's own AST (sql/ast.py). `plan_from_fields` copies any
object shaped like a JAX SelectPlan, converting its AST nodes class by
class (attribute access only — nothing of the JAX package is imported).
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field as dc_field

from greptimedb_tpu_torch.datatypes.types import ConcreteDataType, TypeId
from greptimedb_tpu_torch.errors import PlanError, UnsupportedError
from greptimedb_tpu_torch.query import stats
from greptimedb_tpu_torch.query.expr import (
    eval_const,
    format_expr,
    like_to_regex,
    parse_ts_literal,
)
from greptimedb_tpu_torch.query.functions import (
    AGGREGATE_FUNCS,
    contains_aggregate,
)
from greptimedb_tpu_torch.sql import ast as A
from greptimedb_tpu_torch.sql.ast import Column

__all__ = [
    "Column", "ScanSpec", "AggSpec", "KeySpec", "RangeItemSpec",
    "SelectPlan", "MeshDecision", "SHARDABLE_ROW_OPS",
    "decide_mesh_execution", "decide_kernel", "record_kernel_decision",
    "record_scan_path", "record_mesh_decision",
    "analyze_where", "plan_select", "plan_from_fields", "convert_expr",
]


@dataclass
class ScanSpec:
    ts_min: int | None = None
    ts_max: int | None = None
    matchers: list = dc_field(default_factory=list)
    residual: A.Expr | None = None
    # (column, query) pairs of top-level matches() conjuncts (fulltext
    # pruning in the JAX package; rows are filtered by the residual)
    fulltext: list = dc_field(default_factory=list)
    # a ts bound was folded from now()/current_timestamp
    volatile_bounds: bool = False


@dataclass
class AggSpec:
    key: str                      # internal column name "__agg_i"
    op: str                       # normalized aggregate op
    arg: A.Expr | None            # None == count(*)
    distinct: bool = False
    q: float | None = None        # quantile for percentile/median


@dataclass
class KeySpec:
    key: str                      # internal column name "__key_i"
    expr: A.Expr
    name: str                     # output display name


@dataclass
class RangeItemSpec:
    key: str
    op: str
    arg: A.Expr | None            # None == count(*)
    range_ms: int
    fill: str | None = None       # per-item fill override
    q: float | None = None        # quantile


@dataclass
class SelectPlan:
    kind: str                     # plain | aggregate | range
    table_name: str | None = None
    scan: ScanSpec = dc_field(default_factory=ScanSpec)
    items: list = dc_field(default_factory=list)        # (expr, name) plain
    keys: list[KeySpec] = dc_field(default_factory=list)
    aggs: list[AggSpec] = dc_field(default_factory=list)
    range_items: list[RangeItemSpec] = dc_field(default_factory=list)
    post_items: list = dc_field(default_factory=list)   # (expr, name)
    having: A.Expr | None = None
    order_by: list[A.OrderItem] = dc_field(default_factory=list)
    limit: int | None = None
    offset: int | None = None
    distinct: bool = False
    align_ms: int | None = None
    align_to: int = 0
    fill: str | None = None
    ts_out_name: str | None = None
    # explicit RANGE grid extent override (the JAX package's distributed
    # planner sets it; both RANGE paths honour it)
    grid_ts_min: int | None = None
    grid_ts_max: int | None = None

    def explain_lines(self) -> list[str]:
        """EXPLAIN's rendering of the plan (the JAX package's text)."""
        out = [f"SelectPlan[{self.kind}] table={self.table_name}"]
        s = self.scan
        out.append(
            f"  Scan: ts=[{s.ts_min}, {s.ts_max}] "
            f"matchers={[(m[0], m[1]) for m in s.matchers]} "
            f"residual={format_expr(s.residual) if s.residual else None}"
        )
        if self.kind == "aggregate":
            out.append(
                "  Aggregate: keys="
                + str([format_expr(k.expr) for k in self.keys])
                + " aggs="
                + str([f"{a.op}({format_expr(a.arg) if a.arg else '*'})"
                       for a in self.aggs])
            )
        if self.kind == "range":
            out.append(
                f"  Range: align={self.align_ms}ms to={self.align_to} "
                f"by={[format_expr(k.expr) for k in self.keys]} "
                f"items={[f'{r.op} RANGE {r.range_ms}ms' for r in self.range_items]}"
            )
        if self.order_by:
            out.append(
                "  Sort: "
                + ", ".join(
                    f"{format_expr(o.expr)} {'ASC' if o.asc else 'DESC'}"
                    for o in self.order_by
                )
            )
        if self.limit is not None:
            out.append(f"  Limit: {self.limit} offset={self.offset or 0}")
        return out


# ----------------------------------------------------------------------
# replicate-vs-shard planning (copied from the JAX package's planner)
#
# Small grids replicate (one device: launch and hop latency dominate);
# large decomposable reductions shard the series axis across the mesh.
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class MeshDecision:
    mode: str            # "shard" | "replicate"
    reason: str          # why (no mesh, mesh geometry, grid size)
    devices: int = 1     # shard-axis devices the query will use
    # program variant of a sharded execution: "ring" when the ring
    # kernels carry the cross-shard combine (parallel/kernels/ring_fold.
    # RingFoldCtx), "gather" for the gather-and-left-fold twin
    # (parallel/dist.ShardFoldCtx)
    kernel: str = "gather"
    kernel_reason: str = ""

    @property
    def shard(self) -> bool:
        return self.mode == "shard"

    def label(self) -> str:
        return f"{self.mode}({self.reason})"

    def kernel_label(self) -> str:
        return f"{self.kernel}({self.kernel_reason})"


# aggregate shapes whose sharded row fold is exact (blocked partials and
# the ring extremes/one-hot sums reproduce the one-device result bit for
# bit); var/stddev take their deviations against a per-query f32 mean of
# every block, so the row path keeps them on one device. (Every op the
# port lowers to a grid folds exactly across shards, so the grid kinds
# have no op gate.)
SHARDABLE_ROW_OPS = frozenset({
    "count", "sum", "mean", "min", "max", "first_value", "last_value",
})


def decide_mesh_execution(mesh, *, kind: str = "range",
                          series: int | None = None, rows: int | None = None,
                          ops=(), opts=None) -> MeshDecision:
    """Choose replicate vs shard for one query execution site (the JAX
    package's gate): "range" and "promql" are grid kinds and gate on
    `series` (shard_min_series), "aggregate" and "window" are row kinds
    and gate on `rows` (shard_min_rows). `ops` are the row kind's
    normalized aggregate op names; one op that does not fold exactly
    across shards keeps the whole query on one device."""
    from greptimedb_tpu_torch.parallel.mesh import (
        FOLD_BLOCKS, MeshOptions, shard_count,
    )

    if kind not in ("range", "promql", "aggregate", "window"):
        raise ValueError(f"unknown execution kind: {kind}")
    grid = kind in ("range", "promql")
    n_dev = shard_count(mesh)
    if mesh is None or n_dev <= 1:
        return MeshDecision("replicate", "no_mesh")
    opts = opts or MeshOptions()
    bad = [op for op in ops if not grid and op not in SHARDABLE_ROW_OPS]
    if bad:
        return MeshDecision("replicate", f"non_decomposable:{bad[0]}",
                            devices=n_dev)
    if FOLD_BLOCKS % n_dev != 0:
        # blocked exact folds need the shard count to divide the fixed
        # block count; other geometries run replicated (still correct)
        return MeshDecision("replicate", "mesh_indivisible", devices=n_dev)
    if grid:
        if series is not None and series < max(opts.shard_min_series, 1):
            return MeshDecision("replicate", "small_grid", devices=n_dev)
    elif rows is not None and rows < max(opts.shard_min_rows, 1):
        return MeshDecision("replicate", "small_rowset", devices=n_dev)
    kernel, kreason = decide_kernel(kind, series=series, rows=rows,
                                    opts=opts, device=mesh.devices[0])
    return MeshDecision("shard", "large_grid" if grid else "large_rowset",
                        devices=n_dev, kernel=kernel, kernel_reason=kreason)


def decide_kernel(kind: str = "range", *, series: int | None = None,
                  rows: int | None = None, k: int | None = None,
                  opts=None, device=None) -> tuple[str, str]:
    """Choose the program variant of one sharded execution: "ring" runs
    the ring kernels (ring_fold's for "range"/"promql"/"aggregate",
    topk_merge's for "topk"), "gather" the gather twin. "auto" means
    kernels for CUDA tensors (device.kernels_enabled), where the JAX
    package's means the native TPU backend. `k` caps the topk merge kernel
    (O(k^2) rank comparisons per hop); grid kinds gate on `series`
    (pallas_min_series), the row kind on `rows` (pallas_min_rows)."""
    from greptimedb_tpu_torch.device import kernel_mode, kernels_enabled
    from greptimedb_tpu_torch.parallel.mesh import MeshOptions

    opts = opts or MeshOptions()
    mode = kernel_mode(opts.pallas_kernels)
    if mode == "off":
        return "gather", "kernels_off"
    if not kernels_enabled(mode, "cpu" if device is None else device):
        return "gather", "no_cuda"
    if k is not None and k > max(opts.pallas_max_k, 1):
        return "gather", "k_too_large"
    if kind in ("range", "promql", "topk"):
        if series is not None and series < max(opts.pallas_min_series, 1):
            return "gather", "small_grid"
        return "ring", ("ring_topk" if kind == "topk" or k is not None
                        else "ring_fold")
    if rows is not None and rows < max(opts.pallas_min_rows, 1):
        return "gather", "small_rowset"
    return "ring", "ring_fold"


# ----------------------------------------------------------------------
# the planner's decisions: EXPLAIN ANALYZE notes, span attributes, the
# statement's statistics row and the gtpu_mesh_*/gtpu_index_* counters
# ----------------------------------------------------------------------

def _mesh_queries():
    from greptimedb_tpu_torch.telemetry.metrics import global_registry

    return global_registry.counter(
        "gtpu_mesh_queries_total",
        "Mesh execution decisions by mode/reason/site",
        labels=("kind", "mode", "reason"),
    )


def record_kernel_decision(kind: str, kernel: str, reason: str) -> None:
    """Surface one program-variant choice (`mesh_kernel_<kind>`), under
    the "<kind>_kernel" site label of gtpu_mesh_queries_total."""
    from greptimedb_tpu_torch.telemetry import stmt_stats, tracing

    label = f"{kernel}({reason})"
    stats.note(f"mesh_kernel_{kind}", label)
    tracing.set_attr(**{f"mesh_kernel_{kind}": label})
    stmt_stats.note("mesh_kernel", label)
    _mesh_queries().labels(f"{kind}_kernel", kernel, reason).inc()


def record_scan_path(pruned: bool) -> None:
    """Surface whether a scan rode the secondary tag index (`index_pruned`:
    it had matchers and the index is enabled) or read the whole table
    (`full_scan`)."""
    from greptimedb_tpu_torch.telemetry import stmt_stats
    from greptimedb_tpu_torch.telemetry.metrics import global_registry

    path = "index_pruned" if pruned else "full_scan"
    stats.note("scan_path", path)
    stmt_stats.note("scan_path", path)
    global_registry.counter(
        "gtpu_index_scans_total",
        "Statement scans by path (index_pruned | full_scan)",
        labels=("path",),
    ).labels(path).inc()


def record_mesh_decision(decision: MeshDecision, kind: str) -> None:
    """Surface one replicate-vs-shard decision (`mesh_decision_<kind>`),
    the shard count of a sharded one (`mesh_devices`) and its program
    variant. No counter on a one-device process."""
    from greptimedb_tpu_torch.telemetry import stmt_stats, tracing

    stats.note(f"mesh_decision_{kind}", decision.label())
    tracing.set_attr(**{f"mesh_decision_{kind}": decision.label()})
    stmt_stats.note("mesh_decision", decision.label())
    if decision.devices <= 1:
        return
    if decision.shard:
        # only sharded executions spread over the mesh
        active = stats.active()
        if active is not None:
            active.counters["mesh_devices"] = decision.devices
    _mesh_queries().labels(kind, decision.mode, decision.reason).inc()
    if decision.shard and decision.kernel_reason:
        record_kernel_decision(kind, decision.kernel,
                               decision.kernel_reason)


# ----------------------------------------------------------------------
# plans from JAX-shaped objects
# ----------------------------------------------------------------------

_SPEC_CLASSES = {c.__name__: c for c in (ScanSpec, AggSpec, KeySpec,
                                          RangeItemSpec, SelectPlan)}


def convert_expr(e):
    """The port's counterpart of any plan value: an object whose class
    name is a port AST node (sql/ast.py) or plan spec becomes that class,
    field by field; a ConcreteDataType-shaped object (an `id` enum with a
    `.value`) becomes the port's; lists, tuples and dicts convert element
    by element; scalars, strings and compiled regexes pass through."""
    if e is None or isinstance(e, (str, int, float, bool, re.Pattern)):
        return e
    if isinstance(e, list):
        return [convert_expr(x) for x in e]
    if isinstance(e, tuple):
        return tuple(convert_expr(x) for x in e)
    if isinstance(e, dict):
        return {k: convert_expr(v) for k, v in e.items()}
    name = type(e).__name__
    if name == "ConcreteDataType":
        return ConcreteDataType(TypeId(e.id.value), e.precision, e.scale)
    cls = _SPEC_CLASSES.get(name) or getattr(A, name, None)
    if cls is None or not dataclasses.is_dataclass(cls):
        raise UnsupportedError(f"cannot convert plan value {e!r}")
    return cls(**{f.name: convert_expr(getattr(e, f.name))
                  for f in dataclasses.fields(cls)
                  if hasattr(e, f.name)})


def plan_from_fields(obj) -> SelectPlan:
    """Copy a SelectPlan-shaped object's fields into a port plan."""
    return convert_expr(obj)


# ----------------------------------------------------------------------
# SELECT planning (copied from the JAX package's planner)
# ----------------------------------------------------------------------

_NORMALIZE_AGG = {
    "avg": "mean", "mean": "mean", "sum": "sum", "min": "min", "max": "max",
    "count": "count", "stddev": "stddev_samp", "stddev_pop": "stddev_pop",
    "stddev_samp": "stddev_samp", "var": "var_samp", "var_pop": "var_pop",
    "var_samp": "var_samp", "variance": "var_samp",
    "first_value": "first_value", "last_value": "last_value",
    "median": "quantile", "percentile": "quantile", "quantile": "quantile",
    "approx_percentile_cont": "quantile", "percentile_cont": "quantile",
    "count_distinct": "count_distinct", "approx_distinct": "count_distinct",
}


def split_conjuncts(e: A.Expr | None) -> list[A.Expr]:
    if e is None:
        return []
    if isinstance(e, A.BinaryOp) and e.op == "and":
        return split_conjuncts(e.left) + split_conjuncts(e.right)
    return [e]


_VOLATILE_CALLS = frozenset({
    "now", "current_timestamp", "current_time", "current_date",
    "localtime", "localtimestamp", "random", "rand", "uuid",
})


def _has_volatile_call(e) -> bool:
    """Does the expression tree contain an evaluation-time-dependent
    function call (the fold would freeze a different value per plan)?"""
    if isinstance(e, A.FuncCall) and e.name.lower() in _VOLATILE_CALLS:
        return True
    import dataclasses as _dc

    if _dc.is_dataclass(e) and not isinstance(e, type):
        for f in _dc.fields(e):
            v = getattr(e, f.name)
            if isinstance(v, A.Expr) and _has_volatile_call(v):
                return True
            if isinstance(v, (list, tuple)):
                for x in v:
                    if isinstance(x, A.Expr) and _has_volatile_call(x):
                        return True
    return False


def _try_const(e: A.Expr):
    """Constant-fold an expression with no column refs; None on failure."""
    from greptimedb_tpu_torch.query.expr import collect_columns

    if collect_columns(e):
        return None
    try:
        return eval_const(e)
    except Exception:
        return None


def _const_ts(e: A.Expr):
    v = _try_const(e)
    if v is None:
        return None
    if isinstance(v, str):
        try:
            return parse_ts_literal(v)
        except Exception:
            return None
    if isinstance(v, bool):
        return None
    if isinstance(v, (int, float)):
        return int(v)
    return None


def analyze_where(
    where: A.Expr | None, *, ts_name: str, tag_names: list[str]
) -> ScanSpec:
    """Split WHERE into scan-time pruning (time bounds + tag matchers) and a
    residual row filter."""
    spec = ScanSpec()
    residual: list[A.Expr] = []
    for c in split_conjuncts(where):
        if _absorb_time(c, ts_name, spec):
            if _has_volatile_call(c):
                spec.volatile_bounds = True
            continue
        if _absorb_matcher(c, tag_names, spec):
            continue
        if (isinstance(c, A.FuncCall) and c.name == "matches"
                and len(c.args) == 2
                and isinstance(c.args[0], A.Column)
                and isinstance(c.args[1], A.Literal)):
            # stays in the residual for exact row filtering; recorded
            # for index pruning too
            spec.fulltext.append((c.args[0].name, str(c.args[1].value)))
        residual.append(c)
    if residual:
        e = residual[0]
        for r in residual[1:]:
            e = A.BinaryOp("and", e, r)
        spec.residual = e
    return spec


def _absorb_time(c: A.Expr, ts_name: str, spec: ScanSpec) -> bool:
    def tighten(lo=None, hi=None):
        if lo is not None:
            spec.ts_min = lo if spec.ts_min is None else max(spec.ts_min, lo)
        if hi is not None:
            spec.ts_max = hi if spec.ts_max is None else min(spec.ts_max, hi)

    if isinstance(c, A.Between) and not c.negated and isinstance(
        c.operand, A.Column
    ) and c.operand.name == ts_name:
        lo = _const_ts(c.low)
        hi = _const_ts(c.high)
        if lo is None or hi is None:
            return False
        tighten(lo, hi)
        return True
    if not isinstance(c, A.BinaryOp):
        return False
    left, right, op = c.left, c.right, c.op
    if isinstance(right, A.Column) and right.name == ts_name:
        left, right = right, left
        op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op, op)
    if not (isinstance(left, A.Column) and left.name == ts_name):
        return False
    v = _const_ts(right)
    if v is None:
        return False
    if op == ">=":
        tighten(lo=v)
    elif op == ">":
        tighten(lo=v + 1)
    elif op == "<=":
        tighten(hi=v)
    elif op == "<":
        tighten(hi=v - 1)
    elif op == "=":
        tighten(lo=v, hi=v)
    else:
        return False
    return True


def _absorb_matcher(c: A.Expr, tag_names: list[str], spec: ScanSpec) -> bool:
    if isinstance(c, A.InList) and isinstance(c.operand, A.Column) and (
        c.operand.name in tag_names
    ):
        vals = []
        for item in c.items:
            v = _try_const(item)
            if not isinstance(v, str):
                return False
            vals.append(v)
        spec.matchers.append(
            (c.operand.name, "nin" if c.negated else "in", vals)
        )
        return True
    if not isinstance(c, A.BinaryOp):
        return False
    left, right = c.left, c.right
    if isinstance(right, A.Column) and right.name in tag_names and c.op == "=":
        left, right = right, left
    if not (isinstance(left, A.Column) and left.name in tag_names):
        return False
    v = _try_const(right)
    if not isinstance(v, str):
        return False
    if c.op == "=":
        spec.matchers.append((left.name, "eq", v))
    elif c.op == "!=":
        spec.matchers.append((left.name, "ne", v))
    elif c.op == "like":
        spec.matchers.append((left.name, "re", like_to_regex(v)))
    else:
        return False
    return True


class _Rewriter:
    """Pulls aggregates (and matched group keys) out of item expressions,
    replacing them with internal column refs."""

    def __init__(self, keys: list[KeySpec]):
        self.keys = keys
        self.aggs: list[AggSpec] = []
        self._agg_index: dict[str, str] = {}

    def _key_for(self, e: A.Expr) -> str | None:
        for k in self.keys:
            if k.expr == e:
                return k.key
        return None

    def _add_agg(self, fc: A.FuncCall) -> str:
        sig = repr(fc)
        if sig in self._agg_index:
            return self._agg_index[sig]
        if fc.filter is not None:
            # agg(x) FILTER (WHERE c) == agg(CASE WHEN c THEN x END):
            # aggregates skip NULLs, so the CASE's NULL else-arm drops
            # exactly the filtered-out rows (count(*) counts a literal)
            args = list(fc.args)
            if not args or isinstance(args[0], A.Star):
                # count(*): count a filtered literal instead
                args = [A.Case(None, [(fc.filter, A.Literal(1))], None)]
            else:
                # the VALUE argument is the last one (two-arg aggs like
                # quantile(q, x) carry the fraction first)
                arg_pos = len(args) - 1
                args[arg_pos] = A.Case(
                    None, [(fc.filter, args[arg_pos])], None
                )
            fc = A.FuncCall(fc.name, args, distinct=fc.distinct,
                            order_by=fc.order_by)
        name = _NORMALIZE_AGG.get(fc.name)
        if name is None:
            raise UnsupportedError(f"unknown aggregate: {fc.name}")
        q = None
        arg: A.Expr | None
        if fc.name == "median":
            q = 0.5
            arg = fc.args[0]
        elif name == "quantile":
            if len(fc.args) != 2:
                raise PlanError(f"{fc.name}(q, expr) takes 2 arguments")
            q = float(eval_const(fc.args[0]))
            arg = fc.args[1]
        elif fc.name == "count" and (
            not fc.args or isinstance(fc.args[0], A.Star)
        ):
            arg = None
        else:
            if len(fc.args) != 1:
                raise PlanError(f"{fc.name} takes 1 argument")
            arg = fc.args[0]
        distinct = fc.distinct or name == "count_distinct"
        if fc.name == "count" and fc.distinct:
            name = "count_distinct"
        key = f"__agg_{len(self.aggs)}"
        self.aggs.append(AggSpec(key=key, op=name, arg=arg, distinct=distinct, q=q))
        self._agg_index[sig] = key
        return key

    def rewrite(self, e: A.Expr) -> A.Expr:
        if isinstance(e, A.FuncCall) and e.over is not None:
            raise PlanError(
                "window functions combined with GROUP BY/aggregates are "
                "not supported yet"
            )
        k = self._key_for(e)
        if k is not None:
            return A.Column(k)
        if isinstance(e, A.RangeFunc):
            raise PlanError(
                "`agg(x) RANGE '...'` requires an ALIGN clause "
                "(e.g. ... FROM t ALIGN '5s' BY (host))"
            )
        if isinstance(e, A.FuncCall) and e.name in AGGREGATE_FUNCS:
            return A.Column(self._add_agg(e))
        if isinstance(e, A.FuncCall):
            return A.FuncCall(
                e.name, [self.rewrite(a) for a in e.args], e.distinct,
                e.order_by,
            )
        if isinstance(e, A.BinaryOp):
            return A.BinaryOp(e.op, self.rewrite(e.left), self.rewrite(e.right))
        if isinstance(e, A.UnaryOp):
            return A.UnaryOp(e.op, self.rewrite(e.operand))
        if isinstance(e, A.Cast):
            return A.Cast(self.rewrite(e.operand), e.to)
        if isinstance(e, A.Between):
            return A.Between(
                self.rewrite(e.operand), self.rewrite(e.low),
                self.rewrite(e.high), e.negated,
            )
        if isinstance(e, A.InList):
            return A.InList(
                self.rewrite(e.operand), [self.rewrite(i) for i in e.items],
                e.negated,
            )
        if isinstance(e, A.IsNull):
            return A.IsNull(self.rewrite(e.operand), e.negated)
        if isinstance(e, A.Case):
            return A.Case(
                self.rewrite(e.operand) if e.operand else None,
                [(self.rewrite(c), self.rewrite(t)) for c, t in e.whens],
                self.rewrite(e.else_) if e.else_ else None,
            )
        return e


def _resolve_alias(e: A.Expr, items: list[A.SelectItem]) -> A.Expr:
    """GROUP BY / ORDER BY / HAVING may reference select aliases (anywhere
    in the expression) or 1-based positions (top level only)."""
    if isinstance(e, A.Literal) and isinstance(e.value, int) and not (
        isinstance(e.value, bool)
    ):
        idx = e.value - 1
        if 0 <= idx < len(items):
            return items[idx].expr
        raise PlanError(f"position {e.value} is out of range")
    return _resolve_alias_deep(e, items)


def _resolve_alias_deep(e: A.Expr, items: list[A.SelectItem]) -> A.Expr:
    if isinstance(e, A.Column):
        for item in items:
            if item.alias == e.name:
                return item.expr
        return e
    rec = lambda x: _resolve_alias_deep(x, items)
    if isinstance(e, A.BinaryOp):
        return A.BinaryOp(e.op, rec(e.left), rec(e.right))
    if isinstance(e, A.UnaryOp):
        return A.UnaryOp(e.op, rec(e.operand))
    if isinstance(e, A.Cast):
        return A.Cast(rec(e.operand), e.to)
    if isinstance(e, A.Between):
        return A.Between(rec(e.operand), rec(e.low), rec(e.high), e.negated)
    if isinstance(e, A.InList):
        return A.InList(rec(e.operand), [rec(i) for i in e.items], e.negated)
    if isinstance(e, A.IsNull):
        return A.IsNull(rec(e.operand), e.negated)
    if isinstance(e, A.FuncCall):
        return A.FuncCall(e.name, [rec(a) for a in e.args], e.distinct,
                          e.order_by, over=e.over)
    return e


def item_name(item: A.SelectItem) -> str:
    if item.alias:
        return item.alias
    return format_expr(item.expr)


def plan_select(
    stmt: A.Select, *, ts_name: str | None, tag_names: list[str],
    all_columns: list[str] | None,
) -> SelectPlan:
    scan = analyze_where(
        stmt.where, ts_name=ts_name or "", tag_names=tag_names
    )

    # expand * for plain selects
    items = []
    for it in stmt.items:
        if isinstance(it.expr, A.Star):
            if all_columns is None:
                raise PlanError("SELECT * without a table")
            items.extend(A.SelectItem(A.Column(c)) for c in all_columns)
        else:
            items.append(it)

    if stmt.range_clause is not None:
        return _plan_range(stmt, items, scan, ts_name, tag_names)

    group_exprs = [_resolve_alias(g, items) for g in stmt.group_by]
    has_agg = bool(group_exprs) or any(
        contains_aggregate(it.expr) for it in items
    ) or (stmt.having is not None and contains_aggregate(stmt.having))

    if has_agg:
        from greptimedb_tpu_torch.query.window_fns import (
            collect_window_calls,
        )

        wins: list = []
        for it in items:
            collect_window_calls(it.expr, wins)
        for o in stmt.order_by:
            collect_window_calls(o.expr, wins)
        if stmt.having is not None:
            collect_window_calls(stmt.having, wins)
        if wins:
            raise PlanError(
                "window functions combined with GROUP BY/aggregates are "
                "not supported yet"
            )

    if not has_agg:
        plan = SelectPlan(
            kind="plain", table_name=stmt.from_table, scan=scan,
            items=[(it.expr, item_name(it)) for it in items],
            order_by=[
                A.OrderItem(_resolve_alias(o.expr, items), o.asc, o.nulls_first)
                for o in stmt.order_by
            ],
            limit=stmt.limit, offset=stmt.offset, distinct=stmt.distinct,
        )
        if stmt.having is not None:
            raise PlanError("HAVING requires GROUP BY or aggregates")
        return plan

    keys = [
        KeySpec(key=f"__key_{i}", expr=g, name=format_expr(g))
        for i, g in enumerate(group_exprs)
    ]
    rw = _Rewriter(keys)
    post_items = []
    for it in items:
        rewritten = rw.rewrite(it.expr)
        _check_group_refs(rewritten, keys, rw.aggs, it.expr)
        post_items.append((rewritten, item_name(it)))
    having = None
    if stmt.having is not None:
        having = rw.rewrite(_resolve_alias(stmt.having, items))
    order_by = []
    for o in stmt.order_by:
        oe = _resolve_alias(o.expr, items)
        # order-by may reference an output column name directly
        order_by.append(A.OrderItem(rw.rewrite(oe), o.asc, o.nulls_first))
    return SelectPlan(
        kind="aggregate", table_name=stmt.from_table, scan=scan,
        keys=keys, aggs=rw.aggs, post_items=post_items, having=having,
        order_by=order_by, limit=stmt.limit, offset=stmt.offset,
        distinct=stmt.distinct,
    )


def _check_group_refs(e: A.Expr, keys, aggs, original):
    """Every bare column in a rewritten post-agg expr must be an internal
    ref; anything else references a non-grouped column."""
    from greptimedb_tpu_torch.query.expr import collect_columns

    internal = {k.key for k in keys} | {a.key for a in aggs}
    bad = [
        c for c in collect_columns(e)
        if c not in internal and not c.startswith("__")
    ]
    if bad:
        raise PlanError(
            f"column {bad[0]!r} must appear in GROUP BY or an aggregate "
            f"(in {format_expr(original)})"
        )


def _plan_range(
    stmt: A.Select, items: list[A.SelectItem], scan: ScanSpec,
    ts_name: str | None, tag_names: list[str],
) -> SelectPlan:
    rc = stmt.range_clause
    align_to = 0
    if rc.to:
        t = rc.to.strip().lower()
        if t in ("now",):
            import time as _time

            align_to = int(_time.time() * 1000)
            # folded wall clock: the plan re-fingerprints every call
            scan.volatile_bounds = True
        elif t in ("", "calendar"):
            align_to = 0
        else:
            align_to = parse_ts_literal(rc.to)

    by_exprs = rc.by if rc.by is not None else [A.Column(t) for t in tag_names]
    # BY () means a single global group
    keys = [
        KeySpec(key=f"__key_{i}", expr=e, name=format_expr(e))
        for i, e in enumerate(by_exprs)
    ]

    range_items: list[RangeItemSpec] = []
    post_items = []
    ts_out = None

    def rewrite_range(e: A.Expr) -> A.Expr:
        nonlocal ts_out
        if isinstance(e, A.Column) and ts_name and e.name == ts_name:
            ts_out = "__ts"
            return A.Column("__ts")
        for k in keys:
            if k.expr == e:
                return A.Column(k.key)
        if isinstance(e, A.RangeFunc):
            fc = e.func
            op = _NORMALIZE_AGG.get(fc.name)
            if op is None:
                raise UnsupportedError(f"unknown range aggregate: {fc.name}")
            if op == "quantile":
                # needs raw per-window values (not an associative partial
                # state); the sliding sparse-table combine cannot express it
                raise UnsupportedError(
                    f"{fc.name} is not supported in RANGE queries yet"
                )
            arg = None
            if fc.args and not isinstance(fc.args[0], A.Star):
                arg = fc.args[-1]
            key = f"__r_{len(range_items)}"
            range_items.append(RangeItemSpec(
                key=key, op=op, arg=arg, range_ms=e.range_ms, fill=e.fill,
            ))
            return A.Column(key)
        if isinstance(e, A.FuncCall):
            if e.name in AGGREGATE_FUNCS:
                raise PlanError(
                    f"aggregate {e.name} in a RANGE query needs RANGE "
                    "'<interval>'"
                )
            return A.FuncCall(
                e.name, [rewrite_range(a) for a in e.args], e.distinct,
                e.order_by,
            )
        if isinstance(e, A.BinaryOp):
            return A.BinaryOp(e.op, rewrite_range(e.left), rewrite_range(e.right))
        if isinstance(e, A.UnaryOp):
            return A.UnaryOp(e.op, rewrite_range(e.operand))
        if isinstance(e, A.Cast):
            return A.Cast(rewrite_range(e.operand), e.to)
        return e

    for it in items:
        post_items.append((rewrite_range(it.expr), item_name(it)))
    order_by = [
        A.OrderItem(rewrite_range(_resolve_alias(o.expr, items)), o.asc,
                    o.nulls_first)
        for o in stmt.order_by
    ]
    having = None
    if stmt.having is not None:
        having = rewrite_range(_resolve_alias(stmt.having, items))
    if not range_items:
        raise PlanError("RANGE query has no `agg(x) RANGE '...'` items")
    return SelectPlan(
        kind="range", table_name=stmt.from_table, scan=scan, keys=keys,
        range_items=range_items, post_items=post_items, having=having,
        order_by=order_by, limit=stmt.limit, offset=stmt.offset,
        distinct=stmt.distinct,
        align_ms=rc.align_ms, align_to=align_to, fill=rc.fill,
        ts_out_name=ts_out,
    )
