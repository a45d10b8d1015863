"""Host-side (numpy) expression evaluation over columnar batches (a copy of
the JAX package's query/expr.py).

This is the scalar-expression layer of the query engine — the capability
counterpart of DataFusion's PhysicalExpr evaluation in GreptimeDB
(src/query/src/datafusion.rs upstream). Vectorized numpy on the host
handles projections/filters/post-aggregation arithmetic; the *hot*
reductions (range windows) run on the card in query/device_range.py
instead of being evaluated here.

Nulls are explicit validity masks (None == all valid); comparison with null
yields null, and filters treat null as false — SQL three-valued logic.
"""

from __future__ import annotations

import datetime as _dt
import functools
import re
from dataclasses import dataclass

import numpy as np

from greptimedb_tpu_torch.errors import (
    ColumnNotFoundError,
    ExecutionError,
    PlanError,
    UnsupportedError,
)
from greptimedb_tpu_torch.sql import ast as A


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

    def is_all_valid(self) -> bool:
        return self.validity is None or bool(self.validity.all())


class ColumnSource:
    """Resolves column names to Cols; implemented by the executor over scan
    output (fields direct, tags decoded lazily via the series registry).
    rows/tag_names default to the no-raw-rows shape so any source can
    feed the plain/aggregate executor paths (RowsSource overrides)."""

    num_rows: int = 0
    rows = None
    tag_names: list[str] = []

    def col(self, name: str) -> Col:  # pragma: no cover - interface
        raise ColumnNotFoundError(name)


class EmptySource(ColumnSource):
    """For evaluating constant expressions."""

    num_rows = 1

    def col(self, name: str) -> Col:
        raise ColumnNotFoundError(f"column not found: {name}")


@functools.lru_cache(maxsize=1024)
def compile_matcher(pattern: str, flags: int = 0) -> re.Pattern:
    """Memoized regex compile for tag matchers: dashboards repeat the
    same =~ patterns every poll, and re.compile per matcher per query
    was measurable at fleet query rates. Keyed on (pattern, flags) —
    compiled patterns are immutable, so sharing is safe."""
    return re.compile(pattern, flags)


@functools.lru_cache(maxsize=1024)
def like_to_regex(pattern: str) -> re.Pattern:
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return re.compile("".join(out), re.DOTALL)


def parse_ts_literal(text: str) -> int:
    """Timestamp string -> epoch ms. Accepts 'YYYY-MM-DD[ HH:MM:SS[.fff]]',
    ISO-8601 with T/Z, and '+HH:MM' offsets; naive times are UTC."""
    t = text.strip()
    if re.fullmatch(r"[+-]?\d+", t):
        return int(t)
    norm = t.replace("T", " ").replace("Z", "+00:00")
    for fmt in (
        "%Y-%m-%d %H:%M:%S.%f%z", "%Y-%m-%d %H:%M:%S%z",
        "%Y-%m-%d %H:%M:%S.%f", "%Y-%m-%d %H:%M:%S",
        "%Y-%m-%d %H:%M", "%Y-%m-%d%z", "%Y-%m-%d",
    ):
        try:
            dt = _dt.datetime.strptime(norm, fmt)
        except ValueError:
            continue
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=_dt.timezone.utc)
        return int(dt.timestamp() * 1000)
    raise ExecutionError(f"cannot parse timestamp literal: {text!r}")


def _is_string_col(c: Col) -> bool:
    return c.values.dtype == object or c.values.dtype.kind in ("U", "S")


def _coerce_pair(a: Col, b: Col) -> tuple[np.ndarray, np.ndarray]:
    av, bv = a.values, b.values
    if _is_string_col(a) != _is_string_col(b):
        # comparing a string column against a parsed number etc.
        av = av.astype(str) if not _is_string_col(a) else av
        bv = bv.astype(str) if not _is_string_col(b) else bv
    return av, bv


def _merge_validity(*cols: Col) -> np.ndarray | None:
    out = None
    for c in cols:
        if c.validity is not None:
            out = c.validity if out is None else (out & c.validity)
    return out


def eval_expr(e: A.Expr, src: ColumnSource) -> Col:
    n = src.num_rows
    if isinstance(e, A.Literal):
        if e.value is None:
            return Col(np.zeros(n), np.zeros(n, dtype=bool))
        if isinstance(e.value, bool):
            return Col(np.full(n, e.value, dtype=bool))
        if isinstance(e.value, int):
            return Col(np.full(n, e.value, dtype=np.int64))
        if isinstance(e.value, float):
            return Col(np.full(n, e.value, dtype=np.float64))
        return Col(np.full(n, e.value, dtype=object))
    if isinstance(e, A.IntervalLit):
        return Col(np.full(n, e.ms, dtype=np.int64))
    if isinstance(e, A.Column):
        return src.col(e.name)
    if isinstance(e, A.BinaryOp):
        return _eval_binary(e, src)
    if isinstance(e, A.UnaryOp):
        c = eval_expr(e.operand, src)
        if e.op == "-":
            return Col(-c.values, c.validity)
        if e.op == "not":
            return Col(~c.values.astype(bool), c.validity)
        raise UnsupportedError(f"unary op {e.op}")
    if isinstance(e, A.Cast):
        return _eval_cast(e, src)
    if isinstance(e, A.Between):
        v = eval_expr(e.operand, src)
        lo = eval_expr(e.low, src)
        hi = eval_expr(e.high, src)
        out = (v.values >= lo.values) & (v.values <= hi.values)
        if e.negated:
            out = ~out
        return Col(out, _merge_validity(v, lo, hi))
    if isinstance(e, A.InList):
        v = eval_expr(e.operand, src)
        hits = np.zeros(n, dtype=bool)
        for item in e.items:
            iv = eval_expr(item, src)
            a, b = _coerce_pair(v, iv)
            hits |= a == b
        if e.negated:
            hits = ~hits
        return Col(hits, v.validity)
    if isinstance(e, A.IsNull):
        valid = eval_expr(e.operand, src).valid_mask
        return Col(valid if e.negated else ~valid)
    if isinstance(e, A.Case):
        return _eval_case(e, src)
    if isinstance(e, A.FuncCall):
        if e.filter is not None:
            # aggregates consume .filter in the planner; a FuncCall
            # reaching scalar evaluation with one would silently drop it
            raise UnsupportedError(
                "FILTER is only supported on aggregate functions"
            )
        from greptimedb_tpu_torch.query.functions import eval_scalar_function

        return eval_scalar_function(e, src)
    if isinstance(e, A.Star):
        raise PlanError("'*' is only valid as a select item or in count(*)")
    raise UnsupportedError(f"cannot evaluate expression: {e!r}")


def _eval_binary(e: A.BinaryOp, src: ColumnSource) -> Col:
    op = e.op
    a = eval_expr(e.left, src)
    b = eval_expr(e.right, src)
    if op in ("and", "or"):
        av = a.values.astype(bool)
        bv = b.values.astype(bool)
        if op == "and":
            vals = av & bv
            # Kleene: false AND null == false
            if a.validity is None and b.validity is None:
                return Col(vals)
            valid = (a.valid_mask & b.valid_mask) | (a.valid_mask & ~av) | (
                b.valid_mask & ~bv
            )
            return Col(vals & valid, valid)
        vals = av | bv
        if a.validity is None and b.validity is None:
            return Col(vals)
        valid = (a.valid_mask & b.valid_mask) | (a.valid_mask & av) | (
            b.valid_mask & bv
        )
        return Col(vals, valid)

    validity = _merge_validity(a, b)
    if op in ("=", "!=", "<", "<=", ">", ">="):
        av, bv = _coerce_pair(a, b)
        with np.errstate(invalid="ignore"):
            if op == "=":
                out = av == bv
            elif op == "!=":
                out = av != bv
            elif op == "<":
                out = av < bv
            elif op == "<=":
                out = av <= bv
            elif op == ">":
                out = av > bv
            else:
                out = av >= bv
        return Col(np.asarray(out, dtype=bool), validity)
    if op == "like":
        if isinstance(e.right, A.Literal) and isinstance(e.right.value, str):
            rx = like_to_regex(e.right.value)
            vals = np.asarray(
                [bool(rx.fullmatch(str(v))) for v in a.values], dtype=bool
            )
        else:
            # per-row pattern (LIKE against a column)
            vals = np.asarray(
                [
                    bool(like_to_regex(str(p)).fullmatch(str(v)))
                    for v, p in zip(a.values, b.values)
                ],
                dtype=bool,
            )
        return Col(vals, validity)
    if op == "||":
        av, bv = a.values.astype(object), b.values.astype(object)
        return Col(
            np.asarray([str(x) + str(y) for x, y in zip(av, bv)], object),
            validity,
        )
    # arithmetic — a string combined with an INTERVAL is a timestamp
    # literal ('2024-01-01' - interval '1 hour'), matching the
    # reference's implicit timestamp coercion
    if op in ("+", "-"):
        def _as_ts(col: Col) -> Col:
            valid = col.valid_mask
            out = np.zeros(len(col.values), np.int64)
            for k, v in enumerate(col.values):
                if valid[k]:  # null slots stay 0 and propagate as NULL
                    out[k] = parse_ts_literal(str(v))
            return Col(out, col.validity)

        if isinstance(e.right, A.IntervalLit) and a.values.dtype == object:
            a = _as_ts(a)
        if isinstance(e.left, A.IntervalLit) and b.values.dtype == object:
            b = _as_ts(b)
    av, bv = a.values, b.values
    with np.errstate(divide="ignore", invalid="ignore"):
        if op == "+":
            out = av + bv
        elif op == "-":
            out = av - bv
        elif op == "*":
            out = av * bv
        elif op == "/":
            if np.issubdtype(np.asarray(av).dtype, np.integer) and np.issubdtype(
                np.asarray(bv).dtype, np.integer
            ):
                safe = np.where(bv == 0, 1, bv)
                out = av // safe
                bad = bv == 0
            else:
                out = av / np.where(bv == 0, np.nan, bv)
                bad = bv == 0
            if bad.any():
                validity = (
                    ~bad if validity is None else (validity & ~bad)
                )
        elif op == "%":
            safe = np.where(bv == 0, 1, bv)
            out = np.mod(av, safe)
            bad = bv == 0
            if bad.any():
                validity = ~bad if validity is None else (validity & ~bad)
        else:
            raise UnsupportedError(f"binary op {op}")
    return Col(out, validity)


def _eval_cast(e: A.Cast, src: ColumnSource) -> Col:
    c = eval_expr(e.operand, src)
    to = e.to
    if to.is_timestamp():
        if _is_string_col(c):
            vals = np.asarray(
                [parse_ts_literal(str(v)) for v in c.values], np.int64
            )
        else:
            vals = c.values.astype(np.int64)
        return Col(vals, c.validity)
    if to.is_string():
        return Col(c.values.astype(str).astype(object), c.validity)
    if _is_string_col(c) and to.is_numeric():
        np_t = to.to_numpy()
        out = np.zeros(len(c.values), np_t)
        valid = c.valid_mask.copy()
        for i, v in enumerate(c.values):
            try:
                out[i] = np_t.type(float(v))
            except (TypeError, ValueError):
                valid[i] = False
        return Col(out, valid)
    return Col(c.values.astype(to.to_numpy()), c.validity)


def _eval_case(e: A.Case, src: ColumnSource) -> Col:
    n = src.num_rows
    if e.operand is not None:
        op = eval_expr(e.operand, src)
    result = None
    validity = None
    decided = np.zeros(n, dtype=bool)
    for cond_e, then_e in e.whens:
        if e.operand is not None:
            cv = eval_expr(cond_e, src)
            a, b = _coerce_pair(op, cv)
            cond = (a == b) & op.valid_mask & cv.valid_mask
        else:
            cc = eval_expr(cond_e, src)
            cond = cc.values.astype(bool) & cc.valid_mask
        pick = cond & ~decided
        tv = eval_expr(then_e, src)
        if result is None:
            result = np.zeros(n, dtype=tv.values.dtype)
            validity = np.zeros(n, dtype=bool)
        result = np.where(pick, tv.values, result)
        validity = np.where(pick, tv.valid_mask, validity)
        decided |= cond
    if e.else_ is not None:
        ev = eval_expr(e.else_, src)
        if result is None:
            result = ev.values.copy()
            validity = ev.valid_mask.copy()
        else:
            result = np.where(decided, result, ev.values)
            validity = np.where(decided, validity, ev.valid_mask)
    elif result is None:
        return Col(np.zeros(n), np.zeros(n, dtype=bool))
    else:
        validity = validity & decided
    return Col(result, None if validity.all() else validity)


def eval_const(e: A.Expr):
    """Evaluate a constant expression to a python scalar (None if null)."""
    c = eval_expr(e, EmptySource())
    if c.validity is not None and not c.validity[0]:
        return None
    v = c.values[0]
    if isinstance(v, np.generic):
        return v.item()
    return v


def collect_columns(e: A.Expr, out: set[str] | None = None) -> set[str]:
    """All column names referenced by an expression."""
    if out is None:
        out = set()
    if isinstance(e, A.Column):
        out.add(e.name)
    elif isinstance(e, A.BinaryOp):
        collect_columns(e.left, out)
        collect_columns(e.right, out)
    elif isinstance(e, A.UnaryOp):
        collect_columns(e.operand, out)
    elif isinstance(e, A.Cast):
        collect_columns(e.operand, out)
    elif isinstance(e, A.Between):
        for x in (e.operand, e.low, e.high):
            collect_columns(x, out)
    elif isinstance(e, A.InList):
        collect_columns(e.operand, out)
        for x in e.items:
            collect_columns(x, out)
    elif isinstance(e, A.IsNull):
        collect_columns(e.operand, out)
    elif isinstance(e, A.Case):
        if e.operand:
            collect_columns(e.operand, out)
        for c, t in e.whens:
            collect_columns(c, out)
            collect_columns(t, out)
        if e.else_:
            collect_columns(e.else_, out)
    elif isinstance(e, A.FuncCall):
        for x in e.args:
            collect_columns(x, out)
        if e.over is not None:
            for p in e.over.partition_by:
                collect_columns(p, out)
            for o in e.over.order_by:
                collect_columns(o.expr, out)
    elif isinstance(e, A.RangeFunc):
        collect_columns(e.func, out)
    return out


def format_expr(e: A.Expr) -> str:
    """Render an expression back to SQL-ish text (output column naming)."""
    if isinstance(e, A.Literal):
        if isinstance(e.value, str):
            escaped = e.value.replace("'", "''")
            return f"'{escaped}'"
        if e.value is None:
            return "NULL"
        return str(e.value)
    if isinstance(e, A.IntervalLit):
        # INTERVAL form round-trips compound intervals ('1 hour 30 minutes')
        return f"INTERVAL '{e.raw}'"
    if isinstance(e, A.Column):
        return e.name
    if isinstance(e, A.Star):
        return "*"
    if isinstance(e, A.BinaryOp):
        op = {"and": "AND", "or": "OR", "like": "LIKE"}.get(e.op, e.op)
        return f"{format_expr(e.left)} {op} {format_expr(e.right)}"
    if isinstance(e, A.UnaryOp):
        return f"{'-' if e.op == '-' else 'NOT '}{format_expr(e.operand)}"
    if isinstance(e, A.FuncCall):
        inner = ", ".join(format_expr(a) for a in e.args)
        if e.distinct:
            inner = "DISTINCT " + inner
        return f"{e.name}({inner})"
    if isinstance(e, A.RangeFunc):
        return f"{format_expr(e.func)} RANGE {e.range_ms}ms"
    if isinstance(e, A.Cast):
        return f"CAST({format_expr(e.operand)} AS {e.to.name})"
    if isinstance(e, A.Between):
        neg = " NOT" if e.negated else ""
        return (
            f"{format_expr(e.operand)}{neg} BETWEEN "
            f"{format_expr(e.low)} AND {format_expr(e.high)}"
        )
    if isinstance(e, A.InList):
        neg = " NOT" if e.negated else ""
        items = ", ".join(format_expr(i) for i in e.items)
        return f"{format_expr(e.operand)}{neg} IN ({items})"
    if isinstance(e, A.IsNull):
        return f"{format_expr(e.operand)} IS{' NOT' if e.negated else ''} NULL"
    if isinstance(e, A.Case):
        return "CASE ..."
    return repr(e)
