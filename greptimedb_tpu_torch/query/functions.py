"""Scalar SQL function registry (host, vectorized numpy; a copy of the JAX
package's query/functions.py).

GreptimeDB's function registry (src/common/function/src/scalars/ upstream
and DataFusion built-ins): date/time functions, math, string helpers,
conditionals. Aggregate functions are NOT here — the planner turns them
into range items. The fulltext functions evaluate through
query/fulltext.py, the json/geo/net families through query/functions_ext.py.
"""

from __future__ import annotations

import datetime as _dt
import time

import numpy as np

from greptimedb_tpu_torch.errors import PlanError, UnsupportedError
from greptimedb_tpu_torch.query.expr import (
    Col,
    ColumnSource,
    eval_expr,
    parse_ts_literal,
)
from greptimedb_tpu_torch.sql import ast as A

_TRUNC_UNIT_MS = {
    "second": 1000,
    "minute": 60_000,
    "hour": 3_600_000,
    "day": 86_400_000,
    "week": 604_800_000,  # aligned to epoch Thursday; see below
}


def _interval_months(arg) -> int | None:
    """Total SIGNED months when `arg` is an INTERVAL literal made ONLY
    of year/month units (calendar arithmetic applies); None otherwise.
    The sign must survive: date_add(ts, INTERVAL '-1 month') subtracts."""
    import re as _re

    if not isinstance(arg, A.IntervalLit):
        return None
    raw = (arg.raw or "").lower()
    parts = _re.findall(r"(-?\s*\d+)\s*([a-z]+)", raw)
    if not parts:
        return None
    months = 0
    for num, unit in parts:
        num = num.replace(" ", "")
        if unit.startswith("year") or unit == "y":
            months += int(num) * 12
        elif unit.startswith("mon"):
            months += int(num)
        else:
            return None  # mixed/time units: fixed-span ms path
    return months


def _add_months(ts_ms: np.ndarray, months: int) -> np.ndarray:
    """Calendar month addition with end-of-month day clamping, fully
    vectorized over numpy datetime64."""
    dt = ts_ms.astype("datetime64[ms]")
    month0 = dt.astype("datetime64[M]")
    intra = (dt - month0).astype("timedelta64[ms]").astype(np.int64)
    new_month = month0 + np.timedelta64(months, "M")
    mlen_ms = ((new_month + np.timedelta64(1, "M")).astype("datetime64[ms]")
               - new_month.astype("datetime64[ms]")
               ).astype("timedelta64[ms]").astype(np.int64)
    day_ms = 86_400_000
    days = np.minimum(intra // day_ms, mlen_ms // day_ms - 1)
    tod = intra % day_ms
    return (new_month.astype("datetime64[ms]").astype(np.int64)
            + days * day_ms + tod)


def _ts_ms(c: Col) -> np.ndarray:
    if c.values.dtype == object:
        return np.asarray([parse_ts_literal(str(v)) for v in c.values], np.int64)
    return c.values.astype(np.int64)


def _date_trunc(unit: str, ts_ms: np.ndarray) -> np.ndarray:
    unit = unit.lower()
    if unit in _TRUNC_UNIT_MS:
        q = _TRUNC_UNIT_MS[unit]
        if unit == "week":
            # ISO weeks start Monday; epoch (1970-01-01) is a Thursday.
            off = 3 * 86_400_000
            return (ts_ms + off) // q * q - off
        return np.floor_divide(ts_ms, q) * q
    # calendar units via numpy datetime64
    dt64 = ts_ms.astype("datetime64[ms]")
    if unit == "month":
        return dt64.astype("datetime64[M]").astype("datetime64[ms]").astype(np.int64)
    if unit == "quarter":
        months = dt64.astype("datetime64[M]").astype(np.int64)
        return (
            ((months // 3) * 3).astype("datetime64[M]")
            .astype("datetime64[ms]").astype(np.int64)
        )
    if unit == "year":
        return dt64.astype("datetime64[Y]").astype("datetime64[ms]").astype(np.int64)
    raise UnsupportedError(f"date_trunc unit: {unit}")


def _extract_part(part: str, ts_ms: np.ndarray) -> np.ndarray:
    part = part.lower()
    dt64 = ts_ms.astype("datetime64[ms]")
    if part in ("epoch", "unix"):
        return ts_ms / 1000.0
    if part == "millisecond":
        return (ts_ms % 1000).astype(np.float64)
    if part == "second":
        return ((ts_ms // 1000) % 60).astype(np.float64)
    if part == "minute":
        return ((ts_ms // 60_000) % 60).astype(np.float64)
    if part == "hour":
        return ((ts_ms // 3_600_000) % 24).astype(np.float64)
    if part in ("day", "dom"):
        day = dt64.astype("datetime64[D]")
        month = dt64.astype("datetime64[M]")
        return (day - month.astype("datetime64[D]")).astype(np.int64) + 1.0
    if part in ("dow", "dayofweek"):
        days = dt64.astype("datetime64[D]").astype(np.int64)
        return ((days + 4) % 7).astype(np.float64)  # 0=Sunday
    if part in ("doy", "dayofyear"):
        day = dt64.astype("datetime64[D]")
        year = dt64.astype("datetime64[Y]")
        return (day - year.astype("datetime64[D]")).astype(np.int64) + 1.0
    if part == "week":
        days = dt64.astype("datetime64[D]").astype(np.int64)
        return (((days + 3) // 7)).astype(np.float64)
    if part == "month":
        month = dt64.astype("datetime64[M]").astype(np.int64)
        return (month % 12 + 1).astype(np.float64)
    if part == "quarter":
        month = dt64.astype("datetime64[M]").astype(np.int64)
        return ((month % 12) // 3 + 1).astype(np.float64)
    if part == "year":
        return (dt64.astype("datetime64[Y]").astype(np.int64) + 1970).astype(
            np.float64
        )
    raise UnsupportedError(f"extract part: {part}")


def _strftime(ts_ms: np.ndarray, fmt: str) -> np.ndarray:
    out = np.empty(len(ts_ms), dtype=object)
    for i, v in enumerate(ts_ms):
        out[i] = _dt.datetime.fromtimestamp(
            int(v) / 1000.0, _dt.timezone.utc
        ).strftime(fmt)
    return out


def _const_arg(e: A.Expr):
    from greptimedb_tpu_torch.query.expr import eval_const

    return eval_const(e)


def eval_scalar_function(e: A.FuncCall, src: ColumnSource) -> Col:
    name = e.name
    n = src.num_rows
    args = e.args

    # ---- time ---------------------------------------------------------
    if name == "now" or name == "current_timestamp":
        return Col(np.full(n, int(time.time() * 1000), np.int64))
    if name == "date_trunc":
        if len(args) != 2:
            raise PlanError("date_trunc(unit, ts)")
        unit = str(_const_arg(args[0]))
        c = eval_expr(args[1], src)
        return Col(_date_trunc(unit, _ts_ms(c)), c.validity)
    if name == "date_bin":
        # date_bin(interval, ts[, origin])
        if len(args) < 2:
            raise PlanError("date_bin(interval, ts[, origin])")
        iv = _const_arg(args[0])
        iv_ms = int(iv) if not isinstance(iv, str) else _parse_interval(iv)
        c = eval_expr(args[1], src)
        origin = 0
        if len(args) > 2:
            o = _const_arg(args[2])
            origin = parse_ts_literal(str(o)) if isinstance(o, str) else int(o)
        ts = _ts_ms(c)
        return Col((ts - origin) // iv_ms * iv_ms + origin, c.validity)
    if name in ("to_unixtime", "to_unix_timestamp"):
        c = eval_expr(args[0], src)
        return Col(_ts_ms(c) // 1000, c.validity)
    if name == "from_unixtime":
        c = eval_expr(args[0], src)
        return Col(c.values.astype(np.int64) * 1000, c.validity)
    if name in ("to_timestamp", "to_timestamp_seconds"):
        # seconds (or a parsable string) -> timestamp ms (GreptimeDB:
        # DataFusion to_timestamp family)
        c = eval_expr(args[0], src)
        if c.values.dtype == object:
            vals = _ts_ms(c)  # string parse yields ms directly
        else:
            vals = (c.values.astype(np.float64) * 1000).astype(np.int64)
        return Col(vals, c.validity)
    if name == "to_timestamp_millis":
        c = eval_expr(args[0], src)
        return Col(_ts_ms(c), c.validity)
    if name in ("date_add", "date_sub"):
        # date_add(ts, interval) / date_sub(ts, interval) — the
        # GreptimeDB scalars/date.rs pair. Pure month/year intervals
        # use CALENDAR arithmetic with end-of-month clamping (Jan 31 +
        # 1 month = Feb 29), not a fixed 30-day span.
        if len(args) != 2:
            raise PlanError(f"{name}(ts, interval)")
        from greptimedb_tpu_torch.query.expr import _merge_validity

        c = eval_expr(args[0], src)
        sign = 1 if name == "date_add" else -1
        months = _interval_months(args[1])
        if months is not None:
            out = _add_months(_ts_ms(c), sign * months)
            return Col(out, c.validity)
        iv = eval_expr(args[1], src)
        delta = iv.values.astype(np.int64)
        return Col(_ts_ms(c) + sign * delta, _merge_validity(c, iv))
    if name == "date_format":
        c = eval_expr(args[0], src)
        fmt = str(_const_arg(args[1]))
        return Col(_strftime(_ts_ms(c), fmt), c.validity)
    if name == "extract" or name == "date_part":
        part = str(_const_arg(args[0]))
        c = eval_expr(args[1], src)
        return Col(_extract_part(part, _ts_ms(c)), c.validity)

    # ---- math ---------------------------------------------------------
    if name in ("abs", "floor", "ceil", "sqrt", "exp", "sin", "cos", "tan",
                "asin", "acos", "atan", "sinh", "cosh", "tanh", "sign"):
        c = eval_expr(args[0], src)
        fn = {"ceil": np.ceil, "sign": np.sign}.get(name) or getattr(np, name)
        with np.errstate(invalid="ignore", divide="ignore"):
            return Col(fn(c.values.astype(np.float64)), c.validity)
    if name == "ln":
        c = eval_expr(args[0], src)
        with np.errstate(invalid="ignore", divide="ignore"):
            return Col(np.log(c.values.astype(np.float64)), c.validity)
    if name == "log10" or name == "log":
        c = eval_expr(args[-1], src)
        with np.errstate(invalid="ignore", divide="ignore"):
            if name == "log" and len(args) == 2:
                base = float(_const_arg(args[0]))
                return Col(
                    np.log(c.values.astype(np.float64)) / np.log(base),
                    c.validity,
                )
            return Col(np.log10(c.values.astype(np.float64)), c.validity)
    if name == "log2":
        c = eval_expr(args[0], src)
        with np.errstate(invalid="ignore", divide="ignore"):
            return Col(np.log2(c.values.astype(np.float64)), c.validity)
    if name in ("pow", "power"):
        a = eval_expr(args[0], src)
        b = eval_expr(args[1], src)
        from greptimedb_tpu_torch.query.expr import _merge_validity

        return Col(
            np.power(a.values.astype(np.float64), b.values.astype(np.float64)),
            _merge_validity(a, b),
        )
    if name == "round":
        c = eval_expr(args[0], src)
        digits = int(_const_arg(args[1])) if len(args) > 1 else 0
        return Col(np.round(c.values.astype(np.float64), digits), c.validity)
    if name in ("mod",):
        a = eval_expr(args[0], src)
        b = eval_expr(args[1], src)
        from greptimedb_tpu_torch.query.expr import _merge_validity

        return Col(np.mod(a.values, np.where(b.values == 0, 1, b.values)),
                   _merge_validity(a, b))
    if name in ("greatest", "least"):
        cols = [eval_expr(a, src) for a in args]
        out = cols[0].values.astype(np.float64)
        for c in cols[1:]:
            out = (np.maximum if name == "greatest" else np.minimum)(
                out, c.values.astype(np.float64)
            )
        from greptimedb_tpu_torch.query.expr import _merge_validity

        return Col(out, _merge_validity(*cols))
    if name == "clamp":
        c = eval_expr(args[0], src)
        lo = float(_const_arg(args[1]))
        hi = float(_const_arg(args[2]))
        return Col(np.clip(c.values.astype(np.float64), lo, hi), c.validity)

    # ---- conditionals / null handling ---------------------------------
    if name == "coalesce":
        cols = [eval_expr(a, src) for a in args]
        vals = cols[0].values.copy()
        valid = cols[0].valid_mask.copy()
        for c in cols[1:]:
            need = ~valid
            vals = np.where(need, c.values, vals)
            valid = valid | (need & c.valid_mask)
        return Col(vals, None if valid.all() else valid)
    if name == "nullif":
        a = eval_expr(args[0], src)
        b = eval_expr(args[1], src)
        eq = a.values == b.values
        valid = a.valid_mask & ~eq
        return Col(a.values, None if valid.all() else valid)
    if name == "ifnull" or name == "nvl":
        return eval_scalar_function(
            A.FuncCall("coalesce", args), src
        )
    if name == "isnull":
        c = eval_expr(args[0], src)
        return Col(~c.valid_mask)

    # ---- strings ------------------------------------------------------
    if name in ("upper", "lower"):
        c = eval_expr(args[0], src)
        fn = str.upper if name == "upper" else str.lower
        return Col(
            np.asarray([fn(str(v)) for v in c.values], object), c.validity
        )
    if name in ("length", "char_length", "character_length"):
        c = eval_expr(args[0], src)
        return Col(
            np.asarray([len(str(v)) for v in c.values], np.int64), c.validity
        )
    if name == "concat":
        cols = [eval_expr(a, src) for a in args]
        out = np.asarray(
            ["".join(str(c.values[i]) for c in cols) for i in range(n)],
            object,
        )
        return Col(out)
    if name == "substr" or name == "substring":
        c = eval_expr(args[0], src)
        start = int(_const_arg(args[1]))
        ln = int(_const_arg(args[2])) if len(args) > 2 else None
        s0 = max(start - 1, 0)
        out = np.asarray(
            [
                str(v)[s0: s0 + ln] if ln is not None else str(v)[s0:]
                for v in c.values
            ],
            object,
        )
        return Col(out, c.validity)
    if name == "trim":
        c = eval_expr(args[0], src)
        return Col(
            np.asarray([str(v).strip() for v in c.values], object), c.validity
        )
    if name == "regexp_match":
        import re as _re

        c = eval_expr(args[0], src)
        rx = _re.compile(str(_const_arg(args[1])))
        return Col(
            np.asarray([bool(rx.search(str(v))) for v in c.values], bool),
            c.validity,
        )
    if name == "matches":
        # fulltext query over a string column: terms with AND/OR/NOT and
        # "quoted phrases" (upstream: common-function scalars matches +
        # the tantivy-backed fulltext index, src/index/src/fulltext_index/)
        from greptimedb_tpu_torch.query.fulltext import eval_matches

        c = eval_expr(args[0], src)
        query = str(_const_arg(args[1]))
        return Col(eval_matches(c.values, query), c.validity)
    if name == "matches_term":
        # literal term occurrence with non-alphanumeric boundaries — the
        # term is NOT parsed as a query
        from greptimedb_tpu_torch.query.fulltext import eval_matches_term

        c = eval_expr(args[0], src)
        term = str(_const_arg(args[1]))
        return Col(eval_matches_term(c.values, term), c.validity)
    if name == "starts_with":
        c = eval_expr(args[0], src)
        prefix = str(_const_arg(args[1]))
        return Col(
            np.asarray([str(v).startswith(prefix) for v in c.values], bool),
            c.validity,
        )
    if name in ("ends_with", "reverse", "repeat", "replace", "lpad",
                "rpad", "split_part", "left", "right", "strpos",
                "position", "instr"):
        return _string_fn(name, args, src)

    # ---- misc ---------------------------------------------------------
    if name == "arrow_typeof" or name == "typeof":
        c = eval_expr(args[0], src)
        return Col(np.full(n, str(c.values.dtype), object))
    if name == "version":
        from greptimedb_tpu_torch.version import __version__

        return Col(np.full(n, f"greptimedb-tpu-{__version__}", object))
    if name == "database" or name == "current_schema":
        return Col(np.full(n, "public", object))

    # ---- json / geo / net families (query/functions_ext.py) -----------
    from greptimedb_tpu_torch.query import functions_ext

    out = functions_ext.try_eval(name, args, src)
    if out is not None:
        return out

    raise UnsupportedError(f"unknown function: {name}")


def _string_fn(name: str, args, src) -> Col:
    """Per-row string transforms sharing one map/validity wrapper."""
    c = eval_expr(args[0], src)
    a = [_const_arg(x) for x in args[1:]]

    if name == "ends_with":
        fn, dtype = (lambda s: s.endswith(str(a[0]))), bool
    elif name == "reverse":
        fn, dtype = (lambda s: s[::-1]), object
    elif name == "repeat":
        k = max(int(a[0]), 0)
        fn, dtype = (lambda s: s * k), object
    elif name == "replace":
        frm, to = str(a[0]), str(a[1])
        fn, dtype = (lambda s: s.replace(frm, to)), object
    elif name in ("lpad", "rpad"):
        width = int(a[0])
        fill = (str(a[1]) if len(a) > 1 else " ") or " "

        def fn(s):  # noqa: E306
            if width <= 0:
                return ""          # postgres: non-positive width -> ''
            if len(s) >= width:
                return s[:width]
            add = (fill * (width - len(s)))[:width - len(s)]
            return add + s if name == "lpad" else s + add

        dtype = object
    elif name == "split_part":
        sep, idx = str(a[0]), int(a[1])   # 1-based, like postgres

        def fn(s):  # noqa: E306
            parts = s.split(sep)
            return parts[idx - 1] if 1 <= idx <= len(parts) else ""

        dtype = object
    elif name in ("left", "right"):
        k = int(a[0])
        if name == "left":
            fn = lambda s: s[:k]          # noqa: E731 - k<0 drops tail
        else:
            fn = lambda s: "" if k == 0 else s[-k:]  # noqa: E731
        dtype = object
    else:  # strpos / position / instr
        needle = str(a[0])
        fn, dtype = (lambda s: s.find(needle) + 1), np.int64

    return Col(
        np.asarray([fn(str(v)) for v in c.values], dtype), c.validity
    )


def _parse_interval(text: str) -> int:
    from greptimedb_tpu_torch.sql.parser import parse_interval_ms

    return parse_interval_ms(text)


AGGREGATE_FUNCS = {
    "count", "sum", "min", "max", "avg", "mean", "median",
    "stddev", "stddev_pop", "stddev_samp", "var", "var_pop", "var_samp",
    "variance", "first_value", "last_value", "count_distinct",
    "approx_distinct", "percentile", "quantile", "approx_percentile_cont",
    "percentile_cont",
}


def contains_aggregate(e: A.Expr) -> bool:
    if isinstance(e, A.FuncCall):
        if e.over is not None:
            # a window function is not a GROUP BY aggregate; its args
            # are row-level values
            return False
        if e.name in AGGREGATE_FUNCS:
            return True
        return any(contains_aggregate(a) for a in e.args)
    if isinstance(e, A.RangeFunc):
        return True
    if isinstance(e, A.BinaryOp):
        return contains_aggregate(e.left) or contains_aggregate(e.right)
    if isinstance(e, A.UnaryOp):
        return contains_aggregate(e.operand)
    if isinstance(e, A.Cast):
        return contains_aggregate(e.operand)
    if isinstance(e, A.Between):
        return any(
            contains_aggregate(x) for x in (e.operand, e.low, e.high)
        )
    if isinstance(e, A.InList):
        return contains_aggregate(e.operand) or any(
            contains_aggregate(x) for x in e.items
        )
    if isinstance(e, A.IsNull):
        return contains_aggregate(e.operand)
    if isinstance(e, A.Case):
        parts = [e.operand, e.else_] if e.operand or e.else_ else []
        for c, t in e.whens:
            parts += [c, t]
        return any(contains_aggregate(p) for p in parts if p is not None)
    return False
