"""PromQL evaluation over the device grid cache (the JAX package's
promql/engine.py, for the shapes the fast path serves).

`PromEngine(instance).query_range(promql, start_ms, end_ms, step_ms)`
keeps the JAX signature. The engine reads `instance.catalog.maybe_table(
db, name)` and `instance.query_engine` (`.device`, `.mesh`, `.mesh_opts`;
query/executor.QueryEngine supplies them). Number literals and the
aggregations that promql/fast.py serves evaluate; every other expression,
and an aggregation the fast path does not serve, raises UnsupportedError
naming the shape: the generic engine (selector scans, binary and set
operators, functions) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from greptimedb_tpu_torch.errors import (
    PlanError,
    TableNotFoundError,
    UnsupportedError,
)
from greptimedb_tpu_torch.promql import parser as P
from greptimedb_tpu_torch.promql.parser import (
    Agg,
    Matcher,
    NumberLit,
    PromExpr,
)
from greptimedb_tpu_torch.query.expr import compile_matcher

DEFAULT_LOOKBACK_MS = 300_000


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


class PromEngine:
    def __init__(self, instance, ctx=None):
        self.instance = instance
        self.ctx = ctx
        self._db = getattr(ctx, "database", "public") if ctx else "public"
        # what the last fast-path query ran (promql/fast._note)
        self.last_fast = None

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

    def _eval(self, e: PromExpr, ev: EvalParams):
        if isinstance(e, NumberLit):
            return ScalarValue(np.full(ev.num_steps, e.value))
        if isinstance(e, Agg):
            from greptimedb_tpu_torch.promql import fast as F

            hit = F.try_fast(self, e, ev)
            if hit is None:
                hit = F.try_fast_topk(self, e, ev)
            if hit is not None:
                return hit
            raise UnsupportedError(
                f"{e.op} over this expression is not on the PromQL fast "
                f"path (grouped topk, a range function not ported yet, or "
                f"a step/range/start off the grid's cells) and the generic "
                f"engine is not ported yet: {e!r}")
        raise UnsupportedError(
            f"{type(e).__name__} expressions need the generic PromQL "
            f"engine, which is not ported yet: {e!r}")

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


def _empty_vector(ev: EvalParams) -> VectorValue:
    return VectorValue([], np.zeros((0, ev.num_steps)),
                       np.zeros((0, ev.num_steps), bool))
