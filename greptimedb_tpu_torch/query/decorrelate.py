"""Correlated-subquery decorrelation (the JAX package's
query/decorrelate.py).

Correlated EXISTS / IN / scalar subqueries whose correlation is a
conjunction of equalities `inner_expr = outer_expr` rewrite into ONE
inner evaluation grouped by the correlation keys plus a hash lookup
over the outer rows (a semi/anti/left join in effect). The inner side
(scans, aggregation) runs columnar through the usual paths; only the
final per-row key lookup is host Python, O(outer rows), with each
column converted and its validity read once (the JAX package reads them
a row at a time; the answers are the same).

Shape restrictions (anything else raises UnsupportedError with the JAX
package's texts):
- correlation appears only in the inner WHERE, as top-level equality
  conjuncts with one pure-inner side and one pure-outer side;
- the inner FROM is a table / CTE / view the scope analyzer can see
  through; nested subqueries inside the inner query are opaque.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from greptimedb_tpu_torch.errors import (
    ExecutionError,
    PlanError,
    UnsupportedError,
)
from greptimedb_tpu_torch.query.expr import Col, eval_expr
from greptimedb_tpu_torch.query.planner import split_conjuncts
from greptimedb_tpu_torch.sql import ast as A

_NULL = object()


def collect_columns(e, out: set[str] | None = None) -> set[str]:
    """Qualifier-AWARE column collector: `o.cust` stays `o.cust`, never
    collapsing to bare `cust` (the shared collect_columns drops table
    qualifiers, which made outer-qualified refs look like inner
    columns and silently un-correlated self-join subqueries)."""
    if out is None:
        out = set()
    if isinstance(e, A.Column):
        out.add(f"{e.table}.{e.name}" if e.table else e.name)
        return out
    for child in getattr(e, "__dict__", {}).values():
        if isinstance(child, A.Expr):
            collect_columns(child, out)
        elif isinstance(child, (list, tuple)):
            for x in child:
                if isinstance(x, A.Expr):
                    collect_columns(x, out)
                elif isinstance(x, (list, tuple)):
                    for y in x:
                        if isinstance(y, A.Expr):
                            collect_columns(y, out)
    return out


@dataclass
class CorrSpec:
    kind: str                      # exists | in | scalar
    key: str                       # placeholder column name (__corr_i)
    inner: A.Select                # rewritten inner (keys projected)
    outer_exprs: list              # per-key outer-side expressions
    negated: bool = False
    operand: A.Expr | None = None  # IN operand (outer expression)
    # scalar aggregates: the inner evaluated over ZERO rows — SQL's
    # value for outer rows with no matching inner rows (count()->0,
    # sum()->NULL, count(*)+1 -> 1)
    empty_default: A.Select | None = None


# ---------------------------------------------------------------------------
# scope analysis
# ---------------------------------------------------------------------------


def _source_columns(inst, src, ctx, env) -> set[str] | None:
    """Names visible from a FROM source: bare + `qual.name`. None when
    the source is opaque to static analysis."""
    if isinstance(src, A.TableName):
        qual = src.alias or src.name.rsplit(".", 1)[-1]
        if src.name in env:
            names = list(env[src.name].names)
        else:
            db, name = inst._resolve(src.name, ctx)
            if inst.catalog.maybe_view(db, name) is not None:
                return None  # view text: opaque here, treated whole
            table = inst.catalog.maybe_table(db, name)
            if table is None:
                return None
            names = list(table.schema.column_names)
        out = set(names)
        out.update(f"{qual}.{n}" for n in names)
        out.add(qual)  # qualifier itself, for `qual.*`-ish references
        return out
    if isinstance(src, A.JoinSource):
        left = _source_columns(inst, src.left, ctx, env)
        right = _source_columns(inst, src.right, ctx, env)
        if left is None or right is None:
            return None
        return left | right
    return None  # SubquerySource etc.: opaque


def _free_columns(inst, q: A.Select, ctx, env) -> set[str] | None:
    """Columns referenced by q that its own FROM does not provide.
    None = cannot analyze (treat as uncorrelated / opaque)."""
    src = q.source
    if src is None and q.from_table:
        src = A.TableName(q.from_table)
    if src is None:
        return set()
    scope = _source_columns(inst, src, ctx, env)
    if scope is None:
        return None
    refs: set[str] = set()
    for e in _all_exprs(q):
        if _contains_subquery(e):
            return None  # nested subqueries: opaque
        collect_columns(e, refs)
    return {r for r in refs if r not in scope}


def _all_exprs(q: A.Select):
    for it in q.items:
        yield it.expr
    if q.where is not None:
        yield q.where
    for g in q.group_by:
        yield g
    if q.having is not None:
        yield q.having
    for o in q.order_by:
        yield o.expr


def _contains_subquery(e) -> bool:
    from greptimedb_tpu_torch.query.relational import _has_subquery

    return _has_subquery(e)


# ---------------------------------------------------------------------------
# decorrelation
# ---------------------------------------------------------------------------


def try_decorrelate(inst, e, ctx, env, key: str) -> CorrSpec | None:
    """None = the subquery is uncorrelated (caller materializes it).
    Raises UnsupportedError for correlated-but-undecorrelatable."""
    q = e.query
    free = _free_columns(inst, q, ctx, env)
    if not free:  # empty set OR None (opaque): treat as uncorrelated
        return None
    if (q.group_by or q.having is not None or q.order_by
            or q.limit is not None or q.offset is not None or q.distinct):
        # the decorrelated inner re-projects to correlation keys; any of
        # these clauses would be silently dropped (wrong results), so
        # refuse loudly
        raise UnsupportedError(
            "correlated subqueries with GROUP BY / HAVING / ORDER BY / "
            "LIMIT / DISTINCT are not supported"
        )

    scope = _source_columns(
        inst,
        q.source if q.source is not None else A.TableName(q.from_table),
        ctx, env,
    ) or set()

    def side(expr) -> str:
        cols = collect_columns(expr)
        if not cols:
            return "const"
        if cols <= scope:
            return "inner"
        if not (cols & scope):
            return "outer"
        return "mixed"

    # split the inner WHERE into correlation equalities + residual
    pairs: list[tuple[A.Expr, A.Expr]] = []   # (inner_expr, outer_expr)
    residual: list[A.Expr] = []
    for c in split_conjuncts(q.where):
        cols = collect_columns(c)
        if not (cols & free):
            residual.append(c)
            continue
        if not (isinstance(c, A.BinaryOp) and c.op == "="):
            raise UnsupportedError(
                "correlated subqueries support only equality "
                f"correlation (got: {type(c).__name__})"
            )
        ls, rs = side(c.left), side(c.right)
        if ls == "inner" and rs == "outer":
            pairs.append((c.left, c.right))
        elif ls == "outer" and rs == "inner":
            pairs.append((c.right, c.left))
        else:
            raise UnsupportedError(
                "correlated equality must compare a pure-inner "
                "expression with a pure-outer expression"
            )
    # correlation anywhere else (items/group/having) is unsupported
    for expr in _all_exprs(q):
        if expr is q.where:
            continue
        if collect_columns(expr) & free:
            raise UnsupportedError(
                "correlated references outside the inner WHERE are "
                "not supported"
            )
    if not pairs:
        raise UnsupportedError(
            "correlated subquery has no usable correlation equality"
        )

    where = None
    for c in residual:
        where = c if where is None else A.BinaryOp("and", where, c)

    key_items = [
        A.SelectItem(inner_e, f"__ck{i}")
        for i, (inner_e, _) in enumerate(pairs)
    ]
    outer_exprs = [outer_e for _, outer_e in pairs]

    if isinstance(e, A.Exists):
        inner = A.Select(
            items=key_items, from_table=q.from_table, where=where,
            group_by=[], having=None, order_by=[], limit=None,
            offset=None, range_clause=None, distinct=True,
            source=q.source, ctes=list(getattr(q, "ctes", [])),
        )
        return CorrSpec("exists", key, inner, outer_exprs,
                        negated=e.negated)

    if isinstance(e, A.InSubquery):
        if len(q.items) != 1:
            raise PlanError("IN subquery must return one column")
        inner = A.Select(
            items=[A.SelectItem(q.items[0].expr, "__cv")] + key_items,
            from_table=q.from_table, where=where,
            group_by=[], having=None, order_by=[], limit=None,
            offset=None, range_clause=None, distinct=True,
            source=q.source, ctes=list(getattr(q, "ctes", [])),
        )
        return CorrSpec("in", key, inner, outer_exprs,
                        negated=e.negated, operand=e.operand)

    # scalar subquery
    if len(q.items) != 1:
        raise PlanError("scalar subquery must return one column")
    item = q.items[0].expr
    from greptimedb_tpu_torch.query.functions import contains_aggregate

    is_agg = contains_aggregate(item)
    inner = A.Select(
        items=[A.SelectItem(item, "__cv")] + key_items,
        from_table=q.from_table, where=where,
        group_by=[k.expr for k in key_items] if is_agg else [],
        having=None, order_by=[], limit=None, offset=None,
        range_clause=None, distinct=False,
        source=q.source, ctes=list(getattr(q, "ctes", [])),
    )
    empty_default = None
    if is_agg:
        # SQL's zero-matching-rows value = the aggregate over an empty
        # input (count()->0, sum()->NULL, count(*)+1 -> 1): evaluate the
        # ORIGINAL item once with WHERE false
        empty_default = A.Select(
            items=[A.SelectItem(item, "__cv")],
            from_table=q.from_table, where=A.Literal(False),
            group_by=[], having=None, order_by=[], limit=None,
            offset=None, range_clause=None, distinct=False,
            source=q.source, ctes=list(getattr(q, "ctes", [])),
        )
    return CorrSpec("scalar", key, inner, outer_exprs,
                    empty_default=empty_default)


# ---------------------------------------------------------------------------
# vectorized lookup over the outer frame
# ---------------------------------------------------------------------------


def _norm(v):
    return v.item() if hasattr(v, "item") else v


def _row_keys(cols, n: int) -> list:
    """Per-row key tuples of `cols`, None where a key is NULL (NULL keys
    never equal anything). Each column converts once (`tolist` gives the
    Python values `_norm` gives a row at a time) and its validity is read
    once: the JAX package reads both a row at a time, and `valid_mask`
    builds a whole mask on each read of a column without NULLs."""
    keys = list(zip(*[c.values.tolist() for c in cols]))
    dead = np.zeros(n, bool)
    for c in cols:
        if c.validity is not None:
            dead |= ~c.validity
    for i in np.flatnonzero(dead).tolist():
        keys[i] = None
    return keys


def compute_corr_col(inst, spec: CorrSpec, fsrc, ctx, env,
                     qualify) -> Col:
    """Evaluate the decorrelated inner ONCE, then map outer rows."""
    from greptimedb_tpu_torch.query import relational

    qr = relational.execute(inst, spec.inner, ctx, env)
    n = fsrc.num_rows
    nk = len(spec.outer_exprs)
    okeys = _row_keys([eval_expr(qualify(e), fsrc)
                       for e in spec.outer_exprs], n)

    if spec.kind == "exists":
        present = {k for k in _row_keys(qr.cols[:nk], qr.num_rows)
                   if k is not None}
        vals = np.asarray([
            (k in present) != spec.negated if k is not None
            else spec.negated
            for k in okeys
        ], bool)
        return Col(vals)

    if spec.kind == "in":
        ikeys = _row_keys(qr.cols[1:1 + nk], qr.num_rows)
        vcol = qr.cols[0]
        vvalid = vcol.valid_mask
        by_key: dict = {}
        for i, k in enumerate(ikeys):
            if k is None:
                continue
            st = by_key.setdefault(k, [set(), False])
            if bool(vvalid[i]):
                st[0].add(_norm(vcol.values[i]))
            else:
                st[1] = True  # inner NULL: three-valued logic below
        op = eval_expr(qualify(spec.operand), fsrc)
        op_valid = op.valid_mask
        op_vals = op.values.tolist()
        vals = np.zeros(n, bool)
        valid = np.ones(n, bool)
        for i in range(n):
            k = okeys[i]
            st = by_key.get(k) if k is not None else None
            if st is None:               # no inner rows for this key
                vals[i] = spec.negated   # IN -> false, NOT IN -> true
                continue
            if not bool(op_valid[i]):
                valid[i] = False         # NULL operand -> NULL
                continue
            v = op_vals[i]
            if v in st[0]:
                vals[i] = not spec.negated
            elif st[1]:
                valid[i] = False         # maybe-match via inner NULL
            else:
                vals[i] = spec.negated
        return Col(vals, None if valid.all() else valid)

    # scalar
    ikeys = _row_keys(qr.cols[1:1 + nk], qr.num_rows)
    vcol = qr.cols[0]
    vvalid = vcol.valid_mask
    by_key = {}
    for i, k in enumerate(ikeys):
        if k is None:
            continue
        if k in by_key:
            raise ExecutionError(
                "scalar subquery returned more than one row for a "
                "correlation key"
            )
        by_key[k] = _norm(vcol.values[i]) if bool(vvalid[i]) else _NULL
    default = _NULL
    if spec.empty_default is not None and any(
        k is None or k not in by_key for k in okeys
    ):
        # lazy: only outer rows with NO matching inner rows need the
        # empty-input aggregate value
        dq = relational.execute(inst, spec.empty_default, ctx, env)
        if dq.num_rows == 1:
            dc = dq.cols[0]
            default = (_norm(dc.values[0]) if bool(dc.valid_mask[0])
                       else _NULL)
    picked = [
        by_key.get(k, default) if k is not None else default
        for k in okeys
    ]
    valid = np.asarray([p is not _NULL for p in picked], bool)
    is_str = any(isinstance(p, str) for p in picked if p is not _NULL)
    fill = "" if is_str else 0
    clean = [fill if p is _NULL else p for p in picked]
    arr = (np.asarray(clean, object) if is_str else np.asarray(clean))
    return Col(arr, None if valid.all() else valid)
