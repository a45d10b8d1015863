"""Relational layer: JOINs, CTEs, set operations, subqueries, views (the
JAX package's query/relational.py).

Scans and aggregations, where the data is big, run through the
single-table paths (`Instance._select_single`: the device grid, the
grouped reduce with kernel G); this module joins their much smaller
columnar results on the host with vectorised sort-merge joins over
jointly factorised key codes (no per-row Python). A GROUP BY over a
joined frame goes back to the engine's aggregate path
(`QueryEngine._execute_aggregate`), so it reaches G as a single-table
GROUP BY does. Row order is part of the answer: the joins emit in the
order of their stable sorts, the set operations in that of
`np.unique`/`np.isin`, all copied as they are.

Scope: uncorrelated subqueries, and the correlated forms
query/decorrelate.py rewrites; equi-joins (inner/left/right/full) with
arbitrary residual ON conditions; cross joins under a size guard; UNION /
INTERSECT / EXCEPT with [ALL]; views re-planned from stored SQL text.
RANGE queries stay single-table (wrap the join in a CTE). The join's
host time and rows go to query/stats (`join_ms`, `join_rows`).
"""

from __future__ import annotations

import numpy as np

from greptimedb_tpu_torch.errors import (
    ColumnNotFoundError,
    ExecutionError,
    PlanError,
    UnsupportedError,
)
from greptimedb_tpu_torch.query import stats
from greptimedb_tpu_torch.query.executor import (
    Col,
    DictSource,
    QueryResult,
    _distinct_indices,
    _slice_result,
    _sort_indices,
)
from greptimedb_tpu_torch.query.expr import (
    ColumnSource,
    collect_columns,
    eval_expr,
)
from greptimedb_tpu_torch.query.planner import plan_select, split_conjuncts
from greptimedb_tpu_torch.sql import ast as A

_CROSS_JOIN_GUARD = 25_000_000  # max rows a cross join may materialize


# ----------------------------------------------------------------------
# frames
# ----------------------------------------------------------------------

class Frame:
    """Columnar intermediate with qualified names: (qualifier, name) per
    column. Qualifiers are FROM aliases (or base table names)."""

    def __init__(self, quals: list[str | None], names: list[str],
                 cols: list[Col]):
        self.quals = quals
        self.names = names
        self.cols = cols
        self.num_rows = len(cols[0]) if cols else 0

    @staticmethod
    def from_result(qr: QueryResult, qual: str | None) -> "Frame":
        return Frame([qual] * len(qr.names), list(qr.names), list(qr.cols))

    def lookup(self, name: str) -> int:
        """Resolve `q.n` or bare `n`; bare names must be unambiguous."""
        if "." in name:
            q, n = name.rsplit(".", 1)
            hits = [
                i for i, (cq, cn) in enumerate(zip(self.quals, self.names))
                if cn == n and cq == q
            ]
        else:
            hits = [i for i, cn in enumerate(self.names) if cn == name]
        if len(hits) == 1:
            return hits[0]
        if len(hits) > 1:
            raise PlanError(f"ambiguous column reference: {name}")
        raise ColumnNotFoundError(f"column not found: {name}")

    def has(self, name: str) -> bool:
        try:
            self.lookup(name)
            return True
        except (ColumnNotFoundError, PlanError):
            return False

    def take(self, idx: np.ndarray, valid: np.ndarray | None = None,
             cols: list[int] | None = None) -> list[Col]:
        """Gather rows; `valid=False` rows become NULL (outer-join fill)."""
        sel = range(len(self.cols)) if cols is None else cols
        idx = np.asarray(idx, np.int64)
        out = []
        for ci in sel:
            c = self.cols[ci]
            if len(c.values) == 0:
                if c.values.dtype == object:
                    vals = np.full(len(idx), None, object)
                else:
                    vals = np.zeros(len(idx), c.values.dtype)
                v = np.zeros(len(idx), bool)
            else:
                safe = np.clip(idx, 0, len(c.values) - 1)
                vals = c.values[safe]
                v = None if c.validity is None else c.validity[safe]
            if valid is not None:
                v = valid.copy() if v is None else (v & valid)
            out.append(Col(vals, v))
        return out


class FrameSource(ColumnSource):
    """ColumnSource over a Frame for the shared expression evaluator and
    the executor's plain/aggregate paths."""

    def __init__(self, frame: Frame):
        self.frame = frame
        self.num_rows = frame.num_rows

    def col(self, name: str) -> Col:
        return self.frame.cols[self.frame.lookup(name)]


# ----------------------------------------------------------------------
# routing
# ----------------------------------------------------------------------

def _has_subquery(e) -> bool:
    if isinstance(e, (A.ScalarSubquery, A.InSubquery, A.Exists)):
        return True
    for child in getattr(e, "__dict__", {}).values():
        if isinstance(child, A.Expr) and _has_subquery(child):
            return True
        if isinstance(child, list):
            for x in child:
                if isinstance(x, A.Expr) and _has_subquery(x):
                    return True
                if isinstance(x, tuple) and any(
                    isinstance(y, A.Expr) and _has_subquery(y) for y in x
                ):
                    return True
    return False


def _select_exprs(stmt: A.Select):
    for it in stmt.items:
        yield it.expr
    if stmt.where is not None:
        yield stmt.where
    yield from stmt.group_by
    if stmt.having is not None:
        yield stmt.having
    for o in stmt.order_by:
        yield o.expr


def needs_relational(inst, stmt, ctx) -> bool:
    """True when the statement can't run on the single-table fast path."""
    if isinstance(stmt, A.SetOp):
        return True
    if stmt.ctes:
        return True
    if isinstance(stmt.source, (A.JoinSource, A.SubquerySource)):
        return True
    if any(_has_subquery(e) for e in _select_exprs(stmt)):
        return True
    if stmt.from_table:
        db, name = inst._resolve(stmt.from_table, ctx)
        if inst.catalog.maybe_view(db, name) is not None:
            return True
    return False


# ----------------------------------------------------------------------
# execution
# ----------------------------------------------------------------------

def execute(inst, stmt, ctx, env: dict | None = None) -> QueryResult:
    env = dict(env or {})
    for name, q in getattr(stmt, "ctes", []):
        env[name] = execute(inst, q, ctx, env)
    if isinstance(stmt, A.SetOp):
        return _execute_setop(inst, stmt, ctx, env)
    return _execute_select(inst, stmt, ctx, env)


def _subselect(inst, q, ctx, env) -> QueryResult:
    """Evaluate a nested select/compound under the current CTE env."""
    if isinstance(q, A.SetOp) or getattr(q, "ctes", None) or env:
        return execute(inst, q, ctx, env)
    return execute(inst, q, ctx, {})


def _rewrite_subqueries(inst, e, ctx, env, corr: list | None = None):
    """Replace uncorrelated subquery expressions with literal values.
    Correlated ones (when `corr` is given) decorrelate into placeholder
    columns computed over the outer frame (query/decorrelate.py)."""
    if corr is not None and isinstance(
        e, (A.ScalarSubquery, A.InSubquery, A.Exists)
    ):
        from greptimedb_tpu_torch.query.decorrelate import try_decorrelate

        spec = try_decorrelate(inst, e, ctx, env,
                               key=f"__corr_{len(corr)}")
        if spec is not None:
            corr.append(spec)
            return A.Column(spec.key)
    if isinstance(e, A.ScalarSubquery):
        qr = _subselect(inst, e.query, ctx, env)
        if len(qr.names) != 1:
            raise PlanError("scalar subquery must return one column")
        if qr.num_rows == 0:
            return A.Literal(None)
        if qr.num_rows > 1:
            raise ExecutionError("scalar subquery returned more than one row")
        c = qr.cols[0]
        if not bool(c.valid_mask[0]):
            return A.Literal(None)
        v = c.values[0]
        return A.Literal(v.item() if hasattr(v, "item") else v)
    if isinstance(e, A.InSubquery):
        qr = _subselect(inst, e.query, ctx, env)
        if len(qr.names) != 1:
            raise PlanError("IN subquery must return one column")
        c = qr.cols[0]
        vals = c.values[c.valid_mask]
        uniq = np.unique(vals) if len(vals) else vals
        items = [
            A.Literal(v.item() if hasattr(v, "item") else v) for v in uniq
        ]
        return A.InList(
            _rewrite_subqueries(inst, e.operand, ctx, env, corr),
            items, e.negated
        )
    if isinstance(e, A.Exists):
        qr = _subselect(inst, e.query, ctx, env)
        return A.Literal((qr.num_rows == 0) if e.negated else (qr.num_rows > 0))
    rec = lambda x: _rewrite_subqueries(inst, x, ctx, env, corr)  # noqa: E731
    if isinstance(e, A.BinaryOp):
        return A.BinaryOp(e.op, rec(e.left), rec(e.right))
    if isinstance(e, A.UnaryOp):
        return A.UnaryOp(e.op, rec(e.operand))
    if isinstance(e, A.FuncCall):
        return A.FuncCall(e.name, [rec(a) for a in e.args], e.distinct,
                          e.order_by)
    if isinstance(e, A.RangeFunc):
        return A.RangeFunc(rec(e.func), e.range_ms, e.fill)
    if isinstance(e, A.Cast):
        return A.Cast(rec(e.operand), e.to)
    if isinstance(e, A.Between):
        return A.Between(rec(e.operand), rec(e.low), rec(e.high), e.negated)
    if isinstance(e, A.InList):
        return A.InList(rec(e.operand), [rec(i) for i in e.items], e.negated)
    if isinstance(e, A.IsNull):
        return A.IsNull(rec(e.operand), e.negated)
    if isinstance(e, A.Case):
        return A.Case(
            rec(e.operand) if e.operand else None,
            [(rec(c), rec(t)) for c, t in e.whens],
            rec(e.else_) if e.else_ else None,
        )
    return e


def _map_columns(e, col_fn):
    """Rebuild an expression tree applying col_fn to every Column leaf."""
    if isinstance(e, A.Column):
        return col_fn(e)
    rec = lambda x: _map_columns(x, col_fn)  # noqa: E731
    if isinstance(e, A.BinaryOp):
        return A.BinaryOp(e.op, rec(e.left), rec(e.right))
    if isinstance(e, A.UnaryOp):
        return A.UnaryOp(e.op, rec(e.operand))
    if isinstance(e, A.FuncCall):
        return A.FuncCall(e.name, [rec(a) for a in e.args], e.distinct,
                          e.order_by)
    if isinstance(e, A.RangeFunc):
        return A.RangeFunc(rec(e.func), e.range_ms, e.fill)
    if isinstance(e, A.Cast):
        return A.Cast(rec(e.operand), e.to)
    if isinstance(e, A.Between):
        return A.Between(rec(e.operand), rec(e.low), rec(e.high), e.negated)
    if isinstance(e, A.InList):
        return A.InList(rec(e.operand), [rec(i) for i in e.items], e.negated)
    if isinstance(e, A.IsNull):
        return A.IsNull(rec(e.operand), e.negated)
    if isinstance(e, A.Case):
        return A.Case(
            rec(e.operand) if e.operand else None,
            [(rec(c), rec(t)) for c, t in e.whens],
            rec(e.else_) if e.else_ else None,
        )
    return e


def _qualify(e):
    """Fold table qualifiers into flat `q.n` column names the Frame
    resolves (the shared evaluator only sees Column.name)."""
    return _map_columns(
        e,
        lambda c: A.Column(f"{c.table}.{c.name}") if c.table else c,
    )


def _execute_select(inst, stmt: A.Select, ctx, env) -> QueryResult:
    # 1. materialize uncorrelated subquery expressions; correlated ones
    # decorrelate into __corr_i placeholder columns (computed over the
    # outer frame in step 3b)
    corr: list = []
    rw = lambda e: _rewrite_subqueries(inst, e, ctx, env, corr)  # noqa: E731
    stmt = A.Select(
        items=[A.SelectItem(rw(it.expr), it.alias) for it in stmt.items],
        from_table=stmt.from_table,
        where=rw(stmt.where) if stmt.where is not None else None,
        group_by=[rw(g) for g in stmt.group_by],
        having=rw(stmt.having) if stmt.having is not None else None,
        order_by=[
            A.OrderItem(rw(o.expr), o.asc, o.nulls_first)
            for o in stmt.order_by
        ],
        limit=stmt.limit, offset=stmt.offset,
        range_clause=stmt.range_clause, distinct=stmt.distinct,
        source=stmt.source, ctes=[],
    )

    # 2. single base table (not a CTE/view)? delegate to the fast path —
    # unless correlated placeholders need the frame machinery
    src = stmt.source
    if src is None and corr and stmt.from_table:
        src = A.TableName(stmt.from_table)
    if src is None:
        return inst._select_single(stmt, ctx)
    if isinstance(src, A.TableName) and not corr:
        if src.name not in env:
            db, name = inst._resolve(src.name, ctx)
            if inst.catalog.maybe_view(db, name) is None:
                return inst._select_single(stmt, ctx)

    if stmt.range_clause is not None:
        raise UnsupportedError(
            "RANGE queries run on a single table; wrap the join in a CTE"
        )

    # 3. build the frame, pushing per-leaf WHERE conjuncts down
    conjuncts = [_qualify(c) for c in split_conjuncts(stmt.where)]
    frame, remaining = _eval_source(inst, src, ctx, env, conjuncts)
    fsrc = FrameSource(frame)

    # 3b. correlated placeholders: one inner evaluation each, then a
    # vectorized lookup keyed by the outer rows (semi/anti/left join)
    if corr:
        from greptimedb_tpu_torch.query.decorrelate import compute_corr_col

        for spec in corr:
            col = compute_corr_col(inst, spec, fsrc, ctx, env, _qualify)
            frame = Frame(
                frame.quals + [None], frame.names + [spec.key],
                frame.cols + [col],
            )
            fsrc = FrameSource(frame)

    if remaining:
        cond = remaining[0]
        for c in remaining[1:]:
            cond = A.BinaryOp("and", cond, c)
        m = eval_expr(cond, fsrc)
        mask = m.values.astype(bool) & m.valid_mask
        if not mask.all():
            idx = np.nonzero(mask)[0]
            frame = Frame(frame.quals, frame.names, frame.take(idx))
            fsrc = FrameSource(frame)

    # 4. plan the remainder as a tableless select over the frame
    sel = A.Select(
        items=[A.SelectItem(_qualify(it.expr), it.alias)
               for it in stmt.items],
        from_table=None, where=None,
        group_by=[_qualify(g) for g in stmt.group_by],
        having=_qualify(stmt.having) if stmt.having is not None else None,
        order_by=[
            A.OrderItem(_qualify(o.expr), o.asc, o.nulls_first)
            for o in stmt.order_by
        ],
        limit=stmt.limit, offset=stmt.offset, distinct=stmt.distinct,
    )
    star_columns = [
        n if q is None else f"{q}.{n}"
        for q, n in zip(frame.quals, frame.names)
        if not n.startswith("__corr_")  # decorrelation internals
    ]
    plan = plan_select(sel, ts_name=None, tag_names=[],
                       all_columns=star_columns)

    # output shows bare names; qualifiers are resolution-only
    quals = {q for q in frame.quals if q}

    def bare(n: str) -> str:
        if "." in n and n.rsplit(".", 1)[0] in quals:
            return n.rsplit(".", 1)[-1]
        return n

    plan.items = [(e, bare(n)) for e, n in plan.items]
    plan.post_items = [(e, bare(n)) for e, n in plan.post_items]
    engine = inst.query_engine
    if plan.kind == "plain":
        return engine._execute_plain(plan, fsrc, None)
    if corr:
        # placeholder columns are ROW-level; post-aggregate expressions
        # (HAVING, select exprs over groups) evaluate at GROUP level
        refs: set = set()
        for e, _ in plan.post_items:
            collect_columns(e, refs)
        if plan.having is not None:
            collect_columns(plan.having, refs)
        for o in plan.order_by:
            collect_columns(o.expr, refs)
        if any(r.startswith("__corr_") for r in refs):
            raise UnsupportedError(
                "correlated subqueries in HAVING or post-aggregate "
                "select expressions are not supported yet"
            )
    return engine._execute_aggregate(plan, fsrc, None)


# ----------------------------------------------------------------------
# FROM-source evaluation
# ----------------------------------------------------------------------

def _eval_source(inst, src, ctx, env, conjuncts):
    """Returns (frame, unconsumed conjuncts). Conjuncts whose columns all
    resolve against one base-table leaf are pushed into that leaf's scan
    (predicate pushdown through the join)."""
    if isinstance(src, A.TableName):
        return _frame_for_table(inst, src, ctx, env, conjuncts)
    if isinstance(src, A.SubquerySource):
        qr = _subselect(inst, src.query, ctx, env)
        return Frame.from_result(qr, src.alias), conjuncts
    if isinstance(src, A.JoinSource):
        # WHERE pushdown must not cross into a null-supplying side: a
        # filter below the outer side would silently convert filtered-out
        # matches into NULL-padded rows
        push_left = src.kind not in ("right", "full")
        push_right = src.kind not in ("left", "full")
        if push_left:
            lf, conjuncts = _eval_source(inst, src.left, ctx, env, conjuncts)
        else:
            lf, _ = _eval_source(inst, src.left, ctx, env, [])
        if push_right:
            rf, conjuncts = _eval_source(inst, src.right, ctx, env, conjuncts)
        else:
            rf, _ = _eval_source(inst, src.right, ctx, env, [])
        with stats.timed("join_ms"):
            joined = _join(lf, rf, src)
        stats.add("join_rows", joined.num_rows)
        return joined, conjuncts
    raise PlanError(f"unsupported FROM source: {src!r}")


def _frame_for_table(inst, src: A.TableName, ctx, env, conjuncts):
    qual = src.alias or src.name.rsplit(".", 1)[-1]
    if src.name in env:
        return Frame.from_result(env[src.name], qual), conjuncts
    if inst._is_information_schema(src.name, ctx) or inst._is_pg_catalog(
            src.name, ctx):
        # system virtual tables join like any other relation; the
        # single-table path answers them
        leaf = A.Select(items=[A.SelectItem(A.Star())],
                        from_table=src.name)
        return (
            Frame.from_result(inst._select_single(leaf, ctx), qual),
            conjuncts,
        )
    db, name = inst._resolve(src.name, ctx)
    view_sql = inst.catalog.maybe_view(db, name)
    if view_sql is not None:
        from greptimedb_tpu_torch.sql.parser import parse_sql

        q = parse_sql(view_sql)[0]
        return Frame.from_result(_subselect(inst, q, ctx, env), qual), conjuncts
    table = inst.catalog.table(db, name)
    cols = set(table.schema.column_names)
    pushed, remaining = [], []
    for c in conjuncts:
        if _conjunct_binds(c, qual, cols):
            pushed.append(_strip_qual(c, qual))
        else:
            remaining.append(c)
    where = None
    for p in pushed:
        where = p if where is None else A.BinaryOp("and", where, p)
    leaf = A.Select(
        items=[A.SelectItem(A.Star())], from_table=src.name, where=where,
    )
    qr = inst._select_single(leaf, ctx)
    return Frame.from_result(qr, qual), remaining


def _conjunct_binds(c, qual: str, cols: set) -> bool:
    refs = collect_columns(c)
    if not refs:
        return False
    for r in refs:
        if "." in r:
            q, n = r.rsplit(".", 1)
            if q != qual or n not in cols:
                return False
        elif r not in cols:
            return False
    return True


def _strip_qual(e, qual: str):
    def strip(c: A.Column):
        if "." in c.name:
            q, n = c.name.rsplit(".", 1)
            if q == qual:
                return A.Column(n)
        return c

    return _map_columns(e, strip)


# ----------------------------------------------------------------------
# joins
# ----------------------------------------------------------------------

def _join(lf: Frame, rf: Frame, js: A.JoinSource) -> Frame:
    kind = js.kind
    pairs: list[tuple[A.Expr, A.Expr]] = []
    residual: list[A.Expr] = []
    drop_right: list[int] = []
    if js.using:
        for c in js.using:
            pairs.append((A.Column(c), A.Column(c)))
        # USING outputs the key once: hide the right copy
        drop_right = [rf.lookup(c) for c in js.using]
    elif js.on is not None:
        for c in split_conjuncts(_qualify(js.on)):
            pair = _equi_pair(c, lf, rf)
            if pair is not None:
                pairs.append(pair)
            else:
                residual.append(c)
    if kind == "cross":
        if lf.num_rows * rf.num_rows > _CROSS_JOIN_GUARD:
            raise ExecutionError(
                f"cross join would materialize "
                f"{lf.num_rows * rf.num_rows} rows"
            )
        li = np.repeat(np.arange(lf.num_rows), rf.num_rows)
        ri = np.tile(np.arange(rf.num_rows), lf.num_rows)
        return _emit_join(lf, rf, li, ri, None, None, drop_right)
    if not pairs:
        raise UnsupportedError(
            f"{kind.upper()} JOIN needs at least one equality condition "
            "(use CROSS JOIN for a cartesian product)"
        )

    lsrc, rsrc = FrameSource(lf), FrameSource(rf)
    lcodes = _key_codes([eval_expr(a, lsrc) for a, _ in pairs],
                        [eval_expr(b, rsrc) for _, b in pairs])
    lkeys, rkeys = lcodes

    order = np.argsort(rkeys, kind="stable")
    sorted_r = rkeys[order]
    start = np.searchsorted(sorted_r, lkeys, "left")
    end = np.searchsorted(sorted_r, lkeys, "right")
    counts = end - start
    li = np.repeat(np.arange(lf.num_rows), counts)
    total = int(counts.sum())
    base = np.repeat(start, counts)
    offsets = np.arange(total) - np.repeat(
        np.cumsum(counts) - counts, counts
    )
    ri = order[base + offsets]

    if residual and total:
        cand = _emit_join(lf, rf, li, ri, None, None, [])
        csrc = FrameSource(cand)
        cond = residual[0]
        for c in residual[1:]:
            cond = A.BinaryOp("and", cond, c)
        m = eval_expr(cond, csrc)
        keep = m.values.astype(bool) & m.valid_mask
        li, ri = li[keep], ri[keep]

    # extend matched pairs with the unmatched side(s); the other side's
    # columns read as NULL on those rows
    li0, ri0 = li, ri
    lextra = np.zeros(0, np.int64)
    rextra = np.zeros(0, np.int64)
    if kind in ("left", "full"):
        matched = np.zeros(lf.num_rows, bool)
        matched[li0] = True
        lextra = np.nonzero(~matched)[0]
    if kind in ("right", "full"):
        matched = np.zeros(rf.num_rows, bool)
        matched[ri0] = True
        rextra = np.nonzero(~matched)[0]
    l_valid = r_valid = None
    if len(lextra) or len(rextra):
        nm = len(li0)
        li = np.concatenate([li0, lextra, np.zeros(len(rextra), np.int64)])
        ri = np.concatenate([ri0, np.zeros(len(lextra), np.int64), rextra])
        l_valid = np.ones(len(li), bool)
        l_valid[nm + len(lextra):] = False
        r_valid = np.ones(len(ri), bool)
        r_valid[nm: nm + len(lextra)] = False
    out = _emit_join(lf, rf, li, ri, l_valid, r_valid, drop_right)
    if js.using and l_valid is not None:
        # USING outputs ONE key column, coalesced across sides (standard
        # SQL): right-only rows carry the right side's key value
        rtaken = rf.take(ri, r_valid, drop_right)
        for c, rcol in zip(js.using, rtaken):
            oi = out.lookup(c) if out.has(c) else None
            if oi is None:
                continue
            lcol = out.cols[oi]
            lv = lcol.valid_mask
            vals = np.where(lv, lcol.values, rcol.values)
            valid = lv | rcol.valid_mask
            out.cols[oi] = Col(
                vals, None if valid.all() else valid
            )
    return out


def _equi_pair(c, lf: Frame, rf: Frame):
    """(left_expr, right_expr) when `c` is an equality whose sides bind
    exclusively to opposite frames."""
    if not (isinstance(c, A.BinaryOp) and c.op == "="):
        return None

    def binds(frame, expr):
        refs = collect_columns(expr)
        return bool(refs) and all(frame.has(x) for x in refs)

    a, b = c.left, c.right
    a_l, a_r = binds(lf, a), binds(rf, a)
    b_l, b_r = binds(lf, b), binds(rf, b)
    if a_l and b_r and not a_r and not b_l:
        return (a, b)
    if b_l and a_r and not b_r and not a_l:
        return (b, a)
    return None


def _key_codes(lcols: list[Col], rcols: list[Col], *,
               null_equal: bool = False):
    """Jointly factorize join keys of both sides into int64 codes. JOIN
    semantics (default): NULL keys get a side-unique negative code so they
    never match. Set-operation semantics (null_equal): NULLs compare equal
    (IS NOT DISTINCT FROM)."""
    lparts, rparts = [], []
    cards = []
    for lc, rc in zip(lcols, rcols):
        lv, rv = lc.values, rc.values
        if lv.dtype == object or rv.dtype == object or \
                lv.dtype.kind in "US" or rv.dtype.kind in "US":
            both = np.concatenate([lv.astype(str), rv.astype(str)])
        else:
            dt = np.result_type(lv.dtype, rv.dtype)
            both = np.concatenate([lv.astype(dt), rv.astype(dt)])
        _, inv = np.unique(both, return_inverse=True)
        codes = inv.astype(np.int64) + 1  # 0 reserved for NULL
        lcode = codes[: len(lv)]
        rcode = codes[len(lv):]
        lcode = np.where(lc.valid_mask, lcode, 0)
        rcode = np.where(rc.valid_mask, rcode, 0)
        lparts.append(lcode)
        rparts.append(rcode)
        cards.append(int(codes.max(initial=0)) + 1)
    lkey = lparts[0]
    rkey = rparts[0]
    lnull = lparts[0] == 0
    rnull = rparts[0] == 0
    for lp, rp, card in zip(lparts[1:], rparts[1:], cards[1:]):
        lkey = lkey * card + lp
        rkey = rkey * card + rp
        lnull |= lp == 0
        rnull |= rp == 0
    if not null_equal:
        # NULL anywhere in the key never matches (per-side sentinels)
        lkey = np.where(lnull, np.int64(-1), lkey)
        rkey = np.where(rnull, np.int64(-2), rkey)
    return lkey, rkey


def _emit_join(lf: Frame, rf: Frame, li, ri, l_valid, r_valid,
               drop_right: list[int]) -> Frame:
    keep_r = [i for i in range(len(rf.cols)) if i not in set(drop_right)]
    quals = list(lf.quals) + [rf.quals[i] for i in keep_r]
    names = list(lf.names) + [rf.names[i] for i in keep_r]
    cols = lf.take(li, l_valid) + rf.take(ri, r_valid, keep_r)
    return Frame(quals, names, cols)


# ----------------------------------------------------------------------
# set operations
# ----------------------------------------------------------------------

def _execute_setop(inst, stmt: A.SetOp, ctx, env) -> QueryResult:
    left = _subselect(inst, stmt.left, ctx, env)
    right = _subselect(inst, stmt.right, ctx, env)
    if len(left.names) != len(right.names):
        raise PlanError(
            f"{stmt.op.upper()} requires equal column counts "
            f"({len(left.names)} vs {len(right.names)})"
        )
    names = list(left.names)
    if stmt.op == "union":
        cols = _concat_cols(left.cols, right.cols)
        if not stmt.all:
            cols = _slice_result(cols, _distinct_indices(cols))
    else:
        lkeys, rkeys = _key_codes(left.cols, right.cols, null_equal=True)
        if stmt.all:
            # bag semantics: INTERSECT ALL keeps min(count_l, count_r)
            # copies; EXCEPT ALL removes one left copy per right row
            occ = _occurrence_rank(lkeys)
            rvals, rcounts = np.unique(rkeys, return_counts=True)
            if len(rvals):
                pos = np.clip(
                    np.searchsorted(rvals, lkeys), 0, len(rvals) - 1
                )
                cnt = np.where(rvals[pos] == lkeys, rcounts[pos], 0)
            else:
                cnt = np.zeros(len(lkeys), np.int64)
            if stmt.op == "intersect":
                mask = occ < cnt
            else:  # except all
                mask = occ >= cnt
        else:
            if stmt.op == "intersect":
                mask = np.isin(lkeys, rkeys)
            else:  # except
                mask = ~np.isin(lkeys, rkeys)
        cols = _slice_result(left.cols, np.nonzero(mask)[0])
        if not stmt.all:
            cols = _slice_result(cols, _distinct_indices(cols))
    n = len(cols[0]) if cols else 0
    if stmt.order_by:
        out_src = DictSource(dict(zip(names, cols)), n)
        order_cols = [eval_expr(o.expr, out_src) for o in stmt.order_by]
        idx = _sort_indices(
            order_cols, [o.asc for o in stmt.order_by],
            [o.nulls_first for o in stmt.order_by],
        )
        cols = _slice_result(cols, idx)
    off = stmt.offset or 0
    if off or stmt.limit is not None:
        end = None if stmt.limit is None else off + stmt.limit
        cols = _slice_result(cols, slice(off, end))
    return QueryResult(names, cols)


def _occurrence_rank(keys: np.ndarray) -> np.ndarray:
    """rank[i] = how many earlier rows share keys[i] (0-based, original
    order)."""
    n = len(keys)
    if n == 0:
        return np.zeros(0, np.int64)
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    new_group = np.r_[True, sk[1:] != sk[:-1]]
    starts = np.nonzero(new_group)[0]
    sizes = np.diff(np.r_[starts, n])
    group_start = np.repeat(starts, sizes)
    ranks_sorted = np.arange(n) - group_start
    ranks = np.empty(n, np.int64)
    ranks[order] = ranks_sorted
    return ranks


def _concat_cols(a: list[Col], b: list[Col]) -> list[Col]:
    out = []
    for ca, cb in zip(a, b):
        va, vb = ca.values, cb.values
        if va.dtype == object or vb.dtype == object:
            vals = np.concatenate([va.astype(object), vb.astype(object)])
        else:
            dt = np.result_type(va.dtype, vb.dtype)
            vals = np.concatenate([va.astype(dt), vb.astype(dt)])
        if ca.validity is None and cb.validity is None:
            v = None
        else:
            v = np.concatenate([ca.valid_mask, cb.valid_mask])
        out.append(Col(vals, v))
    return out
