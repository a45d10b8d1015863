"""The SQL entry points: `Standalone(data_root)` (the JAX package's
Standalone: a storage engine, a durable catalog and a query engine) and
`Instance(...)` (a query engine over a catalog given or in memory).

Both run statements through one executor (`Instance.execute_sql` returns
one `Output` per statement, `sql` the last statement's result):

- SELECT: RANGE on the device grid or the host RANGE path, GROUP BY
  through the grouped reduce (on the card or the host), row filters and
  projections on the host; joins, CTEs, subqueries, set operations and
  views through query/relational.py, whose leaves are single-table
  SELECTs (`_select_single`);
- CREATE [OR REPLACE] VIEW, DROP VIEW, SHOW VIEWS, SHOW CREATE VIEW;
- INSERT … VALUES and INSERT … SELECT (declared defaults, nulls, typed
  fields), DELETE (tombstones for the rows its WHERE selects);
- CREATE TABLE (LIKE, IF NOT EXISTS), CREATE/DROP DATABASE, DROP TABLE,
  TRUNCATE, ALTER TABLE add/drop column and rename;
- USE, SHOW DATABASES/TABLES/COLUMNS/INDEX, DESCRIBE, SHOW CREATE TABLE;
- TQL EVAL/EXPLAIN (promql/engine.PromEngine.query_range_result);
- ADMIN flush_table, compact_table, flush_region, compact_region, kill;
- flows (flow/manager.FlowManager, enabled by CREATE FLOW or
  `enable_flows()`, which also reloads the flows a data root persisted):
  CREATE/DROP FLOW, SHOW FLOWS, SHOW CREATE FLOW, ADMIN flush_flow; every
  write (INSERT, line protocol, remote write) feeds them;
- EXPLAIN and EXPLAIN ANALYZE (the plan's lines; ANALYZE runs the
  statement under query/stats' collector and adds its metrics);
- information_schema and the pg_catalog shims (information_schema.py),
  alone or joined;
- the session: SET, SHOW VARIABLES, PREPARE/EXECUTE/DEALLOCATE, SHOW
  STATUS/CHARSET/COLLATION, SHOW PROCESSLIST and ADMIN kill (KILL). Every
  statement registers in the process list while it runs; a kill lands at
  its next cancellation checkpoint (cancellation.py: each table scan);
- the poll path: a data-plane statement passes admission control first
  (`scheduler`, sched/: quotas, a concurrency limit, its deadline at
  every checkpoint); a single-table SELECT meets the result cache
  (`result_cache`, query/result_cache.py, off by default) and the `since`
  cursor (`ctx.extensions["since_ms"]`, query/sessions.py).

COPY raises UnsupportedError naming its ROADMAP item (A2's tail). An
Instance without a storage engine answers DDL with the catalog's
UnsupportedError, and flows with its own. Entry points run on
CUDA unless the caller passes device="cpu". servers/http.HttpServer
serves either over HTTP; `promql/engine.PromEngine(instance)` reads the
same catalog and engine.
"""

from __future__ import annotations

import functools
import logging
import re
import threading
import time

import numpy as np

from greptimedb_tpu_torch import cancellation, concurrency
from greptimedb_tpu_torch.catalog.manager import CatalogManager
from greptimedb_tpu_torch.datatypes.schema import (
    ColumnSchema,
    Schema,
    SemanticType,
)
from greptimedb_tpu_torch.datatypes.types import ConcreteDataType
from greptimedb_tpu_torch.errors import (
    DatabaseNotFoundError,
    ExecutionError,
    InvalidArgumentError,
    TableNotFoundError,
    UnsupportedError,
)
from greptimedb_tpu_torch.query.executor import Col, QueryEngine, QueryResult
from greptimedb_tpu_torch.query.expr import eval_const, parse_ts_literal
from greptimedb_tpu_torch.query.planner import plan_select
from greptimedb_tpu_torch.session import QueryContext
from greptimedb_tpu_torch.sql import ast as A
from greptimedb_tpu_torch.sql.parser import parse_sql

_log = logging.getLogger("greptimedb_tpu_torch.instance")

# statements that wait, and the ROADMAP item that ports them
_WAITING = {A.Copy: "A2's tail"}
# statement kinds that use engine or storage resources and so pass
# admission control; everything else (SHOW, SET, ADMIN kill, DESCRIBE...)
# is control plane and bypasses it
_ADMITTED_STATEMENTS = (
    A.Select, A.SetOp, A.Tql, A.Insert, A.Delete, A.Copy, A.Explain,
)
# ADMIN functions that wait, and their item
_WAITING_ADMIN = {
    "migrate_region": "A10",
    "set_config": "A12", "autotune_freeze": "A12",
    "autotune_unfreeze": "A12",
}


def _waiting(what: str, item: str) -> UnsupportedError:
    return UnsupportedError(
        f"{what} is not ported yet (ROADMAP {item})")


class Output:
    """A statement's result: affected rows or a result set."""

    def __init__(self, *, affected_rows: int | None = None,
                 result: QueryResult | None = None):
        self.affected_rows = affected_rows
        self.result = result

    @staticmethod
    def rows(n: int) -> "Output":
        return Output(affected_rows=n)

    @staticmethod
    def records(r: QueryResult) -> "Output":
        return Output(result=r)


def _result_from_lists(names: list[str], columns: list[list]) -> QueryResult:
    cols = []
    for vals in columns:
        validity = np.asarray([v is not None for v in vals], bool)
        if all(isinstance(v, (int, np.integer)) or v is None for v in vals):
            arr = np.asarray([0 if v is None else v for v in vals], np.int64)
        elif all(isinstance(v, (int, float, np.floating)) or v is None
                 for v in vals):
            arr = np.asarray([0.0 if v is None else float(v) for v in vals],
                             np.float64)
        else:
            arr = np.asarray(["" if v is None else v for v in vals], object)
        cols.append(Col(arr, None if validity.all() else validity))
    return QueryResult(names, cols)


class _ProcessList:
    """The running statements, for SHOW PROCESSLIST and ADMIN kill (the
    JAX package's registry). A killed id raises in the thread that runs
    it, at its next cancellation checkpoint."""

    def __init__(self):
        self._lock = concurrency.Lock()
        self._next_id = 1
        self._running: dict[int, dict] = {}

    def register(self, query: str, ctx) -> int:
        with self._lock:
            pid = self._next_id
            self._next_id += 1
            self._running[pid] = {
                "id": pid, "query": query, "db": ctx.database,
                "user": ctx.username or "greptime", "start": time.time(),
                # elapsed time from the monotonic clock
                "_start_mono": time.monotonic(),
                "killed": False,
                "state": "Queued",
            }
            return pid

    def set_state(self, pid: int, state: str):
        with self._lock:
            entry = self._running.get(pid)
            if entry is not None:
                entry["state"] = state

    def unregister(self, pid: int):
        with self._lock:
            self._running.pop(pid, None)

    def kill(self, pid_text: str) -> bool:
        try:
            pid = int(pid_text)
        except ValueError:
            return False
        with self._lock:
            entry = self._running.get(pid)
            if entry is None:
                return False
            entry["killed"] = True
            return True

    def check_killed(self, pid: int):
        with self._lock:
            entry = self._running.get(pid)
            killed = entry is not None and entry["killed"]
        if killed:
            raise ExecutionError(f"query {pid} was killed")

    def snapshot(self) -> list[dict]:
        with self._lock:
            now = time.monotonic()
            return [
                {**{k: v for k, v in e.items() if not k.startswith("_")},
                 "elapsed_s": now - e["_start_mono"]}
                for e in self._running.values()
            ]


class Instance:
    """A query engine over a catalog: the statement executor."""

    def __init__(self, device=None, mesh=None, mesh_opts=None,
                 prefer_device: bool | None = True, x64: bool = False,
                 catalog: CatalogManager | None = None):
        self.catalog = catalog if catalog is not None else CatalogManager()
        self.engine = self.catalog.engine
        self.query_engine = QueryEngine(device=device, mesh=mesh,
                                        mesh_opts=mesh_opts,
                                        prefer_device=prefer_device, x64=x64)
        self.flows = None   # flow.FlowManager once flows are enabled
        self._process_list = _ProcessList()
        # admission control and deadlines (sched/): the default config
        # is permissive (no quotas or limits: it never queues or sheds);
        # a caller swaps in a configured controller
        from greptimedb_tpu_torch.sched import AdmissionController

        self.scheduler = AdmissionController()
        # the result cache (query/result_cache.py): off by default, a
        # caller swaps in an enabled one; the catalog gets a handle so a
        # DROP purges the table's entries
        from greptimedb_tpu_torch.query.result_cache import ResultCache

        self.result_cache = ResultCache(enabled=False)
        self.catalog.result_cache = self.result_cache
        from greptimedb_tpu_torch.telemetry.slow_query import SlowQueryLog

        self.slow_query_log = SlowQueryLog()

    # ------------------------------------------------------------------
    # entry points
    # ------------------------------------------------------------------
    def execute_sql(self, sql: str, ctx: QueryContext | None = None
                    ) -> list[Output]:
        """Run every statement of `sql`; one Output each. One
        `sql.execute` span covers the batch; each statement carries its
        fingerprint (from the raw text, split on ';' as parse_sql
        splits), and the batch lands in the slow-query log past its
        threshold."""
        from greptimedb_tpu_torch.telemetry import stmt_stats, tracing

        ctx = ctx or QueryContext()
        outputs = []
        t0 = time.perf_counter()
        trace_id = None
        fps = (stmt_stats.fingerprint_sql(sql)
               if stmt_stats.enabled() else [])
        try:
            with tracing.span("sql.execute", db=ctx.database,
                              channel=ctx.channel) as root:
                trace_id = root.trace_id or None
                for i, stmt in enumerate(parse_sql(sql)):
                    token = stmt_stats.bind_fingerprint(
                        fps[i] if i < len(fps) else None)
                    try:
                        outputs.append(self.execute_statement(stmt, ctx))
                    finally:
                        stmt_stats.reset_fingerprint(token)
        finally:
            self.slow_query_log.maybe_record(
                sql, time.perf_counter() - t0,
                db=ctx.database, channel=ctx.channel,
                trace_id=trace_id,
                fingerprint=fps[0].fp if fps else "",
            )
        return outputs

    def sql(self, sql: str, ctx: QueryContext | None = None) -> QueryResult:
        """The last statement's result set (affected rows as a one-cell
        result)."""
        out = self.execute_sql(sql, ctx)[-1]
        if out.result is None:
            return _result_from_lists(["affected_rows"],
                                      [[out.affected_rows or 0]])
        return out.result

    def execute_statement(self, stmt: A.Statement,
                          ctx: QueryContext | None = None) -> Output:
        """Run one statement, registered in the process list while it
        runs; a kill raises at its next cancellation checkpoint. A
        data-plane statement (`_ADMITTED_STATEMENTS`) passes admission
        control first: it shows "Queued" until it gets its slot, and its
        deadline binds for its checkpoints. One statement-statistics
        observation and one `sql.<kind>` span cover it: what the layers
        below attribute (queue time, exec path, first calls, transfer
        bytes) folds into its fingerprint's row on exit."""
        from greptimedb_tpu_torch.telemetry import stmt_stats, tracing

        ctx = ctx or QueryContext()
        kind = type(stmt).__name__
        pid = self._process_list.register(kind, ctx)
        token = cancellation.set_check(
            lambda: self._process_list.check_killed(pid))
        try:
            with stmt_stats.global_stmt_stats.observe(ctx, kind) as obs, \
                    tracing.span(f"sql.{kind}"):
                if isinstance(stmt, _ADMITTED_STATEMENTS):
                    # control-plane statements (SHOW, SET, USE, ADMIN
                    # kill) bypass, so an operator can still inspect and
                    # kill work on an overloaded instance
                    with self.scheduler.admit(ctx):
                        self._process_list.set_state(pid, "Running")
                        out = self._execute_statement(stmt, ctx)
                else:
                    self._process_list.set_state(pid, "Running")
                    out = self._execute_statement(stmt, ctx)
                if obs is not None:
                    obs.add("rows", out.result.num_rows
                            if out.result is not None
                            else (out.affected_rows or 0))
                return out
        finally:
            cancellation.reset(token)
            self._process_list.unregister(pid)

    def _execute_statement(self, stmt: A.Statement, ctx: QueryContext
                           ) -> Output:
        item = _WAITING.get(type(stmt))
        if item is not None:
            raise _waiting(f"{type(stmt).__name__} statements", item)
        if isinstance(stmt, A.Select):
            return Output.records(self._select(stmt, ctx))
        if isinstance(stmt, A.SetOp):
            from greptimedb_tpu_torch.query import relational

            return Output.records(relational.execute(self, stmt, ctx))
        if isinstance(stmt, A.CreateView):
            db, name = self._resolve(stmt.name, ctx)
            if stmt.text is None:
                raise UnsupportedError("CREATE VIEW requires query text")
            self.catalog.create_view(db, name, stmt.text,
                                     or_replace=stmt.or_replace)
            return Output.rows(0)
        if isinstance(stmt, A.DropView):
            db, name = self._resolve(stmt.name, ctx)
            self.catalog.drop_view(db, name, if_exists=stmt.if_exists)
            return Output.rows(0)
        if isinstance(stmt, A.Insert):
            return Output.rows(self._insert(stmt, ctx))
        if isinstance(stmt, A.Delete):
            return Output.rows(self._delete(stmt, ctx))
        if isinstance(stmt, A.CreateTable):
            self._create_table(stmt, ctx)
            return Output.rows(0)
        if isinstance(stmt, A.CreateDatabase):
            self.catalog.create_database(stmt.name,
                                         if_not_exists=stmt.if_not_exists)
            return Output.rows(1)
        if isinstance(stmt, A.DropDatabase):
            self.catalog.drop_database(stmt.name, if_exists=stmt.if_exists)
            return Output.rows(0)
        if isinstance(stmt, A.DropTable):
            for name in stmt.names:
                db, tname = self._resolve(name, ctx)
                self.catalog.drop_table(db, tname, if_exists=stmt.if_exists)
            return Output.rows(0)
        if isinstance(stmt, A.TruncateTable):
            db, tname = self._resolve(stmt.name, ctx)
            self.catalog.table(db, tname).truncate()
            return Output.rows(0)
        if isinstance(stmt, A.AlterTable):
            return Output.rows(self._alter(stmt, ctx))
        if isinstance(stmt, A.Use):
            if not self.catalog.has_database(stmt.database):
                raise DatabaseNotFoundError(
                    f"database not found: {stmt.database}")
            ctx.database = stmt.database
            return Output.rows(0)
        if isinstance(stmt, A.ShowDatabases):
            return Output.records(self._show_databases(stmt))
        if isinstance(stmt, A.ShowTables):
            return Output.records(self._show_tables(stmt, ctx))
        if isinstance(stmt, A.ShowCreateTable):
            return Output.records(self._show_create_table(stmt, ctx))
        if isinstance(stmt, A.DescribeTable):
            return Output.records(self._describe(stmt, ctx))
        if isinstance(stmt, A.ShowColumns):
            return Output.records(self._show_columns(stmt, ctx))
        if isinstance(stmt, A.ShowIndex):
            return Output.records(self._show_index(stmt, ctx))
        if isinstance(stmt, A.Tql):
            return Output.records(self._tql(stmt, ctx))
        if isinstance(stmt, A.Admin):
            return self._admin(stmt, ctx)
        if isinstance(stmt, A.CreateFlow):
            self.enable_flows().create_flow(stmt, ctx)
            return Output.rows(0)
        if isinstance(stmt, A.DropFlow):
            self.enable_flows().drop_flow(stmt.name,
                                          if_exists=stmt.if_exists)
            return Output.rows(0)
        if isinstance(stmt, A.ShowViews):
            return Output.records(_result_from_lists(
                ["Views"], [self.catalog.view_names(ctx.database)]))
        if isinstance(stmt, A.ShowCreateView):
            db, name = self._resolve(stmt.name, ctx)
            sql_text = self.catalog.maybe_view(db, name)
            if sql_text is None:
                raise TableNotFoundError(f"view not found: {name}")
            return Output.records(_result_from_lists(
                ["View", "Create View"],
                [[name], [f"CREATE VIEW {name} AS {sql_text}"]]))
        if isinstance(stmt, A.ShowFlows):
            names = [] if self.flows is None else self.flows.flow_names()
            return Output.records(_result_from_lists(["Flows"], [names]))
        if isinstance(stmt, A.ShowCreateFlow):
            if self.flows is None:
                raise UnsupportedError("flows are not enabled")
            flow = self.flows.maybe_flow(stmt.name)
            if flow is None:
                raise TableNotFoundError(f"flow not found: {stmt.name}")
            return Output.records(_result_from_lists(
                ["Flow", "Create Flow"], [[stmt.name], [flow.raw_sql]]))
        if isinstance(stmt, A.Explain):
            return Output.records(self._explain(stmt, ctx))
        if isinstance(stmt, A.SetVariable):
            return self._set_variable(stmt, ctx)
        if isinstance(stmt, A.ShowVariables):
            return Output.records(self._show_variables(stmt, ctx))
        if isinstance(stmt, A.ShowStatus):
            return Output.records(_result_from_lists(
                ["Variable_name", "Value"], [["Uptime"], ["0"]]))
        if isinstance(stmt, A.ShowCharset):
            return Output.records(_result_from_lists(
                ["Charset", "Description", "Default collation", "Maxlen"],
                [["utf8mb4"], ["UTF-8 Unicode"], ["utf8mb4_bin"], [4]]))
        if isinstance(stmt, A.ShowCollation):
            return Output.records(_result_from_lists(
                ["Collation", "Charset", "Id", "Default", "Compiled",
                 "Sortlen"],
                [["utf8mb4_bin"], ["utf8mb4"], [46], ["Yes"], ["Yes"], [1]]))
        if isinstance(stmt, A.ShowProcesslist):
            return Output.records(self._show_processlist())
        if isinstance(stmt, A.Prepare):
            ctx.extensions.setdefault("prepared", {})[
                stmt.name.lower()] = stmt.sql_text
            return Output.rows(0)
        if isinstance(stmt, A.Execute):
            return self._execute_prepared(stmt, ctx)
        if isinstance(stmt, A.Deallocate):
            prepared = ctx.extensions.get("prepared", {})
            if stmt.name == "all":
                prepared.clear()
            elif prepared.pop(stmt.name.lower(), None) is None:
                raise InvalidArgumentError(
                    f"prepared statement {stmt.name!r} does not exist")
            return Output.rows(0)
        raise UnsupportedError(
            f"statement not supported yet: {type(stmt).__name__}")

    # ------------------------------------------------------------------
    # ADMIN (flush/compact by table or region id)
    # ------------------------------------------------------------------
    def _admin(self, stmt: A.Admin, ctx: QueryContext) -> Output:
        name = stmt.func
        if name in _WAITING_ADMIN:
            raise _waiting(f"ADMIN {name}", _WAITING_ADMIN[name])
        if name == "reset_device_profiler":
            # drops every program row; the exported
            # gtpu_device_program_* series zero at the next scrape, so
            # the three surfaces stay equal
            from greptimedb_tpu_torch.telemetry.device_programs import (
                global_programs,
            )

            return Output.records(_result_from_lists(
                ["ADMIN reset_device_profiler()"],
                [[global_programs.reset()]]))
        if name == "reset_statement_statistics":
            # drops every statement row; the gtpu_stmt_* counters keep
            # counting (carried bases)
            from greptimedb_tpu_torch.telemetry.stmt_stats import (
                global_stmt_stats,
            )

            return Output.records(_result_from_lists(
                ["ADMIN reset_statement_statistics()"],
                [[global_stmt_stats.reset()]]))

        def arg(i: int) -> A.Expr:
            if i >= len(stmt.args):
                raise InvalidArgumentError(
                    f"admin {name}: missing argument {i + 1}")
            return stmt.args[i]

        if name in ("flush_table", "compact_table"):
            ident = eval_const(arg(0))
            if not isinstance(ident, str):
                raise InvalidArgumentError(
                    f"admin {name}: arg 0 must be a string")
            db, tname = self._resolve(ident, ctx)
            table = self.catalog.table(db, tname)
            if name == "flush_table":
                results = [r.flush() is not None for r in table.regions]
            else:
                results = [bool(r.compact(force=True))
                           for r in table.regions]
            n = sum(1 for ok in results if ok)
            return Output.records(_result_from_lists(
                [f"ADMIN {name}('{ident}')"], [[n]]))
        if name == "flush_flow":
            fname = eval_const(arg(0))
            if not isinstance(fname, str):
                raise InvalidArgumentError(
                    f"admin {name}: arg 0 must be a string")
            if self.flows is None:
                raise UnsupportedError("flows are not enabled")
            n = 1 if self.flows.flush_flow(fname) else 0
            return Output.records(_result_from_lists(
                [f"ADMIN flush_flow('{fname}')"], [[n]]))
        if name in ("flush_region", "compact_region"):
            rid = eval_const(arg(0))
            if isinstance(rid, bool) or not isinstance(rid, (int,
                                                             np.integer)):
                raise InvalidArgumentError(
                    f"admin {name}: arg 0 must be an integer")
            rid = int(rid)
            if self.engine is None:
                raise UnsupportedError(
                    f"ADMIN {name} needs a storage engine (Standalone)")
            region = self.engine.region(rid)
            if name == "flush_region":
                n = 1 if region.flush() is not None else 0
            else:
                n = 1 if region.compact(force=True) else 0
            return Output.records(_result_from_lists(
                [f"ADMIN {name}({rid})"], [[n]]))
        if name == "kill":
            target = eval_const(arg(0))
            ok = self._process_list.kill(str(target))
            return Output.records(_result_from_lists(
                [f"ADMIN kill('{target}')"], [[1 if ok else 0]]))
        raise UnsupportedError(f"unknown admin function {name!r}")

    # ------------------------------------------------------------------
    # the session: SET, SHOW VARIABLES, PREPARE/EXECUTE, SHOW PROCESSLIST
    # ------------------------------------------------------------------
    def _set_variable(self, stmt: A.SetVariable, ctx: QueryContext
                      ) -> Output:
        for name, value_expr in stmt.assignments:
            value = eval_const(value_expr)
            if name in ("time_zone", "timezone", "session_time_zone"):
                # no result reads the session's zone yet (nor does the JAX
                # package's)
                ctx.timezone = str(value)
                ctx.variables["time_zone"] = str(value)
            else:
                ctx.variables[name] = (value if isinstance(value, str)
                                       else str(value))
        return Output.rows(0)

    def _show_variables(self, stmt: A.ShowVariables, ctx: QueryContext):
        from greptimedb_tpu_torch.query.expr import like_to_regex
        from greptimedb_tpu_torch.session import DEFAULT_VARIABLES

        merged = dict(DEFAULT_VARIABLES)
        merged.update(ctx.variables)
        items = sorted(merged.items())
        if stmt.like:
            pat = like_to_regex(stmt.like.lower())
            items = [(k, v) for k, v in items if pat.fullmatch(k.lower())]
        return _result_from_lists(
            ["Variable_name", "Value"],
            [[k for k, _ in items], [v for _, v in items]])

    def _show_processlist(self) -> QueryResult:
        entries = self._process_list.snapshot()
        return _result_from_lists(
            ["Id", "User", "db", "Command", "State", "Time", "Info"],
            [[e["id"] for e in entries],
             [e["user"] for e in entries],
             [e["db"] for e in entries],
             ["Query"] * len(entries),
             [e.get("state", "Running") for e in entries],
             [round(e["elapsed_s"], 3) for e in entries],
             [e["query"] for e in entries]])

    def _execute_prepared(self, stmt: A.Execute, ctx: QueryContext
                          ) -> Output:
        """EXECUTE: the prepared text with its placeholders bound to the
        arguments as literals, parsed and run as one statement."""
        text = ctx.extensions.get("prepared", {}).get(stmt.name.lower())
        if text is None:
            raise InvalidArgumentError(
                f"prepared statement {stmt.name!r} does not exist")
        args = [eval_const(a) for a in stmt.args]
        stmts = parse_sql(substitute_placeholders(text, args))
        if len(stmts) != 1:
            raise InvalidArgumentError(
                "prepared statement must be a single statement")
        return self._execute_statement(stmts[0], ctx)

    # ------------------------------------------------------------------
    # DDL
    # ------------------------------------------------------------------
    def _create_table(self, stmt: A.CreateTable, ctx: QueryContext):
        db, name = self._resolve(stmt.name, ctx)
        if stmt.like_table is not None:
            sdb, sname = self._resolve(stmt.like_table, ctx)
            src = self.catalog.table(sdb, sname)
            self.catalog.create_table(
                db, name, Schema(list(src.schema.columns)),
                engine=src.info.engine, options=dict(src.info.options),
                num_regions=len(src.regions),
                if_not_exists=stmt.if_not_exists)
            return
        cols = []
        pk = set(stmt.primary_keys)
        for cd in stmt.columns:
            if cd.time_index or (stmt.time_index == cd.name):
                sem = SemanticType.TIMESTAMP
            elif cd.primary_key or cd.name in pk:
                sem = SemanticType.TAG
            else:
                sem = SemanticType.FIELD
            cols.append(ColumnSchema(
                name=cd.name, data_type=cd.data_type, semantic_type=sem,
                nullable=cd.nullable and sem == SemanticType.FIELD,
                default=_const_default(cd.default), fulltext=cd.fulltext))
        schema = Schema(cols)
        options = dict(stmt.options)
        num_regions = int(options.pop("num_regions", 1))
        self.catalog.create_table(
            db, name, schema, engine=stmt.engine, options=options,
            num_regions=num_regions, if_not_exists=stmt.if_not_exists,
            partition=stmt.partitions or None)

    def _alter(self, stmt: A.AlterTable, ctx: QueryContext) -> int:
        db, name = self._resolve(stmt.name, ctx)
        if stmt.action == "add_column":
            cd = stmt.column
            sem = SemanticType.TAG if cd.primary_key else SemanticType.FIELD
            self.catalog.alter_add_column(db, name, ColumnSchema(
                name=cd.name, data_type=cd.data_type, semantic_type=sem,
                nullable=True, default=_const_default(cd.default)))
        elif stmt.action == "drop_column":
            self.catalog.alter_drop_column(db, name, stmt.old_name)
        elif stmt.action == "rename":
            self.catalog.rename_table(db, name, stmt.new_name)
        else:
            raise UnsupportedError(f"ALTER action: {stmt.action}")
        return 0

    # ------------------------------------------------------------------
    # DML
    # ------------------------------------------------------------------
    def _insert(self, stmt: A.Insert, ctx: QueryContext) -> int:
        db, name = self._resolve(stmt.table, ctx)
        table = self.catalog.table(db, name)
        schema = table.schema
        if stmt.select is not None:
            res = self._select(stmt.select, ctx)
            cols = stmt.columns or res.names
            data = {c: np.asarray(col.values)
                    for c, col in zip(cols, res.cols)}
            valid = {c: col.valid_mask for c, col in zip(cols, res.cols)}
            _apply_defaults(schema, data, valid, res.num_rows)
            written = self._write_columns(table, data, valid)
            self._notify_flows(db, name, table, data, valid)
            return written
        cols = stmt.columns or schema.column_names
        n = len(stmt.values)
        raw = {c: [] for c in cols}
        for row in stmt.values:
            if len(row) != len(cols):
                raise InvalidArgumentError(
                    f"INSERT row has {len(row)} values, expected {len(cols)}")
            for c, e in zip(cols, row):
                raw[c].append(eval_const(e))
        data, valid = {}, {}
        for c, vals in raw.items():
            data[c], valid[c] = _coerce_insert(
                vals, schema.column(c).data_type)
        _apply_defaults(schema, data, valid, n)
        written = self._write_columns(table, data, valid)
        self._notify_flows(db, name, table, data, valid)
        return written

    def _write_columns(self, table, data: dict, valid: dict) -> int:
        schema = table.schema
        ts_name = schema.time_index.name
        if ts_name not in data:
            raise InvalidArgumentError(
                f"INSERT missing TIME INDEX column {ts_name}")
        tags, fields, fvalid = {}, {}, {}
        for cname, arr in data.items():
            cs = schema.column(cname)
            if cs.is_time_index:
                continue
            if cs.is_tag:
                tags[cname] = np.asarray(
                    ["" if v is None else str(v) for v in arr], object)
            else:
                fields[cname] = arr
                if cname in valid and not valid[cname].all():
                    fvalid[cname] = valid[cname]
        ts = np.asarray(data[ts_name], np.int64)
        return table.write(tags, ts, fields, field_valid=fvalid or None)

    def _notify_flows(self, db, name, table, data, valid):
        """Mirror a write's columns to the flows reading its table."""
        if self.flows is not None:
            self.flows.on_insert(db, name, table, data, valid)

    def enable_flows(self, *, tick_interval_s: float | None = None):
        """The flow manager, started on first use: it loads the flows
        the data root persisted and re-derives their state from their
        sources. A later call retargets the tick interval."""
        if self.engine is None:
            raise UnsupportedError(
                "flows need a storage engine (Standalone)")
        if self.flows is None:
            from greptimedb_tpu_torch.flow import FlowManager

            self.flows = FlowManager(self, tick_interval_s=tick_interval_s)
        elif tick_interval_s is not None:
            # the running ticker takes it at its next wait
            self.flows.tick_interval_s = tick_interval_s
        return self.flows

    def _delete(self, stmt: A.Delete, ctx: QueryContext) -> int:
        db, name = self._resolve(stmt.table, ctx)
        table = self.catalog.table(db, name)
        sel = A.Select(
            items=[A.SelectItem(A.Column(t)) for t in table.tag_names]
            + [A.SelectItem(A.Column(table.ts_name))],
            from_table=stmt.table, where=stmt.where)
        res = self._select(sel, ctx)
        if res.num_rows == 0:
            return 0
        tags = {t: np.asarray(res.cols[i].values, object)
                for i, t in enumerate(table.tag_names)}
        ts = np.asarray(res.cols[-1].values, np.int64)
        table.delete(tags, ts)
        return len(ts)

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    def _select(self, stmt: A.Select, ctx: QueryContext | None = None
                ) -> QueryResult:
        from greptimedb_tpu_torch.query import relational

        ctx = ctx or QueryContext()
        if relational.needs_relational(self, stmt, ctx):
            return relational.execute(self, stmt, ctx)
        return self._select_single(stmt, ctx)

    def _select_single(self, stmt: A.Select, ctx: QueryContext
                       ) -> QueryResult:
        """A single-table SELECT (or one without FROM): the plan runs
        straight on the table's scan, device grid and grouped reduce; a
        system table answers from its provider."""
        if stmt.from_table:
            from greptimedb_tpu_torch import information_schema as IS

            if self._is_information_schema(stmt.from_table, ctx):
                return IS.query_information_schema(self, stmt, ctx)
            if self._is_pg_catalog(stmt.from_table, ctx):
                return IS.query_pg_catalog(self, stmt, ctx)
        from greptimedb_tpu_torch.telemetry import tracing

        with tracing.child_span("query.plan",
                                table=stmt.from_table or ""):
            plan, table = self.plan(stmt, ctx)
        return self._execute_select_plan(plan, table, ctx)

    def _execute_select_plan(self, plan, table, ctx: QueryContext):
        """A planned single-table SELECT through the result path: the
        result cache first (a repeated poll over unchanged physical
        versions runs nothing on the card and reads nothing back), then
        the `since` cursor bound for the execution paths (the scan's ts
        bound, the grid's narrowed readback)."""
        from greptimedb_tpu_torch.query import result_cache as RC
        from greptimedb_tpu_torch.query import sessions, stats
        from greptimedb_tpu_torch.telemetry import stmt_stats, tracing

        since = ctx.extensions.get("since_ms")
        rc = self.result_cache
        # EXPLAIN ANALYZE reports a real execution, never a cached one
        use_cache = rc.eligible(plan, table) and stats.active() is None
        if use_cache and since is not None and plan.kind != "aggregate" \
                and (plan.limit is not None or bool(plan.offset)
                     or RC.ts_output_name(plan, table) is None):
            # a since poll is served from the cached FULL result only
            # where the host row filter equals the execution path's
            # cursor (applied before ORDER BY/LIMIT): LIMIT/OFFSET plans
            # and row plans that do not project the time index execute
            # the delta. Aggregates ignore the cursor.
            use_cache = False
        fp = versions = None
        if use_cache:
            fp = RC.plan_fingerprint(plan)
            versions = table.physical_version()
            entry = rc.get(table.info.database, table, fp, versions)
            if entry is not None:
                tracing.set_attr(result_cache="hit")
                stats.note("result_cache", "hit")
                stmt_stats.add("result_cache_hits")
                # the path the cached result came from
                self.query_engine.last_exec_path = entry.exec_path
                res = entry.result
                if since is not None:
                    res = RC.filter_since(res, entry.ts_name, since)
                return res
            tracing.set_attr(result_cache="miss")
            stats.note("result_cache", "miss")
            stmt_stats.add("result_cache_misses")
        elif rc.enabled:
            tracing.set_attr(result_cache="bypass")
            stats.note("result_cache", "bypass")
            stmt_stats.add("result_cache_bypass")
        token = sessions.bind_since(since) if since is not None else None
        try:
            res = self.query_engine.execute(plan, table)
        finally:
            if token is not None:
                sessions.reset_since(token)
        if use_cache and since is None:
            # only full results are stored: a delta answer must never
            # be served as the statement's result
            rc.put(table.info.database, table, fp, versions, res,
                   RC.ts_output_name(plan, table),
                   self.query_engine.last_exec_path)
        return res

    def plan(self, stmt: A.Select, ctx: QueryContext | None = None):
        """(plan, table) of a single-table SELECT (table None without
        FROM)."""
        table = None
        ts_name, tag_names, all_columns = None, [], None
        if stmt.from_table:
            db, name = self._resolve(stmt.from_table, ctx or QueryContext())
            table = self.catalog.table(db, name)
            ts_name, tag_names = table.ts_name, table.tag_names
            all_columns = table.schema.column_names
        return plan_select(stmt, ts_name=ts_name, tag_names=tag_names,
                           all_columns=all_columns), table

    def _explain(self, stmt: A.Explain, ctx: QueryContext) -> QueryResult:
        """EXPLAIN: a single-table SELECT's plan lines, or
        `SelectPlan[relational]` for a CTE, a join, a subquery in FROM or
        a set operation. ANALYZE also runs it under query/stats'
        collector: a `Metrics:` line (rows, elapsed ms), then the
        collector's lines (the analyzed statement's fingerprint among
        them), then the `Trace:` span tree of this execution."""
        from greptimedb_tpu_torch.query import relational, stats
        from greptimedb_tpu_torch.telemetry import stmt_stats, tracing

        inner = stmt.statement
        if not isinstance(inner, (A.Select, A.SetOp)):
            raise UnsupportedError("EXPLAIN supports SELECT only")
        if isinstance(inner, A.Select) and not (
                inner.ctes or isinstance(
                    inner.source, (A.JoinSource, A.SubquerySource))):
            plan, _ = self.plan(inner, ctx)
            lines = plan.explain_lines()
        else:
            lines = ["SelectPlan[relational]"]
        if stmt.analyze:
            t0 = time.perf_counter()
            with stats.collect() as st, tracing.export_spans() as tspans:
                # the ANALYZED statement's fingerprint ("EXPLAIN ANALYZE
                # <q>" and a plain "<q>" share it), so the metrics join
                # its statement_statistics row
                sfp = stmt_stats.explain_fingerprint()
                if sfp:
                    st.note("stmt_fingerprint", sfp)
                if isinstance(inner, A.SetOp):
                    res = relational.execute(self, inner, ctx)
                else:
                    res = self._select(inner, ctx)
            dt = (time.perf_counter() - t0) * 1000
            lines.append(f"  Metrics: rows={res.num_rows} elapsed={dt:.3f}ms")
            lines.extend(st.lines())
            if tspans:
                # this execution's span tree, as /v1/traces serves it
                tid = tracing.current_trace_id()
                remote = tracing.global_traces.trace(tid) if tid else []
                local_ids = {s.span_id for s in tspans}
                docs = [s.to_json() for s in tspans] + [
                    d for d in remote
                    if d["span_id"] not in local_ids
                    and d.get("duration_ms") is not None
                ]
                lines.append(f"  Trace: {tid or '(sampling disabled)'}")
                lines.extend(
                    "    " + ln for ln in tracing.render_tree(docs))
        return _result_from_lists(["plan"], [lines])

    def _is_information_schema(self, name: str, ctx: QueryContext) -> bool:
        if "." in name:
            return name.split(".", 1)[0].lower() == "information_schema"
        return ctx.database.lower() == "information_schema"

    def _is_pg_catalog(self, name: str, ctx: QueryContext) -> bool:
        """A pg_catalog shim: a name qualified by pg_catalog, or a bare
        shim name that no user table shadows."""
        from greptimedb_tpu_torch.information_schema import PG_CATALOG_TABLES

        if "." in name:
            return name.split(".", 1)[0].lower() == "pg_catalog"
        if name.lower() not in PG_CATALOG_TABLES:
            return False
        db, tname = self._resolve(name, ctx)
        return self.catalog.maybe_table(db, tname) is None

    def _tql(self, stmt: A.Tql, ctx: QueryContext) -> QueryResult:
        from greptimedb_tpu_torch.promql.engine import PromEngine
        from greptimedb_tpu_torch.promql.parser import parse_promql

        start = _tql_time(stmt.start)
        end = _tql_time(stmt.end)
        step_ms = _tql_interval(stmt.step)
        lookback_ms = (_tql_interval(stmt.lookback)
                       if stmt.lookback is not None else 300_000)
        if stmt.kind == "explain":
            return _result_from_lists(
                ["plan"], [[repr(parse_promql(stmt.query))]])
        return PromEngine(self, ctx).query_range_result(
            stmt.query, start, end, step_ms, lookback_ms=lookback_ms)

    # ------------------------------------------------------------------
    # SHOW / DESCRIBE
    # ------------------------------------------------------------------
    def _show_databases(self, stmt: A.ShowDatabases) -> QueryResult:
        from greptimedb_tpu_torch.query.expr import like_to_regex

        names = self.catalog.database_names()
        if stmt.like:
            rx = like_to_regex(stmt.like)
            names = [n for n in names if rx.fullmatch(n)]
        return _result_from_lists(["Database"], [names])

    def _show_tables(self, stmt: A.ShowTables, ctx: QueryContext
                     ) -> QueryResult:
        from greptimedb_tpu_torch.query.expr import like_to_regex

        names = self.catalog.table_names(stmt.database or ctx.database)
        if stmt.like:
            rx = like_to_regex(stmt.like)
            names = [n for n in names if rx.fullmatch(n)]
        return _result_from_lists(["Tables"], [names])

    def _show_columns(self, stmt: A.ShowColumns, ctx: QueryContext):
        from greptimedb_tpu_torch.query.expr import like_to_regex

        table = self.catalog.table(stmt.database or ctx.database, stmt.table)
        pat = like_to_regex(stmt.like.lower()) if stmt.like else None
        names, types, nulls, keys, defaults, semantics = [], [], [], [], [], []
        for cs in table.schema.columns:
            if pat is not None and not pat.fullmatch(cs.name.lower()):
                continue
            names.append(cs.name)
            types.append(cs.data_type.name)
            nulls.append("Yes" if cs.nullable else "No")
            keys.append("TIME INDEX" if cs.is_time_index
                        else "PRI" if cs.is_tag else "")
            defaults.append(default_display(cs.default))
            semantics.append(cs.semantic_type.name)
        cols = [names, types, nulls, keys, defaults]
        headers = ["Column", "Type", "Null", "Key", "Default"]
        if stmt.full:
            headers.append("Semantic Type")
            cols.append(semantics)
        return _result_from_lists(headers, cols)

    def _show_index(self, stmt: A.ShowIndex, ctx: QueryContext):
        table = self.catalog.table(stmt.database or ctx.database, stmt.table)
        tags = table.tag_names
        names = [stmt.table] * (len(tags) + 1)
        key_names = ["PRIMARY"] * len(tags) + ["TIME INDEX"]
        seqs = list(range(1, len(tags) + 1)) + [1]
        return _result_from_lists(
            ["Table", "Key_name", "Seq_in_index", "Column_name"],
            [names, key_names, seqs, tags + [table.ts_name]])

    def _describe(self, stmt: A.DescribeTable, ctx: QueryContext
                  ) -> QueryResult:
        db, name = self._resolve(stmt.name, ctx)
        table = self.catalog.table(db, name)
        names, types, keys, nulls, defaults, semantics = [], [], [], [], [], []
        for c in table.schema.columns:
            names.append(c.name)
            types.append(_sql_type_name(c.data_type))
            keys.append("PRI" if c.is_tag or c.is_time_index else "")
            nulls.append("YES" if c.nullable else "NO")
            defaults.append(default_display(c.default))
            semantics.append("TIMESTAMP" if c.is_time_index
                             else ("TAG" if c.is_tag else "FIELD"))
        return _result_from_lists(
            ["Column", "Type", "Key", "Null", "Default", "Semantic Type"],
            [names, types, keys, nulls, defaults, semantics])

    def _show_create_table(self, stmt: A.ShowCreateTable, ctx: QueryContext
                           ) -> QueryResult:
        db, name = self._resolve(stmt.name, ctx)
        table = self.catalog.table(db, name)
        lines = [f"CREATE TABLE IF NOT EXISTS `{name}` ("]
        defs = []
        for c in table.schema.columns:
            d = f"  `{c.name}` {_sql_type_name(c.data_type)}"
            if not c.nullable:
                d += " NOT NULL"
            dflt = default_sql(c.default)
            if dflt is not None:
                d += f" DEFAULT {dflt}"
            defs.append(d)
        defs.append(f"  TIME INDEX (`{table.schema.time_index.name}`)")
        if table.tag_names:
            defs.append("  PRIMARY KEY ("
                        + ", ".join(f"`{t}`" for t in table.tag_names) + ")")
        lines.append(",\n".join(defs))
        lines.append(")")
        lines.append(f"ENGINE={table.info.engine}")
        if table.info.options:
            opts = ", ".join(f"{k!r}={v!r}"
                             for k, v in table.info.options.items())
            lines.append(f"WITH({opts})")
        return _result_from_lists(["Table", "Create Table"],
                                  [[name], ["\n".join(lines)]])

    # ------------------------------------------------------------------
    @staticmethod
    def _resolve(name: str, ctx: QueryContext) -> tuple[str, str]:
        """(database, table) of a possibly qualified name."""
        if "." in name:
            db, t = name.split(".", 1)
            return db, t
        return ctx.database, name


class Standalone(Instance):
    """Single-process database (the JAX package's Standalone): a storage
    engine over `data_root`, its durable catalog and a query engine on
    `device` (default CUDA). `warm_start` restores the grids' restart
    snapshots on a background thread, as the JAX package does
    (`warm_thread`; a cold cache is only slower)."""

    def __init__(self, data_root: str = "./greptimedb_tpu_data", *,
                 engine_config=None, prefer_device: bool | None = None,
                 mesh=None, mesh_opts=None, warm_start: bool = True,
                 store=None, cold_store=None, device=None,
                 x64: bool = False):
        from greptimedb_tpu_torch.storage.engine import (
            EngineConfig,
            TsdbEngine,
        )

        cfg = engine_config or EngineConfig(data_root=data_root,
                                            enable_background=False)
        engine = TsdbEngine(cfg, store=store, cold_store=cold_store,
                            device=device)
        super().__init__(device=device, mesh=mesh, mesh_opts=mesh_opts,
                         prefer_device=prefer_device, x64=x64,
                         catalog=CatalogManager(engine))
        self.warm_thread = None
        if warm_start:
            self.warm_thread = threading.Thread(
                target=self._warm, daemon=True, name="device-cache-warm")
            self.warm_thread.start()

    def _warm(self):
        from greptimedb_tpu_torch.query.device_range import (
            warm_from_snapshots,
        )

        try:
            warm_from_snapshots(self.query_engine, self.catalog)
        except Exception as e:  # noqa: BLE001 - cold caches are only slower
            _log.debug("device cache warm-start skipped: %s", e)

    def close(self):
        if self.warm_thread is not None:
            self.warm_thread.join()
        if self.flows is not None:
            # the ticker stops and the last state reaches the sinks
            # before the engine closes
            self.flows.stop()
        # the closed instance's cached results, grids and the session
        # buffers of those grids go with it
        self.result_cache.clear()
        self.query_engine.range_cache.clear()
        self.engine.close()


# ----------------------------------------------------------------------
# defaults, literals and placeholders (copies of the JAX instance's
# helpers)
# ----------------------------------------------------------------------
def format_sql_literal(v) -> str:
    """Python value -> SQL literal text."""
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    s = str(v).replace("\\", "\\\\").replace("'", "''")
    return f"'{s}'"


def _scan_sql_segments(text: str):
    """Yields ('text'|'quoted'|'qmark'|'dollar', segment) pieces: the one
    quoting state machine that placeholder binding and the `?` counter
    share. Placeholders inside quotes and comments stay text."""
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == "-" and text[i:i + 2] == "--":
            j = text.find("\n", i)
            j = n if j < 0 else j
            yield "text", text[i:j]
            i = j
            continue
        if c == "/" and text[i:i + 2] == "/*":
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            yield "text", text[i:j]
            i = j
            continue
        if c in ("'", '"', "`"):
            close = c
            j = i + 1
            while j < n:
                if text[j] == close and j + 1 < n and text[j + 1] == close:
                    j += 2
                elif text[j] == "\\" and close == "'" and j + 1 < n:
                    j += 2
                elif text[j] == close:
                    break
                else:
                    j += 1
            yield "quoted", text[i:j + 1]
            i = j + 1
            continue
        if c == "?":
            yield "qmark", "?"
            i += 1
            continue
        if c == "$":
            m = re.match(r"\$(\d+)", text[i:])
            if m:
                yield "dollar", m.group(1)
                i += m.end()
                continue
        yield "text", c
        i += 1


def count_placeholders(text: str) -> int:
    """`?` placeholders outside strings, quoted names and comments."""
    return sum(1 for kind, _ in _scan_sql_segments(text) if kind == "qmark")


def substitute_placeholders(text: str, args: list) -> str:
    """Bind `?` (positional) and `$n` placeholders outside strings,
    quoted names and comments to `args` as literals (PREPARE/EXECUTE
    binds at the text layer, before parsing)."""
    out = []
    pos = 0  # next ? index
    for kind, seg in _scan_sql_segments(text):
        if kind == "qmark":
            if pos >= len(args):
                raise InvalidArgumentError(
                    f"not enough parameters: need > {pos}, have {len(args)}")
            out.append(format_sql_literal(args[pos]))
            pos += 1
        elif kind == "dollar":
            k = int(seg)
            if not (1 <= k <= len(args)):
                raise InvalidArgumentError(
                    f"parameter ${k} out of range (have {len(args)})")
            out.append(format_sql_literal(args[k - 1]))
        else:
            out.append(seg)
    return "".join(out)


def _const_default(default):
    """A DDL DEFAULT for the catalog: literal expressions fold to values;
    expressions with calls (now(), current_timestamp()) persist as
    {"__expr__": text} and are evaluated at every insert."""
    if not isinstance(default, A.Expr):
        return default

    def has_call(e) -> bool:
        if isinstance(e, A.FuncCall):
            return True
        if isinstance(e, A.BinaryOp):
            return has_call(e.left) or has_call(e.right)
        if isinstance(e, (A.UnaryOp, A.Cast, A.IsNull)):
            return has_call(e.operand)
        if isinstance(e, A.Between):
            return any(has_call(x) for x in (e.operand, e.low, e.high))
        if isinstance(e, A.InList):
            return has_call(e.operand) or any(has_call(x) for x in e.items)
        if isinstance(e, A.Case):
            parts = (([e.operand] if e.operand else [])
                     + [x for w in e.whens for x in w]
                     + ([e.else_] if e.else_ else []))
            return any(has_call(x) for x in parts)
        return False

    if has_call(default):
        return {"__expr__": _default_expr_sql(default)}
    return eval_const(default)


def _default_expr_sql(e: A.Expr) -> str:
    """A DEFAULT expression as text that re-parses to the same tree (every
    compound operand parenthesized)."""
    if isinstance(e, A.BinaryOp):
        return (f"({_default_expr_sql(e.left)}) {e.op} "
                f"({_default_expr_sql(e.right)})")
    if isinstance(e, A.UnaryOp):
        return f"{e.op} ({_default_expr_sql(e.operand)})"
    if isinstance(e, A.Cast):
        return f"CAST(({_default_expr_sql(e.operand)}) AS {e.to.name})"
    if isinstance(e, A.FuncCall):
        args = ", ".join(f"({_default_expr_sql(a)})" for a in e.args)
        return f"{e.name}({args})"
    if isinstance(e, A.Case):
        parts = ["CASE"]
        if e.operand is not None:
            parts.append(f"({_default_expr_sql(e.operand)})")
        for c, t in e.whens:
            parts.append(f"WHEN ({_default_expr_sql(c)}) "
                         f"THEN ({_default_expr_sql(t)})")
        if e.else_ is not None:
            parts.append(f"ELSE ({_default_expr_sql(e.else_)})")
        parts.append("END")
        return " ".join(parts)
    if isinstance(e, A.IsNull):
        neg = " NOT" if e.negated else ""
        return f"({_default_expr_sql(e.operand)}) IS{neg} NULL"
    if isinstance(e, A.Between):
        neg = "NOT " if e.negated else ""
        return (f"({_default_expr_sql(e.operand)}) {neg}BETWEEN "
                f"({_default_expr_sql(e.low)}) AND "
                f"({_default_expr_sql(e.high)})")
    if isinstance(e, A.InList):
        neg = "NOT " if e.negated else ""
        items = ", ".join(f"({_default_expr_sql(x)})" for x in e.items)
        return f"({_default_expr_sql(e.operand)}) {neg}IN ({items})"
    from greptimedb_tpu_torch.query.expr import format_expr

    return format_expr(e)


def default_display(default) -> str:
    """A stored default as SHOW/DESCRIBE print it."""
    if default is None:
        return ""
    if isinstance(default, dict) and "__expr__" in default:
        return default["__expr__"]
    return str(default)


def default_sql(default) -> str | None:
    """A stored default as DDL text (None: no DEFAULT clause)."""
    if default is None:
        return None
    if isinstance(default, dict) and "__expr__" in default:
        return default["__expr__"]
    return format_sql_literal(default)


@functools.lru_cache(maxsize=512)
def _parse_default_expr(text: str) -> A.Expr:
    from greptimedb_tpu_torch.sql.parser import Parser

    return Parser(text).expr()


def _eval_default(default):
    """A stored default -> this insert's value."""
    if isinstance(default, dict) and "__expr__" in default:
        return eval_const(_parse_default_expr(default["__expr__"]))
    if isinstance(default, A.Expr):
        return eval_const(default)
    return default


def _apply_defaults(schema, data: dict, valid: dict, n: int):
    """Declared DEFAULTs fill the columns an INSERT leaves out (explicit
    NULLs stay NULL); the time index takes part too."""
    for cs in schema.columns:
        if cs.name in data or cs.default is None:
            continue
        arr, v = _coerce_insert([_eval_default(cs.default)] * n,
                                cs.data_type)
        data[cs.name] = arr
        valid[cs.name] = v


def _coerce_insert(vals: list, dt: ConcreteDataType):
    n = len(vals)
    validity = np.asarray([v is not None for v in vals], bool)
    if dt.is_timestamp():
        out = np.zeros(n, np.int64)
        for i, v in enumerate(vals):
            if v is not None:
                out[i] = parse_ts_literal(v) if isinstance(v, str) else int(v)
        return out, validity
    if dt.is_string():
        return (np.asarray(["" if v is None else str(v) for v in vals],
                           object), validity)
    if dt.is_decimal():
        out = np.zeros(n, np.float64)
        for i, v in enumerate(vals):
            if v is not None:
                out[i] = float(v)
        return out, validity
    out = np.zeros(n, dt.to_numpy())
    for i, v in enumerate(vals):
        if v is not None:
            out[i] = v
    return out, validity


def _sql_type_name(dt: ConcreteDataType) -> str:
    names = {
        "int8": "TINYINT", "int16": "SMALLINT", "int32": "INT",
        "int64": "BIGINT", "uint8": "TINYINT UNSIGNED",
        "uint16": "SMALLINT UNSIGNED", "uint32": "INT UNSIGNED",
        "uint64": "BIGINT UNSIGNED", "float32": "FLOAT", "float64": "DOUBLE",
        "string": "STRING", "binary": "VARBINARY", "bool": "BOOLEAN",
        "timestamp_s": "TIMESTAMP(0)", "timestamp_ms": "TIMESTAMP(3)",
        "timestamp_us": "TIMESTAMP(6)", "timestamp_ns": "TIMESTAMP(9)",
        "date": "DATE", "json": "JSON",
    }
    return names.get(dt.name, dt.name.upper())


def _tql_time(e: A.Expr) -> int:
    v = eval_const(e)
    if isinstance(v, str):
        try:
            return int(float(v) * 1000)
        except ValueError:
            return parse_ts_literal(v)
    return int(float(v) * 1000)


def _tql_interval(e: A.Expr) -> int:
    if isinstance(e, A.IntervalLit):
        return e.ms
    v = eval_const(e)
    if isinstance(v, str):
        from greptimedb_tpu_torch.sql.parser import parse_interval_ms

        return parse_interval_ms(v)
    return int(float(v) * 1000)
