"""The SQL entry point: `Instance(...).sql(text)` (the JAX package's
Standalone.sql, for SELECT statements).

An Instance holds a `catalog` (catalog/manager.CatalogManager; tables go in
with `catalog.register(table)`) and a `query_engine`
(query/executor.QueryEngine on `device`, default CUDA, with an optional
mesh, the JAX engine's `prefer_device` and the JAX package's x64 mode,
`x64`, off by default). `catalog=` takes a CatalogManager over a storage
engine (durable tables, catalog/manager.py); the default keeps tables in
memory. `sql` parses the text
(sql/parser.parse_sql), plans each SELECT against its table
(query/planner.plan_select), or against no table for a SELECT without
FROM, and executes it: RANGE plans on the device grid or the host RANGE
path, GROUP BY through the grouped reduce (on the card or the host), row
filters and projections on the host. Every other statement, joins,
subqueries, CTEs, information_schema and window functions raise
UnsupportedError naming the shape: DDL, INSERT over SQL, HTTP and the
rest of the JAX instance are later slices.
`promql/engine.PromEngine(instance)` reads the same catalog and engine.
"""

from __future__ import annotations

from greptimedb_tpu_torch.catalog.manager import CatalogManager
from greptimedb_tpu_torch.errors import UnsupportedError
from greptimedb_tpu_torch.query.executor import QueryEngine, QueryResult
from greptimedb_tpu_torch.query.planner import plan_select
from greptimedb_tpu_torch.sql import ast as A
from greptimedb_tpu_torch.sql.parser import parse_sql

DEFAULT_DATABASE = "public"


class Instance:
    def __init__(self, device=None, mesh=None, mesh_opts=None,
                 prefer_device: bool | None = True, x64: bool = False,
                 catalog: CatalogManager | None = None):
        self.catalog = catalog if catalog is not None else CatalogManager()
        self.query_engine = QueryEngine(device=device, mesh=mesh,
                                        mesh_opts=mesh_opts,
                                        prefer_device=prefer_device, x64=x64)

    def sql(self, sql: str) -> QueryResult:
        """Run every statement of `sql`; returns the last one's result.
        Unqualified table names are looked up in the "public" database."""
        out = None
        for stmt in parse_sql(sql):
            out = self.execute_statement(stmt)
        return out

    def execute_statement(self, stmt: A.Statement) -> QueryResult:
        if isinstance(stmt, A.Select):
            return self._select(stmt)
        raise UnsupportedError(
            f"{type(stmt).__name__} statements are not ported yet")

    def _select(self, stmt: A.Select) -> QueryResult:
        if stmt.ctes or isinstance(stmt.source, (A.JoinSource,
                                                 A.SubquerySource)):
            raise UnsupportedError(
                "CTEs, joins and subqueries in FROM are not ported yet")
        if not stmt.from_table:
            plan = plan_select(stmt, ts_name=None, tag_names=[],
                               all_columns=None)
            return self.query_engine.execute(plan, None)
        plan, table = self.plan(stmt)
        return self.query_engine.execute(plan, table)

    def plan(self, stmt: A.Select):
        """(plan, table) of a single-table SELECT."""
        db, name = self._resolve(stmt.from_table, DEFAULT_DATABASE)
        if db.lower() == "information_schema":
            raise UnsupportedError("information_schema is not ported yet")
        table = self.catalog.table(db, name)
        return plan_select(stmt, ts_name=table.ts_name,
                           tag_names=table.tag_names,
                           all_columns=table.schema.column_names), table

    @staticmethod
    def _resolve(name: str, database: str) -> tuple[str, str]:
        if "." in name:
            db, t = name.split(".", 1)
            return db, t
        return database, name
