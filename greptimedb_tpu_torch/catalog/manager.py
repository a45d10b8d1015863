"""Catalog: databases -> tables (the JAX package's catalog/manager.py, for
single-region tables).

Without an engine the catalog holds tables registered as built
(`register`), in memory, and answers DDL with UnsupportedError. With a
storage engine (storage/engine.TsdbEngine) `create_table` opens each table
over one engine region and the catalog persists databases and table
metadata (TableInfo: the typed schema, engine, options) as JSON
(meta/catalog.json in the engine's object store), so a fresh process
reopens every table, WAL replay included (`CatalogManager(engine)` loads
them, opening their regions on the engine's bounded recovery pool in one
batch). Views are stored as SQL text per database (`create_view`,
`maybe_view`), persisted beside the tables and re-planned by
query/relational.py on every query. `create_table` takes the JAX
signature (a Schema; `Schema.of` builds one from names). Logical metric tables (engine="metric", metric_engine.py) ride one shared physical
table per database. Region ids pack (table_id, region number) as the JAX
package's do; `num_regions > 1` and `PARTITION ON` wait for ROADMAP A10,
the file engine (`CREATE EXTERNAL TABLE`) for A2's tail.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from dataclasses import dataclass, field as dc_field

from greptimedb_tpu_torch.datatypes.schema import (
    ColumnSchema,
    Schema,
    SemanticType,
)
from greptimedb_tpu_torch.datatypes.types import ConcreteDataType
from greptimedb_tpu_torch.errors import (
    DatabaseNotFoundError,
    IllegalStateError,
    InvalidArgumentError,
    TableAlreadyExistsError,
    TableNotFoundError,
    UnsupportedError,
)

DEFAULT_SCHEMA = "public"
CATALOG_PATH = "meta/catalog.json"
_REGION_SHIFT = 10
_log = logging.getLogger("greptimedb_tpu_torch.catalog")


@dataclass
class TableInfo:
    table_id: int
    name: str
    database: str
    schema: Schema
    engine: str = "mito"
    options: dict = dc_field(default_factory=dict)
    num_regions: int = 1
    created_ms: int = 0

    @property
    def region_id(self) -> int:
        return self.table_id << _REGION_SHIFT

    def to_json(self) -> dict:
        return {
            "table_id": self.table_id, "name": self.name,
            "database": self.database, "engine": self.engine,
            "options": self.options, "num_regions": self.num_regions,
            "created_ms": self.created_ms,
            "columns": [
                {"name": c.name, "type": c.data_type.name,
                 "semantic": int(c.semantic_type), "nullable": c.nullable,
                 "default": c.default, "fulltext": c.fulltext,
                 "inverted_index": c.inverted_index}
                for c in self.schema.columns
            ],
            "schema_version": self.schema.version,
        }

    @staticmethod
    def from_json(d: dict) -> "TableInfo":
        cols = [
            ColumnSchema(
                name=c["name"],
                data_type=ConcreteDataType.from_name(c["type"]),
                semantic_type=SemanticType(c["semantic"]),
                nullable=c.get("nullable", True),
                default=c.get("default"),
                # a catalog written before the flags has no such keys
                fulltext=c.get("fulltext", False),
                inverted_index=c.get("inverted_index", False))
            for c in d["columns"]
        ]
        return TableInfo(
            table_id=d["table_id"], name=d["name"], database=d["database"],
            schema=Schema(cols, version=d.get("schema_version", 0)),
            engine=d.get("engine", "mito"), options=d.get("options", {}),
            num_regions=d.get("num_regions", 1),
            created_ms=d.get("created_ms", 0))


def append_mode_enabled(options: dict | None) -> bool:
    return str((options or {}).get("append_mode", "")).lower() in (
        "true", "1")


def validate_table_options(options: dict | None):
    """CREATE-time check: a TTL or compaction window must be positive (a
    negative TTL would expire every row). Reopen stays lenient."""
    from greptimedb_tpu_torch.sql.parser import parse_interval_ms

    for key in ("ttl", "compaction.twcs.time_window"):
        if key in (options or {}):
            if parse_interval_ms(str(options[key])) <= 0:
                raise InvalidArgumentError(
                    f"{key} must be positive: {options[key]!r}")


def region_options_from_table(options: dict | None):
    """Table options -> RegionOptions. The WITH(...) keys of the JAX
    package (ttl, append_mode, merge_mode, compaction.twcs.time_window,
    compaction.twcs.trigger_file_num / max_active_window_files) and, for
    the port's keyword form, RegionOptions field names (ttl_ms,
    compaction_window_ms, compaction_trigger_files, memtable_window_ms,
    flush_rows, wal_sync, ...). Other keys are ignored, as the JAX
    package ignores them; non-positive intervals leave the default."""
    from greptimedb_tpu_torch.sql.parser import parse_interval_ms
    from greptimedb_tpu_torch.storage.region import RegionOptions

    options = options or {}
    opts = RegionOptions()
    for k, v in options.items():
        if "." not in k and hasattr(opts, k) and k not in (
                "append_mode", "merge_mode"):
            setattr(opts, k, v)
    if "ttl" in options:
        ms = parse_interval_ms(str(options["ttl"]))
        if ms > 0:
            opts.ttl_ms = ms
    if append_mode_enabled(options):
        opts.append_mode = True
    if "merge_mode" in options:
        opts.merge_mode = str(options["merge_mode"])
    if "compaction.twcs.time_window" in options:
        ms = parse_interval_ms(str(options["compaction.twcs.time_window"]))
        if ms > 0:
            opts.compaction_window_ms = ms
    for key in ("compaction.twcs.trigger_file_num",
                "compaction.twcs.max_active_window_files"):
        if key in options:
            try:
                n = int(str(options[key]))
            except ValueError:
                continue
            if n > 0:
                opts.compaction_trigger_files = n
    return opts


class _BrokenTable:
    """A table whose open failed: its metadata stays, every data access
    raises the open error."""

    def __init__(self, info, error: Exception):
        self.info = info
        self._error = error

    @property
    def name(self):
        return self.info.name

    @property
    def schema(self):
        return self.info.schema

    def __getattr__(self, item):
        raise IllegalStateError(
            f"table {self.info.name!r} failed to open: {self._error}")


class CatalogManager:
    def __init__(self, engine=None):
        self.engine = engine
        self._databases: dict[str, dict[str, object]] = {DEFAULT_SCHEMA: {}}
        self._views: dict[str, dict[str, str]] = {}  # db -> name -> SQL text
        self._lock = threading.RLock()
        self._next_table_id = 1024
        if engine is not None:
            self._load()
            self._persist()

    # ------------------------------------------------------------------
    # persistence (engine-backed catalogs)
    # ------------------------------------------------------------------
    def _load(self):
        store = self.engine.store
        if not store.exists(CATALOG_PATH):
            return
        doc = json.loads(store.read(CATALOG_PATH))
        self._next_table_id = doc.get("next_table_id", 1024)
        self._views = {db: dict(views)
                       for db, views in doc.get("views", {}).items()}
        all_infos = {db: [TableInfo.from_json(t) for t in tables]
                     for db, tables in doc.get("databases", {}).items()}
        # every region in one batch on the engine's recovery pool; the
        # per-table opens below then hit the registry
        batch = [self._region_meta(i) for infos in all_infos.values()
                 for i in infos if i.engine == "mito"]
        if batch:
            try:
                self.engine.open_regions(batch)
            except Exception as e:  # noqa: BLE001 - per-table isolation
                _log.warning("batch region open failed (isolating per "
                             "table): %s", e)
        for db_name, infos in all_infos.items():
            db = self._databases.setdefault(db_name, {})
            # physical tables first: logical metric tables resolve theirs
            for info in sorted(infos, key=lambda i: i.engine == "metric"):
                try:
                    db[info.name] = self._open_table(info)
                except Exception as e:  # noqa: BLE001 - startup isolation
                    _log.warning("table %s failed to open: %s", info.name, e)
                    db[info.name] = _BrokenTable(info, e)

    def _persist(self):
        if self.engine is None:
            return
        doc = {"next_table_id": self._next_table_id,
               "databases": {db: [t.info.to_json() for t in tables.values()]
                             for db, tables in self._databases.items()},
               "views": {db: dict(v) for db, v in self._views.items() if v}}
        self.engine.store.write(CATALOG_PATH, json.dumps(doc).encode())

    def _region_meta(self, info: TableInfo):
        from greptimedb_tpu_torch.storage.region import RegionMetadata

        s = info.schema
        return RegionMetadata(
            region_id=info.region_id, table=info.name,
            tag_names=s.tag_names, field_names=s.field_names,
            ts_name=s.ts_name,
            options=region_options_from_table(info.options),
            fulltext_fields=[c.name for c in s.field_columns
                             if getattr(c, "fulltext", False)])

    def _open_table(self, info: TableInfo):
        from greptimedb_tpu_torch.catalog.table import Table

        if info.engine == "metric":
            return self._open_metric_table(info)
        if info.engine == "file":
            raise UnsupportedError(
                "the file engine (CREATE EXTERNAL TABLE) is not ported yet "
                "(ROADMAP A2's tail)")
        region = self.engine.open_region(self._region_meta(info))
        return Table(info.name, info=info, region=region)

    def _open_metric_table(self, info: TableInfo):
        """A logical metric-engine table over the shared physical table
        (metric_engine.py)."""
        from greptimedb_tpu_torch import metric_engine as ME

        physical = ME.ensure_physical_table(self, info.database)
        ME.widen_physical_for(self, info.database, physical, info.schema)
        return ME.LogicalTable(info, physical)

    # ------------------------------------------------------------------
    # databases
    # ------------------------------------------------------------------
    def create_database(self, name: str, *, if_not_exists: bool = False):
        with self._lock:
            if name in self._databases:
                if if_not_exists:
                    return
                raise InvalidArgumentError(f"database already exists: {name}")
            self._databases[name] = {}
            self._persist()

    def drop_database(self, name: str, *, if_exists: bool = False):
        with self._lock:
            if name not in self._databases:
                if if_exists:
                    return
                raise DatabaseNotFoundError(f"database not found: {name}")
            if name == DEFAULT_SCHEMA:
                raise InvalidArgumentError("cannot drop the public database")
            for tname in list(self._databases[name]):
                self.drop_table(name, tname)
            del self._databases[name]
            self._views.pop(name, None)
            self._persist()

    # ------------------------------------------------------------------
    # views (name -> stored SQL text; query/relational re-plans the text
    # on every query)
    # ------------------------------------------------------------------
    def create_view(self, database: str, name: str, sql_text: str,
                    *, or_replace: bool = False):
        with self._lock:
            self._db(database)  # the database must exist
            if name in self._databases.get(database, {}):
                raise InvalidArgumentError(
                    f"a table named {name!r} already exists")
            views = self._views.setdefault(database, {})
            if name in views and not or_replace:
                raise InvalidArgumentError(f"view already exists: {name}")
            views[name] = sql_text
            self._persist()

    def drop_view(self, database: str, name: str, *, if_exists: bool = False):
        with self._lock:
            views = self._views.get(database, {})
            if name not in views:
                if if_exists:
                    return
                raise TableNotFoundError(f"view not found: {name}")
            del views[name]
            self._persist()

    def maybe_view(self, database: str, name: str) -> str | None:
        with self._lock:
            return self._views.get(database, {}).get(name)

    def view_names(self, database: str) -> list[str]:
        with self._lock:
            return sorted(self._views.get(database, {}))

    def database_names(self) -> list[str]:
        with self._lock:
            return sorted(self._databases)

    def has_database(self, name: str) -> bool:
        with self._lock:
            return name in self._databases

    # ------------------------------------------------------------------
    # tables
    # ------------------------------------------------------------------
    def register(self, table, database: str | None = None):
        """Add `table` under `database` (default: the table's own) and
        return it; a second table of the same name replaces the first."""
        db = database if database is not None else table.database
        with self._lock:
            self._databases.setdefault(db, {})[table.name] = table
        return table

    def create_table(self, database: str, name: str, schema: Schema, *,
                     engine: str = "mito", options: dict | None = None,
                     num_regions: int = 1, if_not_exists: bool = False,
                     partition=None):
        """A durable table over one new engine region. `options`: table
        options (region_options_from_table)."""
        if num_regions > 1 or partition:
            raise UnsupportedError(
                "tables of more than one region (num_regions, PARTITION "
                "ON) are not ported yet (ROADMAP A10)")
        if engine == "file":
            raise UnsupportedError(
                "the file engine (CREATE EXTERNAL TABLE) is not ported yet "
                "(ROADMAP A2's tail)")
        if self.engine is None:
            raise UnsupportedError(
                "create_table needs a catalog over a storage engine "
                "(Standalone); this catalog holds registered tables only")
        validate_table_options(options)
        with self._lock:
            db = self._db(database)
            if name in self._views.get(database, {}):
                raise InvalidArgumentError(
                    f"a view named {name!r} already exists")
            if name in db:
                if if_not_exists:
                    return db[name]
                raise TableAlreadyExistsError(f"table already exists: {name}")
            schema.time_index  # raises unless a TIME INDEX exists
            info = TableInfo(
                table_id=self._next_table_id, name=name, database=database,
                schema=schema, engine=engine, options=dict(options or {}),
                created_ms=int(time.time() * 1000))
            self._next_table_id += 1
            table = self._open_table(info)
            db[name] = table
            self._persist()
            return table

    def drop_table(self, database: str, name: str, *,
                   if_exists: bool = False):
        with self._lock:
            db = self._db(database)
            table = db.pop(name, None)
            if table is None:
                if if_exists:
                    return
                raise TableNotFoundError(f"table not found: {name}")
            if self.engine is not None and table.info.engine == "mito":
                self.engine.drop_region(table.info.region_id)
            self._persist()
        # release the table's device-resident PromQL grids
        from greptimedb_tpu_torch.promql import fast as _promql_fast

        _promql_fast.drop_table_entries(table)
        self._purge_result_caches(table)

    def _purge_result_caches(self, table):
        """Drop a dropped table's cached results: a recreated table can
        reuse the table id and happen to match versions. (Session buffers
        are keyed per grid entry and released by the grid caches when
        they drop the entry.)"""
        rc = getattr(self, "result_cache", None)
        if rc is not None:
            rc.purge_table(table.info.database, table.info.table_id)

    def table(self, database: str, name: str):
        with self._lock:
            db = self._db(database)
            try:
                return db[name]
            except KeyError:
                raise TableNotFoundError(
                    f"table not found: {database}.{name}") from None

    def maybe_table(self, database: str, name: str):
        with self._lock:
            return self._databases.get(database, {}).get(name)

    def table_names(self, database: str) -> list[str]:
        with self._lock:
            return sorted(self._db(database))

    def all_tables(self) -> list:
        with self._lock:
            return [t for db in self._databases.values()
                    for t in db.values()]

    # ------------------------------------------------------------------
    # alter
    # ------------------------------------------------------------------
    def alter_add_column(self, database: str, name: str, col: ColumnSchema,
                         *, if_not_exists: bool = False):
        """`if_not_exists`: the protocols' auto-widen mode, where a column
        of the same semantic type is a no-op whatever its data type (the
        first writer's type wins). SQL ALTER stays strict."""
        with self._lock:
            table = self.table(database, name)
            if col.semantic_type == SemanticType.TIMESTAMP:
                raise InvalidArgumentError("cannot add a TIME INDEX column")
            existing = table.info.schema.maybe_column(col.name)
            if existing is not None:
                if existing.semantic_type != col.semantic_type:
                    raise InvalidArgumentError(
                        f"column {col.name!r} already exists as a "
                        f"{existing.semantic_type.name} column")
                if if_not_exists or existing.data_type == col.data_type:
                    return
                raise InvalidArgumentError(
                    f"column {col.name!r} already exists as "
                    f"{existing.data_type.name}")
            if table.info.engine == "metric":
                # the column lands on the shared physical table first, so
                # a collision there leaves the logical table unchanged
                from greptimedb_tpu_torch import metric_engine as ME

                physical = ME.ensure_physical_table(self, database)
                candidate = table.info.schema.with_column(col)
                ME.widen_physical_for(self, database, physical, candidate)
                table.info.schema = candidate
            else:
                table.alter_add_column(col)
            self._persist()

    def alter_drop_column(self, database: str, name: str, col_name: str):
        with self._lock:
            table = self.table(database, name)
            col = table.info.schema.column(col_name)
            if not col.is_field:
                raise InvalidArgumentError(
                    "only FIELD columns can be dropped")
            if table.info.engine == "metric":
                # logical only: the physical column is shared
                table.info.schema = table.info.schema.without_column(
                    col_name)
            else:
                table.alter_drop_column(col_name)
            self._persist()

    def rename_table(self, database: str, old: str, new: str):
        with self._lock:
            db = self._db(database)
            if new in db:
                raise TableAlreadyExistsError(f"table already exists: {new}")
            table = db.pop(old, None)
            if table is None:
                raise TableNotFoundError(f"table not found: {old}")
            table.info.name = new
            db[new] = table
            self._persist()

    # ------------------------------------------------------------------
    def _db(self, database: str) -> dict:
        try:
            return self._databases[database]
        except KeyError:
            raise DatabaseNotFoundError(
                f"database not found: {database}") from None
