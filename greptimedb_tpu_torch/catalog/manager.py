"""Catalog: database -> table name -> Table (the JAX package's
catalog/manager.py, for single-region tables).

Without an engine the catalog holds tables registered as built
(`register`), in memory. With a storage engine (storage/engine.TsdbEngine)
`create_table` opens each table over one engine region and the catalog
persists the table metadata as JSON (meta/catalog.json in the engine's
object store), so a fresh process reopens every table, WAL replay included
(`CatalogManager(engine)` loads them, opening their regions on the
engine's bounded recovery pool in one batch). Region ids pack (table_id,
region number) as the JAX package's do; multi-region tables wait for the
distributed roles.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field as dc_field

import numpy as np

from greptimedb_tpu_torch.errors import (
    TableAlreadyExistsError,
    TableNotFoundError,
)

CATALOG_PATH = "meta/catalog.json"
_REGION_SHIFT = 10


@dataclass
class TableInfo:
    table_id: int
    name: str
    database: str
    ts_name: str
    tag_names: list[str]
    fields: dict[str, str]            # field name -> numpy dtype string
    options: dict = dc_field(default_factory=dict)
    created_ms: int = 0

    @property
    def region_id(self) -> int:
        return self.table_id << _REGION_SHIFT

    def to_json(self) -> dict:
        return dict(self.__dict__)

    @staticmethod
    def from_json(d: dict) -> "TableInfo":
        return TableInfo(**d)


def region_options_from_table(options: dict | None):
    """Table options -> RegionOptions: ttl_ms, append_mode, merge_mode,
    compaction_window_ms, compaction_trigger_files, memtable_window_ms,
    flush_rows, wal_sync (the JAX package's WITH(...) surface, by the
    RegionOptions field names)."""
    from greptimedb_tpu_torch.storage.region import RegionOptions

    opts = RegionOptions()
    for k, v in (options or {}).items():
        if not hasattr(opts, k):
            raise ValueError(f"unknown table option {k!r}")
        setattr(opts, k, v)
    return opts


class CatalogManager:
    def __init__(self, engine=None):
        self.engine = engine
        self._databases: dict[str, dict[str, object]] = {}
        self._infos: dict[tuple[str, str], TableInfo] = {}
        self._lock = threading.RLock()
        self._next_table_id = 1024
        if engine is not None:
            self._load()

    # ------------------------------------------------------------------
    # persistence (engine-backed catalogs)
    # ------------------------------------------------------------------
    def _load(self):
        store = self.engine.store
        if not store.exists(CATALOG_PATH):
            return
        doc = json.loads(store.read(CATALOG_PATH))
        self._next_table_id = doc.get("next_table_id", 1024)
        infos = [TableInfo.from_json(t) for t in doc.get("tables", [])]
        # every region in one batch on the engine's recovery pool; the
        # per-table opens below then hit the registry
        self.engine.open_regions([self._region_meta(i) for i in infos])
        for info in infos:
            self._attach(info)

    def _persist(self):
        doc = {"next_table_id": self._next_table_id,
               "tables": [i.to_json() for i in self._infos.values()]}
        self.engine.store.write(CATALOG_PATH, json.dumps(doc).encode())

    def _region_meta(self, info: TableInfo):
        from greptimedb_tpu_torch.storage.region import RegionMetadata

        return RegionMetadata(
            region_id=info.region_id, table=info.name,
            tag_names=list(info.tag_names), field_names=list(info.fields),
            ts_name=info.ts_name,
            options=region_options_from_table(info.options))

    def _attach(self, info: TableInfo):
        from greptimedb_tpu_torch.catalog.table import Table

        region = self.engine.open_region(self._region_meta(info))
        table = Table(info.name, ts_name=info.ts_name,
                      tag_names=info.tag_names, database=info.database,
                      fields={k: np.dtype(v) for k, v in info.fields.items()},
                      region=region)
        self._databases.setdefault(info.database, {})[info.name] = table
        self._infos[(info.database, info.name)] = info
        return table

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

    def create_table(self, database: str, name: str, *, ts_name: str,
                     tag_names: list[str], fields,
                     options: dict | None = None,
                     if_not_exists: bool = False):
        """A durable table over one new engine region. `fields`: names
        (float64) or {name: numpy dtype}; `options`: RegionOptions fields
        (region_options_from_table)."""
        if self.engine is None:
            raise ValueError("create_table needs a catalog over an engine")
        if not isinstance(fields, dict):
            fields = {f: np.float64 for f in fields}
        region_options_from_table(options)       # validate before commit
        with self._lock:
            have = self._databases.get(database, {}).get(name)
            if have is not None:
                if if_not_exists:
                    return have
                raise TableAlreadyExistsError(
                    f"table already exists: {database}.{name}")
            info = TableInfo(
                table_id=self._next_table_id, name=name, database=database,
                ts_name=ts_name, tag_names=list(tag_names),
                fields={k: np.dtype(v).str for k, v in fields.items()},
                options=dict(options or {}),
                created_ms=int(time.time() * 1000))
            self._next_table_id += 1
            table = self._attach(info)
            self._persist()
            return table

    def drop_table(self, database: str, name: str, *,
                   if_exists: bool = False):
        with self._lock:
            table = self._databases.get(database, {}).pop(name, None)
            if table is None:
                if if_exists:
                    return
                raise TableNotFoundError(
                    f"table not found: {database}.{name}")
            info = self._infos.pop((database, name), None)
            if info is not None and self.engine is not None:
                self.engine.drop_region(info.region_id)
                self._persist()

    def table(self, database: str, name: str):
        with self._lock:
            try:
                return self._databases[database][name]
            except KeyError:
                raise TableNotFoundError(
                    f"table not found: {database}.{name}") from None

    def maybe_table(self, database: str, name: str):
        with self._lock:
            return self._databases.get(database, {}).get(name)

    def table_names(self, database: str) -> list[str]:
        with self._lock:
            return sorted(self._databases.get(database, {}))

    def all_tables(self) -> list:
        with self._lock:
            return [t for db in self._databases.values()
                    for t in db.values()]
