"""A single-region table: schema, writes, compaction and scans.

A Table carries its TableInfo (catalog/manager.py): name, database, table
id, engine, options and a typed Schema (datatypes/schema.py: semantic
type, data type, nullability and default of every column), as the JAX
package's Table does. Two ways to build one:

- `Table(name, ts_name=, tag_names=, fields=)` with `fields` names
  (float64) or {name: numpy dtype}: millisecond timestamps, string tags;
- `Table(name, info=)` with the catalog's TableInfo and its full Schema
  (durable tables, `CREATE TABLE` among them).

`write` keeps the JAX package's signature (tag columns by name, int64 ms
timestamps, fields by name); string, boolean and integer fields go through
the same region as float ones. A Table built with `region=` (an
engine-opened storage/region.Region: WAL, SSTs, manifest) is durable; one
built without keeps its rows in an in-memory region (Region.in_memory).
`alter_add_column`/`alter_drop_column` widen or narrow the region as the
JAX catalog's ALTER does. The port's table has one region: multi-region
routing (`num_regions`, `PARTITION ON`) waits for ROADMAP A10.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from greptimedb_tpu_torch.datatypes.schema import (
    ColumnSchema,
    Schema,
    SemanticType,
)
from greptimedb_tpu_torch.storage.memtable import (
    OP_DELETE,
    OP_PUT,
    ColumnarRows,
)
from greptimedb_tpu_torch.storage.region import DEFAULT_WINDOW_MS, Region
from greptimedb_tpu_torch.storage.series import SeriesRegistry


@dataclass
class TableScanData:
    rows: ColumnarRows | None
    registry: SeriesRegistry
    field_names: list[str]

    @property
    def num_rows(self) -> int:
        return 0 if self.rows is None else len(self.rows)


class Table:
    def __init__(self, name: str, *, ts_name: str | None = None,
                 tag_names: list[str] = (), fields=(), info=None,
                 window_ms: int = DEFAULT_WINDOW_MS,
                 database: str = "public", region: Region | None = None):
        """`fields`: field names (float64) or {name: numpy dtype}, with
        `ts_name` and `tag_names`; or the catalog's `info` (a TableInfo).
        `region`: an engine-opened region (default: in memory, its
        compaction window `window_ms`)."""
        from greptimedb_tpu_torch.catalog.manager import TableInfo

        if info is None:
            if not isinstance(fields, dict):
                fields = {f: np.float64 for f in fields}
            info = TableInfo(table_id=0, name=name, database=database,
                             schema=Schema.of(ts_name, list(tag_names),
                                              fields))
        self.info = info
        self.region = region if region is not None else Region.in_memory(
            info.schema.tag_names, info.schema.field_names,
            window_ms=window_ms, table=name)

    @property
    def name(self) -> str:
        return self.info.name

    @property
    def database(self) -> str:
        return self.info.database

    @property
    def schema(self) -> Schema:
        return self.info.schema

    @property
    def regions(self) -> list[Region]:
        return [self.region]

    @property
    def tag_names(self) -> list[str]:
        return self.schema.tag_names

    @property
    def field_names(self) -> list[str]:
        return self.schema.field_names

    @property
    def ts_name(self) -> str:
        return self.schema.ts_name

    def write(self, tag_columns: dict[str, np.ndarray], ts: np.ndarray,
              fields: dict[str, np.ndarray], *,
              field_valid: dict[str, np.ndarray] | None = None,
              op: int = OP_PUT) -> int:
        """Append one run of rows; returns rows written. A put fills every
        field it leaves out with nulls of the field's type."""
        n = len(ts)
        if n == 0:
            return 0
        dtypes = self.schema.field_dtypes
        fields = {k: np.asarray(v, dtypes[k]) for k, v in fields.items()}
        if op == OP_PUT and len(fields) < len(dtypes):
            field_valid = dict(field_valid) if field_valid else {}
            for k, dt in dtypes.items():
                if k not in fields:
                    fields[k] = (np.full(n, "", object) if dt == object
                                 else np.zeros(n, dt))
                    field_valid[k] = np.zeros(n, bool)
        self.region.write(tag_columns, np.asarray(ts, np.int64), fields,
                          field_valid=field_valid, op=op)
        return n

    def delete(self, tag_columns: dict[str, np.ndarray], ts: np.ndarray) -> int:
        return self.write(tag_columns, ts, {}, op=OP_DELETE)

    def compact(self, **kwargs):
        """Compact on the card (see Region.compact for the options and the
        result of each path)."""
        return self.region.compact(**kwargs)

    def flush(self):
        """Persist the memtable as an SST (a durable table; no-op in
        memory)."""
        return self.region.flush()

    def truncate(self):
        self.region.truncate()

    # ------------------------------------------------------------------
    # ALTER (the JAX catalog's region-level half)
    # ------------------------------------------------------------------
    def alter_add_column(self, col: ColumnSchema):
        """Add a tag (existing series read "") or a field (existing rows
        read null) to the schema and the region."""
        region = self.region
        self.info.schema = self.schema.with_column(col)
        with region._lock:
            if col.semantic_type == SemanticType.TAG:
                region.series.add_tag(col.name)
                if col.name not in region.meta.tag_names:
                    region.meta.tag_names.append(col.name)
                return
            if col.name not in region.meta.field_names:
                region.meta.field_names.append(col.name)
                region.memtable.field_names.append(col.name)
        region.invalidate_scan_cache()

    def alter_drop_column(self, col_name: str):
        """Drop a field from the schema and the region."""
        region = self.region
        self.info.schema = self.schema.without_column(col_name)
        with region._lock:
            if col_name in region.meta.field_names:
                region.meta.field_names.remove(col_name)
            if col_name in region.memtable.field_names:
                region.memtable.field_names.remove(col_name)
        region.invalidate_scan_cache()

    def scan(self, field_names: list[str] | None = None, *,
             ts_min: int | None = None, ts_max: int | None = None,
             matchers: list | None = None,
             fulltext: list | None = None) -> TableScanData:
        """Merged rows of `field_names` (default: every field) with ts in
        [ts_min, ts_max], of the series every tag matcher (tag, op, value)
        accepts; rows sorted by (sid, ts). `fulltext` (column, required
        terms) pairs let the SST reads skip row groups."""
        names = field_names if field_names is not None else self.field_names
        from greptimedb_tpu_torch import cancellation

        # a killed statement stops here (the JAX package checks once a
        # region; a port table has one)
        cancellation.checkpoint()
        region = self.region
        sids = None
        if matchers:
            sids = region.match_sids(matchers)
            if len(sids) == 0:
                return TableScanData(None, region.series, names)
        rows = region.scan(names, ts_min=ts_min, ts_max=ts_max, sids=sids,
                           fulltext=fulltext)
        return TableScanData(rows, region.series, names)

    def data_version(self) -> tuple:
        """Logical-data version; device grid caches compare it to decide
        reuse."""
        return (self.region.data_version, tuple(self.field_names),
                tuple(self.tag_names))

    def physical_version(self) -> tuple:
        """data_version with every region's physical version and all the
        column names: it also moves on a flush, a compaction and any
        schema change. The result cache (query/result_cache.py) keys on
        it."""
        return (tuple(r.physical_version for r in self.regions),
                tuple(self.schema.column_names), tuple(self.tag_names))

    def row_count(self) -> int:
        """Rows held (before dedup of pending runs)."""
        return self.region.rows
