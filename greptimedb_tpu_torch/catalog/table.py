"""A minimal single-region table: schema, writes, compaction and scans.

`write` keeps the JAX package's signature (tag columns by name, int64 ms
timestamps, fields by name). Everything lives in one in-memory Region
(storage/region.py); multi-region routing, SSTs and the WAL are later
slices.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from greptimedb_tpu_torch.index import tag_index
from greptimedb_tpu_torch.storage.memtable import (
    OP_DELETE,
    OP_PUT,
    ColumnarRows,
)
from greptimedb_tpu_torch.storage.region import DEFAULT_WINDOW_MS, Region
from greptimedb_tpu_torch.storage.series import SeriesRegistry


@dataclass
class TableSchema:
    ts_name: str
    tag_names: list[str]
    field_dtypes: dict[str, np.dtype]   # field name -> numpy dtype

    @property
    def field_names(self) -> list[str]:
        return list(self.field_dtypes)

    @property
    def column_names(self) -> list[str]:
        """Time index, tags, then fields (what SELECT * expands to)."""
        return [self.ts_name, *self.tag_names, *self.field_names]


@dataclass
class TableScanData:
    rows: ColumnarRows | None
    registry: SeriesRegistry
    field_names: list[str]

    @property
    def num_rows(self) -> int:
        return 0 if self.rows is None else len(self.rows)


class Table:
    def __init__(self, name: str, *, ts_name: str, tag_names: list[str],
                 fields, window_ms: int = DEFAULT_WINDOW_MS,
                 database: str = "public"):
        """`fields`: field names (float64) or {name: numpy dtype}."""
        if not isinstance(fields, dict):
            fields = {f: np.float64 for f in fields}
        self.name = name
        self.database = database
        self.schema = TableSchema(
            ts_name, list(tag_names),
            {k: np.dtype(v) for k, v in fields.items()},
        )
        self.region = Region(self.schema.tag_names, self.schema.field_names,
                             window_ms=window_ms)

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
        """Append one run of rows; returns rows written."""
        n = len(ts)
        if n == 0:
            return 0
        fields = {k: np.asarray(v, self.schema.field_dtypes[k])
                  for k, v in fields.items()}
        self.region.write(tag_columns, np.asarray(ts, np.int64), fields,
                          field_valid=field_valid, op=op)
        return n

    def delete(self, tag_columns: dict[str, np.ndarray], ts: np.ndarray) -> int:
        return self.write(tag_columns, ts, {}, op=OP_DELETE)

    def compact(self, **kwargs) -> int:
        """Compact every window with pending runs on the card (see
        Region.compact for the options)."""
        return self.region.compact(**kwargs)

    def scan(self, field_names: list[str] | None = None, *,
             ts_min: int | None = None, ts_max: int | None = None,
             matchers: list | None = None) -> TableScanData:
        """Merged rows of `field_names` (default: every field) with ts in
        [ts_min, ts_max], of the series every tag matcher (tag, op, value)
        accepts; rows sorted by (sid, ts)."""
        names = field_names if field_names is not None else self.field_names
        region = self.region
        sids = None
        if matchers:
            sids = tag_index.match_sids(region.series, matchers)
            if len(sids) == 0:
                return TableScanData(None, region.series, names)
        rows = region.scan(names, ts_min=ts_min, ts_max=ts_max, sids=sids)
        return TableScanData(rows, region.series, names)

    def data_version(self) -> tuple:
        """Logical-data version; device grid caches compare it to decide
        reuse."""
        return (self.region.data_version, tuple(self.field_names),
                tuple(self.tag_names))

    def row_count(self) -> int:
        """Rows held (before dedup of pending runs)."""
        return self.region.rows
