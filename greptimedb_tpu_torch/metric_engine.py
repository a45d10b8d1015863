"""Metric engine: many logical tables over one physical table (the JAX
package's metric_engine.py).

Prometheus remote write creates one small table per metric; they share
one physical table per database (`PHYSICAL_TABLE`), which carries a
`__table_id` TAG beside every label any logical table has. A logical
table is a thin view: writes add its table id, scans add a `__table_id`
matcher and expose the logical columns only. The physical table widens on
demand (`widen_physical_for`), and the Prometheus discovery APIs never
show it.
"""

from __future__ import annotations

import numpy as np

from greptimedb_tpu_torch.catalog.table import Table, TableScanData
from greptimedb_tpu_torch.datatypes.schema import (
    ColumnSchema,
    Schema,
    SemanticType,
)
from greptimedb_tpu_torch.datatypes.types import ConcreteDataType
from greptimedb_tpu_torch.errors import InvalidArgumentError
from greptimedb_tpu_torch.storage.memtable import OP_DELETE, OP_PUT

PHYSICAL_TABLE = "greptime_physical_table"
TABLE_ID_TAG = "__table_id"


def physical_schema() -> Schema:
    return Schema([
        ColumnSchema(TABLE_ID_TAG, ConcreteDataType.string(),
                     SemanticType.TAG, nullable=False),
        ColumnSchema("greptime_value", ConcreteDataType.float64(),
                     SemanticType.FIELD),
        ColumnSchema("greptime_timestamp",
                     ConcreteDataType.timestamp_millisecond(),
                     SemanticType.TIMESTAMP, nullable=False),
    ])


class LogicalTable(Table):
    """A logical metric table backed by the shared physical table. It has
    no region of its own (so no grid snapshot of its own either)."""

    def __init__(self, info, physical: Table):
        self.info = info
        self.physical = physical

    @property
    def regions(self):
        return self.physical.regions

    @property
    def _tid(self) -> str:
        return str(self.info.table_id)

    def write(self, tag_columns, ts, fields, *, field_valid=None,
              op=OP_PUT):
        tags = dict(tag_columns)
        tags[TABLE_ID_TAG] = np.full(len(ts), self._tid, object)
        return self.physical.write(tags, ts, fields,
                                   field_valid=field_valid, op=op)

    def scan(self, field_names=None, *, ts_min=None, ts_max=None,
             matchers=None, fulltext=None) -> TableScanData:
        m = list(matchers) if matchers else []
        m.append((TABLE_ID_TAG, "eq", self._tid))
        names = field_names if field_names is not None else self.field_names
        return self.physical.scan(names, ts_min=ts_min, ts_max=ts_max,
                                  matchers=m, fulltext=fulltext)

    def scoped_sids(self, region) -> np.ndarray:
        """This table's sids on the physical region: a posting lookup on
        the __table_id tag through the secondary index."""
        return region.match_sids([(TABLE_ID_TAG, "eq", self._tid)])

    def data_version(self) -> tuple:
        return (self.physical.region.data_version,
                tuple(self.schema.column_names), tuple(self.tag_names))

    def flush(self):
        self.physical.flush()

    def compact(self, **kwargs):
        return self.physical.compact(**kwargs)

    def truncate(self):
        """Tombstone this table's rows only."""
        data = self.scan()
        if data.rows is None or len(data.rows) == 0:
            return
        rows, reg = data.rows, data.registry
        uniq, inv = np.unique(rows.sid, return_inverse=True)
        codes = reg.codes_matrix()
        tags = {}
        for t in self.physical.tag_names:
            i = reg.tag_names.index(t)
            d = reg.dicts[i]
            vals = np.asarray([d.decode(int(c)) for c in codes[uniq, i]],
                              dtype=object)
            tags[t] = vals[inv]
        self.physical.write(tags, rows.ts, {}, op=OP_DELETE)

    def row_count(self) -> int:
        return self.scan().num_rows


def ensure_physical_table(catalog, db: str) -> Table:
    t = catalog.maybe_table(db, PHYSICAL_TABLE)
    if t is not None:
        return t
    return catalog.create_table(db, PHYSICAL_TABLE, physical_schema(),
                                engine="mito", if_not_exists=True)


def widen_physical_for(catalog, db: str, physical: Table,
                       logical_schema: Schema):
    """The physical table gains every tag or field the logical table needs;
    a name that exists there with another semantic type raises."""
    for c in logical_schema.columns:
        if c.is_time_index:
            continue
        existing = physical.schema.maybe_column(c.name)
        if existing is not None and existing.semantic_type != c.semantic_type:
            raise InvalidArgumentError(
                f"column {c.name!r} already exists on the physical metric "
                f"table as a {existing.semantic_type.name}; the logical "
                f"table wants a {c.semantic_type.name} — rename the "
                "label/field")
        if existing is None:
            catalog.alter_add_column(
                db, PHYSICAL_TABLE,
                ColumnSchema(c.name,
                             ConcreteDataType.string() if c.is_tag
                             else c.data_type, c.semantic_type),
                if_not_exists=True)
