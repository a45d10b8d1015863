"""Table schemas with semantic column roles (the JAX package's
datatypes/schema.py without its pyarrow conversions).

A column is a TAG (dictionary-encoded on the host, a series id on the
device), a FIELD (a dense column) or the TIMESTAMP (the TIME INDEX, the
time axis of every device grid). `Schema` also answers the names the
query layers read (`ts_name`, `tag_names`, `field_names`, `field_dtypes`).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from greptimedb_tpu_torch.datatypes.types import ConcreteDataType, TypeId
from greptimedb_tpu_torch.errors import (
    ColumnNotFoundError,
    InvalidArgumentError,
)


class SemanticType(enum.IntEnum):
    TAG = 0
    FIELD = 1
    TIMESTAMP = 2


@dataclass
class ColumnSchema:
    name: str
    data_type: ConcreteDataType
    semantic_type: SemanticType = SemanticType.FIELD
    nullable: bool = True
    default: Any = None
    # fulltext-index flag, mirroring upstream's fulltext column option
    fulltext: bool = False
    # inverted-index flag for tag pruning
    inverted_index: bool = False

    @property
    def is_tag(self) -> bool:
        return self.semantic_type == SemanticType.TAG

    @property
    def is_field(self) -> bool:
        return self.semantic_type == SemanticType.FIELD

    @property
    def is_time_index(self) -> bool:
        return self.semantic_type == SemanticType.TIMESTAMP


@dataclass
class Schema:
    """An ordered set of columns with at most one TIME INDEX."""

    columns: list[ColumnSchema]
    version: int = 0
    _index: dict[str, int] = field(default_factory=dict, repr=False)

    def __post_init__(self):
        self._index = {c.name: i for i, c in enumerate(self.columns)}
        if len(self._index) != len(self.columns):
            raise InvalidArgumentError("duplicate column names in schema")
        ts_cols = [c for c in self.columns if c.is_time_index]
        if len(ts_cols) > 1:
            raise InvalidArgumentError(
                "schema must have at most one TIME INDEX column")

    @staticmethod
    def of(ts_name: str, tag_names: list[str], fields: dict) -> "Schema":
        """A schema from names, in the order time index, tags, fields
        (what SELECT * expands to): `fields` maps a field name to its
        numpy dtype; the time index is a millisecond timestamp, tags are
        strings."""
        cols = [ColumnSchema(ts_name,
                             ConcreteDataType.timestamp_millisecond(),
                             SemanticType.TIMESTAMP, nullable=False)]
        cols += [ColumnSchema(t, ConcreteDataType.string(), SemanticType.TAG,
                              nullable=False) for t in tag_names]
        for k, dt in fields.items():
            dt = np.dtype(dt)
            cols.append(ColumnSchema(
                k, ConcreteDataType.string() if dt == object
                else ConcreteDataType(TypeId(dt.name))))
        return Schema(cols)

    # ---- lookups ------------------------------------------------------
    def __len__(self) -> int:
        return len(self.columns)

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def column(self, name: str) -> ColumnSchema:
        try:
            return self.columns[self._index[name]]
        except KeyError:
            raise ColumnNotFoundError(f"column not found: {name}") from None

    def maybe_column(self, name: str) -> ColumnSchema | None:
        i = self._index.get(name)
        return None if i is None else self.columns[i]

    @property
    def column_names(self) -> list[str]:
        return [c.name for c in self.columns]

    @property
    def time_index(self) -> ColumnSchema:
        for c in self.columns:
            if c.is_time_index:
                return c
        raise InvalidArgumentError("schema has no TIME INDEX column")

    @property
    def tag_columns(self) -> list[ColumnSchema]:
        return [c for c in self.columns if c.is_tag]

    @property
    def field_columns(self) -> list[ColumnSchema]:
        return [c for c in self.columns if c.is_field]

    # ---- the names the query layers read ------------------------------
    @property
    def ts_name(self) -> str:
        return self.time_index.name

    @property
    def tag_names(self) -> list[str]:
        return [c.name for c in self.tag_columns]

    @property
    def field_names(self) -> list[str]:
        return [c.name for c in self.field_columns]

    @property
    def field_dtypes(self) -> dict[str, np.dtype]:
        """Field name -> the numpy dtype its values are stored as."""
        return {c.name: c.data_type.to_numpy() for c in self.field_columns}

    # ---- derivations ----------------------------------------------------
    def with_column(self, col: ColumnSchema) -> "Schema":
        return Schema(self.columns + [col], version=self.version + 1)

    def without_column(self, name: str) -> "Schema":
        self.column(name)  # raise if missing
        return Schema(
            [c for c in self.columns if c.name != name],
            version=self.version + 1)
