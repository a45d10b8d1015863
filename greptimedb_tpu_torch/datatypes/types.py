"""Column type system (a copy of the JAX package's datatypes/types.py
without its Arrow conversions: the card machine has no pyarrow).

GreptimeDB's `ConcreteDataType` (src/datatypes/src/data_type.rs upstream):
the types the SQL parser and AST name, with their numpy dtypes. Numerics
and timestamps become device tensors; strings live on the host as
dictionary codes.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np


class TypeId(enum.Enum):
    BOOL = "bool"
    INT8 = "int8"
    INT16 = "int16"
    INT32 = "int32"
    INT64 = "int64"
    UINT8 = "uint8"
    UINT16 = "uint16"
    UINT32 = "uint32"
    UINT64 = "uint64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    STRING = "string"
    BINARY = "binary"
    # timestamps are int64 with a unit; millisecond is the canonical TIME INDEX
    # unit, like the reference's TimestampMillisecond default.
    TIMESTAMP_SECOND = "timestamp_s"
    TIMESTAMP_MILLISECOND = "timestamp_ms"
    TIMESTAMP_MICROSECOND = "timestamp_us"
    TIMESTAMP_NANOSECOND = "timestamp_ns"
    DATE = "date"
    JSON = "json"
    # INTERVAL: a duration, stored as int64 milliseconds (the reference
    # carries IntervalMonthDayNano, src/common/time/src/interval.rs; the
    # fixed-ms form covers the arithmetic/ordering surface this engine
    # computes with)
    INTERVAL = "interval"
    # Decimal128 (reference: src/common/decimal/): exact (precision,
    # scale) at the schema/wire/Parquet boundary; the in-memory and
    # on-device representation is float64 (the TPU computes in floats —
    # values round-trip exactly for precision <= 15)
    DECIMAL = "decimal"


_TS_UNITS = {
    TypeId.TIMESTAMP_SECOND: "s",
    TypeId.TIMESTAMP_MILLISECOND: "ms",
    TypeId.TIMESTAMP_MICROSECOND: "us",
    TypeId.TIMESTAMP_NANOSECOND: "ns",
}

_TS_PER_SECOND = {"s": 1, "ms": 1_000, "us": 1_000_000, "ns": 1_000_000_000}


@dataclass(frozen=True)
class ConcreteDataType:
    id: TypeId
    # decimal parameters (None for every other type)
    precision: int | None = None
    scale: int | None = None

    # ---- constructors -------------------------------------------------
    @staticmethod
    def bool_() -> "ConcreteDataType":
        return ConcreteDataType(TypeId.BOOL)

    @staticmethod
    def int8() -> "ConcreteDataType":
        return ConcreteDataType(TypeId.INT8)

    @staticmethod
    def int16() -> "ConcreteDataType":
        return ConcreteDataType(TypeId.INT16)

    @staticmethod
    def int32() -> "ConcreteDataType":
        return ConcreteDataType(TypeId.INT32)

    @staticmethod
    def int64() -> "ConcreteDataType":
        return ConcreteDataType(TypeId.INT64)

    @staticmethod
    def uint8() -> "ConcreteDataType":
        return ConcreteDataType(TypeId.UINT8)

    @staticmethod
    def uint16() -> "ConcreteDataType":
        return ConcreteDataType(TypeId.UINT16)

    @staticmethod
    def uint32() -> "ConcreteDataType":
        return ConcreteDataType(TypeId.UINT32)

    @staticmethod
    def uint64() -> "ConcreteDataType":
        return ConcreteDataType(TypeId.UINT64)

    @staticmethod
    def float32() -> "ConcreteDataType":
        return ConcreteDataType(TypeId.FLOAT32)

    @staticmethod
    def float64() -> "ConcreteDataType":
        return ConcreteDataType(TypeId.FLOAT64)

    @staticmethod
    def string() -> "ConcreteDataType":
        return ConcreteDataType(TypeId.STRING)

    @staticmethod
    def binary() -> "ConcreteDataType":
        return ConcreteDataType(TypeId.BINARY)

    @staticmethod
    def json() -> "ConcreteDataType":
        return ConcreteDataType(TypeId.JSON)

    @staticmethod
    def timestamp_millisecond() -> "ConcreteDataType":
        return ConcreteDataType(TypeId.TIMESTAMP_MILLISECOND)

    @staticmethod
    def timestamp_second() -> "ConcreteDataType":
        return ConcreteDataType(TypeId.TIMESTAMP_SECOND)

    @staticmethod
    def timestamp_microsecond() -> "ConcreteDataType":
        return ConcreteDataType(TypeId.TIMESTAMP_MICROSECOND)

    @staticmethod
    def timestamp_nanosecond() -> "ConcreteDataType":
        return ConcreteDataType(TypeId.TIMESTAMP_NANOSECOND)

    @staticmethod
    def date() -> "ConcreteDataType":
        return ConcreteDataType(TypeId.DATE)

    @staticmethod
    def interval() -> "ConcreteDataType":
        return ConcreteDataType(TypeId.INTERVAL)

    def is_interval(self) -> bool:
        return self.id == TypeId.INTERVAL

    @staticmethod
    def decimal128(precision: int = 38, scale: int = 10
                   ) -> "ConcreteDataType":
        if not (1 <= precision <= 38):
            raise ValueError(f"decimal precision {precision} out of [1,38]")
        if not (0 <= scale <= precision):
            raise ValueError(
                f"decimal scale {scale} out of [0,{precision}]"
            )
        return ConcreteDataType(TypeId.DECIMAL, precision, scale)

    def is_decimal(self) -> bool:
        return self.id == TypeId.DECIMAL

    # ---- predicates ---------------------------------------------------
    def is_timestamp(self) -> bool:
        return self.id in _TS_UNITS

    def is_string(self) -> bool:
        return self.id in (TypeId.STRING, TypeId.JSON)

    def is_numeric(self) -> bool:
        return self.id in (
            TypeId.INT8, TypeId.INT16, TypeId.INT32, TypeId.INT64,
            TypeId.UINT8, TypeId.UINT16, TypeId.UINT32, TypeId.UINT64,
            TypeId.FLOAT32, TypeId.FLOAT64, TypeId.DECIMAL,
        )

    def is_float(self) -> bool:
        # decimal computes as float64 in this engine (see TypeId.DECIMAL)
        return self.id in (TypeId.FLOAT32, TypeId.FLOAT64, TypeId.DECIMAL)

    def is_integer(self) -> bool:
        return self.is_numeric() and not self.is_float()

    def is_signed(self) -> bool:
        return self.id in (
            TypeId.INT8, TypeId.INT16, TypeId.INT32, TypeId.INT64,
            TypeId.FLOAT32, TypeId.FLOAT64, TypeId.DECIMAL,
        )

    @property
    def timestamp_unit(self) -> str:
        return _TS_UNITS[self.id]

    @property
    def ticks_per_second(self) -> int:
        return _TS_PER_SECOND[_TS_UNITS[self.id]]

    # ---- conversions --------------------------------------------------
    def to_numpy(self) -> np.dtype:
        t = self.id
        if t == TypeId.BOOL:
            return np.dtype(np.bool_)
        if t in (TypeId.STRING, TypeId.JSON, TypeId.BINARY):
            return np.dtype(object)
        if self.is_timestamp() or t in (TypeId.DATE, TypeId.INTERVAL):
            return np.dtype(np.int64)
        if t == TypeId.DECIMAL:
            return np.dtype(np.float64)
        return np.dtype(t.value)

    @property
    def name(self) -> str:
        if self.id == TypeId.DECIMAL:
            return f"decimal({self.precision},{self.scale})"
        return self.id.value

    @staticmethod
    def from_name(name: str) -> "ConcreteDataType":
        name = name.strip().lower()
        aliases = {
            "boolean": TypeId.BOOL,
            "tinyint": TypeId.INT8,
            "smallint": TypeId.INT16,
            "int": TypeId.INT32,
            "integer": TypeId.INT32,
            "bigint": TypeId.INT64,
            "tinyint unsigned": TypeId.UINT8,
            "smallint unsigned": TypeId.UINT16,
            "int unsigned": TypeId.UINT32,
            "bigint unsigned": TypeId.UINT64,
            "float": TypeId.FLOAT32,
            "real": TypeId.FLOAT32,
            "double": TypeId.FLOAT64,
            "varchar": TypeId.STRING,
            "text": TypeId.STRING,
            "varbinary": TypeId.BINARY,
            "timestamp": TypeId.TIMESTAMP_MILLISECOND,
            "timestamp(0)": TypeId.TIMESTAMP_SECOND,
            "timestamp(3)": TypeId.TIMESTAMP_MILLISECOND,
            "timestamp(6)": TypeId.TIMESTAMP_MICROSECOND,
            "timestamp(9)": TypeId.TIMESTAMP_NANOSECOND,
            "timestamp_s": TypeId.TIMESTAMP_SECOND,
            "timestamp_ms": TypeId.TIMESTAMP_MILLISECOND,
            "timestamp_us": TypeId.TIMESTAMP_MICROSECOND,
            "timestamp_ns": TypeId.TIMESTAMP_NANOSECOND,
        }
        if name in aliases:
            return ConcreteDataType(aliases[name])
        import re as _re

        m = _re.fullmatch(
            r"(?:decimal|numeric)\s*(?:\(\s*(\d+)\s*(?:,\s*(\d+)\s*)?\))?",
            name,
        )
        if m:
            precision = int(m.group(1)) if m.group(1) else 38
            scale = int(m.group(2)) if m.group(2) else (
                10 if m.group(1) is None else 0
            )
            return ConcreteDataType.decimal128(precision, scale)
        return ConcreteDataType(TypeId(name))
