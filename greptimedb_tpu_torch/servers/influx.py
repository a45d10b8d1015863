"""InfluxDB line-protocol ingest (the JAX package's servers/influx.py).

Each measurement becomes a table (tags -> PRIMARY KEY strings, fields ->
typed FIELD columns, ts -> TIME INDEX), created or widened on first sight.
`parse_payload` runs the port's native tokenizer (native/lineproto.c,
built at first use); `parse_payload(body, native=False)` runs the
pure-Python parser below, its plain version and the behavioral spec the C
code mirrors. A failed native build raises: there is no quiet switch to
the Python parser.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np

from greptimedb_tpu_torch.datatypes.schema import (
    ColumnSchema,
    Schema,
    SemanticType,
)
from greptimedb_tpu_torch.datatypes.types import ConcreteDataType
from greptimedb_tpu_torch.errors import InvalidArgumentError

# exact (numerator, denominator) ms conversion per precision: float
# scaling at epoch-scale ns values (~1.7e18) rounds the INPUT to
# float64's 2^8-ns granularity, flipping milliseconds and silently
# colliding adjacent rows into last-write-wins dedup
_PRECISION_MS = {"ns": (1, 1_000_000), "u": (1, 1_000), "us": (1, 1_000),
                 "ms": (1, 1), "s": (1_000, 1), "m": (60_000, 1),
                 "h": (3_600_000, 1)}


class LineProtocolError(InvalidArgumentError):
    pass


def _split_escaped(s: str, seps: set[str]):
    """Split on unescaped separator chars; yields (sep_char, token)."""
    out = []
    cur = []
    i = 0
    n = len(s)
    while i < n:
        c = s[i]
        if c == "\\" and i + 1 < n:
            cur.append(s[i + 1])
            i += 2
            continue
        if c in seps:
            out.append(("".join(cur), c))
            cur = []
            i += 1
            continue
        cur.append(c)
        i += 1
    out.append(("".join(cur), ""))
    return out


def parse_line(line: str):
    """One line -> (measurement, tags: dict, fields: dict, ts_raw or None).
    Field values are python bool/int/float/str."""
    # measurement+tags section ends at first unescaped space
    i = 0
    n = len(line)
    depth_quote = False
    sections = []
    cur = []
    while i < n:
        c = line[i]
        if c == "\\" and i + 1 < n:
            # escape pairs survive INSIDE quotes too: \" must not close
            # a string field value
            cur.append(c)
            cur.append(line[i + 1])
            i += 2
            continue
        if c == '"':
            depth_quote = not depth_quote
            cur.append(c)
            i += 1
            continue
        if c == " " and not depth_quote:
            sections.append("".join(cur))
            cur = []
            i += 1
            # collapse runs of spaces
            while i < n and line[i] == " ":
                i += 1
            continue
        cur.append(c)
        i += 1
    sections.append("".join(cur))
    sections = [s for s in sections if s != ""]
    if len(sections) < 2:
        raise LineProtocolError(f"invalid line: {line!r}")
    head, fields_s = sections[0], sections[1]
    ts_raw = sections[2] if len(sections) > 2 else None

    parts = _split_escaped(head, {","})
    measurement = parts[0][0]
    tags = {}
    for token, _ in parts[1:]:
        if not token:
            continue
        kv = token.split("=", 1)
        if len(kv) != 2:
            raise LineProtocolError(f"bad tag {token!r} in {line!r}")
        tags[kv[0]] = kv[1]

    fields = {}
    for token, _ in _split_field_pairs(fields_s):
        kv = token.split("=", 1)
        if len(kv) != 2:
            raise LineProtocolError(f"bad field {token!r} in {line!r}")
        fields[_unescape(kv[0])] = _parse_field_value(kv[1])
    if not fields:
        raise LineProtocolError(f"no fields in {line!r}")
    return measurement, tags, fields, ts_raw


def _split_field_pairs(s: str):
    out = []
    cur = []
    quoted = False
    i = 0
    n = len(s)
    while i < n:
        c = s[i]
        if c == "\\" and i + 1 < n:
            cur.append(c)
            cur.append(s[i + 1])
            i += 2
            continue
        if c == '"':
            quoted = not quoted
            cur.append(c)
            i += 1
            continue
        if c == "," and not quoted:
            out.append(("".join(cur), c))
            cur = []
            i += 1
            continue
        cur.append(c)
        i += 1
    out.append(("".join(cur), ""))
    return out


def _unescape(s: str) -> str:
    """Collapse backslash pairs: '\\x' -> 'x'."""
    if "\\" not in s:
        return s
    out = []
    i = 0
    while i < len(s):
        if s[i] == "\\" and i + 1 < len(s):
            out.append(s[i + 1])
            i += 2
        else:
            out.append(s[i])
            i += 1
    return "".join(out)


def _parse_field_value(v: str):
    if v.startswith('"') and v.endswith('"') and len(v) >= 2:
        return v[1:-1].replace('\\"', '"').replace("\\\\", "\\")
    low = v.lower()
    if low in ("t", "true"):
        return True
    if low in ("f", "false"):
        return False
    # '_' digit grouping is a Python-ism, not line protocol: reject it
    # so native and fallback agree on what malformed data looks like
    if "_" in v:
        raise LineProtocolError(f"bad field value {v!r}")
    if v.endswith("i") or v.endswith("u"):
        try:
            return int(v[:-1])
        except ValueError:
            raise LineProtocolError(f"bad field value {v!r}") from None
    try:
        return float(v)
    except ValueError:
        raise LineProtocolError(f"bad field value {v!r}") from None


_BOOL = ConcreteDataType.bool_()
_INT64 = ConcreteDataType.int64()
_FLOAT64 = ConcreteDataType.float64()
_STRING = ConcreteDataType.string()


def _field_type(v) -> ConcreteDataType:
    if isinstance(v, bool):
        return _BOOL
    if isinstance(v, int):
        return _INT64
    if isinstance(v, float):
        return _FLOAT64
    return _STRING


def parse_payload(body: str, *, native: bool = True) -> list:
    """[(measurement, tags, fields, ts_raw|None)] for a whole payload:
    through the native tokenizer, or the Python parser with
    `native=False`."""
    if native:
        from greptimedb_tpu_torch.native import load_lineproto

        try:
            return load_lineproto().parse_payload(body)
        except ValueError as e:
            raise LineProtocolError(str(e)) from None
    out = []
    # split on \n only (as the native tokenizer does); a stray \r is
    # stripped with the other edge whitespace
    for raw in body.split("\n"):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        try:
            out.append(parse_line(line))
        except LineProtocolError:
            raise
        except ValueError as e:
            raise LineProtocolError(f"{e}: {line!r}") from None
    return out


def write_lines(instance, body: str, *, db: str = "public",
                precision: str = "ns") -> int:
    """Parse a line-protocol payload and write it, auto-creating/widening
    tables. Returns rows written."""
    scale = _PRECISION_MS.get(precision)
    if scale is None:
        raise LineProtocolError(f"bad precision {precision!r}")
    num, den = scale
    now_ms = int(time.time() * 1000)

    # batch rows per measurement
    per_table: dict[str, list] = defaultdict(list)
    for m, tags, fields, ts_raw in parse_payload(body):
        ts = (now_ms if ts_raw is None
              else int(ts_raw) * num // den)    # exact integer math
        per_table[m].append((tags, fields, ts))

    total = 0
    for measurement, rows in per_table.items():
        total += _write_measurement(instance, db, measurement, rows)
    return total


def _write_measurement(instance, db: str, measurement: str, rows) -> int:
    tag_keys: list[str] = []
    field_types: dict[str, ConcreteDataType] = {}
    for tags, fields, _ in rows:
        for k in tags:
            if k not in tag_keys:
                tag_keys.append(k)
        for k, v in fields.items():
            t = _field_type(v)
            prev = field_types.get(k)
            if prev is None or (prev.id.value == "int64"
                                and t.id.value == "float64"):
                field_types[k] = t
    table = ensure_table(instance, db, measurement, tag_keys, field_types)

    n = len(rows)
    ts = np.fromiter((r[2] for r in rows), np.int64, n)
    tag_cols = {
        k: np.asarray([r[0].get(k, "") for r in rows], object)
        for k in table.tag_names
    }
    fields_out = {}
    valid_out = {}
    for k in field_types:
        cs = table.schema.column(k)
        vals = [r[1].get(k) for r in rows]
        if cs.data_type.is_string():
            arr = np.asarray(
                ["" if v is None else str(v) for v in vals], object
            )
        else:
            np_t = cs.data_type.to_numpy()
            is_int = np.issubdtype(np_t, np.integer)
            arr = np.zeros(n, np_t)
            for i, v in enumerate(vals):
                if v is None:
                    continue
                if is_int and isinstance(v, float) and v != int(v):
                    raise LineProtocolError(
                        f"field {k!r} is {cs.data_type.name} but got "
                        f"non-integral value {v}"
                    )
                arr[i] = v
        fields_out[k] = arr
        validity = np.asarray([v is not None for v in vals], bool)
        if not validity.all():
            valid_out[k] = validity
    table.write(tag_cols, ts, fields_out, field_valid=valid_out or None)
    data = {table.ts_name: ts, **tag_cols, **fields_out}
    instance._notify_flows(db, measurement, table, data, valid_out)
    return n


def ensure_table(instance, db: str, name: str, tag_keys: list[str],
                 field_types: dict[str, ConcreteDataType],
                 *, engine: str = "mito"):
    """Auto-create or widen a table for protocol ingest (the reference's
    auto-create/auto-alter on insert, src/operator/src/insert.rs).
    engine="metric" creates a logical table over the shared physical
    region pair (the metric engine's remote-write role)."""
    table = instance.catalog.maybe_table(db, name)
    if table is None:
        cols = [
            ColumnSchema(k, ConcreteDataType.string(), SemanticType.TAG,
                         nullable=False)
            for k in tag_keys
        ]
        for k, t in field_types.items():
            cols.append(ColumnSchema(k, t, SemanticType.FIELD))
        cols.append(ColumnSchema(
            "ts", ConcreteDataType.timestamp_millisecond(),
            SemanticType.TIMESTAMP, nullable=False,
        ))
        if not instance.catalog.has_database(db):
            instance.catalog.create_database(db, if_not_exists=True)
        return instance.catalog.create_table(
            db, name, Schema(cols), if_not_exists=True, engine=engine,
        )
    # widen: add unseen tags/fields; a name clash across semantics is an
    # error, not a silent drop
    schema = table.schema
    for k in tag_keys:
        existing = schema.maybe_column(k)
        if existing is None:
            instance.catalog.alter_add_column(db, name, ColumnSchema(
                k, ConcreteDataType.string(), SemanticType.TAG,
            ), if_not_exists=True)
        elif not existing.is_tag:
            raise LineProtocolError(
                f"{name}.{k} is a {existing.semantic_type.name} column, "
                "cannot write it as a tag"
            )
    for k, t in field_types.items():
        existing = schema.maybe_column(k)
        if existing is None:
            instance.catalog.alter_add_column(db, name, ColumnSchema(
                k, t, SemanticType.FIELD,
            ), if_not_exists=True)
        elif not existing.is_field:
            raise LineProtocolError(
                f"{name}.{k} is a {existing.semantic_type.name} column, "
                "cannot write it as a field"
            )
        schema = table.schema
    return table
