"""Prometheus remote write and read (the JAX package's
servers/prom_store.py): snappy-compressed protobuf WriteRequest ingest
into the metric engine (one logical table per metric, labels -> tags,
value -> greptime_value) and ReadRequest answers. The protobuf wire codec
is written out by hand (three message types deep).
"""

from __future__ import annotations

import struct
from collections import defaultdict

import numpy as np

from greptimedb_tpu_torch.datatypes.types import ConcreteDataType
from greptimedb_tpu_torch.errors import InvalidArgumentError
from greptimedb_tpu_torch.servers import snappy
from greptimedb_tpu_torch.servers.influx import ensure_table

VALUE_FIELD = "greptime_value"


# ----------------------------------------------------------------------
# protobuf wire helpers
# ----------------------------------------------------------------------

def _iter_fields(data: bytes, pos: int = 0, end: int | None = None):
    """Yield (field_no, wire_type, value) — value is int for varint, bytes
    for length-delimited, raw 8/4 bytes for fixed."""
    if end is None:
        end = len(data)
    while pos < end:
        tag = 0
        shift = 0
        while True:
            b = data[pos]
            pos += 1
            tag |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        field_no = tag >> 3
        wire = tag & 0x07
        if wire == 0:  # varint
            v = 0
            shift = 0
            while True:
                b = data[pos]
                pos += 1
                v |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            yield field_no, wire, v
        elif wire == 1:  # 64-bit
            yield field_no, wire, data[pos:pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            ln = 0
            shift = 0
            while True:
                b = data[pos]
                pos += 1
                ln |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            yield field_no, wire, data[pos:pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            yield field_no, wire, data[pos:pos + 4]
            pos += 4
        else:
            raise InvalidArgumentError(f"bad protobuf wire type {wire}")


def _zigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def _parse_label(data: bytes) -> tuple[str, str]:
    name = value = ""
    for f, w, v in _iter_fields(data):
        if f == 1:
            name = v.decode("utf-8", "replace")
        elif f == 2:
            value = v.decode("utf-8", "replace")
    return name, value


def _parse_sample(data: bytes) -> tuple[float, int]:
    value = 0.0
    ts = 0
    for f, w, v in _iter_fields(data):
        if f == 1:
            value = struct.unpack("<d", v)[0]
        elif f == 2:
            ts = v if v < (1 << 63) else v - (1 << 64)
    return value, ts


def parse_write_request(data: bytes):
    """WriteRequest -> list of (labels: dict, samples: list[(value, ts)])."""
    out = []
    for f, w, v in _iter_fields(data):
        if f != 1:
            continue  # skip metadata
        labels = {}
        samples = []
        for f2, w2, v2 in _iter_fields(v):
            if f2 == 1:
                k, val = _parse_label(v2)
                labels[k] = val
            elif f2 == 2:
                samples.append(_parse_sample(v2))
        out.append((labels, samples))
    return out


# ----------------------------------------------------------------------
# ingest
# ----------------------------------------------------------------------

def remote_write(instance, body: bytes, *, db: str = "public",
                 compressed: bool = True) -> tuple[int, int]:
    """Apply a remote-write payload. Returns (series, samples)."""
    if compressed:
        body = snappy.decompress(body)
    serieses = parse_write_request(body)
    return len(serieses), apply_series(instance, serieses, db=db)


def apply_series(instance, serieses, *, db: str = "public") -> int:
    """Write [(labels-with-__name__, [(value, ts_ms)])] series into
    per-metric tables (shared by remote write and the metrics
    self-export task). Returns samples written."""
    per_metric: dict[str, list] = defaultdict(list)
    for labels, samples in serieses:
        metric = labels.pop("__name__", None)
        if metric is None or not samples:
            continue
        per_metric[metric].append((labels, samples))
    n_samples = 0
    for metric, series_list in per_metric.items():
        tag_keys: list[str] = []
        for labels, _ in series_list:
            for k in labels:
                if k not in tag_keys:
                    tag_keys.append(k)
        # remote-write metrics ride the METRIC ENGINE: thousands of
        # small metrics share one physical region pair instead of each
        # costing regions (ref src/metric-engine/src/engine.rs:60 —
        # "backs Prometheus remote-write tables")
        table = ensure_table(
            instance, db, metric, tag_keys,
            {VALUE_FIELD: ConcreteDataType.float64()},
            engine="metric",
        )
        rows_ts = []
        rows_val = []
        rows_tags: dict[str, list] = {k: [] for k in table.tag_names}
        for labels, samples in series_list:
            for value, ts in samples:
                rows_ts.append(ts)
                rows_val.append(value)
                for k in table.tag_names:
                    rows_tags[k].append(labels.get(k, ""))
        ts = np.asarray(rows_ts, np.int64)
        vals = np.asarray(rows_val, np.float64)
        tag_cols = {k: np.asarray(v, object) for k, v in rows_tags.items()}
        table.write(tag_cols, ts, {VALUE_FIELD: vals})
        data = {table.ts_name: ts, VALUE_FIELD: vals, **tag_cols}
        instance._notify_flows(db, metric, table, data, {})
        n_samples += len(ts)
    return n_samples


# ----------------------------------------------------------------------
# remote read
# ----------------------------------------------------------------------

def _encode_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_bytes(no: int, payload: bytes) -> bytes:
    return _encode_varint((no << 3) | 2) + _encode_varint(len(payload)) + payload


def _field_varint(no: int, v: int) -> bytes:
    return _encode_varint(no << 3) + _encode_varint(v & ((1 << 64) - 1))


def _field_double(no: int, v: float) -> bytes:
    return _encode_varint((no << 3) | 1) + struct.pack("<d", v)


def parse_read_request(data: bytes):
    """ReadRequest -> list of queries: (start_ms, end_ms, matchers) where
    matchers is a list of (type, name, value); type 0: EQ 1: NEQ 2: RE
    3: NRE."""
    queries = []
    for f, w, v in _iter_fields(data):
        if f != 1:
            continue
        start = end = 0
        matchers = []
        for f2, w2, v2 in _iter_fields(v):
            if f2 == 1:
                start = v2
            elif f2 == 2:
                end = v2
            elif f2 == 3:
                mtype = 0
                name = value = ""
                for f3, w3, v3 in _iter_fields(v2):
                    if f3 == 1:
                        mtype = v3
                    elif f3 == 2:
                        name = v3.decode()
                    elif f3 == 3:
                        value = v3.decode()
                matchers.append((mtype, name, value))
        queries.append((start, end, matchers))
    return queries


def remote_read(instance, body: bytes, *, db: str = "public") -> bytes:
    """Answer a remote-read request with a snappy-compressed ReadResponse."""
    import re as _re

    from greptimedb_tpu_torch.query.expr import compile_matcher

    data = snappy.decompress(body)
    queries = parse_read_request(data)
    query_results = []
    for start, end, matchers in queries:
        name_matchers = []
        reg_matchers = []
        for mtype, name, value in matchers:
            if name == "__name__":
                name_matchers.append((mtype, value))
                continue
            op = {0: "eq", 1: "ne", 2: "re", 3: "nre"}[mtype]
            val = (compile_matcher(value) if mtype in (2, 3)
                   else value)
            reg_matchers.append((name, op, val))
        # resolve metric names: EQ narrows to one, RE/NEQ/NRE filter all.
        # The metric engine's shared physical table is internal — a
        # regex/NEQ matcher must not surface every sample a second time
        # under its name.
        from greptimedb_tpu_torch.metric_engine import PHYSICAL_TABLE

        metrics = [
            t.name for t in instance.catalog.all_tables()
            if t.info.database == db and t.name != PHYSICAL_TABLE
        ]
        for mtype, value in name_matchers:
            if mtype == 0:
                metrics = [m for m in metrics if m == value]
            elif mtype == 1:
                metrics = [m for m in metrics if m != value]
            else:
                rx = _re.compile(value)
                hit = lambda m: bool(rx.fullmatch(m))
                metrics = [
                    m for m in metrics
                    if (hit(m) if mtype == 2 else not hit(m))
                ]
        timeseries = []
        for metric in metrics:
            table = instance.catalog.maybe_table(db, metric)
            if table is None or VALUE_FIELD not in table.schema:
                continue
            scan = table.scan(
                ts_min=start, ts_max=end, field_names=[VALUE_FIELD],
                matchers=reg_matchers or None,
            )
            if scan.rows is not None and len(scan.rows):
                rows = scan.rows
                for sid in np.unique(rows.sid):
                    sel = rows.sid == sid
                    labels = scan.registry.series_tags(int(sid))
                    lab_bytes = _field_bytes(1, (
                        _field_bytes(1, b"__name__")
                        + _field_bytes(2, metric.encode())
                    ))
                    for k, v in labels.items():
                        if v == "" or k.startswith("__"):
                            # internal tags (metric engine __table_id)
                            # never leave the node
                            continue
                        lab_bytes += _field_bytes(1, (
                            _field_bytes(1, k.encode())
                            + _field_bytes(2, v.encode())
                        ))
                    samples = b""
                    vals = rows.fields[VALUE_FIELD][sel]
                    tss = rows.ts[sel]
                    for v, t in zip(vals, tss):
                        samples += _field_bytes(2, (
                            _field_double(1, float(v))
                            + _field_varint(2, int(t))
                        ))
                    timeseries.append(_field_bytes(1, lab_bytes + samples))
        # QueryResult.timeseries == field 1; ReadResponse.results == field 1
        query_results.append(b"".join(timeseries))
    resp = b"".join(_field_bytes(1, qr) for qr in query_results)
    return snappy.compress(resp)
