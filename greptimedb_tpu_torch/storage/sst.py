"""SST files in the port's own format.

The JAX package writes Parquet through pyarrow; the port writes one file
per SST with the standard library and numpy only:

    magic "GTSST1\\n\\0" | u64 header length | header JSON | data

The header holds the row count, the schema (internal columns, then fields
with their numpy dtypes) and one entry per row group of `row_group_rows`
rows: its row count, ts min/max, sid min/max, and per column the offset and
byte length of its values and, where the group holds a null, of its
validity (one byte a row). It also holds the sid index: per row group the
offset of its distinct sids in one int32 buffer. Numeric columns are raw
little-endian buffers, 64-byte aligned, after the header; string columns are
UTF-8 JSON lists.

Internal columns, as the JAX package's:

    __series int32   dense region-local series id
    __ts     int64   time index, ms
    __seq    uint64  write sequence (dedup: higher wins)
    __op     uint8   0=put 1=delete

Rows inside an SST are sorted by (__series, __ts, __seq). Readers prune row
groups by their ts range and the sid index before decoding. A null reads
back as 0 ("" for strings), as the JAX package's Arrow decode fills it;
parity with the JAX package is on what is read back, never on file bytes.
The fulltext sidecar (a puffin file) is not ported.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass

import numpy as np

from greptimedb_tpu_torch.errors import UnsupportedError
from greptimedb_tpu_torch.storage.memtable import ColumnarRows, _slice_rows
from greptimedb_tpu_torch.storage.object_store import ObjectStore

SERIES_COL = "__series"
TS_COL = "__ts"
SEQ_COL = "__seq"
OP_COL = "__op"
_INTERNAL = (SERIES_COL, TS_COL, SEQ_COL, OP_COL)
_INTERNAL_DTYPES = {SERIES_COL: "<i4", TS_COL: "<i8", SEQ_COL: "<u8",
                    OP_COL: "|u1"}

# storage tiers (compaction tiering): hot files live on the region's
# primary store, cold files on the cold store
TIER_HOT = "hot"
TIER_COLD = "cold"

_MAGIC = b"GTSST1\n\0"
_LEN = struct.Struct("<Q")
_ALIGN = 64


@dataclass
class SstMeta:
    file_id: str
    path: str
    rows: int
    ts_min: int
    ts_max: int
    sid_max: int
    size_bytes: int
    level: int = 0
    # sid range floor for whole-SST pruning (region.scan skips files whose
    # [sid_min, sid_max] cannot intersect the matched sid set)
    sid_min: int = 0
    # a fulltext sidecar: never set by the port (kept for the manifest)
    fulltext: bool = False
    # storage tier
    tier: str = TIER_HOT

    def to_json(self) -> dict:
        return self.__dict__.copy()

    @staticmethod
    def from_json(d: dict) -> "SstMeta":
        return SstMeta(**d)


def sort_rows(rows: ColumnarRows) -> ColumnarRows:
    order = np.lexsort((rows.seq, rows.ts, rows.sid))
    return _slice_rows(rows, order)


def sidecar_path(path: str) -> str:
    return path + ".puffin"


def _col_bytes(vals: np.ndarray) -> tuple[bytes, str]:
    if vals.dtype == object:
        return (json.dumps(["" if v is None else str(v) for v in vals])
                .encode(), "obj")
    le = vals.astype(vals.dtype.newbyteorder("<"), copy=False)
    return np.ascontiguousarray(le).tobytes(), le.dtype.str


def _build_sid_index(sid: np.ndarray, n: int,
                     row_group_rows: int) -> tuple[list[int], np.ndarray]:
    """Per-row-group distinct sids (the JAX package's footer sid index):
    offsets into one int32 array."""
    offsets = [0]
    chunks = []
    for start in range(0, n, row_group_rows):
        uniq = np.unique(sid[start:start + row_group_rows]).astype(np.int32)
        chunks.append(uniq)
        offsets.append(offsets[-1] + len(uniq))
    cat = np.concatenate(chunks) if chunks else np.zeros(0, np.int32)
    return offsets, cat


def encode_sst(rows: ColumnarRows, *,
               row_group_rows: int = 256 * 1024) -> bytes:
    """Sorted rows -> the bytes of one SST file."""
    n = len(rows)
    fields = list(rows.fields)
    cols = {SERIES_COL: np.asarray(rows.sid, np.int32),
            TS_COL: np.asarray(rows.ts, np.int64),
            SEQ_COL: np.asarray(rows.seq, np.uint64),
            OP_COL: np.asarray(rows.op, np.uint8)}
    valids = {}
    schema = [{"name": c, "dtype": _INTERNAL_DTYPES[c]} for c in _INTERNAL]
    for name in fields:
        vals = np.asarray(rows.fields[name])
        valid = (rows.field_valid.get(name)
                 if rows.field_valid is not None else None)
        if valid is not None and not valid.all():
            # a null reads back as 0 ("" for strings), as Arrow's fill
            vals = vals.copy()
            vals[~valid] = "" if vals.dtype == object else 0
            valids[name] = np.asarray(valid, bool)
        cols[name] = vals
        schema.append({"name": name,
                       "dtype": "obj" if vals.dtype == object
                       else vals.dtype.newbyteorder("<").str})
    bufs: list[bytes] = []
    off = 0

    def put(raw: bytes) -> list[int]:
        nonlocal off
        pad = (-off) % _ALIGN
        if pad:
            bufs.append(b"\0" * pad)
            off += pad
        at = off
        bufs.append(raw)
        off += len(raw)
        return [at, len(raw)]

    groups = []
    for start in range(0, max(n, 1), row_group_rows):
        stop = min(start + row_group_rows, n)
        if stop <= start:
            break
        g = {"rows": stop - start,
             "ts_min": int(cols[TS_COL][start:stop].min()),
             "ts_max": int(cols[TS_COL][start:stop].max()),
             "sid_min": int(cols[SERIES_COL][start:stop].min()),
             "sid_max": int(cols[SERIES_COL][start:stop].max()),
             "cols": {}, "valid": {}}
        for name, vals in cols.items():
            raw, _ = _col_bytes(vals[start:stop])
            g["cols"][name] = put(raw)
            v = valids.get(name)
            if v is not None and not v[start:stop].all():
                g["valid"][name] = put(v[start:stop].view(np.uint8).tobytes())
        groups.append(g)
    offsets, sid_cat = _build_sid_index(cols[SERIES_COL], n, row_group_rows)
    header = {"rows": n, "row_group_rows": row_group_rows, "schema": schema,
              "groups": groups,
              "sid_index": {"offsets": offsets,
                            "at": put(sid_cat.astype("<i4").tobytes())}}
    head = json.dumps(header).encode()
    lead = _MAGIC + _LEN.pack(len(head)) + head
    lead += b"\0" * ((-len(lead)) % _ALIGN)
    return b"".join([lead, *bufs])


class SstFile:
    """A parsed SST: its header and column reads by row group, over bytes
    in memory or a memory-mapped local file."""

    def __init__(self, buf):
        if bytes(buf[:len(_MAGIC)]) != _MAGIC:
            raise ValueError("not an SST file (bad magic)")
        (hlen,) = _LEN.unpack_from(bytes(buf[len(_MAGIC):len(_MAGIC) + 8]))
        start = len(_MAGIC) + 8
        self.header = json.loads(bytes(buf[start:start + hlen]))
        end = start + hlen
        self._base = end + ((-end) % _ALIGN)
        self._buf = buf
        self.dtypes = {c["name"]: c["dtype"] for c in self.header["schema"]}

    @staticmethod
    def open(store: ObjectStore, path: str) -> "SstFile":
        """Local files open memory-mapped (only the surviving row groups
        are touched); other stores read the whole object."""
        try:
            lp = store.local_read_path(path)
        except (NotImplementedError, FileNotFoundError, OSError):
            return SstFile(store.read(path))
        return SstFile(np.memmap(lp, dtype=np.uint8, mode="r"))

    @property
    def num_rows(self) -> int:
        return int(self.header["rows"])

    @property
    def groups(self) -> list[dict]:
        return self.header["groups"]

    @property
    def names(self) -> list[str]:
        return [c["name"] for c in self.header["schema"]]

    def _raw(self, at: list[int]):
        return self._buf[self._base + at[0]:self._base + at[0] + at[1]]

    def column(self, g: int, name: str):
        """(values, validity|None) of one column in one row group; the
        values are read-only."""
        grp = self.groups[g]
        dt = self.dtypes[name]
        raw = self._raw(grp["cols"][name])
        if dt == "obj":
            values = np.asarray(json.loads(bytes(raw)), dtype=object)
        else:
            values = np.frombuffer(bytes(raw), dtype=np.dtype(dt))
            values = values.astype(values.dtype.newbyteorder("="),
                                   copy=False)
        values.setflags(write=False)
        validity = None
        if name in grp["valid"]:
            validity = np.frombuffer(bytes(self._raw(grp["valid"][name])),
                                     np.uint8).astype(bool)
        return values, validity

    def sid_index(self) -> tuple[np.ndarray, np.ndarray]:
        idx = self.header["sid_index"]
        sids = np.frombuffer(bytes(self._raw(idx["at"])), "<i4").astype(
            np.int32)
        return np.asarray(idx["offsets"], np.int64), sids


def write_sst(
    store: ObjectStore,
    path: str,
    file_id: str,
    rows: ColumnarRows,
    *,
    row_group_rows: int = 256 * 1024,
    level: int = 0,
    tier: str = TIER_HOT,
    fulltext_fields: list | None = None,
) -> SstMeta:
    """Write sorted rows as one SST object; returns its metadata."""
    if fulltext_fields:
        raise UnsupportedError(
            "fulltext SST sidecars (puffin) are not ported (ROADMAP A4/A8)")
    rows = sort_rows(rows)
    data = encode_sst(rows, row_group_rows=row_group_rows)
    store.write(path, data)
    n = len(rows)
    return SstMeta(
        file_id=file_id,
        path=path,
        rows=n,
        ts_min=int(rows.ts.min()) if n else 0,
        ts_max=int(rows.ts.max()) if n else 0,
        sid_max=int(rows.sid.max()) if n else -1,
        sid_min=int(rows.sid.min()) if n else 0,
        size_bytes=len(data),
        level=level,
        tier=tier,
    )


def _rows_from(decoded: dict, wanted: list[str], names: list[str],
               sel=None) -> ColumnarRows:
    fields = {}
    valids = {}
    has_nulls = False
    n = None
    for name in wanted:
        if name not in names:
            continue
        values, validity = decoded[name]
        if sel is not None:
            values = values[sel]
        n = len(values)
        if validity is not None:
            has_nulls = True
            valids[name] = validity if sel is None else validity[sel]
        else:
            valids[name] = np.ones(n, dtype=bool)
        fields[name] = values
    cols = {c: decoded[c][0] if sel is None else decoded[c][0][sel]
            for c in _INTERNAL}
    return ColumnarRows(
        sid=cols[SERIES_COL], ts=cols[TS_COL], seq=cols[SEQ_COL],
        op=cols[OP_COL], fields=fields,
        field_valid=valids if has_nulls else None,
    )


def read_sst_bytes(data: bytes, *,
                   field_names: list[str] | None = None
                   ) -> ColumnarRows | None:
    """Decode a whole SST from already-fetched (and byte-verified) bytes:
    the compaction read path, with no pruning and no page cache."""
    f = SstFile(data)
    if f.num_rows == 0:
        return None
    names = f.names
    wanted = (field_names if field_names is not None
              else [n for n in names if n not in _INTERNAL])
    cols = list(_INTERNAL) + [n for n in wanted if n in names]
    decoded = {}
    for c in cols:
        parts = [f.column(g, c) for g in range(len(f.groups))]
        decoded[c] = _concat_parts(parts)
    return _rows_from(decoded, wanted, names)


def _concat_parts(parts):
    if len(parts) == 1:
        return parts[0]
    values = np.concatenate([p[0] for p in parts])
    if any(p[1] is not None for p in parts):
        validity = np.concatenate([
            p[1] if p[1] is not None else np.ones(len(p[0]), bool)
            for p in parts])
    else:
        validity = None
    return values, validity


def read_sst(
    store: ObjectStore,
    meta: SstMeta,
    *,
    ts_min: int | None = None,
    ts_max: int | None = None,
    field_names: list[str] | None = None,
    sids: np.ndarray | None = None,
    fulltext: list | None = None,
) -> ColumnarRows | None:
    """Read an SST with row-group pruning by ts range and the sid index,
    then row-filter to the exact range (and optional sid set). Decoded
    row groups ride the page cache."""
    if fulltext and meta.fulltext:
        raise UnsupportedError(
            "fulltext SST sidecars (puffin) are not ported (ROADMAP A4/A8)")
    if ts_min is not None and meta.ts_max < ts_min:
        return None
    if ts_max is not None and meta.ts_min > ts_max:
        return None
    from greptimedb_tpu_torch.storage.page_cache import read_columns

    f = SstFile.open(store, meta.path)
    names = f.names
    wanted = (field_names if field_names is not None
              else [n for n in names if n not in _INTERNAL])
    cols = list(_INTERNAL) + [n for n in wanted if n in names]
    sids_sorted = np.sort(sids) if sids is not None else None
    sid_index = f.sid_index() if sids is not None else None
    groups = []
    for g, grp in enumerate(f.groups):
        if ts_min is not None and grp["ts_max"] < ts_min:
            continue
        if ts_max is not None and grp["ts_min"] > ts_max:
            continue
        if sids_sorted is not None:
            offsets, all_sids = sid_index
            members = all_sids[offsets[g]:offsets[g + 1]]
            if not np.isin(members, sids_sorted, assume_unique=True).any():
                continue
        groups.append(g)
    if not groups:
        return None
    decoded = read_columns(f, meta.path, groups, cols)
    sid = decoded[SERIES_COL][0]
    ts = decoded[TS_COL][0]
    sel = np.ones(len(sid), dtype=bool)
    if ts_min is not None:
        sel &= ts >= ts_min
    if ts_max is not None:
        sel &= ts <= ts_max
    if sids is not None:
        sel &= np.isin(sid, sids)
    if not sel.any():
        return None
    return _rows_from(decoded, wanted, names, sel)
