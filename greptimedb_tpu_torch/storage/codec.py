"""Binary codec for columnar batches (WAL payloads).

The JAX package's codec is a msgpack envelope; the port writes its own,
with the standard library only:

    magic "GTC1" | u32 header length | header JSON | column buffers

The header holds the caller's metadata and, per column, its name, kind,
dtype, shape and byte length. Numeric columns travel as raw little-endian
numpy buffers, back to back after the header; string (object) columns
travel as JSON lists inside the header (None stays None).
"""

from __future__ import annotations

import json
import struct

import numpy as np

_MAGIC = b"GTC1"
_LEN = struct.Struct("<I")


def encode_columns(columns: dict[str, np.ndarray],
                   meta: dict | None = None) -> bytes:
    cols = []
    bufs = []
    for name, arr in columns.items():
        arr = np.asarray(arr)
        if arr.dtype == object:
            cols.append({"n": name, "k": "obj",
                         "v": [None if x is None else str(x) for x in arr]})
            continue
        le = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
        raw = np.ascontiguousarray(le).tobytes()
        cols.append({"n": name, "k": "np", "d": le.dtype.str,
                     "s": list(arr.shape), "b": len(raw)})
        bufs.append(raw)
    head = json.dumps({"meta": meta or {}, "cols": cols}).encode()
    return b"".join([_MAGIC, _LEN.pack(len(head)), head, *bufs])


def decode_columns(data: bytes) -> tuple[dict[str, np.ndarray], dict]:
    if bytes(data[:4]) != _MAGIC:
        raise ValueError("not a column batch (bad magic)")
    (hlen,) = _LEN.unpack_from(data, 4)
    head = json.loads(bytes(data[8:8 + hlen]))
    off = 8 + hlen
    out = {}
    for c in head["cols"]:
        if c["k"] == "obj":
            out[c["n"]] = np.asarray(c["v"], dtype=object)
            continue
        dt = np.dtype(c["d"])
        n = c["b"]
        arr = np.frombuffer(data, dtype=dt, count=n // dt.itemsize,
                            offset=off).reshape(c["s"])
        out[c["n"]] = arr.astype(dt.newbyteorder("="), copy=True)
        off += n
    return out, head.get("meta", {})
