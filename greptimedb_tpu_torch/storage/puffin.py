"""Puffin-analog blob container (a copy of the JAX package's
storage/puffin.py, byte for byte the same container).

Counterpart of upstream GreptimeDB's puffin file format
(src/puffin/src/file_format/: magic-framed blobs with a JSON footer
describing each blob's type, offset, length and properties — the
container its inverted and fulltext indexes ship in).

Layout (all little-endian):

    magic "GPUF" | blob bytes ... | footer JSON | u32 footer_len | magic

Footer: {"blobs": [{"type", "offset", "length", "properties"}]}.
Blobs are opaque bytes; writers choose compression per blob.
"""

from __future__ import annotations

import json
import struct

MAGIC = b"GPUF"


class PuffinWriter:
    def __init__(self):
        self._parts: list[bytes] = [MAGIC]
        self._off = len(MAGIC)
        self._blobs: list[dict] = []

    def add_blob(self, blob_type: str, data: bytes,
                 properties: dict | None = None) -> None:
        self._blobs.append({
            "type": blob_type,
            "offset": self._off,
            "length": len(data),
            "properties": properties or {},
        })
        self._parts.append(data)
        self._off += len(data)

    def finish(self) -> bytes:
        footer = json.dumps({"blobs": self._blobs}).encode()
        return b"".join(
            self._parts
            + [footer, struct.pack("<I", len(footer)), MAGIC]
        )


class PuffinReader:
    def __init__(self, data: bytes):
        if (len(data) < len(MAGIC) * 2 + 4
                or data[:len(MAGIC)] != MAGIC
                or data[-len(MAGIC):] != MAGIC):
            raise ValueError("not a puffin container")
        (flen,) = struct.unpack_from("<I", data, len(data) - len(MAGIC) - 4)
        fstart = len(data) - len(MAGIC) - 4 - flen
        self._data = data
        self.blobs: list[dict] = json.loads(
            data[fstart:fstart + flen]
        )["blobs"]

    def find(self, blob_type: str, **props) -> dict | None:
        for b in self.blobs:
            if b["type"] != blob_type:
                continue
            if all(b["properties"].get(k) == v for k, v in props.items()):
                return b
        return None

    def read(self, blob: dict) -> bytes:
        return self._data[blob["offset"]:blob["offset"] + blob["length"]]
