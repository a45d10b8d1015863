"""Snappy raw-block codec in pure Python (the JAX package's
servers/snappy.py): Prometheus remote write and read bodies are snappy
block-compressed.
"""

from __future__ import annotations


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift > 35:
            raise ValueError("varint too long")


def _write_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decompress(data: bytes) -> bytes:
    """Decompress a raw snappy block."""
    if not data:
        return b""
    want, pos = _read_varint(data, 0)
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 0x03
        if kind == 0:  # literal
            ln = tag >> 2
            if ln >= 60:
                extra = ln - 59
                ln = int.from_bytes(data[pos:pos + extra], "little")
                pos += extra
            ln += 1
            out += data[pos:pos + ln]
            pos += ln
            continue
        if kind == 1:  # copy, 1-byte offset
            ln = ((tag >> 2) & 0x07) + 4
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:  # copy, 2-byte offset
            ln = (tag >> 2) + 1
            offset = int.from_bytes(data[pos:pos + 2], "little")
            pos += 2
        else:  # copy, 4-byte offset
            ln = (tag >> 2) + 1
            offset = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out):
            raise ValueError("snappy: bad copy offset")
        start = len(out) - offset
        if offset >= ln:
            out += out[start:start + ln]
        else:
            # overlapping copy: byte-at-a-time semantics
            for i in range(ln):
                out.append(out[start + i])
    if len(out) != want:
        raise ValueError(
            f"snappy: length mismatch (want {want}, got {len(out)})"
        )
    return bytes(out)


def compress(data: bytes) -> bytes:
    """Minimal valid snappy block: varint length + literal chunks. (Remote
    read responses only need a well-formed stream, not a dense one.)"""
    out = bytearray(_write_varint(len(data)))
    pos = 0
    n = len(data)
    while pos < n:
        chunk = data[pos:pos + 65536]
        ln = len(chunk) - 1
        if ln < 60:
            out.append(ln << 2)
        else:
            nbytes = (ln.bit_length() + 7) // 8
            out.append((59 + nbytes) << 2)
            out += ln.to_bytes(nbytes, "little")
        out += chunk
        pos += len(chunk)
    return bytes(out)
