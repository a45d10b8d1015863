"""Write-ahead log: pluggable LogStores (the JAX package's storage/wal.py).

Per-region appends with monotonically increasing entry ids, replay from
an id, and obsoletion after flush.

Two LogStores here share the CRC-checked length-prefixed record framing:

- RegionWal: node-local segment FILES rotated by size; obsolete() unlinks
  whole segments below the flushed id.
- ObjectStoreLogStore: record batches appended as immutable OBJECTS via
  any ObjectStore (fs, memory): the remote-WAL deployment shape, where a
  new node can replay a lost node's log from shared storage.

SharedWalTopic multiplexes many regions into one physical log.

A region's single-writer discipline means appends for one region never
race; the lock here guards cross-region sharing of the same Wal object.
"""

from __future__ import annotations

import os
import struct

import zlib
from dataclasses import dataclass

from greptimedb_tpu_torch import concurrency

_MAGIC = 0x57414C31  # "WAL1"
_HEADER = struct.Struct("<IQII")  # magic, entry_id, len, crc32


@dataclass
class WalEntry:
    entry_id: int
    payload: bytes


class LogStore:
    """The pluggable WAL interface every backend implements."""

    def append(self, payload: bytes) -> int:
        raise NotImplementedError

    def append_batch(self, payloads: list[bytes]) -> int:
        raise NotImplementedError

    def replay(self, from_id: int = 0) -> list[WalEntry]:
        raise NotImplementedError

    def obsolete(self, up_to_id: int) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass

    @property
    def next_entry_id(self) -> int:
        raise NotImplementedError


def _encode_records(entries: list[tuple[int, bytes]]) -> bytes:
    parts = []
    for eid, payload in entries:
        parts.append(_HEADER.pack(_MAGIC, eid, len(payload),
                                  zlib.crc32(payload)))
        parts.append(payload)
    return b"".join(parts)


def _scan_records(data: bytes, from_id: int) -> tuple[list[WalEntry], int]:
    """Decode CRC-framed records until corruption/torn tail; returns the
    entries >= from_id and the offset where valid data ends. The ONE
    framing decoder both LogStores share."""
    out: list[WalEntry] = []
    off = 0
    n = len(data)
    while off + _HEADER.size <= n:
        magic, eid, ln, crc = _HEADER.unpack_from(data, off)
        if magic != _MAGIC or off + _HEADER.size + ln > n:
            break
        payload = data[off + _HEADER.size: off + _HEADER.size + ln]
        if zlib.crc32(payload) != crc:
            break
        if eid >= from_id:
            out.append(WalEntry(eid, payload))
        off += _HEADER.size + ln
    return out, off


def _decode_records(data: bytes, from_id: int) -> list[WalEntry]:
    return _scan_records(data, from_id)[0]


class ObjectStoreLogStore(LogStore):
    """Remote WAL over an ObjectStore: each append(-batch) writes ONE
    immutable object named {first}_{last}.wseg, so durability is the
    store's atomic write and replay is a prefix listing."""

    def __init__(self, store, prefix: str):
        self.store = store
        self.prefix = prefix.rstrip("/") + "/"
        self._lock = concurrency.Lock()
        self._next_id = 0
        self._recover_next_id()

    def _objects(self) -> list[str]:
        return [m.path for m in self.store.list(self.prefix)
                if m.path.endswith(".wseg")]

    @staticmethod
    def _ids_of(path: str) -> tuple[int, int]:
        base = path.rsplit("/", 1)[-1][:-5]
        first, last = base.split("_")
        return int(first), int(last)

    def _recover_next_id(self):
        last = -1
        for p in self._objects():
            try:
                last = max(last, self._ids_of(p)[1])
            except ValueError:
                continue
        self._next_id = last + 1

    def append(self, payload: bytes) -> int:
        return self.append_batch([payload])

    def drop(self) -> None:
        """Delete every log object (region dropped) — without this the
        wal/region_N prefix would leak in the object store forever."""
        with self._lock:
            for p in self._objects():
                self.store.delete(p)

    def append_batch(self, payloads: list[bytes]) -> int:
        if not payloads:
            return self._next_id - 1
        # the segment write stays under the WAL lock by design: entry ids
        # are allocated and embedded in the object name here, and id order
        # must match durability order for replay to be correct
        with self._lock:
            first = self._next_id
            entries = []
            for p in payloads:
                entries.append((self._next_id, p))
                self._next_id += 1
            last = self._next_id - 1
            self.store.write(
                f"{self.prefix}{first:016d}_{last:016d}.wseg",
                _encode_records(entries),
            )
            return last

    def replay(self, from_id: int = 0) -> list[WalEntry]:
        # reading segments under the lock keeps replay atomic against a
        # concurrent append/obsolete; replay runs at region open
        with self._lock:
            out: list[WalEntry] = []
            for p in sorted(self._objects()):
                try:
                    _, last = self._ids_of(p)
                except ValueError:
                    continue
                if last < from_id:
                    continue
                out.extend(_decode_records(self.store.read(p), from_id))
            return out

    def obsolete(self, up_to_id: int) -> None:
        # listing + deleting segments under the lock keeps truncation
        # atomic against a concurrent append allocating into a segment
        # this sweep would otherwise consider dead
        with self._lock:
            objs = []
            for p in self._objects():
                try:
                    objs.append((self._ids_of(p)[1], p))
                except ValueError:
                    continue
            if not objs:
                return
            # NEVER delete the tail segment (same rule as RegionWal):
            # it carries the highest entry id, which _recover_next_id
            # needs after a restart — deleting it would reset ids to 0
            # below the manifest's flushed id and make every subsequent
            # append unreplayable
            tail = max(objs)[1]
            for last, p in objs:
                if p is not tail and last <= up_to_id:
                    self.store.delete(p)

    @property
    def next_entry_id(self) -> int:
        return self._next_id


class RegionWal(LogStore):
    """WAL for one region: a directory of segment files named by their first
    entry id."""

    def __init__(self, root: str, *, segment_bytes: int = 64 * 1024 * 1024,
                 sync: bool = False):
        self.root = root
        self.segment_bytes = segment_bytes
        self.sync = sync
        self._lock = concurrency.Lock()
        os.makedirs(root, exist_ok=True)
        self._next_id = 0
        self._fh = None
        self._fh_path = None
        self._recover_next_id()

    # ---- write path ---------------------------------------------------
    def append(self, payload: bytes) -> int:
        """Append one entry; returns its entry id."""
        with self._lock:
            eid = self._next_id
            self._next_id += 1
            fh = self._active_file(eid)
            fh.write(_encode_records([(eid, payload)]))
            fh.flush()
            if self.sync:
                os.fsync(fh.fileno())
            return eid

    def append_batch(self, payloads: list[bytes]) -> int:
        """Append several entries with one flush; returns the last id."""
        with self._lock:
            fh = None
            for payload in payloads:
                eid = self._next_id
                self._next_id += 1
                fh = self._active_file(eid)
                fh.write(_encode_records([(eid, payload)]))
            if fh is not None:
                fh.flush()
                if self.sync:
                    os.fsync(fh.fileno())
            return self._next_id - 1

    # ---- read path ----------------------------------------------------
    def replay(self, from_id: int = 0) -> list[WalEntry]:
        """Read entries with id >= from_id, tolerating a torn tail record
        (crash mid-append): scanning stops cleanly at corruption."""
        with self._lock:
            entries: list[WalEntry] = []
            for seg in self._segments():
                first_id = int(os.path.basename(seg).split(".")[0])
                if self._segment_last_id_below(seg, from_id, first_id):
                    continue
                entries.extend(self._read_segment(seg, from_id))
            return entries

    def _segment_last_id_below(self, seg: str, from_id: int, first_id: int):
        # cheap prune: a segment whose successor starts <= from_id is
        # entirely below from_id; conservative fallback is to read it.
        segs = self._segments()
        i = segs.index(seg)
        if i + 1 < len(segs):
            nxt_first = int(os.path.basename(segs[i + 1]).split(".")[0])
            return nxt_first <= from_id
        return False

    def _read_segment(self, path: str, from_id: int) -> list[WalEntry]:
        return self._scan_segment(path, from_id)[0]

    def _scan_segment(self, path: str, from_id: int):
        """Returns (entries, valid_end_offset) — the offset where the first
        torn/corrupt record starts (== file size when intact)."""
        with open(path, "rb") as f:
            data = f.read()
        return _scan_records(data, from_id)

    # ---- maintenance --------------------------------------------------
    def drop(self) -> None:
        """Delete the whole log (region dropped)."""
        with self._lock:
            if self._fh:
                self._fh.close()
                self._fh = None
                self._fh_path = None
            import shutil

            shutil.rmtree(self.root, ignore_errors=True)

    def obsolete(self, up_to_id: int) -> None:
        """Drop entries with id <= up_to_id (whole segments only)."""
        with self._lock:
            segs = self._segments()
            for i, seg in enumerate(segs):
                nxt_first = (
                    int(os.path.basename(segs[i + 1]).split(".")[0])
                    if i + 1 < len(segs) else None
                )
                if nxt_first is not None and nxt_first <= up_to_id + 1:
                    if self._fh_path == seg and self._fh:
                        self._fh.close()
                        self._fh = None
                        self._fh_path = None
                    os.remove(seg)

    def close(self):
        with self._lock:
            if self._fh:
                self._fh.close()
                self._fh = None

    @property
    def next_entry_id(self) -> int:
        return self._next_id

    # ---- internals ----------------------------------------------------
    def _segments(self) -> list[str]:
        return sorted(
            os.path.join(self.root, f)
            for f in os.listdir(self.root)
            if f.endswith(".wal")
        )

    def _recover_next_id(self):
        """Recover the next entry id AND truncate torn tail bytes, so
        post-recovery appends are reachable by future replays (a torn record
        left in place would make everything after it unreadable)."""
        last = -1
        for seg in self._segments():
            entries, valid_end = self._scan_segment(seg, 0)
            if valid_end < os.path.getsize(seg):
                with open(seg, "r+b") as f:
                    f.truncate(valid_end)
            for e in entries:
                last = max(last, e.entry_id)
        self._next_id = last + 1

    def _active_file(self, eid: int):
        if self._fh is not None:
            if self._fh.tell() < self.segment_bytes:
                return self._fh
            self._fh.close()
            self._fh = None
        segs = self._segments()
        if segs and self._fh_path is None and os.path.getsize(segs[-1]) < \
                self.segment_bytes and self._was_active(segs[-1]):
            path = segs[-1]
        else:
            path = os.path.join(self.root, f"{eid:016d}.wal")
        self._fh = open(path, "ab")
        self._fh_path = path
        return self._fh

    def _was_active(self, path: str) -> bool:
        # reopening an existing tail segment after restart is fine; torn
        # tails are tolerated by replay.
        return True


# ----------------------------------------------------------------------
# shared-topic WAL
# ----------------------------------------------------------------------

def _frame_topic_entry(region_id: int, region_eid: int,
                       payload: bytes) -> bytes:
    return (region_id.to_bytes(8, "little")
            + region_eid.to_bytes(8, "little") + payload)


def _unframe_topic_entry(data: bytes) -> tuple[int, int, bytes]:
    return (int.from_bytes(data[:8], "little"),
            int.from_bytes(data[8:16], "little"), data[16:])


class SharedWalTopic:
    """Many regions multiplexed into ONE log ("topic"), a Kafka-style
    remote WAL: entries carry (region_id, per-region entry id, payload);
    per-region LogStore views demultiplex at replay.

    The physical log is any LogStore (RegionWal segment files for
    node-local, ObjectStoreLogStore for the shared/remote topology).
    Truncation honors the slowest region: a physical entry is dropped
    only once every region has flushed past its entries in that prefix."""

    def __init__(self, inner: LogStore):
        self.inner = inner
        self._lock = concurrency.Lock()
        # region_id -> last region entry id handed out
        self._last_eid: dict[int, int] = {}
        # region_id -> [(region_eid, global_id)], ascending
        self._index: dict[int, list[tuple[int, int]]] = {}
        # region_id -> obsolete mark (region entry ids <= mark are dead)
        self._marks: dict[int, int] = {}
        # startup buffers: the open-time scan retains decoded entries per
        # region so R region replays cost ONE pass over the physical log,
        # not R. A region's buffer is dropped at its first replay or
        # append; late replays fall back to a log scan.
        self._startup: dict[int, list[WalEntry]] = {}
        for e in self.inner.replay(0):
            rid, reid, payload = _unframe_topic_entry(e.payload)
            self._last_eid[rid] = max(self._last_eid.get(rid, -1), reid)
            self._index.setdefault(rid, []).append((reid, e.entry_id))
            self._startup.setdefault(rid, []).append(
                WalEntry(reid, payload)
            )

    # ---- per-region surface -------------------------------------------
    def append(self, region_id: int, payload: bytes) -> int:
        with self._lock:
            self._startup.pop(region_id, None)
            reid = self._last_eid.get(region_id, -1) + 1
            gid = self.inner.append(
                _frame_topic_entry(region_id, reid, payload)
            )
            self._last_eid[region_id] = reid
            self._index.setdefault(region_id, []).append((reid, gid))
            return reid

    def append_batch(self, region_id: int, payloads: list[bytes]) -> int:
        with self._lock:
            self._startup.pop(region_id, None)
            start = self._last_eid.get(region_id, -1) + 1
            if not payloads:
                return start - 1
            framed = [
                _frame_topic_entry(region_id, start + i, p)
                for i, p in enumerate(payloads)
            ]
            last_gid = self.inner.append_batch(framed)
            first_gid = last_gid - len(payloads) + 1
            idx = self._index.setdefault(region_id, [])
            idx.extend(
                (start + i, first_gid + i) for i in range(len(payloads))
            )
            self._last_eid[region_id] = start + len(payloads) - 1
            return start + len(payloads) - 1

    def replay(self, region_id: int, from_eid: int = 0) -> list[WalEntry]:
        with self._lock:
            buf = self._startup.pop(region_id, None)
            if buf is not None:
                return [e for e in buf if e.entry_id >= from_eid]
            idx = self._index.get(region_id, [])
            start_gid = None
            for reid, gid in idx:
                if reid >= from_eid:
                    start_gid = gid
                    break
            if start_gid is None:
                return []
            out = []
            for e in self.inner.replay(start_gid):
                rid, reid, payload = _unframe_topic_entry(e.payload)
                if rid == region_id and reid >= from_eid:
                    out.append(WalEntry(reid, payload))
            return out

    def obsolete(self, region_id: int, up_to_eid: int) -> None:
        """Advance the region's mark, then truncate the longest physical
        prefix every region has flushed past."""
        with self._lock:
            self._marks[region_id] = max(
                self._marks.get(region_id, -1), up_to_eid
            )
            self._truncate_locked()
            for rid in list(self._index):
                mark = self._marks.get(rid, -1)
                self._index[rid] = [
                    (reid, gid) for reid, gid in self._index[rid]
                    if reid > mark
                ]

    def next_entry_id_for(self, region_id: int) -> int:
        with self._lock:
            return self._last_eid.get(region_id, -1) + 1

    def seed_last_eid(self, region_id: int, floor_eid: int) -> None:
        """Raise a region's last-entry-id floor to its manifest flushed
        watermark. Needed at open: truncation may have dropped ALL of a
        region's physical entries (they were flushed, and other regions'
        progress allowed the prefix drop), in which case the open-time
        scan recovers nothing for it and a naive restart would hand out
        entry ids from 0 again — below flushed_entry_id, so replay
        (flushed+1) after the next crash silently skips them. Truncation
        only drops reids <= the region's obsolete mark (== its flushed
        id), so the manifest watermark is exactly the erased maximum."""
        with self._lock:
            if floor_eid > self._last_eid.get(region_id, -1):
                self._last_eid[region_id] = floor_eid

    def drop_region(self, region_id: int) -> None:
        """Forget a dropped region so its dead entries stop pinning
        truncation."""
        with self._lock:
            self._index.pop(region_id, None)
            self._last_eid.pop(region_id, None)
            self._marks.pop(region_id, None)
            self._startup.pop(region_id, None)
            self._truncate_locked()

    def _truncate_locked(self):
        cutoff = None
        for rid, idx in self._index.items():
            mark = self._marks.get(rid, -1)
            live = [gid for reid, gid in idx if reid > mark]
            if live:
                first_live = live[0]
                cutoff = (first_live if cutoff is None
                          else min(cutoff, first_live))
        if cutoff is None:
            cutoff = self.inner.next_entry_id
        if cutoff > 0:
            self.inner.obsolete(cutoff - 1)

    def close(self):
        self.inner.close()


class TopicRegionLog(LogStore):
    """One region's LogStore view over a SharedWalTopic. Closing the view
    does NOT close the topic (the engine owns topic lifecycle)."""

    def __init__(self, topic: SharedWalTopic, region_id: int):
        self.topic = topic
        self.region_id = region_id

    def append(self, payload: bytes) -> int:
        return self.topic.append(self.region_id, payload)

    def append_batch(self, payloads: list[bytes]) -> int:
        return self.topic.append_batch(self.region_id, payloads)

    def replay(self, from_id: int = 0) -> list[WalEntry]:
        return self.topic.replay(self.region_id, from_id)

    def obsolete(self, up_to_id: int) -> None:
        self.topic.obsolete(self.region_id, up_to_id)

    def drop(self) -> None:
        self.topic.drop_region(self.region_id)

    def seed_floor(self, floor_eid: int) -> None:
        self.topic.seed_last_eid(self.region_id, floor_eid)

    def close(self) -> None:
        pass

    @property
    def next_entry_id(self) -> int:
        return self.topic.next_entry_id_for(self.region_id)
