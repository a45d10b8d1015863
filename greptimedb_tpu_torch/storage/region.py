"""A storage region: the LSM unit (WAL + memtable + SSTs + manifest), the
JAX package's storage/region.py.

Writes hit the WAL first, then the memtable; a flush writes the memtable as
one SST, commits a manifest edit and trims the WAL; scans merge the
memtable with the pruned SSTs and dedup by (sid, ts) keeping the highest
sequence, then honor deletes. Compaction (storage/compaction.py) merges
each time window's SSTs on the card through device_merge.merge_rows.

A region built without an object store (`store=None`, what a Table built
without an engine opens) keeps the port's in-memory path: no WAL, no SST,
no manifest; `compact` merges every window with memtable rows, together
with the window's earlier compacted output, through device_merge.merge_rows
and keeps the result in host memory. That merge covers every row the
window holds, so tombstones are dropped.

`dedup_rows` is the host reference merge (copied from the JAX package).

The merged-scan cache (the JAX package's `_ScanCachePool`): an unbounded
scan of at least `_SCAN_CACHE_MIN_ROWS` rows keeps its merged, deduped row
set on the region, keyed by the region's data version, its compaction
count and its field names, so a repeated full-table scan pays only its own
filter and projection. A write, a truncate or a compaction changes the
key; `invalidate_scan_cache` drops the entry explicitly.
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field

import numpy as np

from greptimedb_tpu_torch import concurrency
from greptimedb_tpu_torch.errors import RegionReadonlyError
from greptimedb_tpu_torch.storage import codec, device_merge
from greptimedb_tpu_torch.storage.memtable import (
    OP_DELETE,
    OP_PUT,
    ColumnarRows,
    Memtable,
    _concat_rows,
    _slice_rows,
)
from greptimedb_tpu_torch.storage.series import SeriesRegistry

DEFAULT_WINDOW_MS = 3_600_000

_SCAN_CACHE_MIN_ROWS = 1_000_000         # below this a cold scan is cheap
_SCAN_CACHE_TOTAL_BYTES = 6 * 1024**3    # global LRU budget


@dataclass
class RegionOptions:
    memtable_window_ms: int | None = 2 * 3600 * 1000
    flush_rows: int = 2_000_000
    flush_bytes: int = 256 * 1024 * 1024
    wal_sync: bool = False
    compaction_window_ms: int = 2 * 3600 * 1000
    compaction_trigger_files: int = 4
    merge_mode: str = "last_row"   # or "last_non_null"
    append_mode: bool = False      # append-only tables skip dedup
    ttl_ms: int | None = None


@dataclass
class RegionMetadata:
    region_id: int
    table: str
    tag_names: list[str]
    field_names: list[str]
    ts_name: str
    options: RegionOptions = field(default_factory=RegionOptions)
    # columns with flush-time fulltext term indexes (puffin sidecars)
    fulltext_fields: list = field(default_factory=list)


class _ScanCachePool:
    """Tracks cached-scan bytes across regions; LRU-evicts over budget."""

    def __init__(self, budget: int):
        self.budget = budget
        self._lock = concurrency.Lock()
        self._entries: dict[int, tuple] = {}  # id(region) -> (region, bytes)
        self._order: list[int] = []

    def store(self, region, entry: tuple, nbytes: int):
        """Install `entry` as region._scan_cache and account it (the
        attribute is only set or cleared under this lock)."""
        with self._lock:
            k = id(region)
            if k in self._entries:
                self._order.remove(k)
            region._scan_cache = entry
            self._entries[k] = (region, nbytes)
            self._order.append(k)
            total = sum(b for _, b in self._entries.values())
            while total > self.budget and len(self._order) > 1:
                ev = self._order.pop(0)
                reg, b = self._entries.pop(ev)
                reg._scan_cache = None
                total -= b

    def touch(self, region):
        with self._lock:
            k = id(region)
            if k in self._order:
                self._order.remove(k)
                self._order.append(k)

    def drop(self, region):
        with self._lock:
            region._scan_cache = None
            self._entries.pop(id(region), None)
            k = id(region)
            if k in self._order:
                self._order.remove(k)


_scan_pool = _ScanCachePool(_SCAN_CACHE_TOTAL_BYTES)


def _shallow_rows(rows: ColumnarRows, names) -> ColumnarRows:
    """New container sharing the cached arrays: callers replace attributes
    but never mutate the arrays in place."""
    return ColumnarRows(
        sid=rows.sid, ts=rows.ts, seq=rows.seq, op=rows.op,
        fields={n: rows.fields[n] for n in names},
        field_valid=(
            {n: rows.field_valid[n] for n in names if n in rows.field_valid}
            if rows.field_valid else None
        ),
    )


def _rows_nbytes(rows: ColumnarRows) -> int:
    n = rows.sid.nbytes + rows.ts.nbytes + rows.seq.nbytes + rows.op.nbytes
    for a in rows.fields.values():
        n += a.nbytes
    if rows.field_valid:
        for a in rows.field_valid.values():
            n += a.nbytes
    return n


def _select_rows(rows: ColumnarRows, ts_min, ts_max, sids) -> ColumnarRows:
    """Rows with ts in [ts_min, ts_max] (None: unbounded) of the series in
    `sids` (None: all)."""
    sel = None
    if sids is not None:
        sel = np.isin(rows.sid, sids)
    if ts_min is not None or ts_max is not None:
        lo = ts_min if ts_min is not None else -(2**63)
        hi = ts_max if ts_max is not None else 2**63 - 1
        in_ts = (rows.ts >= lo) & (rows.ts <= hi)
        sel = in_ts if sel is None else sel & in_ts
    if sel is None or sel.all():
        return rows
    return _slice_rows(rows, sel)


def dedup_rows(rows: ColumnarRows, *, merge_mode: str = "last_row",
               drop_deletes: bool = True) -> ColumnarRows:
    """Sort by (sid, ts, seq); keep the highest-seq row per (sid, ts); drop
    rows whose winner is a delete. last_non_null additionally back-fills
    null fields from older duplicates of the same key."""
    order = np.lexsort((rows.seq, rows.ts, rows.sid))
    r = _slice_rows(rows, order)
    n = len(r)
    if n == 0:
        return r
    key_change = np.empty(n, dtype=bool)
    key_change[0] = True
    key_change[1:] = (r.sid[1:] != r.sid[:-1]) | (r.ts[1:] != r.ts[:-1])
    # winner of each key-run = its last row (highest seq)
    last_of_run = np.empty(n, dtype=bool)
    last_of_run[:-1] = key_change[1:]
    last_of_run[-1] = True

    if merge_mode == "last_non_null" and r.field_valid is not None:
        # propagate newest-non-null per field within each key-run
        run_id = np.cumsum(key_change) - 1
        for name, vals in r.fields.items():
            valid = r.field_valid[name]
            winners = np.nonzero(last_of_run)[0]
            for w in winners[~valid[last_of_run]]:
                rid = run_id[w]
                i = w - 1
                while i >= 0 and run_id[i] == rid:
                    if valid[i]:
                        vals[w] = vals[i]
                        valid[w] = True
                        break
                    i -= 1
    keep = last_of_run
    if drop_deletes:
        # only safe when the caller merged every file that can hold this
        # key; a compaction of part of a window keeps tombstones
        keep = keep & (r.op != OP_DELETE)
    return _slice_rows(r, keep)


class Region:
    """One region's rows. `store` None: the in-memory path (see the module
    docstring); else WAL under `wal_dir` (or `log_store`), SSTs and the
    manifest under `prefix` in `store`."""

    def __init__(self, meta: RegionMetadata, store=None,
                 wal_dir: str | None = None, *, prefix: str | None = None,
                 log_store=None, checkpoint_interval_edits: int | None = None,
                 cold_store=None):
        self.meta = meta
        self.store = store
        self._cold_store = cold_store
        # compaction pool, engine-wide options and merge device: wired by
        # the owning engine (a bare region compacts inline with defaults)
        self._compaction = None
        self._compaction_opts = None
        self.device = None
        self.prefix = prefix or f"data/region_{meta.region_id}"
        self.memtable = Memtable(meta.field_names,
                                 window_ms=self._memtable_window())
        self._frozen: list[Memtable] = []
        # intern deltas not yet on the log (skip_wal writes, failed
        # appends); the next WAL-on entry carries them, flush clears them
        self._pending_new_series: list[tuple[int, list[str]]] = []
        self._truncate_epoch = 0
        self._compactions = 0
        self._scan_cache: tuple | None = None  # (scan key, ColumnarRows)
        self.scan_cache_hits = 0
        self._lock = concurrency.RLock()
        self.writable = True
        # merge path ("fused", "device" or "host") and input rows of every
        # window merge, in order
        self.merge_paths: list[str] = []
        self.merge_rows_in: list[int] = []
        # per-stage recovery wall times and replayed entries of this open
        self.recovery_stats: dict = {
            "manifest_load_ms": 0.0, "wal_replay_ms": 0.0,
            "sst_restore_ms": 0.0, "replayed_entries": 0,
        }
        if store is None:
            self.wal = None
            self.manifest = None
            self._compacted: dict[int, ColumnarRows] = {}
            self.series = SeriesRegistry(meta.tag_names)
            self._seq = 0
            return
        from greptimedb_tpu_torch.storage import recovery as _recovery
        from greptimedb_tpu_torch.storage.manifest import RegionManifest
        from greptimedb_tpu_torch.storage.wal import RegionWal

        self.wal = (log_store if log_store is not None
                    else RegionWal(wal_dir, sync=meta.options.wal_sync))
        t0 = time.perf_counter()
        self.manifest = RegionManifest(
            store, f"{self.prefix}/manifest",
            checkpoint_distance=checkpoint_interval_edits,
        )
        ms = (time.perf_counter() - t0) * 1000.0
        self.recovery_stats["manifest_load_ms"] = ms
        _recovery.record_stage("manifest_load", ms)
        self.series = (
            SeriesRegistry.restore(self.manifest.state.series_snapshot)
            if self.manifest.state.series_snapshot
            else SeriesRegistry(meta.tag_names)
        )
        # tags added by ALTER after the last snapshot
        for t in meta.tag_names:
            if t not in self.series.tag_names:
                self.series.add_tag(t)
        self._seq = self.manifest.state.committed_sequence
        t1 = time.perf_counter()
        self.recovery_stats["replayed_entries"] = self._replay()
        ms = (time.perf_counter() - t1) * 1000.0
        self.recovery_stats["wal_replay_ms"] = ms
        _recovery.record_stage("wal_replay", ms)

    @classmethod
    def in_memory(cls, tag_names: list[str], field_names: list[str], *,
                  window_ms: int = DEFAULT_WINDOW_MS,
                  table: str = "") -> "Region":
        """The in-memory path's region: `window_ms` is its compaction
        window."""
        return cls(RegionMetadata(
            region_id=0, table=table, tag_names=list(tag_names),
            field_names=list(field_names), ts_name="ts",
            options=RegionOptions(memtable_window_ms=int(window_ms),
                                  compaction_window_ms=int(window_ms))))

    def _memtable_window(self):
        return self.meta.options.memtable_window_ms

    @property
    def durable(self) -> bool:
        return self.store is not None

    @property
    def data_version(self) -> tuple[int, int, int]:
        """Bumps with every write (the sequence) and every truncate or TTL
        purge. Flush-stable (a flush moves rows without changing them), so
        grid snapshots restored after a clean shutdown still match; the
        manifest's truncated_entry_id keeps it comparable across
        restarts."""
        trunc = (self.manifest.state.truncated_entry_id
                 if self.manifest is not None else -1)
        return (self._seq, self._truncate_epoch, trunc)

    @property
    def physical_version(self) -> tuple:
        """data_version extended with the manifest's version, which also
        moves on every manifest commit (flush, compaction, truncate); an
        in-memory region, which has no manifest, counts its compactions
        there. The result cache keys on it, so a cached result is never
        served across a physical change of the region, even one that
        keeps the row set."""
        edits = (self.manifest.version if self.manifest is not None
                 else self._compactions)
        return self.data_version + (edits,)

    @property
    def rows(self) -> int:
        """Rows held, before dedup."""
        n = self.memtable.rows + sum(t.rows for t in self._frozen)
        if self.store is None:
            return n + sum(len(r) for r in self._compacted.values())
        return n + sum(m.rows for m in self.manifest.state.ssts)

    # ------------------------------------------------------------------
    # tiered stores
    # ------------------------------------------------------------------
    @property
    def cold_store(self):
        """The cold tier's store: the configured one, or the raw store
        beneath a local read cache (cold data must not evict hot objects
        from it)."""
        if self._cold_store is not None:
            return self._cold_store
        from greptimedb_tpu_torch.storage.object_store import (
            CachedObjectStore,
        )

        if isinstance(self.store, CachedObjectStore):
            return self.store.inner
        return self.store

    def store_for_tier(self, tier: str):
        from greptimedb_tpu_torch.storage.sst import TIER_COLD

        return self.cold_store if tier == TIER_COLD else self.store

    def store_for(self, meta):
        """The store holding this SST (tier-aware reads and deletes)."""
        return self.store_for_tier(getattr(meta, "tier", "hot"))

    def raw_store_for(self, meta):
        """store_for beneath any local read cache: compaction and restore
        reads are read-once and must not churn the cache."""
        from greptimedb_tpu_torch.storage.object_store import (
            CachedObjectStore,
        )

        st = self.store_for(meta)
        return st.inner if isinstance(st, CachedObjectStore) else st

    # ------------------------------------------------------------------
    # write path
    # ------------------------------------------------------------------
    def write(self, tag_columns: dict[str, np.ndarray], ts: np.ndarray,
              fields: dict[str, np.ndarray], *,
              field_valid: dict[str, np.ndarray] | None = None,
              op: int = OP_PUT, skip_wal: bool = False) -> int:
        """Append rows; returns the assigned base sequence. The lock covers
        the sequence, the intern, the WAL append and the memtable insert:
        the log and the memtable must see writers in one order."""
        if not self.writable:
            raise RegionReadonlyError(
                f"region {self.meta.region_id} readonly")
        n = len(ts)
        with self._lock:
            base_seq = self._seq
            self._seq += n
            rows, new_series = self._make_rows(
                tag_columns, ts, fields, field_valid, op, base_seq)
            if self.wal is not None:
                if skip_wal:
                    self._pending_new_series.extend(new_series)
                else:
                    self._log(rows, fields, field_valid, op, base_seq,
                              new_series)
            self.memtable.append(rows)
            return base_seq

    def _log(self, rows, fields, field_valid, op, base_seq, new_series):
        """One WAL entry: sids and numeric columns as raw buffers, tag
        strings only for the series this batch created; only the caller's
        fields travel (replay back-fills the rest as _make_rows does)."""
        cols = {"__ts": rows.ts, "__sid": rows.sid}
        for k in fields:
            cols[f"__f_{k}"] = rows.fields[k]
        for k, v in (field_valid or {}).items():
            cols[f"__v_{k}"] = np.asarray(v, bool)
        delta = self._pending_new_series + list(new_series)
        payload = codec.encode_columns(cols, meta={
            "fmt": 2, "op": op, "base_seq": base_seq,
            "new_series": [[sid, tags] for sid, tags in delta],
        })
        try:
            self.wal.append(payload)
        except Exception:
            # the registry holds the delta already; a later entry must
            # report it again (ensure_series is idempotent on replay)
            self._pending_new_series.extend(new_series)
            raise
        self._pending_new_series = []

    def _make_rows(self, tag_columns, ts, fields, field_valid, op, base_seq):
        """Intern tags and normalize fields into sid-resolved rows.
        Returns (rows, new_series_delta)."""
        n = len(ts)
        sids, new_series = self.series.intern_rows_delta(
            [np.asarray(tag_columns[name]) if name in tag_columns
             else np.full(n, "", object) for name in self.meta.tag_names],
            n=n,
        )
        full_fields, valids = self._normalize_fields(n, fields, field_valid)
        rows = ColumnarRows(
            sid=sids,
            ts=np.asarray(ts, np.int64),
            seq=np.arange(base_seq, base_seq + n, dtype=np.uint64),
            op=np.full(n, op, dtype=np.uint8),
            fields=full_fields,
            field_valid=valids or None,
        )
        return rows, new_series

    def _normalize_fields(self, n, fields, field_valid):
        """Every schema field present; absent ones zero-filled + invalid."""
        full_fields = {}
        valids = dict(field_valid) if field_valid else {}
        for name in self.meta.field_names:
            if name in fields:
                full_fields[name] = np.asarray(fields[name])
            else:
                full_fields[name] = np.zeros(n, dtype=np.float64)
                valids[name] = np.zeros(n, dtype=bool)
        return full_fields, valids

    def delete(self, tag_columns: dict[str, np.ndarray],
               ts: np.ndarray) -> int:
        return self.write(tag_columns, ts, {}, op=OP_DELETE)

    def _replay(self) -> int:
        """Re-apply the WAL entries after the flushed id; returns the
        number replayed."""
        from_id = self.manifest.state.flushed_entry_id + 1
        seed = getattr(self.wal, "seed_floor", None)
        if seed is not None:
            # shared-topic logs: never hand out ids below the flushed
            # watermark even if truncation erased every physical entry
            seed(self.manifest.state.flushed_entry_id)
        replayed = 0
        for entry in self.wal.replay(from_id):
            replayed += 1
            cols, meta = codec.decode_columns(entry.payload)
            ts = cols.pop("__ts")
            base_seq = meta["base_seq"]
            for sid, tag_vals in meta.get("new_series", []):
                self.series.ensure_series(int(sid), list(tag_vals))
            n = len(ts)
            fields = {}
            valids = {}
            for k, v in cols.items():
                if k.startswith("__f_"):
                    fields[k[4:]] = v
                elif k.startswith("__v_"):
                    valids[k[4:]] = v
            full_fields, valids = self._normalize_fields(
                n, fields, valids or None)
            self.memtable.append(ColumnarRows(
                sid=np.asarray(cols["__sid"], np.int32),
                ts=np.asarray(ts, np.int64),
                seq=np.arange(base_seq, base_seq + n, dtype=np.uint64),
                op=np.full(n, meta["op"], dtype=np.uint8),
                fields=full_fields,
                field_valid=valids or None,
            ))
            self._seq = max(self._seq, base_seq + n)
        return replayed

    # ------------------------------------------------------------------
    # flush
    # ------------------------------------------------------------------
    @property
    def should_flush(self) -> bool:
        o = self.meta.options
        return (self.memtable.rows >= o.flush_rows
                or self.memtable.bytes >= o.flush_bytes)

    def flush(self):
        """Freeze the memtable, write an SST, commit the manifest, trim the
        WAL; returns the SST's SstMeta (None: nothing to flush, or the
        in-memory path, which has nothing to persist)."""
        if self.store is None:
            return None
        from greptimedb_tpu_torch.storage.sst import write_sst

        with self._lock:
            if self.memtable.is_empty:
                return None
            frozen = self.memtable
            self.memtable = Memtable(self.meta.field_names,
                                     window_ms=self._memtable_window())
            self._frozen.append(frozen)
            flushed_entry_id = self.wal.next_entry_id - 1
            seq_now = self._seq
        rows = frozen.scan()
        file_id = uuid.uuid4().hex
        meta = write_sst(
            self.store, f"{self.prefix}/sst/{file_id}.sst", file_id, rows,
            fulltext_fields=self.meta.fulltext_fields,
        )
        # the commit stays under the region lock by design: the SST
        # becoming visible and the frozen memtable going away are atomic
        # against a concurrent flush or truncate
        with self._lock:
            self.manifest.commit({
                "kind": "flush",
                "add_ssts": [meta.to_json()],
                "flushed_entry_id": flushed_entry_id,
                "committed_sequence": seq_now,
                "series_snapshot": self.series.snapshot(),
            })
            # the snapshot covers every live series: replay never needs
            # pre-flush intern deltas again
            self._pending_new_series = []
            self._frozen.remove(frozen)
            self.wal.obsolete(flushed_entry_id)
        return meta

    # ------------------------------------------------------------------
    # compaction
    # ------------------------------------------------------------------
    def compact(self, *, force: bool = False, device=None,
                verify: bool = False, merge_mode: str | None = None,
                kernels: str = "auto",
                device_min_rows: int = device_merge.DEFAULT_DEVICE_MIN_ROWS,
                kernel_min_rows: int = device_merge.DEFAULT_KERNEL_MIN_ROWS):
        """A durable region runs its triggered compactions (`force` merges
        every multi-file window) through the owning
        engine's pool, or inline when bare, and returns True if a merge
        committed; the merge options come from the engine's
        CompactionOptions. The in-memory path merges every window with
        memtable rows using the options given here and returns the
        number of windows merged."""
        if self.store is not None:
            from greptimedb_tpu_torch.storage.compaction import compact_once

            if self._compaction is not None:
                return self._compaction.compact_sync(self, force=force)
            return bool(compact_once(self, force=force))
        with self._lock:
            frozen = self.memtable
            self.memtable = Memtable(self.meta.field_names,
                                     window_ms=self._memtable_window())
        pending = frozen.partitions()
        if not pending:
            return 0
        mode = merge_mode or self.meta.options.merge_mode
        merged = 0
        for w in sorted(pending):
            prev = self._compacted.get(w)
            chunks = ([prev] if prev is not None else []) + pending[w]
            part = _concat_rows(chunks, self.meta.field_names)
            out, path = device_merge.merge_rows(
                part, merge_mode=mode, drop_deletes=True,
                device_min_rows=device_min_rows, verify=verify,
                device=device, kernels=kernels,
                kernel_min_rows=kernel_min_rows,
            )
            self._compacted[w] = out
            self.merge_paths.append(path)
            self.merge_rows_in.append(len(part))
            merged += 1
        with self._lock:
            self._compactions += 1
        return merged

    # ------------------------------------------------------------------
    # scan
    # ------------------------------------------------------------------
    def _scan_key(self) -> tuple:
        """What a merged-scan cache entry is valid for: the logical data,
        the compactions and the fields."""
        return (self.data_version, self._compactions,
                tuple(self.meta.field_names))

    def match_sids(self, matchers) -> np.ndarray:
        """Matched sids for a tag-matcher set, routed through the
        secondary tag index (index/): eq/in are posting lookups, re/ne
        evaluate over the distinct-value dictionary; results memoized per
        matcher set and validated against the registry version."""
        from greptimedb_tpu_torch import index as _index

        return _index.match_sids(self.series, matchers)

    def scan(self, field_names: list[str] | None = None, *,
             ts_min: int | None = None, ts_max: int | None = None,
             sids: np.ndarray | None = None,
             raw: bool = False,
             fulltext: list | None = None) -> ColumnarRows | None:
        """Merged + deduped rows sorted by (sid, ts), tombstones applied,
        cut to ts in [ts_min, ts_max] and the series in `sids` (None:
        unbounded). `raw` keeps every version (sorted by (sid, ts, seq)).
        `fulltext` is a list of (column, required terms) that lets the
        SST reads skip row groups by their fulltext sidecars."""
        if self.meta.options.ttl_ms is not None and ts_min is None:
            ts_min = int(time.time() * 1000) - self.meta.options.ttl_ms
        names = (field_names if field_names is not None
                 else self.meta.field_names)
        if fulltext is None and not raw:
            hit = self._scan_cached(names, ts_min, ts_max, sids)
            if hit is not None:
                return hit
        with self._lock:
            tables = [self.memtable] + list(self._frozen)
            if self.store is None:
                stored = [self._compacted[w] for w in sorted(self._compacted)]
                ssts = []
            else:
                stored = []
                ssts = list(self.manifest.state.ssts)
            # key captured with the snapshot: a write landing during the
            # merge below is never stamped as included in the cache
            snap_key = self._scan_key()
            scan_names = names
            if (sids is None and fulltext is None and not raw
                    and ts_min is None and ts_max is None):
                approx = (sum(t.rows for t in tables)
                          + sum(len(r) for r in stored)
                          + sum(m.rows for m in ssts))
                if (approx >= _SCAN_CACHE_MIN_ROWS
                        and set(names) != set(self.meta.field_names)):
                    # cache-build candidate: read every field once so
                    # alternating projections all hit the same entry
                    scan_names = list(self.meta.field_names)
        if self.store is None:
            rows = self._scan_memory(tables, stored, scan_names, ts_min,
                                     ts_max, sids, raw)
        else:
            # fulltext row-group pruning is VALUE-based: under last-write-
            # wins dedup, skipping a group that holds a newer overwrite or
            # tombstone would resurrect the shadowed row. Append-mode
            # regions (the log-table shape fulltext serves) have no dedup,
            # so pruning is sound there; everywhere else the residual
            # filter alone does the matching.
            ft = fulltext if self.meta.options.append_mode else None
            rows = self._scan_durable(tables, ssts, scan_names, ts_min,
                                      ts_max, sids, raw, ft)
        if rows is None:
            return None
        if (not raw and fulltext is None
                and self._maybe_cache_scan(snap_key, rows, ts_min,
                                           ts_max, sids)):
            # the cached container never escapes
            rows = _shallow_rows(rows, names)
        elif scan_names is not names:
            rows = _shallow_rows(rows, names)
        return rows if len(rows) else None

    def _scan_memory(self, tables, stored, names, ts_min, ts_max, sids,
                     raw):
        pending = [c for t in tables for c in t.chunks()]
        chunks = [c for c in stored + pending if len(c)]
        if not chunks:
            return None
        rows = _select_rows(_concat_rows(chunks, names), ts_min, ts_max,
                            sids)
        if raw:
            return _slice_rows(rows, np.lexsort((rows.seq, rows.ts,
                                                 rows.sid)))
        if pending:
            return dedup_rows(rows, merge_mode=self.meta.options.merge_mode)
        # compacted windows are deduped, tombstone-free, (sid, ts)-sorted
        # within the window, and concatenated in time order: a stable sort
        # by sid alone yields (sid, ts) order, as dedup_rows would
        return _slice_rows(rows, np.argsort(rows.sid, kind="stable"))

    def _scan_durable(self, tables, ssts, names, ts_min, ts_max, sids, raw,
                      fulltext=None):
        from greptimedb_tpu_torch.index.tag_index import count_pruned
        from greptimedb_tpu_torch.query import stats as _stats
        from greptimedb_tpu_torch.storage.sst import read_sst

        chunks: list[ColumnarRows] = []
        smin = smax = None
        if sids is not None and len(sids):
            smin = int(sids.min())
            smax = int(sids.max())
        for meta in ssts:
            if smin is not None and (meta.sid_max < smin
                                     or meta.sid_min > smax):
                # the manifest's sid range misses the matched set: the
                # file is skipped without opening it
                _stats.add("index_ssts_skipped", 1)
                count_pruned(bytes_=meta.size_bytes, scope="sst")
                continue
            r = read_sst(self.store_for(meta), meta, ts_min=ts_min,
                         ts_max=ts_max, field_names=names, sids=sids,
                         fulltext=fulltext)
            if r is not None:
                chunks.append(r)
        for mt in tables:
            r = mt.scan(ts_min, ts_max, names)
            if r is not None:
                if sids is not None:
                    sel = np.isin(r.sid, sids)
                    r = _slice_rows(r, sel) if not sel.all() else r
                if len(r):
                    chunks.append(r)
        if not chunks:
            return None
        # always normalize through _concat_rows: it back-fills fields a
        # chunk does not have
        only = chunks[0] if len(chunks) == 1 else None
        if only is not None and all(n in only.fields for n in names):
            rows = only
        else:
            rows = _concat_rows(chunks, names)
        if not raw and not self.meta.options.append_mode:
            return dedup_rows(rows, merge_mode=self.meta.options.merge_mode)
        return _slice_rows(rows, np.lexsort((rows.seq, rows.ts, rows.sid)))

    def _scan_cached(self, names, ts_min, ts_max,
                     sids=None) -> ColumnarRows | None:
        cached = self._scan_cache
        if cached is None:
            return None
        if cached[0] != self._scan_key():
            # a stale entry can never be served again: release its arrays
            _scan_pool.drop(self)
            return None
        rows: ColumnarRows = cached[1]
        if any(n not in rows.fields for n in names):
            return None
        _scan_pool.touch(self)
        self.scan_cache_hits += 1
        out = _shallow_rows(rows, names)
        if sids is not None:
            # cached rows are (sid, ts)-sorted: each matched series is
            # one contiguous run; runs expand vectorized
            lo_idx = np.searchsorted(out.sid, sids, side="left")
            hi_idx = np.searchsorted(out.sid, sids, side="right")
            lens = hi_idx - lo_idx
            nz = lens > 0
            starts = lo_idx[nz].astype(np.int64)
            lens = lens[nz].astype(np.int64)
            total = int(lens.sum())
            if total:
                run_base = np.concatenate(([0], np.cumsum(lens)[:-1]))
                idx = (np.repeat(starts - run_base, lens)
                       + np.arange(total, dtype=np.int64))
            else:
                idx = np.zeros(0, np.int64)
            out = _slice_rows(out, idx)
        out = _select_rows(out, ts_min, ts_max, None)
        return out if len(out) else None

    def _maybe_cache_scan(self, snap_key, rows, ts_min, ts_max,
                          sids) -> bool:
        """Cache an unbounded scan; hits serve any field subset of it."""
        if (sids is not None or ts_min is not None or ts_max is not None
                or len(rows) < _SCAN_CACHE_MIN_ROWS):
            return False
        nbytes = _rows_nbytes(rows)
        if nbytes > _scan_pool.budget:
            return False
        _scan_pool.store(self, (snap_key, rows), nbytes)
        return True

    def invalidate_scan_cache(self):
        """Drop the merged-scan cache entry (for a change the key does not
        see)."""
        _scan_pool.drop(self)

    # ------------------------------------------------------------------
    def truncate(self):
        from greptimedb_tpu_torch.storage.sst import delete_sst

        with self._lock:
            _scan_pool.drop(self)
            self._truncate_epoch += 1
            self.memtable = Memtable(self.meta.field_names,
                                     window_ms=self._memtable_window())
            self._frozen.clear()
            if self.store is None:
                self._compacted.clear()
                return
            entry_id = self.wal.next_entry_id - 1
            for s in self.manifest.state.ssts:
                delete_sst(self.store_for(s), s)
            self.manifest.commit({
                "kind": "truncate",
                "truncated_entry_id": entry_id,
                "series_snapshot": self.series.snapshot(),
            })
            self.wal.obsolete(entry_id)

    def close(self):
        _scan_pool.drop(self)
        if self.wal is not None:
            self.wal.close()
