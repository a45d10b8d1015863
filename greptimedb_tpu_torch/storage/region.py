"""A minimal in-memory region: appended runs, per-window compaction on the
card, and a merged scan with the merged-scan cache.

Each write appends one run with rising sequence numbers. `compact` merges,
per time window, every pending run of that window together with the
window's earlier compacted output through device_merge.merge_rows — the
merge covers every row the window holds, so tombstones can be dropped.
There is no WAL, no SST and no manifest in this slice: compacted windows
stay in host memory.

`dedup_rows` is the host reference merge (copied from the JAX package).

The merged-scan cache (the JAX package's `_ScanCachePool`): an unbounded
scan of at least `_SCAN_CACHE_MIN_ROWS` rows keeps its merged, deduped
row set on the region, keyed by the region's data version, its
compaction count and its field names, so a repeated full-table scan (the
TSBS high-cpu row filters) pays only its own filter and projection. A
write, a delete or a compaction changes the key; `invalidate_scan_cache`
drops the entry explicitly.
"""

from __future__ import annotations

import threading

import numpy as np

from greptimedb_tpu_torch.storage import device_merge
from greptimedb_tpu_torch.storage.memtable import (
    OP_DELETE,
    OP_PUT,
    ColumnarRows,
    _concat_rows,
    _slice_rows,
)
from greptimedb_tpu_torch.storage.series import SeriesRegistry

DEFAULT_WINDOW_MS = 3_600_000

_SCAN_CACHE_MIN_ROWS = 1_000_000         # below this a cold scan is cheap
_SCAN_CACHE_TOTAL_BYTES = 6 * 1024**3    # global LRU budget


class _ScanCachePool:
    """Tracks cached-scan bytes across regions; LRU-evicts over budget."""

    def __init__(self, budget: int):
        self.budget = budget
        self._lock = threading.Lock()
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
        keep = keep & (r.op != OP_DELETE)
    return _slice_rows(r, keep)


class Region:
    """One region's rows: pending runs plus compacted per-window output."""

    def __init__(self, tag_names: list[str], field_names: list[str], *,
                 window_ms: int = DEFAULT_WINDOW_MS):
        self.tag_names = list(tag_names)
        self.field_names = list(field_names)
        self.window_ms = int(window_ms)
        self.series = SeriesRegistry(tag_names)
        self._pending: list[ColumnarRows] = []
        self._compacted: dict[int, ColumnarRows] = {}
        self._seq = 0
        self._compactions = 0
        self._scan_cache: tuple | None = None  # (scan key, ColumnarRows)
        self.scan_cache_hits = 0
        self._lock = threading.Lock()
        self.merge_paths: list[str] = []

    @property
    def data_version(self) -> int:
        """Bumps with every write (the sequence); compaction moves rows
        without changing the logical row set, so it leaves this alone."""
        return self._seq

    @property
    def rows(self) -> int:
        return (sum(len(r) for r in self._pending)
                + sum(len(r) for r in self._compacted.values()))

    def write(self, tag_columns: dict[str, np.ndarray], ts: np.ndarray,
              fields: dict[str, np.ndarray], *,
              field_valid: dict[str, np.ndarray] | None = None,
              op: int = OP_PUT) -> int:
        """Append one run; returns its base sequence. Missing fields are
        zero-filled and marked invalid."""
        n = len(ts)
        with self._lock:
            base_seq = self._seq
            self._seq += n
            sids = self.series.intern_rows(
                [np.asarray(tag_columns[name]) if name in tag_columns
                 else np.full(n, "", object) for name in self.tag_names],
                n=n,
            )
            full_fields = {}
            valids = dict(field_valid) if field_valid else {}
            for name in self.field_names:
                if name in fields:
                    full_fields[name] = np.asarray(fields[name])
                else:
                    full_fields[name] = np.zeros(n, dtype=np.float64)
                    valids[name] = np.zeros(n, dtype=bool)
            self._pending.append(ColumnarRows(
                sid=sids,
                ts=np.asarray(ts, np.int64),
                seq=np.arange(base_seq, base_seq + n, dtype=np.uint64),
                op=np.full(n, op, dtype=np.uint8),
                fields=full_fields,
                field_valid=valids or None,
            ))
            return base_seq

    def compact(self, *, device=None, verify: bool = False,
                merge_mode: str = "last_row", kernels: str = "auto",
                device_min_rows: int = device_merge.DEFAULT_DEVICE_MIN_ROWS,
                kernel_min_rows: int = device_merge.DEFAULT_KERNEL_MIN_ROWS,
                ) -> int:
        """Merge every window that has pending runs; returns the number of
        windows merged. Each window's merge path lands in merge_paths."""
        with self._lock:
            pending, self._pending = self._pending, []
        if not pending:
            return 0
        # bucket runs by window; only a run that straddles windows is split
        by_win: dict[int, list[ColumnarRows]] = {}
        for run in pending:
            if len(run) == 0:
                continue
            wins = run.ts // self.window_ms
            lo, hi = int(wins.min()), int(wins.max())
            if lo == hi:
                by_win.setdefault(lo, []).append(run)
                continue
            for w in np.unique(wins):
                by_win.setdefault(int(w), []).append(
                    _slice_rows(run, wins == w))
        merged = 0
        for w in sorted(by_win):
            prev = self._compacted.get(w)
            chunks = ([prev] if prev is not None else []) + by_win[w]
            part = _concat_rows(chunks, self.field_names)
            out, path = device_merge.merge_rows(
                part, merge_mode=merge_mode, drop_deletes=True,
                device_min_rows=device_min_rows, verify=verify,
                device=device, kernels=kernels,
                kernel_min_rows=kernel_min_rows,
            )
            self._compacted[w] = out
            self.merge_paths.append(path)
            merged += 1
        with self._lock:
            self._compactions += 1
        return merged

    def _scan_key(self) -> tuple:
        """What a merged-scan cache entry is valid for: the logical data
        (every write bumps the sequence), the compactions and the
        fields."""
        return (self._seq, self._compactions, tuple(self.field_names))

    def scan(self, field_names: list[str] | None = None, *,
             ts_min: int | None = None, ts_max: int | None = None,
             sids: np.ndarray | None = None) -> ColumnarRows | None:
        """Merged + deduped rows sorted by (sid, ts), tombstones applied,
        cut to ts in [ts_min, ts_max] and the series in `sids` (None:
        unbounded)."""
        names = field_names if field_names is not None else self.field_names
        hit = self._scan_cached(names, ts_min, ts_max, sids)
        if hit is not None:
            return hit
        with self._lock:
            pending = list(self._pending)
            windows = [self._compacted[w] for w in sorted(self._compacted)]
            # key captured with the snapshot: a write landing during the
            # merge below is never stamped as included in the cache
            snap_key = self._scan_key()
            scan_names = names
            if sids is None and ts_min is None and ts_max is None:
                approx = (sum(len(r) for r in pending)
                          + sum(len(r) for r in windows))
                if (approx >= _SCAN_CACHE_MIN_ROWS
                        and set(names) != set(self.field_names)):
                    # cache-build candidate: read every field once so
                    # alternating projections all hit the same entry
                    scan_names = list(self.field_names)
        chunks = [c for c in windows + pending if len(c)]
        if not chunks:
            return None
        rows = _select_rows(_concat_rows(chunks, scan_names), ts_min, ts_max,
                            sids)
        if pending:
            rows = dedup_rows(rows)
        else:
            # compacted windows are deduped, tombstone-free, (sid, ts)-
            # sorted within the window, and concatenated in time order: a
            # stable sort by sid alone yields (sid, ts) order, as
            # dedup_rows would
            rows = _slice_rows(rows, np.argsort(rows.sid, kind="stable"))
        if self._maybe_cache_scan(snap_key, rows, ts_min, ts_max, sids):
            # the cached container never escapes
            rows = _shallow_rows(rows, names)
        elif scan_names is not names:
            rows = _shallow_rows(rows, names)
        return rows if len(rows) else None

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
