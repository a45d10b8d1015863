"""Decoded row-group cache for SST reads (the JAX package's
storage/page_cache.py over the port's SST format).

Selective queries that revisit the same row groups skip the decode. Keys
are (sst_path, row_group, column); SSTs are immutable, so entries never
invalidate, and a byte budget evicts the least recently used columns.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from greptimedb_tpu_torch import concurrency

_DEFAULT_CAPACITY = 256 * 1024 * 1024


class PageCache:
    def __init__(self, capacity_bytes: int = _DEFAULT_CAPACITY):
        self.capacity = capacity_bytes
        self._lock = concurrency.Lock()
        self._entries: OrderedDict[tuple, tuple] = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: tuple):
        """-> (values, validity|None) or None."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return entry[0]

    def put(self, key: tuple, value, nbytes: int):
        if nbytes > self.capacity:
            return
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = (value, nbytes)
            self._bytes += nbytes
            while self._bytes > self.capacity and self._entries:
                _, (_, b) = self._entries.popitem(last=False)
                self._bytes -= b
                self.evictions += 1

    def put_free(self, key: tuple, value, nbytes: int) -> bool:
        """Install only while FREE budget remains, never evicting: the
        recovery restore warms the cache with this so a large restore
        cannot push out hot scan data. False once the entry would not
        fit."""
        with self._lock:
            if key in self._entries:
                return True
            if self._bytes + nbytes > self.capacity:
                return False
            self._entries[key] = (value, nbytes)
            self._bytes += nbytes
            return True

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    @property
    def bytes(self) -> int:
        return self._bytes


global_page_cache = PageCache()


def _col_nbytes(values: np.ndarray, validity) -> int:
    n = values.nbytes if values.dtype != object else sum(
        len(str(v)) + 48 for v in values
    )
    if validity is not None:
        n += validity.nbytes
    return n


def read_columns(sst, path: str, groups: list[int], cols: list[str]):
    """Read `cols` over `groups` of the SstFile `sst`, column by group
    through the global cache. Returns {col: (values, validity|None)} with
    arrays concatenated across groups in order."""
    from greptimedb_tpu_torch.query import stats

    per_col: dict[str, list] = {c: [] for c in cols}
    n_miss = 0
    for g in groups:
        for c in cols:
            key = (path, g, c)
            hit = global_page_cache.get(key)
            if hit is None:
                n_miss += 1
                hit = sst.column(g, c)
                global_page_cache.put(key, hit, _col_nbytes(*hit))
            per_col[c].append(hit)
    stats.add("page_cache_hit_cols", len(groups) * len(cols) - n_miss)
    stats.add("page_cache_miss_cols", n_miss)
    out = {}
    for c in cols:
        parts = per_col[c]
        if len(parts) == 1:
            out[c] = parts[0]
            continue
        values = np.concatenate([p[0] for p in parts])
        if any(p[1] is not None for p in parts):
            validity = np.concatenate([
                p[1] if p[1] is not None else np.ones(len(p[0]), bool)
                for p in parts])
        else:
            validity = None
        out[c] = (values, validity)
    return out
