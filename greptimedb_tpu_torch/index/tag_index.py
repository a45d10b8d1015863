"""Per-region secondary tag index: tag-value -> sid postings (a copy of
the JAX package's index/tag_index.py).

The capability analog of upstream's inverted index appliers (src/index
and the puffin blobs mito2 attaches to SSTs): instead of a separate
on-disk index format, the postings are derived from the dictionary-coded
label plane the series registry already maintains — per tag column, a
CSR (offsets, order) pair where order is the stable argsort of that
column's codes, so the sids for one tag value are a contiguous ascending
slice.

Matcher evaluation splits into two domains:

- `eq`/`in` matchers resolve a value to its dictionary code and read the
  posting slice — no per-series work at all.
- `re`/`nre`/`ne`/`nin` matchers evaluate once per DISTINCT value
  (series.ok_codes_for — the same code match_mask broadcasts through),
  then expand the accepting codes through the postings. String/regex
  cost scales with value cardinality, not series cardinality.

The most selective matcher (estimated from posting lengths) seeds the
candidate set; the rest filter candidates by indexing their ok-tables
with the candidates' codes — O(|candidates|) int work per matcher.

Maintenance is incremental and version-validated like the scan cache:
sids are dense and append-only, so postings built at registry version v
cover a sid PREFIX; series registered since are evaluated directly
(O(delta)) until the delta crosses `rebuild_threshold` and the CSR is
rebuilt. ALTER ADD TAG (column-count change) always rebuilds. Matched
sid sets are memoized per canonical matcher key, keyed on the registry
version.

Lookups count in `gtpu_index_lookups_total{path}` and pruned scan data
in `gtpu_index_pruned_row_groups_total` and
`gtpu_index_pruned_bytes_total{scope}` (`lookup_counts` and
`pruned_counts` read them); every live index reports as the `tag_index`
host pool of the memory ledger (`pool_stats`). The per-query notes (`index_lookups`, `index_pruned_bytes`,
`index_pruned_row_groups`) go to query/stats as in the JAX package.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict

import numpy as np

from greptimedb_tpu_torch import concurrency
from greptimedb_tpu_torch.storage.series import missing_tag_ok, ok_codes_for
from greptimedb_tpu_torch.telemetry.metrics import global_registry

_CFG = {
    "enable": True,
    # device-resident label plane (index/device_plane.py)
    "device_plane": True,
    # per-index memoized (matcher-set -> sids) entries
    "result_cache_entries": 256,
    # series registered since the last CSR build before a rebuild;
    # below it the delta tail is evaluated directly per lookup
    "rebuild_threshold": 4096,
}


def configure(section: dict | None) -> None:
    """Apply an [index] config section (a plain dict of the knobs above)."""
    for k, v in (section or {}).items():
        if k in _CFG:
            _CFG[k] = v
    if not _CFG["device_plane"] or not _CFG["enable"]:
        from greptimedb_tpu_torch.index import device_plane

        device_plane.invalidate()


def enabled() -> bool:
    return bool(_CFG["enable"])


def device_plane_enabled() -> bool:
    return bool(_CFG["enable"]) and bool(_CFG["device_plane"])


def matcher_key(matchers) -> tuple:
    """Canonical hashable key for a matcher set: compiled regexes fold
    to their pattern string, list values to sorted tuples. Order-sensitive
    (matcher sets arrive in plan order, which is stable per statement)."""
    out = []
    for name, op, value in matchers:
        if op in ("re", "nre"):
            v = getattr(value, "pattern", value)
        elif isinstance(value, (list, tuple, set, frozenset)):
            v = tuple(sorted(str(x) for x in value))
        else:
            v = value
        out.append((name, op, v))
    return tuple(out)


def _expand_csr(offsets: np.ndarray, order: np.ndarray,
                codes: np.ndarray) -> np.ndarray:
    """Gather the concatenated posting slices for `codes` (vectorized
    multi-slice CSR expand — no per-code Python loop)."""
    if len(codes) == 0:
        return np.zeros(0, dtype=np.int32)
    starts = offsets[codes]
    lens = offsets[codes + 1] - starts
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int32)
    pos = np.repeat(starts - (np.cumsum(lens) - lens), lens)
    return order[pos + np.arange(total, dtype=np.int64)]


class TagIndex:
    """Secondary index over one SeriesRegistry (see module docstring)."""

    def __init__(self, registry):
        self._reg = registry
        self._lock = concurrency.Lock()
        self._built_version = -1
        self._built_rows = 0
        self._built_tags = 0
        # per tag column: (offsets int64 (nvals+1,), order int32) over
        # the first _built_rows sids
        self._postings: list[tuple[np.ndarray, np.ndarray]] = []
        self._results: OrderedDict[tuple, tuple[int, np.ndarray]] = (
            OrderedDict()
        )
        self._hits = 0
        self._misses = 0
        self._builds = 0
        _track(self)

    # -- maintenance ---------------------------------------------------
    def _ensure_built(self, codes: np.ndarray, version: int) -> int:
        """Bring postings up to date for the (n, k) snapshot `codes`;
        returns the prefix length the CSR covers. Caller holds no lock —
        builds race benignly (last writer wins, both are correct)."""
        n, k = codes.shape
        if version == self._built_version and k == self._built_tags:
            return self._built_rows
        if (k == self._built_tags and self._built_rows <= n
                and n - self._built_rows <= int(_CFG["rebuild_threshold"])):
            # delta tail small: validate the version without rebuilding
            # (lookups evaluate sids >= _built_rows directly)
            self._built_version = version
            return self._built_rows
        dicts = self._reg.dicts
        postings = []
        for i in range(k):
            col = codes[:, i]
            nvals = max(len(dicts[i]) if i < len(dicts) else 0,
                        int(col.max()) + 1 if n else 0)
            counts = np.bincount(col, minlength=nvals)
            offsets = np.zeros(len(counts) + 1, dtype=np.int64)
            np.cumsum(counts, out=offsets[1:])
            # stable argsort keeps original (ascending-sid) order within
            # each code, so every posting slice is already sorted
            order = np.argsort(col, kind="stable").astype(np.int32)
            postings.append((offsets, order))
        with self._lock:
            self._postings = postings
            self._built_rows = n
            self._built_tags = k
            self._built_version = version
            self._builds += 1
        return n

    # -- lookup --------------------------------------------------------
    def match_sids(self, matchers) -> np.ndarray:
        """Sids satisfying all matchers, ascending int32 — bit-identical
        to SeriesRegistry.match_sids by construction (same ok-code
        tables, broadcast through postings instead of the full plane)."""
        from greptimedb_tpu_torch.query import stats

        reg = self._reg
        version = reg.version
        key = matcher_key(matchers)
        with self._lock:
            hit = self._results.get(key)
            if hit is not None and hit[0] == version:
                self._results.move_to_end(key)
                self._hits += 1
                _count_lookup("cache")
                stats.add("index_lookups", 1)
                return hit[1]
            self._misses += 1
        sids = self._eval(matchers, version)
        with self._lock:
            self._results[key] = (version, sids)
            self._results.move_to_end(key)
            cap = int(_CFG["result_cache_entries"])
            while len(self._results) > max(cap, 1):
                self._results.popitem(last=False)
        _count_lookup("postings")
        stats.add("index_lookups", 1)
        return sids

    def match_mask(self, matchers) -> np.ndarray:
        """(num_series,) bool mask via the index (postings expanded back
        into a dense mask — what the device plane's ok-tables mirror)."""
        n = self._reg.num_series
        mask = np.zeros(n, dtype=bool)
        sids = self.match_sids(matchers)
        mask[sids[sids < n]] = True
        return mask

    def _eval(self, matchers, version: int) -> np.ndarray:
        reg = self._reg
        codes = reg.codes_matrix()
        n, k = codes.shape
        empty = np.zeros(0, dtype=np.int32)
        if n == 0:
            return empty
        tag_names = reg.tag_names
        dicts = reg.dicts
        # dictionary-domain pass: one ok-table per matcher
        cols: list[int] = []
        oks: list[np.ndarray] = []
        for name, op, value in matchers:
            if name not in tag_names:
                if not missing_tag_ok(op, value):
                    return empty
                continue  # constant-true: no constraint
            i = tag_names.index(name)
            vals = np.asarray(list(dicts[i].values), dtype=object)
            ok = ok_codes_for(vals, op, value)
            if not ok.any():
                return empty
            cols.append(i)
            oks.append(ok)
        if not cols:
            return np.arange(n, dtype=np.int32)
        built = self._ensure_built(codes, version)
        postings = self._postings
        # seed candidates from the most selective matcher (estimated
        # from posting lengths over the built prefix)
        seed = 0
        if built and postings:
            best = None
            for j, (i, ok) in enumerate(zip(cols, oks)):
                offsets, _ = postings[i]
                nv = min(len(ok), len(offsets) - 1)
                est = int(
                    (offsets[1:nv + 1] - offsets[:nv])[ok[:nv]].sum()
                )
                if best is None or est < best:
                    best, seed = est, j
            offsets, order = postings[cols[seed]]
            ok = oks[seed]
            nv = min(len(ok), len(offsets) - 1)
            cs = np.flatnonzero(ok[:nv]).astype(np.int64)
            cand = _expand_csr(offsets, order, cs)
            if len(cs) > 1:
                # each posting slice is ascending; a multi-code union
                # needs one merge sort to restore global sid order
                cand = np.sort(cand)
        else:
            cand = np.arange(built, dtype=np.int32)
        # remaining matchers filter candidates through their ok-tables
        for j, (i, ok) in enumerate(zip(cols, oks)):
            if built and postings and j == seed:
                continue
            if len(cand) == 0:
                break
            c = codes[cand, i]
            safe = np.minimum(c, len(ok) - 1)
            cand = cand[ok[safe] & (c < len(ok))]
        # delta tail (sids registered since the CSR build): direct
        # evaluation over O(delta) rows
        if built < n:
            keep = np.ones(n - built, dtype=bool)
            for i, ok in zip(cols, oks):
                c = codes[built:, i]
                safe = np.minimum(c, len(ok) - 1)
                keep &= ok[safe] & (c < len(ok))
            tail = (np.flatnonzero(keep) + built).astype(np.int32)
            if len(tail):
                cand = np.concatenate([cand.astype(np.int32), tail])
        return np.ascontiguousarray(cand, dtype=np.int32)

    # -- observability -------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "built_rows": self._built_rows,
                "built_version": self._built_version,
                "builds": self._builds,
                "hits": self._hits,
                "misses": self._misses,
                "cached_results": len(self._results),
                "bytes": self.nbytes(),
            }

    def nbytes(self) -> int:
        total = 0
        for offsets, order in self._postings:
            total += int(offsets.nbytes) + int(order.nbytes)
        for _, sids in self._results.values():
            total += int(sids.nbytes)
        return total


# ---------------------------------------------------------------------
# registry -> index association, the process counters and the host pool
# ---------------------------------------------------------------------
_INDEXES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_INDEXES_LOCK = concurrency.Lock()
# separate from _INDEXES_LOCK: TagIndex.__init__ runs under it (via
# index_for) and _track must not re-acquire the same non-reentrant lock
_POOL_LOCK = concurrency.Lock()
_POOL_REGISTERED = False
_LIVE: "weakref.WeakSet[TagIndex]" = weakref.WeakSet()

# the gtpu_index_* counters register at their first count, as the JAX
# package's do (a process that never looked up exports none)
def _lookups():
    return global_registry.counter(
        "gtpu_index_lookups_total",
        "Secondary tag-index matcher lookups by path "
        "(cache | postings | host)",
        labels=("path",),
    )


def _pruned_row_groups():
    return global_registry.counter(
        "gtpu_index_pruned_row_groups_total",
        "Row groups skipped by the secondary-index sid pruning",
    )


def _pruned_bytes():
    return global_registry.counter(
        "gtpu_index_pruned_bytes_total",
        "Bytes skipped by secondary-index sid pruning "
        "(sst = whole files via the manifest sid range, "
        "row_group = row groups via the SST sid index)",
        labels=("scope",),
    )


def _value(name: str, *labels) -> float:
    try:
        return global_registry.get(name).labels(*labels).value
    except KeyError:
        return 0.0


class _IndexPool:
    """Memory-ledger surface over every live TagIndex (host tier)."""

    def stats(self) -> dict:
        total = entries = hits = misses = 0
        for ix in list(_LIVE):
            s = ix.stats()
            total += s["bytes"]
            entries += s["cached_results"]
            hits += s["hits"]
            misses += s["misses"]
        return {
            "bytes": total, "entries": entries, "budget_bytes": 0,
            "hits": hits, "misses": misses, "evictions": 0,
        }


_POOL = _IndexPool()


def _track(ix: "TagIndex") -> None:
    global _POOL_REGISTERED
    _LIVE.add(ix)
    with _POOL_LOCK:
        if _POOL_REGISTERED:
            return
        _POOL_REGISTERED = True
    from greptimedb_tpu_torch.telemetry import memory as _memory

    _memory.register_pool("tag_index", "host", _POOL,
                          stats=_IndexPool.stats)


def pool_stats() -> dict:
    """The `tag_index` host pool: bytes, cached results and hits over
    every live TagIndex."""
    return _POOL.stats()


def lookup_counts() -> dict:
    """Matcher lookups by path (cache | postings | host), read from
    `gtpu_index_lookups_total`."""
    return {p: _value("gtpu_index_lookups_total", p)
            for p in ("cache", "postings", "host")}


def pruned_counts() -> dict:
    """Row groups and bytes skipped by sid pruning, read from the
    `gtpu_index_pruned_*` counters."""
    return {"row_groups": _value("gtpu_index_pruned_row_groups_total"),
            "bytes_sst": _value("gtpu_index_pruned_bytes_total", "sst"),
            "bytes_row_group": _value("gtpu_index_pruned_bytes_total",
                                      "row_group")}


def _count_lookup(path: str) -> None:
    _lookups().labels(path).inc()


def count_pruned(*, row_groups: int = 0, bytes_: int = 0,
                 scope: str = "row_group") -> None:
    """Record scan data skipped by sid-range/sid-index pruning, in the
    per-query ExecStats (EXPLAIN ANALYZE) and the process counters.
    scope: "row_group" (SST sid index) | "sst" (manifest sid range)."""
    from greptimedb_tpu_torch.query import stats

    if row_groups:
        stats.add("index_pruned_row_groups", row_groups)
        _pruned_row_groups().inc(row_groups)
    if bytes_:
        stats.add("index_pruned_bytes", bytes_)
        _pruned_bytes().labels(scope).inc(bytes_)


def index_for(registry) -> TagIndex:
    """The TagIndex for a registry (one per registry, weakly held — a
    region swapping its registry on replay/restore drops the old index
    with it)."""
    with _INDEXES_LOCK:
        ix = _INDEXES.get(registry)
        if ix is None:
            ix = TagIndex(registry)
            _INDEXES[registry] = ix
        return ix


def match_sids(registry, matchers) -> np.ndarray:
    """Route a matcher lookup through the secondary index when enabled;
    the registry's full-plane compare is the fallback (and the oracle
    the index tests equate against)."""
    if not matchers:
        return np.arange(registry.num_series, dtype=np.int32)
    if not _CFG["enable"]:
        _count_lookup("host")
        return registry.match_sids(matchers)
    return index_for(registry).match_sids(matchers)


def match_mask(registry, matchers) -> np.ndarray:
    """Dense bool mask counterpart of match_sids (PromQL grid path)."""
    if not matchers:
        return np.ones(registry.num_series, dtype=bool)
    if not _CFG["enable"]:
        _count_lookup("host")
        return registry.match_mask(matchers)
    return index_for(registry).match_mask(matchers)
