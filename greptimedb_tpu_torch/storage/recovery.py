"""Recovery dataplane: pipelined SST restore + per-stage timings (the JAX
package's storage/recovery.py).

- ``RecoveryOptions`` — the ``[recovery]`` knobs shared by the engine and
  the callers that build one.
- ``restore_region_ssts`` — the pipelined fetch/verify/decode of a
  region's manifest SSTs with a bounded readahead window. Fetches are
  ranged gets of exactly the manifest's ``size_bytes``; a short read is a
  torn object and raises the typed :class:`SstRestoreError` naming the
  file. Decoded columns install into the in-process page cache only while
  it has FREE budget (restore never evicts hot scan data), and
  cache-backed stores (``CachedObjectStore``) are bypassed exactly like
  the WAL bypasses them: restore is write-once/read-once.
- stage totals — cumulative milliseconds per recovery stage in
  ``gtpu_recovery_stage_ms_total`` (``stage_totals`` reads them), each
  also an event span on the active trace.
"""

from __future__ import annotations

import logging
import threading
import time

from collections import deque
from dataclasses import dataclass

from greptimedb_tpu_torch import concurrency
from greptimedb_tpu_torch.errors import SstRestoreError
from greptimedb_tpu_torch.telemetry.metrics import global_registry

_log = logging.getLogger("greptimedb_tpu_torch.storage.recovery")

# 0 = auto: min(8, regions in the batch)
DEFAULT_OPEN_PARALLELISM = 0
DEFAULT_SST_PREFETCH_DEPTH = 4
DEFAULT_CHECKPOINT_INTERVAL = 64
# transient ranged-get failures (flaky remote store) retry this many
# times before surfacing a typed restore error
_FETCH_RETRIES = 2
# per-region cap on raw SST bytes held by the readahead window: depth
# bounds the FILE count, this bounds the MEMORY; at least one fetch is
# always in flight regardless of size
_RESTORE_WINDOW_BYTES = 256 * 1024 * 1024

# recovery stages. "total" covers one whole region open (manifest + replay
# + recovery flush + restore); stages are cumulative per-region sums, so
# overlapping parallel opens add up to more than a batch's wall clock.
STAGES = ("manifest_load", "wal_replay", "recovery_flush", "sst_restore",
          "total")

_stage_ms = global_registry.counter(
    "gtpu_recovery_stage_ms_total",
    "cumulative recovery wall time per stage, milliseconds",
    ("stage",),
)
_regions_total = global_registry.counter(
    "gtpu_recovery_regions_total",
    "regions opened through the recovery dataplane",
)


def record_stage(stage: str, ms: float) -> None:
    _stage_ms.labels(stage).inc(ms)
    # the same stage numbers ride the active trace (the region.open span
    # parents them), so a recovery trace and the counter agree
    from greptimedb_tpu_torch.telemetry import tracing

    tracing.event_span(f"recovery.{stage}", ms)


def record_region() -> None:
    _regions_total.inc()


def stage_totals() -> dict[str, float]:
    """Current aggregate per-stage ms, plus "regions" opened, read from
    the gtpu_recovery_* counters."""
    out = {s: _stage_ms.labels(s).value for s in STAGES}
    out["regions"] = _regions_total.labels().value
    return out


@dataclass
class RecoveryOptions:
    """The ``[recovery]`` section of the JAX package's config."""

    # bounded pool size for batch region opens; 0 = min(8, batch size)
    open_parallelism: int = DEFAULT_OPEN_PARALLELISM
    # SST restore readahead window: gets in flight while decoding.
    # 0 = strictly serial fetch-then-decode (the measured baseline).
    sst_prefetch_depth: int = DEFAULT_SST_PREFETCH_DEPTH
    # manifest checkpoint cadence (edits between checkpoints)
    checkpoint_interval_edits: int = DEFAULT_CHECKPOINT_INTERVAL
    # flush a region right after its WAL replay recovered rows, so the
    # NEXT restart replays nothing (the obsolete path trims the log)
    flush_after_replay: bool = True
    # eagerly fetch+verify(+warm) manifest SSTs during batch opens
    restore_ssts: bool = False


def recovery_options_from(section: dict | None) -> RecoveryOptions:
    """``[recovery]`` dict -> options (unknown keys ignored)."""
    s = section or {}
    base = RecoveryOptions()
    return RecoveryOptions(
        open_parallelism=int(
            s.get("open_parallelism", base.open_parallelism)
        ),
        sst_prefetch_depth=int(
            s.get("sst_prefetch_depth", base.sst_prefetch_depth)
        ),
        checkpoint_interval_edits=int(
            s.get("checkpoint_interval_edits",
                  base.checkpoint_interval_edits)
        ),
        flush_after_replay=bool(
            s.get("flush_after_replay", base.flush_after_replay)
        ),
        restore_ssts=bool(s.get("restore_ssts", base.restore_ssts)),
    )


# ----------------------------------------------------------------------
# pipelined SST restore
# ----------------------------------------------------------------------

def _fetch_verified(store, meta) -> bytes:
    """Ranged get of exactly the manifest's byte count, verified.

    Short data == torn/partial object; both short reads and transient
    store errors retry (the prefetch retry path the recovery stress
    test exercises) before surfacing a typed error."""
    last: Exception | None = None
    for _attempt in range(1 + _FETCH_RETRIES):
        try:
            data = store.read_range(meta.path, 0, meta.size_bytes)
        except (FileNotFoundError, KeyError) as e:
            # KeyError is the memory backend's miss signal
            raise SstRestoreError(
                f"sst object missing during restore: {meta.path}"
            ) from e
        except OSError as e:
            # transient I/O fault (flaky remote store): retry
            last = e
            continue
        except Exception as e:
            # non-I/O failure (auth/type/programming error) is not
            # transient — surface immediately instead of re-downloading
            raise SstRestoreError(
                f"restore fetch failed for {meta.path}: {e}"
            ) from e
        if len(data) == meta.size_bytes:
            return data
        last = SstRestoreError(
            f"torn sst object during restore: {meta.path} "
            f"(got {len(data)} of {meta.size_bytes} bytes)"
        )
    if isinstance(last, SstRestoreError):
        raise last
    raise SstRestoreError(
        f"restore fetch failed for {meta.path}: {last}"
    ) from last


def _decode_install(meta, data: bytes, *, budget_full: bool,
                    warm: bool = True) -> tuple[int, bool]:
    """Verify the SST payload against the manifest entry and warm the page
    cache with its decoded columns while there is FREE budget (never
    evicting: recovery must not push out hot scan data). Cold-tier files
    verify only (``warm=False``). Returns (columns installed,
    budget_full)."""
    from greptimedb_tpu_torch.storage.page_cache import (
        _col_nbytes,
        global_page_cache,
    )
    from greptimedb_tpu_torch.storage.sst import SstFile

    try:
        f = SstFile(data)
        if f.num_rows != meta.rows:
            raise ValueError(
                f"row count {f.num_rows} != manifest {meta.rows}"
            )
        if budget_full or not warm:
            return 0, budget_full
        installed = 0
        for g in range(len(f.groups)):
            if budget_full:
                break
            for c in f.names:
                values, validity = f.column(g, c)
                if global_page_cache.put_free(
                    (meta.path, g, c), (values, validity),
                    _col_nbytes(values, validity),
                ):
                    installed += 1
                else:
                    budget_full = True
        return installed, budget_full
    except SstRestoreError:
        raise
    except Exception as e:
        raise SstRestoreError(
            f"corrupt sst object during restore: {meta.path}: {e}"
        ) from e


class PipelinedFetcher:
    """Bounded-readahead fetch of ``(store, SstMeta)`` items, yielding
    ``(meta, data)`` in submission order with up to ``depth`` verified
    ranged gets in flight — the shared read machinery of SST restore
    AND compaction inputs. Byte counts verify against each manifest
    entry (:func:`_fetch_verified`); the raw-byte window is bounded so
    a deep readahead over multi-hundred-MB SSTs cannot OOM the node.
    Use as a context manager; ``depth <= 0`` (or a single item)
    degrades to serial fetch with no pool."""

    def __init__(self, items, *, depth: int,
                 window_bytes: int = _RESTORE_WINDOW_BYTES):
        self._items = list(items)
        self._depth = int(depth)
        self._window_bytes = window_bytes
        self._pool = None
        self._pending: deque = deque()
        self._nxt = 0
        self._inflight_bytes = 0

    def __enter__(self) -> "PipelinedFetcher":
        if self._depth > 0 and len(self._items) > 1:
            self._pool = concurrency.ThreadPoolExecutor(
                max_workers=min(self._depth, len(self._items)),
                thread_name_prefix="sst-fetch",
            )
            self._fill()
        return self

    def __exit__(self, exc_type, exc, tb):
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
        return False

    def _fill(self):
        # readahead bounded by BOTH file count (depth) and raw bytes
        # in flight; a single oversized file still gets one slot
        while self._nxt < len(self._items) and \
                len(self._pending) < self._depth:
            store, m = self._items[self._nxt]
            if self._pending and (self._inflight_bytes + m.size_bytes
                                  > self._window_bytes):
                break
            self._pending.append(
                (m, self._pool.submit(_fetch_verified, store, m))
            )
            self._inflight_bytes += m.size_bytes
            self._nxt += 1

    def __iter__(self):
        if self._pool is None:
            for store, m in self._items[self._nxt:]:
                yield m, _fetch_verified(store, m)
            return
        while self._pending:
            m, fut = self._pending.popleft()
            data = fut.result()
            self._inflight_bytes -= m.size_bytes
            # keep the readahead window full before the caller decodes
            self._fill()
            yield m, data


def restore_region_ssts(region, *, prefetch_depth: int | None = None,
                        now_ms: int | None = None) -> dict:
    """Pipelined restore of a region's manifest SSTs.

    Issues ranged gets for up to ``prefetch_depth`` files ahead while
    the current file decodes; verifies each file's bytes against its
    manifest entry before install. On TTL tables, files whose whole
    time range already fell outside the retention window are skipped by
    manifest metadata — they would be fetched only to become
    immediately eligible for physical expiry.

    Returns stats: files/bytes restored, columns installed into the
    page cache, files skipped as expired, wall ms."""
    t0 = time.perf_counter()
    depth = (DEFAULT_SST_PREFETCH_DEPTH if prefetch_depth is None
             else int(prefetch_depth))
    ssts = list(region.manifest.state.ssts)
    stats = {"files": 0, "bytes": 0, "installed_cols": 0,
             "skipped_expired": 0, "ms": 0.0}
    ttl = region.meta.options.ttl_ms
    if ttl is not None:
        horizon = (now_ms if now_ms is not None
                   else int(time.time() * 1000)) - ttl
        live = [m for m in ssts if m.ts_max >= horizon]
        stats["skipped_expired"] = len(ssts) - len(live)
        ssts = live
    if ssts:
        # restore reads are write-once/read-once: go beneath the local
        # read cache (CachedObjectStore) exactly like the WAL does, so a
        # large restore can never evict hot scan objects from it.
        # Tier-aware: cold files fetch from the cold store and verify
        # only (no page-cache warm — cold columns must not take budget
        # hot scans want).
        from greptimedb_tpu_torch.storage.sst import TIER_COLD

        budget_full = False
        items = [(region.raw_store_for(m), m) for m in ssts]
        with PipelinedFetcher(items, depth=depth) as fetcher:
            for m, data in fetcher:
                installed, budget_full = _decode_install(
                    m, data, budget_full=budget_full,
                    warm=getattr(m, "tier", "hot") != TIER_COLD,
                )
                stats["files"] += 1
                stats["bytes"] += len(data)
                stats["installed_cols"] += installed
    ms = (time.perf_counter() - t0) * 1000.0
    stats["ms"] = ms
    rec = getattr(region, "recovery_stats", None)
    if rec is not None:
        rec["sst_restore_ms"] = rec.get("sst_restore_ms", 0.0) + ms
    record_stage("sst_restore", ms)
    return stats
