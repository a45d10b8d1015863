"""The region engine: region lifecycle + write-buffer management +
background maintenance (the JAX package's storage/engine.py), with one
background maintenance thread; the API is region-id keyed.

The engine takes `device=` (default CUDA, as every entry point of the
port): compaction merges run there (storage/compaction.py).

Region opens are a recovery dataplane (storage/recovery.py): the
registry lock covers dict swaps ONLY. The actual open — manifest read,
WAL replay, recovery flush, pipelined SST restore — runs outside the
lock, with an in-flight placeholder per region id so a half-open region
is never visible: a concurrent open of the same id waits on the same
slot, and a failed open removes the placeholder and re-raises to every
waiter. ``open_regions`` fans a batch over a bounded pool
(``[recovery] open_parallelism``) — the startup path for datanode
rejoin and standalone catalog load.
"""

from __future__ import annotations

import logging
import os
import threading

from dataclasses import dataclass, field

from greptimedb_tpu_torch import concurrency
from greptimedb_tpu_torch.device import resolve_device
from greptimedb_tpu_torch.errors import RegionNotFoundError
from greptimedb_tpu_torch.storage.compaction import (
    CompactionOptions,
    CompactionScheduler,
)
from greptimedb_tpu_torch.storage.object_store import (
    FsObjectStore,
    ObjectStore,
)
from greptimedb_tpu_torch.storage.recovery import RecoveryOptions
from greptimedb_tpu_torch.storage.region import Region, RegionMetadata

_log = logging.getLogger("greptimedb_tpu_torch.storage.engine")


@dataclass
class EngineConfig:
    data_root: str = "./greptimedb_tpu_data"
    global_write_buffer_bytes: int = 1024 * 1024 * 1024
    enable_background: bool = True
    background_interval_s: float = 5.0
    # WAL location override. Default: <data_root>/wal (node-local). Point
    # it at shared storage for the remote-WAL deployment shape.
    wal_root: str | None = None
    # "fs" (node-local segment files), "object" (ObjectStoreLogStore
    # over the engine's object store, the remote-WAL topology), or
    # "shared" (N shared topics multiplexing all regions)
    wal_backend: str = "fs"
    # number of shared topics when wal_backend == "shared" (regions are
    # assigned to topics round-robin)
    wal_topics: int = 4
    # recovery dataplane knobs
    recovery: RecoveryOptions = field(default_factory=RecoveryOptions)
    # compaction + tiering dataplane knobs
    compaction: CompactionOptions = field(
        default_factory=CompactionOptions
    )


class _OpenSlot:
    """In-flight region-open placeholder: concurrent opens of one id
    coalesce here instead of repeating (or observing half of) the
    open."""

    __slots__ = ("_done", "region", "error")

    def __init__(self):
        self._done = concurrency.Event()
        self.region = None
        self.error = None

    def resolve(self, region=None, error=None):
        self.region = region
        self.error = error
        self._done.set()

    def wait_done(self):
        """Wait for the open to settle without re-raising its error."""
        self._done.wait()

    def result(self):
        self._done.wait()
        if self.error is not None:
            raise self.error
        return self.region


class TsdbEngine:
    def __init__(self, config: EngineConfig | None = None,
                 store: ObjectStore | None = None,
                 cold_store: ObjectStore | None = None, *, device=None):
        self.config = config or EngineConfig()
        # where compaction merges run (default CUDA; raises without a
        # card unless device="cpu")
        self.device = resolve_device(device)
        self.store = store or FsObjectStore(self.config.data_root)
        # dedicated cold-tier store; None = regions derive it (the raw
        # store beneath any local read cache)
        self.cold_store = cold_store
        # bounded per-engine compaction pool: merges run off the
        # maintenance thread so a long merge never stalls maybe_flush
        # or other regions; Region.compact rides the same pool
        self.compaction = CompactionScheduler(self.config.compaction)
        self._regions: dict[int, Region] = {}
        self._opening: dict[int, _OpenSlot] = {}
        self._topics: dict[int, object] = {}
        self._lock = concurrency.RLock()
        # serializes shared-topic creation + the topics.json assignment
        # file (parallel opens of regions on the same topic must share
        # ONE SharedWalTopic object)
        self._topics_lock = concurrency.Lock()
        self._stop = concurrency.Event()
        # maintenance is lazy: the thread starts at the first region
        # open instead of spinning on an empty registry from __init__
        self._bg: threading.Thread | None = None

    # ---- lifecycle ----------------------------------------------------
    def create_region(self, meta: RegionMetadata) -> Region:
        return self.open_region(meta, _require_new=True)

    def open_region(self, meta: RegionMetadata, *,
                    restore: bool | None = None,
                    _require_new: bool = False,
                    _trace_parent=None) -> Region:
        """Open (possibly existing) region, replaying its WAL.

        The registry lock covers only the dict check/swap; the open
        itself (manifest + WAL replay + recovery flush + optional SST
        restore) runs outside it. Two threads racing on the same id get
        the SAME Region object; if the opener raises, the placeholder
        is removed and the error re-raises to all waiters."""
        with self._lock:
            if _require_new:
                # create semantics: duplicate ids fail atomically, even
                # against an in-flight open of the same id
                if (meta.region_id in self._regions
                        or meta.region_id in self._opening):
                    raise ValueError(
                        f"region {meta.region_id} already exists")
            existing = self._regions.get(meta.region_id)
            if existing is not None:
                return existing
            slot = self._opening.get(meta.region_id)
            if slot is not None:
                waiter = True
            else:
                slot = _OpenSlot()
                self._opening[meta.region_id] = slot
                waiter = False
        if waiter:
            return slot.result()
        try:
            # joins the caller's trace, or the batch span passed from a
            # pool worker (which does not inherit the submitting thread's
            # context); the recovery.* stage spans nest under it
            from greptimedb_tpu_torch.telemetry import tracing

            with tracing.child_span("region.open", _parent=_trace_parent,
                                    region=meta.region_id):
                region = self._open(meta, restore=restore)
        except BaseException as e:
            with self._lock:
                self._opening.pop(meta.region_id, None)
            slot.resolve(error=e)
            raise
        with self._lock:
            self._regions[meta.region_id] = region
            self._opening.pop(meta.region_id, None)
        slot.resolve(region=region)
        self._ensure_background()
        return region

    def open_regions(self, metas, *, parallelism: int | None = None,
                     restore: bool | None = None) -> list[Region]:
        """Batch open on a bounded pool (datanode rejoin / standalone
        startup). Joins every submission before returning; if any open
        failed, the FIRST error re-raises after the rest complete — the
        registry stays consistent (failed regions absent, the others
        open, and a retry coalesces or re-attempts per region)."""
        metas = list(metas)
        if not metas:
            return []
        # regions already in the registry need no pool slot — a repeat
        # batch (e.g. the per-table opens after the catalog's one
        # cross-table batch) degrades to plain dict lookups below
        with self._lock:
            missing = [m for m in metas
                       if m.region_id not in self._regions]
        errors: list = []
        if missing:
            from greptimedb_tpu_torch.telemetry import tracing

            par = (self.config.recovery.open_parallelism
                   if parallelism is None else int(parallelism))
            if par <= 0:
                par = min(8, len(missing))
            par = min(par, len(missing))
            # one span for the batch: a root trace at startup, a child
            # of the statement's trace on DDL-triggered opens; pool
            # workers parent to it explicitly
            with tracing.span("recovery.open_regions",
                              regions=len(missing)) as batch_sp:
                parent = batch_sp if batch_sp.trace_id else None
                if par <= 1:
                    for m in missing:
                        try:
                            self.open_region(m, restore=restore,
                                             _trace_parent=parent)
                        except Exception as e:  # noqa: BLE001 - below
                            errors.append(e)
                else:
                    with concurrency.ThreadPoolExecutor(
                        max_workers=par, thread_name_prefix="region-open",
                    ) as pool:
                        futs = [pool.submit(self.open_region, m,
                                            restore=restore,
                                            _trace_parent=parent)
                                for m in missing]
                        for fut in futs:
                            try:
                                fut.result()
                            except Exception as e:  # noqa: BLE001
                                errors.append(e)
        if errors:
            raise errors[0]
        return [self.open_region(m, restore=restore) for m in metas]

    def _open(self, meta: RegionMetadata, *,
              restore: bool | None = None) -> Region:
        import time as _time

        from greptimedb_tpu_torch.storage import recovery as _recovery

        rec = self.config.recovery
        t0 = _time.perf_counter()
        region = self._build_region(meta)
        if self.config.compaction.cleanup_orphans:
            # crash-mid-compaction/flush leftovers: SST objects the
            # loaded manifest does not reference. Before the recovery
            # flush below, so the listing races no writes of our own.
            from greptimedb_tpu_torch.storage.compaction import (
                cleanup_orphan_ssts,
            )

            try:
                cleanup_orphan_ssts(region)
            except Exception:  # noqa: BLE001 - cleanup is best-effort
                _log.warning(
                    "orphan sst cleanup failed for region %s",
                    meta.region_id, exc_info=True,
                )
        if rec.flush_after_replay and \
                region.recovery_stats.get("replayed_entries"):
            # WAL truncation after the recovery flush: persist the
            # replayed rows now so the NEXT restart replays nothing
            # (flush commits the manifest and runs the existing
            # obsolete path; on shared topics that only advances the
            # per-region low-watermark)
            t1 = _time.perf_counter()
            region.flush()
            ms = (_time.perf_counter() - t1) * 1000.0
            region.recovery_stats["recovery_flush_ms"] = ms
            _recovery.record_stage("recovery_flush", ms)
        do_restore = rec.restore_ssts if restore is None else restore
        if do_restore:
            _recovery.restore_region_ssts(
                region, prefetch_depth=rec.sst_prefetch_depth
            )
        total = (_time.perf_counter() - t0) * 1000.0
        region.recovery_stats["total_ms"] = total
        _recovery.record_stage("total", total)
        _recovery.record_region()
        return region

    def _build_region(self, meta: RegionMetadata) -> Region:
        wal_root = self.config.wal_root or os.path.join(
            self.config.data_root, "wal"
        )
        wal_dir = os.path.join(wal_root, f"region_{meta.region_id}")
        log_store = None
        if self.config.wal_backend == "object":
            # remote-WAL topology: the log rides the (possibly shared /
            # S3) object store instead of node-local files. WAL objects
            # are write-once/read-at-replay, so they bypass any local
            # read cache rather than evict hot SST data from it.
            from greptimedb_tpu_torch.storage.object_store import (
                CachedObjectStore,
            )
            from greptimedb_tpu_torch.storage.wal import ObjectStoreLogStore

            wal_store = (self.store.inner
                         if isinstance(self.store, CachedObjectStore)
                         else self.store)
            log_store = ObjectStoreLogStore(
                wal_store, f"wal/region_{meta.region_id}"
            )
        elif self.config.wal_backend == "shared":
            from greptimedb_tpu_torch.storage.wal import TopicRegionLog

            topic_id = self._assign_topic(meta.region_id, wal_root)
            topic = self._topic(topic_id, wal_root)
            log_store = TopicRegionLog(topic, meta.region_id)
        elif self.config.wal_backend != "fs":
            raise ValueError(
                f"unknown wal_backend {self.config.wal_backend!r} "
                "(fs | object | shared)"
            )
        region = Region(
            meta, self.store, wal_dir, log_store=log_store,
            checkpoint_interval_edits=(
                self.config.recovery.checkpoint_interval_edits
            ),
            cold_store=self.cold_store,
        )
        region._compaction = self.compaction
        region._compaction_opts = self.config.compaction
        region.device = self.device
        return region

    def _assign_topic(self, region_id: int, wal_root: str) -> int:
        """Persisted region->topic assignment: an existing region keeps its
        topic even if wal_topics changes across restarts — recomputing the modulus would replay
        the wrong topic and silently drop unflushed entries. The
        topics lock serializes the read-modify-write of topics.json
        against parallel region opens."""
        import json

        with self._topics_lock:
            path = os.path.join(wal_root, "topics.json")
            os.makedirs(wal_root, exist_ok=True)
            assignments = {}
            if os.path.exists(path):
                with open(path) as f:
                    assignments = {
                        int(k): v for k, v in json.load(f).items()
                    }
            if region_id in assignments:
                return assignments[region_id]
            n = max(1, int(self.config.wal_topics))
            topic_id = region_id % n
            assignments[region_id] = topic_id
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({str(k): v for k, v in assignments.items()}, f)
            os.replace(tmp, path)
            return topic_id

    def _topic(self, topic_id: int, wal_root: str):
        """Open (once) the shared topic this region multiplexes into.
        Serialized: parallel opens of two regions on the same topic
        must share ONE SharedWalTopic (its open-time scan builds the
        per-region replay index)."""
        from greptimedb_tpu_torch.storage.wal import RegionWal, SharedWalTopic

        with self._topics_lock:
            topic = self._topics.get(topic_id)
            if topic is None:
                topic = SharedWalTopic(
                    RegionWal(os.path.join(wal_root, f"topic_{topic_id}"))
                )
                self._topics[topic_id] = topic
            return topic

    def _wait_open(self, region_id: int):
        """Join any in-flight open of this id (close/drop must not race
        a half-finished open into a leaked region)."""
        with self._lock:
            slot = self._opening.get(region_id)
        if slot is not None:
            # a failed open leaves nothing to close/drop; only the
            # settling matters here, so the opener's error stays its own
            slot.wait_done()

    def close_region(self, region_id: int):
        self._wait_open(region_id)
        with self._lock:
            region = self._regions.pop(region_id, None)
        if region:
            region.flush()
            region.close()

    def drop_region(self, region_id: int):
        self._wait_open(region_id)
        with self._lock:
            region = self._regions.pop(region_id, None)
        if region:
            region.close()
            for meta in region.manifest.state.ssts:
                # tier-aware: cold files may live on a separate store
                region.store_for(meta).delete(meta.path)
            for m in self.store.list(region.prefix + "/"):
                self.store.delete(m.path)
            cold = region.cold_store
            if cold is not self.store:
                for m in cold.list(region.prefix + "/"):
                    cold.delete(m.path)
            if hasattr(region.wal, "drop"):
                # shared-topic view: forget the region so its dead
                # entries stop pinning topic truncation
                region.wal.drop()
            wal_root = getattr(region.wal, "root", None)
            if wal_root:
                import shutil

                shutil.rmtree(wal_root, ignore_errors=True)

    def region(self, region_id: int) -> Region:
        with self._lock:
            region = self._regions.get(region_id)
            slot = self._opening.get(region_id) if region is None else None
        if region is not None:
            return region
        if slot is not None:
            # an open is in flight: callers see it once it lands
            try:
                return slot.result()
            except Exception:  # noqa: BLE001 - opener's error is its own
                raise RegionNotFoundError(
                    f"region {region_id} not found"
                ) from None
        raise RegionNotFoundError(f"region {region_id} not found")

    def regions(self) -> list[Region]:
        with self._lock:
            return list(self._regions.values())

    # ---- maintenance --------------------------------------------------
    def maybe_flush(self):
        """Flush regions over their own threshold, plus the largest ones
        while the global write-buffer budget is exceeded. One region's
        failing flush must not starve the others of theirs."""
        regions = self.regions()
        for r in regions:
            if r.should_flush:
                try:
                    r.flush()
                except Exception:  # noqa: BLE001 - isolated per region
                    _log.warning("maintenance flush failed for region "
                                 "%s", r.meta.region_id, exc_info=True)
        total = sum(r.memtable.bytes for r in regions)
        if total > self.config.global_write_buffer_bytes:
            for r in sorted(regions, key=lambda r: -r.memtable.bytes):
                if total <= self.config.global_write_buffer_bytes:
                    break
                total -= r.memtable.bytes
                try:
                    r.flush()
                except Exception:  # noqa: BLE001 - isolated per region
                    _log.warning("budget flush failed for region %s",
                                 r.meta.region_id, exc_info=True)

    def run_maintenance(self):
        """One maintenance tick: flushes, TTL expiry, compaction
        scheduling. Failures are isolated PER REGION — one region's
        failing purge/compact no longer aborts the remaining regions'
        maintenance for the tick — and compaction merges run on the
        bounded pool, not this thread."""
        from greptimedb_tpu_torch.storage.compaction import purge_expired

        self.maybe_flush()
        regions = self.regions()
        for r in regions:
            try:
                purge_expired(r)
                self.compaction.maybe_schedule(r)
            except Exception:  # noqa: BLE001 - isolated per region
                _log.warning("maintenance failed for region %s",
                             r.meta.region_id, exc_info=True)
        self.compaction.update_read_amp(regions)

    def _ensure_background(self):
        """Lazy-start the maintenance thread on first region open."""
        if not self.config.enable_background:
            return
        with self._lock:
            if self._bg is not None or self._stop.is_set():
                return
            self._bg = concurrency.Thread(
                target=self._background_loop, daemon=True,
                name="engine-maintenance",
            )
            self._bg.start()

    def _background_loop(self):
        while not self._stop.wait(self.config.background_interval_s):
            try:
                self.run_maintenance()
            except Exception:  # pragma: no cover - keep the loop alive
                import traceback

                traceback.print_exc()

    def close(self):
        self._stop.set()
        if self._bg:
            self._bg.join(timeout=10)
        # stop the merge pool before closing regions: a merge landing
        # after its region closed would commit into a dead manifest
        self.compaction.close()
        # drain in-flight opens: a region landing after the close loop
        # snapshot would keep its WAL handle (and replayed rows) open
        while True:
            with self._lock:
                slots = list(self._opening.values())
            if not slots:
                break
            for slot in slots:
                slot.wait_done()
        for rid in list(self._regions):
            self.close_region(rid)
        with self._lock:
            for topic in self._topics.values():
                topic.close()
            self._topics.clear()
