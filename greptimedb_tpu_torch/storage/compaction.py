"""Compaction and tiered storage: leveled TWCS with the merge on the card,
tombstone GC and hot/cold tiering (the JAX package's
storage/compaction.py).

- **Leveled picker** (`pick_tasks`): SSTs are bucketed into time windows
  by max timestamp. Per window, level-0 files merge into one L1 run once
  `compaction_trigger_files` accumulate (the per-table knob), L1 runs
  merge into L2 on the l1 file/byte triggers, and L2 self-merges on its
  own trigger so the top level stays one run per window.
- **Tombstone GC**: a merge drops delete tombstones exactly when its input
  set covers EVERY live file whose time range overlaps the merge range.
- **Hot/cold tiering**: windows older than ``cold_horizon_ms`` are
  rewritten onto the cold object-store tier.
- **Merge on the card**: the concatenated runs sort/dedup/merge-mode-fold
  through storage/device_merge.merge_rows at ``device_merge_min_rows`` and
  above (the fused form, kernel K1, on CUDA from
  ``device_merge.DEFAULT_KERNEL_MIN_ROWS``), bit-identical to the host
  path; the device is the owning engine's (``region.device``).
- **Bounded pool** (`CompactionScheduler`): merges run on a per-engine
  worker pool with per-region in-flight dedupe.

The JAX package's compaction counters wait for the port's telemetry (A9);
each region lists its merges' paths and input rows (`merge_paths`,
`merge_rows_in`).
"""

from __future__ import annotations

import logging
import threading
import time
import uuid

from collections import defaultdict
from dataclasses import dataclass

from greptimedb_tpu_torch import concurrency
from greptimedb_tpu_torch.errors import CompactionError
from greptimedb_tpu_torch.storage.device_merge import (
    DEFAULT_DEVICE_MIN_ROWS,
    merge_rows,
)
from greptimedb_tpu_torch.storage.memtable import _concat_rows
from greptimedb_tpu_torch.storage.sst import (
    TIER_COLD,
    TIER_HOT,
    delete_sst,
    read_sst_bytes,
    sidecar_path,
    write_sst,
)

_log = logging.getLogger("greptimedb_tpu_torch.storage.compaction")

MAX_LEVEL = 2
# cascade bound per compact_once call: L0->L1->L2->tier is 4 picks;
# anything deeper indicates a picker bug, not more work
_MAX_ROUNDS = 8

@dataclass
class CompactionOptions:
    """The ``[compaction]`` section of the JAX package's config. The L0
    trigger and window size stay per table (``RegionOptions``); these are
    the engine-wide level/tier/merge knobs."""

    # bounded per-engine merge pool
    workers: int = 1
    # L1 -> L2 promotion: file-count OR byte triggers (0 disables one)
    l1_trigger_files: int = 4
    l1_trigger_bytes: int = 256 * 1024 * 1024
    # L2 self-merge trigger (top level stays ~1 run per window)
    l2_trigger_files: int = 4
    # windows older than this rewrite onto the cold tier; 0 = off
    cold_horizon_ms: int = 0
    # device merge threshold; <= 0 forces the host path
    device_merge_min_rows: int = DEFAULT_DEVICE_MIN_ROWS
    # diagnostic: assert device output bit-identical to host per merge
    verify_device_merge: bool = False
    # pipelined compaction-read readahead (files in flight; 0 = serial)
    prefetch_depth: int = 4
    # remove manifest-unreferenced SST objects at region open
    cleanup_orphans: bool = True


def compaction_options_from(section: dict | None) -> CompactionOptions:
    """``[compaction]`` dict -> options (unknown keys ignored)."""
    s = section or {}
    base = CompactionOptions()
    return CompactionOptions(
        workers=int(s.get("workers", base.workers)),
        l1_trigger_files=int(
            s.get("l1_trigger_files", base.l1_trigger_files)
        ),
        l1_trigger_bytes=int(
            s.get("l1_trigger_bytes", base.l1_trigger_bytes)
        ),
        l2_trigger_files=int(
            s.get("l2_trigger_files", base.l2_trigger_files)
        ),
        cold_horizon_ms=int(s.get("cold_horizon_ms", base.cold_horizon_ms)),
        device_merge_min_rows=int(
            s.get("device_merge_min_rows", base.device_merge_min_rows)
        ),
        verify_device_merge=bool(
            s.get("verify_device_merge", base.verify_device_merge)
        ),
        prefetch_depth=int(s.get("prefetch_depth", base.prefetch_depth)),
        cleanup_orphans=bool(
            s.get("cleanup_orphans", base.cleanup_orphans)
        ),
    )


@dataclass
class CompactionTask:
    kind: str               # l0 | l1 | l2 | tier | force
    window: int
    files: list             # SstMeta inputs
    output_level: int
    output_tier: str
    drop_deletes: bool


# ----------------------------------------------------------------------
# picker
# ----------------------------------------------------------------------

def _by_window(ssts: list, window_ms: int) -> dict[int, list]:
    window = max(window_ms, 1)
    out: dict[int, list] = defaultdict(list)
    for m in ssts:
        out[m.ts_max // window].append(m)
    return out


def _covers_all_overlapping(files: list, live: list) -> bool:
    """True when no live file OUTSIDE the merge set overlaps the merge
    set's time range — the tombstone-GC safety condition: any row a
    dropped delete could shadow must itself be inside the merge."""
    ids = {m.file_id for m in files}
    mn = min(m.ts_min for m in files)
    mx = max(m.ts_max for m in files)
    return all(
        m.ts_max < mn or m.ts_min > mx
        for m in live if m.file_id not in ids
    )


def pick_tasks(region, opts: CompactionOptions, *,
               now_ms: int | None = None,
               force: bool = False) -> list[CompactionTask]:
    """Pick at most one merge task per time window, most-loaded window
    first. ``force`` merges every multi-file
    window to the top level regardless of triggers."""
    with region._lock:
        live = list(region.manifest.state.ssts)
    ropts = region.meta.options
    if now_ms is None:
        now_ms = int(time.time() * 1000)
    window_ms = max(ropts.compaction_window_ms, 1)
    cold_before = (now_ms - opts.cold_horizon_ms
                   if opts.cold_horizon_ms > 0 else None)
    tasks: list[CompactionTask] = []
    for win, files in sorted(_by_window(live, window_ms).items(),
                             key=lambda kv: -len(kv[1])):
        window_end = (win + 1) * window_ms
        goes_cold = cold_before is not None and window_end <= cold_before
        out_tier = TIER_COLD if goes_cold else TIER_HOT
        if force:
            if len(files) >= 2 or (goes_cold and any(
                    m.tier != TIER_COLD for m in files)):
                tasks.append(CompactionTask(
                    kind="force", window=win, files=list(files),
                    output_level=MAX_LEVEL, output_tier=out_tier,
                    drop_deletes=_covers_all_overlapping(files, live),
                ))
            continue
        l0 = [m for m in files if m.level == 0]
        l1 = [m for m in files if m.level == 1]
        l2 = [m for m in files if m.level >= 2]
        task = None
        if len(l0) >= max(ropts.compaction_trigger_files, 2):
            task = CompactionTask(
                kind="l0", window=win, files=l0, output_level=1,
                output_tier=out_tier, drop_deletes=False,
            )
        elif len(l1) >= 2 and (
            len(l1) >= opts.l1_trigger_files
            or (opts.l1_trigger_bytes > 0
                and sum(m.size_bytes for m in l1) >= opts.l1_trigger_bytes)
        ):
            task = CompactionTask(
                kind="l1", window=win, files=l1, output_level=2,
                output_tier=out_tier, drop_deletes=False,
            )
        elif len(l2) >= max(opts.l2_trigger_files, 2):
            task = CompactionTask(
                kind="l2", window=win, files=l2,
                output_level=MAX_LEVEL, output_tier=out_tier,
                drop_deletes=False,
            )
        elif goes_cold and any(m.tier != TIER_COLD for m in files):
            # quiesced window past the horizon: rewrite ALL of it (any
            # level/tier) into one top-level cold run
            task = CompactionTask(
                kind="tier", window=win, files=list(files),
                output_level=MAX_LEVEL, output_tier=TIER_COLD,
                drop_deletes=False,
            )
        if task is not None:
            task.drop_deletes = _covers_all_overlapping(task.files, live)
            tasks.append(task)
    return tasks


def read_amplification(region) -> int:
    """Live files in the region's busiest time window — the number of
    sorted runs every scan of that window must merge."""
    with region._lock:
        live = list(region.manifest.state.ssts)
    if not live:
        return 0
    window_ms = max(region.meta.options.compaction_window_ms, 1)
    return max(len(v) for v in _by_window(live, window_ms).values())


# ----------------------------------------------------------------------
# task runner
# ----------------------------------------------------------------------

def _read_inputs(region, task: CompactionTask,
                 opts: CompactionOptions) -> list:
    """Fetch + verify + decode the task's inputs through the recovery
    dataplane's pipelined readahead (bytes checked against each
    manifest entry; reads bypass any local object cache — inputs are
    read once and then deleted)."""
    from greptimedb_tpu_torch.storage.recovery import PipelinedFetcher

    chunks = []
    items = [(region.raw_store_for(m), m) for m in task.files]
    with PipelinedFetcher(items, depth=opts.prefetch_depth) as fetcher:
        for meta, data in fetcher:
            r = read_sst_bytes(data, field_names=region.meta.field_names)
            if r is not None:
                chunks.append(r)
    return chunks


def run_task(region, task: CompactionTask,
             opts: CompactionOptions) -> bool:
    """Run one merge task end to end: pipelined read, merge on the card,
    write, validated manifest swap, input deletion. Returns True if the
    swap committed; False when a concurrent truncate/compaction removed an
    input first (the new output is deleted, nothing else changed)."""
    from greptimedb_tpu_torch.errors import SstRestoreError

    try:
        chunks = _read_inputs(region, task, opts)
    except SstRestoreError:
        with region._lock:
            live = {m.file_id for m in region.manifest.state.ssts}
        if not all(m.file_id in live for m in task.files):
            # benign race: a concurrent truncate/TTL purge removed an
            # input between pick and read — nothing to merge anymore
            return False
        raise
    if not chunks:
        return False
    rows = (_concat_rows(chunks, region.meta.field_names)
            if len(chunks) > 1 else chunks[0])
    if not region.meta.options.append_mode:
        rows_in = len(rows)
        rows, path = merge_rows(
            rows,
            merge_mode=region.meta.options.merge_mode,
            drop_deletes=task.drop_deletes,
            device_min_rows=opts.device_merge_min_rows,
            verify=opts.verify_device_merge,
            device=region.device,
        )
        region.merge_paths.append(path)
        region.merge_rows_in.append(rows_in)

    if len(rows) == 0:
        # every surviving row was a GC'd tombstone: commit a pure
        # removal instead of writing an empty SST
        with region._lock:
            live = {m.file_id for m in region.manifest.state.ssts}
            if not all(m.file_id in live for m in task.files):
                return False
            region.manifest.commit({
                "kind": "compact",
                "remove_files": [m.file_id for m in task.files],
                "add_ssts": [],
            })
        for m in task.files:
            delete_sst(region.store_for(m), m)
        region._compactions += 1
        return True

    file_id = uuid.uuid4().hex
    out_store = region.store_for_tier(task.output_tier)
    subdir = "cold" if task.output_tier == TIER_COLD else "sst"
    new_path = f"{region.prefix}/{subdir}/{file_id}.sst"
    new_meta = write_sst(
        out_store, new_path, file_id, rows, level=task.output_level,
        tier=task.output_tier,
        fulltext_fields=region.meta.fulltext_fields,
    )

    with region._lock:
        live = {m.file_id for m in region.manifest.state.ssts}
        if not all(m.file_id in live for m in task.files):
            # lost a race with truncate/TTL purge/another compaction:
            # abort without touching the manifest
            delete_sst(out_store, new_meta)
            return False
        region.manifest.commit({
            "kind": "compact",
            "remove_files": [m.file_id for m in task.files],
            "add_ssts": [new_meta.to_json()],
        })
        region._compactions += 1
    for m in task.files:
        delete_sst(region.store_for(m), m)
    return True


def _region_opts(region) -> CompactionOptions:
    return getattr(region, "_compaction_opts", None) or CompactionOptions()


def compact_once(region, opts: CompactionOptions | None = None, *,
                 force: bool = False,
                 now_ms: int | None = None) -> bool:
    """Run triggered compactions for this region until the picker is
    satisfied (bounded cascade: an L0 merge may arm the L1 trigger and
    so on). Returns True if any merge committed."""
    if opts is None:
        opts = _region_opts(region)
    did = False
    first_err: Exception | None = None
    failed: set = set()   # (kind, window) that failed THIS call
    for _round in range(_MAX_ROUNDS):
        tasks = [
            t for t in pick_tasks(region, opts, now_ms=now_ms,
                                  force=force)
            if (t.kind, t.window) not in failed
        ]
        if not tasks:
            break
        progressed = False
        for task in tasks:
            try:
                if run_task(region, task, opts):
                    progressed = did = True
            except Exception as e:  # noqa: BLE001 - re-raised below
                # one bad window (corrupt input, device divergence
                # under verify, commit error) must not starve the
                # region's OTHER windows: count it, skip the window
                # for the rest of this call, surface the first error
                # after every window got its attempt
                failed.add((task.kind, task.window))
                if first_err is None:
                    first_err = e
        if not progressed:
            break
        # force is satisfied by one pass per window; re-picking with
        # force would see the (single) merged outputs and stop anyway,
        # but the trigger cascade below is what the loop is for
        force = False
    if first_err is not None:
        raise first_err
    return did


# ----------------------------------------------------------------------
# TTL expiry + orphan cleanup
# ----------------------------------------------------------------------

def purge_expired(region, *, now_ms: int | None = None) -> int:
    """Physically drop whole SSTs past the table's TTL horizon. Query-time
    filtering already hides expired rows (region.scan's ts_min clamp);
    this reclaims the storage, tier-aware. Returns files removed."""
    ttl = region.meta.options.ttl_ms
    if ttl is None:
        return 0
    horizon = (now_ms if now_ms is not None
               else int(time.time() * 1000)) - ttl
    with region._lock:
        expired = [
            m for m in region.manifest.state.ssts if m.ts_max < horizon
        ]
        if not expired:
            return 0
        region.manifest.commit({
            "kind": "compact",
            "remove_files": [m.file_id for m in expired],
            "add_ssts": [],
        })
        # rows disappeared without a write: bump the logical data
        # version so device grid caches rebuild rather than serve
        # purged rows
        region._truncate_epoch += 1
    for m in expired:
        delete_sst(region.store_for(m), m)
    return len(expired)


def cleanup_orphan_ssts(region) -> int:
    """Delete SST objects (and sidecars) under the region's sst/ and
    cold/ prefixes that the freshly loaded manifest does not reference
    — the leftovers of a crash between an SST write and its manifest
    commit (flush or compaction). Runs at region open, before any
    concurrent flush can add new files."""
    live: set[str] = set()
    for m in region.manifest.state.ssts:
        live.add(m.path)
        if m.fulltext:
            live.add(sidecar_path(m.path))
    removed = 0
    for tier in (TIER_HOT, TIER_COLD):
        store = region.store_for_tier(tier)
        subdir = "cold" if tier == TIER_COLD else "sst"
        prefix = f"{region.prefix}/{subdir}/"
        for obj in store.list(prefix):
            if obj.path in live:
                continue
            store.delete(obj.path)
            removed += 1
            _log.warning("removed orphan sst object %s (region %s)",
                         obj.path, region.meta.region_id)
    return removed


# ----------------------------------------------------------------------
# scheduler: the bounded per-engine compaction pool
# ----------------------------------------------------------------------

class CompactionScheduler:
    """Bounded worker pool running merges off the maintenance thread.

    One instance per engine. ``schedule`` is the background path
    (async, per-region in-flight dedupe: a region never runs two
    concurrent merges); ``compact_sync`` is the caller's path
    (`Region.compact`) — it rides the same pool so requested merges obey
    the same concurrency bound, and runs inline when already on a worker
    thread (a merge must not deadlock waiting for itself)."""

    _THREAD_PREFIX = "compact"

    def __init__(self, opts: CompactionOptions | None = None):
        self.opts = opts or CompactionOptions()
        self._lock = concurrency.Lock()
        self._pool = None
        self._closed = False
        self._inflight: dict[int, object] = {}      # region_id -> Future

    # -- pool lifecycle -------------------------------------------------
    def _ensure_pool(self):
        with self._lock:
            if self._closed:
                raise CompactionError("compaction scheduler is closed")
            if self._pool is None:
                self._pool = concurrency.ThreadPoolExecutor(
                    max_workers=max(1, int(self.opts.workers)),
                    thread_name_prefix=self._THREAD_PREFIX,
                )
            return self._pool

    def close(self):
        with self._lock:
            self._closed = True
            pool, self._pool = self._pool, None
        if pool is not None:
            # let the running merge finish (its commit is atomic);
            # queued work is dropped — the picker re-finds it
            pool.shutdown(wait=True, cancel_futures=True)

    def _in_worker(self) -> bool:
        return threading.current_thread().name.startswith(
            self._THREAD_PREFIX
        )

    # -- job submission -------------------------------------------------
    def maybe_schedule(self, region) -> bool:
        """Cheap picker probe; submits an async merge job when work is
        triggered and the region has no job in flight."""
        tasks = pick_tasks(region, self.opts)
        if not tasks:
            return False
        return self.schedule(region) is not None

    def schedule(self, region, *, force: bool = False):
        """Submit one merge job for the region (per-region in-flight
        dedupe: returns None when a job is already running or the
        scheduler is closed)."""
        rid = region.meta.region_id
        with self._lock:
            if self._closed or rid in self._inflight:
                return None
        pool = self._ensure_pool()
        with self._lock:
            if self._closed or rid in self._inflight:
                return None
            fut = pool.submit(self._run_region, region, force)
            self._inflight[rid] = fut
        # release via done-callback, NOT a finally inside the job: a job
        # cancelled at close() never runs, and its slot must not stay
        # taken. Attached OUTSIDE the lock: an already-done future fires
        # the callback inline on this thread, which would deadlock the
        # non-reentrant lock.
        fut.add_done_callback(lambda _f, rid=rid: self._release(rid))
        return fut

    def _release(self, rid: int):
        with self._lock:
            self._inflight.pop(rid, None)

    def _run_region(self, region, force: bool = False) -> bool:
        try:
            return compact_once(region, self.opts, force=force)
        except Exception:
            # the background path has no caller to observe the Future: a
            # failing merge must surface in the log, then the next
            # maintenance tick retries with the inputs intact
            _log.warning("compaction failed for region %s",
                         region.meta.region_id, exc_info=True)
            raise

    # -- synchronous path ----------------------------------------------
    def compact_sync(self, region, *, force: bool = False) -> bool:
        """Run a merge pass for the region on the pool and wait.
        Participates in the same per-region in-flight dedupe as the
        background path: an already-running job is awaited first (its
        result does not satisfy force semantics, so a fresh pass
        follows). The in-worker inline path below skips the dedupe —
        commit-time revalidation keeps any residual overlap safe."""
        from concurrent.futures import CancelledError

        if self._in_worker():
            # already on a pool thread: run inline rather than deadlock
            # waiting on our own pool
            return compact_once(region, self.opts, force=force)
        rid = region.meta.region_id
        # picked up front: an idle pass skips the pool entirely
        tasks = pick_tasks(region, self.opts, force=force)
        while True:
            with self._lock:
                idle = not self._closed and rid not in self._inflight
            if not tasks and idle:
                return False
            fut = self.schedule(region, force=force)
            if fut is not None:
                try:
                    return fut.result()
                except CancelledError:
                    # close() cancelled the queued job; keep the wire
                    # contract typed
                    raise CompactionError(
                        "compaction scheduler closed before the job ran"
                    ) from None
            with self._lock:
                if self._closed:
                    raise CompactionError(
                        "compaction scheduler is closed"
                    )
                existing = self._inflight.get(rid)
            if existing is None:
                continue  # raced the job's completion; claim again
            try:
                existing.result()
            except CancelledError:
                continue  # close() raced; the loop re-checks _closed
            except Exception:  # noqa: BLE001 - its error is its own
                _log.warning(
                    "in-flight compaction failed ahead of a requested pass "
                    "(region %s)", rid, exc_info=True,
                )

    # -- observability --------------------------------------------------
    def update_read_amp(self, regions) -> int:
        return max(
            (read_amplification(r) for r in regions), default=0
        )
