"""Device-resident RANGE execution, on one device or series-sharded.

RANGE queries (`agg(x) RANGE 'r' ... ALIGN 'a' BY (tags)`) run over
device-resident (series x time-cell) partial-state grids:

    cells (S, NB) --mask--> fold sids->groups --gather--> window combine
    (stride doubling, O(log W) passes) --strided sample--> finalize

- one `_Entry` per (table, resolution, phase) holds (S, NB) tensors of
  per-cell partial aggregate states per field ({s, n, s2, mn, mx, vl/il,
  vf/if}, built for the ops seen), plus field-independent row presence and
  per-cell intra-cell ts offsets for exact window math;
- the grid is built on the host with numpy (build_entry, copied from the
  JAX package) and uploaded once; entries are reused while the table's
  data_version holds;
- the query program (_range_body) is plain torch on the card except the
  grouped sum fold, which runs K2 (parallel/kernels/ring_fold) because its
  fixed order of float additions is the bit-identity contract;
- with a mesh, the replicate-vs-shard planner decides placement at build
  time: a sharded entry holds one slice of the series axis per shard
  device (every grid is a list of per-shard tensors; an unsharded entry
  is a list of one). Each shard masks and segment-folds its own rows, the
  fold ctx (parallel/dist, parallel/kernels/ring_fold) is the only place
  shards meet, and results are bit-identical to the one-device engine.

States are float32/int32 as in the JAX package's device path; indices are
int64 only where torch indexing requires it. Tag matchers of the WHERE
clause become a host sid mask (index/tag_index.match_sids, through the
secondary index's postings) that the
prelude and every shard's program apply. Where the JAX package declines
a shape (residual filters, expression arguments, non-tag keys, unaligned
time bounds, oversized grids, `prefer_device` off or a small table), the
entry points return None and the engine answers on the host path
(query/executor). A sharded fold without the blocked form (past the
blocked-fold cap, or a series count that is no multiple of FOLD_BLOCKS)
gathers every shard's grids to the first shard's device and runs the
one-device program there ("single_gathered").

A poll's folded result stays on the card in the query session registry
(query/sessions.py), keyed to its entry: a repeated poll runs no program,
and a `since` poll narrows the resident result to the steps past the
cursor before the one readback (readback.read_gathered(lo=)). The cache
releases an entry's buffers wherever it drops the entry (`_release`).

A durable table's entries persist as restart snapshots under its region's
directory (`persist_entry`, after a build on a thread) and a fresh engine
restores them with uploads only (`load_entry_snapshot`,
`warm_from_snapshots`); a snapshot of an older data version is deleted
when found. The JAX package also records the jit specs an entry served
and precompiles them at warm time; the port's range program is eager
torch with nothing to compile ahead, so that snapshot is not ported.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field as dc_field

import numpy as np
import torch

from greptimedb_tpu_torch.errors import UnsupportedError
from greptimedb_tpu_torch.index import tag_index
from greptimedb_tpu_torch.ops import window as W
from greptimedb_tpu_torch.parallel.dist import LocalFoldCtx, ShardFoldCtx
from greptimedb_tpu_torch.parallel.kernels import ring_fold
from greptimedb_tpu_torch.parallel.mesh import FOLD_BLOCKS, shard_count
from greptimedb_tpu_torch.query import readback, sessions, stats
from greptimedb_tpu_torch.query.planner import (
    Column,
    MeshDecision,
    decide_mesh_execution,
    record_mesh_decision,
    record_scan_path,
)
from greptimedb_tpu_torch.query.reduce import DEVICE_THRESHOLD

_CELL_CAP = 256 * 1024 * 1024    # max S*NB cells per cached array (1GB f32)
_MAX_ENTRIES = 8                 # LRU entry-count cap across all tables
_BYTE_BUDGET = 4 * 1024**3       # LRU byte cap across all cached entries
_FOLD_CAP = 256_000_000          # max cells of a (blocks, g, nb) partial

# Timestamps ride as exact (cell index, intra-cell ms offset) int32 pairs.
_I32_MAX = 2**31 - 1
_I32_MIN = -(2**31)

# every one of these folds exactly across shards (blocked partials plus
# ordered extreme/one-hot combines), which the mesh planner relies on
_DEVICE_RANGE_OPS = {
    "count", "sum", "mean", "min", "max",
    "var_pop", "var_samp", "stddev_pop", "stddev_samp",
    "first_value", "last_value",
}

# build-state keys needed per op (field-level arrays, all (S, NB))
_STATE_KEYS = {
    "count": ("n",),
    "sum": ("s", "n"),
    "mean": ("s", "n"),
    "min": ("mn", "n"),
    "max": ("mx", "n"),
    "var_pop": ("s", "s2", "n"),
    "var_samp": ("s", "s2", "n"),
    "stddev_pop": ("s", "s2", "n"),
    "stddev_samp": ("s", "s2", "n"),
    # first/last carry both directions: the window combine picks winners
    # from either half. "if"/"il" are intra-cell ms offsets.
    "first_value": ("vf", "if", "vl", "il", "n"),
    "last_value": ("vf", "if", "vl", "il", "n"),
}

# combine-state keys per op (besides "n")
_STATE_COMBINE = {
    "count": (),
    "sum": ("s",), "mean": ("s",),
    "min": ("m",), "max": ("m",),
    "var_pop": ("s", "s2"), "var_samp": ("s", "s2"),
    "stddev_pop": ("s", "s2"), "stddev_samp": ("s", "s2"),
    "first_value": ("vl", "il", "vf", "if"),
    "last_value": ("vl", "il", "vf", "if"),
}


@dataclass
class _Entry:
    version: tuple
    res: int                     # cell width, ms
    phase: int                   # cell boundaries ≡ phase (mod res)
    t0c: int                     # absolute ms of cell 0's left edge
    nb: int                      # number of cells
    num_series: int
    registry: object             # SeriesRegistry of the building scan
    rows_scanned: int
    # one device per shard (one entry: unsharded); every grid below is a
    # list of per-shard (S / shards, NB) tensors in shard order
    devices: list = dc_field(default_factory=lambda: [torch.device("cpu")])
    mesh: object = None          # the Mesh a sharded entry spans
    mesh_decision: object = None  # planner.MeshDecision (with a mesh)
    # field name -> state key -> per-shard (S, NB) grids
    fields: dict = dc_field(default_factory=dict)
    # field name -> True when data and f32 partials are all finite, so
    # presence can ride inside the value plane as NaN
    nan_ok: dict = dc_field(default_factory=dict)
    nrow: object = None          # (S, NB) int32 rows per cell
    imin: object = None          # (S, NB) int32 intra offset of min ts
    imax: object = None          # (S, NB) int32 intra offset of max ts
    # memoized prelude results keyed by (mask signature, lo, hi)
    prelude: dict = dc_field(default_factory=dict)
    # memoized per-query-shape device inputs (gid, mask, fold members)
    query_memo: dict = dc_field(default_factory=dict)
    nbytes: int = 0
    grow_lock: object = dc_field(default_factory=threading.Lock)
    # host-side grid arrays kept by build_entry(keep_host=True) until
    # persist_entry writes them as a restart snapshot
    host_snap: dict | None = None
    persist_thread: object = None    # persist_entry_async's thread
    # fields whose "n" state IS entry.nrow (every row valid)
    n_aliased: set = dc_field(default_factory=set)

    def recount_bytes(self) -> int:
        per = self.num_series * self.nb * 4
        seen = {id(self.nrow), id(self.imin), id(self.imax)}
        n_arr = 3
        for d in self.fields.values():
            for arr in d.values():
                if id(arr) not in seen:
                    seen.add(id(arr))
                    n_arr += 1
        self.nbytes = per * n_arr
        return self.nbytes

    def bytes(self) -> int:
        return self.nbytes


class DeviceRangeCache:
    """LRU of device grid entries shared by a QueryEngine, budgeted by
    entry count and by total device bytes. Entries are reused only while
    the table's data_version is the one they were built at."""

    def __init__(self, byte_budget: int = _BYTE_BUDGET):
        self._entries: dict[tuple, _Entry] = {}
        self._lock = threading.Lock()
        self.byte_budget = byte_budget
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        from greptimedb_tpu_torch.telemetry import memory as _memory

        _memory.register_pool(
            "range_grid", "device", self,
            stats=DeviceRangeCache._mem_stats,
            evict=DeviceRangeCache.evict_bytes,
            buffers=DeviceRangeCache._device_buffers,
        )

    def _release(self, entry: _Entry):
        """Drop the entry's session buffers with it (query/sessions.py):
        their keys embed id(entry), so a stale, replaced or evicted
        entry's buffers could never be probed again, and a later entry
        that reuses the id must not meet them."""
        self.evictions += 1
        sessions.global_sessions.purge_table(("range", id(entry)))

    def lookup_compatible(self, tkey, version, r0: int, align_to: int
                          ) -> _Entry | None:
        """A live entry for `tkey` whose resolution serves a query with
        bucket gcd r0 and phase align_to; stale versions are evicted."""
        with self._lock:
            for key in list(self._entries):
                if key[0] != tkey:
                    continue
                e = self._entries[key]
                if e.version != version:
                    del self._entries[key]
                    self._release(e)
                    continue
                if r0 % e.res == 0 and align_to % e.res == e.phase:
                    self._entries.pop(key)
                    self._entries[key] = e
                    self.hits += 1
                    return e
            self.misses += 1
        return None

    def insert(self, key: tuple, entry: _Entry):
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None and old is not entry:
                self._release(old)
            total = sum(e.bytes() for e in self._entries.values())
            total += entry.bytes()
            while self._entries and (
                len(self._entries) >= _MAX_ENTRIES
                or total > self.byte_budget
            ):
                victim = self._entries.pop(next(iter(self._entries)))
                self._release(victim)
                total -= victim.bytes()
            self._entries[key] = entry
        from greptimedb_tpu_torch.telemetry import memory as _memory

        _memory.note_device_bytes()

    def clear(self):
        """Drop every entry, and with each its session buffers."""
        with self._lock:
            for e in self._entries.values():
                self._release(e)
            self._entries.clear()

    def has_table(self, tkey) -> bool:
        with self._lock:
            return any(k[0] == tkey for k in self._entries)

    def insert_if_table_absent(self, key: tuple, entry: _Entry) -> bool:
        """Insert unless an entry of the same table arrived first (a warm
        restore racing a query's build)."""
        with self._lock:
            if any(k[0] == key[0] for k in self._entries):
                return False
        self.insert(key, entry)
        return True

    def reserve_growth(self, entry: _Entry, add: int) -> bool:
        """Admit an in-place growth of `add` bytes against the aggregate
        budget, evicting other LRU entries if needed."""
        with self._lock:
            if entry.bytes() + add > self.byte_budget:
                return False
            total = sum(e.bytes() for e in self._entries.values()) + add
            for key in list(self._entries):
                if total <= self.byte_budget:
                    break
                if self._entries[key] is entry:
                    continue
                victim = self._entries.pop(key)
                self._release(victim)
                total -= victim.bytes()
            return total <= self.byte_budget

    # ------------------------------------------------------------------
    # memory ledger surface (telemetry/memory.py)
    # ------------------------------------------------------------------
    def _mem_stats(self) -> dict:
        with self._lock:
            total = 0
            for e in self._entries.values():
                total += e.bytes()
                # the per-query-shape inputs ride the entry (query_memo)
                # outside recount_bytes' grid bytes: the watermark must
                # still see them
                for memo in list(e.query_memo.values()):
                    total += sum(t.numel() * t.element_size()
                                 for t in _memo_tensors(memo))
            return {
                "bytes": total,
                "entries": len(self._entries),
                "budget_bytes": self.byte_budget,
                "max_entries": _MAX_ENTRIES,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
            }

    def evict_bytes(self, target: int) -> int:
        """Shed LRU grid entries until `target` bytes are freed (the
        global device watermark)."""
        freed = 0
        with self._lock:
            while freed < target and self._entries:
                victim = self._entries.pop(next(iter(self._entries)))
                self._release(victim)
                freed += victim.bytes()
        return freed

    def _device_buffers(self):
        from greptimedb_tpu_torch.telemetry.memory import iter_device_arrays

        out = []
        with self._lock:
            for key, e in self._entries.items():
                tag = f"range:{key[0][0]}.{key[0][1]}"
                out += [(t, tag) for t in iter_device_arrays(
                    [e.nrow, e.imin, e.imax])]
                # list() snapshots: fields and query_memo grow under the
                # entry's own lock, not this one
                for fname, d in list(e.fields.items()):
                    out += [(t, f"{tag}:{fname}") for t in
                            iter_device_arrays(list(d.values()))]
                for memo in list(e.query_memo.values()):
                    out += [(t, f"{tag}:query_memo")
                            for t in _memo_tensors(memo)]
        return out


def _memo_tensors(memo: dict) -> list:
    """The device inputs a query shape keeps on its entry: the group ids,
    the active mask and K2's member lists."""
    from greptimedb_tpu_torch.telemetry.memory import iter_device_arrays

    parts = [memo.get("gid"), memo.get("mask")]
    for fm in memo.get("fold_members") or ():
        parts.extend(vars(fm).values())
    return list(iter_device_arrays(parts))


# ----------------------------------------------------------------------
# eligibility
# ----------------------------------------------------------------------

def plan_lowering(plan, table) -> list[tuple[str, str]] | None:
    """(field, op) per range item when `plan` lowers onto cell partials;
    None sends it to the host path. Checks everything except the cell
    alignment of time bounds (that needs the entry's resolution)."""
    if plan.kind != "range":
        return None
    if plan.scan.residual is not None:
        return None
    items = []
    for it in plan.range_items:
        if it.op not in _DEVICE_RANGE_OPS:
            return None
        if it.arg is None:
            if it.op != "count":
                return None
            items.append(("__rows__", it.op))
            continue
        if not isinstance(it.arg, Column):
            return None
        dt = table.schema.field_dtypes.get(it.arg.name)
        if dt is None or dt.kind not in "biuf":
            return None
        items.append((it.arg.name, it.op))
    for k in plan.keys:
        if not (isinstance(k.expr, Column) and k.expr.name in table.tag_names):
            return None
    return items


# ----------------------------------------------------------------------
# cache build (host numpy over the sorted scan, then one upload)
# ----------------------------------------------------------------------

def _is_sid_ts_sorted(sid: np.ndarray, ts: np.ndarray) -> bool:
    if len(sid) < 2:
        return True
    d_sid = np.diff(sid.astype(np.int64))
    return bool(np.all((d_sid > 0) | ((d_sid == 0) & (np.diff(ts) >= 0))))


def _pick_res(plan, ts: np.ndarray, num_series: int) -> int | None:
    r0 = plan.align_ms
    for it in plan.range_items:
        r0 = math.gcd(r0, it.range_ms)
    # estimate the data interval from time deltas (sorted by (sid, ts))
    if len(ts) > 1:
        d = np.diff(ts)
        pos = d[d > 0]
        if len(pos):
            res = math.gcd(r0, int(pos.min()))
            span = int(ts[-1]) - int(ts[0]) + res
            if num_series * (span // res + 1) <= _CELL_CAP:
                return res
    span = int(ts[-1]) - int(ts[0]) + r0 if len(ts) else r0
    if num_series * (span // r0 + 1) > _CELL_CAP:
        return None
    return r0


def _series_pad(s: int, mesh=None) -> int:
    """Pad the series axis to the fold-block multiple (and the shard
    count): block boundaries are part of the numeric contract — the
    blocked group fold combines per-block f32 partials in one fixed order,
    so sharded and one-device entries of the same table get identical
    block contents and bit-identical results."""
    n = shard_count(mesh)
    mult = FOLD_BLOCKS * n // math.gcd(FOLD_BLOCKS, n)
    return -(-s // mult) * mult


def _put(devices):
    """Host -> device placement: the series axis (dim 0) cut into one
    equal slice per shard device, in shard order."""
    ns = len(devices)

    def put(a: np.ndarray) -> list:
        a = np.ascontiguousarray(a)
        per = a.shape[0] // ns
        return [torch.from_numpy(np.ascontiguousarray(a[k * per:(k + 1) * per]))
                .to(d) for k, d in enumerate(devices)]
    return put


def build_entry(plan, table, items, *, device, mesh=None, mesh_opts=None,
                byte_budget: int = _BYTE_BUDGET,
                keep_host: bool = False) -> _Entry | None:
    """Scan the table once and build the device cell-state grids.

    With a mesh, the replicate-vs-shard planner decides placement from the
    series count: large grids are cut along the series axis over the
    mesh's devices, small ones stay on `device`. keep_host=True also keeps
    the host-side grid arrays on entry.host_snap. None (the host path
    answers) for an empty table and a grid past the cell cap or the byte
    budget."""
    needed: dict[str, set] = {}
    for fname, op in items:
        if fname != "__rows__":
            needed.setdefault(fname, set()).update(_STATE_KEYS[op])
    # version BEFORE the scan: a write racing the build leaves the entry
    # stamped stale, so the next query rebuilds
    version = table.data_version()
    data = table.scan(field_names=sorted(needed))
    rows = data.rows
    if rows is None or len(rows) == 0:
        return None
    ts = rows.ts
    sid = rows.sid
    if not _is_sid_ts_sorted(sid, ts):
        order = np.lexsort((ts, sid))
        ts = ts[order]
        sid = sid[order]
        reorder = order
    else:
        reorder = None
    S = max(data.registry.num_series, int(sid.max()) + 1 if len(sid) else 1)
    decision = None
    if mesh is not None:
        decision = decide_mesh_execution(mesh, kind="range", series=S,
                                         opts=mesh_opts)
        if not decision.shard:
            mesh = None
    S = _series_pad(S, mesh)
    res = _pick_res(plan, ts, S)
    if res is None or res >= _I32_MAX:
        # res >= 2^31 ms would overflow the exact int32 intra-cell offsets
        return None
    phase = plan.align_to % res
    data_min = int(ts.min())
    data_max = int(ts.max())
    t0c = phase + ((data_min - phase) // res) * res
    nb = (data_max - t0c) // res + 1
    if S * nb > _CELL_CAP:
        return None
    # projected device bytes for the full entry must fit the cache budget
    n_arr = 3 + sum(len(k) for k in needed.values())
    if S * nb * 4 * n_arr > byte_budget:
        return None

    cell = (ts - t0c) // res
    seg = sid.astype(np.int64) * nb + cell
    nseg = S * nb
    # exact intra-cell ms offset (0 <= intra < res < 2^31)
    intra = (ts - t0c - cell * res).astype(np.int64)

    entry = _Entry(
        version=version, res=res, phase=phase, t0c=t0c, nb=nb,
        num_series=S, registry=data.registry, rows_scanned=len(rows),
        devices=(list(mesh.devices) if mesh is not None
                 else [torch.device(device)]),
        mesh=mesh, mesh_decision=decision,
    )
    snap = {} if keep_host else None
    put = _put(entry.devices)
    shape = (S, nb)
    nrow = np.bincount(seg, minlength=nseg).reshape(shape).astype(np.int32)
    if snap is not None:
        snap["nrow"] = nrow
    entry.nrow = put(nrow)
    # per-cell ts extremes: rows are (sid, ts)-sorted, so each seg run's
    # first/last row give the extremes directly
    change = np.empty(len(seg), bool)
    if len(seg):
        change[0] = True
        change[1:] = seg[1:] != seg[:-1]
    starts = np.nonzero(change)[0]
    ends = np.r_[starts[1:], len(seg)] - 1
    useg = seg[starts]
    imin = np.zeros(nseg, np.int64)
    imax = np.zeros(nseg, np.int64)
    imin[useg] = intra[starts]
    imax[useg] = intra[ends]
    imin = imin.reshape(shape).astype(np.int32)
    imax = imax.reshape(shape).astype(np.int32)
    if snap is not None:
        snap["imin"] = imin
        snap["imax"] = imax
    entry.imin = put(imin)
    entry.imax = put(imax)

    for fname, keys in needed.items():
        vals = rows.fields[fname]
        if reorder is not None:
            vals = vals[reorder]
        vals = vals.astype(np.float64, copy=False)
        if rows.field_valid is not None and fname in rows.field_valid:
            valid = rows.field_valid[fname]
            if reorder is not None:
                valid = valid[reorder]
        else:
            valid = np.ones(len(vals), bool)
        states, nan_ok, n_aliased = _build_field_states(
            keys, vals, valid, seg, nseg, intra, shape, put,
            snap=snap, snap_prefix=f"f::{fname}::", nrow_alias=entry.nrow,
        )
        entry.fields[fname] = states
        entry.nan_ok[fname] = nan_ok
        if n_aliased:
            entry.n_aliased.add(fname)
    _ensure_rows_pseudo(entry, items)
    entry.recount_bytes()
    entry.host_snap = snap
    return entry


def _build_field_states(keys, vals, valid, seg, nseg, intra, shape, put,
                        snap=None, snap_prefix="", nrow_alias=None):
    out = {}

    def emit(key, arr):
        if snap is not None:
            snap[snap_prefix + key] = arr
        out[key] = put(arr)

    all_valid = valid.all()
    vm = vals if all_valid else np.where(valid, vals, 0.0)
    nan_ok = bool(np.isfinite(vm).all())
    n_aliased = False
    if all_valid and nrow_alias is not None:
        # every row carries this field: its per-cell count IS the row
        # count — alias the device tensor (no second build/transfer)
        out["n"] = nrow_alias
        n_aliased = True
    else:
        n = (np.bincount(seg, minlength=nseg) if all_valid
             else np.bincount(seg[valid], minlength=nseg))
        emit("n", n.reshape(shape).astype(np.int32))
    if "s" in keys:
        s = np.bincount(seg, weights=vm, minlength=nseg).astype(np.float32)
        nan_ok = nan_ok and bool(np.isfinite(s).all())
        emit("s", s.reshape(shape))
    if "s2" in keys:
        s2 = np.bincount(seg, weights=vm * vm, minlength=nseg).astype(
            np.float32
        )
        nan_ok = nan_ok and bool(np.isfinite(s2).all())
        emit("s2", s2.reshape(shape))
    if keys & {"mn", "mx", "vf", "if", "vl", "il"}:
        segf = seg if all_valid else seg[valid]
        vf_ = vals if all_valid else vals[valid]
        intraf = intra if all_valid else intra[valid]
        change = np.empty(len(segf), bool)
        if len(segf):
            change[0] = True
            change[1:] = segf[1:] != segf[:-1]
        starts = np.nonzero(change)[0]
        ends = np.r_[starts[1:], len(segf)] - 1
        useg = segf[starts]
        if "mn" in keys:
            arr = np.full(nseg, np.inf)
            if len(starts):
                arr[useg] = np.minimum.reduceat(vf_, starts)
            emit("mn", arr.reshape(shape).astype(np.float32))
        if "mx" in keys:
            arr = np.full(nseg, -np.inf)
            if len(starts):
                arr[useg] = np.maximum.reduceat(vf_, starts)
            emit("mx", arr.reshape(shape).astype(np.float32))
        if "vf" in keys:
            arr = np.zeros(nseg)
            t = np.zeros(nseg, np.int64)
            arr[useg] = vf_[starts]
            t[useg] = intraf[starts]
            emit("vf", arr.reshape(shape).astype(np.float32))
            emit("if", t.reshape(shape).astype(np.int32))
        if "vl" in keys:
            arr = np.zeros(nseg)
            t = np.zeros(nseg, np.int64)
            arr[useg] = vf_[ends]
            t[useg] = intraf[ends]
            emit("vl", arr.reshape(shape).astype(np.float32))
            emit("il", t.reshape(shape).astype(np.int32))
    return out, nan_ok, n_aliased


def _ensure_rows_pseudo(entry, items):
    if any(f == "__rows__" for f, _ in items):
        entry.fields.setdefault("__rows__", {})["n"] = entry.nrow


def entry_from_host_arrays(snap: dict, meta: dict, *, registry, device,
                           version=None) -> _Entry:
    """A port grid entry from a JAX grid entry's host arrays.

    `snap` is the JAX entry's host_snap (build_entry(..., keep_host=True)):
    "nrow", "imin", "imax" and "f::<field>::<state>" arrays; a field
    without an "n" state had it aliased to nrow. `meta` carries res,
    phase, t0c, nb, num_series and optionally nan_ok ({field: bool}).
    Both range programs can then run on bit-identical grids."""
    dev = torch.device(device)
    put = _put([dev])
    entry = _Entry(
        version=version, res=int(meta["res"]), phase=int(meta["phase"]),
        t0c=int(meta["t0c"]), nb=int(meta["nb"]),
        num_series=int(meta["num_series"]), registry=registry,
        rows_scanned=int(meta.get("rows_scanned", 0)), devices=[dev],
    )
    entry.nrow = put(snap["nrow"])
    entry.imin = put(snap["imin"])
    entry.imax = put(snap["imax"])
    nan_ok = meta.get("nan_ok") or {}
    for key, arr in snap.items():
        if key.startswith("f::"):
            _, fname, state = key.split("::")
            entry.fields.setdefault(fname, {})[state] = put(arr)
    for fname, states in entry.fields.items():
        if "n" not in states:
            states["n"] = entry.nrow
            entry.n_aliased.add(fname)
        entry.nan_ok[fname] = bool(nan_ok.get(fname, False))
    entry.recount_bytes()
    return entry


def ensure_states(entry: _Entry, table, items,
                  cache: DeviceRangeCache | None = None) -> bool:
    """Add any state tensors a new query needs that the entry lacks (same
    resolution/phase, different ops). False when the table changed under
    the entry or the growth does not fit the budget."""
    if table.data_version() != entry.version:
        return False
    with entry.grow_lock:
        return _ensure_states_locked(entry, table, items, cache)


def _ensure_states_locked(entry, table, items, cache) -> bool:
    missing: dict[str, set] = {}
    for fname, op in items:
        if fname == "__rows__":
            _ensure_rows_pseudo(entry, items)
            continue
        have = entry.fields.get(fname, {})
        want = set(_STATE_KEYS[op]) - set(have)
        if want:
            missing.setdefault(fname, set()).update(want)
    if not missing:
        return True
    add = 0
    for fname, keys in missing.items():
        have = set(entry.fields.get(fname, {}))
        add += entry.num_series * entry.nb * 4 * len((keys | {"n"}) - have)
    if cache is not None and not cache.reserve_growth(entry, add):
        return False
    data = table.scan(field_names=sorted(missing))
    if table.data_version() != entry.version:
        return False
    rows = data.rows
    if rows is None:
        return False
    ts, sid = rows.ts, rows.sid
    order = None
    if not _is_sid_ts_sorted(sid, ts):
        order = np.lexsort((ts, sid))
        ts, sid = ts[order], sid[order]
    cell = (ts - entry.t0c) // entry.res
    seg = sid.astype(np.int64) * entry.nb + cell
    nseg = entry.num_series * entry.nb
    if len(cell) and (cell.min() < 0 or cell.max() >= entry.nb
                      or sid.max() >= entry.num_series):
        return False
    intra = (ts - entry.t0c - cell * entry.res).astype(np.int64)
    shape = (entry.num_series, entry.nb)
    put = _put(entry.devices)
    for fname, keys in missing.items():
        vals = rows.fields[fname]
        valid = (rows.field_valid or {}).get(fname)
        if order is not None:
            vals = vals[order]
            valid = valid[order] if valid is not None else None
        if valid is None:
            valid = np.ones(len(vals), bool)
        states, nan_ok, n_aliased = _build_field_states(
            keys | {"n"}, vals.astype(np.float64, copy=False), valid,
            seg, nseg, intra, shape, put, nrow_alias=entry.nrow,
        )
        entry.fields.setdefault(fname, {}).update(states)
        entry.nan_ok[fname] = entry.nan_ok.get(fname, True) and nan_ok
        if n_aliased:
            entry.n_aliased.add(fname)
    entry.recount_bytes()
    return True


# ----------------------------------------------------------------------
# device programs
# ----------------------------------------------------------------------

def _clamp_i32(v: int) -> int:
    """Cell bounds from WHERE ts can land far outside the grid; clamping
    both directions is lossless (comparisons only see cells in [0, nb))."""
    return max(-(2**31) + 1, min(int(v), 2**31 - 1))


def run_prelude(entry: _Entry, sid_mask: np.ndarray | None, lo: int, hi: int):
    """Exact (active sids, filtered ts_min, ts_max) from cell states.
    Memoized per (mask signature, bounds) on the entry. A sharded entry
    reduces its per-shard partials explicitly, on the first shard's
    device; any/min/max are exact in any order."""
    key = (sid_mask.tobytes() if sid_mask is not None else None, lo, hi)
    hit = entry.prelude.get(key)
    if hit is not None:
        return hit
    if len(entry.prelude) >= 32:
        entry.prelude.pop(next(iter(entry.prelude)))
    masks = (_put(entry.devices)(sid_mask) if sid_mask is not None
             else [None] * len(entry.devices))
    from greptimedb_tpu_torch.telemetry import device_trace

    # the prelude runs before every device RANGE query; one program per
    # grid geometry
    with device_trace.device_call(
            "range_prelude",
            key=("prelude", tuple(tuple(t.shape) for t in entry.nrow)),
            device=entry.devices[0]) as dcall:
        act_any, bounds = dcall.run(_prelude_program, entry, masks, lo, hi)
        dcall.executed()
        if dcall.first:
            # the nrow/imin/imax planes read once; a compare per cell
            dcall.declare(sum(t.numel() for t in entry.nrow),
                          sum(t.numel() * t.element_size()
                              for t in (*entry.nrow, *entry.imin,
                                        *entry.imax)))
        act_h = readback.read_gathered(act_any)
        c_lo, i_lo, c_hi, i_hi = (int(v) for v in readback.read_full(bounds))
        dcall.transfer(act_h.nbytes + bounds.numel() * bounds.element_size())
    if not act_h.any():
        out = (act_h, None, None)
    else:
        out = (
            act_h,
            entry.t0c + c_lo * entry.res + i_lo,
            entry.t0c + c_hi * entry.res + i_hi,
        )
    entry.prelude[key] = out
    return out


def _prelude_program(entry: _Entry, masks: list, lo: int, hi: int):
    """The prelude's launches: (per-shard active-sid masks, the stacked
    int32 (c_lo, i_lo, c_hi, i_hi)) on the card."""
    nb = entry.nb
    dev0 = entry.devices[0]
    acts, cells = [], []
    for nrow, mask in zip(entry.nrow, masks):
        c = torch.arange(nb, dtype=torch.int32, device=nrow.device)
        act = (nrow > 0) & ((c >= _clamp_i32(lo)) & (c < _clamp_i32(hi)))[
            None, :]
        acts.append(act if mask is None else act & mask[:, None])
        cells.append(c)
    colact = acts[0].any(dim=0)
    for a in acts[1:]:
        colact = colact | a.any(dim=0).to(dev0)
    # global min ts lives in the first active cell (cells are
    # time-ordered), global max in the last: two exact int32 stages
    c_lo = torch.where(colact, cells[0], _I32_MAX).min()
    c_hi = torch.where(colact, cells[0], -1).max()
    i_lo = i_hi = None
    for act, c, imin, imax in zip(acts, cells, entry.imin, entry.imax):
        lo_k = torch.where(act & (c[None, :] == c_lo.to(c.device)), imin,
                           _I32_MAX).min().to(dev0)
        hi_k = torch.where(act & (c[None, :] == c_hi.to(c.device)), imax,
                           -1).max().to(dev0)
        i_lo = lo_k if i_lo is None else torch.minimum(i_lo, lo_k)
        i_hi = hi_k if i_hi is None else torch.maximum(i_hi, hi_k)
    return ([a.any(dim=1) for a in acts],
            torch.stack([c_lo, i_lo, c_hi, i_hi]))


# window-combine machinery (device mirror of the host path's
# _combine_states/_shift_left/_window_combine/_finalize_window)

def _identity(key, op):
    if key == "mn" or (key == "m" and op == "min"):
        return math.inf
    if key == "mx" or (key == "m" and op == "max"):
        return -math.inf
    if key == "cl":
        return -1          # "no cell": loses every last-cell max
    if key == "cf":
        return _I32_MAX    # "no cell": loses every first-cell min
    if key in ("il", "if"):
        return 0           # intra offsets are tie-broken under cl/cf
    return 0.0


def _ck_to_bk(ck: str, op: str) -> str:
    if ck == "m":
        return "mn" if op == "min" else "mx"
    return ck


def _shift_left_j(state: dict, k: int, op):
    out = {}
    for key, v in state.items():
        pad = torch.full((v.shape[0], k), _identity(key, op), dtype=v.dtype,
                         device=v.device)
        out[key] = torch.cat([v[:, k:], pad], dim=1)
    return out


def _combine_j(op, a: dict, b: dict):
    if op == "count":
        return {"n": a["n"] + b["n"]}
    if op in ("sum", "mean"):
        return {"s": a["s"] + b["s"], "n": a["n"] + b["n"]}
    if op == "min":
        return {"m": torch.minimum(a["m"], b["m"]), "n": a["n"] + b["n"]}
    if op == "max":
        return {"m": torch.maximum(a["m"], b["m"]), "n": a["n"] + b["n"]}
    if op in ("var_pop", "var_samp", "stddev_pop", "stddev_samp"):
        return {"s": a["s"] + b["s"], "s2": a["s2"] + b["s2"],
                "n": a["n"] + b["n"]}
    if op in ("first_value", "last_value"):
        # exact (cell, intra) lexicographic timestamp compare; a and b
        # come from distinct cells, so cl/cf ties only happen between
        # empty halves (where the value is irrelevant)
        pick_b_last = (b["cl"] > a["cl"]) | (
            (b["cl"] == a["cl"]) & (b["il"] > a["il"])
        )
        pick_a_first = (a["cf"] < b["cf"]) | (
            (a["cf"] == b["cf"]) & (a["if"] <= b["if"])
        )
        return {
            "vl": torch.where(pick_b_last, b["vl"], a["vl"]),
            "il": torch.where(pick_b_last, b["il"], a["il"]),
            "cl": torch.maximum(a["cl"], b["cl"]),
            "vf": torch.where(pick_a_first, a["vf"], b["vf"]),
            "if": torch.where(pick_a_first, a["if"], b["if"]),
            "cf": torch.minimum(a["cf"], b["cf"]),
            "n": a["n"] + b["n"],
        }
    raise UnsupportedError(op)


def _window_combine_j(op, state: dict, w: int):
    """Combine every window of w consecutive cells by stride doubling:
    level tables of width 1, 2, 4, ... then the binary decomposition of
    w. Every step is an elementwise op on shifted tensors, so the order
    of float additions is the JAX program's order."""
    if w == 1:
        return state
    tables = {1: state}
    size = 1
    cur = state
    while size < w:
        cur = _combine_j(op, cur, _shift_left_j(cur, size, op))
        size *= 2
        tables[size] = cur
    result = None
    offset = 0
    remaining = w
    bit = 1
    parts = []
    while remaining:
        if remaining & bit:
            parts.append((offset, bit))
            offset += bit
            remaining &= ~bit
        bit <<= 1
    for off, sz in parts:
        st = tables[sz]
        piece = _shift_left_j(st, off, op) if off else st
        result = piece if result is None else _combine_j(op, result, piece)
    return result


def _finalize_j(op, state: dict):
    n = state["n"].to(torch.float32)
    present = state["n"] > 0
    if op == "count":
        return n, present
    if op == "sum":
        return torch.where(present, state["s"], 0.0), present
    if op == "mean":
        return state["s"] / torch.clamp(n, min=1), present
    if op in ("min", "max"):
        return torch.where(present, state["m"], 0.0), present
    if op in ("var_pop", "var_samp", "stddev_pop", "stddev_samp"):
        ddof = 1 if op.endswith("_samp") else 0
        mean = state["s"] / torch.clamp(n, min=1)
        # XLA:CPU contracts s2 / n - mean * mean into one fused
        # multiply-add (an fnmadd), in float32 and in float64 alike
        var = torch.clamp(W._fma(-mean, mean,
                                 state["s2"] / torch.clamp(n, min=1)),
                          min=0.0)
        if ddof:
            var = var * n / torch.clamp(n - 1, min=1)
            present = state["n"] > 1
        if op.startswith("stddev"):
            return W.sqrt_rn(var), present
        return var, present
    if op == "last_value":
        return torch.where(present, state["vl"], 0.0), present
    if op == "first_value":
        return torch.where(present, state["vf"], 0.0), present
    raise UnsupportedError(op)


def _fold_blocks(g: int, nb: int, s: int) -> int:
    """Series-block count for the group fold: FOLD_BLOCKS when the
    (blocks, g, nb) partial is affordable and the series axis is
    block-aligned; 1 degenerates to the direct fold."""
    if s % FOLD_BLOCKS == 0 and FOLD_BLOCKS * g * nb <= _FOLD_CAP:
        return FOLD_BLOCKS
    return 1


def _segment_ext(x: torch.Tensor, gid: torch.Tensor, g: int,
                 take_max: bool) -> torch.Tensor:
    """jax.ops.segment_max/min over dim 0: empty segments hold the JAX
    identity (-inf/+inf for floats, INT32_MIN/MAX for int32), never zero.
    Sids with gid >= g land in an extra segment that is sliced off.
    min/max are order-free except for signed zeros: scatter_reduce compares
    -0.0 and +0.0 equal and keeps either, where XLA orders -0.0 below +0.0,
    so a float zero result takes its sign from whether the segment holds
    the winning zero (+0.0 for max, -0.0 for min), as
    ops/promql.segment_ext does."""
    if x.dtype.is_floating_point:
        ident = -math.inf if take_max else math.inf
    else:
        ident = _I32_MIN if take_max else _I32_MAX
    out = torch.full((g + 1, x.shape[1]), ident, dtype=x.dtype,
                     device=x.device)
    idx = gid.clamp(max=g).to(torch.int64)[:, None].expand_as(x)
    reduce = "amax" if take_max else "amin"
    out.scatter_reduce_(0, idx, x, reduce=reduce, include_self=True)
    if x.dtype.is_floating_point:
        winner = (x == 0) & (torch.signbit(x) != take_max)
        has_winner = torch.zeros((g + 1, x.shape[1]), dtype=torch.int32,
                                 device=x.device)
        has_winner.scatter_reduce_(0, idx, winner.to(torch.int32),
                                   reduce="amax", include_self=True)
        zero, other = (0.0, -0.0) if take_max else (-0.0, 0.0)
        out = torch.where(out == 0, torch.where(has_winner > 0, zero, other),
                          out)
    return out[:g]


def _segment_sum_onehot(x: torch.Tensor, gid: torch.Tensor, g: int):
    """Segment sum of a masked one-nonzero payload: per (group, cell) at
    most one addend is not +0.0, so any order (index_add_'s atomics on
    CUDA included) gives the same bits."""
    out = torch.zeros((g + 1, x.shape[1]), dtype=x.dtype, device=x.device)
    out.index_add_(0, gid.clamp(max=g).to(torch.int64), x)
    return out[:g]


def _fold_groups(op, states, q, g, ctx):
    """Fold per-series cell states into per-group states.

    `states` holds one dict per shard (its slice of the series axis, in
    shard order); the folded dict comes back on the first shard's device.
    n/s/s2 fold through the ctx's blocked sum (FOLD_BLOCKS series blocks
    combined in one fixed left-fold order, bit-identical to the JAX
    package at every shard count); min/max are exactly associative;
    first/last winners resolve by exact (ts, sid) staged selection and a
    masked one-nonzero sum."""
    out = {}
    gids = q["gid"]
    fms = q["fold_members"]
    s_local = states[0]["n"].shape[0]
    for key in ("n", "s", "s2"):
        if key in states[0]:
            out[key] = ctx.fold_sum([st[key] for st in states], fms)[0]
    if "m" in states[0]:
        tm = op != "min"
        out["m"] = ctx.pext([_segment_ext(st["m"], gid, g, take_max=tm)
                             for st, gid in zip(states, gids)],
                            take_max=tm)[0]
    # gathers by gid clamp inactive sids (gid == g) to g - 1, as JAX's
    # out-of-bounds gather does; those sids have n == 0, so they never tie
    gidcs = [gid.clamp(max=g - 1).to(torch.int64) for gid in gids]
    # global sids: shard k holds sids [k * s_local, (k + 1) * s_local)
    sids = [(k * s_local + torch.arange(s_local, dtype=torch.int32,
                                        device=gid.device))[:, None]
            for k, gid in enumerate(gids)]
    has = [st["n"] > 0 for st in states]

    # first/last across sids within one cell: winner = (ts, sid)
    # lexicographic (max ts then max sid for last; min ts then min sid
    # for first). The winner is unique, so its value comes out of a
    # masked sum — exact for any float value incl. ±inf/NaN.
    def fold_extreme(vkey, tkey, pick_max):
        t_id = -1 if pick_max else _I32_MAX
        ts = [torch.where(h, st[tkey], t_id) for h, st in zip(has, states)]
        win_t = ctx.pext([_segment_ext(t, gid, g, pick_max)
                          for t, gid in zip(ts, gids)], take_max=pick_max)
        ties = [h & (t == w[gc])
                for h, t, w, gc in zip(has, ts, win_t, gidcs)]
        sid_w = ctx.pext([_segment_ext(torch.where(tie, sid, t_id), gid, g,
                                       pick_max)
                          for tie, sid, gid in zip(ties, sids, gids)],
                         take_max=pick_max)
        v = ctx.psum([
            _segment_sum_onehot(
                torch.where(tie & (sid == w[gc]), st[vkey], 0.0), gid, g)
            for tie, sid, w, gc, st, gid in zip(ties, sids, sid_w, gidcs,
                                                states, gids)])
        return v[0], torch.clamp(win_t[0], 0, _I32_MAX - 1)

    if "il" in states[0]:
        out["vl"], out["il"] = fold_extreme("vl", "il", True)
    if "if" in states[0]:
        out["vf"], out["if"] = fold_extreme("vf", "if", False)
    return out


def _disjoint_reduce(op, state, n_steps, w):
    """Disjoint windows (w == stride): reshape-reduce. The float sums
    reduce w cells in torch's order, not XLA's — the one place the range
    program's sums may differ from the JAX package by rounding."""
    out = {}
    if op in ("first_value", "last_value"):
        G = state["n"].shape[0]
        n_r = state["n"].reshape(G, n_steps, w)
        has = n_r > 0
        pos = torch.arange(w, dtype=torch.int32,
                           device=n_r.device)[None, None, :]
        # cells within a window carry distinct time ranges, so the
        # last/first present cell is the exact winner. torch.argmax/argmin
        # return the first extreme, as jnp does.
        am_l = torch.argmax(torch.where(has, pos, -1), dim=2, keepdim=True)
        am_f = torch.argmin(torch.where(has, pos, _I32_MAX), dim=2,
                            keepdim=True)
        for k, v in state.items():
            r = v.reshape(G, n_steps, w)
            if k == "n":
                out[k] = r.sum(dim=2, dtype=r.dtype)
            elif k in ("vl", "il", "cl"):
                out[k] = torch.gather(r, 2, am_l)[..., 0]
            elif k in ("vf", "if", "cf"):
                out[k] = torch.gather(r, 2, am_f)[..., 0]
        return out
    for k, v in state.items():
        r = v.reshape(v.shape[0], n_steps, w)
        if k in ("n", "s", "s2"):
            out[k] = r.sum(dim=2, dtype=r.dtype)
        elif k == "m":
            out[k] = r.amin(dim=2) if op == "min" else r.amax(dim=2)
    return out


def _masked_state(op, raw: dict, live: torch.Tensor) -> dict:
    """One shard's build-state grids masked to the query's live cells and
    mapped to combine-state keys."""
    state = {"n": torch.where(live, raw["n"], 0)}
    for bk, ck in (("s", "s"), ("s2", "s2"), ("mn", "m"), ("mx", "m"),
                   ("vl", "vl"), ("il", "il"), ("vf", "vf"), ("if", "if")):
        if bk in raw and ck in _STATE_COMBINE.get(op, ()):
            v = raw[bk]
            if ck not in ("il", "if"):
                v = v.to(torch.float32)
            state[ck] = torch.where(live, v, _identity(bk, op))
    return state


def _window_finalize(op, state: dict, w: int, stride: int, n_steps: int,
                     delta: int, nanenc: bool):
    """The query's window over one (rows, nb) state: gather its cells,
    combine every window of w cells, sample each step, finalize."""
    nb = state["n"].shape[1]
    dev = state["n"].device
    # gather the query's cell window: nb_q cells starting at delta
    # (delta and the clamped indices may be negative: they are python
    # ints / int64, never floor-divided here)
    nb_q = (n_steps - 1) * stride + w
    idx = delta + torch.arange(nb_q, dtype=torch.int64, device=dev)
    okc = (idx >= 0) & (idx < nb)
    safe = torch.clamp(idx, 0, nb - 1)
    state = {
        k: torch.where(okc[None, :], v.index_select(1, safe),
                       _identity(_ck_to_bk(k, op), op))
        for k, v in state.items()
    }
    if op in ("first_value", "last_value"):
        # cell keys for the lexicographic (cell, intra) ts compare;
        # window position is monotone in absolute cell index
        pres = state["n"] > 0
        pos = torch.arange(nb_q, dtype=torch.int32, device=dev)[None, :]
        state["cl"] = torch.where(pres, pos, -1)
        state["cf"] = torch.where(pres, pos, _I32_MAX)
    if w == stride and nb_q == n_steps * w:
        # disjoint windows: reshape-reduce (the TSBS double-groupby shape
        # — dense reductions, no stride doubling)
        combined = _disjoint_reduce(op, state, n_steps, w)
    else:
        combined = _window_combine_j(op, state, w)
        combined = {k: v[:, 0:(n_steps - 1) * stride + 1:stride]
                    for k, v in combined.items()}
    v, p = _finalize_j(op, combined)
    if nanenc:
        # presence rides inside the value plane as NaN (data is known
        # all-finite): halves the result payload
        v = torch.where(p, v, math.nan)
    return v.to(torch.float32), p


def _range_body(arrs, q, spec, ctx):
    """One RANGE query over the per-shard cell-state grids. spec =
    (stride, n_steps, g, fold, nanenc, items), items (op, w, field_key);
    q holds the query's per-shard device inputs (gid, mask, fold members)
    and delta, lo, hi.

    Every shard masks its own rows. fold=True folds the shards into one
    group state (the ctx hooks are the only place shards meet) and runs
    the window combine once; fold=False keeps one output per shard.
    Returns the output tensors, one per part, in shard order."""
    stride, n_steps, g, fold, nanenc, items = spec
    nb = next(iter(next(iter(arrs.values())).values()))[0].shape[1]
    lives = []
    for mask in q["mask"]:
        c = torch.arange(nb, dtype=torch.int32, device=mask.device)
        lives.append(((c >= q["lo"]) & (c < q["hi"]))[None, :]
                     & mask[:, None])
    n_parts = 1 if fold else len(lives)
    vals_out = [[] for _ in range(n_parts)]
    pres_out = [[] for _ in range(n_parts)]
    for op, w, fkey in items:
        raw = arrs[fkey]
        states = [_masked_state(op, {bk: v[k] for bk, v in raw.items()},
                                live) for k, live in enumerate(lives)]
        if fold:
            states = [_fold_groups(op, states, q, g, ctx)]
        for part, state in enumerate(states):
            v, p = _window_finalize(op, state, w, stride, n_steps,
                                    q["delta"], nanenc)
            vals_out[part].append(v)
            pres_out[part].append(p)
    # ONE output tensor per part -> one device->host transfer per query
    if nanenc:
        return [torch.stack(v) for v in vals_out]
    return [torch.cat([torch.stack(v), torch.stack(p).to(torch.float32)],
                      dim=0)
            for v, p in zip(vals_out, pres_out)]


# ----------------------------------------------------------------------
# orchestration
# ----------------------------------------------------------------------

def _group_ids_from_sids(plan, registry, active: np.ndarray):
    """Per-sid group ids over the entry's series space. Returns
    (gid_full (S,) int32 with inactive sids routed to g, g, key_cols)."""
    from greptimedb_tpu_torch.query.executor import Col

    S = len(active)
    act_idx = np.nonzero(active)[0]
    if not plan.keys:
        gid_full = np.full(S, 1, np.int32)
        gid_full[act_idx] = 0
        return gid_full, 1, {}
    code_cols = []
    vocabs = []
    cards = []
    for k in plan.keys:
        name = k.expr.name
        codes = np.zeros(S, np.int64)
        tc = registry.tag_codes(name).astype(np.int64)
        codes[:len(tc)] = tc
        vocab = np.asarray(
            registry.dicts[registry.tag_names.index(name)].values,
            dtype=object,
        )
        code_cols.append(codes)
        vocabs.append(vocab)
        cards.append(max(len(vocab), 1))
    combined = code_cols[0].copy()
    for codes, card in zip(code_cols[1:], cards[1:]):
        combined = combined * card + codes
    uniq, inv = np.unique(combined[act_idx], return_inverse=True)
    g = len(uniq)
    gid_full = np.full(S, g, np.int32)
    gid_full[act_idx] = np.ravel(inv).astype(np.int32)
    key_cols = {}
    rem = uniq
    for i in range(len(code_cols) - 1, -1, -1):
        card = cards[i]
        code_i = rem % card
        rem = rem // card
        key_cols[plan.keys[i].key] = Col(vocabs[i][code_i])
    return gid_full, g, key_cols


# ----------------------------------------------------------------------
# restart snapshots (the module docstring)
# ----------------------------------------------------------------------

_SNAP_DIRNAME = "device_cache"
_SNAP_MAGIC = b"GTDEVC1\n"
_SNAP_ALIGN = 64
_snapshot_io_lock = threading.Lock()
# per-table restore serialization: a warm thread and a racing query must
# not both decode and upload the same snapshot
_restore_locks: dict = {}


def _restore_lock(tkey) -> threading.Lock:
    with _snapshot_io_lock:
        return _restore_locks.setdefault(tkey, threading.Lock())


def _ver_json(version) -> str:
    import json

    def norm(v):
        if isinstance(v, (list, tuple)):
            return [norm(x) for x in v]
        return int(v) if isinstance(v, (bool, np.integer)) else v

    return json.dumps(norm(version))


def _snapshot_region(table):
    """The durable region a table's snapshots live under (None: a table
    in memory)."""
    region = getattr(table, "region", None)
    if region is None or getattr(region, "store", None) is None:
        return None
    return region


def _host_arrays(entry: _Entry) -> dict:
    """The entry's grids read back from its devices (shards concatenated
    along the series axis), keyed as build_entry's host_snap."""
    def host(parts):
        return torch.cat([t.cpu() for t in parts]).numpy()

    snap = {"nrow": host(entry.nrow), "imin": host(entry.imin),
            "imax": host(entry.imax)}
    for fname, states in entry.fields.items():
        if fname == "__rows__":
            continue
        for skey, arr in states.items():
            if skey == "n" and fname in entry.n_aliased:
                continue
            snap[f"f::{fname}::{skey}"] = host(arr)
    return snap


def persist_entry(entry: _Entry, table) -> bool:
    """Write the entry's grids as a restart snapshot under the region's
    directory: the host arrays build_entry(..., keep_host=True) kept (and
    clears them), or, once they are gone, every grid read back from the
    device, so an entry grown by later queries persists whole.

    Format: magic + u64 JSON-meta length + meta + 64-aligned raw arrays,
    flat so load_entry_snapshot can memory-map each array."""
    import io
    import json
    import os

    snap = entry.host_snap
    entry.host_snap = None
    region = _snapshot_region(table)
    if region is None:
        return False
    if snap is None:
        with entry.grow_lock:
            snap = _host_arrays(entry)
    names = list(snap)
    layout = []
    off = 0
    for k in names:
        arr = np.ascontiguousarray(snap[k])
        snap[k] = arr
        off += (-off) % _SNAP_ALIGN
        layout.append({"key": k, "dtype": arr.dtype.str,
                       "shape": list(arr.shape), "offset": off,
                       "nbytes": arr.nbytes})
        off += arr.nbytes
    meta = {
        "version": _ver_json(entry.version),
        "res": entry.res, "phase": entry.phase, "t0c": entry.t0c,
        "nb": entry.nb, "num_series": entry.num_series,
        "rows_scanned": entry.rows_scanned,
        "nan_ok": {k: bool(v) for k, v in entry.nan_ok.items()},
        "n_alias": sorted(entry.n_aliased),
        "arrays": layout,
    }
    mb = json.dumps(meta).encode()
    header = _SNAP_MAGIC + len(mb).to_bytes(8, "little") + mb
    data_start = len(header) + ((-len(header)) % _SNAP_ALIGN)

    def stream(f):
        f.write(header)
        f.write(b"\0" * (data_start - len(header)))
        pos = 0
        for k, ent in zip(names, layout):
            f.write(b"\0" * (ent["offset"] - pos))
            f.write(memoryview(snap[k]).cast("B"))
            pos = ent["offset"] + ent["nbytes"]

    path = (f"{region.prefix}/{_SNAP_DIRNAME}/"
            f"grid_{entry.res}_{entry.phase}.gtdc")
    try:
        with _snapshot_io_lock:
            try:
                lp = region.store.local_path(path)
            except NotImplementedError:
                buf = io.BytesIO()
                stream(buf)
                region.store.write(path, buf.getvalue())
            else:
                os.makedirs(os.path.dirname(lp), exist_ok=True)
                tmp = lp + ".tmp"
                with open(tmp, "wb") as f:
                    stream(f)
                os.replace(tmp, lp)
        return True
    except OSError:
        return False


def persist_entry_async(entry: _Entry, table):
    """persist_entry on a daemon thread; returns the thread (also kept as
    entry.persist_thread, so a caller can wait for the file)."""
    if entry.host_snap is None:
        return None
    t = threading.Thread(target=persist_entry, args=(entry, table),
                         daemon=True, name="device-cache-persist")
    entry.persist_thread = t
    t.start()
    return t


def _snap_open(region, path):
    """-> (meta, fetch(layout entry) -> numpy view). Local files
    memory-map; other stores slice the object's bytes."""
    import json

    try:
        lp = region.store.local_read_path(path)
    except (NotImplementedError, FileNotFoundError, OSError):
        raw = region.store.read(path)
        if raw[:len(_SNAP_MAGIC)] != _SNAP_MAGIC:
            raise ValueError("bad snapshot magic")
        mlen = int.from_bytes(
            raw[len(_SNAP_MAGIC):len(_SNAP_MAGIC) + 8], "little")
        hdr_end = len(_SNAP_MAGIC) + 8 + mlen
        meta = json.loads(raw[len(_SNAP_MAGIC) + 8:hdr_end])
        data_start = hdr_end + ((-hdr_end) % _SNAP_ALIGN)

        def fetch(ent):
            dt = np.dtype(ent["dtype"])
            return np.frombuffer(
                raw, dt, count=ent["nbytes"] // dt.itemsize,
                offset=data_start + ent["offset"]).reshape(ent["shape"])

        return meta, fetch

    with open(lp, "rb") as f:
        if f.read(len(_SNAP_MAGIC)) != _SNAP_MAGIC:
            raise ValueError("bad snapshot magic")
        mlen = int.from_bytes(f.read(8), "little")
        meta = json.loads(f.read(mlen))
    hdr_end = len(_SNAP_MAGIC) + 8 + mlen
    data_start = hdr_end + ((-hdr_end) % _SNAP_ALIGN)

    def fetch(ent):
        return np.memmap(lp, dtype=np.dtype(ent["dtype"]), mode="r",
                         offset=data_start + ent["offset"],
                         shape=tuple(ent["shape"]))

    return meta, fetch


def load_entry_snapshot(table, r0: int, align_to: int, *, device,
                        mesh=None, mesh_opts=None,
                        byte_budget: int = _BYTE_BUDGET) -> _Entry | None:
    """Restore a compatible snapshot for the table's CURRENT data version
    onto `device` (or the mesh the planner picks for its series count),
    deleting stale snapshot files as they are found."""
    region = _snapshot_region(table)
    if region is None:
        return None
    prefix = f"{region.prefix}/{_SNAP_DIRNAME}/"
    # captured once: the restored entry carries the version validated
    version = table.data_version()
    cur_ver = _ver_json(version)
    with _snapshot_io_lock:
        metas = region.store.list(prefix)
    for m in metas:
        base = m.path.rsplit("/", 1)[-1]
        if base.startswith("grid_") and base.endswith(".gtdc"):
            try:
                _, res_s, phase_s = base[:-5].split("_")
                if (r0 % int(res_s) != 0
                        or align_to % int(res_s) != int(phase_s)):
                    continue
            except ValueError:
                pass
        try:
            with _snapshot_io_lock:
                meta, fetch = _snap_open(region, m.path)
        except (OSError, ValueError):
            region.store.delete(m.path)
            continue
        if meta["version"] != cur_ver:
            # stale: the data changed since this snapshot was written
            region.store.delete(m.path)
            continue
        res, phase = meta["res"], meta["phase"]
        if r0 % res != 0 or align_to % res != phase:
            continue
        S, nb = meta["num_series"], meta["nb"]
        if S * nb * 4 * len(meta["arrays"]) > byte_budget:
            continue
        decision = None
        if mesh is not None:
            decision = decide_mesh_execution(mesh, kind="range", series=S,
                                             opts=mesh_opts)
            if decision.shard and S % shard_count(mesh):
                # an unsharded build's series axis may not split evenly
                decision = type(decision)("replicate", "snapshot_unaligned",
                                          devices=decision.devices)
            if not decision.shard:
                mesh = None
        entry = _Entry(
            version=version, res=res, phase=phase, t0c=meta["t0c"], nb=nb,
            num_series=S, registry=region.series,
            rows_scanned=meta["rows_scanned"],
            devices=(list(mesh.devices) if mesh is not None
                     else [torch.device(device)]),
            mesh=mesh, mesh_decision=decision,
        )
        put = _put(entry.devices)
        by_key = {ent["key"]: ent for ent in meta["arrays"]}
        entry.nrow = put(np.array(fetch(by_key["nrow"])))
        entry.imin = put(np.array(fetch(by_key["imin"])))
        entry.imax = put(np.array(fetch(by_key["imax"])))
        for key, ent in by_key.items():
            if key.startswith("f::"):
                _, fname, skey = key.split("::", 2)
                entry.fields.setdefault(fname, {})[skey] = put(
                    np.array(fetch(ent)))
        for fname in meta.get("n_alias", []):
            entry.fields.setdefault(fname, {})["n"] = entry.nrow
            entry.n_aliased.add(fname)
        for fname in entry.fields:
            entry.nan_ok[fname] = bool(meta["nan_ok"].get(fname, False))
        entry.recount_bytes()
        return entry
    return None


def _load_any_snapshot(table, engine) -> _Entry | None:
    region = _snapshot_region(table)
    for m in region.store.list(f"{region.prefix}/{_SNAP_DIRNAME}/"):
        base = m.path.rsplit("/", 1)[-1]
        if not base.startswith("grid_") or not base.endswith(".gtdc"):
            continue
        try:
            _, res_s, phase_s = base[:-5].split("_")
            res, phase = int(res_s), int(phase_s)
        except ValueError:
            continue
        entry = load_entry_snapshot(
            table, r0=res, align_to=phase, device=engine.device,
            mesh=engine.mesh, mesh_opts=engine.mesh_opts,
            byte_budget=engine.range_cache.byte_budget)
        if entry is not None:
            return entry
    return None


def warm_from_snapshots(engine, catalog) -> int:
    """Restore every durable table's snapshot into the query engine's grid
    cache (what an instance runs at open, on a background thread). Returns
    the number of entries restored."""
    restored = 0
    for table in catalog.all_tables():
        region = _snapshot_region(table)
        if region is None or not region.store.list(
                f"{region.prefix}/{_SNAP_DIRNAME}/"):
            continue
        tkey = (table.database, table.name, id(table))
        cache: DeviceRangeCache = engine.range_cache
        with _restore_lock(tkey):
            if cache.has_table(tkey):
                continue
            entry = _load_any_snapshot(table, engine)
            if entry is not None and cache.insert_if_table_absent(
                    (tkey, entry.res, entry.phase), entry):
                restored += 1
    return restored


def execute_range_device(engine, plan, table):
    """Run a RANGE plan on the device grid cache: a QueryResult, or None
    where the JAX package declines the shape (the host path answers)."""
    items = plan_lowering(plan, table)
    if items is None:
        return None
    prefer = engine.prefer_device
    if prefer is False:
        return None
    if prefer is None and table.row_count() < DEVICE_THRESHOLD:
        return None
    align = plan.align_ms
    if align is None or align <= 0:
        return None
    r0 = align
    for it in plan.range_items:
        r0 = math.gcd(r0, it.range_ms)
    version = table.data_version()
    cache: DeviceRangeCache = engine.range_cache
    tkey = (table.database, table.name, id(table))
    entry = cache.lookup_compatible(tkey, version, r0, plan.align_to)
    persist = _snapshot_region(table) is not None
    engine.last_grid = "hit"
    if entry is None and persist:
        with stats.timed("grid_cache_restore_ms"), _restore_lock(tkey):
            # a warm thread may have restored while we waited
            entry = cache.lookup_compatible(tkey, version, r0,
                                            plan.align_to)
            if entry is None:
                entry = load_entry_snapshot(
                    table, r0, plan.align_to, device=engine.device,
                    mesh=engine.mesh, mesh_opts=engine.mesh_opts,
                    byte_budget=cache.byte_budget)
                if entry is not None:
                    cache.insert((tkey, entry.res, entry.phase), entry)
                    engine.last_grid = "restored"
    if entry is None:
        with stats.timed("grid_cache_build_ms"):
            entry = build_entry(plan, table, items, device=engine.device,
                                mesh=engine.mesh, mesh_opts=engine.mesh_opts,
                                byte_budget=cache.byte_budget,
                                keep_host=persist)
        if entry is None:
            return None
        stats.note("grid_cache", "miss(build)")
        engine.last_grid = "built"
        cache.insert((tkey, entry.res, entry.phase), entry)
        if persist:
            persist_entry_async(entry, table)
    else:
        stats.note("grid_cache", "miss(restored)"
                   if engine.last_grid == "restored" else "hit")
        with stats.timed("grid_cache_ensure_ms"):
            ok = ensure_states(entry, table, items, cache)
        if not ok:
            return None
    stats.add("grid_cache_bytes", entry.bytes())
    if engine.mesh is not None:
        dec = entry.mesh_decision
        if dec is None:
            dec = MeshDecision(
                "shard" if entry.mesh is not None else "replicate",
                "cached", devices=shard_count(engine.mesh))
        record_mesh_decision(dec, "range")
    return execute_on_entry(engine, plan, table, entry, items)


def execute_on_entry(engine, plan, table, entry: _Entry, items=None):
    """The query half of execute_range_device over a given grid entry (None:
    the host path answers)."""
    if items is None:
        items = plan_lowering(plan, table)
        if items is None:
            return None
    s = plan.scan
    align = plan.align_ms
    res = entry.res
    # WHERE ts bounds must land on cell edges or partials can't honor them
    if s.ts_min is not None and (s.ts_min - entry.t0c) % res != 0:
        return None
    if s.ts_max is not None and (s.ts_max + 1 - entry.t0c) % res != 0:
        return None
    lo = ((s.ts_min - entry.t0c) // res if s.ts_min is not None
          else -(2**31) + 1)
    hi = ((s.ts_max + 1 - entry.t0c) // res if s.ts_max is not None
          else 2**31 - 1)

    names = [nm for _, nm in plan.post_items]
    empty = engine._empty_result(names)
    sid_mask = None
    mask_key = None
    if s.matchers:
        record_scan_path(tag_index.enabled())
        sids = tag_index.match_sids(entry.registry, s.matchers)
        if len(sids) == 0:
            return empty
        sid_mask = np.zeros(entry.num_series, bool)
        sid_mask[sids[sids < entry.num_series]] = True
        # memo on the canonical matcher key + registry version instead
        # of hashing an O(num_series) mask per query
        mask_key = (tag_index.matcher_key(s.matchers),
                    entry.registry.version)
    else:
        record_scan_path(False)
    active, ts_min_f, ts_max_f = run_prelude(entry, sid_mask, lo, hi)
    if ts_min_f is None:
        return empty
    if plan.grid_ts_min is not None:
        # distributed fill-grid override: the negotiated global extent
        ts_min_f = plan.grid_ts_min
        ts_max_f = plan.grid_ts_max

    # window math — identical to the host path (python ints: // floors)
    align_to = plan.align_to % align if plan.align_to else 0
    max_range = max(r.range_ms for r in plan.range_items)
    j_first = -((-(ts_min_f - max_range + 1 - align_to)) // align)
    j_last = (ts_max_f - align_to) // align
    n_steps = int(j_last - j_first + 1)
    if n_steps <= 0:
        return empty
    stride = align // res
    t0q = align_to + j_first * align
    delta = (t0q - entry.t0c) // res
    if not (-(2**31) < delta < 2**31):
        return None  # query window absurdly far from the data grid
    lo_c = _clamp_i32(lo)
    hi_c = _clamp_i32(hi)

    memo_key = (mask_key, tuple(k.expr.name for k in plan.keys), delta,
                lo_c, hi_c)
    memo = entry.query_memo.get(memo_key)
    uploaded_bytes = 0
    if memo is None:
        gid_full, g, key_cols = _group_ids_from_sids(
            plan, entry.registry, active
        )
        # identity grouping (each real series is its own group, padded
        # tail routed past g) needs no fold: the per-series state IS the
        # group state
        fold = not (g <= entry.num_series
                    and np.array_equal(gid_full[:g], np.arange(g))
                    and (gid_full[g:] == g).all())
        fb = _fold_blocks(g, entry.nb, entry.num_series)
        # a sharded fold without the blocked form (past the cap, or a
        # series count that is no multiple of FOLD_BLOCKS) runs the
        # one-device program on the first shard's device over every
        # shard's grids, as the JAX package runs its one-device program
        # over the sharded arrays
        gathered = fold and len(entry.devices) > 1 and fb == 1
        devices = entry.devices[:1] if gathered else entry.devices
        ns = len(devices)
        put = _put(devices)
        per = entry.num_series // ns
        memo = {
            "gid": put(gid_full),
            "mask": put(active),
            "g": g, "key_cols": key_cols, "fold": fold,
            "gathered": gathered,
            # shard k folds global blocks [k * fb / ns, (k + 1) * fb / ns):
            # its slice of gid cut into fb / ns blocks of the same width
            "fold_members": ([ring_fold.fold_members(
                gid_full[k * per:(k + 1) * per], g, fb // ns, dev)
                for k, dev in enumerate(devices)] if fold else None),
            "delta": int(delta), "lo": lo_c, "hi": hi_c,
        }
        uploaded_bytes = int(gid_full.nbytes) + int(active.nbytes)
        if len(entry.query_memo) >= 32:
            entry.query_memo.pop(next(iter(entry.query_memo)))
        entry.query_memo[memo_key] = memo
    g = memo["g"]
    key_cols = memo["key_cols"]
    for item in plan.range_items:
        w_i = item.range_ms // res
        nb_i = (n_steps - 1) * (align // res) + w_i
        if g * nb_i > 256_000_000:
            return None
    step_ts = (align_to + (j_first + np.arange(n_steps)) * align).astype(
        np.int64
    )
    prog_items = tuple(
        (op, it.range_ms // res, fname)
        for (fname, op), it in zip(items, plan.range_items)
    )
    arrs = {}
    for fname, op in items:
        d = arrs.setdefault(fname, {})
        for bk in _STATE_KEYS[op]:
            d[bk] = entry.fields[fname][bk]
    nanenc = all(
        entry.nan_ok.get(fname, fname == "__rows__") for fname, _ in items
    )
    spec = (stride, n_steps, g, memo["fold"], nanenc, prog_items)
    # the `since` cursor: j0 is the first step past the client's
    # watermark. With FILL the whole grid assembles first (PREV/LINEAR
    # carry from steps before the cursor), so the cursor moves to cell
    # emission; otherwise only the delta's steps are read back
    since = sessions.current_since()
    has_fill = plan.fill is not None or any(
        r.fill is not None for r in plan.range_items)
    j0 = 0
    if since is not None and not has_fill:
        j0 = int(np.searchsorted(step_ts, since, side="right"))
        if j0 >= n_steps:
            return empty    # the client has every step already
    ns = len(entry.devices)
    comm_bytes = 0
    ring_form = None
    if memo["gathered"]:
        dev0 = entry.devices[0]
        arrs = {f: {k: [torch.cat([t.to(dev0) for t in parts])]
                    for k, parts in d.items()} for f, d in arrs.items()}
        ctx, program = LocalFoldCtx(), "single_gathered"
    elif entry.mesh is None:
        ctx, program = LocalFoldCtx(), "single"
    elif entry.mesh_decision.kernel == "ring":
        ctx, program = ring_fold.RingFoldCtx(ns), "sharded_ring"
        ring_form = ctx.form(entry.devices)
        if memo["fold"]:
            for op_i, w_i, _ in prog_items:
                planes = 1 + len(_STATE_COMBINE.get(op_i, ()))
                comm_bytes += ring_fold.fold_comm_bytes(
                    ns, g, (n_steps - 1) * stride + w_i, planes)
    else:
        ctx, program = ShardFoldCtx(ns), "sharded_gather"
    engine.last_range = {
        "program": program, "shards": ns, "comm_bytes": comm_bytes,
        "decision": (entry.mesh_decision.label()
                     if entry.mesh_decision is not None else None),
        "kernel": (entry.mesh_decision.kernel_label()
                   if entry.mesh is not None else None),
        # "fused" (one ring kernel per fold) or "hops" (seed + fold_cont
        # hop by hop) on the ring engine, None otherwise
        "ring_form": ring_form,
    }
    # the query session: this shape's folded result stays on the card
    # across polls, so a repeated poll runs no program (no K2, no range
    # body) and a delta poll narrows the resident result below. Keyed to
    # THIS grid entry: engines over one table do not share buffers, and
    # the cache purges an entry's buffers when it drops the entry
    # (DeviceRangeCache._release). Tables assembled per call opt out
    # (`session_cacheable`): their entries never repeat. The parts are
    # torch.stack/cat outputs of _range_body, which the program owns, so
    # no later launch writes them.
    use_sessions = getattr(table, "session_cacheable", True)
    session_tkey = ("range", id(entry))
    session_key = (memo_key, spec, program, ring_form)
    from greptimedb_tpu_torch.telemetry import device_trace

    # one device.execute span a query (a session hit keeps it, with no
    # program call); the program identity carries the mesh variant
    with stats.timed("device_exec_ms"), device_trace.device_call(
            "range", key=("range", program, ring_form, spec),
            groups=g, steps=n_steps,
            collective=program == "sharded_ring", comm_bytes=comm_bytes,
            device=entry.devices[0]) as dcall:
        parts = (sessions.global_sessions.get(session_tkey, session_key,
                                              entry.version)
                 if use_sessions else None)
        if parts is not None:
            stats.note("device_session", "hit")
            engine.last_session = "hit"
            dcall.executed()
        else:
            stats.note("device_session", "miss")
            engine.last_session = "miss"
            if uploaded_bytes:
                dcall.transfer(uploaded_bytes, "upload")
            parts = dcall.run(_range_body, arrs, memo, spec, ctx)
            dcall.executed()
            if dcall.first:
                # every state plane read once, the gid/mask inputs once,
                # the result written once; an add per state cell
                planes = [t for d in arrs.values() for v in d.values()
                          for t in v]
                ins = planes + list(memo["gid"]) + list(memo["mask"])
                dcall.declare(
                    sum(t.numel() for t in planes),
                    sum(t.numel() * t.element_size()
                        for t in ins + list(parts)))
            if use_sessions:
                sessions.global_sessions.put(session_tkey, session_key,
                                             entry.version, parts,
                                             owner=entry)
        # fold=False leaves the series axis un-folded and series-sharded:
        # the shards' outputs concatenate in shard order, and rows [g:]
        # are the padded/inactive tail, cut on the card before the one
        # readback; a delta poll narrows the steps axis first
        out = readback.read_gathered(parts, dim=1,
                                     stop=None if memo["fold"] else g,
                                     lo=j0)
        dcall.transfer(out.nbytes, "readback")
    stats.add("device_readback_bytes", out.nbytes)
    stats.add("range_groups", g)
    stats.add("range_steps", n_steps)
    n_items = len(plan.range_items)
    vals = out[:n_items].astype(np.float64)
    if nanenc:
        pres = np.empty_like(vals, dtype=bool)
        for i, (fname, op) in enumerate(items):
            if op == "count":
                pres[i] = vals[i] > 0
            else:
                pres[i] = np.isfinite(vals[i])
    else:
        pres = out[n_items:] > 0.5
    item_vals = {}
    item_present = {}
    for i, item in enumerate(plan.range_items):
        item_vals[item.key] = vals[i]
        item_present[item.key] = pres[i]
    return engine._assemble_range_result(
        plan, table, item_vals, item_present, key_cols, step_ts[j0:], g,
        n_steps - j0, since_ms=since if has_fill else None,
    )
