"""Cached device fast path for hot PromQL shapes (the JAX package's
promql/fast.py).

- a **selector grid cache**: per (table, field), the full (series x cell)
  vals/has/tsg grids of every series live on the card, version-stamped by
  Table.data_version() and evicted under a byte budget. On a mesh whose
  planner decision is shard(large_grid) the series axis is cut into one
  slice per shard (per-shard lists of tensors, shard order);
- **dictionary-coded label algebra**: matchers evaluate per distinct tag
  value and broadcast through int32 code columns (SeriesRegistry.
  match_mask); group keys come from the codes matrix through one
  np.unique — no per-series Python;
- **one device program per query**: range function (ops/window.py) and
  cross-series aggregation or per-step top-k, so a query moves J * 12
  bytes of window indices to the card and a packed result back;
- **query sessions** (query/sessions.py): the packed result of each query
  shape stays on the card, so a repeated poll over an unchanged grid runs
  no program (`_session_exec`); the cache purges an entry's buffers when
  it drops the entry (`SelectorGridCache._release`).

Shapes served: `agg [by|without (...)] (range_fn(sel[d]) | sel)` with agg
in sum/avg/min/max/count/group/stddev/stdvar and every range function
but absent_over_time (scalar-literal arguments in their generic-path
positions), global `topk|bottomk(k, ...)` of the same, `vecL <op> vecR`
(one-to-one default matching over one table, with an optional
aggregation around it), and `histogram_quantile(phi, range_fn(sel) | sel
| sum by (le, ...) (range_fn(sel)))`. Every other shape, and a query whose
step/range/start does not land on the cached grid's cells, returns None;
the generic engine (promql/engine.py) answers it.

The sharded aggregate uses the gather twin (parallel/dist.ShardFoldCtx),
as the JAX package does, or with the ring kernels on (planner.
decide_kernel("promql")) parallel/kernels/ring_fold.RingFoldCtx: the same
additions in the same order. The sharded topk takes a local per-step top-k
on every shard and either reselects over the shard-order concatenation
(the gather twin) or merges the candidates around the ring with the topk
merge kernel (parallel/kernels/topk_merge.py), as planner.decide_kernel(
"topk") says. The binary and histogram programs, which the JAX package
runs as single-device code under auto-SPMD, evaluate each shard's series
on its device and aggregate on the first shard's (`_on_first`). Every
variant answers bit-identically to the one-device program.

The cache key carries the query engine's device, mesh and mesh options
(the JAX package's is (table, field), where a change of mesh options needs
invalidate_cache()), so engines with different meshes over one table keep
separate grids.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from greptimedb_tpu_torch.index import device_plane, tag_index
from greptimedb_tpu_torch.ops import promql as K
from greptimedb_tpu_torch.ops import window as W
from greptimedb_tpu_torch.promql.parser import (
    _CMP_OPS,
    Agg,
    Binary,
    Call,
    NumberLit,
    VectorSelector,
)
from greptimedb_tpu_torch.telemetry.metrics import global_registry

# the range functions the fast path evaluates per series (prefix sums or
# gathered windows of L cells): every range function but absent_over_time
_PREFIX_FNS = frozenset({
    "rate", "increase", "delta", "idelta", "irate",
    "sum_over_time", "count_over_time", "avg_over_time",
    "last_over_time", "first_over_time", "present_over_time",
    "changes", "resets",
    "min_over_time", "max_over_time", "stddev_over_time",
    "stdvar_over_time", "mad_over_time", "deriv",
    "quantile_over_time", "predict_linear", "holt_winters",
})
# leading scalar-literal argument count per arg-taking range function
_FN_LEAD_ARGS = {
    "quantile_over_time": 1, "predict_linear": 0, "holt_winters": 0,
}
# trailing scalar args (after the selector)
_FN_TRAIL_ARGS = {"predict_linear": 1, "holt_winters": 2}
_SIMPLE_AGGS = frozenset(
    {"sum", "avg", "min", "max", "count", "group", "stddev", "stdvar"}
)
_BUDGET_BYTES = 4 * 1024**3


def _pow2_bucket(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclass
class _Entry:
    table: object
    fieldname: str
    version: tuple
    registry: object            # SeriesRegistry backing the grids
    spec: object                # ops.grid.GridSpec
    vals: list                  # per shard (S_pad / shards, NC) float32
    has: list                   # per shard (S_pad / shards, NC) bool
    tsg: list                   # per shard (S_pad / shards, NC) int32
    num_series: int
    s_pad: int
    nbytes: int
    devices: list               # shard devices, shard order (one: replicate)
    mesh_decision: object = None  # planner MeshDecision (None: no mesh)
    last_used: float = 0.0
    # per-entry derived caches (device-resident, so queries move no masks)
    match_cache: dict = field(default_factory=dict)
    group_cache: dict = field(default_factory=dict)
    win_cache: dict = field(default_factory=dict)

    @property
    def shards(self) -> int:
        return len(self.devices)


class SelectorGridCache:
    """LRU byte-budgeted cache of full-table selector grids."""

    def __init__(self, byte_budget: int = _BUDGET_BYTES):
        self.byte_budget = byte_budget
        self._entries: dict[tuple, _Entry] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        from greptimedb_tpu_torch.telemetry import memory as _memory

        _memory.register_pool(
            "promql_grid", "device", self,
            stats=SelectorGridCache._mem_stats,
            evict=SelectorGridCache.evict_bytes,
            buffers=SelectorGridCache._device_buffers,
        )

    def get_entry(self, table, fieldname: str, *, device, mesh=None,
                  mesh_opts=None) -> _Entry | None:
        mesh_key = None if mesh is None else tuple(str(d)
                                                   for d in mesh.devices)
        key = (id(table), fieldname, str(device), mesh_key, mesh_opts)
        version = table.data_version()
        with self._lock:
            e = self._entries.get(key)
            if e is not None and e.table is table and e.version == version:
                e.last_used = time.monotonic()
                self.hits += 1
                return e
            self.misses += 1
        e = _build_entry(table, fieldname, version, device=device,
                         mesh=mesh, mesh_opts=mesh_opts,
                         byte_budget=self.byte_budget)
        if e is None:
            return None
        with self._lock:
            old = self._entries.get(key)
            if old is not None and old is not e:
                self._release(old)  # a stale version: free its buffers
            self._entries[key] = e
            e.last_used = time.monotonic()
            self._evict_locked(keep=key)
        from greptimedb_tpu_torch.telemetry import memory as _memory

        _memory.note_device_bytes()
        return e

    def _release(self, entry: _Entry):
        """Drop the entry's session buffers with it (query/sessions.py):
        a dropped entry's id() can be reused by a new entry, and its
        buffers would otherwise pin the card's memory until unrelated
        LRU pressure."""
        from greptimedb_tpu_torch.query import sessions

        self.evictions += 1
        sessions.global_sessions.purge_table(("promql", id(entry)))

    def _evict_locked(self, keep):
        total = sum(e.nbytes for e in self._entries.values())
        for key, _ in sorted(self._entries.items(),
                             key=lambda kv: kv[1].last_used):
            if total <= self.byte_budget:
                return
            if key != keep:
                victim = self._entries.pop(key)
                self._release(victim)
                total -= victim.nbytes

    def invalidate(self):
        with self._lock:
            for e in self._entries.values():
                self._release(e)
            self._entries.clear()

    def drop_table(self, table):
        with self._lock:
            for key in [k for k, e in self._entries.items()
                        if e.table is table]:
                self._release(self._entries.pop(key))

    # ------------------------------------------------------------------
    # memory ledger surface (telemetry/memory.py)
    # ------------------------------------------------------------------
    _DERIVED = ("match_cache", "group_cache", "win_cache")

    def _mem_stats(self) -> dict:
        from greptimedb_tpu_torch.telemetry.memory import iter_device_arrays

        with self._lock:
            total = 0
            seen: set[int] = set()
            for e in self._entries.values():
                total += e.nbytes
                # the derived per-query inputs pinned on the entry count
                # too: the watermark must see every resident byte
                for cname in self._DERIVED:
                    for v in list(getattr(e, cname).values()):
                        for t in iter_device_arrays(v):
                            if id(t) not in seen:
                                seen.add(id(t))
                                total += t.numel() * t.element_size()
            return {
                "bytes": total,
                "entries": len(self._entries),
                "budget_bytes": self.byte_budget,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
            }

    def evict_bytes(self, target: int) -> int:
        """Shed least-recently-used grids until `target` bytes are
        freed (the global device watermark)."""
        freed = 0
        with self._lock:
            for key, e in sorted(self._entries.items(),
                                 key=lambda kv: kv[1].last_used):
                if freed >= target:
                    break
                self._release(self._entries.pop(key))
                freed += e.nbytes
        return freed

    def _device_buffers(self):
        from greptimedb_tpu_torch.telemetry.memory import iter_device_arrays

        out = []
        with self._lock:
            for e in self._entries.values():
                tag = f"promql:{e.fieldname}"
                out += [(t, tag) for t in iter_device_arrays(
                    [e.vals, e.has, e.tsg])]
                for cname in self._DERIVED:
                    for v in list(getattr(e, cname).values()):
                        out += [(t, f"{tag}:{cname}")
                                for t in iter_device_arrays(v)]
        return out


_CACHE = SelectorGridCache()

_FAST_HITS = global_registry.counter(
    "greptime_promql_fast_path_total",
    "PromQL queries served from the selector grid cache", ("event",),
)


def _hit(out):
    _FAST_HITS.labels("hit").inc()
    return out


def _fallback():
    _FAST_HITS.labels("fallback").inc()


def _run_program(site: str, key: tuple, entry: _Entry, skey: tuple,
                 inputs: tuple, run, dtype=np.float64, **attrs):
    """One fused program through its query session under a
    `device.execute` span (telemetry/device_trace.py): a session hit runs
    nothing and counts no program call. Declares the program's least
    bytes (the entry's grid planes read once, the packed result written
    once) and one op per grid cell at its first dispatch. Returns (the
    packed result read back, session hit)."""
    from greptimedb_tpu_torch.query import readback
    from greptimedb_tpu_torch.telemetry import device_trace

    with device_trace.device_call(site, key=key, device=entry.devices[0],
                                  **attrs) as dcall:
        packed, hit = _session_exec(entry, skey, inputs,
                                    lambda: dcall.run(run))
        dcall.executed()
        if dcall.first:
            dcall.declare(entry.nbytes // 9,
                          entry.nbytes + packed.numel()
                          * packed.element_size())
        out = readback.read_full(packed, dtype)
        dcall.transfer(out.nbytes, "readback")
    return out, hit


def _session_exec(entry: _Entry, skey: tuple, inputs: tuple, run):
    """The query session of a fused program's packed result
    (query/sessions.py): an identical repeated poll serves the resident
    result and runs no program. The key holds the identities of the
    cached per-query inputs (masks, grouping, window indices); the
    session entry keeps those objects alive, so no later object can
    reuse an id while the key can still hit. The entry's version rides
    the registry's validation, so any write invalidates. Every fused
    program returns a torch.cat of its outputs, a tensor it owns.
    Returns (packed, hit)."""
    from greptimedb_tpu_torch.query import sessions

    tkey = ("promql", id(entry))
    key = skey + tuple(id(o) for o in inputs)
    got = sessions.global_sessions.get(tkey, key, entry.version)
    if got is not None:
        return got[0], True
    packed = run()
    sessions.global_sessions.put(tkey, key, entry.version,
                                 (packed, inputs),
                                 sessions.buffer_nbytes(packed), owner=entry)
    return packed, False


def _win_inputs(win) -> tuple:
    """A window plan's cached tensors (the per-query copy that sets x64
    shares them)."""
    return (win.lo, win.hi, win.t_end)


def _build_entry(table, fieldname: str, version, *, device, mesh=None,
                 mesh_opts=None, byte_budget: int = _BUDGET_BYTES
                 ) -> _Entry | None:
    """Scan the whole table once and gridify every series onto one
    card-resident grid (cut per shard on a sharding mesh). Resolution is
    the gcd of the observed sample intervals, coarsened if the grid would
    pass half the cache budget."""
    from greptimedb_tpu_torch.ops import grid as G
    from greptimedb_tpu_torch.query.planner import decide_mesh_execution

    if not np.issubdtype(table.schema.field_dtypes[fieldname], np.number):
        return None  # no device grid for string fields
    data = table.scan(field_names=[fieldname])
    rows = data.rows
    registry = data.registry
    devices = [torch.device(device)]
    if rows is None or len(rows) == 0 or registry.num_series == 0:
        return _Entry(table, fieldname, version, registry, None, [], [], [],
                      0, 0, 0, devices)
    ts = np.asarray(rows.ts, np.int64)
    uniq_ts = np.unique(ts)
    res = int(np.gcd.reduce(np.diff(uniq_ts))) if len(uniq_ts) > 1 else 1000
    res = max(res, 1)
    t_min, t_max = int(uniq_ts[0]), int(uniq_ts[-1])
    s = registry.num_series
    decision = None
    if mesh is not None:
        # replicate-vs-shard: small grids stay on one device, large ones
        # cut the series axis over the mesh
        decision = decide_mesh_execution(mesh, kind="promql", series=s,
                                         opts=mesh_opts)
        if decision.shard:
            devices = list(mesh.devices)
    ns = len(devices)
    # pow2 buckets >= 8 divide an 8-way mesh evenly; smaller pad up to it
    s_pad = max(_pow2_bucket(s), ns)
    max_cells = max(byte_budget // 2 // (9 * s_pad), 16)
    while (t_max - t_min) // res + 2 > max_cells:
        res *= 2
    # anchor the grid to the data's phase: samples at t_min + k*res land
    # exactly on cell boundaries
    t0 = t_min - res
    nc = int(-((-(t_max - t0)) // res)) + 1
    spec = G.GridSpec.build(t0, res, nc)

    dev0 = devices[0]
    mask = np.ones(len(ts), bool)
    if rows.field_valid is not None and fieldname in rows.field_valid:
        mask = np.asarray(rows.field_valid[fieldname], bool)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev0)

    # the grid build is this path's big host->device transfer: a span
    # on the trace (a cold selector's first query pays it)
    from greptimedb_tpu_torch.telemetry import tracing

    t0_build = time.perf_counter()
    with tracing.child_span("device.upload", site="promql_grid",
                            upload_bytes=s_pad * nc * 9):
        gvals, ghas, gtsg = G.gridify(
            up(np.asarray(rows.sid, np.int32)),
            up(spec.cell_of(ts).astype(np.int32)),
            up(spec.device_ts(ts)),
            up(np.asarray(rows.fields[fieldname], np.float32)),
            up(mask), s_pad, nc,
        )
    _FAST_HITS.labels("grid_build").inc()
    global_registry.gauge(
        "greptime_promql_grid_build_seconds",
        "wall seconds of the last selector grid build",
    ).set(time.perf_counter() - t0_build)
    per = s_pad // ns

    def cut(x):
        # each shard owns its rows: a copy even where the shard's device
        # is the build device
        return [x[k * per:(k + 1) * per].to(d, copy=True)
                for k, d in enumerate(devices)]

    return _Entry(table, fieldname, version, registry, spec, cut(gvals),
                  cut(ghas), cut(gtsg), s, s_pad, s_pad * nc * 9, devices,
                  mesh_decision=decision)


def _replicated(entry: _Entry, arr: np.ndarray) -> list:
    """A host array on every shard's device, shard order."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return [t.to(d) for d in entry.devices]


def _sharded(entry: _Entry, arr: np.ndarray) -> list:
    """A per-series host array (S_pad, ...) cut over the shards."""
    per = entry.s_pad // entry.shards
    return [torch.from_numpy(np.ascontiguousarray(arr[k * per:(k + 1) * per]))
            .to(d) for k, d in enumerate(entry.devices)]


# ----------------------------------------------------------------------
# per-query planning against a cached grid
# ----------------------------------------------------------------------

@dataclass
class _WinShim:
    """One shard's window tensors with the static scalars, shaped for
    ops/promql.eval_range_function."""

    lo: torch.Tensor
    hi: torch.Tensor
    t_end: torch.Tensor
    range_ticks: int
    l_cells: int


@dataclass
class _Windows:
    lo: list                    # per shard (J,) int32
    hi: list
    t_end: list
    range_ticks: int
    l_cells: int
    # the query engine's x64 mode (a per-query copy; cached windows keep
    # the default)
    x64: bool = False

    @property
    def num_steps(self) -> int:
        return int(self.lo[0].shape[0])


def _eval_side(vals, has, tsg, smask, lo, hi, t_end, *, fname, range_ticks,
               l_cells, tps, fargs, lookback_ticks, x64=False):
    """Instant lookback or range function over one shard's masked grid —
    the front half of every fused query."""
    has = has & smask[:, None]
    if fname == "__instant__":
        return W.instant_lookback(vals, has, tsg, hi, t_end, lookback_ticks)
    win = _WinShim(lo, hi, t_end, range_ticks, l_cells)
    return K.eval_range_function(fname, vals, has, tsg, win, tps,
                                 args=fargs, x64=x64)


def _eval_shards(entry: _Entry, smask: list, win: _Windows, *, fname: str,
                 fargs: tuple, lookback_ticks: int):
    """_eval_side on every shard: per-shard lists of (S_local, J) outputs
    and presence, shard order."""
    outs, press = [], []
    for k in range(entry.shards):
        out, pres = _eval_side(
            entry.vals[k], entry.has[k], entry.tsg[k], smask[k], win.lo[k],
            win.hi[k], win.t_end[k], fname=fname,
            range_ticks=win.range_ticks, l_cells=win.l_cells,
            tps=entry.spec.tps, fargs=fargs, lookback_ticks=lookback_ticks,
            x64=win.x64)
        outs.append(out)
        press.append(pres)
    return outs, press


def _plan_windows(entry: _Entry, ev, range_ms: int, offset_ms: int, *,
                  align_range: bool = True) -> _Windows | None:
    """Window cell indices against the cached grid, or None if the query's
    step/range/start do not land on cell boundaries (exactness requires
    alignment). Instant lookback compares exact sample ticks, so only
    step and start need aligning for it."""
    spec = entry.spec
    res = spec.res
    start = ev.start_ms - offset_ms
    end = ev.end_ms - offset_ms
    if ev.step_ms % res or (start - spec.t0) % res:
        return None
    if align_range and range_ms % res:
        return None
    key = (start, end, ev.step_ms, range_ms)
    hit = entry.win_cache.get(key)
    if hit is not None:
        return hit
    steps = np.arange(start, end + 1, ev.step_ms, dtype=np.int64)
    hi_raw = (steps - spec.t0) // res
    w = max(range_ms // res, 1)
    hi = np.clip(hi_raw, 0, spec.num_cells - 1).astype(np.int32)
    lo = np.clip(hi_raw - w, 0, spec.num_cells - 1).astype(np.int32)
    lo = np.minimum(lo, hi)
    t_end = np.clip((steps - spec.t0) // spec.unit, -2**31 + 1,
                    2**31 - 1).astype(np.int32)
    # card-resident window indices: a repeated query uploads nothing
    out = _Windows(_replicated(entry, lo), _replicated(entry, hi),
                   _replicated(entry, t_end), int(range_ms // spec.unit),
                   int(w))
    if len(entry.win_cache) >= 64:
        entry.win_cache.pop(next(iter(entry.win_cache)))
    entry.win_cache[key] = out
    return out


def _matcher_mask_dev(entry: _Entry, matchers):
    """Per-shard card-resident (S_pad / shards,) bool masks for a matcher
    set (padded series are always False) and whether any series matched:
    from the resident label plane where it serves the set, else the host
    mask through the secondary index, uploaded. Cached so repeated queries
    move no bytes."""
    key = tuple((name, op, value.pattern if hasattr(value, "pattern")
                 else value) for name, op, value in matchers)
    hit = entry.match_cache.get(key)
    if hit is not None:
        return hit
    out = None
    if matchers:
        # card-resident label plane (index/device_plane): the mask is a
        # gather+AND over the resident codes matrix, per shard — only the
        # per-distinct-value ok-tables cross to the card
        out = device_plane.matcher_mask_dev(
            entry.registry, matchers, entry.s_pad, devices=entry.devices,
            num_series=entry.num_series)
    if out is None:
        mask = np.zeros(entry.s_pad, bool)
        if matchers:
            mask[:entry.num_series] = tag_index.match_mask(
                entry.registry, matchers)[:entry.num_series]
        else:
            mask[:entry.num_series] = True
        out = (_sharded(entry, mask), bool(mask.any()))
    if len(entry.match_cache) >= 128:
        entry.match_cache.pop(next(iter(entry.match_cache)))
    entry.match_cache[key] = out
    return out


@dataclass
class _Grouping:
    labels: list                # G group label dicts
    gid: list                   # per shard (S_pad / shards,) int32
    gid_host: np.ndarray        # (S_pad,) int32; padded series -> G
    g: int
    fold_members: list | None = None   # per shard, built on first use
    # the whole (S_pad,) gid and G's member order over g + 1 groups on one
    # device (the unblocked aggregation), per device, built on first use
    gid_full: dict = field(default_factory=dict)
    members: dict = field(default_factory=dict)
    hist_slots: object = None   # _hist_slots_from_labels(labels), cached

    def full(self, device) -> torch.Tensor:
        key = str(device)
        if key not in self.gid_full:
            self.gid_full[key] = torch.from_numpy(self.gid_host).to(device)
        return self.gid_full[key]

    def group_members(self, device):
        """G's member order of the whole gid on `device` (the scatter
        branch of aggregate_across_series), one per device. The padded
        series (group g, dropped after the aggregation) are left out, so
        no segment walks them."""
        key = str(device)
        if key not in self.members:
            gid = self.full(device)
            self.members[key] = K.group_members(gid, self.g + 1,
                                                live=gid < self.g)
        return self.members[key]


def _grouping_dev(entry: _Entry, table, grouping, without: bool
                  ) -> _Grouping:
    """Group labels, per-shard gids and the group count. Padded series map
    to group G (dropped after aggregation). Cached per label set."""
    key = (tuple(sorted(grouping)), bool(without))
    hit = entry.group_cache.get(key)
    if hit is not None:
        return hit
    reg = entry.registry
    visible = set(table.tag_names)
    cols = [i for i, nm in enumerate(reg.tag_names)
            if nm in visible and not nm.startswith("__")
            and ((nm not in grouping) if without else (nm in grouping))]
    s = entry.num_series
    if not cols or s == 0:
        labels = [{}]
        gid = np.zeros(entry.s_pad, np.int32)
        gid[s:] = 1
        g = 1
    else:
        sub = reg.codes_matrix()[:s, cols]
        uniq, inv = np.unique(sub, axis=0, return_inverse=True)
        labels = []
        for row in uniq:
            lab = {}
            for ci, code in zip(cols, row):
                v = reg.dicts[ci].decode(int(code))
                if v != "":
                    lab[reg.tag_names[ci]] = v
            labels.append(lab)
        g = len(uniq)
        gid = np.full(entry.s_pad, g, np.int32)
        gid[:s] = np.ravel(inv).astype(np.int32)
    out = _Grouping(labels, _sharded(entry, gid), gid, g)
    if len(entry.group_cache) >= 128:
        entry.group_cache.pop(next(iter(entry.group_cache)))
    entry.group_cache[key] = out
    return out


def _fold_members(entry: _Entry, grp: _Grouping) -> list:
    """Per-shard K2 member lists of the grouping over g + 1 groups (the
    scatter branch's blocked segment sums), FOLD_BLOCKS / shards blocks
    per shard; built once per grouping. The padded series (group g,
    dropped after the aggregation) are routed past g + 1, so no list holds
    them: group g's sums start at 0 and add nothing, +0.0 as the sum of
    their +0.0s was, and no walk spends its chain on them."""
    from greptimedb_tpu_torch.parallel.kernels.ring_fold import fold_members
    from greptimedb_tpu_torch.parallel.mesh import FOLD_BLOCKS

    if grp.fold_members is None:
        per = entry.s_pad // entry.shards
        gid = np.where(grp.gid_host < grp.g, grp.gid_host, grp.g + 1)
        grp.fold_members = [
            fold_members(gid[k * per:(k + 1) * per], grp.g + 1,
                         FOLD_BLOCKS // entry.shards, d)
            for k, d in enumerate(entry.devices)]
    return grp.fold_members


def _fused_query(entry: _Entry, smask: list, grp: _Grouping, win: _Windows,
                 *, fname: str, fargs: tuple, op: str, lookback_ticks: int,
                 ring: bool = False):
    """The whole query over every shard: matcher mask, range function or
    instant lookback, cross-series aggregation (the JAX package's
    _fused_query and its shard_map twin _make_sharded_fused_query: one
    shard runs LocalFoldCtx, several the gather twin ShardFoldCtx or, with
    `ring`, the ring kernels' RingFoldCtx, bit-identical to it). Returns
    the packed (2G, J) float32 result on the first shard's device."""
    from greptimedb_tpu_torch.parallel.dist import LocalFoldCtx, ShardFoldCtx
    from greptimedb_tpu_torch.parallel.kernels.ring_fold import RingFoldCtx

    ns = entry.shards
    g = grp.g
    outs, press = _eval_shards(entry, smask, win, fname=fname, fargs=fargs,
                               lookback_ticks=lookback_ticks)
    fms = None
    if not K.uses_matmul(op, g + 1, entry.s_pad):
        fms = _fold_members(entry, grp)
    if ns == 1:
        ctx = LocalFoldCtx()
    else:
        ctx = RingFoldCtx(ns) if ring else ShardFoldCtx(ns)
    vals_g, pres_g = K.aggregate_across_series_blocked(
        outs, press, grp.gid, g + 1, op, total_series=entry.s_pad, ctx=ctx,
        fms=fms)
    # one packed (2G, J) buffer: one card -> host transfer per query
    return torch.cat([vals_g[:g], pres_g[:g].to(vals_g.dtype)])


def _resolve_fast_selector(engine, inner, ev):
    """Match `range_fn(sel)` / a bare instant selector, resolve the table
    and its grid entry, plan the windows. Returns (entry, table,
    raw_matchers, fname, fargs, win), "empty" for a selector with no
    series, or None for a shape the fast path does not serve (the generic
    engine answers it)."""
    fargs: tuple = ()
    if isinstance(inner, Call) and inner.name in _PREFIX_FNS:
        # scalar-literal args ride as fargs (phi, horizon, sf/tf) in their
        # exact generic-path positions: a misplaced scalar returns None,
        # and the generic engine rejects it
        lead = _FN_LEAD_ARGS.get(inner.name, 0)
        trail = _FN_TRAIL_ARGS.get(inner.name, 0)
        args = inner.args
        if len(args) != lead + 1 + trail:
            return None
        if not all(isinstance(a, NumberLit)
                   for a in args[:lead] + args[lead + 1:]):
            return None
        fargs = tuple(float(a.value) for a in args[:lead] + args[lead + 1:])
        sel = args[lead]
        if not isinstance(sel, VectorSelector) or sel.range_ms is None:
            return None
        fname = inner.name
        range_ms = sel.range_ms
    elif isinstance(inner, VectorSelector) and inner.range_ms is None:
        sel = inner
        fname = "__instant__"
        range_ms = ev.lookback_ms
    else:
        return None
    if sel.at_ms is not None:
        return None
    table, field_sel, raw_matchers = engine._resolve_table(sel)
    if table is None:
        return None
    try:
        fieldname = engine._value_field(table, field_sel)
    except Exception:  # noqa: BLE001 - resolution failure: generic path
        return None
    qe = engine.instance.query_engine
    entry = _CACHE.get_entry(table, fieldname, device=qe.device,
                             mesh=qe.mesh, mesh_opts=qe.mesh_opts)
    if entry is None:
        return None
    if entry.num_series == 0:
        return "empty"
    win = _plan_windows(entry, ev, range_ms, sel.offset_ms,
                        align_range=fname != "__instant__")
    if win is None:
        return None
    if qe.x64:
        win = replace(win, x64=True)
    return entry, table, raw_matchers, fname, fargs, win


def _note(engine, entry: _Entry, kind: str, kernel=None, comm_bytes=0,
          session=None):
    """What the last fast-path query ran (the JAX package's EXPLAIN
    ANALYZE notes): shard count, mesh decision, program variant, and its
    query session ("hit": no program ran)."""
    dec = entry.mesh_decision
    engine.last_fast = {
        "kind": kind, "shards": entry.shards,
        "decision": None if dec is None else dec.label(),
        "kernel": kernel, "comm_bytes": comm_bytes, "session": session,
    }


def try_fast(engine, e, ev):
    """Serve `agg(range_fn(selector))` / `agg(selector)` from the grid
    cache. Returns a VectorValue, or None for a shape it does not serve."""
    from greptimedb_tpu_torch.promql.engine import _empty_vector

    if not isinstance(e, Agg) or e.op not in _SIMPLE_AGGS:
        return None
    resolved = _resolve_fast_selector(engine, e.expr, ev)
    if resolved is None:
        return _fallback()
    if resolved == "empty":
        return _hit(_empty_vector(ev))
    entry, table, raw_matchers, fname, fargs, win = resolved
    matchers = engine._to_registry_matchers(raw_matchers, table)
    smask, any_match = _matcher_mask_dev(entry, matchers)
    if not any_match:
        return _hit(_empty_vector(ev))
    grp = _grouping_dev(entry, table, e.grouping, e.without)
    lookback_ticks = max(int(ev.lookback_ms // entry.spec.unit), 1)
    ring, kernel_label = False, None
    if entry.shards > 1:
        from greptimedb_tpu_torch.query import planner

        kdec, kreason = planner.decide_kernel(
            "promql", series=entry.num_series,
            opts=engine.instance.query_engine.mesh_opts,
            device=entry.devices[0])
        ring = kdec == "ring"
        kernel_label = f"{kdec}({kreason})"
    skey = ("q", fname, fargs, e.op, grp.g, win.range_ticks, win.l_cells,
            win.x64, entry.spec.tps, lookback_ticks, ring)
    packed_np, hit = _run_program(
        "promql", ("promql", entry.shards) + skey, entry, skey,
        (smask, grp, *_win_inputs(win)),
        lambda: _fused_query(entry, smask, grp, win, fname=fname,
                             fargs=fargs, op=e.op,
                             lookback_ticks=lookback_ticks, ring=ring),
        groups=grp.g)
    _note(engine, entry, "promql", kernel_label,
          session="hit" if hit else "miss")
    return _hit(_vector_from_packed(packed_np, grp.labels, grp.g))


# ----------------------------------------------------------------------
# per-series output labels of topk winners
# ----------------------------------------------------------------------

def _series_labels_for(entry: _Entry, table, sids) -> list[dict]:
    """Tag dicts for just the requested sids (O(k), not O(num_series)),
    memoized per entry."""
    memo = entry.group_cache.setdefault("__series_labels_memo__", {})
    reg = entry.registry
    visible = set(table.tag_names)
    out = []
    for s in sids:
        s = int(s)
        lab = memo.get(s)
        if lab is None:
            lab = {k: str(v) for k, v in reg.series_tags(s).items()
                   if v != "" and k in visible and not k.startswith("__")}
            memo[s] = lab
        out.append(dict(lab))
    return out


# ----------------------------------------------------------------------
# topk / bottomk over the grid cache
# ----------------------------------------------------------------------

def _topk_key(out: torch.Tensor, pres: torch.Tensor, largest: bool):
    """Descending sort key: present samples clamped to a finite range so
    genuine +-Inf values still rank above/below every absent slot (-inf
    fill); present NaN ranks below every real value but above absence,
    staying finite so the presence check keeps it when k exceeds the real
    winners. -0.0 becomes +0.0: the merge kernel compares the two equal,
    so one key representation keeps every path's ties the same."""
    big = 3.0e38
    base = out.clamp(-big, big)
    k_dir = (base if largest else -base) + 0.0
    return torch.where(pres, torch.where(torch.isnan(out), -3.2e38, k_dir),
                       float("-inf"))


def _stable_topk(key: torch.Tensor, k: int):
    """(values, indices) of the k largest keys per row, equal keys in
    ascending index order — jax.lax.top_k's lower-index-wins rule, which
    torch.topk does not promise."""
    vals, idx = torch.sort(key, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _local_candidates(out, pres, key, kl: int, base: int):
    """One shard's per-step top-kl candidate planes (J, kl) with global
    series indices (base + local index)."""
    from greptimedb_tpu_torch.parallel.kernels.topk_merge import Candidates

    l_key, l_idx = _stable_topk(key.T, kl)
    return Candidates(
        l_key.contiguous(),
        torch.gather(out.T, 1, l_idx).to(torch.float32).contiguous(),
        (l_idx + base).to(torch.int32).contiguous(),
        torch.gather(pres.T, 1, l_idx).contiguous(),
    )


def _fused_topk(entry: _Entry, smask: list, win: _Windows, *, fname: str,
                fargs: tuple, k: int, largest: bool, lookback_ticks: int,
                kernel: bool = False):
    """Range function or selector, then per-step top-k, over every shard.
    One shard: one stable select (the JAX package's _fused_topk). Several:
    each shard's local top-min(k, S_local) candidates, then either the
    reselect over their shard-order concatenation (the gather twin,
    _make_sharded_fused_topk) or, with `kernel`, the ring merge
    (_make_sharded_fused_topk_pallas). Candidate order (shard, then local
    rank) equals ascending global series index among equal keys, so every
    variant selects what the one-shard program selects. Returns the packed
    (3J, k) float32 [values; winner indices; presence] on the first
    shard's device (indices are exact in f32 below 2^24)."""
    from greptimedb_tpu_torch.parallel.dist import gather_blocks
    from greptimedb_tpu_torch.parallel.kernels.topk_merge import (
        ring_topk_merge,
    )

    ns = entry.shards
    s_loc = entry.s_pad // ns
    cands = []
    outs, press = _eval_shards(entry, smask, win, fname=fname, fargs=fargs,
                               lookback_ticks=lookback_ticks)
    for s, (out, pres) in enumerate(zip(outs, press)):
        cands.append(_local_candidates(out, pres, _topk_key(out, pres,
                                                            largest),
                                       min(k, s_loc), s * s_loc))
    if ns == 1:
        f_key, f_vals, f_idx, f_pres = cands[0]
    elif kernel:
        f_key, f_vals, f_idx, f_pres = ring_topk_merge(cands, k)[0]
    else:
        c_key, c_val, c_idx, c_pres = (gather_blocks(list(p), dim=1)
                                       for p in zip(*cands))
        f_key, f_pos = _stable_topk(c_key, k)
        f_vals = torch.gather(c_val, 1, f_pos)
        f_idx = torch.gather(c_idx, 1, f_pos)
        f_pres = torch.gather(c_pres, 1, f_pos)
    f_pres = f_pres & torch.isfinite(f_key)
    return torch.cat([f_vals, f_idx.to(torch.float32),
                      f_pres.to(torch.float32)])


def try_fast_topk(engine, e, ev):
    """Serve global `topk/bottomk(k, range_fn(sel) | sel)` from the grid
    cache; grouped topk returns None."""
    from greptimedb_tpu_torch.promql.engine import VectorValue, _empty_vector
    from greptimedb_tpu_torch.query import planner

    if not isinstance(e, Agg) or e.op not in ("topk", "bottomk"):
        return None
    if e.grouping or e.without:
        return None
    if not isinstance(e.param, NumberLit):
        return None
    k = int(e.param.value)
    if k <= 0:
        return _empty_vector(ev)
    resolved = _resolve_fast_selector(engine, e.expr, ev)
    if resolved is None:
        return _fallback()
    if resolved == "empty":
        return _hit(_empty_vector(ev))
    entry, table, raw_matchers, fname, fargs, win = resolved
    matchers = engine._to_registry_matchers(raw_matchers, table)
    smask, any_match = _matcher_mask_dev(entry, matchers)
    if not any_match:
        return _hit(_empty_vector(ev))
    if entry.s_pad >= (1 << 24):
        # packed winner indices ride as f32 (exact only below 2^24)
        return None
    lookback_ticks = max(int(ev.lookback_ms // entry.spec.unit), 1)
    kk = min(k, entry.num_series)
    use_kernel = False
    kernel_label = None
    comm_bytes = 0
    if entry.shards > 1:
        from greptimedb_tpu_torch.parallel.kernels.topk_merge import (
            topk_comm_bytes,
        )

        kdec, kreason = planner.decide_kernel(
            "topk", series=entry.num_series, k=kk,
            opts=engine.instance.query_engine.mesh_opts,
            device=entry.devices[0])
        use_kernel = kdec == "ring"
        kernel_label = f"{kdec}({kreason})"
        if use_kernel:
            comm_bytes = topk_comm_bytes(entry.shards, win.num_steps, kk)
    skey = ("topk", fname, fargs, kk, e.op == "topk", win.range_ticks,
            win.l_cells, win.x64, entry.spec.tps, lookback_ticks, use_kernel)
    packed, hit = _run_program(
        "topk", ("topk", entry.shards) + skey, entry, skey,
        (smask, *_win_inputs(win)),
        lambda: _fused_topk(entry, smask, win, fname=fname, fargs=fargs,
                            k=kk, largest=e.op == "topk",
                            lookback_ticks=lookback_ticks,
                            kernel=use_kernel),
        dtype=None, collective=use_kernel, comm_bytes=comm_bytes)
    _note(engine, entry, "topk", kernel_label, comm_bytes,
          session="hit" if hit else "miss")
    jj = packed.shape[0] // 3
    top_vals = packed[:jj].astype(np.float64)      # (J, k)
    top_idx = packed[jj:2 * jj].astype(np.int64)
    top_pres = packed[2 * jj:] != 0.0
    j = top_vals.shape[0]
    sids = np.unique(top_idx[top_pres])
    if len(sids) == 0:
        return _hit(_empty_vector(ev))
    pos = {int(s): i for i, s in enumerate(sids)}
    vals_out = np.zeros((len(sids), j))
    pres_out = np.zeros((len(sids), j), bool)
    steps, ranks = np.nonzero(top_pres)
    rows_ = np.asarray([pos[int(s)] for s in top_idx[steps, ranks]])
    vals_out[rows_, steps] = top_vals[steps, ranks]
    pres_out[rows_, steps] = True
    labels = _series_labels_for(entry, table, sids)
    if fname == "__instant__":
        for lab in labels:
            lab["__name__"] = table.name
    return _hit(VectorValue(labels, vals_out, pres_out))


# ----------------------------------------------------------------------
# the one-device tail of the binary and histogram programs
# ----------------------------------------------------------------------

def _on_first(entry: _Entry, parts: list) -> torch.Tensor:
    """Per-shard (S_local, ...) tensors in shard order on the first
    shard's device as one (S_pad, ...) tensor. The JAX package runs the
    binary and histogram programs as single-device code under auto-SPMD
    (XLA picks the combine order there); the port moves every shard's
    per-series outputs to shard 0 and runs the one-device tail there, so a
    mesh engine's result is bit-identical to one device's."""
    from greptimedb_tpu_torch.parallel.dist import gather_blocks

    return parts[0] if len(parts) == 1 else gather_blocks(parts)


def _series_labels(entry: _Entry, table) -> list[dict]:
    """Per-sid tag dicts (no __name__), aligned with the entry's sid
    space; built once per entry (cached on it, like group_cache)."""
    hit = entry.group_cache.get("__series_labels__")
    if hit is not None:
        return hit
    reg = entry.registry
    visible = set(table.tag_names)
    tag_names = [t for t in reg.tag_names
                 if t in visible and not t.startswith("__")]
    cols = {t: reg.tag_values(t) for t in tag_names}
    labels = [{t: str(cols[t][s]) for t in tag_names if cols[t][s] != ""}
              for s in range(entry.num_series)]
    entry.group_cache["__series_labels__"] = labels
    return labels


def _vector_from_packed(packed_np: np.ndarray, labels: list, rows: int):
    """VectorValue of a packed [values; presence] (2 rows, J) readback,
    keeping the rows with any present step."""
    from greptimedb_tpu_torch.promql.engine import VectorValue

    n = len(packed_np) // 2
    vals_np = packed_np[:n][:rows]
    pres_np = packed_np[n:][:rows] != 0.0
    keep = pres_np.any(axis=1)
    if not keep.all():
        idx = np.nonzero(keep)[0]
        return VectorValue([labels[int(i)] for i in idx], vals_np[idx],
                           pres_np[idx])
    return VectorValue(list(labels), vals_np, pres_np)


# ----------------------------------------------------------------------
# vector <op> vector over the grid cache: label matching on sid codes
# ----------------------------------------------------------------------

_BINARY_FAST_OPS = frozenset({
    "+", "-", "*", "/", "%", "^",
    ">", "<", ">=", "<=", "==", "!=",
})


def _apply_op_dev(op: str, a: torch.Tensor, b: torch.Tensor):
    """jnp's elementwise binary operators: fmod is exact on every device;
    pow is the platform's powf (not always correctly rounded: C2)."""
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "/":
        return a / b
    if op == "%":
        return torch.fmod(a, b)
    if op == "^":
        return torch.pow(a, b)
    return {
        ">": a > b, "<": a < b, ">=": a >= b, "<=": a <= b,
        "==": a == b, "!=": a != b,
    }[op]


def _fused_binary(entry_l: _Entry, side_l: tuple, entry_r: _Entry,
                  side_r: tuple, *, op: str, bool_mod: bool, agg_op: str,
                  grp: _Grouping | None, lookback_ticks: int):
    """vector <op> vector (one-to-one, default matching): both sides share
    the table's sid space, so label matching is sid alignment. Each side
    is evaluated per shard and moved to the first shard's device
    (_on_first), then the operator and the optional aggregation
    (aggregate_across_series) run there. Returns the packed [values;
    presence] float32 result, (2G, J) with an aggregation, else
    (2 S_pad, J)."""
    outs = []
    for entry, (smask, fname, fargs, win) in ((entry_l, side_l),
                                               (entry_r, side_r)):
        o, p = _eval_shards(entry, smask, win, fname=fname, fargs=fargs,
                            lookback_ticks=lookback_ticks)
        outs.append((_on_first(entry, o), _on_first(entry, p)))
    (out_l, pres_l), (out_r, pres_r) = outs
    out_r, pres_r = out_r.to(out_l.device), pres_r.to(out_l.device)
    pres = pres_l & pres_r
    res = _apply_op_dev(op, out_l, out_r)
    if op in _CMP_OPS:
        if bool_mod:
            out = res.to(out_l.dtype)
        else:
            # a filtering comparison keeps the LEFT operand's sample
            pres = pres & res
            out = out_l
    else:
        out = res.to(out_l.dtype)
    if agg_op:
        dev = out.device
        vals_g, pres_g = K.aggregate_across_series(
            out, pres, grp.full(dev), grp.g + 1, agg_op,
            members=(None if K.uses_matmul(agg_op, grp.g + 1, out.shape[0])
                     else grp.group_members(dev)))
        return torch.cat([vals_g[:grp.g], pres_g[:grp.g].to(vals_g.dtype)])
    return torch.cat([out, pres.to(out.dtype)])


def _operand_shape_fast(expr) -> bool:
    """Static AST pre-check, before any entry resolution: a grid build can
    scan the whole table, so reject shapes the fast path cannot take."""
    if isinstance(expr, VectorSelector):
        return expr.range_ms is None
    return isinstance(expr, Call) and expr.name in _PREFIX_FNS


def _resolve_binary(engine, e, ev):
    """Both operands fast-resolve over the same series registry ->
    (left, right, table), "empty", or None."""
    if not isinstance(e, Binary) or e.op not in _BINARY_FAST_OPS:
        return None
    m = e.matching
    if m.explicit or m.labels or m.group or m.include:
        return None  # only default one-to-one matching rides sid codes
    if not (_operand_shape_fast(e.lhs) and _operand_shape_fast(e.rhs)):
        return None
    left = _resolve_fast_selector(engine, e.lhs, ev)
    if left is None:
        return None
    right = _resolve_fast_selector(engine, e.rhs, ev)
    if right is None:
        return None
    if left == "empty" or right == "empty":
        return "empty"
    if left[0].registry is not right[0].registry:
        return None  # different sid spaces: generic label matching
    return left, right, left[1]


def try_fast_binary(engine, e, ev, *, agg=None):
    """Serve `vecL <op> vecR` (and `agg(...)` around it) when both sides
    live on the same table's grid cache. Returns a VectorValue or None."""
    from greptimedb_tpu_torch.promql.engine import _empty_vector

    if agg is not None and agg.op not in _SIMPLE_AGGS:
        return None
    resolved = _resolve_binary(engine, e, ev)
    if resolved is None:
        return None
    if resolved == "empty":
        return _empty_vector(ev)
    left, right, table = resolved
    entry_l, _tl, raw_m_l, fname_l, fargs_l, win_l = left
    entry_r, _tr, raw_m_r, fname_r, fargs_r, win_r = right
    grp = None
    if agg is not None:
        grp = _grouping_dev(entry_l, table, agg.grouping, agg.without)
    smask_l, any_l = _matcher_mask_dev(
        entry_l, engine._to_registry_matchers(raw_m_l, table))
    smask_r, any_r = _matcher_mask_dev(
        entry_r, engine._to_registry_matchers(raw_m_r, table))
    if not (any_l and any_r):
        return _hit(_empty_vector(ev))
    lookback_ticks = max(int(ev.lookback_ms // entry_l.spec.unit), 1)
    agg_op = "" if agg is None else agg.op
    skey = ("binary", fname_l, fargs_l, fname_r, fargs_r, e.op,
            bool(e.bool_mod), agg_op, win_l.range_ticks, win_l.l_cells,
            win_r.range_ticks, win_r.l_cells, win_l.x64, lookback_ticks,
            entry_r.version)
    packed_np, hit = _run_program(
        "promql_binary", skey[:-1], entry_l, skey,
        (entry_r, smask_l, smask_r, grp,
         *_win_inputs(win_l), *_win_inputs(win_r)),
        lambda: _fused_binary(
            entry_l, (smask_l, fname_l, fargs_l, win_l),
            entry_r, (smask_r, fname_r, fargs_r, win_r), op=e.op,
            bool_mod=bool(e.bool_mod), agg_op=agg_op, grp=grp,
            lookback_ticks=lookback_ticks))
    _note(engine, entry_l, "binary", session="hit" if hit else "miss")
    if agg is not None:
        return _hit(_vector_from_packed(packed_np, grp.labels, grp.g))
    return _hit(_vector_from_packed(
        packed_np, _series_labels(entry_l, table), entry_l.num_series))


# ----------------------------------------------------------------------
# histogram_quantile over the grid cache
# ----------------------------------------------------------------------

def _fused_hist_query(entry: _Entry, smask: list, win: _Windows, *,
                      fname: str, fargs: tuple, agg_grp: _Grouping | None,
                      slot: torch.Tensor, le: torch.Tensor, g: int, b: int,
                      phi: float, lookback_ticks: int):
    """histogram_quantile(phi, [sum by (le, ...)] (range_fn(sel))): the
    per-series range function on every shard, then on the first shard's
    device (_on_first) the optional cross-series sum, the scatter into
    (group, bucket) slots and the quantile fold. Returns the packed
    (2G, J) float32 result."""
    outs, press = _eval_shards(entry, smask, win, fname=fname, fargs=fargs,
                               lookback_ticks=lookback_ticks)
    out, pres = _on_first(entry, outs), _on_first(entry, press)
    sel_mask = _on_first(entry, smask)
    dev = out.device
    if agg_grp is not None:
        # inner `sum by (le, ...)`: (S_pad, J) -> (G_agg, J); slot then maps
        # the aggregated series into histogram cells. An aggregated series
        # exists iff any member survived the matcher (the generic engine's
        # vector membership): an int count, exact in any order.
        g_agg = agg_grp.g
        gid = agg_grp.full(dev)
        exists = torch.zeros(g_agg + 1, dtype=torch.int32, device=dev)
        exists.index_add_(0, gid.to(torch.int64), sel_mask.to(torch.int32))
        out, pres = K.aggregate_across_series(
            out, pres, gid, g_agg + 1, "sum",
            members=(None if K.uses_matmul("sum", g_agg + 1, out.shape[0])
                     else agg_grp.group_members(dev)))
        out, pres = out[:g_agg], pres[:g_agg]
        sel_mask = exists[:g_agg] > 0
    j = out.shape[1]
    # -> (G, B, J) over unique (group, bucket) slots. Each slot holds at
    # most one series (_hist_grouping and _hist_slots_from_labels refuse
    # duplicates), so a slot's sum is 0 + x: index_add_ onto zeros gives
    # segment_sum's bits in any order (a -0.0 comes out +0.0 either way),
    # the one float scatter of the port that may use atomics.
    seg = torch.where(sel_mask & (slot >= 0), slot, g * b).to(torch.int64)
    bsum = torch.zeros((g * b + 1, j), dtype=torch.float32, device=dev)
    bsum.index_add_(0, seg, torch.where(pres, out, 0.0).to(torch.float32))
    bsum = bsum[:-1].reshape(g, b, j)
    bcnt = torch.zeros((g * b + 1, j), dtype=torch.int32, device=dev)
    bcnt.index_add_(0, seg, pres.to(torch.int32))
    bpres = bcnt[:-1].reshape(g, b, j) > 0
    # a histogram without a +Inf bucket is undefined: a group qualifies
    # only if a matcher-surviving series fills its +Inf cell (rank b - 1)
    inf_seg = torch.where(sel_mask & (slot >= 0) & (slot % b == b - 1),
                          slot // b, g).to(torch.int64)
    has_inf = torch.zeros(g + 1, dtype=torch.int32, device=dev)
    has_inf.index_add_(0, inf_seg, torch.ones_like(inf_seg,
                                                   dtype=torch.int32))
    q_out, q_ok = K.histogram_quantile(le, bsum.transpose(1, 2),
                                       bpres.transpose(1, 2), phi)
    q_ok = q_ok & (has_inf[:g] > 0)[:, None]
    return torch.cat([q_out, q_ok.to(q_out.dtype)])


def _hist_grouping(entry: _Entry, table):
    """(labels, slot (S_pad,) int32 on the first shard's device, le (B,)
    float64, G, B):
    groups are the label sets minus `le`; a series' bucket is the rank of
    its le bound. None when the layout cannot take the fast path (no le
    tag, unparsable bounds, duplicate (group, le) series, or no +Inf
    bucket); that verdict is cached too."""
    key = ("__hist__",)
    hit = entry.group_cache.get(key)
    if hit is not None:
        return None if hit == "unservable" else hit

    def reject():
        # an unservable layout must not re-pay the O(series) le parsing
        # on every query before it falls back
        entry.group_cache[key] = "unservable"
        return None

    reg = entry.registry
    if "le" not in reg.tag_names:
        return reject()
    s = entry.num_series
    codes = reg.codes_matrix()[:s]
    le_raw = reg.tag_values("le")[:s]
    le_vals = np.full(s, np.nan)
    for i, t in enumerate(le_raw):
        if t == "":
            continue
        try:
            le_vals[i] = float(t.replace("+Inf", "inf"))
        except ValueError:
            pass
    valid = np.isfinite(le_vals) | np.isposinf(le_vals)
    if not valid.any():
        return reject()
    visible = set(table.tag_names)
    gcols = [i for i, nm in enumerate(reg.tag_names)
             if nm != "le" and nm in visible and not nm.startswith("__")]
    uniq_le = np.unique(le_vals[valid])
    if not np.isposinf(uniq_le[-1]):
        return reject()  # no +Inf bucket: undefined histogram
    b = len(uniq_le)
    bidx = np.searchsorted(uniq_le, le_vals[valid])
    if gcols:
        sub = codes[valid][:, gcols]
        uniq_g, ginv = np.unique(sub, axis=0, return_inverse=True)
        ginv = np.ravel(ginv)
        g = len(uniq_g)
    else:
        uniq_g = np.zeros((1, 0), codes.dtype)
        ginv = np.zeros(int(valid.sum()), np.int64)
        g = 1
    slots = ginv * b + bidx
    if len(np.unique(slots)) != len(slots):
        return reject()  # duplicate (group, le): conflicting buckets
    slot_full = np.full(entry.s_pad, -1, np.int32)
    slot_full[np.nonzero(valid)[0]] = slots.astype(np.int32)
    labels = []
    for row in uniq_g:
        lab = {}
        for ci, code in zip(gcols, row):
            v = reg.dicts[ci].decode(int(code))
            if v != "" and reg.tag_names[ci] != "__name__":
                lab[reg.tag_names[ci]] = v
        labels.append(lab)
    out = (labels, torch.from_numpy(slot_full).to(entry.devices[0]), uniq_le,
           g, b)
    if len(entry.group_cache) >= 128:
        entry.group_cache.pop(next(iter(entry.group_cache)))
    entry.group_cache[key] = out
    return out


def _hist_slots_from_labels(labels):
    """Histogram cells over aggregated series labels: (out_labels, slot
    array, le array, G, B) or None."""
    keys, le_vals = [], []
    for lab in labels:
        le = lab.get("le")
        v = None
        if le is not None:
            try:
                v = float(str(le).replace("+Inf", "inf"))
            except ValueError:
                pass
        le_vals.append(v)
        keys.append(tuple(sorted((k, val) for k, val in lab.items()
                                 if k not in ("le", "__name__"))))
    valid = [i for i, v in enumerate(le_vals) if v is not None]
    if not valid:
        return None
    uniq_le = np.unique(np.asarray([le_vals[i] for i in valid]))
    if not np.isposinf(uniq_le[-1]):
        return None
    b = len(uniq_le)
    uniq_keys = sorted({keys[i] for i in valid})
    kidx = {k: i for i, k in enumerate(uniq_keys)}
    g = len(uniq_keys)
    slot = np.full(len(labels), -1, np.int32)
    seen = set()
    for i in valid:
        s = kidx[keys[i]] * b + int(np.searchsorted(uniq_le, le_vals[i]))
        if s in seen:
            return None  # duplicate (group, le)
        seen.add(s)
        slot[i] = s
    return [dict(k) for k in uniq_keys], slot, uniq_le, g, b


def try_fast_histogram(engine, phi: float, inner, ev):
    """Serve `histogram_quantile(phi, range_fn(sel))`,
    `histogram_quantile(phi, sel)` and
    `histogram_quantile(phi, sum by (le, ...)(range_fn(sel)))` from the
    grid cache. Returns a VectorValue, or None for the generic engine."""
    from greptimedb_tpu_torch.promql.engine import _empty_vector

    agg = None
    if (isinstance(inner, Agg) and inner.op == "sum" and not inner.without
            and inner.grouping and "le" in inner.grouping):
        agg = inner
        inner = inner.expr
    resolved = _resolve_fast_selector(engine, inner, ev)
    if resolved is None:
        return _fallback()
    if resolved == "empty":
        return _hit(_empty_vector(ev))
    entry, table, raw_matchers, fname, fargs, win = resolved
    agg_grp = None
    if agg is not None:
        agg_grp = _grouping_dev(entry, table, agg.grouping, agg.without)
        if agg_grp.hist_slots is None:
            cells = _hist_slots_from_labels(agg_grp.labels)
            agg_grp.hist_slots = "unservable" if cells is None else (
                *cells[:1], torch.from_numpy(cells[1]).to(entry.devices[0]),
                *cells[2:])
        if agg_grp.hist_slots == "unservable":
            return _fallback()
        labels, slot, uniq_le, g, b = agg_grp.hist_slots
    else:
        grouping = _hist_grouping(entry, table)
        if grouping is None:
            return _fallback()
        labels, slot, uniq_le, g, b = grouping
    matchers = engine._to_registry_matchers(raw_matchers, table)
    smask, any_match = _matcher_mask_dev(entry, matchers)
    if not any_match:
        return _hit(_empty_vector(ev))
    lookback_ticks = max(int(ev.lookback_ms // entry.spec.unit), 1)
    le_host = np.asarray(uniq_le, np.float32)
    skey = ("hist", fname, fargs, g, b, float(phi), le_host.tobytes(),
            win.range_ticks, win.l_cells, win.x64, lookback_ticks)
    packed_np, hit = _run_program(
        "promql_histogram", skey[:5] + skey[7:], entry, skey,
        (smask, agg_grp, slot, *_win_inputs(win)),
        lambda: _fused_hist_query(
            entry, smask, win, fname=fname, fargs=fargs, agg_grp=agg_grp,
            slot=slot, le=torch.from_numpy(le_host).to(slot.device), g=g,
            b=b, phi=phi, lookback_ticks=lookback_ticks))
    _note(engine, entry, "histogram", session="hit" if hit else "miss")
    return _hit(_vector_from_packed(packed_np, labels, g))


def invalidate_cache():
    _CACHE.invalidate()


def drop_table_entries(table):
    """Called by the catalog on DROP TABLE so grids don't pin dead
    tables."""
    _CACHE.drop_table(table)
