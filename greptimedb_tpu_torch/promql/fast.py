"""Cached device fast path for hot PromQL shapes (the JAX package's
promql/fast.py, for the shapes this slice ports).

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
  cross-series aggregation (ops/promql.aggregate_across_series_blocked) or
  per-step top-k, so a query moves J * 12 bytes of window indices to the
  card and a packed (2G, J) or (3J, k) result back.

Shapes served: `agg [by|without (...)] (range_fn(sel[d]))` and
`agg [by|without (...)] (sel)` with agg in sum/avg/min/max/count/group/
stddev/stdvar, and global `topk|bottomk(k, range_fn(sel[d]) | sel)`. Every
other shape, and a query whose step/range/start does not land on the
cached grid's cells, returns None; the engine then raises
UnsupportedError (the generic engine is not ported yet).

The sharded aggregate uses the gather twin (parallel/dist.ShardFoldCtx),
as the JAX package does. The sharded topk takes a local per-step top-k on
every shard and either reselects over the shard-order concatenation (the
gather twin) or merges the candidates around the ring with the topk merge
kernel (parallel/kernels/topk_merge.py), as planner.decide_kernel("topk")
says. Both select bit-identically to the one-device program.

The cache key carries the query engine's device, mesh and mesh options
(the JAX package's is (table, field), where a change of mesh options needs
invalidate_cache()), so engines with different meshes over one table keep
separate grids.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from greptimedb_tpu_torch.ops import promql as K
from greptimedb_tpu_torch.ops import window as W
from greptimedb_tpu_torch.promql.parser import (
    Agg,
    Call,
    NumberLit,
    VectorSelector,
)

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
                return e
        e = _build_entry(table, fieldname, version, device=device,
                         mesh=mesh, mesh_opts=mesh_opts,
                         byte_budget=self.byte_budget)
        if e is None:
            return None
        with self._lock:
            self._entries[key] = e
            e.last_used = time.monotonic()
            self._evict_locked(keep=key)
        return e

    def _evict_locked(self, keep):
        total = sum(e.nbytes for e in self._entries.values())
        for key, _ in sorted(self._entries.items(),
                             key=lambda kv: kv[1].last_used):
            if total <= self.byte_budget:
                return
            if key != keep:
                total -= self._entries.pop(key).nbytes

    def invalidate(self):
        with self._lock:
            self._entries.clear()

    def drop_table(self, table):
        with self._lock:
            for key in [k for k, e in self._entries.items()
                        if e.table is table]:
                del self._entries[key]


_CACHE = SelectorGridCache()


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

    gvals, ghas, gtsg = G.gridify(
        up(np.asarray(rows.sid, np.int32)),
        up(spec.cell_of(ts).astype(np.int32)),
        up(spec.device_ts(ts)),
        up(np.asarray(rows.fields[fieldname], np.float32)),
        up(mask), s_pad, nc,
    )
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

    @property
    def num_steps(self) -> int:
        return int(self.lo[0].shape[0])


def _eval_side(vals, has, tsg, smask, lo, hi, t_end, *, fname, range_ticks,
               l_cells, tps, lookback_ticks):
    """Instant lookback or range function over one shard's masked grid —
    the front half of every fused query."""
    has = has & smask[:, None]
    if fname == "__instant__":
        return W.instant_lookback(vals, has, tsg, hi, t_end, lookback_ticks)
    win = _WinShim(lo, hi, t_end, range_ticks, l_cells)
    return K.eval_range_function(fname, vals, has, tsg, win, tps)


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
    set (padded series are always False) and whether any series matched.
    Cached so repeated queries move no bytes."""
    key = tuple((name, op, value.pattern if hasattr(value, "pattern")
                 else value) for name, op, value in matchers)
    hit = entry.match_cache.get(key)
    if hit is not None:
        return hit
    mask = np.zeros(entry.s_pad, bool)
    if matchers:
        mask[:entry.num_series] = entry.registry.match_mask(
            matchers)[:entry.num_series]
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
    per shard; built once per grouping."""
    from greptimedb_tpu_torch.parallel.kernels.ring_fold import fold_members
    from greptimedb_tpu_torch.parallel.mesh import FOLD_BLOCKS

    if grp.fold_members is None:
        per = entry.s_pad // entry.shards
        grp.fold_members = [
            fold_members(grp.gid_host[k * per:(k + 1) * per], grp.g + 1,
                         FOLD_BLOCKS // entry.shards, d)
            for k, d in enumerate(entry.devices)]
    return grp.fold_members


def _fused_query(entry: _Entry, smask: list, grp: _Grouping, win: _Windows,
                 *, fname: str, op: str, lookback_ticks: int):
    """The whole query over every shard: matcher mask, range function or
    instant lookback, cross-series aggregation (the JAX package's
    _fused_query and its shard_map twin _make_sharded_fused_query: one
    shard runs LocalFoldCtx, several the gather twin ShardFoldCtx). Returns
    the packed (2G, J) float32 result on the first shard's device."""
    from greptimedb_tpu_torch.parallel.dist import LocalFoldCtx, ShardFoldCtx

    ns = entry.shards
    g = grp.g
    outs, press = [], []
    for k in range(ns):
        out, pres = _eval_side(
            entry.vals[k], entry.has[k], entry.tsg[k], smask[k], win.lo[k],
            win.hi[k], win.t_end[k], fname=fname,
            range_ticks=win.range_ticks, l_cells=win.l_cells,
            tps=entry.spec.tps, lookback_ticks=lookback_ticks)
        outs.append(out)
        press.append(pres)
    fms = None
    if not K.uses_matmul(op, g + 1, entry.s_pad):
        fms = _fold_members(entry, grp)
    ctx = LocalFoldCtx() if ns == 1 else ShardFoldCtx(ns)
    vals_g, pres_g = K.aggregate_across_series_blocked(
        outs, press, grp.gid, g + 1, op, total_series=entry.s_pad, ctx=ctx,
        fms=fms)
    # one packed (2G, J) buffer: one card -> host transfer per query
    return torch.cat([vals_g[:g], pres_g[:g].to(vals_g.dtype)])


def _resolve_fast_selector(engine, inner, ev):
    """Match `range_fn(sel)` / a bare instant selector, resolve the table
    and its grid entry, plan the windows. Returns (entry, table,
    raw_matchers, fname, win), "empty" for a selector with no series, or
    None for a shape the fast path does not serve."""
    if isinstance(inner, Call) and inner.name in K.RANGE_FUNCTIONS:
        if len(inner.args) != 1:
            return None
        sel = inner.args[0]
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
        return "empty"  # an unknown metric selects no series
    fieldname = engine._value_field(table, field_sel)
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
    return entry, table, raw_matchers, fname, win


def _note(engine, entry: _Entry, kind: str, kernel=None, comm_bytes=0):
    """What the last fast-path query ran (the JAX package's EXPLAIN
    ANALYZE notes): shard count, mesh decision, program variant."""
    dec = entry.mesh_decision
    engine.last_fast = {
        "kind": kind, "shards": entry.shards,
        "decision": None if dec is None else dec.label(),
        "kernel": kernel, "comm_bytes": comm_bytes,
    }


def try_fast(engine, e, ev):
    """Serve `agg(range_fn(selector))` / `agg(selector)` from the grid
    cache. Returns a VectorValue, or None for a shape it does not serve."""
    from greptimedb_tpu_torch.promql.engine import VectorValue, _empty_vector
    from greptimedb_tpu_torch.query import readback

    if not isinstance(e, Agg) or e.op not in _SIMPLE_AGGS:
        return None
    resolved = _resolve_fast_selector(engine, e.expr, ev)
    if resolved is None:
        return None
    if resolved == "empty":
        return _empty_vector(ev)
    entry, table, raw_matchers, fname, win = resolved
    matchers = engine._to_registry_matchers(raw_matchers, table)
    smask, any_match = _matcher_mask_dev(entry, matchers)
    if not any_match:
        return _empty_vector(ev)
    grp = _grouping_dev(entry, table, e.grouping, e.without)
    lookback_ticks = max(int(ev.lookback_ms // entry.spec.unit), 1)
    packed = _fused_query(entry, smask, grp, win, fname=fname, op=e.op,
                          lookback_ticks=lookback_ticks)
    _note(engine, entry, "promql")
    packed_np = readback.read_full(packed, np.float64)
    g = grp.g
    vals_np = packed_np[:g]
    pres_np = packed_np[g:] != 0.0
    keep = pres_np.any(axis=1)
    if not keep.all():
        idx = np.nonzero(keep)[0]
        return VectorValue([grp.labels[i] for i in idx], vals_np[idx],
                           pres_np[idx])
    return VectorValue(list(grp.labels), vals_np, pres_np)


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
                k: int, largest: bool, lookback_ticks: int,
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
    for s in range(ns):
        out, pres = _eval_side(
            entry.vals[s], entry.has[s], entry.tsg[s], smask[s], win.lo[s],
            win.hi[s], win.t_end[s], fname=fname,
            range_ticks=win.range_ticks, l_cells=win.l_cells,
            tps=entry.spec.tps, lookback_ticks=lookback_ticks)
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
    from greptimedb_tpu_torch.query import planner, readback

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
        return None
    if resolved == "empty":
        return _empty_vector(ev)
    entry, table, raw_matchers, fname, win = resolved
    matchers = engine._to_registry_matchers(raw_matchers, table)
    smask, any_match = _matcher_mask_dev(entry, matchers)
    if not any_match:
        return _empty_vector(ev)
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
    packed_dev = _fused_topk(entry, smask, win, fname=fname, k=kk,
                             largest=e.op == "topk",
                             lookback_ticks=lookback_ticks,
                             kernel=use_kernel)
    _note(engine, entry, "topk", kernel_label, comm_bytes)
    packed = readback.read_full(packed_dev)
    jj = packed.shape[0] // 3
    top_vals = packed[:jj].astype(np.float64)      # (J, k)
    top_idx = packed[jj:2 * jj].astype(np.int64)
    top_pres = packed[2 * jj:] != 0.0
    j = top_vals.shape[0]
    sids = np.unique(top_idx[top_pres])
    if len(sids) == 0:
        return _empty_vector(ev)
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
    return VectorValue(labels, vals_out, pres_out)


def invalidate_cache():
    _CACHE.invalidate()
