"""Grouped reductions of GROUP BY, on the host (numpy) or on the card
(the JAX package's query/reduce.py).

`grouped_reduce` routes one GROUP BY: small row counts, ops or dtypes the
device program does not take, and `prefer_device=False` run vectorized
numpy (`_host_reduce`, copied); the rest runs the fused device program
(`_fused_program`) and one readback, then the host combines the blocked
float32 partials in float64, as the JAX package does.

The device program computes what the JAX package's fused XLA program
computes, in the same order, with these pieces:

- per-(block, group) float32 sums (counts, sums, squared deviations:
  `pseg2`) and per-group extremes through kernel G
  (parallel/kernels/grouped_reduce.grouped_block_reduce), whose fixed
  order reproduces XLA:CPU's segment_sum/segment_max bit for bit;
- the per-group float32 mean of the var/stddev deviations through kernel
  Gt (column_tree_sum: XLA:CPU's chunk-of-32 tree for jnp.sum over the
  block axis);
- first/last winners resolved exactly by the (ts_hi, ts_lo, row) int32
  key in three stages, each an int32 extreme of G over the mask's member
  order (int32 extremes are exact in any order; an atomic scatter_reduce
  over every row into a handful of groups serializes on the card). The
  last stage's extreme is the winner's row itself, so its value is one
  gather per group: each group has exactly one winner, no two floats are
  ever added and the value does not depend on an order. XLA's
  segment_sum adds that one value to zeros, which turns -0.0 into +0.0;
  the port adds +0.0 to it for the same bits (on the card a NaN comes out
  as the card's canonical NaN, ROADMAP C2).

Sharded (`mesh`): rows are cut into `ns` contiguous slices on the mesh's
devices; with `bl = blocks // ns` local blocks of the same width, each
shard runs G on its slice, blocked sections concatenate in shard order,
extremes and the winner stages combine through the fold ctx's `pext` and
the winner values through its `psum` (RingFoldCtx: the ring kernels 4r/5r,
or 4/5 hop by hop; ShardFoldCtx: the gather twin). Results are bit-
identical to one device. var/stddev never shard (planner.SHARDABLE_ROW_OPS).
"""

from __future__ import annotations

import numpy as np
import torch

from greptimedb_tpu_torch.datatypes.batch import bucket_size, pad_to
from greptimedb_tpu_torch.errors import (
    ArithmeticOverflowError,
    UnsupportedError,
)
from greptimedb_tpu_torch.parallel import dist
from greptimedb_tpu_torch.parallel.kernels import grouped_reduce as gr
from greptimedb_tpu_torch.parallel.kernels import ring_fold
from greptimedb_tpu_torch.parallel.mesh import shard_count
from greptimedb_tpu_torch.query import readback

DEVICE_THRESHOLD = 262_144  # rows below this stay on the host (prefer None)

_2_31M = 2**31 - 1


def _pad_group_count(g: int) -> int:
    b = 1
    while b < g:
        b *= 2
    return b


def _pow2_floor(n: int) -> int:
    b = 1
    while b * 2 <= n:
        b *= 2
    return b


def _pick_blocks(nb: int, gb: int) -> int:
    """Power-of-two row-block count of the fused program, independent of
    the mesh: sharded and one-device runs of the same query use the same
    block boundaries, so their float32 partials (and the host float64
    combine) agree bit for bit."""
    return max(1, min(nb, _pow2_floor(max(8, (1 << 20) // max(gb, 1)))))


# ----------------------------------------------------------------------
# host path (copied from the JAX package)
# ----------------------------------------------------------------------

def grouped_minmax_typed(op: str, values, valid, gid, g: int):
    """Per-group min/max preserving the input dtype: BIGINT/timestamp
    extremes above 2^53 never round-trip through float, strings order
    lexicographically via lexsort, floats keep numpy NaN propagation.
    Returns (out_values, present_mask)."""
    present = np.zeros(g, bool)
    present[gid[valid]] = True
    if values.dtype == object or values.dtype.kind in "US":
        vv = values[valid].astype(str)
        gg = gid[valid]
        order = np.lexsort((vv, gg))
        gs = gg[order]
        edge = np.ones(len(gs), bool)
        if op == "min":
            edge[1:] = gs[1:] != gs[:-1]
        else:
            edge[:-1] = gs[:-1] != gs[1:]
        out = np.full(g, "", object)
        out[gs[edge]] = values[valid][order][edge]
        return out, present
    ufunc = np.minimum if op == "min" else np.maximum
    if values.dtype.kind in "iu":
        info = np.iinfo(values.dtype)
        init = info.max if op == "min" else info.min
        out = np.full(g, init, values.dtype)
        ufunc.at(out, gid[valid], values[valid])
        return np.where(present, out, 0), present
    v = values.astype(np.float64, copy=False)
    out = np.full(g, np.inf if op == "min" else -np.inf)
    ufunc.at(out, gid[valid], v[valid])
    return np.where(present, out, 0.0), present


def _host_reduce(op: str, values, valid, gid, g: int, q: float | None,
                 order_ts=None):
    """One aggregate over host arrays. values may be None for count(*).
    Returns (out_values, out_valid)."""
    n = len(gid)
    if op == "count":
        if values is None:
            cnt = np.bincount(gid, minlength=g)
        else:
            cnt = np.bincount(gid[valid], minlength=g)
        return cnt.astype(np.int64), None
    if op == "count_distinct":
        if n == 0:
            return np.zeros(g, np.int64), None
        vv = values[valid]
        gg = gid[valid]
        if vv.dtype == object:
            vv = vv.astype(str)
        pairs = np.unique(
            np.stack([gg.astype(np.int64),
                      np.unique(vv, return_inverse=True)[1].astype(np.int64)]),
            axis=1,
        )
        return np.bincount(pairs[0], minlength=g).astype(np.int64), None

    # dtype-preserving paths before the f64 cast: BIGINT/timestamp
    # extremes and sums above 2^53 stay exact, strings order
    # lexicographically
    if op in ("min", "max"):
        return grouped_minmax_typed(op, values, valid, gid, g)
    if op == "sum" and values.dtype.kind in "iu":
        present = np.zeros(g, bool)
        present[gid[valid]] = True
        vals = values[valid]
        gg = gid[valid]
        out = np.zeros(g, np.int64)
        if vals.size:
            info64 = np.iinfo(np.int64)
            infov = np.iinfo(vals.dtype)
            mag_dtype = max(abs(int(infov.max)), abs(int(infov.min)))
            # cheapest-first safety ladder: (1) the dtype bound, no data
            # pass; (2) the observed extremes with the row count as the
            # group-size cap; (3) only then the exact path
            safe = vals.size * mag_dtype <= info64.max
            if not safe:
                vmax, vmin = int(vals.max()), int(vals.min())
                safe = (vmax <= info64.max
                        and vals.size * max(abs(vmax), abs(vmin))
                        <= info64.max)
            if safe:
                np.add.at(out, gg, vals.astype(np.int64))
            else:
                # exact big-int accumulation: uint64 above 2^63 stays
                # exact and a true overflow is detected, never wrapped
                exact = np.zeros(g, object)
                np.add.at(exact, gg, np.asarray(vals.tolist(), object))
                hi = max(exact[present], default=0)
                lo = min(exact[present], default=0)
                if hi > info64.max or lo < info64.min:
                    raise ArithmeticOverflowError(
                        f"SUM overflows BIGINT: group total "
                        f"{hi if hi > info64.max else lo} "
                        f"is outside [{info64.min}, {info64.max}]"
                    )
                out[present] = exact[present].astype(np.int64)
        return out, present

    v = values.astype(np.float64, copy=False)
    vm = np.where(valid, v, 0.0)
    cnt = np.bincount(gid[valid], minlength=g)
    present = cnt > 0
    if op == "sum":
        s = np.bincount(gid, weights=vm, minlength=g)
        return s, present
    if op == "mean":
        s = np.bincount(gid, weights=vm, minlength=g)
        return s / np.maximum(cnt, 1), present
    if op in ("var_pop", "var_samp", "stddev_pop", "stddev_samp"):
        s = np.bincount(gid, weights=vm, minlength=g)
        mean = s / np.maximum(cnt, 1)
        dev = np.where(valid, v - mean[gid], 0.0)
        s2 = np.bincount(gid, weights=dev * dev, minlength=g)
        ddof = 1 if op.endswith("_samp") else 0
        var = s2 / np.maximum(cnt - ddof, 1)
        ok = cnt > ddof
        if op.startswith("stddev"):
            return np.sqrt(var), ok
        return var, ok
    if op in ("first_value", "last_value"):
        ts = order_ts if order_ts is not None else np.arange(n)
        idx = np.arange(n)
        order = np.lexsort((idx, ts))
        order = order[valid[order]]
        if op == "first_value":
            order = order[::-1]
        out = np.zeros(g, dtype=v.dtype)
        # later assignments win: ascending order leaves the latest
        # timestamp for last_value, the earliest for first_value
        out[gid[order]] = v[order]
        return out, present
    if op == "quantile":
        order = np.lexsort((v, gid))
        order = order[valid[order]]
        gg = gid[order]
        vv = v[order]
        starts = np.zeros(g, np.int64)
        np.cumsum(np.bincount(gg, minlength=g), out=starts)
        starts = np.concatenate([[0], starts[:-1]])
        rank = q * np.maximum(cnt - 1, 0)
        lo = np.floor(rank).astype(np.int64)
        hi = np.ceil(rank).astype(np.int64)
        frac = rank - lo

        def take(i):
            if not len(vv):
                return np.zeros(g)
            return vv[np.minimum(starts + i, max(len(vv) - 1, 0))]

        v_lo = take(lo)
        v_hi = take(hi)
        out = v_lo + (v_hi - v_lo) * frac
        return np.where(present, out, 0.0), present
    raise UnsupportedError(f"aggregate op: {op}")


# ----------------------------------------------------------------------
# device path: one program, one device -> host transfer
# ----------------------------------------------------------------------

_DEVICE_OPS = {"count", "sum", "mean", "min", "max", "var_pop", "var_samp",
               "stddev_pop", "stddev_samp", "first_value", "last_value"}
_VAR_OPS = ("var_pop", "var_samp", "stddev_pop", "stddev_samp")


def _fused_program(shards: list, spec: tuple, ctx):
    """Every aggregate of a GROUP BY over per-shard inputs (the JAX
    package's _fused_program for one shard, _sharded_fused_program for
    more). Each shard is a dict of (nbl,) tensors on its device: "vals"
    (V, nbl) float32, "masks" (M, nbl) bool, "gid" int32, "tshi"/"tslo"
    int32 and "row0", its first global row. Returns (blocked, single): the
    (blocks, gb) sections in the JAX program's order and the (gb,) rows of
    the extremes and winners, all on shard 0's device."""
    gb, blocks, mask_rows, items = spec
    ns = len(shards)
    bl = blocks // ns  # local blocks per shard (aligned boundaries)
    members: dict = {}

    def mem(k, mi):
        # the member order of one mask on one shard, built once
        if (k, mi) not in members:
            sh = shards[k]
            members[k, mi] = gr.group_members(sh["gid"], sh["masks"][mi],
                                              bl, gb)
        return members[k, mi]

    def pseg2(vs, mi):
        parts = [gr.grouped_block_reduce(vs[k], mem(k, mi), "sum")
                 for k in range(ns)]
        return parts[0] if ns == 1 else dist.gather_blocks(parts)

    blocked, single, cnt_parts = [], [], []
    for mi in range(mask_rows):
        cp = pseg2([torch.ones(sh["gid"].numel(), dtype=torch.float32,
                               device=sh["gid"].device) for sh in shards], mi)
        blocked.append(cp)
        cnt_parts.append(cp)
    for op, vi, mi in items:
        if op == "count":
            continue  # rides the mask's count rows
        vs = [sh["vals"][vi] for sh in shards]
        masks = [sh["masks"][mi] for sh in shards]
        if op in ("sum", "mean"):
            blocked.append(pseg2(vs, mi))
        elif op in _VAR_OPS:
            if ns > 1:
                raise ValueError(f"{op} does not shard (SHARDABLE_ROW_OPS)")
            sp = pseg2(vs, mi)
            cnt32 = gr.column_tree_sum(cnt_parts[mi])
            m32 = gr.column_tree_sum(sp) / torch.clamp(cnt32, min=1.0)
            gid = shards[0]["gid"].to(torch.int64)
            dev = torch.where(masks[0], vs[0] - m32[gid], 0.0)
            blocked.append(pseg2([dev * dev], mi))
        elif op in ("min", "max"):
            r = [gr.grouped_block_reduce(vs[k], mem(k, mi), op)
                 for k in range(ns)]
            single.append(ctx.pext(r, take_max=op == "max")[0])
        elif op in ("first_value", "last_value"):
            single.append(_winner_values(
                shards, vs, masks, [mem(k, mi) for k in range(ns)], gb, ctx,
                last=op == "last_value"))
        else:
            raise UnsupportedError(f"device aggregate op: {op}")
    return blocked, single


def _winner_values(shards, vs, masks, members, gb, ctx, *, last: bool):
    """first_value/last_value per group: the winner row by the exact
    (ts_hi, ts_lo, global row) int32 key in three stages (each a per-shard
    int32 extreme of G, combined across shards by ctx.pext), then its
    value, gathered on the shard that holds the row and summed across
    shards by ctx.psum (every other shard holds +0.0)."""
    ns = len(shards)
    form = "max" if last else "min"
    sent = -1 if last else _2_31M
    ties = list(masks)
    for name in ("tshi", "tslo", "idx"):
        keys = []
        for sh in shards:
            if name == "idx":
                n = sh["gid"].numel()
                keys.append(torch.arange(sh["row0"], sh["row0"] + n,
                                         dtype=torch.int32,
                                         device=sh["gid"].device))
            else:
                keys.append(sh[name])
        ws = ctx.pext([gr.grouped_block_reduce(
            torch.where(ties[k], keys[k], sent), members[k], form)
            for k in range(ns)], take_max=last)
        if name != "idx":
            ties = [ties[k] & (keys[k] == ws[k][shards[k]["gid"].long()])
                    & masks[k] for k in range(ns)]
    rs = []
    for k, sh in enumerate(shards):
        n = sh["gid"].numel()
        row = ws[k].long() - sh["row0"]
        here = (row >= 0) & (row < n)
        rs.append(torch.where(here, vs[k][row.clamp(0, n - 1)] + 0.0, 0.0))
    return ctx.psum(rs)[0]


def _fold_ctx(mesh, kernel: bool, ns: int):
    """The cross-shard hooks of one run: identity on one device, the ring
    kernels (ring_fold.RingFoldCtx) or the gather twin."""
    if mesh is None:
        return dist.LocalFoldCtx(), "single", None
    if kernel:
        ctx = ring_fold.RingFoldCtx(ns)
        return ctx, "sharded_ring", ctx.form(mesh.devices)
    return dist.ShardFoldCtx(ns), "sharded_gather", None


def _device_reduce_fused(specs, values: dict, gid, valid_map, g: int, ts, *,
                         device, mesh=None, kernel: bool = False):
    """Single-program GROUP BY. specs: (name, op, vkey|None, q). Returns
    ({name: (np values, np valid|None)}, program note). kernel=True runs
    the cross-shard combines on the ring kernels (planner-decided)."""
    n = len(gid)
    nb = bucket_size(n)
    if mesh is not None:
        nb = max(nb, shard_count(mesh))  # bucket sizes are powers of two
    gb = _pad_group_count(g)
    blocks = _pick_blocks(nb, gb)
    if mesh is not None and (blocks % shard_count(mesh) or nb % blocks):
        # shard boundaries must align with block boundaries for the exact
        # blocked combine; such geometries run on one device
        mesh = None

    # distinct validity masks (mask 0 = all-valid)
    mask_arrays = [np.ones(n, dtype=bool)]
    mask_of: dict = {None: 0}
    for _, _, vk, _ in specs:
        m = valid_map.get(vk) if vk else None
        mid = id(m) if m is not None else None
        if mid not in mask_of:
            mask_of[mid] = len(mask_arrays)
            mask_arrays.append(m)
    vkeys = sorted({vk for _, _, vk, _ in specs if vk is not None})
    vidx = {k: i for i, k in enumerate(vkeys)}
    h_vals = (np.stack([pad_to(values[k].astype(np.float32, copy=False), nb)
                        for k in vkeys])
              if vkeys else np.zeros((1, nb), np.float32))
    h_masks = np.stack([pad_to(m, nb, fill=False) for m in mask_arrays])
    h_gid = pad_to(gid.astype(np.int32), nb)
    if ts is not None and any(
        op in ("first_value", "last_value") for _, op, _, _ in specs
    ):
        rel = (ts.astype(np.int64) - int(ts.min())) if n else ts
        tshi = (rel >> 31).astype(np.int32)
        tslo = (rel & _2_31M).astype(np.int32)
    else:
        tshi = tslo = np.zeros(n, np.int32)
    h_tshi = pad_to(tshi, nb)
    h_tslo = pad_to(tslo, nb)

    items = tuple(
        (op, vidx[vk] if vk is not None else -1,
         mask_of[id(valid_map[vk]) if vk and vk in valid_map else None])
        for _, op, vk, _ in specs
    )
    spec = (gb, blocks, len(mask_arrays), items)
    devices = list(mesh.devices) if mesh is not None else [device]
    ns = len(devices)
    nbl = nb // ns

    def put(a, k):
        return torch.from_numpy(np.ascontiguousarray(
            a[..., k * nbl:(k + 1) * nbl])).to(devices[k])

    shards = [{"vals": put(h_vals, k), "masks": put(h_masks, k),
               "gid": put(h_gid, k), "tshi": put(h_tshi, k),
               "tslo": put(h_tslo, k), "row0": k * nbl}
              for k in range(ns)]
    ctx, program, ring_form = _fold_ctx(mesh, kernel, ns)
    blocked, single = _fused_program(shards, spec, ctx)
    # reassemble the JAX program's row layout on shard 0's device: per
    # mask its count rows, then per item its blocked rows or one row
    pieces = list(blocked[:len(mask_arrays)])
    bi, si = len(mask_arrays), 0
    for op, _vi, _mi in items:
        if op == "count":
            continue
        if op in ("sum", "mean") or op in _VAR_OPS:
            pieces.append(blocked[bi])
            bi += 1
        else:
            pieces.append(single[si][None, :])
            si += 1
    out_mat = readback.read_full(torch.cat(pieces), np.float64)

    # decode: host f64 combine of the blocked partials (the JAX package's)
    cnts = []
    r = 0
    for _ in mask_arrays:
        cnts.append(out_mat[r:r + blocks].sum(axis=0)[:g])
        r += blocks
    out = {}
    for (name, op, vk, q), (op2, vi, mi) in zip(specs, items):
        cnt = cnts[mi]
        present = cnt > 0
        if op == "count":
            out[name] = (cnt.astype(np.int64), None)
            continue
        if op in ("sum", "mean"):
            s = out_mat[r:r + blocks].sum(axis=0)[:g]
            r += blocks
            out[name] = ((s, present) if op == "sum"
                         else (s / np.maximum(cnt, 1), present))
        elif op in _VAR_OPS:
            s2 = out_mat[r:r + blocks].sum(axis=0)[:g]
            r += blocks
            ddof = 1 if op.endswith("_samp") else 0
            var = np.maximum(s2, 0.0) / np.maximum(cnt - ddof, 1)
            ok = cnt > ddof
            out[name] = ((np.sqrt(var), ok) if op.startswith("stddev")
                         else (var, ok))
        else:  # min / max / first / last: one row
            vrow = out_mat[r][:g]
            r += 1
            out[name] = (np.where(present, vrow, 0.0), present)
    note = {"program": program, "shards": ns, "ring_form": ring_form,
            "blocks": blocks, "gb": gb, "rows": nb}
    return out, note


# ----------------------------------------------------------------------
# dispatch
# ----------------------------------------------------------------------

def grouped_reduce(specs: list, values: dict, gid: np.ndarray,
                   valid_map: dict, g: int, *, ts: np.ndarray | None = None,
                   prefer_device: bool | None = None, device=None,
                   mesh=None, mesh_opts=None) -> tuple[dict, str, dict]:
    """specs: list of (out_name, op, value_key|None, q|None). values: key
    -> per-row array. valid_map: key -> bool array (all-valid if missing).
    Returns ({out_name: (np array len g, valid|None)}, exec_path, note):
    exec_path is "device" or "host:<reason>", note names the device
    program (None on the host)."""
    n = len(gid)
    all_valid = np.ones(n, dtype=bool)
    use_device = prefer_device
    if use_device is None:
        use_device = n >= DEVICE_THRESHOLD
    path = "device"
    if not use_device:
        path = "host:small" if prefer_device is None else "host:config"
    elif not all(op in _DEVICE_OPS for _, op, _, _ in specs):
        path = "host:op"
    elif not all(vk is None or values[vk].dtype.kind in "iuf"
                 for _, _, vk, _ in specs):
        path = "host:dtype"
    if path == "device":
        from greptimedb_tpu_torch.query.planner import (
            decide_mesh_execution, record_mesh_decision,
        )

        use_mesh, kernel, decision = None, False, None
        if mesh is not None:
            decision = decide_mesh_execution(
                mesh, kind="aggregate", rows=n,
                ops=[op for _, op, _, _ in specs], opts=mesh_opts)
            record_mesh_decision(decision, "aggregate")
            if decision.shard:
                use_mesh = mesh
                kernel = decision.kernel == "ring"
        out, note = _device_reduce_fused(
            specs, values, gid, valid_map, g, ts, device=device,
            mesh=use_mesh, kernel=kernel)
        note["decision"] = None if decision is None else decision.label()
        return out, path, note
    out = {}
    for name, op, vk, q in specs:
        v = values[vk] if vk is not None else None
        mask = valid_map.get(vk) if vk else None
        if mask is None:
            mask = all_valid
        out[name] = _host_reduce(op, v, mask, gid, g, q, order_ts=ts)
    return out, path, None
