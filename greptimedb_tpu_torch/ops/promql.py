"""PromQL function semantics over grid windows (the JAX package's
ops/promql.py).

`eval_range_function` maps one shard's (vals, has, tsg) grids and the
query's windows onto (S, J) outputs with presence masks.
`aggregate_across_series_blocked` folds every shard's (S_local, J) outputs
into (G, J) groups with the JAX package's fixed blocked-combine structure
(the fast path's aggregations); `aggregate_across_series` is the unblocked
one of the binary, histogram and generic paths. `histogram_quantile` folds
(group, step, bucket) cumulative counts into quantiles.
"""

from __future__ import annotations

import torch

from greptimedb_tpu_torch.ops import window as W

RANGE_FUNCTIONS = frozenset({
    "rate", "increase", "delta", "idelta", "irate",
    "avg_over_time", "sum_over_time", "count_over_time", "min_over_time",
    "max_over_time", "last_over_time", "first_over_time",
    "present_over_time", "absent_over_time",
    "stddev_over_time", "stdvar_over_time", "quantile_over_time",
    "mad_over_time",
    "changes", "resets", "deriv", "predict_linear", "holt_winters",
})


def eval_range_function(name: str, vals, has, tsg, win, tps: float, *,
                        args: tuple = (), fused: bool = True,
                        x64: bool = False):
    """Evaluate one range function over all windows of `win` (lo, hi,
    t_end tensors on vals' device; range_ticks and l_cells ints). Returns
    (out, present) shaped (S, J). `args` carries the scalar parameters
    (quantile phi, the predict_linear horizon in seconds, holt_winters' sf
    and tf). `fused`: the call is part of one fused program whose scalars
    are constants (the fast path); else the generic engine's call, where
    the JAX package jits each window function alone with its scalars as
    arguments and runs the glue below as separate operations. `x64`: the
    JAX package's jax_enable_x64 mode, which the fused rate depends on
    (window.extrapolated_rate)."""
    lo, hi, t_end = win.lo, win.hi, win.t_end
    l_cells = win.l_cells
    if name in ("rate", "increase", "delta"):
        return W.extrapolated_rate(
            vals, has, tsg, lo, hi, t_end, win.range_ticks, tps,
            is_counter=name != "delta", is_rate=name == "rate", fused=fused,
            x64=x64,
        )
    if name == "idelta":
        return W.instant_delta(vals, has, tsg, lo, hi, tps, is_rate=False)
    if name == "irate":
        return W.instant_delta(vals, has, tsg, lo, hi, tps, is_rate=True)
    if name == "sum_over_time":
        return W.window_sum(vals, has, lo, hi)
    if name == "count_over_time":
        cnt = W.window_count(has, lo, hi)
        return cnt.to(vals.dtype), cnt > 0
    if name == "avg_over_time":
        return W.window_avg(vals, has, lo, hi)
    if name == "min_over_time":
        return W.window_minmax(vals, has, tsg, hi, l_cells, "min")
    if name == "max_over_time":
        return W.window_minmax(vals, has, tsg, hi, l_cells, "max")
    if name == "last_over_time":
        v, _, p = W.window_last(vals, has, tsg, lo, hi)
        return torch.where(p, v, 0.0), p
    if name == "first_over_time":
        v, _, p = W.window_first(vals, has, tsg, lo, hi)
        return torch.where(p, v, 0.0), p
    if name == "present_over_time":
        p = W.window_count(has, lo, hi) > 0
        return p.to(vals.dtype), p
    if name == "absent_over_time":
        absent = W.window_count(has, lo, hi) == 0
        return absent.to(vals.dtype), absent
    if name == "stddev_over_time":
        _, sd, p = W.window_stdvar(vals, has, tsg, hi, l_cells)
        return sd, p
    if name == "stdvar_over_time":
        var, _, p = W.window_stdvar(vals, has, tsg, hi, l_cells)
        return var, p
    if name == "quantile_over_time":
        (phi,) = args
        return W.window_quantile(vals, has, tsg, hi, l_cells, phi)
    if name == "mad_over_time":
        return W.window_mad(vals, has, tsg, hi, l_cells, fused=fused)
    if name == "changes":
        return W.window_pair_count(vals, has, lo, hi, count_changes=True)
    if name == "resets":
        return W.window_pair_count(vals, has, lo, hi, count_changes=False)
    if name in ("deriv", "predict_linear"):
        slope, intercept, n = W.window_linear_fit(
            vals, has, tsg, hi, t_end, l_cells, tps, fused=fused)
        p = n >= 2
        if name == "deriv":
            return torch.where(p, slope, 0.0), p
        (horizon_s,) = args
        h = torch.tensor(horizon_s, dtype=vals.dtype, device=vals.device)
        # one program contracts intercept + slope * horizon into an fma
        out = (W._fma_f32(slope, h.expand_as(slope), intercept) if fused
               else intercept + slope * h)
        return torch.where(p, out, 0.0), p
    if name == "holt_winters":
        sf, tf = args
        return W.window_holt_winters(vals, has, tsg, hi, l_cells, sf, tf)
    raise ValueError(f"unsupported range function: {name}")


# ----------------------------------------------------------------------
# histogram_quantile
# ----------------------------------------------------------------------

def _cummax_last(b: torch.Tensor) -> torch.Tensor:
    """lax.cummax over the last dim with XLA's bits: NaN propagates and
    -0.0 orders below +0.0 (torch.cummax takes the later of two equal
    zeros). The extreme is associative, so a sequential scan gives the
    bits of any XLA bracketing."""
    from greptimedb_tpu_torch.parallel.kernels.ring_fold import extreme_plain

    cols = [b[..., 0]]
    for i in range(1, b.shape[-1]):
        cols.append(extreme_plain(cols[-1], b[..., i], True))
    return torch.stack(cols, dim=-1)


def histogram_quantile(le: torch.Tensor, buckets: torch.Tensor,
                       mask: torch.Tensor, q):
    """Prometheus histogram_quantile over pre-grouped buckets.

    le:      (B,) ascending bucket upper bounds, last must be +inf
    buckets: (..., B) cumulative bucket values (one histogram per leading
             index; typically (G, J, B))
    mask:    (..., B) bucket presence
    q:       quantile in [0, 1]

    Prometheus bucketQuantile: monotonicity enforced by a running max;
    rank interpolated linearly within the located bucket (an fma, as
    XLA:CPU contracts lb + (ub - lb) * frac); the lowest bucket
    interpolates from 0 when its bound is positive."""
    dt = buckets.dtype
    dev = buckets.device
    q = torch.tensor(float(q), dtype=dt, device=dev)
    le = le.to(dt)
    b = _cummax_last(torch.where(mask, buckets, 0.0))
    total = b[..., -1]
    ok = mask.any(dim=-1) & (total > 0)
    rank = q * total
    # first bucket index with cum >= rank
    idx = (b < rank[..., None]).to(torch.int32).sum(dim=-1)
    nb = le.shape[0]
    idx = idx.clamp(0, nb - 1).to(torch.int64)
    in_inf = idx >= nb - 1
    idx_lo = (idx - 1).clamp(min=0)
    ub = le[idx]
    lb = torch.where(idx > 0, le[idx_lo], 0.0)
    # a non-positive lowest bound: no interpolation from zero
    lb = torch.where((idx == 0) & (le[0] <= 0), le[0], lb)
    cum_lo = torch.where(idx > 0, torch.gather(b, -1, idx_lo[..., None])[
        ..., 0], 0.0)
    cum_hi = torch.gather(b, -1, idx[..., None])[..., 0]
    width = cum_hi - cum_lo
    # XLA:CPU contracts q * total - cum_lo into an fma too
    frac = W._fma(q.expand_as(total), total, -cum_lo) / torch.where(
        width == 0, 1.0, width)
    out = W._fma(ub - lb, frac, lb)
    highest_finite = le[max(nb - 2, 0)]
    out = torch.where(in_inf, highest_finite, out)
    out = torch.where(q < 0, float("-inf"), out)
    out = torch.where(q > 1, float("inf"), out)
    return torch.where(ok, out, 0.0), ok


# ----------------------------------------------------------------------
# cross-series aggregation (sum/avg/min/max/... by (...) semantics)
# ----------------------------------------------------------------------

# at and above this global series count, linear group reductions run as
# one-hot matrix products per fold block; below it, as segment sums in
# K2's order. min/max are not linear and stay on the scatter path.
_MATMUL_MIN_SERIES = 4096
_MATMUL_MAX_ONEHOT_ELEMS = 1 << 28  # 1 GB f32 one-hot ceiling
_LINEAR_OPS = frozenset(
    {"sum", "avg", "count", "group", "stddev", "stdvar"})


def uses_matmul(op: str, num_groups: int, total_series: int) -> bool:
    """The JAX package's matmul-vs-scatter choice, on the GLOBAL padded
    series count so every sharding takes the same branch."""
    return (op in _LINEAR_OPS and total_series >= _MATMUL_MIN_SERIES
            and num_groups * total_series <= _MATMUL_MAX_ONEHOT_ELEMS)


def _group_matmul(x: torch.Tensor, onehot_t: torch.Tensor) -> torch.Tensor:
    """(G, S) @ (S, J) in full float32 (one-hot entries are exact in any
    precision; the data must not round through TF32)."""
    if x.is_cuda:
        assert torch.backends.cuda.matmul.allow_tf32 is False, \
            "the group matmul must run in full float32"
    return torch.matmul(onehot_t, x)


def segment_ext(x: torch.Tensor, gid: torch.Tensor, g: int,
                take_max: bool) -> torch.Tensor:
    """jax.ops.segment_max/min over dim 0 of an (S, J) float tensor into
    g segments (gid in [0, g)): empty segments hold -inf/+inf, NaN
    propagates, and -0.0 orders below +0.0 as in XLA. scatter_reduce
    compares -0.0 and +0.0 equal and keeps either, so a zero result takes
    its sign from whether the segment holds the winning zero (+0.0 for
    max, -0.0 for min); every other result is order-free."""
    idx = gid.to(torch.int64)[:, None].expand_as(x)
    reduce = "amax" if take_max else "amin"
    out = torch.full((g, x.shape[1]), float("-inf" if take_max else "inf"),
                     dtype=x.dtype, device=x.device)
    out.scatter_reduce_(0, idx, x, reduce=reduce, include_self=True)
    winner = (x == 0) & (torch.signbit(x) != take_max)
    has_winner = torch.zeros((g, x.shape[1]), dtype=torch.int32,
                             device=x.device)
    has_winner.scatter_reduce_(0, idx, winner.to(torch.int32), reduce="amax",
                               include_self=True)
    zero = 0.0 if take_max else -0.0
    other = -0.0 if take_max else 0.0
    return torch.where(out == 0, torch.where(has_winner > 0, zero, other),
                       out)


def aggregate_across_series_blocked(vals: list, present: list, gids: list,
                                    num_groups: int, op: str, *,
                                    total_series: int, ctx, fms=None):
    """Series aggregation with the JAX package's fixed blocked-combine
    structure, over per-shard lists (shard order) of (S_local, J) values,
    presence and group ids in [0, num_groups). The series axis splits into
    FOLD_BLOCKS aligned blocks; each shard holds FOLD_BLOCKS / shards of
    them, and the per-block partials are combined in one left fold in
    block order, so one device and every shard count perform the same
    additions in the same order.

    - matmul branch (`uses_matmul`): one full-f32 product per block.
    - scatter branch: per-block segment sums in ascending sid order — K2
      (ctx.fold_sum over `fms`, the per-shard FoldMembers of the gids with
      FOLD_BLOCKS / shards blocks each).
    - min/max: a segment extreme per shard, then ctx.pext.

    ctx is dist.LocalFoldCtx (one shard) or dist.ShardFoldCtx. Returns
    (values, present) of shape (G, J) on the first shard's device."""
    from greptimedb_tpu_torch.parallel.dist import (
        gather_blocks, left_fold_sum, replicate,
    )
    from greptimedb_tpu_torch.parallel.mesh import FOLD_BLOCKS

    dt = vals[0].dtype
    ns = len(vals)
    if FOLD_BLOCKS % ns:
        raise ValueError(f"{ns} shards do not divide {FOLD_BLOCKS} blocks")
    bl = FOLD_BLOCKS // ns
    s_loc = vals[0].shape[0]
    if s_loc % bl:
        raise ValueError(f"{s_loc} series per shard are not {bl} blocks")
    per = s_loc // bl
    matmul = uses_matmul(op, num_groups, total_series)

    def bsum(xs: list) -> list:
        """Blocked exact-structured group sum of per-shard (S_loc, J)
        matrices -> (G, J) on every shard's device."""
        if not matmul:
            return ctx.fold_sum([x.contiguous() for x in xs], fms)
        parts = []
        for x, gid in zip(xs, gids):
            grange = torch.arange(num_groups, dtype=torch.int32,
                                  device=x.device)[:, None]
            blocks = []
            for b in range(bl):
                sl = slice(b * per, (b + 1) * per)
                onehot_t = (gid[sl][None, :] == grange).to(dt)
                blocks.append(_group_matmul(x[sl], onehot_t))
            parts.append(torch.stack(blocks))          # (bl, G, J)
        return replicate(left_fold_sum(gather_blocks(parts)), xs)

    cnt = bsum([p.to(dt) for p in present])
    any_present = cnt[0] > 0
    if op in ("sum", "avg"):
        s = bsum([torch.where(p, v, 0.0) for v, p in zip(vals, present)])[0]
        if op == "avg":
            s = s / cnt[0].clamp(min=1)
        return torch.where(any_present, s, 0.0), any_present
    if op == "count":
        return cnt[0], any_present
    if op == "group":
        return any_present.to(dt), any_present
    if op in ("min", "max"):
        take_max = op == "max"
        fill = float("-inf" if take_max else "inf")
        m = ctx.pext([segment_ext(torch.where(p, v, fill), gid, num_groups,
                                  take_max)
                      for v, p, gid in zip(vals, present, gids)],
                     take_max=take_max)[0]
        return torch.where(any_present, m, 0.0), any_present
    if op in ("stddev", "stdvar"):
        s = bsum([torch.where(p, v, 0.0) for v, p in zip(vals, present)])
        means = [si / ci.clamp(min=1) for si, ci in zip(s, cnt)]
        devs = [torch.where(p, v - mean[gid.to(torch.int64)], 0.0)
                for v, p, gid, mean in zip(vals, present, gids, means)]
        var = bsum([d * d for d in devs])[0] / cnt[0].clamp(min=1)
        out = var if op == "stdvar" else W.sqrt_rn(var)
        return torch.where(any_present, out, 0.0), any_present
    raise ValueError(f"unsupported aggregation: {op}")


def group_members(gid: torch.Tensor, num_groups: int, live=None):
    """G's member order of the series of an (S,) gid, one row block: the
    series of each group in ascending order (aggregate_across_series'
    scatter branch). `live` (S,) bool leaves series out (a group of the
    caller's padding, whose sums it drops: its segment then sums to 0).
    Build once per grouping and device and pass it in."""
    from greptimedb_tpu_torch.parallel.kernels import grouped_reduce as gr

    if live is None:
        live = torch.ones_like(gid, dtype=torch.bool)
    return gr.group_members(gid.to(torch.int32), live, 1, num_groups)


def _segment_sum(x: torch.Tensor, members) -> torch.Tensor:
    """jax.ops.segment_sum over dim 0 of an (S, J) float32 or float64
    tensor with XLA:CPU's order: each group adds its rows in row order
    from 0. G's sum form, one launch per step column (float64: the generic
    engine's vectors); G raises on any other dtype."""
    from greptimedb_tpu_torch.parallel.kernels import grouped_reduce as gr

    return torch.stack([gr.grouped_block_reduce(x[:, j].contiguous(),
                                                members, "sum")[0]
                        for j in range(x.shape[1])], dim=1)


def aggregate_across_series(vals: torch.Tensor, present: torch.Tensor,
                            group_ids: torch.Tensor, num_groups: int,
                            op: str, *, members=None):
    """PromQL aggregation operators over the series axis of an (S, J)
    matrix (the JAX package's unblocked aggregate_across_series, which the
    binary, histogram and generic paths use). group_ids (S,) maps each
    series to its group in [0, num_groups). Returns (G, J) values and
    presence on vals' device.

    - matmul branch (`uses_matmul` at S): one full-precision product of
      the (G, S) one-hot and the values (the BLAS's add order: C2's
      2 gamma_n sum|x| bound against XLA's dot);
    - scatter branch: float sums in segment_sum's row order (`_segment_sum`
      over `members`, built from group_ids when not given); the int32
      counts by index_add_ (integer adds are exact in any order); min/max
      by segment_ext (order-free)."""
    dt = vals.dtype
    dev = vals.device
    gid = group_ids.to(torch.int64)
    if uses_matmul(op, num_groups, vals.shape[0]):
        onehot_t = (gid[None, :] == torch.arange(
            num_groups, device=dev)[:, None]).to(dt)
        cnt_f = _group_matmul(present.to(dt), onehot_t)
        any_present = cnt_f > 0
        masked = torch.where(present, vals, 0.0)
        if op in ("sum", "avg"):
            s = _group_matmul(masked, onehot_t)
            if op == "avg":
                s = s / cnt_f.clamp(min=1)
            return torch.where(any_present, s, 0.0), any_present
        if op == "count":
            return cnt_f, any_present
        if op == "group":
            return any_present.to(dt), any_present
        # stddev / stdvar: two passes, as the scatter branch
        n = cnt_f.clamp(min=1)
        mean = _group_matmul(masked, onehot_t) / n
        dev_ = torch.where(present, vals - mean[gid], 0.0)
        var = _group_matmul(dev_ * dev_, onehot_t) / n
        out = var if op == "stdvar" else W.sqrt_rn(var)
        return torch.where(any_present, out, 0.0), any_present

    cnt = torch.zeros((num_groups, vals.shape[1]), dtype=torch.int32,
                      device=dev)
    cnt.index_add_(0, gid, present.to(torch.int32))
    any_present = cnt > 0
    if op in ("min", "max"):
        take_max = op == "max"
        fill = float("-inf" if take_max else "inf")
        m = segment_ext(torch.where(present, vals, fill), gid, num_groups,
                        take_max)
        return torch.where(any_present, m, 0.0), any_present
    if op == "count":
        return cnt.to(dt), any_present
    if op == "group":
        return any_present.to(dt), any_present
    if op not in ("sum", "avg", "stddev", "stdvar"):
        raise ValueError(f"unsupported aggregation: {op}")
    if members is None:
        members = group_members(group_ids, num_groups)
    s = _segment_sum(torch.where(present, vals, 0.0), members)
    if op in ("sum", "avg"):
        if op == "avg":
            s = s / cnt.clamp(min=1).to(dt)
        return torch.where(any_present, s, 0.0), any_present
    n = cnt.clamp(min=1).to(dt)
    mean = s / n
    dev_ = torch.where(present, vals - mean[gid], 0.0)
    var = _segment_sum(dev_ * dev_, members) / n
    out = var if op == "stdvar" else W.sqrt_rn(var)
    return torch.where(any_present, out, 0.0), any_present
