"""PromQL function semantics over grid windows (the JAX package's
ops/promql.py, for the range functions and aggregations the fast path
ports).

`eval_range_function` maps one shard's (vals, has, tsg) grids and the
query's windows onto (S, J) outputs with presence masks.
`aggregate_across_series_blocked` folds every shard's (S_local, J) outputs
into (G, J) groups with the JAX package's fixed blocked-combine structure.
"""

from __future__ import annotations

import torch

from greptimedb_tpu_torch.errors import UnsupportedError
from greptimedb_tpu_torch.ops import window as W

# the range functions this slice evaluates; the quantile, linear-fit and
# Holt-Winters families (quantile/mad_over_time, deriv, predict_linear,
# holt_winters) are not ported yet
RANGE_FUNCTIONS = frozenset({
    "rate", "increase", "delta", "idelta", "irate",
    "sum_over_time", "count_over_time", "avg_over_time",
    "last_over_time", "first_over_time", "present_over_time",
    "changes", "resets",
    "min_over_time", "max_over_time", "stddev_over_time",
    "stdvar_over_time",
})


def eval_range_function(name: str, vals, has, tsg, win, tps: float):
    """Evaluate one range function over all windows of `win` (lo, hi,
    t_end tensors on vals' device; range_ticks and l_cells ints). Returns
    (out, present) shaped (S, J)."""
    lo, hi, t_end = win.lo, win.hi, win.t_end
    l_cells = win.l_cells
    if name in ("rate", "increase", "delta"):
        return W.extrapolated_rate(
            vals, has, tsg, lo, hi, t_end, win.range_ticks, tps,
            is_counter=name != "delta", is_rate=name == "rate",
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
    if name == "stddev_over_time":
        _, sd, p = W.window_stdvar(vals, has, tsg, hi, l_cells)
        return sd, p
    if name == "stdvar_over_time":
        var, _, p = W.window_stdvar(vals, has, tsg, hi, l_cells)
        return var, p
    if name == "changes":
        return W.window_pair_count(vals, has, lo, hi, count_changes=True)
    if name == "resets":
        return W.window_pair_count(vals, has, lo, hi, count_changes=False)
    raise UnsupportedError(f"range function {name} is not ported yet")


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
        out = var if op == "stdvar" else W.sqrt_f32(var)
        return torch.where(any_present, out, 0.0), any_present
    raise UnsupportedError(f"aggregation {op} is not ported yet")
