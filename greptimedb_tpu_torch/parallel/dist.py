"""Fold hooks of the blocked exact group fold, over per-shard values.

Shards are list positions: a hook takes the list of per-shard values in
shard order and returns the combined value on every shard's device, in
shard order. The fold hooks are the only points where shards meet.

- LocalFoldCtx: one shard; K2 folds the group sums in one launch and the
  extreme/sum hooks are the identity.
- ShardFoldCtx: the gather twin the JAX package runs with kernels off —
  every shard's (fb_local, g, nb) block partials are concatenated in shard
  order and left-folded; extremes and one-hot sums fold in shard order.
- parallel/kernels/ring_fold.RingFoldCtx: the ring with the hand kernels.

All three add the same per-block partials in the same order, so their
results are bit-identical.
"""

from __future__ import annotations

import torch


def left_fold_sum(parts: torch.Tensor) -> torch.Tensor:
    """Sum over axis 0 as an explicit left fold starting from parts[0]
    (never 0 + parts[0]: that maps -0.0 to +0.0). The add chain is the
    contract shared with the JAX package's left_fold_sum."""
    total = parts[0]
    for i in range(1, parts.shape[0]):
        total = total + parts[i]
    return total


def gather_blocks(parts: list, dim: int = 0) -> torch.Tensor:
    """Concatenate per-shard tensors along `dim` in shard order, on the
    first shard's device. Pure data movement — exact."""
    dev = parts[0].device
    return torch.cat([p.to(dev) for p in parts], dim=dim)


def halo_prev_1d(parts: list, halo: int, fill=0.0) -> list:
    """Each shard of a 1-D row-sharded array with the last `halo` cells of
    the PREVIOUS shard prepended (the first shard gets `fill`), on the
    shard's device. The sliding-window primitive for frames crossing
    shard boundaries (query/window_fns.py ROWS k PRECEDING); on one card
    it is a copy of the previous shard's tail. Every shard holds at least
    `halo` cells."""
    out = []
    for s, x in enumerate(parts):
        if s == 0:
            tail = torch.full((halo,), fill, dtype=x.dtype, device=x.device)
        else:
            prev = parts[s - 1]
            tail = prev[prev.numel() - halo:].to(x.device)
        out.append(torch.cat([tail, x]))
    return out


def replicate(x: torch.Tensor, like: list) -> list:
    """`x` on the device of every shard of `like`, in shard order."""
    return [x.to(t.device) for t in like]


class LocalFoldCtx:
    """Single-shard hooks: K2 is the whole fold, the rest is identity."""

    shards = 1

    def fold_sum(self, arrs: list, fms: list) -> list:
        """Per-group sums of (S, nb) per-series states in the blocked
        fold order (K2, one launch)."""
        from greptimedb_tpu_torch.parallel.kernels import ring_fold

        return [ring_fold.blocked_fold_sum(arrs[0], fms[0])]

    def pext(self, xs: list, take_max: bool) -> list:
        return xs

    def psum(self, xs: list) -> list:
        return xs


class ShardFoldCtx(LocalFoldCtx):
    """Gather-and-left-fold hooks over `shards` shards (kernels off)."""

    def __init__(self, shards: int):
        self.shards = shards

    def fold_sum(self, arrs: list, fms: list) -> list:
        from greptimedb_tpu_torch.parallel.kernels import ring_fold

        parts = [ring_fold.block_partials(a, fm) for a, fm in zip(arrs, fms)]
        return replicate(left_fold_sum(gather_blocks(parts)), arrs)

    def pext(self, xs: list, take_max: bool) -> list:
        from greptimedb_tpu_torch.parallel.kernels import ring_fold

        acc = xs[0]
        for x in xs[1:]:
            acc = ring_fold.extreme_plain(acc, x.to(acc.device), take_max)
        return replicate(acc, xs)

    def psum(self, xs: list) -> list:
        """Sum in shard order; exact for the masked one-nonzero payloads
        the range fold hands it (ring_fold.ring_psum_onehot)."""
        acc = xs[0]
        for x in xs[1:]:
            acc = acc + x.to(acc.device)
        return replicate(acc, xs)
