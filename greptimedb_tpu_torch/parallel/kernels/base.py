"""The ring harness of the cross-shard combines.

The JAX package runs the ring inside shard_map, where every shard
evaluates every hop and latches with jnp.where. Here the shards are a list
of per-shard values, so only the shard whose turn it is computes its
combine; the values it latches, and their order, are the same.
"""

from __future__ import annotations

import torch


def ring_form(devices, fused: bool | None = None) -> str:
    """"fused" (the whole ring in one launch) when every shard lies on one
    device and the caller did not ask for hops (fused=False), else "hops"
    (one combine launch per shard, each on that shard's device). A choice
    from the device list, never a fallback."""
    one = len({torch.device(d) for d in devices}) == 1
    return "fused" if one and fused is not False else "hops"


def ring_comm_bytes(ns: int, plane_bytes: int) -> int:
    """Estimated inter-card bytes of one sequential ring pass: the
    accumulator (plane_bytes) crosses 2(ns-1) neighbour hops — (ns-1) for
    the fold phase, (ns-1) for the broadcast."""
    return max(0, 2 * (int(ns) - 1)) * int(plane_bytes)


def sequential_ring(local: list, combine) -> list:
    """Sequential reduce-then-broadcast ring over the shards of `local`.

    local[0] seeds the accumulator. At hop s the accumulator moves to
    shard s (`.to(local[s].device)`: a no-op on one card, a peer copy
    across cards) and shard s latches combine(s, acc), its own
    contribution folded onto the prefix of shards 0..s-1. After ns-1 hops
    shard ns-1 holds the total; ns-1 more hops carry it to shards
    0..ns-2, each latching it as it passes by. The combine order is
    exactly shard 0..ns-1 — the left fold of the gather path — and the
    latches are assignments, never arithmetic. Returns the total on every
    shard's device, in shard order."""
    ns = len(local)
    acc = local[0]
    for s in range(1, ns):
        acc = combine(s, acc.to(local[s].device))
    out = [None] * ns
    out[ns - 1] = acc
    for t in range(ns - 1):
        acc = acc.to(local[t].device)
        out[t] = acc
    return out
