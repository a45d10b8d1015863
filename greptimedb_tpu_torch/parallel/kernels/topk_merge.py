"""Distributed topk: per-shard candidate planes merged around the ring.

The gather twin concatenates every shard's (J, kl) candidate planes in
shard order and reselects the top k. The ring keeps candidates where they
were selected: the accumulated top k walks the ring (2(ns - 1) hops of
(J, k) planes) and each shard merges its local candidates on top with the
merge kernel (csrc/topk_merge.cu, replacing the Pallas
greptimedb_tpu/parallel/kernels/topk_merge.py merge_candidates). Ties go
to the accumulator — the earlier shard, i.e. the lower concatenation
position — which is jax.lax.top_k's lower-index-wins rule over the
shard-order concatenation, so the winners (values, indices, presence)
match the gather twin exactly.

Planes are placed through the merge positions as int32 bit patterns,
never through float arithmetic (a one-hot float product would turn
-inf * 0 into NaN, and a float sum would turn -0.0 into +0.0).

`ring_topk_merge` takes the whole ring in one launch
(`ring_topk_merge_fused`, csrc/topk_merge.cu ring_topk_merge_kernel: the
same chain of merges, shard by shard) when every shard lies on one
device, and the hop ring (`ring_topk_merge_hops`: one `merge_candidates`
launch per shard after the first) otherwise — base.ring_form, the rule of
RingFoldCtx.form. Both launchers are bound once (build.entry).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from greptimedb_tpu_torch.parallel.kernels import build
from greptimedb_tpu_torch.parallel.kernels.base import (
    ring_comm_bytes,
    ring_form,
    sequential_ring,
)

_IDX_SENTINEL = 2**31 - 1
_MAX_THREADS = 1024
_TYPES = (torch.float32, torch.float32, torch.int32, torch.bool)
_PTR = ctypes.c_void_p
_INT = ctypes.c_int


class Candidates(NamedTuple):
    """Per-step candidate planes of one shard or of the accumulator, each
    (J, width): key float32 (descending), val float32, idx int32 (global
    series index), pres bool."""

    key: torch.Tensor
    val: torch.Tensor
    idx: torch.Tensor
    pres: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.key.device

    def to(self, device) -> "Candidates":
        return Candidates(*(p.to(device) for p in self))


def merge_candidates_plain(acc: Candidates, loc: Candidates) -> Candidates:
    """Plain PyTorch version of the merge: the same (J, kk, kl) rank
    comparisons and one-hot int32 sums as the Pallas body."""
    ak, bk = acc.key, loc.key
    kk, kl = ak.shape[1], bk.shape[1]
    dev = ak.device
    iota_a = torch.arange(kk, dtype=torch.int32, device=dev)
    iota_b = torch.arange(kl, dtype=torch.int32, device=dev)
    gt = bk[:, None, :] > ak[:, :, None]               # (J, kk, kl)
    pos_a = iota_a[None, :] + gt.sum(dim=2, dtype=torch.int32)
    ge = ak[:, :, None] >= bk[:, None, :]
    pos_b = iota_b[None, :] + ge.sum(dim=1, dtype=torch.int32)
    slots = torch.arange(kk, dtype=torch.int32, device=dev)
    hit_a = pos_a[:, :, None] == slots[None, None, :]  # (J, kk, kk)
    hit_b = pos_b[:, :, None] == slots[None, None, :]  # (J, kl, kk)

    def place(plane_a, plane_b):
        # int32 sums wrap as the Pallas body's do
        return (torch.where(hit_a, plane_a[:, :, None], 0)
                .sum(dim=1, dtype=torch.int32)
                + torch.where(hit_b, plane_b[:, :, None], 0)
                .sum(dim=1, dtype=torch.int32))

    bits = lambda x: x.view(torch.int32)  # noqa: E731
    return Candidates(
        place(bits(acc.key), bits(loc.key)).view(torch.float32),
        place(bits(acc.val), bits(loc.val)).view(torch.float32),
        place(acc.idx, loc.idx),
        place(acc.pres.to(torch.int32), loc.pres.to(torch.int32)) > 0,
    )


def _check(what: str, planes: Candidates) -> None:
    """One candidate set: the four plane types, one (J, width) shape, one
    device, contiguous."""
    key = planes.key
    if (key.dtype, planes.val.dtype, planes.idx.dtype,
            planes.pres.dtype) != _TYPES:
        raise TypeError(f"{what}: planes must be {_TYPES}, not "
                        f"{tuple(p.dtype for p in planes)}")
    shape, dev = key.shape, key.device
    for p in planes:
        if p.shape != shape or p.device != dev or not p.is_contiguous():
            raise ValueError(f"{what}: planes of shapes "
                             f"{[tuple(q.shape) for q in planes]} on "
                             f"{[str(q.device) for q in planes]} (one "
                             f"contiguous (J, width) shape on one device)")
    if key.dim() != 2:
        raise ValueError(f"{what}: planes of shape {tuple(shape)}, not "
                         f"(J, width)")


def _alloc(like: Candidates, j: int, kk: int) -> Candidates:
    """The output planes (J, kk) beside `like`'s. empty_like where the
    shape matches: on the card it costs less host time than torch.empty
    with a shape, a dtype and a device (merge_candidates' launch_path_ns
    in chip_smoke.py)."""
    if like.key.shape == (j, kk):
        return Candidates(*(torch.empty_like(p) for p in like))
    dev = like.key.device
    return Candidates(*(torch.empty((j, kk), dtype=t, device=dev)
                        for t in _TYPES))


def merge_candidates(acc: Candidates, loc: Candidates) -> Candidates:
    """One merge hop: acc (J, kk) and loc (J, kl) candidate planes, keys
    descending, -> the merged (J, kk) planes. Launches the kernel on a
    CUDA tensor, runs the plain version on a CPU one."""
    _check("merge_candidates: acc", acc)
    _check("merge_candidates: loc", loc)
    ka, kb = acc.key, loc.key
    if ka.device != kb.device:
        raise ValueError(f"merge_candidates: planes on {ka.device} and "
                         f"{kb.device}")
    j, kk = ka.shape
    kl = kb.shape[1]
    if kb.shape[0] != j:
        raise ValueError(f"merge_candidates: {j} and {kb.shape[0]} rows")
    if kk < 1:
        raise ValueError("merge_candidates: the accumulator is empty")
    if ka.is_cpu:
        return merge_candidates_plain(acc, loc)
    if kk + kl > _MAX_THREADS:
        raise ValueError(f"merge_candidates: kk + kl = {kk + kl} candidates "
                         f"past the kernel's {_MAX_THREADS} threads")
    out = _alloc(acc, j, kk)
    if j == 0:
        return out
    entry = build.entry("topk_merge", "gtt_merge_topk",
                        (_PTR,) * 12 + (_INT,) * 3)
    build.launch(entry, "merge_candidates", ka.get_device(),
                 *(p.data_ptr() for p in acc), *(p.data_ptr() for p in loc),
                 *(p.data_ptr() for p in out), j, kk, kl)
    merge_candidates.launches += 1
    return out


merge_candidates.launches = 0


def _pad_seed(seed: Candidates, k: int) -> Candidates:
    """The ring's seed: shard 0's (J, kl) planes padded to k slots with
    -inf keys, 0.0 values, index 2^31 - 1 and absent presence."""
    j, kl = seed.key.shape
    if kl >= k:
        return seed
    pad = k - kl

    def ext(x, fill):
        return torch.cat([x, torch.full((j, pad), fill, dtype=x.dtype,
                                        device=x.device)], dim=1)

    return Candidates(ext(seed.key, float("-inf")), ext(seed.val, 0.0),
                      ext(seed.idx, _IDX_SENTINEL), ext(seed.pres, False))


def ring_topk_merge_hops(local: list, k: int) -> list:
    """The hop ring: the padded seed walks the shards in order and each
    shard merges its candidates on top (one merge_candidates launch per
    shard after the first, each on that shard's device). Returns the
    winners on every shard's device, in shard order."""
    return sequential_ring([_pad_seed(local[0], k)] + list(local[1:]),
                           lambda s, acc: merge_candidates(acc, local[s]))


def ring_topk_merge_fused_plain(local: list, k: int) -> list:
    """Plain PyTorch version of the one-launch ring: merge_candidates_plain
    chained in shard order from the padded seed; the winners once for
    every shard."""
    acc = _pad_seed(local[0], k)
    for loc in local[1:]:
        acc = merge_candidates_plain(acc, loc)
    return [acc] * len(local)


def ring_topk_merge_fused(local: list, k: int) -> list:
    """The ring topk over per-shard (J, kl) candidate planes that lie on
    one device, in one launch (kl <= k, k + kl <= 1024 candidates, at most
    8 shards): bit-identical to ring_topk_merge_hops on any input. Returns
    the winners (J, k) as the same Candidates in every shard position. A
    CPU device runs the plain version."""
    if not local or len(local) > build.MAX_SHARDS:
        raise ValueError(f"ring_topk_merge_fused takes 1 to "
                         f"{build.MAX_SHARDS} shards, not {len(local)}")
    c0 = local[0]
    for c in local:
        _check("ring_topk_merge_fused", c)
        if c.key.shape != c0.key.shape or c.key.device != c0.key.device:
            raise ValueError(f"ring_topk_merge_fused: shards of "
                             f"{tuple(c0.key.shape)} on {c0.key.device} "
                             f"and {tuple(c.key.shape)} on {c.key.device}")
    j, kl = c0.key.shape
    if not 0 <= kl <= k or k + kl > _MAX_THREADS:
        raise ValueError(f"ring_topk_merge_fused: kl = {kl}, k = {k} (kl <= "
                         f"k and k + kl <= {_MAX_THREADS})")
    if c0.key.is_cpu:
        return ring_topk_merge_fused_plain(local, k)
    out = _alloc(c0, j, k)
    if j:
        planes = [build.SHARD_PTRS(*[c[i].data_ptr() for c in local])
                  for i in range(4)]
        entry = build.entry("topk_merge", "gtt_ring_topk_merge",
                            (_PTR,) * 8 + (_INT,) * 4)
        build.launch(entry, "ring_topk_merge_fused", c0.key.get_device(),
                     *planes, *(p.data_ptr() for p in out), len(local), j,
                     k, kl)
        ring_topk_merge_fused.launches += 1
    return [out] * len(local)


ring_topk_merge_fused.launches = 0


def ring_topk_merge(local: list, k: int) -> list:
    """Ring-merge per-shard candidate planes (J, kl each, shard order) into
    the global (J, k) winners, on every shard's device in shard order: in
    one launch when every shard lies on one device, else hop by hop. kl may be below k (fewer local series than k): the
    seed pads with -inf keys, 0.0 values, index 2^31 - 1 and absent
    presence, which only ever tie with other absent candidates and are
    dropped by the caller's isfinite(key) presence check. A failed fused
    launch raises."""
    if ring_form([c.device for c in local]) == "fused":
        return ring_topk_merge_fused(local, k)
    return ring_topk_merge_hops(local, k)


def topk_comm_bytes(ns: int, j: int, k: int) -> int:
    """Declared inter-card traffic of one topk ring: (J, k) key/val/idx
    f32+f32+int32 planes plus the bool presence plane, 2(ns - 1) hops."""
    return ring_comm_bytes(ns, (4 + 4 + 4 + 1) * int(j) * int(k))
