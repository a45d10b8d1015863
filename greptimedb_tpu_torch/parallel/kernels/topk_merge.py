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
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from greptimedb_tpu_torch.parallel.kernels.base import (
    ring_comm_bytes,
    sequential_ring,
)

_IDX_SENTINEL = 2**31 - 1
_MAX_THREADS = 1024


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


def _check(acc: Candidates, loc: Candidates) -> None:
    types = (torch.float32, torch.float32, torch.int32, torch.bool)
    for name, planes in (("acc", acc), ("loc", loc)):
        for p, t in zip(planes, types):
            if p.dtype != t:
                got = tuple(q.dtype for q in planes)
                raise TypeError(f"merge_candidates: {name} planes must be "
                                f"{types}, not {got}")
            if p.dim() != 2 or p.shape != planes.key.shape:
                raise ValueError(f"merge_candidates: {name} planes of "
                                 f"shapes {[tuple(q.shape) for q in planes]}")
            if p.device != acc.key.device:
                raise ValueError("merge_candidates: planes on "
                                 f"{p.device} and {acc.key.device}")
            if not p.is_contiguous():
                raise ValueError("merge_candidates takes contiguous planes")
    if acc.key.shape[0] != loc.key.shape[0]:
        raise ValueError(f"merge_candidates: {acc.key.shape[0]} and "
                         f"{loc.key.shape[0]} rows")
    if acc.key.shape[1] < 1:
        raise ValueError("merge_candidates: the accumulator is empty")


def merge_candidates(acc: Candidates, loc: Candidates) -> Candidates:
    """One merge hop: acc (J, kk) and loc (J, kl) candidate planes, keys
    descending, -> the merged (J, kk) planes. Launches the kernel on a
    CUDA tensor, runs the plain version on a CPU one."""
    _check(acc, loc)
    if acc.device.type == "cpu":
        return merge_candidates_plain(acc, loc)
    j, kk = acc.key.shape
    kl = loc.key.shape[1]
    if kk + kl > _MAX_THREADS:
        raise ValueError(f"merge_candidates: kk + kl = {kk + kl} candidates "
                         f"past the kernel's {_MAX_THREADS} threads")
    out = Candidates(torch.empty_like(acc.key), torch.empty_like(acc.val),
                     torch.empty_like(acc.idx), torch.empty_like(acc.pres))
    if j == 0:
        return out
    from greptimedb_tpu_torch.parallel.kernels import build

    lib = build.load("topk_merge")
    fn = lib.gtt_merge_topk
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        rc = fn(*(p.data_ptr() for p in acc), *(p.data_ptr() for p in loc),
                *(p.data_ptr() for p in out), j, kk, kl, stream)
    build.check_launch(lib, rc, "merge_candidates")
    merge_candidates.launches += 1
    return out


merge_candidates.launches = 0


def ring_topk_merge(local: list, k: int) -> list:
    """Ring-merge per-shard candidate planes (J, kl each, shard order) into
    the global (J, k) winners, on every shard's device in shard order.
    kl may be below k (fewer local series than k): the seed pads with -inf
    keys, 0.0 values, index 2^31 - 1 and absent presence, which only ever
    tie with other absent candidates and are dropped by the caller's
    isfinite(key) presence check."""
    seed = local[0]
    j, kl = seed.key.shape
    if kl < k:
        pad = k - kl

        def ext(x, fill):
            return torch.cat([x, torch.full((j, pad), fill, dtype=x.dtype,
                                            device=x.device)], dim=1)

        seed = Candidates(ext(seed.key, float("-inf")), ext(seed.val, 0.0),
                          ext(seed.idx, _IDX_SENTINEL), ext(seed.pres, False))
    return sequential_ring([seed] + list(local[1:]),
                           lambda s, acc: merge_candidates(acc, local[s]))


def topk_comm_bytes(ns: int, j: int, k: int) -> int:
    """Declared inter-card traffic of one topk ring: (J, k) key/val/idx
    f32+f32+int32 planes plus the bool presence plane, 2(ns - 1) hops."""
    return ring_comm_bytes(ns, (4 + 4 + 4 + 1) * int(j) * int(k))
