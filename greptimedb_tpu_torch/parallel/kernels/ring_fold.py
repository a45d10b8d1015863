"""The blocked group fold (K2) and the ring combines across shards.

K2 folds per-series cell states (S, nb) into per-group states (g, nb) in
the fixed order that carries the JAX package's bit-identity contract:

1. per series block b (S / fb consecutive sids), a segment sum over the
   block's members of each group, starting from 0 and adding members in
   ascending sid order (jax.ops.segment_sum's order as XLA's scatter runs
   it);
2. a left fold of the fb block partials, starting FROM block 0's partial
   (parallel/dist.left_fold_sum, the body of the Pallas _fold_seed_kernel)
   — or, continuing a ring, from the accumulator that arrived
   (`fold_cont`, the body of _fold_cont_kernel).

On CUDA, index_add_/scatter_add_ add floats with atomics in no fixed
order, so the fold needs its own kernels even on one card: the seed in
csrc/ring_fold.cu (two forms, picked by `blocked_fold_form` from the
shape: a thread per (group, cell) where the groups fill the card, a block
per (series block, group, cell chunk) staging its member rows where few
groups have long lists), the continuation (`fold_cont`) and the partials
(`block_partials`) as forms of the fused ring's pipelined member walk in
csrc/ring_fold_fused.cu. The plain versions below keep the same order:
they step through member ranks, adding the k-th member of every (block,
group) at step k.

The hop ring's entry points (`ring_fold_blocks`, `ring_pext`,
`ring_psum_onehot`) run over per-shard lists through
parallel/kernels/base.sequential_ring; every combine of a hop is one of
this module's kernels (`fold_cont`, `extreme`, `onehot_add`).

The one-ring forms do a whole ring in ONE launch for shards on one
device: `ring_fold_fused` (csrc/ring_fold_fused.cu, the Pallas
_tpu_ring_fold_call: every shard's block partials through a pipelined
member walk, then one left fold of all of them by the last block to
arrive at each tile), and `ring_pext_fused` / `ring_psum_onehot_fused`
(csrc/ring_fold.cu: the hop ring's chain of extremes or adds, in shard
order, per element).
`RingFoldCtx` takes them when every shard lies on one device, and the hop
ring otherwise (or when asked with fused=False).

Every launcher is bound once (`build.entry`: library, symbol, argtypes)
and called on the caller's current stream of the tensors' card
(`build.launch`).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from greptimedb_tpu_torch.parallel.dist import ShardFoldCtx, left_fold_sum
from greptimedb_tpu_torch.parallel.kernels import build
from greptimedb_tpu_torch.parallel.kernels.base import (
    ring_comm_bytes,
    ring_form,
    sequential_ring,
)


@dataclass
class FoldMembers:
    """Group membership of one query, built once with the gid upload.

    member/ptr: CSR over (block, group) — member[ptr[b*g + grp]:
    ptr[b*g + grp + 1]] are the sids of group grp in series block b,
    ascending; sids with gid >= g are not listed. step_slot/step_sid/
    step_ptr regroup the same pairs by rank within their (block, group)
    for the plain version."""

    g: int
    fb: int
    s: int
    member: torch.Tensor     # (m,) int32
    ptr: torch.Tensor        # (fb * g + 1,) int32
    step_slot: torch.Tensor  # (m,) int64, (block * g + group), rank-major
    step_sid: torch.Tensor   # (m,) int64
    step_ptr: list           # rank k's pairs: [step_ptr[k], step_ptr[k+1])


def fold_members(gid: np.ndarray, g: int, fb: int, device) -> FoldMembers:
    """Build the fold's member lists from per-sid group ids (host numpy,
    (S,) with inactive sids routed to g or beyond)."""
    gid = np.asarray(gid, np.int64)
    s = len(gid)
    if fb < 1 or s % fb:
        raise ValueError(f"series axis {s} is not a multiple of {fb} blocks")
    per = s // fb
    sids = np.nonzero(gid < g)[0]
    key = (sids // per) * g + gid[sids]
    order = np.argsort(key, kind="stable")   # stable: sids stay ascending
    member = sids[order]
    key_sorted = key[order]
    counts = np.bincount(key_sorted, minlength=fb * g)
    ptr = np.zeros(fb * g + 1, np.int64)
    np.cumsum(counts, out=ptr[1:])
    rank = np.arange(len(member)) - ptr[key_sorted]
    by_rank = np.argsort(rank, kind="stable")
    max_len = int(counts.max()) if len(counts) else 0
    step_counts = np.bincount(rank, minlength=max_len)
    step_ptr = np.zeros(max_len + 1, np.int64)
    np.cumsum(step_counts, out=step_ptr[1:])
    dev = torch.device(device)
    return FoldMembers(
        g=g, fb=fb, s=s,
        member=torch.from_numpy(member.astype(np.int32)).to(dev),
        ptr=torch.from_numpy(ptr.astype(np.int32)).to(dev),
        step_slot=torch.from_numpy(key_sorted[by_rank]).to(dev),
        step_sid=torch.from_numpy(member[by_rank]).to(dev),
        step_ptr=step_ptr.tolist(),
    )


# ----------------------------------------------------------------------
# plain versions (the CPU path, and the card's reference)
# ----------------------------------------------------------------------

def block_partials_plain(arr: torch.Tensor, fm: FoldMembers) -> torch.Tensor:
    """(fb, g, nb) block partials in the kernel's order: every partial
    starts at 0 and its k-th member (ascending sid) is added at step k.
    Within one step the (block, group) slots are distinct, so the indexed
    update is deterministic on every device."""
    nb = arr.shape[1]
    parts = torch.zeros((fm.fb * fm.g, nb), dtype=arr.dtype,
                        device=arr.device)
    for k in range(len(fm.step_ptr) - 1):
        a, b = fm.step_ptr[k], fm.step_ptr[k + 1]
        slots = fm.step_slot[a:b]
        parts[slots] = parts[slots] + arr[fm.step_sid[a:b]]
    return parts.reshape(fm.fb, fm.g, nb)


def fold_from(acc: torch.Tensor, parts: torch.Tensor) -> torch.Tensor:
    """acc + parts[0] + ... + parts[-1], left to right: the body of the
    Pallas _fold_cont_kernel."""
    for i in range(parts.shape[0]):
        acc = acc + parts[i]
    return acc


def blocked_fold_sum_plain(arr: torch.Tensor, fm: FoldMembers) -> torch.Tensor:
    """Plain PyTorch version of K2."""
    return left_fold_sum(block_partials_plain(arr, fm))


def fold_cont_plain(acc: torch.Tensor, arr: torch.Tensor,
                    fm: FoldMembers) -> torch.Tensor:
    """Plain PyTorch version of K2's continuation."""
    return fold_from(acc, block_partials_plain(arr, fm))


def extreme_plain(acc: torch.Tensor, x: torch.Tensor,
                  take_max: bool) -> torch.Tensor:
    """jnp.maximum(acc, x) / jnp.minimum(acc, x) with XLA:CPU's bits.

    Integers: the plain extreme. Floats: NaN propagates and -0.0 orders
    below +0.0, as in jnp; which operand's bits come out follows LLVM's x86
    lowering of llvm.maximum/minimum, which XLA:CPU emits — order the pair
    by the sign bit of acc, compare, and a NaN first operand wins. Every
    step is a selection, so NaN payloads pass through unchanged."""
    if not acc.dtype.is_floating_point:
        return torch.maximum(acc, x) if take_max else torch.minimum(acc, x)
    neg = torch.signbit(acc)
    if take_max:
        p, q = torch.where(neg, acc, x), torch.where(neg, x, acc)
        take_p = p > q
    else:
        p, q = torch.where(neg, x, acc), torch.where(neg, acc, x)
        take_p = p < q
    return torch.where(torch.isnan(p) | take_p, p, q)


def onehot_add_plain(acc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the one-hot add."""
    return acc + x


# ----------------------------------------------------------------------
# kernel wrappers: launch on a CUDA tensor, plain version on a CPU one
# ----------------------------------------------------------------------

_FOLD_TYPES = {torch.float32: "f32", torch.int32: "i32"}
_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_LL = ctypes.c_longlong


_MAX_FB = 8
_FUSED_CELLS = 256       # cells per tile of every walk form (ring_fold_fused.cu)


def _check_fold(what: str, arr: torch.Tensor, fm: FoldMembers) -> None:
    if arr.dtype not in _FOLD_TYPES:
        raise TypeError(f"{what} takes float32 or int32, not {arr.dtype}")
    if arr.dim() != 2 or arr.shape[0] != fm.s:
        raise ValueError(f"arr shape {tuple(arr.shape)} does not match "
                         f"{fm.s} series")
    if arr.device != fm.member.device:
        raise ValueError(f"arr on {arr.device}, members on "
                         f"{fm.member.device}")
    if not arr.is_contiguous():
        raise ValueError("arr must be contiguous")


def _check_pair(what: str, acc: torch.Tensor, x: torch.Tensor,
                dtypes) -> None:
    if acc.dtype not in dtypes or x.dtype != acc.dtype:
        raise TypeError(f"{what} takes two tensors of one of {dtypes}, not "
                        f"{acc.dtype} and {x.dtype}")
    if acc.shape != x.shape:
        raise ValueError(f"{what}: shapes {tuple(acc.shape)} and "
                         f"{tuple(x.shape)} differ")
    if acc.device != x.device:
        raise ValueError(f"{what}: tensors on {acc.device} and {x.device}")
    if not (acc.is_contiguous() and x.is_contiguous()):
        raise ValueError(f"{what} takes contiguous tensors")


def _fold_launch(source: str, kind: str, arr, fm, out) -> None:
    entry = build.entry(source, f"gtt_{kind}_{_FOLD_TYPES[arr.dtype]}",
                        (_PTR,) * 4 + (_INT,) * 3)
    build.launch(entry, kind, arr.get_device(), arr.data_ptr(),
                 fm.member.data_ptr(), fm.ptr.data_ptr(), out.data_ptr(),
                 fm.g, fm.fb, arr.shape[1])


# K2's forms (csrc/ring_fold.cu kPerCell, kStaged) and the shape rule
# between them: one thread per (group, cell) where g * nb fills the card
# and each thread's walk (its group's members, m / g) is short; one block
# per (series block, group, 256-cell chunk) staging its list otherwise
_K2_FORMS = {"cells": 0, "staged": 1}
_K2_FILL_CELLS = 16384
_K2_CELL_ROWS = 1024


def blocked_fold_form(g: int, nb: int, members: int) -> str:
    """The form K2 launches for g groups of nb cells over `members`
    listed sids: "cells" or "staged"."""
    if g * nb >= _K2_FILL_CELLS and members <= _K2_CELL_ROWS * g:
        return "cells"
    return "staged"


def blocked_fold_sum(arr: torch.Tensor, fm: FoldMembers) -> torch.Tensor:
    """(S, nb) float32/int32 per-series states -> (g, nb) per-group sums,
    segment-summed per series block and left-folded over the blocks from
    block 0 (K2; the ring's seed on shard 0), in one launch of the form
    `blocked_fold_form` picks. The staged form with fb > 1 keeps its block
    partials and arrival counts in the per-(device, stream) scratch."""
    _check_fold("blocked_fold_sum", arr, fm)
    if arr.is_cpu:
        return blocked_fold_sum_plain(arr, fm)
    g, fb, nb = fm.g, fm.fb, arr.shape[1]
    out = torch.empty((g, nb), dtype=arr.dtype, device=arr.device)
    if out.numel() == 0:
        return out
    form = blocked_fold_form(g, nb, fm.member.numel())
    index = arr.get_device()
    lib, fn = build.entry("ring_fold",
                          f"gtt_blocked_fold_sum_{_FOLD_TYPES[arr.dtype]}",
                          (_PTR,) * 6 + (_INT,) * 4)
    args = (arr.data_ptr(), fm.member.data_ptr(), fm.ptr.data_ptr(),
            out.data_ptr())
    if form == "staged" and fb > 1:
        with build.scratch_lock:
            stream = build.stream(index)
            part, count = build.stream_scratch(arr.device, stream).take(
                4 * fb * g * nb, g * -(-nb // _FUSED_CELLS))
            rc = build.on_card(index, fn, *args, part, count, g, fb, nb,
                               _K2_FORMS[form], stream)
    else:
        rc = build.on_card(index, fn, *args, None, None, g, fb, nb,
                           _K2_FORMS[form], build.stream(index))
    if rc:
        build.check_launch(lib, rc, "blocked_fold_sum")
    blocked_fold_sum.launches += 1
    return out


def fold_cont(acc: torch.Tensor, arr: torch.Tensor,
              fm: FoldMembers) -> torch.Tensor:
    """acc (g, nb) + this shard's block partials of arr, in block order
    (K2's continuation: every ring shard after the first), through the
    pipelined member walk (csrc/ring_fold_fused.cu, form kCont): each
    block partial goes to the per-(device, stream) scratch and the last
    block of a tile folds them onto acc."""
    _check_fold("fold_cont", arr, fm)
    if acc.dtype != arr.dtype:
        raise TypeError(f"fold_cont: acc is {acc.dtype}, arr {arr.dtype}")
    if (tuple(acc.shape) != (fm.g, arr.shape[1])
            or acc.device != arr.device or not acc.is_contiguous()):
        raise ValueError(f"fold_cont: acc {tuple(acc.shape)} on "
                         f"{acc.device} is not a contiguous ({fm.g}, "
                         f"{arr.shape[1]}) tensor beside arr")
    if arr.is_cpu:
        return fold_cont_plain(acc, arr, fm)
    out = torch.empty_like(acc)
    if out.numel() == 0:
        return out
    g, fb, nb = fm.g, fm.fb, arr.shape[1]
    index = arr.get_device()
    lib, fn = build.entry("ring_fold_fused",
                          f"gtt_fold_cont_{_FOLD_TYPES[arr.dtype]}",
                          (_PTR,) * 7 + (_INT,) * 3)
    with build.scratch_lock:
        stream = build.stream(index)
        part, count = build.stream_scratch(arr.device, stream).take(
            4 * fb * g * nb, g * -(-nb // _FUSED_CELLS))
        rc = build.on_card(index, fn, arr.data_ptr(), fm.member.data_ptr(),
                           fm.ptr.data_ptr(), acc.data_ptr(), out.data_ptr(),
                           part, count, g, fb, nb, stream)
    if rc:
        build.check_launch(lib, rc, "fold_cont")
    fold_cont.launches += 1
    return out


def block_partials(arr: torch.Tensor, fm: FoldMembers) -> torch.Tensor:
    """(S, nb) per-series states -> the (fb, g, nb) unfolded block
    partials (K2's partials form; the gather twin folds them), through the
    pipelined member walk (csrc/ring_fold_fused.cu, form kPartials)."""
    _check_fold("block_partials", arr, fm)
    if arr.is_cpu:
        return block_partials_plain(arr, fm)
    out = torch.empty((fm.fb, fm.g, arr.shape[1]), dtype=arr.dtype,
                      device=arr.device)
    if out.numel() == 0:
        return out
    _fold_launch("ring_fold_fused", "block_partials", arr, fm, out)
    block_partials.launches += 1
    return out


def extreme(acc: torch.Tensor, x: torch.Tensor,
            take_max: bool) -> torch.Tensor:
    """Elementwise max/min of two float32 or int32 tensors with
    jnp.maximum/minimum's bits (see extreme_plain)."""
    _check_pair("extreme", acc, x, _FOLD_TYPES)
    if acc.is_cpu:
        return extreme_plain(acc, x, take_max)
    out = torch.empty_like(acc)
    if out.numel() == 0:
        return out
    entry = build.entry("ring_fold",
                        f"gtt_extreme_{_FOLD_TYPES[acc.dtype]}",
                        (_PTR, _PTR, _PTR, _LL, _INT))
    build.launch(entry, "extreme", acc.get_device(), acc.data_ptr(),
                 x.data_ptr(), out.data_ptr(), acc.numel(), int(take_max))
    extreme.launches += 1
    return out


def onehot_add(acc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """acc + x over float32 tensors (the one-hot sum's hop)."""
    _check_pair("onehot_add", acc, x, (torch.float32,))
    if acc.is_cpu:
        return onehot_add_plain(acc, x)
    out = torch.empty_like(acc)
    if out.numel() == 0:
        return out
    entry = build.entry("ring_fold", "gtt_onehot_add_f32",
                        (_PTR, _PTR, _PTR, _LL))
    build.launch(entry, "onehot_add", acc.get_device(), acc.data_ptr(),
                 x.data_ptr(), out.data_ptr(), acc.numel())
    onehot_add.launches += 1
    return out


def noop(device) -> None:
    """Launch the empty kernel on the current stream of `device` through
    the same bound launch path as the kernels above: the floor under every
    launch of this module (a measurement hook; counted nowhere)."""
    dev = torch.device(device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    build.launch(build.entry("ring_fold", "gtt_noop", ()), "noop", index)


def add_chain(device, n: int) -> torch.Tensor:
    """One thread on `device` adds 1.0 to 0.0 n times, each add waiting on
    the one before, as in K2's chains: the card's dependent-add latency,
    which K2's chain bound counts in (a measurement hook; counted
    nowhere). Returns the (1,) float32 sum: n, for n <= 2^24."""
    dev = torch.device(device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    out = torch.empty(1, dtype=torch.float32, device=dev)
    build.launch(build.entry("ring_fold", "gtt_add_chain", (_PTR, _INT)),
                 "add_chain", index, out.data_ptr(), n)
    return out


for _fn in (blocked_fold_sum, fold_cont, block_partials, extreme,
            onehot_add):
    _fn.launches = 0


# ----------------------------------------------------------------------
# the ring extreme and the ring one-hot sum in one launch (rows 4 and 5)
# ----------------------------------------------------------------------

def ring_pext_fused_plain(xs: list, take_max: bool) -> list:
    """Plain PyTorch version of the one-launch ring extreme: the hop
    ring's chain extreme(... extreme(xs[0], xs[1]) ..., xs[ns - 1]) in
    shard order, the total once for every shard."""
    acc = xs[0]
    for x in xs[1:]:
        acc = extreme_plain(acc, x, take_max)
    return [acc] * len(xs)


def ring_psum_onehot_fused_plain(xs: list) -> list:
    """Plain PyTorch version of the one-launch ring one-hot sum: xs[0] +
    xs[1] + ... in shard order, from shard 0's value (a -0.0 winner
    comes out +0.0, as in the hop ring and in psum)."""
    acc = xs[0]
    for x in xs[1:]:
        acc = onehot_add_plain(acc, x)
    return [acc] * len(xs)


def _check_ring(what: str, xs: list, dtypes) -> None:
    if not xs:
        raise ValueError(f"{what}: no shards")
    if len(xs) > build.MAX_SHARDS:
        raise ValueError(f"{what} takes at most {build.MAX_SHARDS} shards, "
                         f"not {len(xs)}")
    x0 = xs[0]
    if x0.dtype not in dtypes:
        raise TypeError(f"{what} takes one of {dtypes}, not {x0.dtype}")
    for x in xs:
        if x.dtype != x0.dtype:
            raise TypeError(f"{what}: shards of {x0.dtype} and {x.dtype}")
        if x.shape != x0.shape:
            raise ValueError(f"{what}: shapes {tuple(x0.shape)} and "
                             f"{tuple(x.shape)} differ")
        if x.device != x0.device:
            raise ValueError(f"{what}: shards on {x0.device} and "
                             f"{x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{what} takes contiguous tensors")


def _ring_launch(wrapper, symbol: str, xs: list, *flags) -> list:
    """One launch of a ring combine over every shard's plane, counted on
    `wrapper`: the total, once for every shard."""
    out = torch.empty_like(xs[0])
    n = out.numel()
    if n:
        entry = build.entry("ring_fold", symbol,
                            (_PTR, _PTR, _INT, _LL) + (_INT,) * len(flags))
        build.launch(entry, wrapper.__name__, xs[0].get_device(),
                     build.SHARD_PTRS(*[x.data_ptr() for x in xs]),
                     out.data_ptr(), len(xs), n, *flags)
        wrapper.launches += 1
    return [out] * len(xs)


def ring_pext_fused(xs: list, take_max: bool) -> list:
    """Cross-shard elementwise max/min of per-shard (g, nb) float32 or
    int32 planes that lie on one device, in one launch: bit-identical to
    ring_pext (the hop ring) and to the gather twin. Returns the total
    once for every shard (the same tensor in every position); one shard
    comes back as it is. A CPU device runs the plain version."""
    _check_ring("ring_pext_fused", xs, _FOLD_TYPES)
    if len(xs) == 1:
        return [xs[0]]
    if xs[0].is_cpu:
        return ring_pext_fused_plain(xs, take_max)
    return _ring_launch(ring_pext_fused,
                        f"gtt_pext_ring_{_FOLD_TYPES[xs[0].dtype]}", xs,
                        int(take_max))


def ring_psum_onehot_fused(xs: list) -> list:
    """Cross-shard sum of per-shard (g, nb) float32 MASKED ONE-NONZERO
    planes (see ring_psum_onehot) that lie on one device, in one launch:
    bit-identical to the hop ring and to the gather twin. Returns the
    total once for every shard; one shard comes back as it is. A CPU
    device runs the plain version."""
    _check_ring("ring_psum_onehot_fused", xs, (torch.float32,))
    if len(xs) == 1:
        return [xs[0]]
    if xs[0].is_cpu:
        return ring_psum_onehot_fused_plain(xs)
    return _ring_launch(ring_psum_onehot_fused, "gtt_psum_onehot_ring_f32",
                        xs)


ring_pext_fused.launches = 0
ring_psum_onehot_fused.launches = 0


# ----------------------------------------------------------------------
# the fused ring (row 6): one launch per fold across every shard
# ----------------------------------------------------------------------

def ring_fold_fused_plain(arrs: list, fms: list) -> list:
    """Plain PyTorch version of the fused ring, in the kernel's order:
    every shard's fb_local block partials (K2's member walk), then one left
    fold of all of them in shard and block order from shard 0's first
    partial — the order in which the Pallas _tpu_ring_fold_call's ring
    steps add them. Returns the total on every shard's device, in shard
    order."""
    dev = arrs[0].device
    parts = torch.cat([block_partials_plain(a, fm).to(dev)
                       for a, fm in zip(arrs, fms)])
    total = left_fold_sum(parts)
    return [total.to(a.device) for a in arrs]


def _check_fused(arrs: list, fms: list) -> None:
    if not arrs or len(arrs) != len(fms):
        raise ValueError(f"ring_fold_fused: {len(arrs)} shards, "
                         f"{len(fms)} member lists")
    if len(arrs) > build.MAX_SHARDS:
        raise ValueError(f"ring_fold_fused takes at most {build.MAX_SHARDS} "
                         f"shards, not {len(arrs)}")
    fm0 = fms[0]
    if fm0.fb > _MAX_FB:
        raise ValueError(f"ring_fold_fused takes at most {_MAX_FB} blocks "
                         f"a shard, not {fm0.fb}")
    for a, fm in zip(arrs, fms):
        _check_fold("ring_fold_fused", a, fm)
        if (fm.g, fm.fb) != (fm0.g, fm0.fb):
            raise ValueError("ring_fold_fused: shards differ in groups or "
                             "blocks")
        if (a.dtype, a.shape[1], a.device) != (
                arrs[0].dtype, arrs[0].shape[1], arrs[0].device):
            raise ValueError("ring_fold_fused: shards differ in dtype, "
                             "cells or device")


def ring_fold_fused(arrs: list, fms: list) -> list:
    """Per-group sums of every shard's (s_local, nb) float32/int32 states,
    the total on every shard, in one launch of the fused ring kernel;
    bit-identical to ring_fold_blocks (the hop ring) and to the gather
    twin. Every shard's tensors must lie on one device: a CPU device runs
    the plain version, a CUDA card the kernel."""
    _check_fused(arrs, fms)
    if arrs[0].is_cpu:
        return ring_fold_fused_plain(arrs, fms)
    ns = len(arrs)
    g, fb, nb = fms[0].g, fms[0].fb, arrs[0].shape[1]
    dev = arrs[0].device
    outs = list(torch.empty((ns, g, nb), dtype=arrs[0].dtype,
                            device=dev).unbind(0))
    if g * nb == 0:
        return outs
    index = arrs[0].get_device()

    def ptrs(ts):
        return build.SHARD_PTRS(*[t.data_ptr() for t in ts])

    # bound once: the wrapper's host time is most of a fold's time at the
    # range path's shapes
    lib, fn = build.entry("ring_fold_fused",
                          f"gtt_ring_fold_fused_{_FOLD_TYPES[arrs[0].dtype]}",
                          (_PTR,) * 6 + (_INT,) * 4)
    with build.scratch_lock:
        stream = build.stream(index)
        part, count = build.stream_scratch(dev, stream).take(
            4 * ns * fb * g * nb, g * -(-nb // _FUSED_CELLS))
        rc = build.on_card(index, fn, ptrs(arrs),
                           ptrs([fm.member for fm in fms]),
                           ptrs([fm.ptr for fm in fms]), ptrs(outs), part,
                           count, ns, g, fb, nb, stream)
    if rc:
        build.check_launch(lib, rc, "ring_fold_fused")
    ring_fold_fused.launches += 1
    return outs


ring_fold_fused.launches = 0


# ----------------------------------------------------------------------
# the ring over per-shard lists
# ----------------------------------------------------------------------

def ring_fold_blocks(arrs: list, fms: list) -> list:
    """Per-group sums of every shard's (s_local, nb) states through the
    ring: shard 0 seeds with K2 over its fb_local blocks, and each later
    shard folds its blocks onto the accumulator that arrived (fold_cont).
    Bit-identical to dist.left_fold_sum(dist.gather_blocks(partials)).
    (The ring reads only the seed and the devices of the later shards'
    entries of its `local` list.)"""
    return sequential_ring(
        [blocked_fold_sum(arrs[0], fms[0])] + list(arrs[1:]),
        lambda s, acc: fold_cont(acc, arrs[s], fms[s]),
    )


def ring_pext(xs: list, take_max: bool) -> list:
    """Cross-shard elementwise extreme around the ring. With the JAX
    package's bits the sequential order matches pmin/pmax (min/max are
    exactly associative)."""
    return sequential_ring(
        xs, lambda s, acc: extreme(acc, xs[s], take_max))


def ring_psum_onehot(xs: list) -> list:
    """Cross-shard sum around the ring for MASKED ONE-NONZERO payloads
    (the staged first/last winner extraction: per element exactly one
    shard contributes the winner value, every other shard +0.0). x + 0.0
    is exact for every x except -0.0 -> +0.0, as in psum. NOT exact for
    general summands; those go through ring_fold_blocks."""
    return sequential_ring(xs, lambda s, acc: onehot_add(acc, xs[s]))


def fold_comm_bytes(ns: int, g: int, nb: int, passes: int = 1) -> int:
    """Declared inter-card traffic of `passes` ring passes over a (g, nb)
    f32 accumulator."""
    return ring_comm_bytes(ns, 4 * int(g) * int(nb)) * max(int(passes), 1)


class RingFoldCtx(ShardFoldCtx):
    """Kernel-path twin of dist.ShardFoldCtx: the same hooks, with the
    ring kernels behind them. Each hook is bit-identical to its gather
    counterpart for the payloads the range fold produces.

    `fused` mirrors the JAX package's `interpret=`. By default the devices
    decide: the one-ring forms (one ring_fold_fused, ring_pext_fused or
    ring_psum_onehot_fused launch per ring) when every shard lies on one
    device, the hop ring (K2's seed, then fold_cont, extreme or
    onehot_add hop by hop) when the shards span devices — the peer-copy
    form of the fused kernels belongs to the multi-card slice.
    fused=False always takes the hop ring. A choice from the device list,
    never a fallback: a failed fused launch raises."""

    def __init__(self, shards: int, fused: bool | None = None):
        super().__init__(shards)
        self.fused = fused

    def form(self, devices) -> str:
        """"fused" or "hops": the ring this ctx runs over shards on
        `devices` (base.ring_form)."""
        return ring_form(devices, self.fused)

    def fold_sum(self, arrs: list, fms: list) -> list:
        if self.form([a.device for a in arrs]) == "fused":
            return ring_fold_fused(arrs, fms)
        return ring_fold_blocks(arrs, fms)

    def pext(self, xs: list, take_max: bool) -> list:
        if self.form([x.device for x in xs]) == "fused":
            return ring_pext_fused(xs, take_max)
        return ring_pext(xs, take_max)

    def psum(self, xs: list) -> list:
        if self.form([x.device for x in xs]) == "fused":
            return ring_psum_onehot_fused(xs)
        return ring_psum_onehot(xs)
