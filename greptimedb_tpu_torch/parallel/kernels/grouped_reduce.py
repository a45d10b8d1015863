"""G: the GROUP BY's fixed-order grouped reduce, and Gt: its column sum.

The JAX package's fused GROUP BY program (query/reduce.py _fused_program)
builds every sum, count and squared deviation as float32 per-(block,
group) partials with jax.ops.segment_sum, every min/max with
jax.ops.segment_max/segment_min, and the per-group float32 mean of the
var/stddev deviations with jnp.sum over the block axis. XLA:CPU adds each
segment's rows one after the other in row order, and the bit contract
rests on that order; CUDA's index_add_, scatter_add_ and scatter_reduce
add floats with atomics in no fixed order. So these reductions run through
hand kernels on the card (csrc/grouped_reduce.cu):

- `grouped_block_reduce(v, members, "sum")`: (blocks, gb) float32 or
  float64, out[b, g] = 0 + v[i0] + v[i1] + ... over the member rows of
  group g in row block b, ascending (pseg2; float64: the PromQL generic
  engine's vectors through aggregate_across_series' scatter branch);
- `grouped_block_reduce(v, members, "max" | "min")`: (gb,) float32,
  float64 or int32, the fold of XLA's maximum/minimum from -inf/+inf
  (int32: from its least/greatest value) over the member rows of group g,
  ascending (segment_max/segment_min, the int32 stages of the first/last
  winners, and float64 for the flow state's min/max in x64 mode); the
  fold is associative (csrc/grouped_reduce.cu says why), so it folds each
  segment and then the segments in block order as a tree;
- `column_tree_sum(x)`: (cols,) float32, XLA:CPU's order for a float32
  sum over axis 0: chunks of 32 rows summed in order from 0, then the
  chunk sums the same way until one chunk is left; every level in one
  launch.

The walk gives a warp 32 consecutive segments of one group; a warp with a
segment of at least `_WARP_ROWS` rows (series-ordered rows: a group's rows
are long runs) streams all 32 as one coalesced range, any other lets each
lane walk its own (csrc/grouped_reduce.cu says why).

`group_members` builds the member order of one validity mask once (a
stable device sort of the group ids, as int16 keys when they fit: an index
permutation, no float arithmetic), and every section on that mask shares
it. The plain versions follow the kernels' order and run for CPU tensors;
on a CUDA tensor a wrapper launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from greptimedb_tpu_torch.parallel.kernels import build
from greptimedb_tpu_torch.parallel.kernels.ring_fold import extreme_plain

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_LL = ctypes.c_longlong
_FORMS = ("sum", "max", "min")
_EXT_TYPES = {torch.float32: "f32", torch.float64: "f64",
              torch.int32: "i32"}
_SUM_ENTRIES = {torch.float32: "gtt_grouped_block_sum",
                torch.float64: "gtt_grouped_block_sum_f64"}
_TREE = 32          # rows a chunk of XLA:CPU's tree reduction
_SLAB = _TREE * _TREE   # rows a block of the tree kernel reduces alone
_WARP = 32          # segments a warp of the walk owns
_WARP_ROWS = 32     # a segment this long makes its warp stream (kWarpRows)
_INT16_KEYS = 32767     # the largest gb whose masked key (gb) fits int16


@dataclass
class GroupMembers:
    """The member order of one validity mask over n rows cut into `blocks`
    runs of ceil(n / blocks) consecutive rows: perm[ptr[s]:ptr[s + 1]] are
    the rows of segment s = g * blocks + b (group g, row block b),
    ascending; masked rows follow the last segment."""

    gb: int
    blocks: int
    n: int
    perm: torch.Tensor   # (n,) int32
    ptr: torch.Tensor    # (gb * blocks + 1,) int32


def group_members(gid: torch.Tensor, mask: torch.Tensor, blocks: int,
                  gb: int) -> GroupMembers:
    """Member order of the rows `mask` keeps, by group id `gid` (int32,
    every kept id below gb) and row block. A stable sort by group id lists
    each group's rows ascending, and so its segments in block order."""
    n = gid.numel()
    if blocks < 1 or gb < 1:
        raise ValueError(f"blocks {blocks} and gb {gb} must be positive")
    key = gid.masked_fill(~mask, gb)
    if gb <= _INT16_KEYS:
        # half the key bytes; a stable sort of the same key order gives
        # the same permutation
        key = key.to(torch.int16)
    key_sorted, perm = torch.sort(key, stable=True)
    per = -(-n // blocks)
    block = perm // per
    seg_sorted = key_sorted.to(torch.int64) * blocks + block
    ptr = torch.searchsorted(
        seg_sorted, torch.arange(gb * blocks + 1, device=gid.device),
        out_int32=True)
    return GroupMembers(gb=gb, blocks=blocks, n=n,
                        perm=perm.to(torch.int32), ptr=ptr)


# ----------------------------------------------------------------------
# plain versions (the CPU path, and the card's reference)
# ----------------------------------------------------------------------

def _identity(form: str, dtype):
    """The value every segment starts from."""
    if form == "sum":
        return 0.0
    if dtype.is_floating_point:
        return -torch.inf if form == "max" else torch.inf
    info = torch.iinfo(dtype)
    return info.min if form == "max" else info.max


def _rank_steps(members: GroupMembers):
    """The members regrouped by rank within their segment: at step k the
    k-th row of every segment. Returns (segment, row, step_ptr)."""
    ptr = members.ptr.to(torch.int64)
    nseg = ptr.numel() - 1
    counts = ptr[1:] - ptr[:-1]
    m = int(ptr[-1])
    seg = torch.repeat_interleave(
        torch.arange(nseg, device=ptr.device), counts)
    rank = torch.arange(m, device=ptr.device) - ptr[:-1][seg]
    order = torch.argsort(rank, stable=True)
    step_ptr = [0] + torch.cumsum(torch.bincount(rank), 0).tolist()
    rows = members.perm[:m].to(torch.int64)
    return seg[order], rows[order], step_ptr


def grouped_block_reduce_plain(v: torch.Tensor, members: GroupMembers,
                               form: str) -> torch.Tensor:
    """Plain PyTorch version of G in the kernel's order: every segment
    starts from 0 (sum) or -inf/+inf (max/min) and takes its k-th row at
    step k (the slots of one step are distinct, so the indexed update is
    deterministic on every device); max/min then fold each group's
    segments in block order, pairwise (the fold is associative)."""
    gb, blocks = members.gb, members.blocks
    seg, rows, step_ptr = _rank_steps(members)
    take_max = form == "max"
    acc = torch.full((gb * blocks,), _identity(form, v.dtype), dtype=v.dtype,
                     device=v.device)
    for k in range(len(step_ptr) - 1):
        a, b = step_ptr[k], step_ptr[k + 1]
        sl = seg[a:b]
        x = v[rows[a:b]]
        acc[sl] = (acc[sl] + x if form == "sum"
                   else extreme_plain(acc[sl], x, take_max))
    if form == "sum":
        return acc.view(gb, blocks).t().contiguous()
    part = acc.view(gb, blocks)
    while part.shape[1] > 1:
        if part.shape[1] % 2:
            part = torch.cat([part, part.new_full(
                (gb, 1), _identity(form, v.dtype))], dim=1)
        part = extreme_plain(part[:, 0::2], part[:, 1::2], take_max)
    return part[:, 0].contiguous()


def column_tree_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of Gt: chunks of 32 rows summed in order from
    0, level by level, until one chunk is left."""
    while True:
        rows = x.shape[0]
        y = torch.zeros((-(-rows // _TREE), x.shape[1]), dtype=x.dtype,
                        device=x.device)
        for r in range(min(_TREE, rows)):
            part = x[r::_TREE]
            y[:part.shape[0]] = y[:part.shape[0]] + part
        x = y
        if rows <= _TREE:
            return x[0]


# ----------------------------------------------------------------------
# kernel wrappers: launch on a CUDA tensor, plain version on a CPU one
# ----------------------------------------------------------------------

def _check(v: torch.Tensor, members: GroupMembers, form: str) -> None:
    if form not in _FORMS:
        raise ValueError(f"grouped_block_reduce form {form!r} is not one of "
                         f"{_FORMS}")
    dtypes = tuple(_SUM_ENTRIES if form == "sum" else _EXT_TYPES)
    if v.dtype not in dtypes or v.dim() != 1 or v.numel() != members.n:
        raise TypeError(f"grouped_block_reduce {form} takes {members.n} "
                        f"values of {dtypes}, not {v.dtype} "
                        f"{tuple(v.shape)}")
    if v.device != members.perm.device:
        raise ValueError(f"values on {v.device}, members on "
                         f"{members.perm.device}")
    if not v.is_contiguous():
        raise ValueError("grouped_block_reduce takes contiguous values")


def grouped_block_reduce(v: torch.Tensor, members: GroupMembers,
                         form: str) -> torch.Tensor:
    """G over the rows of `members`: form "sum" gives the (blocks, gb)
    per-(block, group) sums of float32 or float64 values, "max"/"min" the
    (gb,) per-group extremes of float32, float64 or int32 values."""
    _check(v, members, form)
    if v.is_cpu:
        return grouped_block_reduce_plain(v, members, form)
    gb, blocks = members.gb, members.blocks
    index = v.get_device()
    if form == "sum":
        out = torch.empty((blocks, gb), dtype=v.dtype, device=v.device)
        build.launch(build.entry("grouped_reduce", _SUM_ENTRIES[v.dtype],
                                 (_PTR,) * 4 + (_INT,) * 2),
                     "grouped_block_reduce", index, v.data_ptr(),
                     members.perm.data_ptr(), members.ptr.data_ptr(),
                     out.data_ptr(), gb, blocks)
    else:
        # one partial per (group, 32-block chunk)
        part = torch.empty(gb * -(-blocks // _WARP), dtype=v.dtype,
                           device=v.device)
        out = torch.empty(gb, dtype=v.dtype, device=v.device)
        build.launch(build.entry("grouped_reduce",
                                 f"gtt_grouped_extreme_{_EXT_TYPES[v.dtype]}",
                                 (_PTR,) * 5 + (_INT,) * 3),
                     "grouped_block_reduce", index, v.data_ptr(),
                     members.perm.data_ptr(), members.ptr.data_ptr(),
                     part.data_ptr(), out.data_ptr(), gb, blocks,
                     int(form == "max"))
    grouped_block_reduce.launches += 1
    return out


def column_tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Gt: the (cols,) float32 sum over axis 0 of a (rows, cols) float32
    tensor in XLA:CPU's order, every level of the tree in one launch (the
    slab sums and the arrival counts in build's per-(device, stream)
    scratch)."""
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] < 1:
        raise TypeError(f"column_tree_sum takes a non-empty 2-D float32 "
                        f"tensor, not {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("column_tree_sum takes a contiguous tensor")
    if x.is_cpu:
        return column_tree_sum_plain(x)
    rows, cols = x.shape
    out = torch.empty(cols, dtype=torch.float32, device=x.device)
    slabs = -(-rows // _SLAB)
    lib, fn = build.entry("grouped_reduce", "gtt_column_tree_sum",
                          (_PTR,) * 4 + (_LL, _INT))
    index = x.get_device()
    with build.scratch_lock:
        stream = build.stream(index)
        part, count = build.stream_scratch(x.device, stream).take(
            4 * (slabs + -(-slabs // _TREE)) * cols if slabs > 1 else 0,
            cols)
        rc = build.on_card(index, fn, x.data_ptr(), out.data_ptr(), part,
                           count, rows, cols, stream)
    if rc:
        build.check_launch(lib, rc, "column_tree_sum")
    column_tree_sum.launches += 1
    return out


grouped_block_reduce.launches = 0
column_tree_sum.launches = 0
