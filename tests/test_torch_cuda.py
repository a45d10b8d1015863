"""The port's CUDA kernels and entry points on a card, against their plain
versions on the CPU. Every test skips without a CUDA card.

This file imports nothing of JAX, so it runs on a machine without it:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from greptimedb_tpu_torch.catalog.table import Table
from greptimedb_tpu_torch.parallel import dist
from greptimedb_tpu_torch.parallel.kernels import build
from greptimedb_tpu_torch.parallel.kernels import merge_gather as mg
from greptimedb_tpu_torch.parallel.kernels import ring_fold as rf
from greptimedb_tpu_torch.parallel.kernels import topk_merge as tm
from greptimedb_tpu_torch.parallel.mesh import MeshOptions, make_mesh
from greptimedb_tpu_torch.query.executor import QueryEngine
from greptimedb_tpu_torch.catalog.manager import CatalogManager
from greptimedb_tpu_torch.promql.engine import PromEngine
from greptimedb_tpu_torch.query.planner import (
    Column, KeySpec, RangeItemSpec, SelectPlan,
)
from greptimedb_tpu_torch.storage import device_merge as dm
from greptimedb_tpu_torch.storage.memtable import OP_DELETE, ColumnarRows

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_gather_planes_kernel_matches_plain(cuda):
    rng = np.random.default_rng(1)
    n = 1 << 14
    planes = rng.integers(-2**31, 2**31, (26, n), dtype=np.int64).astype(
        np.int32)
    src = np.sort(rng.choice(n, 12_345, replace=False)).astype(np.int32)
    want = mg.gather_planes(torch.from_numpy(planes), torch.from_numpy(src))
    before = mg.gather_planes.launches
    got = mg.gather_planes(torch.from_numpy(planes).to(cuda),
                           torch.from_numpy(src).to(cuda))
    torch.cuda.synchronize()
    assert mg.gather_planes.launches == before + 1
    assert torch.equal(got.cpu(), want)


def _k2_input(rng, s, nb, g, layout, dtype, m=None):
    """K2's inputs: (s, nb) states with edge bits (float32: wide
    magnitudes, -0.0, one NaN payload in the plane; int32: extremes whose
    sums wrap) and group ids. Layouts: "random" (10 % inactive), "mod32"
    (PromQL's dc = i % 32, 5 % inactive; with g = 33 group 32 is empty, as
    the grid's padding group is once it is left out), "skewed" (mod32 with
    70 % of the series in group 0), "prefix" (sid i in group i % g for
    i < m, the rest inactive: exactly m listed members)."""
    if dtype == torch.float32:
        arr = (rng.standard_normal((s, nb))
               * 10.0 ** rng.integers(-3, 4, (s, nb))).astype(np.float32)
        arr[rng.random((s, nb)) < 0.05] = -0.0
        bits = np.uint32(int(rng.integers(0, 2**22)) | 0x7FC00000)
        arr[rng.integers(s), rng.integers(nb)] = bits.view(np.float32)
    else:
        arr = rng.integers(-1000, 1000, (s, nb)).astype(np.int32)
        r = rng.random(arr.shape)
        arr[r < 0.05] = 2**31 - 1
        arr[(r >= 0.05) & (r < 0.1)] = -(2**31)
    sid = np.arange(s)
    if layout == "random":
        gid = rng.integers(0, g, s).astype(np.int32)
        gid[rng.random(s) < 0.1] = g
    elif layout == "prefix":
        gid = np.where(sid < m, sid % g, g).astype(np.int32)
    else:
        gid = (sid % 32).astype(np.int32)
        if layout == "skewed":
            gid[rng.random(s) < 0.7] = 0
        gid[rng.random(s) < 0.05] = g
    return arr, gid


def _same_bits_or_nan(got, want):
    """got (card) equals want (CPU) bit for bit, except that a NaN may
    carry the card's canonical payload (test_card_add_returns_its_
    canonical_nan)."""
    got = got.cpu()
    if got.dtype != torch.float32:
        return torch.equal(got, want)
    nan = torch.isnan(want)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(got.view(torch.int32)[~nan],
                            want.view(torch.int32)[~nan]))


# (s, nb, g, layout, offset, form): fb = 8 where s % 8 == 0, else 1;
# offset 1 cuts the rows one element into a larger buffer
_K2_CASES = [
    (4000, 2160, 9, "random", 0, "cells"),     # the one-device Q2 shape
    (4000, 257, 9, "random", 0, "staged"),
    (1000, 257, 37, "random", 0, "staged"),
    (60, 257, 4, "random", 0, "staged"),
    (1 << 18, 8, 33, "mod32", 0, "staged"),    # PromQL max by (dc)'s count
    (1 << 18, 9, 33, "mod32", 0, "staged"),    # nb % 4 != 0: 4-byte copies
    ((1 << 18) - 1, 8, 33, "mod32", 0, "staged"),       # fb = 1
    ((1 << 18) - 1, 9, 33, "skewed", 0, "staged"),
    (1 << 18, 8, 33, "skewed", 1, "staged"),   # misaligned rows
    (1 << 18, 8, 32, "mod32", 0, "staged"),    # every group listed
    # the switch point: g * nb at and below 16384, m at and above 1024 g
    (4096, 2048, 8, "random", 0, "cells"),
    (4096, 2047, 8, "random", 0, "staged"),
    (8200, 2048, 8, "prefix", 0, "cells"),     # m = 8192
    (8200, 2048, 8, "prefix", 1, "staged"),    # m = 8193
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("s,nb,g,layout,offset,form", _K2_CASES)
def test_blocked_fold_sum_kernel_matches_plain(cuda, s, nb, g, layout,
                                               offset, form, dtype):
    """One launch of the form the shape picks, bit for bit against the
    plain version on the card, and against the CPU up to the card's NaN."""
    rng = np.random.default_rng(s + nb + g + offset)
    m = 8192 + offset if layout == "prefix" else None
    arr, gid = _k2_input(rng, s, nb, g, layout, dtype, m)
    fb = 8 if s % 8 == 0 else 1
    fm_cpu = rf.fold_members(gid, g, fb, "cpu")
    assert rf.blocked_fold_form(g, nb, fm_cpu.member.numel()) == form
    want = rf.blocked_fold_sum(torch.from_numpy(arr), fm_cpu)
    fm = rf.fold_members(gid, g, fb, cuda)
    flat = torch.empty(offset + s * nb, dtype=dtype, device=cuda)
    x = flat[offset:].view(s, nb)
    x.copy_(torch.from_numpy(arr))
    before = rf.blocked_fold_sum.launches
    got = rf.blocked_fold_sum(x, fm)
    torch.cuda.synchronize()
    assert rf.blocked_fold_sum.launches == before + 1
    assert torch.equal(_bits32(got), _bits32(rf.blocked_fold_sum_plain(x, fm)))
    assert _same_bits_or_nan(got, want)


def test_blocked_fold_sum_back_to_back_resets_its_arrival_counts(cuda):
    """The staged form's partials and arrival counts live in the stream's
    scratch, shared with the walk forms: back to back on one stream, with
    forms, shapes, block counts and dtypes changing (and a fold_cont in
    between), every fold equals its plain version and the counts are all
    0 after each launch."""
    rng = np.random.default_rng(31)
    inputs = []
    for s, nb, g, layout, dtype in [
            (1 << 16, 8, 33, "mod32", torch.float32),
            (4000, 2160, 9, "random", torch.int32),
            (1 << 16, 9, 33, "skewed", torch.int32),
            ((1 << 16) - 1, 8, 33, "mod32", torch.float32),
            (4000, 300, 9, "random", torch.float32)]:
        arr, gid = _k2_input(rng, s, nb, g, layout, dtype)
        x = torch.from_numpy(arr).to(cuda)
        fm = rf.fold_members(gid, g, 8 if s % 8 == 0 else 1, cuda)
        inputs.append((x, fm, rf.blocked_fold_sum_plain(x, fm)))
    key = (inputs[0][0].device, build.stream(cuda.index or 0))
    acc = torch.zeros((33, 8), device=cuda)
    for _ in range(3):
        for x, fm, want in inputs * 2:
            got = rf.blocked_fold_sum(x, fm)
            torch.cuda.synchronize()
            assert torch.equal(_bits32(got), _bits32(want))
            assert int(build.scratches[key].count.abs().sum()) == 0
        rf.fold_cont(acc, inputs[0][0], inputs[0][1])


def _bits32(t):
    return t.cpu().view(torch.int32)


def _walk_case(rng, s, nb, g, fb, offset, dtype, cuda):
    """Inputs of fold_cont and block_partials on the card: (s, nb) states
    with the fold's edge bits, cut `offset` elements into a larger buffer
    (offset 1: rows 4 bytes past a 16-byte boundary, the 4-byte copies);
    member lists where group 0 holds more than 1024 members of one block
    whenever the shape allows (the walk stages 1024 sids at a time) and
    group g - 1 holds none; an acc with -0.0 in every cell of that empty
    group (acc + an empty partial must come out +0.0) and in a band of
    cells elsewhere."""
    x = _ring_input(rng, 1, s, nb, dtype)[0]
    gid = rng.integers(0, g - 1, s).astype(np.int32)
    gid[rng.random(s) < 0.1] = g                   # inactive: not listed
    per = s // fb
    if per > 1100:
        gid[:1100] = 0                             # 1100+ members in block 0
    if dtype == torch.float32:
        acc = (rng.standard_normal((g, nb))
               * 10.0 ** rng.integers(-3, 4, (g, nb))).astype(np.float32)
        acc[g - 1] = -0.0
        acc[:, : max(nb // 4, 1)] = -0.0
    else:
        acc = rng.integers(-2**31, 2**31, (g, nb), dtype=np.int64).astype(
            np.int32)
    flat = torch.empty(offset + s * nb, dtype=dtype, device=cuda)
    arr = flat[offset:].view(s, nb)
    arr.copy_(torch.from_numpy(x))
    return (arr, torch.from_numpy(acc).to(cuda),
            rf.fold_members(gid, g, fb, cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("s,nb,g,fb,offset", [
    (2048, 2160, 9, 2, 0),      # one shard of the mesh phase's Q2
    (2048, 2160, 9, 1, 0),
    (2048, 2160, 9, 8, 0),
    (2048, 2160, 9, 2, 1),      # misaligned rows: the 4-byte copies
    (1024, 257, 5, 2, 0),       # nb % 4 != 0, a ragged last tile
    (1024, 257, 5, 8, 1),
    (64, 6, 3, 8, 0),           # fewer cells than one thread's 4 x 2
    (64, 6, 3, 1, 1),
    (3000, 40, 3, 1, 0),        # 2000+ members a group: three batches
])
def test_fold_cont_and_block_partials_kernels_match_plain(cuda, s, nb, g, fb,
                                                          offset, dtype):
    """fold_cont and block_partials (the walk's kCont and kPartials forms)
    bit for bit against their plain versions on the card, one launch
    each, with NaN payloads, ±inf, -0.0 and int32 sums that wrap."""
    rng = np.random.default_rng(s + nb + g + fb + offset)
    x, a, fm = _walk_case(rng, s, nb, g, fb, offset, dtype, cuda)
    if offset:
        assert x.is_contiguous() and x.data_ptr() % 16
    counts = fm.ptr.cpu().diff().view(fb, g)
    assert (counts[:, g - 1] == 0).all()
    if s // fb > 1100:
        assert counts[0, 0] > 1024
    before = (rf.fold_cont.launches, rf.block_partials.launches)
    cont = rf.fold_cont(a, x, fm)
    parts = rf.block_partials(x, fm)
    torch.cuda.synchronize()
    assert (rf.fold_cont.launches, rf.block_partials.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(_bits32(cont), _bits32(rf.fold_cont_plain(a, x, fm)))
    assert torch.equal(_bits32(parts),
                       _bits32(rf.block_partials_plain(x, fm)))
    if dtype == torch.float32:
        # -0.0 + the empty group's +0.0 partials is +0.0
        assert (_bits32(cont)[g - 1] == 0).all()


def test_fold_cont_back_to_back_resets_its_arrival_counts(cuda):
    """fold_cont back to back on one stream, beside the fused ring that
    shares its scratch, with the shape, fb and dtype changing: every call
    equals its plain version and the arrival counts are all 0 after it."""
    rng = np.random.default_rng(31)
    cases = [(2048, 2160, 9, 2, 0, torch.float32),
             (1024, 257, 5, 8, 1, torch.int32),
             (64, 6, 3, 1, 0, torch.float32),
             (3000, 40, 3, 1, 0, torch.int32),
             (2048, 2160, 9, 2, 0, torch.int32)]
    inputs = []
    for s, nb, g, fb, offset, dtype in cases:
        x, a, fm = _walk_case(rng, s, nb, g, fb, offset, dtype, cuda)
        inputs.append((x, a, fm, rf.fold_cont_plain(a, x, fm)))
    ring = _ring_input(rng, 4, 256, 300, torch.float32)
    arrs = [torch.from_numpy(np.ascontiguousarray(r)).to(cuda) for r in ring]
    gid = rng.integers(0, 4, (4, 256)).astype(np.int32)
    fms = [rf.fold_members(gid[k], 3, 2, cuda) for k in range(4)]
    ring_want = rf.ring_fold_fused_plain(arrs, fms)
    stream = build.stream(torch.cuda.current_device())
    for _ in range(3):
        for x, a, fm, want in inputs * 2:
            got = rf.fold_cont(a, x, fm)
            torch.cuda.synchronize()
            assert torch.equal(_bits32(got), _bits32(want))
            counts = build.scratches[x.device, stream].count
            assert int(counts.abs().sum()) == 0
        for got, want in zip(rf.ring_fold_fused(arrs, fms), ring_want):
            assert torch.equal(_bits32(got), _bits32(want))


def test_fold_cont_on_two_streams_at_once(cuda):
    """Two streams run fold_cont at the same time, each with its own
    scratch and counts: both equal the plain version, launch after
    launch."""
    rng = np.random.default_rng(37)
    x, a, fm = _walk_case(rng, 2048, 2160, 9, 2, 0, torch.float32, cuda)
    want = rf.fold_cont_plain(a, x, fm)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = {0: [], 1: []}
    for _ in range(8):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(rf.fold_cont(a, x, fm))
    torch.cuda.synchronize()
    for i in outs:
        for got in outs[i]:
            assert torch.equal(_bits32(got), _bits32(want))
    assert len({k for k in build.scratches if k[0] == x.device}) >= 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_hop_fused_and_gather_folds_agree_at_the_mesh_q2_shape(cuda, dtype):
    """Four shards of 2048 series at the mesh phase's Q2 shape (nb = 2160,
    g = 9, fb_local = 2), with edge bits: the fused ring (one launch), the
    hop ring (K2's seed, then three fold_cont) and the gather twin
    (block_partials on every shard, then the left fold) give the same
    bits on every shard, and the plain version's."""
    rng = np.random.default_rng(41)
    ns, s_local, nb, g = 4, 2048, 2160, 9
    x = _ring_input(rng, ns, s_local, nb, dtype)
    gid = rng.integers(0, g + 1, (ns, s_local)).astype(np.int32)
    arrs = [torch.from_numpy(np.ascontiguousarray(x[k])).to(cuda)
            for k in range(ns)]
    fms = [rf.fold_members(gid[k], g, 2, cuda) for k in range(ns)]
    before = (rf.ring_fold_fused.launches, rf.fold_cont.launches,
              rf.block_partials.launches)
    fused = rf.RingFoldCtx(ns).fold_sum(arrs, fms)
    hops = rf.RingFoldCtx(ns, fused=False).fold_sum(arrs, fms)
    gather = dist.ShardFoldCtx(ns).fold_sum(arrs, fms)
    torch.cuda.synchronize()
    assert (rf.ring_fold_fused.launches, rf.fold_cont.launches,
            rf.block_partials.launches) == (
        before[0] + 1, before[1] + ns - 1, before[2] + ns)
    want = rf.ring_fold_fused_plain(arrs, fms)
    for k in range(ns):
        for got in (fused, hops, gather):
            assert torch.equal(_bits32(got[k]), _bits32(want[k])), k


def _specials(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    r = rng.random(shape)
    x[r < 0.1] = 0.0
    x[(r >= 0.1) & (r < 0.2)] = -0.0
    x[(r >= 0.2) & (r < 0.25)] = np.inf
    x[(r >= 0.25) & (r < 0.3)] = -np.inf
    nan = (r >= 0.3) & (r < 0.45)
    bits = (rng.integers(0, 2**22, shape) | 0x7FC00000
            | (rng.integers(0, 2, shape) << 31)).astype(np.uint32)
    x[nan] = bits.view(np.float32)[nan]
    return x


@pytest.mark.parametrize("take_max", [False, True])
def test_extreme_kernel_matches_plain_and_the_cpu(cuda, take_max):
    """NaN payloads, ±0 and ±inf: the kernel's bits equal the plain
    version's on the card and on the CPU (the JAX package's bits)."""
    rng = np.random.default_rng(13 + take_max)
    a, b = _specials(rng, (9, 2160)), _specials(rng, (9, 2160))
    want = rf.extreme(torch.from_numpy(a), torch.from_numpy(b), take_max)
    ac, bc = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
    before = rf.extreme.launches
    got = rf.extreme(ac, bc, take_max)
    torch.cuda.synchronize()
    assert rf.extreme.launches == before + 1
    assert torch.equal(_bits32(got), want.view(torch.int32))
    assert torch.equal(_bits32(rf.extreme_plain(ac, bc, take_max)),
                       want.view(torch.int32))
    ai = torch.from_numpy(rng.integers(-2**31, 2**31, (9, 2160),
                                       dtype=np.int64).astype(np.int32))
    bi = torch.from_numpy(rng.integers(-2**31, 2**31, (9, 2160),
                                       dtype=np.int64).astype(np.int32))
    got_i = rf.extreme(ai.to(cuda), bi.to(cuda), take_max)
    assert torch.equal(got_i.cpu(), rf.extreme(ai, bi, take_max))


def test_onehot_add_kernel_matches_plain(cuda):
    rng = np.random.default_rng(17)
    a = rng.standard_normal((9, 2160)).astype(np.float32)
    x = np.where(rng.random((9, 2160)) < 0.5, 0.0,
                 rng.standard_normal((9, 2160))).astype(np.float32)
    a[:, :8] = -0.0
    ac, xc = torch.from_numpy(a).to(cuda), torch.from_numpy(x).to(cuda)
    before = rf.onehot_add.launches
    got = rf.onehot_add(ac, xc)
    torch.cuda.synchronize()
    assert rf.onehot_add.launches == before + 1
    assert torch.equal(_bits32(got), _bits32(rf.onehot_add_plain(ac, xc)))
    assert torch.equal(_bits32(got), _bits32(torch.from_numpy(a + x)))


def _ring_planes(rng, ns, g, nb, offset, cuda):
    """Per-shard (g, nb) planes on the card: float32 edge bits (NaN
    payloads of either sign, ±0, ±inf), int32 extremes, and one-hot
    float32 payloads (one winner shard per element, +0.0 elsewhere, the
    winners edge bits too). offset > 0 cuts every plane out of a larger
    buffer `offset` elements in: contiguous, but its pointer is off the
    16-byte boundary, so the kernel takes its one-element path."""
    f32 = np.stack([_specials(rng, (g, nb)) for _ in range(ns)])
    i32 = rng.integers(-2**31, 2**31, (ns, g, nb), dtype=np.int64).astype(
        np.int32)
    r = rng.random(i32.shape)
    i32[r < 0.1] = -2**31
    i32[(r >= 0.1) & (r < 0.2)] = 2**31 - 1
    win = rng.integers(0, ns, (g, nb))
    oh = np.zeros((ns, g, nb), np.float32)
    oh[win, np.arange(g)[:, None], np.arange(nb)[None, :]] = _specials(
        rng, (g, nb))

    def card(x):
        out = []
        for k in range(ns):
            buf = torch.empty(offset + g * nb, dtype=torch.from_numpy(
                x[:1]).dtype, device=cuda)
            plane = buf[offset:].view(g, nb)
            plane.copy_(torch.from_numpy(np.ascontiguousarray(x[k])))
            out.append(plane)
        return out

    return {"f32": (f32, card(f32)), "i32": (i32, card(i32)),
            "onehot": (oh, card(oh))}


def _cpu_shards(x):
    return [torch.from_numpy(np.ascontiguousarray(p)) for p in x]


@pytest.mark.parametrize("ns,g,nb,offset", [
    (4, 9, 2160, 0),        # the mesh phase's Q2 plane: 16-byte loads
    (4, 9, 2161, 0),        # n % 4 == 1: 16-byte loads and a tail
    (4, 9, 2160, 1),        # misaligned views: one element a thread
    (2, 3, 7, 0),
    (8, 5, 300, 3),
    (8, 9, 2160, 0),
])
def test_ring_combine_kernels_match_plain_and_the_hop_ring(cuda, ns, g, nb,
                                                           offset):
    """ring_pext_fused (f32 and int32, max and min) and
    ring_psum_onehot_fused, one launch per ring: bit for bit against their
    plain versions and the hop ring on the card, and against the CPU (the
    JAX package's bits) — the extreme exactly, the sum except for which
    NaN comes out (the card's add returns its canonical NaN)."""
    rng = np.random.default_rng(ns * 10_000 + nb + offset)
    planes = _ring_planes(rng, ns, g, nb, offset, cuda)
    if offset:
        assert planes["f32"][1][0].data_ptr() % 16
    for dt in ("f32", "i32"):
        host, xs = planes[dt]
        for take_max in (True, False):
            before = (rf.ring_pext_fused.launches, rf.extreme.launches)
            got = rf.ring_pext_fused(xs, take_max)
            torch.cuda.synchronize()
            assert (rf.ring_pext_fused.launches, rf.extreme.launches) == (
                before[0] + 1, before[1])
            assert len(got) == ns and all(o is got[0] for o in got)
            want = rf.ring_pext_fused_plain(_cpu_shards(host), take_max)[0]
            assert torch.equal(_bits32(got[0]), _bits32(want)), (dt, take_max)
            assert torch.equal(
                _bits32(got[0]),
                _bits32(rf.ring_pext_fused_plain(xs, take_max)[0]))
            hops = rf.ring_pext(xs, take_max)
            assert all(torch.equal(_bits32(got[0]), _bits32(h))
                       for h in hops)
    for dt in ("onehot", "f32"):
        host, xs = planes[dt]
        before = rf.ring_psum_onehot_fused.launches
        got = rf.ring_psum_onehot_fused(xs)
        torch.cuda.synchronize()
        assert rf.ring_psum_onehot_fused.launches == before + 1
        plain = rf.ring_psum_onehot_fused_plain(xs)[0]
        assert torch.equal(_bits32(got[0]), _bits32(plain)), dt
        assert all(torch.equal(_bits32(got[0]), _bits32(h))
                   for h in rf.ring_psum_onehot(xs))
        want = rf.ring_psum_onehot_fused_plain(_cpu_shards(host))[0]
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got[0]).cpu(), nan)
        assert torch.equal(_bits32(got[0])[~nan], _bits32(want)[~nan])
        if dt == "onehot":
            assert (_bits32(got[0])[nan] == 0x7FFFFFFF).all()


def test_launch_floor_runs(cuda):
    """The empty kernel through the bound launch path (chip_smoke.py's
    launch_floor_ms) launches and leaves the card usable."""
    for _ in range(3):
        rf.noop(cuda)
    torch.cuda.synchronize()


def test_add_chain_counts_its_adds(cuda):
    """The dependent-add probe behind K2's chain bound adds 1.0 n times,
    each add after the one before: exactly n below 2^24."""
    for n in (1, 17, 1 << 16):
        assert float(rf.add_chain(cuda, n)) == n


def _stream_cases(cuda):
    """(name, launch, want) for rows 2-6 and the ring forms over one set of
    inputs: launch(*inputs) runs the kernel, want the plain version on the
    CPU."""
    rng = np.random.default_rng(21)
    ns, s_local, nb, g = 4, 256, 300, 9
    x = _ring_input(rng, ns, s_local, nb, torch.float32)
    x[~np.isfinite(x)] = 1.0                   # no NaN: CPU bits == card's
    gid = rng.integers(0, g + 1, (ns, s_local)).astype(np.int32)
    fms = [rf.fold_members(gid[k], g, 2, cuda) for k in range(ns)]
    fms_cpu = [rf.fold_members(gid[k], g, 2, "cpu") for k in range(ns)]
    planes = rng.standard_normal((ns, g, nb)).astype(np.float32)
    host = [x[k] for k in range(ns)] + [planes[k] for k in range(ns)]
    arrs, pl = slice(0, ns), slice(ns, 2 * ns)
    return host, [
        ("blocked_fold_sum", lambda t: [rf.blocked_fold_sum(t[0], fms[0])],
         lambda t: [rf.blocked_fold_sum(t[0], fms_cpu[0])]),
        ("fold_cont", lambda t: [rf.fold_cont(t[ns], t[1], fms[1])],
         lambda t: [rf.fold_cont(t[ns], t[1], fms_cpu[1])]),
        ("extreme", lambda t: [rf.extreme(t[ns], t[ns + 1], True)],
         lambda t: [rf.extreme(t[ns], t[ns + 1], True)]),
        ("onehot_add", lambda t: [rf.onehot_add(t[ns], t[ns + 1])],
         lambda t: [rf.onehot_add(t[ns], t[ns + 1])]),
        ("ring_pext_fused", lambda t: rf.ring_pext_fused(t[pl], False),
         lambda t: rf.ring_pext_fused(t[pl], False)),
        ("ring_psum_onehot_fused",
         lambda t: rf.ring_psum_onehot_fused(t[pl]),
         lambda t: rf.ring_psum_onehot_fused(t[pl])),
        ("ring_fold_fused", lambda t: rf.ring_fold_fused(t[arrs], fms),
         lambda t: rf.ring_fold_fused(t[arrs], fms_cpu)),
    ]


def test_bound_launchers_run_on_the_callers_stream(cuda):
    """Rows 2-6 and the ring forms launch on the caller's current stream:
    inside torch.cuda.stream(s), each kernel queues behind a sleep and the
    copy of its inputs on s, and reads the copied values. A launch on the
    default stream would run at once and read the zeros left before (side
    streams do not wait for the default stream)."""
    host, cases = _stream_cases(cuda)
    side = torch.cuda.Stream()
    for name, launch, want_fn in cases:
        cpu_in = [torch.from_numpy(np.ascontiguousarray(h)) for h in host]
        want = want_fn(cpu_in)
        dst = [torch.zeros_like(t, device=cuda) for t in cpu_in]
        pinned = [t.pin_memory() for t in cpu_in]
        torch.cuda.synchronize()
        with torch.cuda.stream(side):
            assert build.stream(torch.cuda.current_device()) == (
                side.cuda_stream)
            torch.cuda._sleep(50_000_000)
            for d, p in zip(dst, pinned):
                d.copy_(p, non_blocking=True)
            got = launch(dst)
        side.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(_bits32(a), _bits32(b)), name


def test_bound_launchers_run_on_a_card_that_is_not_current(cuda):
    """Inputs on card 1 while card 0 is current: every kernel launches on
    card 1 (its current stream there), the current card stays 0, and a
    hop ring across the two cards launches on each."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    other = torch.device("cuda", 1)
    host, cases = _stream_cases(other)
    with torch.cuda.device(0):
        for name, launch, want_fn in cases:
            cpu_in = [torch.from_numpy(np.ascontiguousarray(h))
                      for h in host]
            got = launch([t.to(other) for t in cpu_in])
            torch.cuda.synchronize(other)
            assert torch.cuda.current_device() == 0
            for a, b in zip(got, want_fn(cpu_in)):
                assert a.device == other
                assert torch.equal(_bits32(a), _bits32(b)), name
        rng = np.random.default_rng(4)
        host = np.stack([_specials(rng, (9, 300)) for _ in range(4)])
        xs = [torch.from_numpy(host[k]).to(torch.device("cuda", k % 2))
              for k in range(4)]
        ctx = rf.RingFoldCtx(4)
        assert ctx.form([x.device for x in xs]) == "hops"
        before = (rf.extreme.launches, rf.ring_pext_fused.launches)
        got = ctx.pext(xs, True)
        assert (rf.extreme.launches, rf.ring_pext_fused.launches) == (
            before[0] + 3, before[1])
        want = rf.ring_pext_fused_plain(_cpu_shards(host), True)[0]
        for k, t in enumerate(got):
            assert t.device == xs[k].device
            assert torch.equal(_bits32(t), _bits32(want))


def _ring_input(rng, ns, s_local, nb, dtype):
    """Per-shard states with the fold's edge bits: float32 with wide
    magnitudes, -0.0 (a whole cell of it), ±inf in two cells of three and
    at most one NaN payload per (group, cell) chain in the third; int32
    with extremes whose sums wrap."""
    if dtype == torch.int32:
        x = rng.integers(-1000, 1000, (ns, s_local, nb)).astype(np.int32)
        r = rng.random(x.shape)
        x[r < 0.05] = 2**31 - 1
        x[(r >= 0.05) & (r < 0.1)] = -(2**31)
        return x
    x = (rng.standard_normal((ns, s_local, nb))
         * 10.0 ** rng.integers(-4, 5, (ns, s_local, nb))).astype(np.float32)
    r = rng.random(x.shape)
    x[r < 0.1] = -0.0
    x[:, :, nb // 2] = -0.0
    inf_cell = (np.arange(nb) % 3 != 0)[None, None, :]
    inf_cell[..., nb // 2] = False
    x[(r >= 0.1) & (r < 0.12) & inf_cell] = np.inf
    x[(r >= 0.12) & (r < 0.14) & inf_cell] = -np.inf
    for c in range(0, nb, 3):
        bits = np.uint32(int(rng.integers(0, 2**22)) | 0x7FC00000)
        x[rng.integers(ns), rng.integers(s_local), c] = bits.view(np.float32)
    return x


@pytest.mark.parametrize("ns,s_local,nb,g,dtype", [
    (4, 2048, 2160, 9, torch.float32),     # the mesh phase's Q2 shape
    (4, 2048, 2160, 9, torch.int32),
    (2, 64, 37, 5, torch.float32),         # nb % 4 != 0: the 4-byte copies
    (8, 16, 300, 3, torch.int32),          # a ragged last chunk (300 % 256)
    (8, 16, 300, 3, torch.float32),
    (4, 1024, 1, 1, torch.float32),        # BY (): one group, one cell
    (4, 3000, 40, 2, torch.float32),       # 1500 members a group: two
                                           # member batches of the walk
])
def test_ring_fold_fused_kernel_matches_plain(cuda, ns, s_local, nb, g,
                                              dtype):
    """Every shard's output bit for bit against the plain version on the
    card and against the hop ring, one launch a fold; against the CPU bit
    for bit except for which NaN comes out (the card's float add returns
    its canonical NaN where the CPU's keeps an operand's payload)."""
    rng = np.random.default_rng(ns * 1000 + nb + g)
    x = _ring_input(rng, ns, s_local, nb, dtype)
    gid = rng.integers(0, g + 1, (ns, s_local)).astype(np.int32)
    fb = 8 // ns
    cpu = [torch.from_numpy(np.ascontiguousarray(x[k])) for k in range(ns)]
    fms_cpu = [rf.fold_members(gid[k], g, fb, "cpu") for k in range(ns)]
    want = rf.ring_fold_fused(cpu, fms_cpu)
    arrs = [t.to(cuda) for t in cpu]
    fms = [rf.fold_members(gid[k], g, fb, cuda) for k in range(ns)]
    before = rf.ring_fold_fused.launches
    got = rf.ring_fold_fused(arrs, fms)
    torch.cuda.synchronize()
    assert rf.ring_fold_fused.launches == before + 1
    plain = rf.ring_fold_fused_plain(arrs, fms)
    hops = rf.ring_fold_blocks(arrs, fms)
    for k in range(ns):
        nan = torch.isnan(want[k]) if dtype == torch.float32 else None
        if nan is not None:
            assert torch.equal(torch.isnan(got[k]).cpu(), nan), k
            assert torch.equal(_bits32(got[k])[~nan],
                               want[k].view(torch.int32)[~nan]), k
        else:
            assert torch.equal(got[k].cpu(), want[k]), k
        assert torch.equal(_bits32(got[k]), _bits32(plain[k])), k
        assert torch.equal(_bits32(got[k]), _bits32(hops[k])), k


def test_ring_fold_fused_takes_misaligned_rows(cuda):
    """Shards whose rows start 4 bytes past a 16-byte boundary (views one
    element into a larger tensor), with nb % 4 == 0 and nb % 4 == 1, take
    the 4-byte copies and still equal the plain version bit for bit."""
    rng = np.random.default_rng(17)
    ns, s_local, g = 4, 256, 9
    for nb in (300, 301):
        x = _ring_input(rng, ns, s_local + 1, nb, torch.float32)
        gid = rng.integers(0, g + 1, (ns, s_local)).astype(np.int32)
        fms = [rf.fold_members(gid[k], g, 2, cuda) for k in range(ns)]
        flat = [torch.from_numpy(x[k].ravel()).to(cuda) for k in range(ns)]
        arrs = [f[1:1 + s_local * nb].view(s_local, nb) for f in flat]
        assert all(a.is_contiguous() and a.data_ptr() % 16 for a in arrs)
        got = rf.ring_fold_fused(arrs, fms)
        want = rf.ring_fold_fused_plain(arrs, fms)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(_bits32(a), _bits32(b)), nb


def test_card_add_returns_its_canonical_nan(cuda):
    """Why a folded sum that is NaN has other bits on the card than on the
    CPU: the card's float add returns 0x7FFFFFFF for a NaN operand and for
    inf + (-inf), where the CPU keeps the operand's payload."""
    x = torch.tensor([0x7FC12345, 0x7F800000, -0x00800000],
                     dtype=torch.int32).view(torch.float32)
    assert (x[:1] + 1.0).view(torch.int32).item() == 0x7FC12345
    assert torch.isnan(x[1:2] + x[2:3]).all()
    xc = x.to(cuda)
    assert (xc[:1] + 1.0).view(torch.int32).item() == 0x7FFFFFFF
    assert (xc[1:2] + xc[2:3]).view(torch.int32).item() == 0x7FFFFFFF


def test_ring_fold_fused_resets_its_arrival_counts(cuda):
    """The scratch and the per-tile arrival counts outlive a launch and
    are never cleared by the wrapper: back to back on one stream, with the
    shard count, the plane and the dtype changing, every ring equals its
    plain version (a count left above 0 would elect the wrong last block),
    and the counts are all 0 after each launch."""
    rng = np.random.default_rng(9)
    cases = [(4, 512, 2160, 9, torch.float32), (2, 64, 37, 5, torch.int32),
             (8, 16, 300, 3, torch.float32), (4, 512, 2160, 9, torch.int32),
             (4, 64, 7, 1, torch.float32)]
    inputs = []
    for ns, s_local, nb, g, dtype in cases:
        x = _ring_input(rng, ns, s_local, nb, dtype)
        gid = rng.integers(0, g + 1, (ns, s_local)).astype(np.int32)
        arrs = [torch.from_numpy(np.ascontiguousarray(x[k])).to(cuda)
                for k in range(ns)]
        fms = [rf.fold_members(gid[k], g, 8 // ns, cuda) for k in range(ns)]
        inputs.append((arrs, fms, rf.ring_fold_fused_plain(arrs, fms)))
    key = (inputs[0][0][0].device, build.stream(cuda.index or 0))
    for _ in range(3):
        for arrs, fms, want in inputs * 2:
            got = rf.ring_fold_fused(arrs, fms)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                assert torch.equal(_bits32(a), _bits32(b))
            assert int(build.scratches[key].count.abs().sum()) == 0
    with pytest.raises(ValueError):                # shards on two devices
        rf.ring_fold_fused([inputs[0][0][0], inputs[0][0][1].cpu()],
                           inputs[0][1][:2])


def test_ring_fold_fused_on_two_streams_at_once(cuda):
    """Two streams fold at the same time, each with its own scratch and
    counts: both equal the plain version, launch after launch."""
    rng = np.random.default_rng(10)
    ns, s_local, nb, g = 4, 1024, 2160, 9
    x = _ring_input(rng, ns, s_local, nb, torch.float32)
    gid = rng.integers(0, g + 1, (ns, s_local)).astype(np.int32)
    arrs = [torch.from_numpy(np.ascontiguousarray(x[k])).to(cuda)
            for k in range(ns)]
    fms = [rf.fold_members(gid[k], g, 2, cuda) for k in range(ns)]
    want = rf.ring_fold_fused_plain(arrs, fms)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = {0: [], 1: []}
    for _ in range(8):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(rf.ring_fold_fused(arrs, fms))
    torch.cuda.synchronize()
    for i in outs:
        for got in outs[i]:
            for a, b in zip(got, want):
                assert torch.equal(_bits32(a), _bits32(b))
    assert len({k for k in build.scratches if k[0] == arrs[0].device}) >= 2


def test_sql_on_cuda_matches_cpu(cuda):
    """Instance.sql on the card (one device; four shards as the fused ring,
    the hop ring and the gather twin) against Instance(device="cpu").sql,
    bit for bit; the fused kernel carries every sharded fold of the
    default ring and launches on no other engine."""
    import functools

    from greptimedb_tpu_torch.instance import Instance
    from greptimedb_tpu_torch.query import device_range as dr

    rng = np.random.default_rng(4)
    t = Table("cpu", ts_name="ts", tag_names=["hostname", "region"],
              fields=["u", "v"])
    hosts = np.array([f"host_{i}" for i in range(300)])
    regions = np.array(["a", "b", "c"])[rng.integers(0, 3, 300)]
    ts = np.tile(np.arange(720) * 10_000, 300)
    hi = np.repeat(np.arange(300), 720)
    t.write({"hostname": hosts[hi], "region": regions[hi]}, ts,
            {"u": rng.random(len(ts)) * 100, "v": rng.random(len(ts))})
    queries = [
        "SELECT ts, region, count(u) RANGE '1h', sum(u) RANGE '1h', "
        "min(u) RANGE '1h', max(v) RANGE '1h', avg(u) RANGE '1h', "
        "first_value(v) RANGE '1h', last_value(u) RANGE '1h' FROM cpu "
        "ALIGN '30m' BY (region)",
        "SELECT ts, max(u) RANGE '1m' FROM cpu WHERE ts < 3600000 "
        "ALIGN '1m' BY () ORDER BY ts DESC LIMIT 5",
        "SELECT ts, max(u) RANGE '1m' FROM cpu WHERE hostname = 'host_17' "
        "ALIGN '1m' BY (hostname)",
        "SELECT ts, hostname, avg(u) RANGE '2h' FROM cpu WHERE hostname IN "
        "('host_1', 'host_250') ALIGN '1h' BY (hostname)",
    ]
    cpu_inst = Instance(device="cpu")
    cpu_inst.catalog.register(t)
    want = [cpu_inst.sql(q) for q in queries]
    low = {"shard_min_series": 1, "pallas_min_series": 1}
    mesh = make_mesh([cuda] * 4)
    engines = {"single": (None, None, True),
               "fused": (mesh, MeshOptions(**low), True),
               "hops": (mesh, MeshOptions(**low), False),
               "gather": (mesh, MeshOptions(pallas_kernels="off", **low),
                          True)}
    real_ctx = rf.RingFoldCtx
    for name, (m, opts, fused) in engines.items():
        inst = Instance(device=cuda, mesh=m, mesh_opts=opts)
        inst.catalog.register(t)
        for q, w in zip(queries, want):
            before = rf.ring_fold_fused.launches
            dr.ring_fold.RingFoldCtx = (real_ctx if fused else
                                        functools.partial(real_ctx,
                                                          fused=False))
            try:
                got = inst.sql(q)
            finally:
                dr.ring_fold.RingFoldCtx = real_ctx
            torch.cuda.synchronize()
            info = inst.query_engine.last_range
            launched = rf.ring_fold_fused.launches - before
            assert (launched > 0) == (name == "fused"
                                      and info["comm_bytes"] > 0), (name, q)
            if name in ("fused", "hops"):
                assert info["ring_form"] == name
            assert got.names == w.names and got.num_rows == w.num_rows > 0
            for a, b in zip(got.cols, w.cols):
                assert np.array_equal(a.valid_mask, b.valid_mask), (name, q)
                assert np.array_equal(np.asarray(a.values),
                                      np.asarray(b.values)), (name, q)


def _runs(rng, n=300_000, n_sid=500):
    f = rng.standard_normal(n)
    f[rng.random(n) < 0.01] = np.nan
    return ColumnarRows(
        sid=rng.integers(0, n_sid, n).astype(np.int32),
        ts=rng.integers(0, 3000, n).astype(np.int64) * 1000,
        seq=np.arange(n, dtype=np.uint64),
        op=((rng.random(n) < 0.02) * OP_DELETE).astype(np.uint8),
        fields={"f": f, "k": rng.integers(-2**62, 2**62, n)},
        field_valid={"f": rng.random(n) > 0.1, "k": rng.random(n) > 0.1},
    )


@pytest.mark.parametrize("mode", ["last_row", "last_non_null"])
@pytest.mark.parametrize("kernels", ["auto", "off"])
def test_merge_rows_on_cuda_matches_host(cuda, mode, kernels):
    rows = _runs(np.random.default_rng(7))
    out, path = dm.merge_rows(rows, merge_mode=mode, drop_deletes=True,
                              device=cuda, kernels=kernels, verify=True)
    assert path == ("fused" if kernels == "auto" else "device")
    host = dm.host_merge(rows, merge_mode=mode, drop_deletes=True)
    dm._assert_identical(out, host)


def test_range_queries_on_cuda_match_cpu(cuda):
    rng = np.random.default_rng(3)
    t = Table("cpu", ts_name="ts", tag_names=["hostname", "region"],
              fields=["u"])
    hosts = np.array([f"h{i}" for i in range(200)])
    regions = np.array(["a", "b", "c"])[rng.integers(0, 3, 200)]
    ts = np.tile(np.arange(1440) * 10_000, 200)
    hi = np.repeat(np.arange(200), 1440)
    t.write({"hostname": hosts[hi], "region": regions[hi]}, ts,
            {"u": rng.random(len(ts)) * 100})
    t.compact(device=cuda, verify=True, device_min_rows=1,
              kernel_min_rows=1)
    ops = ["count", "sum", "min", "max", "mean", "stddev_samp",
           "first_value", "last_value"]
    plan = SelectPlan(
        kind="range", keys=[KeySpec("__key_0", Column("region"), "region")],
        range_items=[RangeItemSpec(f"__r_{i}", op, Column("u"), 7_200_000)
                     for i, op in enumerate(ops)],
        post_items=[(Column("__ts"), "ts"), (Column("__key_0"), "region")]
        + [(Column(f"__r_{i}"), op) for i, op in enumerate(ops)],
        align_ms=3_600_000,
    )
    got = QueryEngine(device=cuda).execute(plan, t)
    want = QueryEngine(device="cpu").execute(plan, t)
    assert got.names == want.names and got.num_rows == want.num_rows > 0
    for a, b in zip(got.cols, want.cols):
        assert np.array_equal(a.valid_mask, b.valid_mask)
        assert np.array_equal(a.values, b.values)
    # four shards on the one card: the one-launch ring kernels (never the
    # hop combines) and the gather twin
    low = {"shard_min_series": 1, "pallas_min_series": 1}
    for kernels, program in (("auto", "sharded_ring"),
                             ("off", "sharded_gather")):
        eng = QueryEngine(device=cuda, mesh=make_mesh([cuda] * 4),
                          mesh_opts=MeshOptions(pallas_kernels=kernels,
                                                **low))
        before = (rf.ring_pext_fused.launches, rf.extreme.launches)
        sharded = eng.execute(plan, t)
        assert eng.last_range["program"] == program
        assert (rf.ring_pext_fused.launches > before[0]) == (
            kernels == "auto")
        assert rf.extreme.launches == before[1]
        for a, b in zip(sharded.cols, want.cols):
            assert np.array_equal(a.valid_mask, b.valid_mask)
            assert np.array_equal(a.values, b.values)


def _candidates(rng, j, width, *, sort=True, ties=True):
    """(J, width) candidate planes; tie-heavy keys from a small value set
    (with -inf fills and both zeros) or continuous keys; values with NaN
    payloads and -0.0."""
    shape = (j, width)
    if ties:
        key = rng.choice(np.array([2.0, 1.0, 0.0, -0.0, -1.0, -np.inf],
                                  np.float32), shape)
    else:
        key = rng.standard_normal(shape).astype(np.float32)
    if sort:
        key = -np.sort(-key, axis=1)
    val = _specials(rng, shape)
    idx = rng.integers(0, 2**31 - 1, shape).astype(np.int32)
    pres = rng.random(shape) < 0.8
    return tm.Candidates(*(torch.from_numpy(np.ascontiguousarray(p))
                           for p in (key, val, idx, pres)))


@pytest.mark.parametrize("j,kk,kl,sort,ties", [
    (8, 100, 100, True, True), (8, 100, 100, True, False),
    (8, 5, 5, True, True), (3, 128, 40, True, True),
    (16, 7, 13, False, True), (1, 512, 512, True, True)])
def test_merge_candidates_kernel_matches_plain(cuda, j, kk, kl, sort, ties):
    """Every slot of every plane bit for bit against the plain version,
    sorted inputs or not."""
    rng = np.random.default_rng(j + kk + kl + sort + ties)
    acc = _candidates(rng, j, kk, sort=sort, ties=ties)
    loc = _candidates(rng, j, kl, sort=sort, ties=ties)
    want = tm.merge_candidates(acc, loc)
    before = tm.merge_candidates.launches
    got = tm.merge_candidates(acc.to(cuda), loc.to(cuda))
    torch.cuda.synchronize()
    assert tm.merge_candidates.launches == before + 1
    for w, g in zip(want, got):
        if w.dtype == torch.float32:
            assert torch.equal(_bits32(g), w.view(torch.int32))
        else:
            assert torch.equal(g.cpu(), w)
    plain = tm.merge_candidates_plain(acc.to(cuda), loc.to(cuda))
    for p, g in zip(plain, got):
        assert torch.equal(p, g) or torch.equal(_bits32(p), _bits32(g))


def _edge_ring(rng, ns, j, kl, sort, ties):
    return [_candidates(rng, j, kl, sort=sort, ties=ties) for _ in range(ns)]


def _raw(t):
    """A candidate plane's bits on the CPU (float32 as int32)."""
    t = t.cpu()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("ns,j,k,kl,sort,ties", [
    (4, 8, 100, 100, True, True),          # the PromQL path's shape
    (4, 8, 100, 100, True, False), (4, 8, 100, 40, True, True),
    (2, 3, 128, 128, True, True), (8, 5, 7, 7, False, True),
    (8, 16, 13, 5, False, True), (1, 4, 9, 5, True, True),
    (3, 1, 512, 512, True, True)])
def test_ring_topk_merge_fused_kernel_matches_plain_and_hops(
        cuda, ns, j, k, kl, sort, ties):
    """One launch per ring: every slot of every plane bit for bit against
    the plain version on the card and on the CPU, and against the hop
    chain (ns - 1 merge launches), on the edge inputs of the merge's own
    test (ties, -inf, -0.0, NaN payloads; unsorted too)."""
    rng = np.random.default_rng(ns * 100 + j + k + kl + sort)
    local = _edge_ring(rng, ns, j, kl, sort, ties)
    want = tm.ring_topk_merge_fused(local, k)[0]          # the CPU plain
    dev = [c.to(cuda) for c in local]
    before = (tm.ring_topk_merge_fused.launches, tm.merge_candidates.launches)
    got = tm.ring_topk_merge(dev, k)
    torch.cuda.synchronize()
    assert (tm.ring_topk_merge_fused.launches,
            tm.merge_candidates.launches) == (before[0] + 1, before[1])
    assert len(got) == ns and all(c is got[0] for c in got)
    hops = tm.ring_topk_merge_hops(dev, k)[0]
    plain = tm.ring_topk_merge_fused_plain(dev, k)[0]
    assert tm.merge_candidates.launches == before[1] + ns - 1
    for w, g, h, p in zip(want, got[0], hops, plain):
        assert g.shape == (j, k)
        assert torch.equal(_raw(g), _raw(w)), w.dtype
        assert torch.equal(_raw(g), _raw(h))
        assert torch.equal(_raw(g), _raw(p))


def test_ring_topk_merge_fused_refuses_bad_launches(cuda):
    rng = np.random.default_rng(1)
    local = [c.to(cuda) for c in _edge_ring(rng, 4, 8, 100, True, True)]
    before = tm.ring_topk_merge_fused.launches
    with pytest.raises(ValueError):                   # kl > k
        tm.ring_topk_merge_fused(local, 50)
    with pytest.raises(ValueError):                   # past 1024 threads
        big = [c.to(cuda) for c in _edge_ring(rng, 2, 2, 600, True, True)]
        tm.ring_topk_merge_fused(big, 600)
    with pytest.raises(ValueError):                   # a shard elsewhere
        tm.ring_topk_merge_fused(local[:3] + [local[3].to("cpu")], 100)
    with pytest.raises(ValueError):                   # nine shards
        tm.ring_topk_merge_fused(local * 3, 100)
    with pytest.raises(TypeError):
        tm.ring_topk_merge_fused(
            [local[0]._replace(idx=local[0].idx.long())] + local[1:], 100)
    assert tm.ring_topk_merge_fused.launches == before


def test_topk_launchers_run_on_the_callers_stream(cuda):
    """The merge hop and the one-launch ring launch on the caller's current
    stream: inside torch.cuda.stream(s) they queue behind a sleep and the
    copy of their inputs on s."""
    rng = np.random.default_rng(2)
    host = _edge_ring(rng, 4, 8, 100, True, True)
    want_hop = tm.merge_candidates(host[0], host[1])
    want_ring = tm.ring_topk_merge_fused(host, 100)[0]
    side = torch.cuda.Stream()
    dst = [tm.Candidates(*(torch.zeros_like(p, device=cuda) for p in c))
           for c in host]
    pinned = [tm.Candidates(*(p.pin_memory() for p in c)) for c in host]
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)
        for d, p in zip(dst, pinned):
            for a, b in zip(d, p):
                a.copy_(b, non_blocking=True)
        hop = tm.merge_candidates(dst[0], dst[1])
        ring = tm.ring_topk_merge_fused(dst, 100)[0]
    side.synchronize()
    for got, want in ((hop, want_hop), (ring, want_ring)):
        for g, w in zip(got, want):
            assert torch.equal(_raw(g), _raw(w))


def test_merge_candidates_refuses_bad_launches(cuda):
    rng = np.random.default_rng(0)
    acc = _candidates(rng, 4, 8).to(cuda)
    loc = _candidates(rng, 4, 8).to(cuda)
    before = tm.merge_candidates.launches
    with pytest.raises(TypeError):
        tm.merge_candidates(acc._replace(val=acc.val.double()), loc)
    with pytest.raises(ValueError):
        tm.merge_candidates(acc, loc.to("cpu"))
    big = _candidates(rng, 2, 600).to(cuda)
    with pytest.raises(ValueError):
        tm.merge_candidates(big, big)
    assert tm.merge_candidates.launches == before


def test_promql_on_cuda_matches_cpu(cuda):
    """One device, four ring shards and four gather shards on the card
    against the port on the CPU: aggregates within float32 rounding of
    the CPU run (the card's matrix products add in another order), topk
    winners and values bit-identical; the ring on one card launches the
    one-launch ring topk once per query and the merge hop never."""
    import types

    rng = np.random.default_rng(5)
    n_s, t0 = 5000, 1_700_000_000_000
    table = Table("prom_bench", ts_name="ts", tag_names=["host", "dc"],
                  fields=["greptime_value"])
    tags = {"host": np.array([f"host_{i}" for i in range(n_s)], object),
            "dc": np.array([f"dc{i % 32}" for i in range(n_s)], object)}
    base = np.cumsum(rng.random(n_s))
    for k in range(10):
        table.write(tags, np.full(n_s, t0 + k * 30_000, np.int64),
                    {"greptime_value": base + k * 50.0})
    catalog = CatalogManager()
    catalog.register(table)
    low = {"shard_min_series": 1, "pallas_min_series": 1}

    def engine(device, mesh=None, opts=None):
        return PromEngine(types.SimpleNamespace(
            catalog=catalog, query_engine=QueryEngine(
                device=device, mesh=mesh, mesh_opts=opts, x64=True)))

    engines = {
        "cuda": engine(cuda),
        "ring": engine(cuda, make_mesh([cuda] * 4), MeshOptions(**low)),
        "gather": engine(cuda, make_mesh([cuda] * 4),
                         MeshOptions(pallas_kernels="off", **low)),
    }
    cpu = engine("cpu")
    span = (t0 + 60_000, t0 + 270_000, 30_000)
    for q in ("topk(100, rate(prom_bench[1m]))",
              "bottomk(7, rate(prom_bench[1m]))",
              "sum by (dc) (rate(prom_bench[1m]))"):
        want, _ = cpu.query_range(q, *span)
        for name, eng in engines.items():
            before = (tm.ring_topk_merge_fused.launches,
                      tm.merge_candidates.launches)
            got, _ = eng.query_range(q, *span)
            launched = (tm.ring_topk_merge_fused.launches - before[0],
                        tm.merge_candidates.launches - before[1])
            ring_topk = name == "ring" and q.startswith(("topk", "bottomk"))
            assert launched == ((1 if ring_topk else 0), 0), (name, q)
            assert got.labels == want.labels, (name, q)
            assert np.array_equal(got.present, want.present)
            if q.startswith("sum"):
                np.testing.assert_allclose(got.values, want.values,
                                           rtol=1e-5)
            else:
                assert np.array_equal(got.values, want.values), (name, q)


# ----------------------------------------------------------------------
# G and Gt: the GROUP BY's grouped reduce and its column tree sum
# ----------------------------------------------------------------------

def _same_or_both_nan(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-equal, except that a NaN may be the card's canonical NaN on one
    side (ROADMAP C2): NaN positions must agree."""
    a, b = a.cpu(), b.cpu()
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    return torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32))


def _groupby_input(rng, n, gb, edge):
    v = (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n)).astype(
        np.float32)
    mask = rng.random(n) > 0.15
    gid = rng.integers(0, max(gb - 2, 1), n).astype(np.int32)  # empty groups
    if edge and gb > 2:
        k = rng.choice(n, 64, replace=False)
        v[k] = np.array([0xFFC00001, 0x7FC00002, 0xFF800000, 0x7F800000,
                         0x80000000, 0x00000000, 0x7FC00000, 0x80000000]
                        * 8, np.uint32).view(np.float32)
        mask[gid == 1] = False             # an all-masked group
    gid[~mask] = 0                         # padding: never group 0
    return v, mask, gid


# run lengths of the series-ordered layout: around a warp's 32 rows, and
# runs of one series (a TSBS host holds ~4,300 rows)
_RUNS = (1, 31, 32, 33, 64, 65, 4096)


def _runs_gid(rng, live, ids):
    """Group ids of `live` rows in series order: contiguous runs of the
    lengths in _RUNS (4096 and up to 500 more), in random order, each run
    the next id of `ids` (runs cross row-block boundaries as they fall)."""
    out, filled, k = [], 0, 0
    while filled < live:
        ln = int(rng.choice(_RUNS))
        ln += int(rng.integers(0, 500)) if ln == 4096 else 0
        ln = min(ln, live - filled)
        out.append(np.full(ln, ids[k % len(ids)], np.int32))
        filled += ln
        k += 1
    return np.concatenate(out)


def _plant_mixed(rng, gid, mask, n, blocks):
    """Segments of chosen lengths in the first rows of chosen row blocks
    (warp = 32 consecutive blocks of one group): group 2's first warp holds
    a long segment (300 rows) beside short ones (5 and 40), group 3's first
    several long ones (600 rows in each of blocks 4-6), group 4's first one
    of exactly the walk's threshold (gr._WARP_ROWS rows, block 7) and its
    second warp one just below it (block 40), among the random ids' short
    segments (~15 rows). The planted groups take no other row."""
    from greptimedb_tpu_torch.parallel.kernels import grouped_reduce as gr

    per = -(-n // blocks)
    if blocks < 41 or per < 600:
        raise ValueError("the mixed layout needs 41 blocks of 600 rows")
    free = ~np.isin(gid, (2, 3, 4))
    gid[~free] = rng.choice(np.array([0, 5]), int((~free).sum()))
    for g, b, ln in ((2, 0, 300), (2, 1, 5), (2, 2, 40), (3, 4, 600),
                     (3, 5, 600), (3, 6, 600), (4, 7, gr._WARP_ROWS),
                     (4, 40, gr._WARP_ROWS - 1)):
        gid[b * per:b * per + ln] = g
        mask[b * per:b * per + ln] = True


def _layout_input(rng, n, blocks, gb, layout, edge=True):
    """v, mask, gid of n rows: "random" draws each row's group uniformly
    (segments of a few rows), "runs" puts the rows in series order (group
    ids in contiguous runs, _runs_gid) with the padding rows (mask False,
    gid 0) after the live ones, so the last row blocks are empty, and
    "mixed" plants chosen segment lengths among random ids
    (_plant_mixed). The last two groups stay empty; with `edge`, values
    carry NaN of both signs, +-0 and +-inf, and group 1 is all masked."""
    v, mask, gid = _groupby_input(rng, n, gb, edge)
    ids = np.arange(max(gb - 2, 1), dtype=np.int32)
    if layout == "runs":
        live = n - n // 7
        gid = np.zeros(n, np.int32)
        gid[:live] = _runs_gid(rng, live, ids)
        mask[live:] = False
    elif layout == "mixed":
        _plant_mixed(rng, gid, mask, n, blocks)
    elif layout != "random":
        raise ValueError(layout)
    if edge and gb > 2:
        mask[gid == 1] = False
    gid[~mask] = 0
    return v, mask, gid


_G_SHAPES = [(1 << 17, 8, 16, True), (1 << 17, 256, 4096, True),
             (1 << 17, 65536, 16, True), (100_003, 256, 64, True),
             (50_000, 8, 1, False), (1 << 20, 256, 9, False),
             (1 << 17, 8, 32768, True)]   # int32 member keys past int16


@pytest.mark.parametrize("layout,n,blocks,gb,edge", [
    (layout, *shape) for layout in ("random", "runs") for shape in _G_SHAPES
] + [("mixed", 1 << 18, 256, 64, True), ("mixed", 1 << 20, 1024, 64, True)])
def test_grouped_block_reduce_kernel_matches_plain(cuda, layout, n, blocks,
                                                   gb, edge):
    from greptimedb_tpu_torch.parallel.kernels import grouped_reduce as gr

    rng = np.random.default_rng(n + blocks + gb)
    v, mask, gid = _layout_input(rng, n, blocks, gb, layout, edge)
    members = gr.group_members(torch.from_numpy(gid).to(cuda),
                               torch.from_numpy(mask).to(cuda), blocks, gb)
    cpu_members = gr.group_members(torch.from_numpy(gid),
                                   torch.from_numpy(mask), blocks, gb)
    assert torch.equal(members.ptr.cpu(), cpu_members.ptr)
    assert torch.equal(members.perm.cpu()[:int(mask.sum())],
                       cpu_members.perm[:int(mask.sum())])
    # either sort's key type (int16 up to gb 32767, then int32) gives the
    # stable order of the int32 keys
    live = int(mask.sum())
    perm = np.argsort(np.where(mask, gid, gb), kind="stable")
    assert np.array_equal(members.perm.cpu().numpy()[:live], perm[:live])
    x = torch.from_numpy(v).to(cuda)
    for form in ("sum", "max", "min"):
        before = gr.grouped_block_reduce.launches
        got = gr.grouped_block_reduce(x, members, form)
        torch.cuda.synchronize()
        assert gr.grouped_block_reduce.launches == before + 1
        plain = gr.grouped_block_reduce_plain(x, members, form)
        assert torch.equal(got.view(torch.int32),
                           plain.view(torch.int32)), form
        want = gr.grouped_block_reduce(torch.from_numpy(v), cpu_members, form)
        if form == "sum":
            assert _same_or_both_nan(got, want), form
        else:   # selections: every bit survives
            assert torch.equal(got.cpu().view(torch.int32),
                               want.view(torch.int32)), form
    # the int32 extremes of the winner stages
    keys = rng.integers(-1, 2**31 - 1, n).astype(np.int32)
    for form in ("max", "min"):
        got = gr.grouped_block_reduce(torch.from_numpy(keys).to(cuda),
                                      members, form)
        want = gr.grouped_block_reduce(torch.from_numpy(keys), cpu_members,
                                       form)
        assert got.dtype == torch.int32
        assert torch.equal(got.cpu(), want), form


@pytest.mark.parametrize("layout,n,blocks,gb,edge", [
    (layout, *shape) for layout in ("random", "runs")
    for shape in _G_SHAPES[:6]] + [("mixed", 1 << 18, 256, 64, True)])
def test_grouped_block_reduce_float64_sum_matches_plain(cuda, layout, n,
                                                        blocks, gb, edge):
    """G's float64 sum form (the PromQL generic engine's vectors) against
    its plain version and the CPU run, on the same layouts as the float32
    form; the values carry bits below float32's. Bit for bit except NaN
    payloads: where two NaNs meet in a float64 add, the kernel's add and
    torch's keep different payloads (ROADMAP C2); NaN positions agree."""
    from greptimedb_tpu_torch.parallel.kernels import grouped_reduce as gr

    rng = np.random.default_rng(n + blocks + gb + 64)
    v, mask, gid = _layout_input(rng, n, blocks, gb, layout, edge)
    v = v.astype(np.float64) * (1 + rng.random(n) * 2.0 ** -30)
    members = gr.group_members(torch.from_numpy(gid).to(cuda),
                               torch.from_numpy(mask).to(cuda), blocks, gb)
    cpu_members = gr.group_members(torch.from_numpy(gid),
                                   torch.from_numpy(mask), blocks, gb)
    x = torch.from_numpy(v).to(cuda)
    before = gr.grouped_block_reduce.launches
    got = gr.grouped_block_reduce(x, members, "sum")
    torch.cuda.synchronize()
    assert gr.grouped_block_reduce.launches == before + 1
    assert got.dtype == torch.float64 and got.shape == (blocks, gb)
    plain = gr.grouped_block_reduce_plain(x, members, "sum")
    assert _same_or_both_nan(got, plain)
    want = gr.grouped_block_reduce(torch.from_numpy(v), cpu_members, "sum")
    assert _same_or_both_nan(got, want)


@pytest.mark.parametrize("rows,cols", [
    (65536, 16), (256, 4096), (8, 3), (1, 5), (4096, 1)] + [
    (rows, cols) for rows in (31, 32, 33, 1025, 32769, 1 << 20)
    for cols in (3, 16)])
def test_column_tree_sum_kernel_matches_plain(cuda, rows, cols):
    from greptimedb_tpu_torch.parallel.kernels import grouped_reduce as gr

    rng = np.random.default_rng(rows + cols)
    x = (rng.standard_normal((rows, cols))
         * 10.0 ** rng.integers(-3, 4, (rows, cols))).astype(np.float32)
    before = gr.column_tree_sum.launches
    got = gr.column_tree_sum(torch.from_numpy(x).to(cuda))
    torch.cuda.synchronize()
    assert gr.column_tree_sum.launches == before + 1
    want = gr.column_tree_sum(torch.from_numpy(x))
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


def test_groupby_on_cuda_matches_cpu(cuda):
    """GROUP BY through Instance.sql on the card (one device; four shards
    on the ring and on the gather twin) against Instance(device="cpu").sql:
    bit for bit (a NaN may be the card's canonical NaN); kernel G launches
    on every engine, the ring forms only on the ring."""
    from greptimedb_tpu_torch.instance import Instance
    from greptimedb_tpu_torch.parallel.kernels import grouped_reduce as gr

    rng = np.random.default_rng(8)
    t = Table("cpu", ts_name="ts", tag_names=["hostname", "region"],
              fields=["u", "v"])
    hosts = np.array([f"host_{i}" for i in range(300)])
    regions = np.array(["a", "b", "c"])[rng.integers(0, 3, 300)]
    ts = np.tile(np.arange(720) * 10_000, 300)
    hi = np.repeat(np.arange(300), 720)
    u = rng.random(len(ts)) * 100
    u[rng.choice(len(u), 5, replace=False)] = np.nan
    t.write({"hostname": hosts[hi], "region": regions[hi]}, ts,
            {"u": u, "v": rng.standard_normal(len(ts))},
            field_valid={"v": rng.random(len(ts)) > 0.1})
    queries = [
        "SELECT hostname, avg(u) FROM cpu GROUP BY hostname",
        "SELECT region, count(*), sum(u), avg(u), min(u), max(v), "
        "first_value(v), last_value(v) FROM cpu GROUP BY region",
        "SELECT region, count(*), stddev_samp(v), var_pop(u) FROM cpu "
        "GROUP BY region",
        "SELECT min(v), max(v), last_value(u) FROM cpu",
    ]
    cpu_inst = Instance(device="cpu")
    cpu_inst.catalog.register(t)
    want = [cpu_inst.sql(q) for q in queries]
    low = {"shard_min_rows": 1, "pallas_min_rows": 1}
    mesh = make_mesh([cuda] * 4)
    engines = {"single": (None, None),
               "ring": (mesh, MeshOptions(**low)),
               "gather": (mesh, MeshOptions(pallas_kernels="off", **low))}
    for name, (m, opts) in engines.items():
        inst = Instance(device=cuda, mesh=m, mesh_opts=opts)
        inst.catalog.register(t)
        for q, w in zip(queries, want):
            before = (gr.grouped_block_reduce.launches,
                      rf.ring_pext_fused.launches)
            got = inst.sql(q)
            torch.cuda.synchronize()
            assert inst.query_engine.last_exec_path == "device"
            note = inst.query_engine.last_reduce
            assert gr.grouped_block_reduce.launches > before[0], (name, q)
            ring_launched = rf.ring_pext_fused.launches > before[1]
            assert ring_launched == (note["program"] == "sharded_ring"
                                     and ("min(" in q or "first" in q
                                          or "last" in q)), (name, q)
            assert got.names == w.names and got.num_rows == w.num_rows > 0
            for a, b in zip(got.cols, w.cols):
                assert np.array_equal(a.valid_mask, b.valid_mask), (name, q)
                va, vb = np.asarray(a.values), np.asarray(b.values)
                if va.dtype == object:
                    assert (va == vb).all(), (name, q)
                    continue
                assert _same_or_both_nan(
                    torch.from_numpy(va.astype(np.float64)),
                    torch.from_numpy(vb.astype(np.float64))), (name, q)


# ----------------------------------------------------------------------
# the rest of PromQL: G in the unblocked aggregation's scatter branch
# ----------------------------------------------------------------------

def test_grouped_block_reduce_at_the_histogram_pod_shape(cuda):
    """G's sum form at the shape of histogram_quantile(0.9, sum by (le,
    pod) (rate(hist_bucket[1m]))) over bench.py's 100,000 bucket series:
    one row block, 100,000 groups of one series, the 31,072 padded series
    left out (the fast path drops their group); kernel and plain version
    bit for bit (also with the padding in, one segment of 31,072 rows),
    and the whole aggregation on the card equal to the CPU's, one G launch
    a step."""
    from greptimedb_tpu_torch.ops import promql as K
    from greptimedb_tpu_torch.parallel.kernels import grouped_reduce as gr

    rng = np.random.default_rng(13)
    s, s_pad, j = 100_000, 1 << 17, 8
    gid = np.full(s_pad, s, np.int32)
    gid[:s] = rng.permutation(s).astype(np.int32)
    vals = (rng.random((s_pad, j)) * 40).astype(np.float32)
    vals[rng.random((s_pad, j)) < 0.01] = -0.0
    pres = rng.random((s_pad, j)) < 0.97
    pres[s:] = False
    gid_t = torch.from_numpy(gid).to(cuda)
    members = K.group_members(gid_t, s + 1, live=gid_t < s)
    col = torch.from_numpy(np.where(pres, vals, 0)[:, 3].copy()).to(cuda)
    for m in (members, K.group_members(gid_t, s + 1)):
        before = gr.grouped_block_reduce.launches
        got = gr.grouped_block_reduce(col, m, "sum")
        torch.cuda.synchronize()
        assert gr.grouped_block_reduce.launches == before + 1
        assert torch.equal(got.view(torch.int32),
                           gr.grouped_block_reduce_plain(
                               col, m, "sum").view(torch.int32))
    before = gr.grouped_block_reduce.launches
    out, ok = K.aggregate_across_series(
        *(torch.from_numpy(a).to(cuda) for a in (vals, pres, gid)), s + 1,
        "sum", members=members)
    torch.cuda.synchronize()
    assert gr.grouped_block_reduce.launches == before + j
    want, want_ok = K.aggregate_across_series(
        *(torch.from_numpy(a) for a in (vals, pres, gid)), s + 1, "sum")
    assert torch.equal(ok.cpu(), want_ok)
    assert torch.equal(out.cpu()[:s].view(torch.int32),
                       want[:s].view(torch.int32))


def test_generic_engine_pod_sums_run_g_in_float64(cuda):
    """The generic engine's instant sum by (le, pod) over 100,000 series of
    one sample each (query h of chip_smoke's phase 10): float64 vectors,
    the scatter branch, one G launch, the same bits as the CPU."""
    from greptimedb_tpu_torch.ops import promql as K
    from greptimedb_tpu_torch.parallel.kernels import grouped_reduce as gr

    rng = np.random.default_rng(14)
    s = 100_000
    gid = rng.permutation(s).astype(np.int32)
    vals = rng.random((s, 1)) * 40
    vals[rng.random((s, 1)) < 0.01] = -0.0
    pres = rng.random((s, 1)) < 0.97
    assert not K.uses_matmul("sum", s, s)
    before = gr.grouped_block_reduce.launches
    out, ok = K.aggregate_across_series(
        *(torch.from_numpy(a).to(cuda) for a in (vals, pres, gid)), s, "sum")
    torch.cuda.synchronize()
    assert gr.grouped_block_reduce.launches == before + 1
    assert out.dtype == torch.float64
    want, want_ok = K.aggregate_across_series(
        *(torch.from_numpy(a) for a in (vals, pres, gid)), s, "sum")
    assert torch.equal(ok.cpu(), want_ok)
    assert torch.equal(out.cpu().view(torch.int64), want.view(torch.int64))


def test_promql_rest_on_cuda_matches_cpu(cuda):
    """The quantile, linear-fit and Holt-Winters windows, the fast binary
    (every operator; `^` within the card's powf error: CUDA documents
    2 ulp, torch's CPU powf is within 0.57, so 3 ulp), histogram_quantile
    (sum by (le, ...) of 2000 series: the scatter branch through G) and
    the generic engine
    (instant queries off the grid) on one device, four ring shards and
    four gather shards on the card, against the port on the CPU: bit for
    bit where no matrix product adds; max/min by (dc) launch the one-launch
    ring extreme on the ring engine only."""
    import types

    from greptimedb_tpu_torch.parallel.kernels import grouped_reduce as gr

    rng = np.random.default_rng(6)
    t0 = 1_700_000_000_000
    n_s = 5000
    prom = Table("prom_bench", ts_name="ts", tag_names=["host", "dc"],
                 fields=["greptime_value"])
    tags = {"host": np.array([f"host_{i}" for i in range(n_s)], object),
            "dc": np.array([f"dc{i % 32}" for i in range(n_s)], object)}
    for k in range(10):
        prom.write(tags, np.full(n_s, t0 + k * 30_000, np.int64),
                   {"greptime_value": np.cumsum(rng.random(n_s)) + k * 50.0})
    # 2000 bucket series: under 4096 the aggregations take the scatter
    # branch, G's
    pods, les = 400, ["0.05", "0.5", "1", "5", "+Inf"]
    hist = Table("hist_bucket", ts_name="ts", tag_names=["pod", "svc", "le"],
                 fields=["greptime_value"])
    base = np.cumsum(rng.random((pods, len(les))) * 5, axis=1).ravel()
    hcols = {"pod": np.repeat(np.array([f"pod_{i}" for i in range(pods)],
                                       object), len(les)),
             "svc": np.repeat(np.array([f"svc_{i % 7}" for i in range(pods)],
                                       object), len(les)),
             "le": np.tile(np.array(les, object), pods)}
    for k in range(10):
        hist.write(hcols, np.full(len(base), t0 + k * 30_000, np.int64),
                   {"greptime_value": base * (k + 1)})
    catalog = CatalogManager()
    catalog.register(prom)
    catalog.register(hist)
    low = {"shard_min_series": 1, "pallas_min_series": 1}

    def engine(device, mesh=None, opts=None):
        return PromEngine(types.SimpleNamespace(
            catalog=catalog, query_engine=QueryEngine(
                device=device, mesh=mesh, mesh_opts=opts, x64=True)))

    engines = {
        "cuda": engine(cuda),
        "ring": engine(cuda, make_mesh([cuda] * 4), MeshOptions(**low)),
        "gather": engine(cuda, make_mesh([cuda] * 4),
                         MeshOptions(pallas_kernels="off", **low)),
    }
    cpu = engine("cpu")
    span = (t0 + 60_000, t0 + 270_000, 30_000)
    exact = [
        "max by (dc) (deriv(prom_bench[2m]))",
        "min by (dc) (quantile_over_time(0.9, prom_bench[2m]))",
        "topk(5, holt_winters(prom_bench[2m], 0.5, 0.5))",
        "bottomk(5, predict_linear(prom_bench[2m], 600))",
        "topk(5, mad_over_time(prom_bench[2m]))",
        "histogram_quantile(0.9, sum by (le, pod) (rate(hist_bucket[1m])))",
        "histogram_quantile(0.9, sum by (le, svc) (rate(hist_bucket[1m])))",
        "histogram_quantile(0.5, rate(hist_bucket[1m]))",
        "rate(hist_bucket[1m]) > 1",
    ] + [f"last_over_time(prom_bench[1m]) {op} rate(prom_bench[1m])"
         for op in ("+", "-", "*", "/", "%")] + [
        f"rate(prom_bench[1m]) {op} rate(prom_bench[2m])"
        for op in (">", "<", ">=", "<=", "!=", "> bool")] + [
        # the two rates are never equal: == compares a counter's last
        # sample with its window maximum, equal on every series
        "last_over_time(prom_bench[1m]) == max_over_time(prom_bench[1m])"]
    bounded = ["sum by (dc) (rate(prom_bench[1m]) / "
               "last_over_time(prom_bench[1m]))"]
    power = "rate(prom_bench[1m]) ^ rate(prom_bench[2m])"
    for q in exact + bounded + [power]:
        want, _ = cpu.query_range(q, *span)
        assert want.num_series > 0, q
        for name, eng in engines.items():
            before = (rf.ring_pext_fused.launches,
                      gr.grouped_block_reduce.launches)
            got, _ = eng.query_range(q, *span)
            torch.cuda.synchronize()
            assert (rf.ring_pext_fused.launches > before[0]) == (
                name == "ring" and q.startswith(("max by", "min by"))), (
                name, q)
            assert (gr.grouped_block_reduce.launches > before[1]) == (
                "sum by (le" in q), (name, q)
            assert got.labels == want.labels, (name, q)
            assert np.array_equal(got.present, want.present), (name, q)
            a = got.values[got.present].astype(np.float32)
            b = want.values[want.present].astype(np.float32)
            if q in exact:
                assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), (
                    name, q)
            elif q == power:
                assert np.all(np.abs(a.astype(np.float64) - b)
                              <= 3 * np.spacing(np.abs(b))), (name, q)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5)
    # the generic engine: an instant query steps 1 s, off the grid
    for q in ("sum by (dc) (rate(prom_bench[1m]))",
              "histogram_quantile(0.9, rate(hist_bucket[1m]))",
              "quantile_over_time(0.5, prom_bench[2m])"):
        want, _ = cpu.query_instant(q, t0 + 270_000)
        got, _ = engines["cuda"].query_instant(q, t0 + 270_000)
        assert got.labels == want.labels and np.array_equal(
            got.present, want.present), q
        np.testing.assert_allclose(got.values, want.values, rtol=1e-12)


def _durable_engine(root, device):
    from greptimedb_tpu_torch.storage.compaction import CompactionOptions
    from greptimedb_tpu_torch.storage.engine import EngineConfig, TsdbEngine

    return TsdbEngine(EngineConfig(
        data_root=str(root), enable_background=False,
        compaction=CompactionOptions(verify_device_merge=True)),
        device=device)


def _durable_meta():
    from greptimedb_tpu_torch.storage.region import (
        RegionMetadata,
        RegionOptions,
    )

    return RegionMetadata(
        region_id=1, table="cpu", tag_names=["hostname"], field_names=["u"],
        ts_name="ts", options=RegionOptions(compaction_trigger_files=2,
                                            compaction_window_ms=3_600_000))


def test_durable_compaction_and_reopen_on_cuda(cuda, tmp_path):
    """A durable region's compaction merges on the card (K1 at the fused
    path's floor, verified against the host merge), and a reopen on the
    card reads back what the CPU reads."""
    rng = np.random.default_rng(12)
    hosts = np.array([f"h{i}" for i in range(400)], object)
    outs = {}
    for name, dev in (("cuda", cuda), ("cpu", "cpu")):
        eng = _durable_engine(tmp_path / name, dev)
        r = eng.create_region(_durable_meta())
        rng = np.random.default_rng(12)
        for k in range(3):
            ts = np.tile(np.arange(720) * 5_000, 400)
            hi = np.repeat(np.arange(400), 720)
            r.write({"hostname": hosts[hi]}, ts,
                    {"u": rng.random(len(ts))})
            r.delete({"hostname": hosts[:50]}, np.full(50, 5_000 * k))
            r.flush()
        before = mg.gather_planes.launches
        assert r.compact()
        if name == "cuda":
            assert max(r.merge_rows_in) >= dm.DEFAULT_KERNEL_MIN_ROWS
            assert "fused" in r.merge_paths
            assert mg.gather_planes.launches > before
        eng.close()
        eng = _durable_engine(tmp_path / name, dev)
        r = eng.open_region(_durable_meta())
        outs[name] = r.scan(["u"])
        eng.close()
    a, b = outs["cuda"], outs["cpu"]
    for k in ("sid", "ts", "seq", "op"):
        assert np.array_equal(getattr(a, k), getattr(b, k))
    assert np.array_equal(a.fields["u"], b.fields["u"])


def test_server_path_on_cuda_matches_cpu(cuda, tmp_path):
    """The standalone server on the card: line protocol over HTTP, DELETE,
    flush and compaction over /v1/sql (K1 in the merge), Q2 as SQL (K2),
    GROUP BY (G) and a PromQL range query, every answer equal to a CPU
    Standalone fed the same payloads in process; then remote write and
    read, and the answers after a reopen."""
    import json
    import urllib.parse
    import urllib.request

    from greptimedb_tpu_torch.instance import Standalone
    from greptimedb_tpu_torch.parallel.kernels import grouped_reduce as gr
    from greptimedb_tpu_torch.servers import http, influx
    from greptimedb_tpu_torch.storage.device_merge import (
        DEFAULT_KERNEL_MIN_ROWS,
    )

    rng = np.random.default_rng(5)
    hosts, steps = 800, 360
    lines = []
    for k in range(steps):
        for h in range(hosts):
            lines.append(f"cpu,hostname=host_{h},region=r{h % 7} "
                         f"u={float(rng.random() * 100)!r},"
                         f"s={float(rng.random())!r} {k * 10_000}")
    card = Standalone(str(tmp_path / "card"), device=cuda)
    cpu = Standalone(str(tmp_path / "cpu"), device="cpu")
    srv = http.HttpServer(card, port=0).start()

    def post(path, data):
        req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}",
                                     data=data)
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read()

    def sql(text):
        status, body = post("/v1/sql", urllib.parse.urlencode(
            {"sql": text}).encode())
        assert status == 200
        doc = json.loads(body)
        doc.pop("execution_time_ms")
        return doc

    def both(text):
        got = sql(text)
        want = json.loads(json.dumps({"output": [
            http.result_to_json(cpu.sql(text))]}))
        assert got["output"][-1] == want["output"][-1], text
        return got

    try:
        create = ("CREATE TABLE cpu (ts TIMESTAMP TIME INDEX, hostname "
                  "STRING, region STRING, u DOUBLE, s DOUBLE, "
                  "PRIMARY KEY (hostname, region))")
        sql(create)
        cpu.sql(create)
        for i in range(0, len(lines), 40_000):
            body = "\n".join(lines[i:i + 40_000])
            assert post("/v1/influxdb/write?precision=ms",
                        body.encode())[0] == 204
            influx.write_lines(cpu, body, precision="ms")
            for stmt in ("ADMIN flush_table('cpu')",):
                sql(stmt)
                cpu.sql(stmt)
        delete = ("DELETE FROM cpu WHERE hostname IN ('host_3', 'host_9') "
                  "AND ts < 600000")
        sql(delete)
        cpu.sql(delete)
        k1 = mg.gather_planes.launches
        for stmt in ("ADMIN flush_table('cpu')",
                     "ADMIN compact_table('cpu')"):
            sql(stmt)
            cpu.sql(stmt)
        region = card.catalog.table("public", "cpu").region
        big = [n for n in region.merge_rows_in
               if n >= DEFAULT_KERNEL_MIN_ROWS]
        assert big and mg.gather_planes.launches - k1 >= len(big)
        k2, g = rf.blocked_fold_sum.launches, gr.grouped_block_reduce.launches
        q2 = ("SELECT ts, region, count(u) RANGE '2h', sum(u) RANGE '2h', "
              "min(u) RANGE '2h', max(u) RANGE '2h' FROM cpu ALIGN '1h' "
              "BY (region)")
        both(q2)
        assert rf.blocked_fold_sum.launches > k2
        both("SELECT hostname, avg(u), max(s) FROM cpu GROUP BY hostname")
        assert gr.grouped_block_reduce.launches > g
        both("SELECT count(*) FROM cpu")
        q = urllib.parse.urlencode({
            "query": 'max by (region) (rate(cpu{__field__="u"}[1m]))',
            "start": 0, "end": 3600, "step": 60})
        req = f"http://127.0.0.1:{srv.port}/v1/prometheus/api/v1/" \
              f"query_range?{q}"
        with urllib.request.urlopen(req, timeout=300) as r:
            got = json.load(r)
        from greptimedb_tpu_torch.promql.engine import PromEngine
        want = http._prom_matrix_json(*PromEngine(cpu).query_range(
            'max by (region) (rate(cpu{__field__="u"}[1m]))', 0,
            3_600_000, 60_000))
        assert got == json.loads(json.dumps(want))
        srv.stop()
        card.close()
        card = Standalone(str(tmp_path / "card"), device=cuda)
        srv = http.HttpServer(card, port=0).start()
        both(q2)
    finally:
        srv.stop()
        card.close()
        cpu.close()


# ----------------------------------------------------------------------
# flows: G's float64 max/min form, the device flow state
# ----------------------------------------------------------------------

_EDGE64 = np.array([0xFFF8000000000001, 0x7FF8000000000002,
                    0xFFF0000000000000, 0x7FF0000000000000,
                    0x8000000000000000, 0x0000000000000000,
                    0x7FF8000000000000, 0x8000000000000000], np.uint64)


@pytest.mark.parametrize("layout,n,blocks,gb,edge", [
    (layout, *shape) for layout in ("random", "runs")
    for shape in _G_SHAPES[:6]] + [
        ("random", 10_000, 1, 65536, True),     # the flow's shape
        ("runs", 10_000, 1, 1024, True), ("random", 777, 1, 4096, True),
        ("runs", 1 << 17, 1, 16, True), ("random", 1 << 17, 8, 4096, True),
        ("mixed", 1 << 18, 256, 64, True)])
def test_grouped_block_reduce_float64_extreme_matches_plain(
        cuda, layout, n, blocks, gb, edge):
    """G's float64 max/min form (the flow state's min/max in x64 mode)
    against its plain version and the CPU run, bit for bit: the extremes
    are selections, so NaN payloads of both signs, +-0.0 and +-inf pass
    through as XLA's maximum/minimum pick them. Ragged groups (random and
    series-ordered ids, planted segment lengths), one row block (the
    flow's) and several."""
    from greptimedb_tpu_torch.parallel.kernels import grouped_reduce as gr

    rng = np.random.default_rng(n + blocks + gb + 128)
    _, mask, gid = _layout_input(rng, n, blocks, gb, layout, edge)
    v = rng.standard_normal(n) * 10.0 ** rng.integers(-300, 300, n)
    if edge:
        k = rng.choice(n, min(n, 64), replace=False)
        v[k] = np.resize(_EDGE64, len(k)).view(np.float64)
    members = gr.group_members(torch.from_numpy(gid).to(cuda),
                               torch.from_numpy(mask).to(cuda), blocks, gb)
    cpu_members = gr.group_members(torch.from_numpy(gid),
                                   torch.from_numpy(mask), blocks, gb)
    x = torch.from_numpy(v).to(cuda)
    for form in ("max", "min"):
        before = gr.grouped_block_reduce.launches
        got = gr.grouped_block_reduce(x, members, form)
        torch.cuda.synchronize()
        assert gr.grouped_block_reduce.launches == before + 1
        assert got.dtype == torch.float64 and got.shape == (gb,)
        plain = gr.grouped_block_reduce_plain(x, members, form)
        assert torch.equal(got.view(torch.int64), plain.view(torch.int64))
        want = gr.grouped_block_reduce(torch.from_numpy(v), cpu_members,
                                       form)
        assert torch.equal(got.cpu().view(torch.int64),
                           want.view(torch.int64)), form


_FLOW_DDL = ("CREATE TABLE cpu (hostname STRING, region STRING, "
             "usage_user DOUBLE, usage_system DOUBLE, ts TIMESTAMP TIME "
             "INDEX, PRIMARY KEY (hostname, region))")
_FLOWS = (
    "CREATE FLOW f_avg SINK TO f_avg_out AS SELECT hostname, "
    "date_bin('1 hour', ts) AS hour, avg(usage_user) AS a, "
    "max(usage_user) AS m, sum(usage_system) AS s FROM cpu "
    "GROUP BY hostname, hour",
    "CREATE FLOW f_stats SINK TO f_stats_out AS SELECT hostname, "
    "date_bin('1 hour', ts) AS hour, count(usage_user) AS n, "
    "min(usage_user) AS lo, stddev_samp(usage_user) AS sd, "
    "var_pop(usage_system) AS vp, "
    "first_value(usage_user ORDER BY ts) AS fv, "
    "last_value(usage_user ORDER BY ts) AS lv FROM cpu "
    "GROUP BY hostname, hour",
)


def _flow_deltas(seed, hosts=300, steps=40, per=2000):
    """TSBS-like rows (hosts x steps at 10 s, host-major, two fields, some
    nulls, equal timestamps across hosts) cut into deltas of `per` rows."""
    rng = np.random.default_rng(seed)
    names = np.asarray([f"host_{i}" for i in range(hosts)], object)
    hi = np.repeat(np.arange(hosts), steps)
    ts = np.tile(np.arange(steps, dtype=np.int64) * 10_000 + 3_590_000,
                 hosts)
    u = (rng.random(len(ts)) * 100.0).astype(np.float32).astype(np.float64)
    s = rng.normal(50.0, 5.0, len(ts))
    sv = rng.random(len(ts)) > 0.05
    for a in range(0, len(ts), per):
        b = min(a + per, len(ts))
        data = {"hostname": names[hi[a:b]],
                "region": np.asarray([f"r{i % 3}" for i in hi[a:b]],
                                     object),
                "ts": ts[a:b], "usage_user": u[a:b], "usage_system": s[a:b]}
        valid = {k: np.ones(b - a, bool) for k in data}
        valid["usage_system"] = sv[a:b]
        yield data, valid


def _flow_standalone(root, device, x64, tick_s=3600):
    from greptimedb_tpu_torch.instance import Standalone

    inst = Standalone(str(root), device=device, x64=x64, warm_start=False)
    inst.enable_flows(tick_interval_s=tick_s)
    inst.sql(_FLOW_DDL)
    for sql in _FLOWS:
        inst.sql(sql)
    return inst


def _write_delta(inst, data, valid):
    t = inst.catalog.table("public", "cpu")
    inst._write_columns(t, data, valid)
    inst._notify_flows("public", "cpu", t, data, valid)


def _same_flow_state(a, b):
    assert a.capacity == b.capacity and a.key_rows() == b.key_rows()
    for i, (x, y) in enumerate(zip(a.state, b.state)):
        assert x.dtype == y.dtype
        assert torch.equal(x.cpu().view(torch.uint8),
                           y.cpu().view(torch.uint8)), f"slot {i}"


def _same_sinks(a, b):
    for sink, order in (("f_avg_out", "hostname, hour"),
                        ("f_stats_out", "hostname, hour")):
        ra = a.sql(f"SELECT * FROM {sink} ORDER BY {order}")
        rb = b.sql(f"SELECT * FROM {sink} ORDER BY {order}")
        assert ra.names == rb.names and ra.num_rows == rb.num_rows > 0
        for name, ca, cb in zip(ra.names, ra.cols, rb.cols):
            if name == "update_at":
                continue
            va, vb = np.asarray(ca.values), np.asarray(cb.values)
            if va.dtype.kind == "f":
                va, vb = va.view(np.uint64), vb.view(np.uint64)
            assert np.array_equal(va, vb), (sink, name)
            assert np.array_equal(ca.valid_mask, cb.valid_mask), name


@pytest.mark.parametrize("x64", [False, True], ids=["f32", "x64"])
def test_flow_on_cuda_matches_cpu(cuda, tmp_path, x64):
    """Flow deltas, a tick and the finalize on the card equal the same on
    the CPU (G's plain versions), bit for bit: every state slot and every
    sink cell; float32 slots by default, float64 with x64 (G's float64
    sum and min/max forms). Every delta launches G; nothing fails and
    nothing demotes."""
    from greptimedb_tpu_torch.parallel.kernels import grouped_reduce as gr

    card = _flow_standalone(tmp_path / "card", cuda, x64)
    cpu = _flow_standalone(tmp_path / "cpu", "cpu", x64)
    try:
        for k, (data, valid) in enumerate(_flow_deltas(3)):
            before = gr.grouped_block_reduce.launches
            _write_delta(card, data, valid)
            torch.cuda.synchronize()
            assert gr.grouped_block_reduce.launches > before
            _write_delta(cpu, data, valid)
            if k == 2:
                card.flows.flush_all()
                cpu.flows.flush_all()
        for name in ("f_avg", "f_stats"):
            a = card.flows.maybe_flow(name).device_state
            b = cpu.flows.maybe_flow(name).device_state
            assert a is not None and b is not None
            assert all(t.is_cuda for t in a.state)
            assert {t.dtype for t in a.state if t.is_floating_point()} == {
                torch.float64 if x64 else torch.float32}
            _same_flow_state(a, b)
        card.flows.flush_all()
        cpu.flows.flush_all()
        _same_sinks(card, cpu)
        for inst in (card, cpu):
            assert inst.flows.failed_applies == inst.flows.failed_ticks == 0
    finally:
        card.close()
        cpu.close()


def test_flow_tick_thread_beside_writes_on_cuda(cuda, tmp_path):
    """The tick thread finalizes on the card while a writer folds deltas
    in: a snapshot taken for a tick stays intact under later deltas (the
    state is never written in place), and after the last tick the sinks
    and states equal a CPU run fed the same deltas with manual ticks."""
    import time

    card = _flow_standalone(tmp_path / "card", cuda, False, tick_s=0.005)
    cpu = _flow_standalone(tmp_path / "cpu", "cpu", False)
    try:
        deltas = list(_flow_deltas(4))
        _write_delta(card, *deltas[0])
        _write_delta(cpu, *deltas[0])
        flow = card.flows.maybe_flow("f_stats")
        ds = flow.device_state
        with flow.lock:
            snap = (ds.state, ds.capacity, np.arange(ds.num_groups))
        kept = [s.clone() for s in snap[0]]
        ticks = card.flows.ticks
        for data, valid in deltas[1:]:
            _write_delta(card, data, valid)
            _write_delta(cpu, data, valid)
        deadline = time.monotonic() + 30
        while card.flows.ticks < ticks + 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert card.flows.ticks >= ticks + 3, "the tick thread did not run"
        card.flows._stop.set()
        card.flows._ticker.join(timeout=30)
        for s, k in zip(snap[0], kept):
            assert torch.equal(s.view(torch.uint8), k.view(torch.uint8))
        ds.finalize_snapshot(snap)      # still usable after the deltas
        card.flows.flush_all()
        cpu.flows.flush_all()
        for name in ("f_avg", "f_stats"):
            _same_flow_state(card.flows.maybe_flow(name).device_state,
                             cpu.flows.maybe_flow(name).device_state)
        _same_sinks(card, cpu)
        assert card.flows.failed_applies == card.flows.failed_ticks == 0
    finally:
        card.close()
        cpu.close()


# ----------------------------------------------------------------------
# S: the segmented scans, and the window functions that run them
# ----------------------------------------------------------------------

def _scan_inputs(rng, n, form, reset):
    """One form's inputs: values with edge bits (float64: NaN of both
    signs, +-0.0, +-inf; the two-float forms: +-0.0 and large values
    whose hi parts tie) and a reset pattern."""
    from greptimedb_tpu_torch.parallel.kernels import segmented_scan as ss

    if reset == "every_row":
        r = np.ones(n, bool)
    elif reset == "row0_only":
        r = np.zeros(n, bool)
        r[0] = True
    else:
        r = rng.random(n) < 0.01
    if form in ss.TWO_FLOAT:
        v = np.round(rng.standard_normal(n), 1) * 1e6 + rng.integers(
            0, 4, n) * 1e-3
        v[rng.random(n) < 0.05] = -0.0
        hi = v.astype(np.float32)
        lo = (v - hi.astype(np.float64)).astype(np.float32)
        return [hi, lo], r
    v = np.round(rng.standard_normal(n), 1)
    pick = rng.random(n)
    v[pick < 0.02] = np.inf
    v[(pick >= 0.02) & (pick < 0.04)] = -np.inf
    v[(pick >= 0.04) & (pick < 0.06)] = -0.0
    v[(pick >= 0.06) & (pick < 0.08)] = np.nan
    v[(pick >= 0.08) & (pick < 0.10)] = -np.nan
    return [v], r


SCAN_FORMS = [("add", np.int32), ("add", np.int64), ("add", np.float64),
              ("max", np.float64), ("min", np.float64),
              ("comp", np.float32), ("max2", np.float32),
              ("min2", np.float32)]


def _scan_rows(ss, size, form, dtype, cuda):
    """Row count of a named size: the kernel's tile edges, the resident
    form's edge (as many tiles as the card holds blocks at once, and one
    more) and past one block's capacity of totals."""
    if isinstance(size, int):
        return size
    tile = ss.tile_rows()
    grid = ss.resident_tiles(form, torch.from_numpy(np.zeros(
        0, dtype)).dtype, cuda)
    return {"tile-1": tile - 1, "tile": tile, "tile+1": tile + 1,
            "resident": grid * tile, "resident+1": (grid + 1) * tile,
            "totals_past_one_block": tile * (tile + 1) + 5}[size]


@pytest.mark.parametrize("reset", ["random", "every_row", "row0_only"])
@pytest.mark.parametrize("size", [1, 2, "tile-1", "tile", "tile+1", 263_520,
                                  "resident", "resident+1",
                                  "totals_past_one_block"])
@pytest.mark.parametrize("form,dtype", SCAN_FORMS,
                         ids=[f"{f}-{np.dtype(d).name}" for f, d in
                              SCAN_FORMS])
def test_segmented_scan_kernel_matches_plain(cuda, form, dtype, size, reset):
    from greptimedb_tpu_torch.parallel.kernels import segmented_scan as ss

    n = _scan_rows(ss, size, form, dtype, cuda)
    rng = np.random.default_rng(n)
    xs, r = _scan_inputs(rng, n, form, reset)
    if dtype in (np.int32, np.int64):
        info = np.iinfo(dtype)
        xs = [rng.integers(info.min // 4, info.max // 4, n, dtype=dtype)]
    cpu = [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]
    dev = [c.to(cuda) for c in cpu]
    rc = torch.from_numpy(r)
    if n > 10_000_000:
        # the plain version on the card: the same IEEE operations
        want = ss.segmented_scan_plain(form, dev[0], rc.to(cuda),
                                       *dev[1:]).cpu()
    else:
        want = ss.segmented_scan(form, cpu[0], rc, *cpu[1:])
    before = ss.segmented_scan.launches
    got = ss.segmented_scan(form, dev[0], rc.to(cuda), *dev[1:]).cpu()
    assert ss.segmented_scan.launches == before + 1
    w, g = want.numpy(), got.numpy()
    if w.dtype.kind == "f":
        # the card's add returns its canonical NaN (ROADMAP C2): NaN
        # positions, and every other cell's bits
        nan = np.isnan(w)
        assert np.array_equal(nan, np.isnan(g))
        w, g = w[~nan], g[~nan]
        w, g = w.view(np.uint8), g.view(np.uint8)
    assert np.array_equal(w, g)


@pytest.mark.parametrize("size", ["tile", "resident", "resident+1",
                                  "totals_past_one_block"])
def test_segmented_scan_is_one_kernel_launch(cuda, size):
    """Every size is one launch of S's one cooperative kernel, by the
    profiler's count."""
    from torch.profiler import ProfilerActivity, profile

    from greptimedb_tpu_torch.parallel.kernels import segmented_scan as ss

    n = _scan_rows(ss, size, "add", np.float64, cuda)
    x = torch.rand(n, dtype=torch.float64, device=cuda)
    r = torch.rand(n, device=cuda) < 0.001
    ss.segmented_scan("add", x, r)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ss.segmented_scan("add", x, r)
        torch.cuda.synchronize()
    kernels = [(e.key, e.count) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total]
    assert [c for k, c in kernels if "segscan_kernel<" in k] == [1], kernels
    assert len(kernels) == 1, kernels


def test_segmented_scan_refused_launch_raises(cuda, monkeypatch):
    """A grid larger than the card holds at once, or a scratch smaller
    than the totals need, is refused: the wrapper raises with the CUDA
    error, counts no launch and does not give way to the plain version."""
    from greptimedb_tpu_torch.parallel.kernels import segmented_scan as ss

    n = 3 * ss.tile_rows() + 5
    x = torch.rand(n, dtype=torch.float64, device=cuda)
    r = torch.zeros(n, dtype=torch.bool, device=cuda)
    ss.segmented_scan("add", x, r)
    before = ss.segmented_scan.launches
    with monkeypatch.context() as m:
        m.setattr(ss, "GRID", 1 << 24)
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            ss.segmented_scan("add", x, r)
    with monkeypatch.context() as m:
        m.setattr(ss, "_scratch_bytes", lambda *a: 0)
        m.setattr(build, "scratches", {})
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            ss.segmented_scan("add", x, r)
    assert ss.segmented_scan.launches == before
    # the card goes on: the next scan launches and is right
    got = ss.segmented_scan("add", x, r)
    want = ss.segmented_scan_plain("add", x, r)
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))


def test_segmented_scan_extremes_keep_nan_payloads(cuda):
    """The extreme forms select operands, so the card keeps every NaN
    payload as the CPU does."""
    from greptimedb_tpu_torch.parallel.kernels import segmented_scan as ss

    rng = np.random.default_rng(3)
    n = 70_000
    v = rng.standard_normal(n)
    v[rng.random(n) < 0.01] = np.nan
    v[rng.random(n) < 0.01] = -np.nan
    r = rng.random(n) < 0.001
    for form in ("max", "min"):
        want = ss.segmented_scan(form, torch.from_numpy(v),
                                 torch.from_numpy(r))
        got = ss.segmented_scan(form, torch.from_numpy(v).to(cuda),
                                torch.from_numpy(r).to(cuda)).cpu()
        assert torch.equal(want.view(torch.int64), got.view(torch.int64))


def test_window_sql_on_cuda_matches_cpu(cuda, tmp_path, monkeypatch):
    """Running frames (the device path through S) and the sharded ROWS k
    PRECEDING path (four shards on the card) on a CUDA Standalone equal a
    CPU Standalone's, in both x64 modes."""
    from greptimedb_tpu_torch.instance import Standalone
    from greptimedb_tpu_torch.parallel import mesh as M
    from greptimedb_tpu_torch.parallel.kernels import segmented_scan as ss
    from greptimedb_tpu_torch.query import window_fns as W

    monkeypatch.setattr(W, "DEVICE_THRESHOLD", 1000)
    rng = np.random.default_rng(5)
    hosts, steps = 16, 400
    n = hosts * steps
    tags = {"g": np.repeat(np.array([f"g{i}" for i in range(hosts)],
                                    object), steps)}
    ts = np.tile(np.arange(steps, dtype=np.int64) * 1000, hosts)
    vals = {"v": rng.random(n) * 1e6 + rng.random(n) * 1e-3}
    valid = {"v": rng.random(n) >= 0.05}
    running = ("SELECT g, ts, sum(v) OVER (PARTITION BY g ORDER BY ts), "
               "max(v) OVER (PARTITION BY g ORDER BY ts), count(v) OVER "
               "(PARTITION BY g ORDER BY ts), min(v) OVER (ORDER BY ts, g "
               "ROWS UNBOUNDED PRECEDING) FROM w ORDER BY g, ts")
    sliding = ("SELECT g, ts, sum(v) OVER (PARTITION BY g ORDER BY ts ROWS "
               "BETWEEN 5 PRECEDING AND CURRENT ROW), count(v) OVER "
               "(PARTITION BY g ORDER BY ts ROWS 5 PRECEDING) FROM w "
               "ORDER BY g, ts")
    M.reset_for_tests()
    M.configure(M.MeshOptions(enabled=True, axis_size=4, shard_min_rows=1),
                device=cuda)
    try:
        for x64 in (False, True):
            insts = [Standalone(str(tmp_path / f"{d}{x64}"), device=d,
                                x64=x64, warm_start=False)
                     for d in (cuda, "cpu")]
            try:
                for inst in insts:
                    inst.execute_sql("create table w (ts timestamp time "
                                     "index, g string primary key, "
                                     "v double)")
                    inst.catalog.table("public", "w").write(
                        tags, ts, vals, field_valid=valid)
                for sql, path in ((running, "device"),
                                  (sliding, "device_mesh" if x64
                                   else None)):
                    before = ss.segmented_scan.launches
                    card, cpu = (inst.sql(sql) for inst in insts)
                    assert [i.query_engine.last_window_path
                            for i in insts] == [path, path]
                    if sql is running:
                        assert ss.segmented_scan.launches > before
                    for a, b in zip(card.cols, cpu.cols):
                        assert np.array_equal(a.valid_mask, b.valid_mask)
                        assert np.array_equal(np.asarray(a.values),
                                              np.asarray(b.values))
            finally:
                for inst in insts:
                    inst.close()
    finally:
        M.reset_for_tests()


# ----------------------------------------------------------------------
# the relational layer: a GROUP BY over a joined frame through G
# ----------------------------------------------------------------------

def test_join_groupby_on_cuda_matches_cpu(cuda, tmp_path):
    """chip_smoke.py's R1 at a small size: a join of the cpu table with a
    tags table, then GROUP BY datacenter over the joined frame, on a CUDA
    Standalone and a CPU one: bit for bit (names, order, dtypes, values,
    validity); the card launches G and ends on the device path."""
    from greptimedb_tpu_torch.instance import Standalone
    from greptimedb_tpu_torch.parallel.kernels import grouped_reduce as gr

    rng = np.random.default_rng(18)
    hosts, steps = 300, 720
    n = hosts * steps
    tags = {"hostname": np.repeat(np.array(
        [f"host_{i}" for i in range(hosts)], object), steps)}
    ts = np.tile(np.arange(steps, dtype=np.int64) * 10_000, hosts)
    fields = {"usage_user": rng.random(n) * 100,
              "usage_system": rng.random(n) * 100}
    valid = {"usage_system": rng.random(n) > 0.05}
    rows = ", ".join(f"(0, 'host_{i}', 'dc{i % 7}', '{i % 3}')"
                     for i in range(hosts + 5))
    sql = ("SELECT t.datacenter, count(*), avg(c.usage_user), "
           "max(c.usage_system) FROM cpu c JOIN tags t ON c.hostname = "
           "t.hostname WHERE c.ts < 3600000 GROUP BY t.datacenter "
           "ORDER BY t.datacenter")
    insts = [Standalone(str(tmp_path / str(d)), device=d,
                        prefer_device=True, warm_start=False)
             for d in (cuda, "cpu")]
    try:
        for inst in insts:
            inst.execute_sql(
                "CREATE TABLE cpu (ts TIMESTAMP TIME INDEX, hostname STRING "
                "PRIMARY KEY, usage_user DOUBLE, usage_system DOUBLE); "
                "CREATE TABLE tags (ts TIMESTAMP TIME INDEX, hostname STRING "
                "PRIMARY KEY, datacenter STRING, os STRING); "
                f"INSERT INTO tags VALUES {rows}")
            inst.catalog.table("public", "cpu").write(tags, ts, fields,
                                                      field_valid=valid)
        before = gr.grouped_block_reduce.launches
        card = insts[0].sql(sql)
        torch.cuda.synchronize()
        assert gr.grouped_block_reduce.launches > before
        assert insts[0].query_engine.last_exec_path == "device"
        want = insts[1].sql(sql)
        assert card.names == want.names and card.num_rows == want.num_rows
        assert card.column("count(*)").values.tolist() == [
            360 * len(range(d, hosts, 7)) for d in range(7)]
        for a, b in zip(card.cols, want.cols):
            va, vb = np.asarray(a.values), np.asarray(b.values)
            assert va.dtype == vb.dtype
            assert np.array_equal(a.valid_mask, b.valid_mask)
            if va.dtype.kind == "f":
                va, vb = va.view(np.uint8), vb.view(np.uint8)
            assert np.array_equal(va, vb)
    finally:
        for inst in insts:
            inst.close()


# ----------------------------------------------------------------------
# EXPLAIN ANALYZE: which path a statement took on the card
# ----------------------------------------------------------------------

def test_explain_analyze_groupby_on_cuda(cuda, tmp_path):
    """EXPLAIN ANALYZE of a small GROUP BY on a CUDA Standalone: the
    device path (`exec_path_aggregate: device`) through G, the plan lines
    and counts equal to a CPU Standalone's, and the answer of the plain
    query bit for bit."""
    from greptimedb_tpu_torch.instance import Standalone
    from greptimedb_tpu_torch.parallel.kernels import grouped_reduce as gr

    rng = np.random.default_rng(19)
    hosts, steps = 64, 360
    tags = {"hostname": np.repeat(np.array(
        [f"host_{i}" for i in range(hosts)], object), steps)}
    ts = np.tile(np.arange(steps, dtype=np.int64) * 10_000, hosts)
    fields = {"usage_user": rng.random(hosts * steps) * 100}
    sql = ("SELECT hostname, max(usage_user), count(*) FROM cpu "
           "GROUP BY hostname ORDER BY hostname")
    insts = [Standalone(str(tmp_path / str(d)), device=d,
                        prefer_device=True, warm_start=False)
             for d in (cuda, "cpu")]
    try:
        for inst in insts:
            inst.sql("CREATE TABLE cpu (ts TIMESTAMP TIME INDEX, hostname "
                     "STRING PRIMARY KEY, usage_user DOUBLE)")
            inst.catalog.table("public", "cpu").write(tags, ts, fields)
        before = gr.grouped_block_reduce.launches
        lines = [str(v) for v in insts[0].sql(
            f"EXPLAIN ANALYZE {sql}").cols[0].values]
        torch.cuda.synchronize()
        assert gr.grouped_block_reduce.launches > before
        want = [str(v) for v in insts[1].sql(
            f"EXPLAIN ANALYZE {sql}").cols[0].values]
        notes = {ln.strip().split(": ")[0]: ln.strip().split(": ")[1]
                 for ln in lines if ln.startswith("    ")}
        cpu_notes = {ln.strip().split(": ")[0]: ln.strip().split(": ")[1]
                     for ln in want if ln.startswith("    ")}
        assert notes["exec_path_aggregate"] == "device"
        assert set(notes) == set(cpu_notes)
        for k in ("agg_groups", "rows_scanned", "series_total"):
            assert notes[k] == cpu_notes[k]
        assert int(notes["agg_groups"]) == hosts
        head = [ln for ln in lines if not ln.startswith("    ")]
        assert head[:-1] == [ln for ln in want
                             if not ln.startswith("    ")][:-1]
        assert head[-1].startswith(f"  Metrics: rows={hosts} ")
        card, cpu = (inst.sql(sql) for inst in insts)
        for a, b in zip(card.cols, cpu.cols):
            va, vb = np.asarray(a.values), np.asarray(b.values)
            assert va.dtype == vb.dtype
            if va.dtype.kind == "f":
                va, vb = va.view(np.uint8), vb.view(np.uint8)
            assert np.array_equal(va, vb)
    finally:
        for inst in insts:
            inst.close()


# ----------------------------------------------------------------------
# the poll path: query sessions, the result cache and `since` deltas
# ----------------------------------------------------------------------

def _poll_table(rng, hosts=300, steps=720):
    t = Table("cpu", ts_name="ts", tag_names=["hostname", "region"],
              fields=["u", "v"])
    names = np.array([f"host_{i}" for i in range(hosts)])
    regions = np.array(["a", "b", "c"])[rng.integers(0, 3, hosts)]
    ts = np.tile(np.arange(steps) * 10_000, hosts)
    hi = np.repeat(np.arange(hosts), steps)
    t.write({"hostname": names[hi], "region": regions[hi]}, ts,
            {"u": rng.random(len(ts)) * 100, "v": rng.random(len(ts))})
    return t


_POLL_A = ("SELECT ts, region, count(u) RANGE '1h', sum(u) RANGE '1h', "
           "max(v) RANGE '1h' FROM cpu ALIGN '30m' BY (region)")
_POLL_B = ("SELECT ts, region, sum(v) RANGE '2h', min(u) RANGE '1h' FROM "
           "cpu ALIGN '1h' BY (region)")


def _same_result(a, b):
    assert a.names == b.names and a.num_rows == b.num_rows > 0
    for x, y in zip(a.cols, b.cols):
        va, vb = np.asarray(x.values), np.asarray(y.values)
        assert np.array_equal(x.valid_mask, y.valid_mask)
        if va.dtype.kind == "f":
            va, vb = va.view(np.uint8), vb.view(np.uint8)
        assert np.array_equal(va, vb)


def test_session_hit_does_not_alias_on_cuda(cuda):
    """Poll A (K2), run B through the same kernels, poll A again: a session
    hit that launches nothing and answers A's first bits; both equal the
    CPU port."""
    from greptimedb_tpu_torch.instance import Instance
    from greptimedb_tpu_torch.query import sessions

    t = _poll_table(np.random.default_rng(20))
    card, cpu = Instance(device=cuda), Instance(device="cpu")
    for inst in (card, cpu):
        inst.catalog.register(t)
    sessions.global_sessions.clear()
    first = card.sql(_POLL_A)
    eng = card.query_engine
    assert eng.last_session == "miss" and eng.last_exec_path == "device"
    before = rf.blocked_fold_sum.launches
    other = card.sql(_POLL_B)
    torch.cuda.synchronize()
    assert rf.blocked_fold_sum.launches > before
    before = rf.blocked_fold_sum.launches
    again = card.sql(_POLL_A)
    torch.cuda.synchronize()
    assert eng.last_session == "hit"
    assert rf.blocked_fold_sum.launches == before
    _same_result(again, first)
    _same_result(first, cpu.sql(_POLL_A))
    _same_result(other, cpu.sql(_POLL_B))


@pytest.mark.parametrize("by", ["region", "hostname"])
def test_since_delta_reads_back_its_bytes_on_cuda(cuda, by):
    """A `since` poll narrows the resident result on the card: it reads
    back planes x groups x (steps past the cursor) x 4 bytes, and answers
    the full result's rows past the cursor."""
    from greptimedb_tpu_torch.instance import Instance
    from greptimedb_tpu_torch.query import readback
    from greptimedb_tpu_torch.session import QueryContext

    t = _poll_table(np.random.default_rng(21), hosts=64)
    card = Instance(device=cuda)
    card.catalog.register(t)
    q = (f"SELECT ts, {by}, avg(u) RANGE '10m', max(v) RANGE '10m' FROM "
         f"cpu ALIGN '10m' BY ({by})")
    full = card.sql(q)
    f0 = readback.readback_bytes["full"]
    card.sql(q)
    assert card.query_engine.last_session == "hit"
    full_bytes = readback.readback_bytes["full"] - f0
    ts = np.asarray(full.cols[0].values, np.int64)
    steps = np.unique(ts)
    groups = full.num_rows // len(steps)
    planes = full_bytes // (groups * len(steps) * 4)
    assert planes * groups * len(steps) * 4 == full_bytes
    for j0 in (1, len(steps) // 2, len(steps) - 1):
        ctx = QueryContext()
        ctx.extensions["since_ms"] = int(steps[j0 - 1])
        d0 = readback.readback_bytes["delta"]
        delta = card.sql(q, ctx)
        assert readback.readback_bytes["delta"] - d0 == \
            planes * groups * (len(steps) - j0) * 4
        keep = ts > steps[j0 - 1]
        for a, b in zip(delta.cols, full.cols):
            assert np.array_equal(np.asarray(a.values),
                                  np.asarray(b.values)[keep])


def test_result_cache_hit_launches_nothing_on_cuda(cuda, tmp_path):
    """A result-cache hit on a card Standalone: no kernel launch, no byte
    read back, the same answer; an INSERT makes the next poll miss."""
    from greptimedb_tpu_torch.instance import Standalone
    from greptimedb_tpu_torch.parallel.kernels import grouped_reduce as gr
    from greptimedb_tpu_torch.query import readback
    from greptimedb_tpu_torch.query.result_cache import ResultCache

    card = Standalone(str(tmp_path / "card"), device=cuda,
                      prefer_device=True, warm_start=False)
    try:
        card.catalog.register(_poll_table(np.random.default_rng(22)))
        rc = ResultCache.from_options({"enable": True})
        card.result_cache = card.catalog.result_cache = rc
        for q in (_POLL_A, "SELECT hostname, max(u), avg(v) FROM cpu "
                           "GROUP BY hostname ORDER BY hostname"):
            want = card.sql(q)
            counts = (rf.blocked_fold_sum.launches,
                      gr.grouped_block_reduce.launches,
                      dict(readback.readback_bytes))
            h0 = rc.hits
            got = card.sql(q)
            torch.cuda.synchronize()
            assert rc.hits == h0 + 1
            assert (rf.blocked_fold_sum.launches,
                    gr.grouped_block_reduce.launches,
                    dict(readback.readback_bytes)) == counts
            _same_result(got, want)
        m0 = rc.misses
        card.sql("INSERT INTO cpu (ts, hostname, region, u, v) VALUES "
                 "(7200000, 'host_1', 'a', 1.0, 2.0)")
        card.sql(_POLL_A)
        assert rc.misses == m0 + 1
        assert card.query_engine.last_session == "miss"
    finally:
        card.close()


@pytest.mark.parametrize("shards", [1, 4])
def test_device_plane_masks_match_host_mask_on_cuda(cuda, shards):
    """The resident label plane's masks (gather + AND on the card) equal
    the host mask through the secondary index, on one device and on four
    shards of one card; a repeated set uploads nothing."""
    import re

    from greptimedb_tpu_torch.index import device_plane, tag_index
    from greptimedb_tpu_torch.storage.series import SeriesRegistry

    rng = np.random.default_rng(21)
    n, s_pad = 100_003, 1 << 17
    reg = SeriesRegistry(["host", "dc", "os"])
    reg.intern_rows([
        np.asarray([f"host_{i}" for i in range(n)], object),
        np.asarray([f"dc_{v}" for v in rng.integers(0, 8, n)], object),
        np.asarray([f"os_{v}" for v in rng.integers(0, 3, n)], object)])
    device_plane.invalidate()
    devices = [cuda] * shards
    sets = [
        [("dc", "eq", "dc_3")],
        [("dc", "re", re.compile("dc_(1|2)"))],
        [("host", "re", re.compile("host_1.*"))],
        [("dc", "ne", "dc_0"), ("host", "nre", re.compile("host_9.*"))],
        [("os", "in", ["os_0", "os_2"]), ("dc", "nin", ["dc_7"])],
        [("ghost", "eq", "x")],
        [("host", "eq", "nosuch")],
    ]
    for m in sets:
        out = device_plane.matcher_mask_dev(reg, m, s_pad, devices=devices,
                                            num_series=n)
        assert out is not None, m
        masks, any_match = out
        assert len(masks) == shards
        assert all(t.is_cuda and t.dtype == torch.bool for t in masks)
        host = np.zeros(s_pad, bool)
        host[:n] = tag_index.match_mask(reg, m)
        got = torch.cat([t.cpu() for t in masks]).numpy()
        assert np.array_equal(got, host), m
        assert any_match == bool(host.any())
        before = device_plane.stats()
        again = device_plane.matcher_mask_dev(reg, m, s_pad, devices=devices,
                                              num_series=n)
        after = device_plane.stats()
        assert again is out
        assert after["ok_upload_bytes"] == before["ok_upload_bytes"]
        assert after["plane_upload_bytes"] == before["plane_upload_bytes"]
