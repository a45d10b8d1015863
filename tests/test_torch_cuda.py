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


@pytest.mark.parametrize("s,g,dtype", [(4000, 9, torch.float32),
                                       (4000, 9, torch.int32),
                                       (1000, 37, torch.float32),
                                       (60, 4, torch.float32)])
def test_blocked_fold_sum_kernel_matches_plain(cuda, s, g, dtype):
    rng = np.random.default_rng(s + g)
    nb = 257
    if dtype == torch.float32:
        arr = (rng.standard_normal((s, nb))
               * 10.0 ** rng.integers(-3, 4, (s, nb))).astype(np.float32)
        arr[rng.random((s, nb)) < 0.05] = -0.0
    else:
        arr = rng.integers(0, 5, (s, nb)).astype(np.int32)
    gid = rng.integers(0, g, s).astype(np.int32)
    gid[rng.random(s) < 0.1] = g
    fb = 8 if s % 8 == 0 else 1
    want = rf.blocked_fold_sum(torch.from_numpy(arr),
                               rf.fold_members(gid, g, fb, "cpu"))
    fm = rf.fold_members(gid, g, fb, cuda)
    x = torch.from_numpy(arr).to(cuda)
    before = rf.blocked_fold_sum.launches
    got = rf.blocked_fold_sum(x, fm)
    torch.cuda.synchronize()
    assert rf.blocked_fold_sum.launches == before + 1
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    assert torch.equal(rf.blocked_fold_sum_plain(x, fm).view(torch.int32),
                       got.view(torch.int32))


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
