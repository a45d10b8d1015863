"""Row 6, the fused ring fold (parallel/kernels/ring_fold.ring_fold_fused),
against the JAX package.

The port's plain version runs the kernel's steps literally: per-shard
block partials and seed, then 2(ns - 1) steps over double buffers with
fold turns and latches. It must equal, bit for bit at 2, 4 and 8 shards,
float32 and int32, with NaN payloads, -0.0, ±inf and int32 extremes:

- the JAX package's ring_fold_blocks(..., interpret=True) inside a jitted
  shard_map on the 8 virtual CPU devices (the interpret twin of the Pallas
  _tpu_ring_fold_call, fed the same per-block segment sums as
  device_range._fold_groups.blocked_sum);
- the port's hop ring (ring_fold_blocks: K2's seed, then fold_cont hop by
  hop) and the gather twin (ShardFoldCtx.fold_sum).

The wrapper's input checks and RingFoldCtx's choice of ring form are
checked here too; the kernel itself runs in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from greptimedb_tpu.parallel import kernels as JK
from greptimedb_tpu.parallel import mesh as JM
from greptimedb_tpu_torch.parallel.dist import ShardFoldCtx
from greptimedb_tpu_torch.parallel.kernels import ring_fold as trf

SHARDS = [2, 4, 8]
I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def _bits(a):
    a = np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}") if a.dtype.kind == "f" else a


def _nan_payloads(rng, shape):
    """Quiet NaNs with random payloads and random signs."""
    bits = (rng.integers(0, 2**22, shape) | 0x7FC00000
            | (rng.integers(0, 2, shape) << 31)).astype(np.uint32)
    return bits.view(np.float32)


def _fold_input(rng, ns, s_local, nb, dtype):
    """float32: wide magnitudes, -0.0 (whole cells of it too), ±inf in two
    cells of three and at most one NaN payload per (group, cell) chain in
    the third (NaN + NaN picks a payload by operand order, which no
    reduction order promises); int32: values that wrap past the extremes."""
    if dtype == "i32":
        x = rng.integers(-1000, 1000, (ns, s_local, nb)).astype(np.int32)
        r = rng.random(x.shape)
        x[r < 0.05] = I32_MAX
        x[(r >= 0.05) & (r < 0.1)] = I32_MIN
        return x
    x = (rng.standard_normal((ns, s_local, nb))
         * 10.0 ** rng.integers(-4, 5, (ns, s_local, nb))).astype(np.float32)
    r = rng.random(x.shape)
    x[r < 0.1] = -0.0
    x[:, :, 1] = -0.0                    # a cell of -0.0 only
    inf_cell = (np.arange(nb) % 3 != 0)[None, None, :]
    inf_cell[..., 1] = False
    x[(r >= 0.1) & (r < 0.14) & inf_cell] = np.inf
    x[(r >= 0.14) & (r < 0.18) & inf_cell] = -np.inf
    for c in range(0, nb, 3):
        x[rng.integers(ns), rng.integers(s_local), c] = _nan_payloads(
            rng, 1)[0]
    return x


def _shards(x):
    return [torch.from_numpy(np.ascontiguousarray(x[k]))
            for k in range(len(x))]


def _jax_ring_fold(xf, xi, gid, g):
    """The JAX package's ring fold (interpret twin of the Pallas
    _tpu_ring_fold_call) of (ns, s_local, nb) float32 and int32 states
    over per-shard group ids, in one jitted shard_map: (ns, g, nb) each."""
    ns, s_local, nb = xf.shape
    fb_local = JM.FOLD_BLOCKS // ns
    per = s_local // fb_local

    def body(xf_, xi_, gl):
        ctx = JK.RingFoldCtx(ns, interpret=True)
        bid = jnp.arange(s_local, dtype=jnp.int32) // per
        seg = jnp.where(gl < g, bid * g + gl, fb_local * g)

        def fold(x):
            p = jax.ops.segment_sum(x, seg, num_segments=fb_local * g + 1)
            return ctx.fold_blocks(p[:-1].reshape(fb_local, g, nb))

        return fold(xf_), fold(xi_)

    mesh = JM.make_mesh(jax.devices()[:ns])
    spec = P(JM.AXIS_SHARD)
    args = [jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))
            for a in (xf, xi, gid)]
    outs = jax.jit(shard_map(
        lambda *a: tuple(o[None] for o in body(*[v[0] for v in a])),
        mesh=mesh, in_specs=(spec,) * 3, out_specs=(spec,) * 2,
        check_rep=False,
    ))(*args)
    return [np.asarray(o) for o in outs]


def _assert_every_form_matches(xs, gid, g, wants):
    """The plain fused ring, the wrapper (plain on the CPU), the hop ring
    and the gather twin against the JAX ring's outputs, bit for bit."""
    ns, s_local = gid.shape
    fms = [trf.fold_members(gid[k], g, JM.FOLD_BLOCKS // ns, "cpu")
           for k in range(ns)]
    for x, want in zip(xs, wants):
        got = trf.ring_fold_fused_plain(_shards(x), fms)
        assert len(got) == ns
        stack = np.stack([t.numpy() for t in got])
        assert np.array_equal(_bits(stack), _bits(want)), x.dtype
        for other in (trf.ring_fold_fused(_shards(x), fms),
                      trf.ring_fold_blocks(_shards(x), fms),
                      ShardFoldCtx(ns).fold_sum(_shards(x), fms)):
            assert np.array_equal(
                _bits(np.stack([t.numpy() for t in other])), _bits(want))


@pytest.mark.parametrize("ns", SHARDS)
def test_fused_plain_matches_jax_ring_hop_ring_and_gather(ns):
    rng = np.random.default_rng(100 + ns)
    s_local, nb, g = 16, 24, 3
    per = s_local // (JM.FOLD_BLOCKS // ns)
    xf = _fold_input(rng, ns, s_local, nb, "f32")
    xi = _fold_input(rng, ns, s_local, nb, "i32")
    gid = rng.integers(0, g + 1, (ns, s_local)).astype(np.int32)  # g: off
    gid[0, :per] = 0              # shard 0's first block seeds group 0
    outs = _jax_ring_fold(xf, xi, gid, g)
    _assert_every_form_matches((xf, xi), gid, g, outs)
    # the edges really are in the result: a cell of -0.0 only sums to +0.0
    # (every block partial starts at +0.0), ±inf, NaN payloads, and int32
    # sums that wrapped
    f = outs[0]
    assert np.all(f[..., 1] == 0) and not np.signbit(f[..., 1]).any()
    assert np.isnan(f).any()
    assert np.isposinf(f).any() and np.isneginf(f).any()
    wide = np.stack([xi[gid == grp].astype(np.int64).sum(axis=0)
                     for grp in range(g)])
    assert np.array_equal(outs[1][0], wide.astype(np.int32))
    assert (wide != wide.astype(np.int32)).any()
    assert trf.ring_fold_fused.launches == 0       # the CPU never launches


@pytest.mark.parametrize("ns,s_local,nb,g,groups", [
    (4, 32, 300, 5, "empty"),     # a ragged tile (300 % 256) and groups
                                  # with no member on some shards
    (2, 64, 513, 3, "uneven"),    # 90 % of the series in one group
    (8, 8, 257, 4, "uneven"),     # one cell past a whole tile
], ids=["ragged_empty", "ragged_uneven", "one_cell_past_a_tile"])
def test_fused_plain_on_ragged_tiles_and_uneven_groups(ns, s_local, nb, g,
                                                      groups):
    """Shapes where the kernel's (group, 256-cell chunk) tiles are ragged
    (nb % 256 != 0) and where member lists are empty or very uneven: the
    plain version, the hop ring and the gather twin still equal the JAX
    ring bit for bit."""
    rng = np.random.default_rng(nb + g)
    xf = _fold_input(rng, ns, s_local, nb, "f32")
    xi = _fold_input(rng, ns, s_local, nb, "i32")
    if groups == "empty":
        # groups 1 and 3 never occur; group 4 only on shard 0
        gid = rng.choice(np.array([0, 2, 5], np.int32), (ns, s_local))
        gid[0, -3:] = 4
    else:
        gid = np.where(rng.random((ns, s_local)) < 0.9, 1,
                       rng.integers(0, g + 1, (ns, s_local))).astype(
            np.int32)
    outs = _jax_ring_fold(xf, xi, gid, g)
    _assert_every_form_matches((xf, xi), gid, g, outs)
    if groups == "empty":
        assert np.all(outs[1][:, [1, 3]] == 0)


def test_single_shard_is_the_seed():
    rng = np.random.default_rng(7)
    x = _fold_input(rng, 1, 32, 10, "f32")
    gid = rng.integers(0, 4, 32).astype(np.int32)
    fm = trf.fold_members(gid, 3, 8, "cpu")
    got = trf.ring_fold_fused_plain(_shards(x), [fm])
    want = trf.blocked_fold_sum_plain(torch.from_numpy(x[0]), fm)
    assert torch.equal(got[0].view(torch.int32), want.view(torch.int32))


def test_ring_ctx_picks_the_ring_form_from_the_devices(monkeypatch):
    rng = np.random.default_rng(3)
    ns, g = 4, 2
    x = _fold_input(rng, ns, 8, 6, "f32")
    gid = rng.integers(0, g, (ns, 8)).astype(np.int32)
    fms = [trf.fold_members(gid[k], g, 2, "cpu") for k in range(ns)]
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    assert trf.RingFoldCtx(ns).form([cpu] * ns) == "fused"
    assert trf.RingFoldCtx(ns).form([cuda] * ns) == "fused"
    assert trf.RingFoldCtx(ns).form(
        [torch.device("cuda", k) for k in range(ns)]) == "hops"
    assert trf.RingFoldCtx(ns, fused=False).form([cpu] * ns) == "hops"
    # fused=True asks for nothing more than the default: shards on several
    # devices still take the hop ring
    assert trf.RingFoldCtx(ns, fused=True).form(
        [torch.device("cuda", k) for k in range(ns)]) == "hops"
    seen = []
    monkeypatch.setattr(trf, "ring_fold_fused",
                        lambda a, f: seen.append("fused") or a)
    monkeypatch.setattr(trf, "ring_fold_blocks",
                        lambda a, f: seen.append("hops") or a)
    trf.RingFoldCtx(ns).fold_sum(_shards(x), fms)
    trf.RingFoldCtx(ns, fused=False).fold_sum(_shards(x), fms)
    assert seen == ["fused", "hops"]


def test_fused_wrapper_checks_its_inputs():
    rng = np.random.default_rng(5)
    x = _fold_input(rng, 2, 8, 6, "f32")
    gid = rng.integers(0, 2, (2, 8)).astype(np.int32)
    fms = [trf.fold_members(gid[k], 2, 4, "cpu") for k in range(2)]
    arrs = _shards(x)
    with pytest.raises(ValueError):
        trf.ring_fold_fused(arrs, fms[:1])
    with pytest.raises(TypeError):
        trf.ring_fold_fused([a.double() for a in arrs], fms)
    with pytest.raises(ValueError):            # shards differ in cells
        trf.ring_fold_fused([arrs[0], arrs[1][:, :5].contiguous()], fms)
    with pytest.raises(ValueError):            # shards differ in groups
        trf.ring_fold_fused(arrs, [fms[0], trf.fold_members(
            gid[1], 3, 4, "cpu")])
    with pytest.raises(ValueError):            # more shards than blocks
        trf.ring_fold_fused(arrs * 5, fms * 5)
    assert trf.ring_fold_fused.launches == 0
