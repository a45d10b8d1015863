"""The port's ring combines and mesh planner against the JAX package.

(a) ring_fold_blocks, ring_pext (float32 and int32) and ring_psum_onehot
in their plain versions (CPU tensors, shards as list entries) against the
JAX package's RingFoldCtx hooks inside shard_map on the 8 virtual CPU
devices, with the Pallas ring kernels in interpret mode — at 2, 4 and 8
shards, with NaN payloads, -0.0, ±inf and int32 extremes. Exact, bit for
bit. The gather twin (ShardFoldCtx) and the one-launch ring forms
(ring_pext_fused, ring_psum_onehot_fused) must give the same bits.

(b) decide_mesh_execution/decide_kernel equal to the JAX package's RANGE
gate (kind="range") over a grid of shard counts, series and knobs.
The port's variant names map from the JAX package's: pallas -> ring,
xla -> gather, and "auto" means CUDA tensors (reason no_cuda) where the
JAX package's means a TPU backend (no_tpu).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from greptimedb_tpu.parallel import kernels as JK
from greptimedb_tpu.parallel import mesh as JM
from greptimedb_tpu.parallel.kernels import ring_fold as jrf
from greptimedb_tpu.query import planner as jplanner
from greptimedb_tpu_torch.parallel import mesh as TM
from greptimedb_tpu_torch.parallel.dist import ShardFoldCtx
from greptimedb_tpu_torch.parallel.kernels import ring_fold as trf
from greptimedb_tpu_torch.query import device_range as tdr
from greptimedb_tpu_torch.query import planner as tplanner

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


def _specials(rng, shape, nan_frac=0.1):
    x = (rng.standard_normal(shape) * 10.0 ** rng.integers(-3, 4, shape)
         ).astype(np.float32)
    r = rng.random(shape)
    x[r < 0.08] = 0.0
    x[(r >= 0.08) & (r < 0.16)] = -0.0
    x[(r >= 0.16) & (r < 0.2)] = np.inf
    x[(r >= 0.2) & (r < 0.24)] = -np.inf
    nan = (r >= 0.24) & (r < 0.24 + nan_frac)
    x[nan] = _nan_payloads(rng, shape)[nan]
    return x


def _stack(xs):
    return np.stack([x.numpy() for x in xs])


def _fold_input(rng, ns, s_local, nb, dtype):
    if dtype == "i32":
        return rng.integers(-1000, 1000, (ns, s_local, nb)).astype(np.int32)
    x = (rng.standard_normal((ns, s_local, nb))
         * 10.0 ** rng.integers(-4, 5, (ns, s_local, nb))).astype(np.float32)
    r = rng.random(x.shape)
    x[r < 0.1] = -0.0
    # ±inf in two cells of three; in the third, NaN payloads, at most one
    # per (group, cell) add chain: NaN + NaN picks a payload by operand
    # order, which no reduction order promises
    inf_cell = (np.arange(nb) % 3 != 0)[None, None, :]
    x[(r >= 0.1) & (r < 0.14) & inf_cell] = np.inf
    x[(r >= 0.14) & (r < 0.18) & inf_cell] = -np.inf
    for c in range(0, nb, 3):
        x[rng.integers(ns), rng.integers(s_local), c] = _nan_payloads(
            rng, 1)[0]
    return x


def _ext_input(rng, ns, g, nb, dtype):
    if dtype == "f32":
        return _specials(rng, (ns, g, nb), nan_frac=0.15)
    x = rng.integers(-50, 50, (ns, g, nb)).astype(np.int32)
    r = rng.random(x.shape)
    x[r < 0.1] = I32_MIN
    x[(r >= 0.1) & (r < 0.2)] = I32_MAX
    return x


@pytest.mark.parametrize("ns", SHARDS)
def test_ring_hooks_match_jax_ring(ns):
    """Every hook at ns shards in ONE shard_map program (one compile):

    - fold_blocks: per-shard states -> the JAX side's per-block segment
      sums (device_range._fold_groups.blocked_sum) through
      RingFoldCtx.fold_blocks; the port's ring through K2's seed and
      continuation plain versions; f32 and int32;
    - pext: max and min of f32 (NaN payloads, ±0, ±inf) and int32
      (extremes);
    - psum of a one-hot payload whose winners include NaN payloads, -0.0
      and ±inf;

    each against the port's hop ring, the gather twin and the one-launch
    ring forms."""
    rng = np.random.default_rng(ns)
    s_local, nb, g = 16, 24, 3
    fb_local = JM.FOLD_BLOCKS // ns
    per = s_local // fb_local
    xf = _fold_input(rng, ns, s_local, nb, "f32")
    xi = _fold_input(rng, ns, s_local, nb, "i32")
    gid = rng.integers(0, g + 1, (ns, s_local)).astype(np.int32)  # g: off
    ef = _ext_input(rng, ns, g, nb, "f32")
    ei = _ext_input(rng, ns, g, nb, "i32")
    win = rng.integers(0, ns, (g, nb))
    oh = np.zeros((ns, g, nb), np.float32)
    onehot_vals = _specials(rng, (g, nb), nan_frac=0.2)
    oh[win, np.arange(g)[:, None], np.arange(nb)[None, :]] = onehot_vals
    names = ["fold_f32", "fold_i32", "max_f32", "min_f32", "max_i32",
             "min_i32", "psum"]

    def body(xf_, xi_, gl, ef_, ei_, oh_):
        ctx = JK.RingFoldCtx(ns, interpret=True)
        bid = jnp.arange(s_local, dtype=jnp.int32) // per
        seg = jnp.where(gl < g, bid * g + gl, fb_local * g)

        def fold(x):
            p = jax.ops.segment_sum(x, seg, num_segments=fb_local * g + 1)
            return ctx.fold_blocks(p[:-1].reshape(fb_local, g, nb))

        return (fold(xf_), fold(xi_), ctx.pext(ef_, take_max=True),
                ctx.pext(ef_, take_max=False), ctx.pext(ei_, take_max=True),
                ctx.pext(ei_, take_max=False), ctx.psum(oh_))

    mesh = JM.make_mesh(jax.devices()[:ns])
    spec = P(JM.AXIS_SHARD)
    args = [jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))
            for a in (xf, xi, gid, ef, ei, oh)]
    # jit: one compile of the whole program (eager shard_map dispatches,
    # and compiles, every primitive on its own)
    outs = jax.jit(shard_map(
        lambda *a: tuple(o[None] for o in body(*[v[0] for v in a])),
        mesh=mesh, in_specs=(spec,) * 6, out_specs=(spec,) * 7,
        check_rep=False,
    ))(*args)
    want = dict(zip(names, (np.asarray(o) for o in outs)))

    def shards(x):
        return [torch.from_numpy(x[k]) for k in range(ns)]

    fms = [trf.fold_members(gid[k], g, fb_local, "cpu") for k in range(ns)]
    gather = ShardFoldCtx(ns)
    got, gathered = {}, {}
    for dt, x in (("f32", xf), ("i32", xi)):
        got[f"fold_{dt}"] = trf.ring_fold_blocks(shards(x), fms)
        gathered[f"fold_{dt}"] = gather.fold_sum(shards(x), fms)
    for dt, x in (("f32", ef), ("i32", ei)):
        for tm, nm in ((True, "max"), (False, "min")):
            got[f"{nm}_{dt}"] = trf.ring_pext(shards(x), tm)
            gathered[f"{nm}_{dt}"] = gather.pext(shards(x), tm)
    got["psum"] = trf.ring_psum_onehot(shards(oh))
    gathered["psum"] = gather.psum(shards(oh))
    fused = {"psum": trf.ring_psum_onehot_fused(shards(oh))}
    for dt, x in (("f32", ef), ("i32", ei)):
        for tm, nm in ((True, "max"), (False, "min")):
            fused[f"{nm}_{dt}"] = trf.ring_pext_fused(shards(x), tm)
    for name in names:
        assert np.array_equal(_bits(_stack(got[name])), _bits(want[name])), \
            name
        assert np.array_equal(_bits(_stack(gathered[name])),
                              _bits(want[name])), name
    for name, res in fused.items():
        assert len(res) == ns, name
        assert np.array_equal(_bits(_stack(res)), _bits(want[name])), name
    # a -0.0 winner comes out +0.0, as in psum
    assert not np.signbit(want["psum"][0][onehot_vals == 0]).any()


@pytest.mark.parametrize("take_max", [False, True])
def test_extreme_plain_matches_pallas_ext_kernel(take_max):
    rng = np.random.default_rng(5 + take_max)
    a = _specials(rng, (9, 2160), nan_frac=0.2)
    b = _specials(rng, (9, 2160), nan_frac=0.2)
    kernel = jrf._ext_max_kernel if take_max else jrf._ext_min_kernel
    want = np.asarray(jrf._call2(kernel, jnp.asarray(a), jnp.asarray(b),
                                 interpret=True))
    got = trf.extreme(torch.from_numpy(a), torch.from_numpy(b), take_max)
    assert np.array_equal(_bits(got.numpy()), _bits(want))


def test_fold_from_matches_pallas_cont_kernel():
    rng = np.random.default_rng(31)
    fb, g, nb = 4, 5, 128
    parts = (rng.standard_normal((fb, g, nb))
             * 10.0 ** rng.integers(-4, 5, (fb, g, nb))).astype(np.float32)
    acc = rng.standard_normal((g, nb)).astype(np.float32)
    acc[:, :16] = -0.0
    parts[:, :, :8] = -0.0          # -0.0 + -0.0 ... stays -0.0
    want = np.asarray(jrf._call2(jrf._fold_cont_kernel, jnp.asarray(acc),
                                 jnp.asarray(parts), interpret=True))
    got = trf.fold_from(torch.from_numpy(acc), torch.from_numpy(parts))
    assert np.array_equal(_bits(got.numpy()), _bits(want))
    assert np.signbit(got.numpy()[:, :8]).all()


def test_kernel_wrappers_check_inputs_and_never_launch_on_cpu():
    fm = trf.fold_members(np.zeros(16, np.int32), 1, 2, "cpu")
    arr = torch.ones((16, 4), dtype=torch.int32)
    acc = torch.full((1, 4), 5, dtype=torch.int32)
    assert trf.fold_cont(acc, arr, fm).tolist() == [[21] * 4]
    assert trf.block_partials(arr, fm).tolist() == [[[8] * 4]] * 2
    with pytest.raises(TypeError):
        trf.fold_cont(acc.float(), arr, fm)
    with pytest.raises(ValueError):
        trf.fold_cont(torch.zeros((2, 4), dtype=torch.int32), arr, fm)
    with pytest.raises(TypeError):
        trf.extreme(torch.zeros(3), torch.zeros(3, dtype=torch.float64),
                    True)
    with pytest.raises(ValueError):
        trf.onehot_add(torch.zeros(3), torch.zeros(4))
    with pytest.raises(TypeError):
        trf.onehot_add(torch.zeros(3, dtype=torch.int32),
                       torch.zeros(3, dtype=torch.int32))
    for fn in (trf.blocked_fold_sum, trf.fold_cont, trf.block_partials,
               trf.extreme, trf.onehot_add):
        assert fn.launches == 0


def test_fold_comm_bytes_matches_jax():
    for ns, g, nb, passes in itertools.product([1, 2, 4, 8], [1, 9],
                                               [7, 2160], [1, 3]):
        assert (trf.fold_comm_bytes(ns, g, nb, passes)
                == jrf.fold_comm_bytes(ns, g, nb, passes))


def test_mesh_of_one_device_named_n_times():
    m = TM.make_mesh(["cpu"] * 4)
    assert TM.shard_count(m) == 4 and TM.shard_count(None) == 1
    assert m.shape == {TM.AXIS_SHARD: 4}
    assert all(d == torch.device("cpu") for d in m.devices)
    assert TM.FOLD_BLOCKS == JM.FOLD_BLOCKS


_VARIANT = {"pallas": "ring", "xla": "gather"}
_REASON = {"no_tpu": "no_cuda"}


def _as_port(kernel, reason):
    return _VARIANT[kernel], _REASON.get(reason, reason)


@pytest.mark.parametrize("mode", ["on", "off", "auto"])
def test_planner_decisions_match_jax(mode):
    """The port's RANGE gate against the JAX package's kind="range" over
    shard counts (with an indivisible one), series around the thresholds
    and thresholds, with every op the port lowers; every reason label
    comes up."""
    ops = tuple(sorted(tdr._DEVICE_RANGE_OPS))
    # the port's gate has no op branch: every op it lowers must shard
    assert set(ops) <= jplanner.SHARDABLE_GRID_OPS
    meshes = {None: (None, None)}
    for ns in (2, 3, 4, 8):
        meshes[ns] = (JM.make_mesh(jax.devices()[:ns]),
                      TM.make_mesh(["cpu"] * ns))
    seen = set()
    for ns, series, smin, pmin in itertools.product(
            meshes, [64, 4095, 4096, 8192], [1, 4096], [1, 4096]):
        jmesh, tmesh = meshes[ns]
        jopts = JM.MeshOptions(shard_min_series=smin, pallas_kernels=mode,
                               pallas_min_series=pmin)
        topts = TM.MeshOptions(shard_min_series=smin, pallas_kernels=mode,
                               pallas_min_series=pmin)
        want = jplanner.decide_mesh_execution(
            jmesh, kind="range", series=series, ops=ops, opts=jopts)
        got = tplanner.decide_mesh_execution(tmesh, series=series,
                                             opts=topts)
        case = (ns, series, smin, pmin)
        assert (got.mode, got.reason, got.devices) == (
            want.mode, want.reason, want.devices), case
        assert (got.kernel, got.kernel_reason) == _as_port(
            want.kernel, want.kernel_reason), case
        kernel = tplanner.decide_kernel(series=series, opts=topts,
                                        device="cpu")
        assert kernel == _as_port(*jplanner.decide_kernel(
            "range", series=series, opts=jopts)), case
        seen |= {got.reason, kernel[1]}
    assert {"no_mesh", "mesh_indivisible", "small_grid", "large_grid"} <= seen
    assert {"on": {"ring_fold", "small_grid"}, "off": {"kernels_off"},
            "auto": {"no_cuda"}}[mode] <= seen


def test_auto_means_kernels_for_cuda_tensors():
    opts = TM.MeshOptions()
    cuda = torch.device("cuda")
    assert tplanner.decide_kernel(series=8192, opts=opts,
                                  device=cuda) == ("ring", "ring_fold")
    assert tplanner.decide_kernel(series=8192, opts=opts,
                                  device="cpu") == ("gather", "no_cuda")
    assert tplanner.decide_kernel(series=64, opts=opts,
                                  device=cuda) == ("gather", "small_grid")


@pytest.mark.parametrize("mode", ["on", "off", "auto"])
def test_row_planner_decisions_match_jax(mode):
    """The port's GROUP BY gate (kind="aggregate") against the JAX
    package's over shard counts, rows around the thresholds, thresholds
    and op sets (one that keeps var/stddev on one device); every reason
    label comes up."""
    meshes = {None: (None, None)}
    for ns in (2, 3, 4, 8):
        meshes[ns] = (JM.make_mesh(jax.devices()[:ns]),
                      TM.make_mesh(["cpu"] * ns))
    op_sets = (("count", "mean", "min", "first_value"),
               ("sum", "stddev_samp"))
    seen = set()
    for ns, rows, smin, pmin, ops in itertools.product(
            meshes, [1000, 262143, 262144, 1 << 20], [1, 262144],
            [1, 262144], op_sets):
        jmesh, tmesh = meshes[ns]
        jopts = JM.MeshOptions(shard_min_rows=smin, pallas_kernels=mode,
                               pallas_min_rows=pmin)
        topts = TM.MeshOptions(shard_min_rows=smin, pallas_kernels=mode,
                               pallas_min_rows=pmin)
        want = jplanner.decide_mesh_execution(
            jmesh, kind="aggregate", rows=rows, ops=ops, opts=jopts)
        got = tplanner.decide_mesh_execution(
            tmesh, kind="aggregate", rows=rows, ops=ops, opts=topts)
        case = (ns, rows, smin, pmin, ops)
        assert (got.mode, got.reason, got.devices) == (
            want.mode, want.reason, want.devices), case
        assert (got.kernel, got.kernel_reason) == _as_port(
            want.kernel, want.kernel_reason), case
        seen |= {got.reason, got.kernel_reason}
    assert {"no_mesh", "mesh_indivisible", "small_rowset", "large_rowset",
            "non_decomposable:stddev_samp"} <= seen
    assert {"on": {"ring_fold", "small_rowset"}, "off": {"kernels_off"},
            "auto": {"no_cuda"}}[mode] <= seen
