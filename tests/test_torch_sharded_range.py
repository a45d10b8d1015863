"""The series-sharded RANGE path as a whole, against the JAX package.

Data: slice 1's TSBS shape at test size — 64 hosts in 4 regions, 3 h at
10 s, two usage_* fields, hourly runs plus a re-delivery run (10 % of the
hour's keys, new values) and a tombstone run (1 %) per hour.

The JAX side runs QueryEngine(prefer_device=True, mesh=make_mesh(devices[
:4]), mesh_opts=...) with the thresholds of the mesh parity fuzz dropped
to the floor (tests/fuzz/test_fuzz_mesh_parity.py) and the Pallas ring
kernels forced on in interpret mode. Its results do not depend on the
mesh size (bench.py's multichip probe holds them bit-identical across
mesh 1/2/4/8), so one JAX mesh is the reference for every port mesh. The
port runs QueryEngine(device="cpu", mesh=make_mesh(["cpu"] * ns)) with
kernels on (RingFoldCtx, the kernels' plain versions) and off
(ShardFoldCtx, the gather twin), at 2, 4 and 8 shards.

Tolerances against the JAX package are slice 1's (tests/
test_torch_device_range.py): exact, except stddev under the FMA bound and
Q1's disjoint-window sums and means under 2 (w - 1) 2^-24 relative. The
port sharded against the port on one device, and ring against gather, are
bit-identical for every op.
"""

import numpy as np
import pytest
import torch

from greptimedb_tpu.instance import Standalone
from greptimedb_tpu.parallel import mesh as JM
from greptimedb_tpu.query.executor import QueryEngine as JQueryEngine
from greptimedb_tpu.query.planner import plan_select
from greptimedb_tpu.sql.parser import parse_sql
from greptimedb_tpu_torch.catalog.table import Table
from greptimedb_tpu_torch.parallel.kernels import ring_fold
from greptimedb_tpu_torch.parallel.mesh import MeshOptions, make_mesh
from greptimedb_tpu_torch.query import device_range as tdr
from greptimedb_tpu_torch.query.executor import QueryEngine
from greptimedb_tpu_torch.query.planner import plan_from_fields

HOSTS, REGIONS, HOURS, STEP_MS = 64, 4, 3, 10_000
FIELDS = ["usage_user", "usage_system"]
TAGS = ["hostname", "region"]
HOUR_MS = 3_600_000
U = 2.0 ** -24
SHARDS = [2, 4, 8]
JAX_SHARDS = 4

Q1 = ("SELECT ts, hostname, "
      + ", ".join(f"avg({f}) RANGE '1h'" for f in FIELDS)
      + " FROM cpu ALIGN '1h' BY (hostname)")
Q2_OPS = ["count", "sum", "min", "max", "avg", "stddev_samp",
          "first_value", "last_value"]
Q2 = ("SELECT ts, region, "
      + ", ".join(f"{op}(usage_user) RANGE '2h'" for op in Q2_OPS)
      + " FROM cpu ALIGN '1h' BY (region)")
QUERIES = {"q1_double_groupby_all": (Q1, 360), "q2_by_region": (Q2, 720)}

# the JAX package's sharded legs, thresholds at the floor so 64 hosts shard
JAX_KERNEL = JM.MeshOptions(shard_min_series=1, shard_min_rows=1,
                            pallas_kernels="on", pallas_min_series=1,
                            pallas_min_rows=1)
PORT_OPTS = {
    "ring": MeshOptions(shard_min_series=1, pallas_kernels="on",
                        pallas_min_series=1),
    "gather": MeshOptions(shard_min_series=1, pallas_kernels="off"),
}


def _runs(seed=3):
    rng = np.random.default_rng(seed)
    hosts = np.array([f"host_{i}" for i in range(HOSTS)], object)
    region_of = np.array([f"region_{i}" for i in rng.integers(
        0, REGIONS, HOSTS)], object)
    per_hour = HOUR_MS // STEP_MS
    out = []
    for h in range(HOURS):
        ts = np.tile(np.arange(h * per_hour, (h + 1) * per_hour,
                               dtype=np.int64) * STEP_MS, HOSTS)
        hi = np.repeat(np.arange(HOSTS), per_hour)
        n = len(ts)
        fields = {f: (rng.random(n, dtype=np.float32) * 100.0).astype(
            np.float64) for f in FIELDS}
        out.append(("put", hi, ts, fields))
        re = rng.random(n) < 0.10
        out.append(("put", hi[re], ts[re],
                    {f: (rng.random(int(re.sum()), dtype=np.float32)
                         * 100.0).astype(np.float64) for f in FIELDS}))
        dl = rng.random(n) < 0.01
        out.append(("delete", hi[dl], ts[dl], None))
    return hosts, region_of, out


def _write(table, hosts, region_of, runs):
    for kind, hi, ts, fields in runs:
        tags = {"hostname": hosts[hi], "region": region_of[hi]}
        if kind == "put":
            table.write(tags, ts, fields)
        else:
            table.delete(tags, ts)


def _plan(sql):
    return plan_select(parse_sql(sql)[0], ts_name="ts", tag_names=TAGS,
                       all_columns=None)


@pytest.fixture(scope="module")
def setup(tmp_path_factory, devices):
    """Tables, plans, the JAX sharded results and the port's one-device
    results."""
    hosts, region_of, runs = _runs()
    inst = Standalone(str(tmp_path_factory.mktemp("jax_sharded")))
    cols = ", ".join(f"{f} double" for f in FIELDS)
    inst.execute_sql(
        "create table cpu (ts timestamp time index, hostname string "
        f"primary key, region string primary key, {cols})"
    )
    jt = inst.catalog.table("public", "cpu")
    _write(jt, hosts, region_of, runs)
    tt = Table("cpu", ts_name="ts", tag_names=TAGS, fields=FIELDS)
    _write(tt, hosts, region_of, runs)
    plans = {name: _plan(q) for name, (q, _) in QUERIES.items()}
    single = QueryEngine(device="cpu")
    want_single = {name: single.execute(plan_from_fields(p), tt)
                   for name, p in plans.items()}
    assert single.last_range["program"] == "single"
    eng = JQueryEngine(prefer_device=True,
                       mesh=JM.make_mesh(devices[:JAX_SHARDS]),
                       mesh_opts=JAX_KERNEL)
    want_jax = {name: eng.execute(p, jt) for name, p in plans.items()}
    yield tt, plans, want_single, want_jax
    inst.close()


def _op_of(name):
    return name.split("(")[0]


def _bits(v):
    v = np.asarray(v)
    return v.view(np.uint64) if v.dtype == np.float64 else v


def _assert_identical(a, b):
    """Every column bit for bit (NaN equal to NaN), presence included."""
    assert a.names == b.names and a.num_rows == b.num_rows > 0
    for name, ca, cb in zip(a.names, a.cols, b.cols):
        assert np.array_equal(ca.valid_mask, cb.valid_mask), name
        va, vb = np.asarray(ca.values), np.asarray(cb.values)
        if va.dtype == object:
            assert (va == vb).all(), name
        else:
            assert np.array_equal(_bits(va), _bits(vb)), name


def _compare_to_jax(want, got, w):
    """Slice 1's contract: exact except stddev (FMA bound) and the
    disjoint-window sums/means of Q1 (reduce-order bound)."""
    assert got.names == want.names
    assert got.num_rows == want.num_rows > 0
    by_op = {_op_of(n): i for i, n in enumerate(want.names)}
    disjoint = w == 360
    for i, name in enumerate(want.names):
        a, b = want.cols[i], got.cols[i]
        assert np.array_equal(a.valid_mask, b.valid_mask), name
        m = a.valid_mask
        av, bv = np.asarray(a.values)[m], np.asarray(b.values)[m]
        if av.dtype == object:
            assert (av == bv).all(), name
            continue
        op = _op_of(name)
        if op == "stddev_samp":
            n = np.asarray(want.cols[by_op["count"]].values)[m]
            mean = np.asarray(want.cols[by_op["avg"]].values)[m]
            c = n / np.maximum(n - 1, 1)
            bound = 4 * U * c * (mean * mean + av * av)
            assert np.all(np.abs(bv * bv - av * av) <= bound), name
        elif disjoint and op in ("avg", "sum"):
            bound = 2 * (w - 1) * U
            assert np.all(np.abs(av - bv) <= bound * np.abs(av)), name
        else:
            assert np.array_equal(av.astype(np.float64),
                                  bv.astype(np.float64)), name


@pytest.mark.parametrize("ns", SHARDS)
def test_sharded_range_matches_jax_and_one_device(setup, ns):
    tt, plans, want_single, want_jax = setup
    got = {}
    for variant, opts in PORT_OPTS.items():
        eng = QueryEngine(device="cpu", mesh=make_mesh(["cpu"] * ns),
                          mesh_opts=opts)
        for name, plan in plans.items():
            res = eng.execute(plan_from_fields(plan), tt)
            assert eng.last_range["program"] == f"sharded_{variant}"
            assert eng.last_range["shards"] == ns
            assert eng.last_range["decision"] == "shard(large_grid)"
            _compare_to_jax(want_jax[name], res, QUERIES[name][1])
            _assert_identical(want_single[name], res)
            got[variant, name] = res
        entry = next(iter(eng.range_cache._entries.values()))
        assert len(entry.devices) == ns and len(entry.nrow) == ns
        assert entry.num_series % (8 * ns // np.gcd(8, ns)) == 0
    for name in plans:
        _assert_identical(got["ring", name], got["gather", name])
    # Q2 folds through the ring: 2(ns-1) hops of (g, nb_q) per plane
    ring = QueryEngine(device="cpu", mesh=make_mesh(["cpu"] * ns),
                       mesh_opts=PORT_OPTS["ring"])
    ring.execute(plan_from_fields(plans["q2_by_region"]), tt)
    assert ring.last_range["comm_bytes"] > 0
    ring.execute(plan_from_fields(plans["q1_double_groupby_all"]), tt)
    assert ring.last_range["comm_bytes"] == 0        # no fold, no hops
    for fn in (ring_fold.blocked_fold_sum, ring_fold.fold_cont,
               ring_fold.block_partials, ring_fold.extreme,
               ring_fold.onehot_add, ring_fold.ring_pext_fused,
               ring_fold.ring_psum_onehot_fused):
        assert fn.launches == 0                      # the CPU never launches


def test_planner_replicates_small_grids_by_default(setup):
    tt, plans, want_single, _ = setup
    eng = QueryEngine(device="cpu", mesh=make_mesh(["cpu"] * 4))
    res = eng.execute(plan_from_fields(plans["q2_by_region"]), tt)
    assert eng.last_range["program"] == "single"
    assert eng.last_range["decision"] == "replicate(small_grid)"
    _assert_identical(want_single["q2_by_region"], res)


def test_oversized_sharded_fold_raises(setup, monkeypatch):
    """A sharded fold past the blocked-fold cap no longer raises: it
    gathers every shard's grids to the first shard's device and answers
    as the one-device program does, bit for bit."""
    tt, plans, want_single, _ = setup
    monkeypatch.setattr(tdr, "_FOLD_CAP", 1)    # every fold past the cap
    eng = QueryEngine(device="cpu", mesh=make_mesh(["cpu"] * 2),
                      mesh_opts=PORT_OPTS["ring"])
    res = eng.execute(plan_from_fields(plans["q2_by_region"]), tt)
    assert eng.last_range["program"] == "single_gathered"
    # without a fold (one group per host) the sharded path still runs
    eng.execute(plan_from_fields(plans["q1_double_groupby_all"]), tt)
    assert eng.last_range["program"] == "sharded_ring"
    # one device: fb = 1 degenerates to the direct fold, the same program
    single = QueryEngine(device="cpu")
    _assert_identical(
        single.execute(plan_from_fields(plans["q2_by_region"]), tt), res)


@pytest.mark.parametrize("ns", SHARDS)
@pytest.mark.parametrize("variant", ["ring", "gather"])
def test_sharded_fold_without_blocks_gathers(setup, monkeypatch, ns,
                                             variant):
    """_fold_blocks == 1 on a sharded entry (the two conditions that reach
    it: 8 g nb past the cap, or a series count no multiple of 8) answers
    on the first shard's device, bit-identical to the port on one device
    folding the same way (the direct fold, fb = 1)."""
    tt, plans, _, _ = setup
    monkeypatch.setattr(tdr, "_fold_blocks", lambda g, nb, s: 1)
    plan = plans["q2_by_region"]
    want = QueryEngine(device="cpu").execute(plan_from_fields(plan), tt)
    eng = QueryEngine(device="cpu", mesh=make_mesh(["cpu"] * ns),
                      mesh_opts=PORT_OPTS[variant])
    for _ in range(2):                           # cold, then memoized
        res = eng.execute(plan_from_fields(plan), tt)
        assert eng.last_range["program"] == "single_gathered"
        assert eng.last_range["decision"] == "shard(large_grid)"
        _assert_identical(want, res)
    entry = next(iter(eng.range_cache._entries.values()))
    assert len(entry.devices) == ns and len(entry.nrow) == ns


def test_sharded_prelude_equals_one_device(setup):
    tt, plans, _, _ = setup
    plan = plan_from_fields(plans["q2_by_region"])
    items = tdr.plan_lowering(plan, tt)
    one = tdr.build_entry(plan, tt, items, device="cpu")
    four = tdr.build_entry(plan, tt, items, device="cpu",
                           mesh=make_mesh(["cpu"] * 4),
                           mesh_opts=PORT_OPTS["gather"])
    assert four.mesh_decision.label() == "shard(large_grid)"
    assert four.num_series == one.num_series
    for lo, hi in ((-(2**31) + 1, 2**31 - 1), (30, 700), (400, 401)):
        a = tdr.run_prelude(one, None, lo, hi)
        b = tdr.run_prelude(four, None, lo, hi)
        assert np.array_equal(a[0], b[0]) and a[1:] == b[1:]
    torch.testing.assert_close(torch.cat(four.nrow), one.nrow[0], rtol=0,
                               atol=0)
