"""The port's PromQL fast path against the JAX package's.

(a) One device: the port's PromEngine (QueryEngine(device="cpu")) against
the JAX PromEngine on a JAX Standalone, on the data of
tests/test_promql_fast.py (6 hosts in 2 dcs, 41 samples at 15 s), with
its aggregation and topk queries, the +Inf topk case and the other range
functions the port evaluates. Exact, bit for bit, on every present slot:
the port reproduces XLA:CPU's association of the prefix sums, its
constant-divisor reciprocals and its fused multiply-add in window sums of
squares (ops/window.py), and the scatter branch of the aggregation adds in
segment_sum's order (K2).

(b) Series-sharded: the port on meshes of 2, 4 and 8 shards with the ring
(kernels on; their plain versions on the CPU) and the gather twin against
the port on one device — bit-identical — and against the JAX mesh engine
at 4 shards (Pallas kernels on, interpret mode; its results do not depend
on the mesh size).

(c) The matmul branch and the tie rule at 4608 series with the JAX
PromQL benchmark's data shape (every series rises by exactly 50 a sample,
so the rates tie across thousands of series): topk/bottomk winners exact
against JAX, and the aggregation within the bound of two dot-product
orders: |port - JAX| <= 2 * gamma_n * sum |x_i| over a group's members,
gamma_n = n u / (1 - n u), n = the per-block length plus the 8-block fold,
u = 2^-24 (torch's and XLA:CPU's float32 matrix products add in different
orders). The port sharded stays bit-identical to the port on one device.

(d) The numeric rules: the -0.0 of the one-hot cell take, segment
extremes with NaN and signed zeros, the blocked cumsum, and the shapes
earlier slices refused, which the port now answers as the JAX package
does.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from greptimedb_tpu.instance import Standalone
from greptimedb_tpu.parallel import mesh as JM
from greptimedb_tpu.promql import fast as JF
from greptimedb_tpu.promql.engine import PromEngine as JPromEngine
from greptimedb_tpu.query.executor import QueryEngine as JQueryEngine
from greptimedb_tpu_torch.catalog.manager import CatalogManager
from greptimedb_tpu_torch.catalog.table import Table
from greptimedb_tpu_torch.ops import promql as TK
from greptimedb_tpu_torch.ops import window as TW
from greptimedb_tpu_torch.parallel.mesh import MeshOptions, make_mesh
from greptimedb_tpu_torch.promql import fast as TF
from greptimedb_tpu_torch.promql.engine import PromEngine
from greptimedb_tpu_torch.query.executor import QueryEngine

T0 = 1_700_000_000_000
U = 2.0 ** -24
SHARDS = [2, 4, 8]

# tests/test_promql_fast.py QUERIES and TOPK_QUERIES (every function in
# them is ported), then the other range functions the port evaluates
QUERIES = [
    "sum by (host) (rate(req_total[1m]))",
    "sum(rate(req_total[1m]))",
    "avg by (dc) (increase(req_total[2m]))",
    "max by (dc) (delta(req_total[1m]))",
    "count by (dc) (req_total)",
    "sum by (host) (last_over_time(req_total[1m]))",
    "stddev by (dc) (rate(req_total[1m]))",
    'sum by (dc) (rate(req_total{host=~"h[0-2]"}[1m]))',
    'sum by (host) (rate(req_total{dc="dc0"}[1m]))',
    "sum by (host) (rate(req_total[1m] offset 1m))",
    "sum without (host) (changes(req_total[2m]))",
    "group by (dc) (req_total)",
]
TOPK_QUERIES = [
    "topk(3, rate(req_total[1m]))",
    "bottomk(2, rate(req_total[1m]))",
    "topk(3, req_total)",
    "topk(100, rate(req_total[1m]))",  # k > num_series
    'topk(2, rate(req_total{dc="dc0"}[1m]))',
]
MORE_QUERIES = [
    "sum by (dc) (sum_over_time(req_total[2m]))",
    "avg by (dc) (avg_over_time(req_total[2m]))",
    "min by (dc) (min_over_time(req_total[2m]))",
    "max(max_over_time(req_total[2m]))",
    "avg by (dc) (stddev_over_time(req_total[2m]))",
    "stdvar by (dc) (stdvar_over_time(req_total[2m]))",
    "sum by (host) (first_over_time(req_total[1m]))",
    "sum(count_over_time(req_total[2m]))",
    "count(present_over_time(req_total[1m]))",
    "sum by (dc) (irate(req_total[1m]))",
    "min(idelta(req_total[1m]))",
    "sum(resets(req_total[2m]))",
    'stdvar without (dc) (rate(req_total{host!="h1",dc!~"dc9"}[1m]))',
    "bottomk(4, avg_over_time(req_total[1m]))",
]
ALL = QUERIES + TOPK_QUERIES + MORE_QUERIES
RANGE = (T0 + 120_000, T0 + 480_000, 30_000)


def _metrics_runs():
    """The writes of tests/test_promql_fast.py's setup_metrics, plus an
    infm table of one +Inf, one finite and one -Inf series."""
    ts = T0 + np.arange(41) * 15_000
    rng = np.random.default_rng(7)
    runs = []
    for h in range(6):
        vals = np.cumsum(rng.uniform(0, 5, 41))
        runs.append(("req_total", {"host": np.full(41, f"h{h}", object),
                                   "dc": np.full(41, f"dc{h % 2}", object)},
                     ts, vals))
    ts4 = T0 + np.arange(4) * 15_000
    for h, v in [("a", np.inf), ("b", 5.0), ("c", -np.inf)]:
        runs.append(("infm", {"host": np.full(4, h, object)}, ts4,
                     np.full(4, v)))
    return runs


def _port_instance(catalog, **engine_kw):
    """The holder the engine reads: a catalog and a query engine."""
    return types.SimpleNamespace(
        catalog=catalog, query_engine=QueryEngine(device="cpu", x64=True,
                                                  **engine_kw))


def _port_engines(catalog):
    out = {"single": _port_instance(catalog)}
    for ns in SHARDS:
        mesh = make_mesh(["cpu"] * ns)
        out[f"ring{ns}"] = _port_instance(catalog, mesh=mesh,
                                          mesh_opts=MeshOptions(
                                              shard_min_series=1,
                                              pallas_kernels="on",
                                              pallas_min_series=1))
        out[f"gather{ns}"] = _port_instance(catalog, mesh=mesh,
                                            mesh_opts=MeshOptions(
                                                shard_min_series=1,
                                                pallas_kernels="off"))
    return out


def _jax_mesh_instance(inst, devices):
    return types.SimpleNamespace(
        catalog=inst.catalog,
        query_engine=JQueryEngine(
            prefer_device=True, mesh=JM.make_mesh(devices[:4]),
            mesh_opts=JM.MeshOptions(shard_min_series=1, pallas_kernels="on",
                                     pallas_min_series=1)))


@pytest.fixture(scope="module")
def small(tmp_path_factory, devices):
    """Per query: the JAX single-device and 4-shard results and the port's
    results on every engine."""
    JF.invalidate_cache()
    TF.invalidate_cache()
    inst = Standalone(str(tmp_path_factory.mktemp("jax_promql")))
    inst.sql("CREATE TABLE req_total (host STRING, dc STRING, "
             "greptime_value DOUBLE, ts TIMESTAMP TIME INDEX, "
             "PRIMARY KEY (host, dc))")
    inst.sql("CREATE TABLE infm (host STRING PRIMARY KEY, "
             "greptime_value DOUBLE, ts TIMESTAMP TIME INDEX)")
    catalog = CatalogManager()
    for name, tags, ts, vals in _metrics_runs():
        inst.catalog.table("public", name).write(
            tags, ts, {"greptime_value": vals})
        table = catalog.maybe_table("public", name) or catalog.register(
            Table(name, ts_name="ts", tag_names=list(tags),
                  fields=["greptime_value"]))
        table.write(tags, ts, {"greptime_value": vals})
    jax_single = {q: JPromEngine(inst).query_range(q, *RANGE)[0] for q in ALL}
    port = {}
    notes = {}
    for name, holder in _port_engines(catalog).items():
        eng = PromEngine(holder)
        for q in ALL:
            port[name, q] = eng.query_range(q, *RANGE)[0]
            notes[name, q] = eng.last_fast
    # the JAX grid cache keys on (table, field): drop the single-device
    # grids before the mesh engine builds its sharded ones
    JF.invalidate_cache()
    jmesh = JPromEngine(_jax_mesh_instance(inst, devices))
    jax_mesh = {q: jmesh.query_range(q, *RANGE)[0]
                for q in TOPK_QUERIES + QUERIES[:2]}
    yield {"inst": inst, "catalog": catalog, "jax": jax_single,
           "jax_mesh": jax_mesh, "port": port, "notes": notes}
    JF.invalidate_cache()
    TF.invalidate_cache()
    inst.close()


def _as_map(v):
    return {tuple(sorted(lab.items())): (v.values[i], v.present[i])
            for i, lab in enumerate(v.labels)}


def _f32_bits(x):
    return np.asarray(x, np.float64).astype(np.float32).view(np.uint32)


def _assert_same(want, got, what):
    """Same series (by labels), same presence, and the same float32 bits
    on every present slot (NaN equal to NaN)."""
    a, b = _as_map(want), _as_map(got)
    assert set(a) == set(b), (what, set(a) ^ set(b))
    for key in a:
        (va, pa), (vb, pb) = a[key], b[key]
        assert np.array_equal(pa, pb), (what, key)
        same = (_f32_bits(va[pa]) == _f32_bits(vb[pb])) | (
            np.isnan(va[pa]) & np.isnan(vb[pb]))
        assert same.all(), (what, key, va[pa], vb[pb])


@pytest.mark.parametrize("promql", ALL)
def test_one_device_matches_jax(small, promql):
    want, got = small["jax"][promql], small["port"]["single", promql]
    assert want.num_series > 0
    _assert_same(want, got, promql)
    assert small["notes"]["single", promql]["shards"] == 1


@pytest.mark.parametrize("variant", ["ring", "gather"])
@pytest.mark.parametrize("ns", SHARDS)
def test_sharded_identical_to_one_device(small, ns, variant):
    for q in ALL:
        _assert_same(small["port"]["single", q],
                     small["port"][f"{variant}{ns}", q], (ns, variant, q))
        note = small["notes"][f"{variant}{ns}", q]
        assert note["shards"] == ns
        assert note["decision"] == "shard(large_grid)"
        if q in TOPK_QUERIES:
            want = ("ring(ring_topk)" if variant == "ring"
                    else "gather(kernels_off)")
            assert note["kernel"] == want, q


@pytest.mark.parametrize("promql", TOPK_QUERIES + QUERIES[:2])
def test_sharded_matches_jax_mesh(small, promql):
    for ns in SHARDS:
        _assert_same(small["jax_mesh"][promql],
                     small["port"][f"ring{ns}", promql], (ns, promql))


def test_topk_keeps_infinite_samples(small):
    """A present +Inf sample wins topk (and -Inf bottomk) rather than
    being confused with the absent-slot fill (tests/test_promql_fast.py
    test_topk_keeps_infinite_samples)."""
    for name, holder in _port_engines(small["catalog"]).items():
        eng = PromEngine(holder)
        v, _ = eng.query_range("topk(1, infm)", T0 + 15_000, T0 + 45_000,
                               15_000)
        assert [lab["host"] for lab in v.labels] == ["a"], name
        assert np.isposinf(v.values[v.present]).all()
        assert all(lab["__name__"] == "infm" for lab in v.labels)
        v, _ = eng.query_range("bottomk(1, infm)", T0 + 15_000,
                               T0 + 45_000, 15_000)
        assert [lab["host"] for lab in v.labels] == ["c"], name
        assert np.isneginf(v.values[v.present]).all()
    jv, _ = JPromEngine(small["inst"]).query_range(
        "topk(1, infm)", T0 + 15_000, T0 + 45_000, 15_000)
    tv, _ = PromEngine(_port_instance(small["catalog"])).query_range(
        "topk(1, infm)", T0 + 15_000, T0 + 45_000, 15_000)
    _assert_same(jv, tv, "topk(1, infm)")


def test_query_instant_and_unknown_metric(small):
    eng = PromEngine(_port_instance(small["catalog"]))
    jeng = JPromEngine(small["inst"])
    # an instant query steps 1 s, off the 15 s grid: both packages answer
    # it from the generic engine
    q = "sum by (dc) (rate(req_total[1m]))"
    v, _ = eng.query_instant(q, T0 + 300_000)
    jv, _ = jeng.query_instant(q, T0 + 300_000)
    assert jv.num_series == 2
    _assert_same(jv, v, q)
    # an unknown metric selects no series, as the JAX engine answers
    v, _ = eng.query_range("sum(rate(nope[1m]))", *RANGE)
    jv, _ = jeng.query_range("sum(rate(nope[1m]))", *RANGE)
    assert v.num_series == jv.num_series == 0
    assert eng.query_range("3", *RANGE)[0].values.tolist() == [3.0] * 13


@pytest.mark.parametrize("promql,start,step", [
    ("topk by (dc) (2, rate(req_total[1m]))", T0 + 120_000, 30_000),
    ("sum(quantile_over_time(0.5, req_total[2m]))", T0 + 120_000, 30_000),
    ("sum(deriv(req_total[2m]))", T0 + 120_000, 30_000),
    ("sum(rate(req_total[1m])) / 2", T0 + 120_000, 30_000),
    ("rate(req_total[1m])", T0 + 120_000, 30_000),
    ("req_total", T0 + 120_000, 30_000),
    ("sum(rate(req_total[1m]))", T0 + 120_000, 20_000),   # step off-grid
    ("sum(rate(req_total[1m]))", T0 + 121_000, 30_000),   # start off-grid
    ("sum(rate(req_total[70s]))", T0 + 120_000, 30_000),  # range off-grid
])
def test_unported_shapes_raise(small, promql, start, step):
    """The shapes earlier slices refused with UnsupportedError (grouped
    topk, the quantile and linear-fit families, binaries, bare range
    functions and selectors, and queries off the grid's cells): every one
    is answered now, as the JAX package answers it (the fast path or the
    generic engine), with the same labels, presence and bits."""
    eng = PromEngine(_port_instance(small["catalog"]))
    got, _ = eng.query_range(promql, start, T0 + 480_000, step)
    want, _ = JPromEngine(small["inst"]).query_range(promql, start,
                                                      T0 + 480_000, step)
    assert want.num_series > 0
    _assert_same(want, got, promql)


# ----------------------------------------------------------------------
# (c) the matmul branch and the tie rule at 4608 series
# ----------------------------------------------------------------------

BIG_S = 4608
BIG_QUERIES = ["sum by (dc) (rate(prom_bench[1m]))",
               "avg(rate(prom_bench[1m]))",
               "count by (dc) (rate(prom_bench[1m]))",
               "topk(5, rate(prom_bench[1m]))",
               "topk(100, rate(prom_bench[1m]))",
               "bottomk(100, rate(prom_bench[1m]))"]
BIG_RANGE = (T0 + 60_000, T0 + 270_000, 30_000)


@pytest.fixture(scope="module")
def big(tmp_path_factory):
    """bench.py's prom_bench shape (dc = i % 32, 10 samples at 30 s, each
    series rising by 50 a sample from a seeded start) at 4608 series."""
    JF.invalidate_cache()
    inst = Standalone(str(tmp_path_factory.mktemp("jax_prom_big")))
    inst.sql("CREATE TABLE prom_bench (host STRING, dc STRING, "
             "greptime_value DOUBLE, ts TIMESTAMP TIME INDEX, "
             "PRIMARY KEY (host, dc))")
    jt = inst.catalog.table("public", "prom_bench")
    tt = Table("prom_bench", ts_name="ts", tag_names=["host", "dc"],
               fields=["greptime_value"])
    prng = np.random.default_rng(11)
    tags = {"host": np.array([f"host_{i}" for i in range(BIG_S)], object),
            "dc": np.array([f"dc{i % 32}" for i in range(BIG_S)], object)}
    base = np.cumsum(prng.random(BIG_S))
    for s in range(10):
        ts = np.full(BIG_S, T0 + s * 30_000, np.int64)
        for t in (jt, tt):
            t.write(tags, ts, {"greptime_value": base + s * 50.0})
    catalog = CatalogManager()
    catalog.register(tt)
    jax_res = {q: JPromEngine(inst).query_range(q, *BIG_RANGE)[0]
               for q in BIG_QUERIES}
    port = {name: {q: PromEngine(h).query_range(q, *BIG_RANGE)[0]
                   for q in BIG_QUERIES}
            for name, h in _port_engines(catalog).items()}
    yield jax_res, port, base
    JF.invalidate_cache()
    TF.invalidate_cache()
    inst.close()


@pytest.mark.parametrize("promql", BIG_QUERIES[3:])
def test_ties_at_scale_match_jax(big, promql):
    jax_res, port, _ = big
    want = jax_res[promql]
    assert want.num_series > 5
    # the data does tie: some step has more equal keys than winners
    vals = want.values[want.present]
    assert len(np.unique(vals.astype(np.float32))) < len(vals)
    _assert_same(want, port["single"][promql], promql)


@pytest.mark.parametrize("promql", BIG_QUERIES[:3])
def test_matmul_branch_within_bound(big, promql):
    jax_res, port, base = big
    assert TK.uses_matmul("sum", 33, 8192)
    a, b = _as_map(jax_res[promql]), _as_map(port["single"][promql])
    assert set(a) == set(b)
    # a group's members are 4608 / 32 = 144 series per dc (one group of
    # all of them for avg); per fold block the product adds 8192 / 8 rows
    n = 8192 // 8 + 8
    gamma = n * U / (1 - n * U)
    for key in a:
        (va, pa), (vb, pb) = a[key], b[key]
        assert np.array_equal(pa, pb)
        # every rate here is about 50 / 30 per second; the members' sum of
        # magnitudes, and for avg the same bound over the member count
        members = BIG_S if not key else BIG_S // 32
        mag = members * 2.0 if promql.startswith("sum") else 2.0
        if promql.startswith("count"):
            assert np.array_equal(va[pa], vb[pb])
            continue
        assert np.all(np.abs(va[pa] - vb[pb]) <= 2 * gamma * mag), key


@pytest.mark.parametrize("variant", ["ring", "gather"])
@pytest.mark.parametrize("ns", SHARDS)
def test_big_sharded_identical_to_one_device(big, ns, variant):
    _, port, _ = big
    for q in BIG_QUERIES:
        _assert_same(port["single"][q], port[f"{variant}{ns}"][q],
                     (ns, variant, q))


PAD_S = 1000          # not a power of two: the grid pads to 1024 series
PAD_QUERIES = ["max by (dc) (rate(prom_bench[1m]))",
               "count by (dc) (rate(prom_bench[1m]))",
               "count by (dc) (prom_bench)"]


def test_padded_series_leave_the_fold_lists(tmp_path):
    """prom_bench's shape (dc = i % 32) at 1000 series, padded to 1024 on
    the grid: `max by` and `count by` take the scatter branch (below 4096
    series) through K2, whose member lists leave the 24 padded series out
    (their group's row is dropped after the fold). Every answer stays bit
    for bit the JAX package's, on one device and on every sharded engine,
    and no list holds a padded sid."""
    JF.invalidate_cache()
    TF.invalidate_cache()
    inst = Standalone(str(tmp_path / "jax_pad"))
    inst.sql("CREATE TABLE prom_bench (host STRING, dc STRING, "
             "greptime_value DOUBLE, ts TIMESTAMP TIME INDEX, "
             "PRIMARY KEY (host, dc))")
    jt = inst.catalog.table("public", "prom_bench")
    tt = Table("prom_bench", ts_name="ts", tag_names=["host", "dc"],
               fields=["greptime_value"])
    rng = np.random.default_rng(41)
    tags = {"host": np.array([f"host_{i}" for i in range(PAD_S)], object),
            "dc": np.array([f"dc{i % 32}" for i in range(PAD_S)], object)}
    base = np.cumsum(rng.random(PAD_S))
    for k in range(10):
        ts = np.full(PAD_S, T0 + k * 30_000, np.int64)
        vals = base + k * rng.uniform(10, 90, PAD_S)
        for t in (jt, tt):
            t.write(tags, ts, {"greptime_value": vals})
    catalog = CatalogManager()
    catalog.register(tt)
    try:
        assert not TK.uses_matmul("count", 33, 1024)
        want = {q: JPromEngine(inst).query_range(q, *BIG_RANGE)[0]
                for q in PAD_QUERIES}
        checked = 0
        engines = _port_engines(catalog)
        for name, holder in engines.items():
            eng = PromEngine(holder)
            for q in PAD_QUERIES:
                got = eng.query_range(q, *BIG_RANGE)[0]
                assert got.num_series == 32
                _assert_same(want[q], got, (name, q))
            for entry in list(TF._CACHE._entries.values()):
                assert entry.s_pad == 1024 and entry.num_series == PAD_S
                per = entry.s_pad // entry.shards
                for grp in entry.group_cache.values():
                    if not isinstance(grp, TF._Grouping):
                        continue
                    assert grp.fold_members is not None
                    for k, fm in enumerate(grp.fold_members):
                        sids = fm.member.numpy().astype(np.int64) + k * per
                        assert (sids < PAD_S).all(), name
                        assert len(sids) == (
                            grp.gid_host[k * per:(k + 1) * per]
                            < grp.g).sum()
                    checked += 1
            TF.invalidate_cache()
        assert checked == len(engines)
    finally:
        JF.invalidate_cache()
        TF.invalidate_cache()
        inst.close()


# ----------------------------------------------------------------------
# (d) numeric rules
# ----------------------------------------------------------------------

def test_take_cells_turns_negative_zero_positive():
    """JAX's one-hot cell take sums +0.0 into the selected value up to
    T = 128 (so -0.0 comes out +0.0) and gathers beyond."""
    rng = np.random.default_rng(0)
    for t in (12, 128, 129):
        arr = np.where(rng.random((5, t)) < 0.5, -0.0, 1.5).astype(np.float32)
        idx = rng.integers(0, t, (5, 7)).astype(np.int32)
        from greptimedb_tpu.ops import window as JW

        want = np.asarray(JW._take_cells(jnp.asarray(arr), jnp.asarray(idx)))
        got = TW._take_cells(torch.from_numpy(arr), torch.from_numpy(idx))
        assert np.array_equal(want.view(np.uint32),
                              got.numpy().view(np.uint32)), t
        assert np.signbit(want).any() == (t > 128)


@pytest.mark.parametrize("t", [1, 5, 16, 17, 48, 100, 361])
def test_prefix_matches_xla_cumsum(t):
    rng = np.random.default_rng(t)
    x = (rng.standard_normal((9, t)) * 10.0 ** rng.integers(-3, 6, (9, t))
         ).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = -0.0
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=1))(x))
    got = TW._prefix(torch.from_numpy(x))[:, 1:].numpy()
    assert np.array_equal(want.view(np.uint32), got.view(np.uint32))


def _specials(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    r = rng.random(shape)
    x[r < 0.15] = 0.0
    x[(r >= 0.15) & (r < 0.3)] = -0.0
    x[(r >= 0.3) & (r < 0.35)] = np.nan
    x[(r >= 0.35) & (r < 0.4)] = np.inf
    x[(r >= 0.4) & (r < 0.45)] = -np.inf
    return x


@pytest.mark.parametrize("take_max", [True, False])
def test_segment_extremes_match_jax(take_max):
    rng = np.random.default_rng(int(take_max))
    g = 9
    x = _specials(rng, (300, 6))
    gid = rng.integers(0, g - 1, 300).astype(np.int32)  # segment g-1 empty
    zeros = np.where(rng.random((300, 6)) < 0.5, 0.0, -0.0).astype(
        np.float32)
    op = jax.ops.segment_max if take_max else jax.ops.segment_min
    for data in (x, zeros):
        want = np.asarray(jax.jit(
            lambda a, s: op(a, s, num_segments=g))(data, gid))
        got = TK.segment_ext(torch.from_numpy(data), torch.from_numpy(gid),
                             g, take_max).numpy()
        nan = np.isnan(want)
        assert np.array_equal(nan, np.isnan(got))
        assert np.array_equal(want[~nan].view(np.uint32),
                              got[~nan].view(np.uint32))


def test_window_stdvar_fma_matches_jax():
    from greptimedb_tpu.ops import window as JW

    rng = np.random.default_rng(2)
    s, t, l_cells = 40, 30, 8
    vals = np.cumsum(rng.uniform(0, 5, (s, t)), axis=1).astype(np.float32)
    has = rng.random((s, t)) < 0.85
    tsg = np.zeros((s, t), np.int32)
    hi = np.arange(8, 30, 2).astype(np.int32)
    want = JW.window_stdvar(vals, has, tsg, hi, num_cells=l_cells)
    got = TW.window_stdvar(torch.from_numpy(vals), torch.from_numpy(has),
                           torch.from_numpy(tsg), torch.from_numpy(hi),
                           l_cells)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w).view(np.uint8),
                              g.numpy().view(np.uint8))


def test_grid_cache_budget_versions_and_drops(small):
    """Entries key on (table, field, device, mesh, options), rebuild when
    the table's data version moves, evict least recently used past the
    byte budget, and go with invalidate/drop_table."""
    table = small["catalog"].table("public", "req_total")
    cache = TF.SelectorGridCache()
    e1 = cache.get_entry(table, "greptime_value", device="cpu")
    assert cache.get_entry(table, "greptime_value", device="cpu") is e1
    mesh = make_mesh(["cpu"] * 2)
    opts = MeshOptions(shard_min_series=1)
    e2 = cache.get_entry(table, "greptime_value", device="cpu", mesh=mesh,
                         mesh_opts=opts)
    assert e2 is not e1 and e2.shards == 2 and e1.shards == 1
    assert e2.vals[0].shape == (e2.s_pad // 2, e2.spec.num_cells)
    # a budget of one entry keeps only the newest
    cache.byte_budget = e1.nbytes
    other = small["catalog"].table("public", "infm")
    cache.get_entry(other, "greptime_value", device="cpu")
    assert len(cache._entries) == 1
    cache.byte_budget = 1 << 30
    e3 = cache.get_entry(table, "greptime_value", device="cpu")
    assert e3 is not e1
    cache.drop_table(table)
    assert all(e.table is other for e in cache._entries.values())
    cache.invalidate()
    assert not cache._entries
    # a write moves the version: the next lookup rebuilds
    copy = Table("req_total", ts_name="ts", tag_names=["host", "dc"],
                 fields=["greptime_value"])
    for name, tags, ts, vals in _metrics_runs()[:2]:
        copy.write(tags, ts, {"greptime_value": vals})
    a = cache.get_entry(copy, "greptime_value", device="cpu")
    copy.write({"host": np.array(["h9"], object),
                "dc": np.array(["dc1"], object)},
               np.array([T0], np.int64), {"greptime_value": np.ones(1)})
    b = cache.get_entry(copy, "greptime_value", device="cpu")
    assert b is not a and b.num_series == a.num_series + 1
