"""SQL in for the TSBS RANGE suite: the port's parser, planner and
Instance.sql against the JAX package's parse_sql, plan_select and
Standalone.sql.

Data: slice 1's TSBS shape at test size (tests/test_torch_device_range.py):
64 hosts in 4 regions, 6 h at 10 s, four usage_* fields, hourly runs plus
a re-delivery run (10 % of the hour's keys, new values) and a tombstone
run (1 %). The JAX side writes them to a Standalone table and answers
through Standalone(prefer_device=True).sql; the port writes the same runs
to its Table, registers it in an Instance(device="cpu") and answers
through Instance.sql.

The suite is bench.py's TSBS RANGE shapes (the headline double-groupby-all
and the nine device shapes), cut to the table's 6 hours, plus Q2 written
as SQL and RANGE variants (ALIGN TO, FILL, LIMIT/OFFSET, IN/NOT/LIKE
matchers, output expressions, DISTINCT, HAVING), and sum, avg and
stddev_samp over disjoint windows of a signed field g (N(0, 1), about half
its cells null, its own seeded generator).

The contract is slice 1's, as tests/test_torch_device_range.py states it:
exact for counts, min/max, first/last, keys and timestamps; sums and
means of disjoint windows (range == align) within E1 = 2 (w - 1) 2^-24
sum|x| per cell (E1 / n for means; sum|x| from the written rows), the
gap of two reduction orders over w cells; stddev bit for bit over
overlapping windows (both packages contract its variance into one fused
multiply-add), within the reorder gap over disjoint windows. The sharded port (four shards on
the CPU: the fused ring, the hop ring, the gather twin) must equal the
one-device port bit for bit.
"""

import functools
import re

import numpy as np
import pytest

from greptimedb_tpu.instance import Standalone
from greptimedb_tpu.query.planner import plan_select as jplan_select
from greptimedb_tpu.sql.parser import parse_sql as jparse_sql
from greptimedb_tpu_torch.catalog.table import Table
from greptimedb_tpu_torch.errors import UnsupportedError
from greptimedb_tpu_torch.instance import Instance
from greptimedb_tpu_torch.parallel.kernels import ring_fold
from greptimedb_tpu_torch.parallel.mesh import MeshOptions, make_mesh
from greptimedb_tpu_torch.promql.engine import PromEngine
from greptimedb_tpu_torch.query import device_range as tdr
from greptimedb_tpu_torch.query.planner import convert_expr, plan_select
from greptimedb_tpu_torch.sql.parser import parse_sql

HOSTS, REGIONS, HOURS, STEP_MS = 64, 4, 6, 10_000
FIELDS = ["usage_user", "usage_system", "usage_idle", "usage_nice"]
SIGNED = "g"          # N(0, 1), about half its cells null
TAGS = ["hostname", "region"]
HOUR_MS = 3_600_000
END_MS = HOURS * HOUR_MS
U = 2.0 ** -24
HOSTS8 = ", ".join(f"'host_{i}'" for i in range(8))

# bench.py's TSBS RANGE suite (name, sql, rows) at the table's size
SUITE = [
    ("double_groupby_all", "SELECT ts, hostname, " + ", ".join(
        f"avg({f}) RANGE '1h'" for f in FIELDS)
     + " FROM cpu ALIGN '1h' BY (hostname)", HOSTS * HOURS),
    ("lastpoint", "SELECT ts, hostname, last_value(usage_user) RANGE '12h' "
     "FROM cpu ALIGN '12h' TO '1970-01-01 00:00:00' BY (hostname)", HOSTS),
    ("groupby_orderby_limit", "SELECT ts, max(usage_user) RANGE '1m' FROM "
     f"cpu WHERE ts < {END_MS - HOUR_MS} ALIGN '1m' BY () "
     "ORDER BY ts DESC LIMIT 5", 5),
    ("single_groupby_1_1_1", "SELECT ts, max(usage_user) RANGE '1m' FROM cpu "
     f"WHERE hostname = 'host_17' AND ts >= {END_MS - HOUR_MS} "
     f"AND ts < {END_MS} ALIGN '1m' BY (hostname)", 60),
    ("single_groupby_1_1_12", "SELECT ts, max(usage_user) RANGE '1m' FROM "
     "cpu WHERE hostname = 'host_17' ALIGN '1m' BY (hostname)", HOURS * 60),
    ("single_groupby_5_8_1", "SELECT ts, hostname, " + ", ".join(
        f"max({f}) RANGE '1m'" for f in FIELDS)
     + f" FROM cpu WHERE hostname IN ({HOSTS8}) AND ts >= {END_MS - HOUR_MS}"
     f" AND ts < {END_MS} ALIGN '1m' BY (hostname)", 8 * 60),
    ("cpu_max_all_1", "SELECT ts, " + ", ".join(
        f"max({f}) RANGE '1h'" for f in FIELDS)
     + " FROM cpu WHERE hostname = 'host_42' ALIGN '1h' BY (hostname) "
     "LIMIT 8", min(8, HOURS)),
    ("cpu_max_all_8", "SELECT ts, hostname, " + ", ".join(
        f"max({f}) RANGE '1h'" for f in FIELDS)
     + f" FROM cpu WHERE hostname IN ({HOSTS8}) AND ts < {8 * HOUR_MS} "
     "ALIGN '1h' BY (hostname)", 8 * min(8, HOURS)),
    ("double_groupby_1", "SELECT ts, hostname, avg(usage_user) RANGE '1h' "
     "FROM cpu ALIGN '1h' BY (hostname)", HOSTS * HOURS),
    ("double_groupby_5", "SELECT ts, hostname, " + ", ".join(
        f"avg({f}) RANGE '1h'" for f in FIELDS[:3])
     + " FROM cpu ALIGN '1h' BY (hostname)", HOSTS * HOURS),
    ("q2_by_region", "SELECT ts, region, " + ", ".join(
        f"{op}(usage_user) RANGE '2h'" for op in (
            "count", "sum", "min", "max", "avg", "stddev_samp",
            "first_value", "last_value"))
     + " FROM cpu ALIGN '1h' BY (region)", REGIONS * (HOURS + 1)),
]
VARIANTS = [
    ("align_to_fill_prev", "SELECT ts, region, avg(usage_user) RANGE '2h' "
     f"FILL PREV FROM cpu WHERE hostname IN ({HOSTS8}) ALIGN '1h' "
     "TO '1970-01-01 00:30:00' BY (region)"),
    ("fill_linear_offset", "SELECT ts, region, min(usage_idle) RANGE '30m' "
     "FROM cpu WHERE hostname IN ('host_3', 'host_9') ALIGN '20m' "
     "BY (region) FILL LINEAR ORDER BY region, ts DESC LIMIT 10 OFFSET 3"),
    ("fill_const_not_in", "SELECT ts, hostname, count(usage_user) RANGE '1h'"
     " FROM cpu WHERE hostname NOT IN ('host_1', 'host_2') AND ts >= "
     f"{HOUR_MS} AND ts < {3 * HOUR_MS} ALIGN '30m' BY (hostname) FILL 0"),
    ("like_expressions", "SELECT ts, region, max(usage_user) RANGE '1h' - "
     "min(usage_user) RANGE '1h' AS spread, first_value(usage_nice) RANGE "
     "'90m' FROM cpu WHERE hostname LIKE 'host_1%' ALIGN '1h' BY (region) "
     "ORDER BY spread DESC"),
    ("ne_having_by_all", "SELECT ts, max(usage_system) RANGE '1h' AS m FROM "
     "cpu WHERE region != 'region_0' ALIGN '1h' HAVING m > 99.0 "
     "ORDER BY m DESC LIMIT 7"),
    ("distinct_count_star", "SELECT DISTINCT region, count(*) RANGE '1h' "
     "AS n FROM cpu ALIGN '1h' BY (region) ORDER BY region, n"),
]
# the signed, half-null field over disjoint windows (ROADMAP C1)
SIGNED_QUERIES = [
    (f"signed_{rng}_by_{key}", f"SELECT ts, {key}, " + ", ".join(
        f"{op}({SIGNED}) RANGE '{rng}'"
        for op in ("count", "sum", "avg", "stddev_samp"))
     + f" FROM cpu ALIGN '{rng}' BY ({key})")
    for rng, key in (("10m", "hostname"), ("1h", "hostname"),
                     ("10m", "region"), ("1h", "region"))
]
QUERIES = VARIANTS + SIGNED_QUERIES


def _signed(rng, n):
    """n values of the signed field and their validity (about half)."""
    return {SIGNED: rng.standard_normal(n)}, {SIGNED: rng.random(n) < 0.5}


def _runs(seed=0):
    """The write sequence: per hour one run, then one re-delivery run
    (10% of the hour's keys, new values) and one tombstone run (1%). The
    signed field draws from its own generator, so the usage fields keep
    their values."""
    rng = np.random.default_rng(seed)
    grng = np.random.default_rng(seed + 1000)
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
        g, valid = _signed(grng, n)
        out.append(("put", hi, ts, {**fields, **g}, valid))
        re = rng.random(n) < 0.10
        g, valid = _signed(grng, int(re.sum()))
        out.append(("put", hi[re], ts[re],
                    {**{f: (rng.random(int(re.sum()), dtype=np.float32)
                            * 100.0).astype(np.float64) for f in FIELDS},
                     **g}, valid))
        dl = rng.random(n) < 0.01
        out.append(("delete", hi[dl], ts[dl], None, None))
    return hosts, region_of, out


def _write(table, hosts, region_of, runs):
    for kind, hi, ts, fields, valid in runs:
        tags = {"hostname": hosts[hi], "region": region_of[hi]}
        if kind == "put":
            table.write(tags, ts, fields, field_valid=valid)
        else:
            table.delete(tags, ts)


LOW = {"shard_min_series": 1, "pallas_min_series": 1}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX Standalone and the port's tables, one-device Instance, and
    both packages' answers to every query (each engine built once)."""
    hosts, region_of, runs = _runs()
    jinst = Standalone(str(tmp_path_factory.mktemp("jax_sql")),
                       prefer_device=True, warm_start=False)
    cols = ", ".join(f"{f} double" for f in FIELDS + [SIGNED])
    jinst.execute_sql(
        "create table cpu (ts timestamp time index, hostname string "
        f"primary key, region string primary key, {cols})")
    _write(jinst.catalog.table("public", "cpu"), hosts, region_of, runs)
    tt = Table("cpu", ts_name="ts", tag_names=TAGS, fields=FIELDS + [SIGNED])
    _write(tt, hosts, region_of, runs)
    inst = Instance(device="cpu")
    inst.catalog.register(tt)
    want, got = {}, {}
    for name, sql, *_ in SUITE + QUERIES:
        want[name] = jinst.sql(sql)
        assert jinst.query_engine.last_exec_path == "device", name
        got[name] = inst.sql(sql)
        assert inst.query_engine.last_exec_path == "device", name
    yield tt, inst, want, got
    jinst.close()


def _op_of(name):
    return name.split("(")[0]


def _window_cells(sql):
    """w of the query's widest RANGE item at its grid resolution."""
    stmt = parse_sql(sql)[0]
    plan = plan_select(stmt, ts_name="ts", tag_names=TAGS, all_columns=None)
    res = functools.reduce(np.gcd, [plan.align_ms, STEP_MS] + [
        r.range_ms for r in plan.range_items])
    return max(r.range_ms for r in plan.range_items) // int(res)


def _cell_stats(table, res, field, keys, range_ms):
    """Per output row of `res`: (n, sum|x|, sum x^2) in float64 over the
    valid `field` values of the written rows (the table's scan) in the
    row's window [ts, ts + range_ms) of the series whose `keys` tags equal
    the row's (range == align, aligned to 0: disjoint windows)."""
    rows = table.scan([field]).rows
    ok = rows.field_valid[field] if rows.field_valid else np.ones(
        len(rows.ts), bool)
    x = rows.fields[field].astype(np.float64)[ok]
    reg = table.region.series
    row_key = np.full(int(ok.sum()), "", object)
    res_key = np.full(res.num_rows, "", object)
    for k in keys:
        row_key = row_key + "\x00" + np.asarray(
            reg.tag_values(k), object)[rows.sid[ok]]
        res_key = res_key + "\x00" + np.asarray(res.column(k).values,
                                                 object)
    names, code = np.unique(np.concatenate([row_key, res_key]),
                            return_inverse=True)
    n_win = int(rows.ts.max()) // range_ms + 2
    row_cell = code[:len(row_key)] * n_win + rows.ts[ok] // range_ms
    res_cell = (code[len(row_key):] * n_win
                + np.asarray(res.column("ts").values, np.int64) // range_ms)
    size = len(names) * n_win
    return tuple(np.bincount(row_cell, weights=wt, minlength=size)[res_cell]
                 for wt in (np.ones_like(x), np.abs(x), x * x))


def _stats_fn(table, sql, res):
    """column name -> _cell_stats of its field, for a disjoint-window
    query (range == align) grouped by the tags among its columns."""
    plan = plan_select(parse_sql(sql)[0], ts_name="ts", tag_names=TAGS,
                       all_columns=None)
    assert all(r.range_ms == plan.align_ms for r in plan.range_items)
    keys = [t for t in TAGS if t in res.names]
    return lambda name: _cell_stats(
        table, res, re.search(r"\((\w+)\)", name)[1], keys, plan.align_ms)


def _compare(want, got, w, stats=None):
    """Slice 1's contract (module docstring). `stats(column)` gives the
    per-cell (n, sum|x|, sum x^2) of a disjoint-window query's column;
    without it (overlapping windows) sums, means and stddev must be
    bit-equal."""
    assert got.names == want.names
    assert got.num_rows == want.num_rows
    names = [_op_of(n) for n in want.names]
    for i, name in enumerate(want.names):
        a, b = want.cols[i], got.cols[i]
        assert np.array_equal(a.valid_mask, b.valid_mask), name
        m = a.valid_mask
        av, bv = np.asarray(a.values)[m], np.asarray(b.values)[m]
        if av.dtype == object:
            assert (av == bv).all(), name
            continue
        if np.array_equal(av.astype(np.float64), bv.astype(np.float64)):
            continue
        op = _op_of(name)
        if op == "stddev_samp":
            assert stats is not None, f"{name} not bit-equal"
            n = np.asarray(want.cols[names.index("count")].values)[m]
            mean = np.asarray(want.cols[names.index("avg")].values)[m]
            c = n / np.maximum(n - 1, 1)
            _, abs1, sq = (v[m] for v in stats(name))
            e1, e2 = 2 * (w - 1) * U * abs1, 2 * (w - 1) * U * sq
            bound = c * (e2 + 2 * np.abs(mean) * e1) / n
            assert np.all(np.abs(bv * bv - av * av) <= bound), name
        else:
            assert op in ("avg", "sum") and stats is not None, (
                f"{name} not bit-equal")
            cnt, abs1, _ = (v[m] for v in stats(name))
            bound = 2 * (w - 1) * U * abs1
            if op == "avg":
                bound = bound / cnt
            assert np.all(np.abs(av - bv) <= bound), name


def _bits(v):
    v = np.asarray(v)
    return v.view(np.uint64) if v.dtype == np.float64 else v


def _assert_identical(a, b):
    """Every column bit for bit (NaN equal to NaN), presence included."""
    assert a.names == b.names and a.num_rows == b.num_rows
    for name, ca, cb in zip(a.names, a.cols, b.cols):
        assert np.array_equal(ca.valid_mask, cb.valid_mask), name
        va, vb = np.asarray(ca.values), np.asarray(cb.values)
        if va.dtype == object:
            assert (va == vb).all(), name
        else:
            assert np.array_equal(_bits(va), _bits(vb)), name


@pytest.mark.parametrize("name,sql", [(n, s) for n, s, *_ in
                                      SUITE + QUERIES])
def test_parse_and_plan_match_jax_field_by_field(name, sql):
    jstmt = jparse_sql(sql)
    stmt = parse_sql(sql)
    assert convert_expr(jstmt) == stmt
    cols = ["ts", *TAGS, *FIELDS, SIGNED]
    jplan = jplan_select(jstmt[0], ts_name="ts", tag_names=TAGS,
                         all_columns=cols)
    plan = plan_select(stmt[0], ts_name="ts", tag_names=TAGS,
                       all_columns=cols)
    assert convert_expr(jplan) == plan


# disjoint windows (range == align): sums and means within E1
DISJOINT = {"double_groupby_all", "double_groupby_1", "double_groupby_5",
            *(n for n, _ in SIGNED_QUERIES)}


@pytest.mark.parametrize("name,sql", [(n, s) for n, s, *_ in
                                      SUITE + QUERIES])
def test_instance_sql_matches_standalone(setup, name, sql):
    tt, _, want, got = setup
    assert want[name].num_rows > 0
    stats = _stats_fn(tt, sql, want[name]) if name in DISJOINT else None
    _compare(want[name], got[name], _window_cells(sql), stats)


@pytest.mark.parametrize("name,sql", SIGNED_QUERIES,
                         ids=[n for n, _ in SIGNED_QUERIES])
def test_signed_field_windows_and_cancellation(setup, name, sql):
    """The signed queries' counts equal the valid written rows of each
    window (the windows _cell_stats sums |x| over), and their sums cancel
    far below sum|x|: the data on which a bound relative to the sum fails.
    Their bounds against Standalone.sql hold in
    test_instance_sql_matches_standalone (one device), and the sharded
    engines equal the one-device port bit for bit in
    test_sharded_sql_engines_are_bit_identical."""
    tt, _, want, _ = setup
    res = want[name]
    stats = _stats_fn(tt, sql, res)
    cnt, s = (next(c for c in res.names if c.startswith(op))
              for op in ("count", "sum"))
    m = res.column(cnt).valid_mask
    assert np.array_equal(np.asarray(res.column(cnt).values)[m],
                          stats(cnt)[0][m])
    sm = res.column(s).valid_mask
    assert (np.abs(np.asarray(res.column(s).values)[sm])
            / stats(s)[1][sm]).min() < 0.01


def test_suite_row_counts_and_timestamp_type(setup):
    _, _, _, got = setup
    for name, _, rows in SUITE:
        assert got[name].num_rows == rows, name
        assert got[name].types["ts"].name == "timestamp_ms", name


def _hop_ring(monkeypatch):
    monkeypatch.setattr(tdr.ring_fold, "RingFoldCtx", functools.partial(
        ring_fold.RingFoldCtx, fused=False))


def test_sharded_sql_engines_are_bit_identical(setup, monkeypatch):
    """The suite on make_mesh(["cpu"] * 4): the fused ring (the default
    ring form: every shard on one device), the hop ring (RingFoldCtx with
    fused=False), the gather twin and the one-device port, column for
    column. The fused ring runs once per folded plane of every folding
    query, and never on the gather twin."""
    tt, _, _, single = setup
    calls = []
    fused = ring_fold.ring_fold_fused

    def counting(arrs, fms, **kw):
        calls.append(len(arrs))
        return fused(arrs, fms, **kw)

    monkeypatch.setattr(ring_fold, "ring_fold_fused", counting)
    engines = {
        "fused": MeshOptions(pallas_kernels="on", **LOW),
        "hops": MeshOptions(pallas_kernels="on", **LOW),
        "gather": MeshOptions(pallas_kernels="off", **LOW),
    }
    for form, opts in engines.items():
        with monkeypatch.context() as m:
            if form == "hops":
                _hop_ring(m)
            inst = Instance(device="cpu", mesh=make_mesh(["cpu"] * 4),
                            mesh_opts=opts)
            inst.catalog.register(tt)
            for name, sql, *_ in SUITE + QUERIES:
                del calls[:]
                res = inst.sql(sql)
                info = inst.query_engine.last_range
                assert info["shards"] == 4, (form, name)
                _assert_identical(single[name], res)
                folds = bool(calls) or info["comm_bytes"] > 0
                if form == "gather":
                    assert info["program"] == "sharded_gather"
                    assert info["ring_form"] is None and not calls
                else:
                    assert info["program"] == "sharded_ring"
                    assert info["kernel"] == "ring(ring_fold)"
                    assert info["ring_form"] == form, name
                    assert bool(calls) == (form == "fused" and folds)
                    assert all(n == 4 for n in calls)


def test_folding_queries_fold_on_the_sharded_path(setup):
    """Which suite queries fold groups across shards (the ones the fused
    kernel carries on the card): every grouped shape whose groups are not
    the series themselves. host_0..host_7 are sids 0..7, so the IN list of
    eight hosts keeps the identity grouping and needs no fold."""
    tt, *_ = setup
    inst = Instance(device="cpu", mesh=make_mesh(["cpu"] * 4),
                    mesh_opts=MeshOptions(pallas_kernels="on", **LOW))
    inst.catalog.register(tt)
    folding = set()
    for name, sql, _ in SUITE:
        inst.sql(sql)
        if inst.query_engine.last_range["comm_bytes"] > 0:
            folding.add(name)
    assert folding == {"groupby_orderby_limit", "single_groupby_1_1_1",
                       "single_groupby_1_1_12", "cpu_max_all_1",
                       "q2_by_region"}


def test_unported_statements_raise(setup):
    """Statements the port does not run yet. (The plain, aggregate and
    host RANGE shapes this list held are answered now and held against
    Standalone.sql in tests/test_torch_sql_host.py; INSERT runs since the
    server slice, tests/test_torch_statements.py, and window functions
    since the window slice, tests/test_torch_window.py; set operations
    since the relational slice, tests/test_torch_relational.py; EXPLAIN
    since the introspection and session slice, tests/test_torch_session.py,
    so it answers here.) CREATE TABLE needs a storage engine, which this
    Instance lacks."""
    _, inst, _, _ = setup
    assert inst.sql("EXPLAIN SELECT 1").rows() == [
        ["SelectPlan[plain] table=None"],
        ["  Scan: ts=[None, None] matchers=[] residual=None"]]
    with pytest.raises(UnsupportedError):
        inst.sql("CREATE TABLE t (ts timestamp time index, v double)")


def test_promql_reads_the_instance(setup):
    tt, inst, _, _ = setup
    v, _ = PromEngine(inst).query_range(
        'sum by (region) (rate(cpu{__field__="usage_user"}[1m]))',
        HOUR_MS, 2 * HOUR_MS, 60_000)
    assert v.num_series == REGIONS


def test_matcher_memo_keys_on_matchers_and_registry_version():
    """A grid entry memoizes a matcher query's device inputs per (matcher
    key, registry version), as the JAX package does."""
    inst = Instance(device="cpu")
    t2 = Table("cpu", ts_name="ts", tag_names=TAGS, fields=FIELDS + [SIGNED])
    inst.catalog.register(t2)
    hosts, region_of, runs = _runs()
    _write(t2, hosts, region_of, runs[:3])
    assert inst.sql(SUITE[4][1]).num_rows == 60      # one hour of minutes
    entry = next(iter(inst.query_engine.range_cache._entries.values()))
    assert {k[0] for k in entry.query_memo} == {
        ((("hostname", "eq", "host_17"),), t2.region.series.version)}


def _signed_zero_runs(seed=9):
    """16 hosts in 2 regions, one sample an hour for 4 hours, values
    mostly -0.0 and +0.0 (both zeros inside most (region, hour) cells)."""
    rng = np.random.default_rng(seed)
    hosts = np.array([f"host_{i}" for i in range(16)], object)
    region = np.array([f"region_{i % 2}" for i in range(16)], object)
    ts = np.repeat(np.arange(4, dtype=np.int64) * HOUR_MS, 16)
    hi = np.tile(np.arange(16), 4)
    v = rng.choice(np.array([-0.0, 0.0, 1.5, -2.5]), len(ts),
                   p=[0.45, 0.45, 0.05, 0.05])
    return {"hostname": hosts[hi], "region": region[hi]}, ts, v


ZERO_SQL = ("SELECT ts, region, min(v) RANGE '1h', max(v) RANGE '1h' FROM z "
            "ALIGN '1h' BY (region)")


def test_signed_zeros_in_range_min_max_match_jax(tmp_path):
    """RANGE min/max over cells that hold both -0.0 and +0.0: XLA's
    segment_min/max order -0.0 below +0.0, so min is -0.0 and max +0.0
    wherever both meet; scatter_reduce alone keeps either. Bits against
    the JAX package, on one device and on four shards."""
    tags, ts, v = _signed_zero_runs()
    jinst = Standalone(str(tmp_path), prefer_device=True, warm_start=False)
    jinst.execute_sql("create table z (ts timestamp time index, hostname "
                      "string primary key, region string primary key, "
                      "v double)")
    jinst.catalog.table("public", "z").write(tags, ts, {"v": v})
    want = jinst.sql(ZERO_SQL)
    assert jinst.query_engine.last_exec_path == "device"
    jinst.close()
    tz = Table("z", ts_name="ts", tag_names=TAGS, fields=["v"])
    tz.write(tags, ts, {"v": v})
    zeros = 0
    for mesh, opts in ((None, None),
                       (make_mesh(["cpu"] * 4),
                        MeshOptions(pallas_kernels="on", **LOW)),
                       (make_mesh(["cpu"] * 4),
                        MeshOptions(pallas_kernels="off", **LOW))):
        inst = Instance(device="cpu", mesh=mesh, mesh_opts=opts)
        inst.catalog.register(tz)
        got = inst.sql(ZERO_SQL)
        _assert_identical(want, got)
        vals = np.concatenate([np.asarray(c.values) for c in got.cols[2:]])
        zeros = int((vals == 0).sum())
    assert zeros > 0
    mins = np.asarray(want.cols[2].values)
    maxs = np.asarray(want.cols[3].values)
    assert np.signbit(mins[mins == 0]).any()
    assert not np.signbit(maxs[maxs == 0]).any()
