"""SQL on the host paths of the port against the JAX package's
Standalone.sql: row filters and projections (TSBS high-cpu-1 and
high-cpu-all), the RANGE shapes the device grid declines (residual row
filters, expression arguments, ts bounds off a cell edge, OR and NOT LIKE
predicates), RANGE with prefer_device=False, SELECT without a table and a
plain ORDER BY ... LIMIT, and the merged-scan cache that high-cpu-all
rides.

Data: a TSBS cpu table at test size (48 hosts in 4 regions, 3 h at 10 s,
three usage_* fields and a half-null signed field g), hourly runs plus a
re-delivery run (10 % of the hour's keys, new values) and a tombstone run
(1 %), written to both packages from one numpy seed.

The contract: the same rows, bit-identical values and validity, and the
same `last_exec_path`, for every statement.
"""

import numpy as np
import pytest

from greptimedb_tpu.instance import Standalone
from greptimedb_tpu.query.executor import QueryEngine as JQueryEngine
from greptimedb_tpu_torch.catalog.table import Table
from greptimedb_tpu_torch.instance import Instance
from greptimedb_tpu_torch.storage import region as tregion

HOSTS, REGIONS, HOURS, STEP_MS = 48, 4, 3, 10_000
FIELDS = ["usage_user", "usage_system", "usage_idle", "g"]
TAGS = ["hostname", "region"]
HOUR_MS = 3_600_000

HIGH_CPU = [
    # bench.py's TSBS high-cpu-1 and high-cpu-all
    ("high_cpu_1", "SELECT ts, usage_user, usage_system FROM cpu "
     "WHERE usage_user > 90.0 AND hostname = 'host_17'"),
    ("high_cpu_all", "SELECT * FROM cpu WHERE usage_user > 90.0"),
]
RANGE_ITEMS = ", ".join(f"{op}(usage_user) RANGE '1h'" for op in (
    "count", "sum", "min", "max", "avg", "stddev_samp", "first_value",
    "last_value"))
RANGE_SHAPES = [
    # the RANGE shapes the device grid declines
    ("or_matcher", f"SELECT ts, region, {RANGE_ITEMS} FROM cpu WHERE "
     "hostname = 'host_3' OR hostname = 'host_4' ALIGN '30m' BY (region)"),
    ("residual", f"SELECT ts, region, {RANGE_ITEMS} FROM cpu WHERE "
     "usage_user > 50 ALIGN '30m' BY (region)"),
    ("expression_arg", "SELECT ts, hostname, avg(usage_user + usage_system) "
     "RANGE '1h' FROM cpu ALIGN '1h' BY (hostname)"),
    ("ts_off_cell_edge", f"SELECT ts, region, {RANGE_ITEMS} FROM cpu WHERE "
     "ts > 3600000 ALIGN '30m' BY (region)"),
    ("not_like", "SELECT ts, hostname, max(usage_idle) RANGE '20m', "
     "count(g) RANGE '20m', sum(g) RANGE '20m' FROM cpu WHERE hostname NOT "
     "LIKE 'host_1%' ALIGN '20m' BY (hostname)"),
    # shapes that tests/test_torch_sql.py and test_torch_device_range.py
    # listed as raising before the host paths were ported
    ("residual_by_all", "SELECT ts, max(usage_user) RANGE '1h' FROM cpu "
     "WHERE usage_user > 1.0 ALIGN '1h'"),
    ("q2_residual", "SELECT ts, region, " + ", ".join(
        f"{op}(usage_user) RANGE '2h'" for op in (
            "count", "sum", "min", "max", "avg", "stddev_samp",
            "first_value", "last_value"))
     + " FROM cpu WHERE usage_user > 50.0 ALIGN '1h' BY (region)"),
    ("expression_times_two", "SELECT ts, avg(usage_user * 2) RANGE '1h' "
     "FROM cpu ALIGN '1h'"),
]
# GROUP BY on the card (prefer_device=True in both packages)
GROUP_BY = [
    ("groupby_hostname_max", "SELECT hostname, max(usage_user) FROM cpu "
     "GROUP BY hostname"),
    ("groupby_hostname_avg", "SELECT hostname, avg(usage_user) FROM cpu "
     "GROUP BY hostname"),
]
OTHER = [
    ("select_1", "SELECT 1"),
    ("select_expr", "SELECT 1 + 2 AS three, 'x' AS s"),
    ("order_limit", "SELECT ts, hostname, usage_user, g FROM cpu WHERE "
     "region = 'region_1' ORDER BY usage_user DESC, ts LIMIT 20 OFFSET 3"),
    ("fill_linear_host", "SELECT ts, region, avg(g) RANGE '30m' FROM cpu "
     "WHERE usage_idle < 20 ALIGN '15m' BY (region) FILL LINEAR"),
    ("fill_prev_host", "SELECT ts, hostname, last_value(g) RANGE '10m' FILL "
     "PREV FROM cpu WHERE hostname IN ('host_1', 'host_2') AND usage_user > "
     "30 ALIGN '10m' BY (hostname)"),
    ("distinct_plain", "SELECT DISTINCT region FROM cpu WHERE "
     "usage_system > 99 ORDER BY region"),
]
QUERIES = HIGH_CPU + RANGE_SHAPES + GROUP_BY + OTHER
# device-eligible RANGE shapes, asked with prefer_device=False
HOST_RANGE = [
    ("q2_host", f"SELECT ts, region, {RANGE_ITEMS} FROM cpu "
     "ALIGN '1h' BY (region)"),
    ("fill_null_host", "SELECT ts, hostname, min(g) RANGE '1h' FROM cpu "
     "WHERE hostname IN ('host_5', 'host_6') ALIGN '30m' BY (hostname) "
     "FILL NULL"),
]


def _runs(seed=5):
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
        for frac in (1.0, 0.10):
            sel = rng.random(len(ts)) < frac
            n = int(sel.sum())
            fields = {f: (rng.random(n, dtype=np.float32) * 100.0).astype(
                np.float64) for f in FIELDS[:3]}
            fields["g"] = rng.standard_normal(n)
            out.append(("put", hi[sel], ts[sel], fields,
                        {"g": rng.random(n) < 0.5}))
        dl = rng.random(len(ts)) < 0.01
        out.append(("delete", hi[dl], ts[dl], None, None))
    return hosts, region_of, out


def _write(table, hosts, region_of, runs):
    for kind, hi, ts, fields, valid in runs:
        tags = {"hostname": hosts[hi], "region": region_of[hi]}
        if kind == "put":
            table.write(tags, ts, fields, field_valid=valid)
        else:
            table.delete(tags, ts)


def _jax(path, runs_data):
    jinst = Standalone(str(path), prefer_device=True, warm_start=False)
    cols = ", ".join(f"{f} double" for f in FIELDS)
    jinst.execute_sql(
        "create table cpu (ts timestamp time index, hostname string "
        f"primary key, region string primary key, {cols})")
    _write(jinst.catalog.table("public", "cpu"), *runs_data)
    return jinst


def _port(runs_data, **kw):
    tt = Table("cpu", ts_name="ts", tag_names=TAGS, fields=FIELDS)
    _write(tt, *runs_data)
    inst = Instance(device="cpu", **kw)
    inst.catalog.register(tt)
    return tt, inst


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    data = _runs()
    jinst = _jax(tmp_path_factory.mktemp("jax_sql_host"), data)
    tt, inst = _port(data)
    yield data, jinst, tt, inst
    jinst.close()


def _bits(v):
    v = np.asarray(v)
    return v.view(np.uint64) if v.dtype == np.float64 else v


def _assert_identical(a, b, what):
    assert a.names == b.names, what
    assert a.num_rows == b.num_rows, what
    for name, ca, cb in zip(a.names, a.cols, b.cols):
        assert np.array_equal(ca.valid_mask, cb.valid_mask), (what, name)
        m = ca.valid_mask
        va, vb = np.asarray(ca.values)[m], np.asarray(cb.values)[m]
        if va.dtype == object or vb.dtype == object:
            assert (va == vb).all(), (what, name)
            continue
        if va.dtype.kind == "f" or vb.dtype.kind == "f":
            va, vb = va.astype(np.float64), vb.astype(np.float64)
        assert np.array_equal(_bits(va), _bits(vb)), (what, name)


@pytest.mark.parametrize("name,sql", QUERIES, ids=[q[0] for q in QUERIES])
def test_host_statements_match_standalone(setup, name, sql):
    _, jinst, _, inst = setup
    want = jinst.sql(sql)
    got = inst.sql(sql)
    assert (inst.query_engine.last_exec_path
            == jinst.query_engine.last_exec_path), name
    if name not in ("select_1", "select_expr"):
        # SELECT without a table leaves the path of the query before it
        assert inst.query_engine.last_exec_path == (
            "device" if name.startswith("groupby") else "host"), name
        assert got.num_rows > 0, name
    _assert_identical(want, got, name)


@pytest.mark.parametrize("name,sql", HOST_RANGE,
                         ids=[q[0] for q in HOST_RANGE])
def test_range_with_prefer_device_off_matches_jax_host(setup, name, sql):
    data, jinst, _, _ = setup
    _, inst = _port(data, prefer_device=False)
    saved = jinst.query_engine
    jinst.query_engine = JQueryEngine(prefer_device=False)
    try:
        want = jinst.sql(sql)
        assert jinst.query_engine.last_exec_path == "host"
    finally:
        jinst.query_engine = saved
    got = inst.sql(sql)
    assert inst.query_engine.last_exec_path == "host"
    assert inst.query_engine.last_range is None
    _assert_identical(want, got, name)


def test_high_cpu_rows_equal_a_numpy_filter_of_the_scan(setup):
    _, _, tt, inst = setup
    rows = tt.scan().rows
    host = np.asarray(tt.region.series.tag_values("hostname"))[rows.sid]
    uu = rows.fields["usage_user"]
    res = inst.sql(HIGH_CPU[0][1])
    sel = (uu > 90.0) & (host == "host_17")
    assert np.array_equal(res.column("ts").values, rows.ts[sel])
    assert np.array_equal(res.column("usage_user").values, uu[sel])
    res = inst.sql(HIGH_CPU[1][1])
    assert res.names == ["ts", *TAGS, *FIELDS]
    assert res.num_rows == int((uu > 90.0).sum())
    assert np.array_equal(res.column("usage_idle").values,
                          rows.fields["usage_idle"][uu > 90.0])


def test_merged_scan_cache_hits_and_invalidates(tmp_path, monkeypatch):
    """An unbounded scan past the cache floor is served from the cached
    row set the second time; a write and a compaction each invalidate it,
    and every answer equals Standalone.sql on the same writes."""
    monkeypatch.setattr(tregion, "_SCAN_CACHE_MIN_ROWS", 1000)
    data = _runs(seed=9)
    jinst = _jax(tmp_path, data)
    tt, inst = _port(data)
    reg = tt.region
    q = HIGH_CPU[1][1]

    def check(what):
        _assert_identical(jinst.sql(q), inst.sql(q), what)

    check("cold")
    assert reg.scan_cache_hits == 0 and reg._scan_cache is not None
    check("warm")
    assert reg.scan_cache_hits == 1
    # the cached row set serves other projections and bounded scans too
    got = inst.sql("SELECT ts, g FROM cpu WHERE usage_user > 90.0 AND "
                   "hostname = 'host_7' AND ts < 7200000")
    assert reg.scan_cache_hits == 2 and got.num_rows > 0
    _assert_identical(
        jinst.sql("SELECT ts, g FROM cpu WHERE usage_user > 90.0 AND "
                  "hostname = 'host_7' AND ts < 7200000"), got, "subset")
    # a write invalidates
    more = (np.array(["host_7", "host_8"], object),
            np.array(["region_0", "region_0"], object))
    for table in (jinst.catalog.table("public", "cpu"), tt):
        table.write({"hostname": more[0], "region": more[1]},
                    np.array([5, 7], np.int64) + 3 * HOUR_MS,
                    {"usage_user": np.array([95.0, 99.5]),
                     "usage_system": np.array([1.0, 2.0]),
                     "usage_idle": np.array([3.0, 4.0]),
                     "g": np.array([0.5, -0.5])})
    check("after write")
    assert reg.scan_cache_hits == 2
    check("after write, warm")
    assert reg.scan_cache_hits == 3
    # a compaction invalidates
    assert tt.compact(device="cpu") > 0
    check("after compaction")
    assert reg.scan_cache_hits == 3
    check("after compaction, warm")
    assert reg.scan_cache_hits == 4
    reg.invalidate_scan_cache()
    assert reg._scan_cache is None
    check("after invalidate")
    assert reg.scan_cache_hits == 4
    jinst.close()


def test_table_scan_bounds_and_matchers(setup):
    _, _, tt, _ = setup
    full = tt.scan(["usage_user"]).rows
    got = tt.scan(["usage_user"], ts_min=HOUR_MS, ts_max=2 * HOUR_MS - 1,
                  matchers=[("region", "eq", "region_2")]).rows
    regions = np.asarray(tt.region.series.tag_values("region"))
    sel = ((full.ts >= HOUR_MS) & (full.ts <= 2 * HOUR_MS - 1)
           & (regions[full.sid] == "region_2"))
    assert np.array_equal(got.ts, full.ts[sel])
    assert np.array_equal(got.sid, full.sid[sel])
    assert np.array_equal(got.fields["usage_user"],
                          full.fields["usage_user"][sel])
    assert tt.scan(matchers=[("hostname", "eq", "nope")]).rows is None
