"""The slice as a whole: TSBS-shaped ingest -> compaction -> RANGE queries,
PyTorch port (device="cpu", plain kernel versions) against the JAX package.

Data: 64 hosts in 4 regions, 6 h at 10 s, four usage_* fields, written as
hourly runs plus one late re-delivery run (new values for some keys, some
tombstones). The JAX side writes them to a Standalone table and runs its
QueryEngine(prefer_device=True); the port writes the same runs to its
Table, compacts every hour window through merge_rows (fused, verify=True)
and runs its QueryEngine(device="cpu") on plan_from_fields(jax_plan).

Q1 is TSBS double-groupby-all (avg of every field, RANGE 1h ALIGN 1h BY
hostname: one series per group, no fold, disjoint windows). Q2 groups by
region (fold through K2) over overlapping 2 h windows (stride-doubling
window combine).

Exactness: counts, min/max, first/last, presence, timestamps and keys are
exact. Q2's folded sums and means are exact too: K2 adds in XLA's
segment_sum order and the window combine is elementwise. Two bounds:

- Q1's sums reduce w = 360 cells per window in torch's order instead of
  XLA's (_disjoint_reduce); each order's rounding error is at most
  (w - 1) * 2^-24 * sum|x|, so two orders differ by at most twice that —
  with usage values >= 0, a relative bound of 2 * (w - 1) * 2^-24 on sum
  and mean.
- stddev: XLA:CPU contracts var = s2/n - mean*mean into one fused
  multiply-add; the port rounds mean*mean first. The two variances
  differ by at most u * mean^2 + 2u * var before the n/(n-1) correction
  (u = 2^-24), so with c = n/(n-1) the squared results differ by at most
  4u * c * (mean^2 + var).
"""

import numpy as np
import pytest

from greptimedb_tpu.instance import Standalone
from greptimedb_tpu.query import device_range as jdr
from greptimedb_tpu.query.executor import QueryEngine as JQueryEngine
from greptimedb_tpu.query.planner import plan_select
from greptimedb_tpu.sql.parser import parse_sql
from greptimedb_tpu_torch.catalog.table import Table
from greptimedb_tpu_torch.errors import UnsupportedError
from greptimedb_tpu_torch.parallel.kernels import merge_gather, ring_fold
from greptimedb_tpu_torch.query import device_range as tdr
from greptimedb_tpu_torch.query.executor import QueryEngine
from greptimedb_tpu_torch.query.planner import plan_from_fields

HOSTS, REGIONS, HOURS, STEP_MS = 64, 4, 6, 10_000
FIELDS = ["usage_user", "usage_system", "usage_idle", "usage_nice"]
TAGS = ["hostname", "region"]
HOUR_MS = 3_600_000
U = 2.0 ** -24

Q1 = ("SELECT ts, hostname, "
      + ", ".join(f"avg({f}) RANGE '1h'" for f in FIELDS)
      + " FROM cpu ALIGN '1h' BY (hostname)")
Q2_OPS = ["count", "sum", "min", "max", "avg", "stddev_samp",
          "first_value", "last_value"]
Q2 = ("SELECT ts, region, "
      + ", ".join(f"{op}(usage_user) RANGE '2h'" for op in Q2_OPS)
      + " FROM cpu ALIGN '1h' BY (region)")


def _runs(seed=0):
    """The write sequence: per hour one run, then one re-delivery run
    (10% of the hour's keys, new values) and one tombstone run (1%)."""
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


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    hosts, region_of, runs = _runs()
    inst = Standalone(str(tmp_path_factory.mktemp("jax_tsbs")))
    cols = ", ".join(f"{f} double" for f in FIELDS)
    inst.execute_sql(
        "create table cpu (ts timestamp time index, hostname string "
        f"primary key, region string primary key, {cols})"
    )
    jt = inst.catalog.table("public", "cpu")
    _write(jt, hosts, region_of, runs)
    tt = Table("cpu", ts_name="ts", tag_names=TAGS, fields=FIELDS)
    _write(tt, hosts, region_of, runs)
    merged = tt.compact(device="cpu", verify=True, kernels="on",
                        kernel_min_rows=1, device_min_rows=1)
    assert merged == HOURS
    assert tt.region.merge_paths == ["fused"] * HOURS
    yield jt, tt
    inst.close()


def _plan(sql):
    return plan_select(parse_sql(sql)[0], ts_name="ts", tag_names=TAGS,
                       all_columns=None)


def _op_of(name):
    return name.split("(")[0]


def _compare(want, got, *, w, exact_sums):
    """exact_sums: sums and means must be bit-equal too; else they are
    held to the relative bound 2 * (w - 1) * 2^-24. stddev is held to the
    FMA bound (module docstring)."""
    assert got.names == want.names
    assert got.num_rows == want.num_rows > 0
    by_op = {_op_of(n): i for i, n in enumerate(want.names)}
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
        elif name == "ts" or exact_sums or op in (
                "count", "min", "max", "first_value", "last_value"):
            assert np.array_equal(av.astype(np.float64),
                                  bv.astype(np.float64)), name
        else:
            bound = 2 * (w - 1) * U
            assert np.all(np.abs(av - bv) <= bound * np.abs(av)), name


def test_compacted_scan_equals_jax_scan(tables):
    jt, tt = tables
    want = jt.scan(field_names=FIELDS).rows
    got = tt.scan(FIELDS).rows
    assert len(got) == len(want)
    for name in ("sid", "ts"):
        assert np.array_equal(getattr(got, name), getattr(want, name))
    for f in FIELDS:
        assert np.array_equal(got.fields[f].view(np.uint64),
                              want.fields[f].view(np.uint64))


@pytest.mark.parametrize("q,w,exact", [(Q1, 360, False), (Q2, 720, True)],
                         ids=["q1_double_groupby_all", "q2_by_region"])
def test_range_query_matches_jax_engine(tables, q, w, exact):
    jt, tt = tables
    jplan = _plan(q)
    want = JQueryEngine(prefer_device=True).execute(jplan, jt)
    eng = QueryEngine(device="cpu")
    got = eng.execute(plan_from_fields(jplan), tt)
    _compare(want, got, w=w, exact_sums=exact)
    # the second run reuses the cached grid
    again = eng.execute(plan_from_fields(jplan), tt)
    _compare(want, again, w=w, exact_sums=exact)
    assert eng.range_cache.hits >= 1


@pytest.mark.parametrize("q,w,exact", [(Q1, 360, False), (Q2, 720, True)],
                         ids=["q1_double_groupby_all", "q2_by_region"])
def test_range_program_on_jax_grid_arrays(tables, q, w, exact):
    """Both range programs on bit-identical grids: the JAX entry's host
    arrays carried into a port entry with entry_from_host_arrays."""
    jt, tt = tables
    jplan = _plan(q)
    items = jdr.plan_lowering(jplan, jt)
    jentry = jdr.build_entry(jplan, jt, items, keep_host=True)
    meta = {"res": jentry.res, "phase": jentry.phase, "t0c": jentry.t0c,
            "nb": jentry.nb, "num_series": jentry.num_series,
            "nan_ok": dict(jentry.nan_ok)}
    entry = tdr.entry_from_host_arrays(jentry.host_snap, meta,
                                       registry=tt.region.series,
                                       device="cpu")
    eng = QueryEngine(device="cpu")
    plan = plan_from_fields(jplan)
    got = tdr.execute_on_entry(eng, plan, tt, entry)
    want = JQueryEngine(prefer_device=True).execute(jplan, jt)
    _compare(want, got, w=w, exact_sums=exact)


def test_q1_matches_numpy_hourly_means(tables):
    _, tt = tables
    got = QueryEngine(device="cpu").execute(plan_from_fields(_plan(Q1)), tt)
    rows = tt.scan(FIELDS).rows
    hosts = np.asarray(tt.region.series.tag_values("hostname"))[rows.sid]
    hour = rows.ts // HOUR_MS
    ts_col = got.column("ts").values
    host_col = got.column("hostname").values
    for f in FIELDS:
        name = next(n for n in got.names if f in n)
        vals = got.column(name).values
        for i in range(0, got.num_rows, 37):
            sel = (hosts == host_col[i]) & (hour == ts_col[i] // HOUR_MS)
            assert np.isclose(vals[i], rows.fields[f][sel].mean(),
                              rtol=1e-5)


def test_unported_shapes_raise(tables):
    _, tt = tables
    eng = QueryEngine(device="cpu")
    for sql in (
        Q2.replace("FROM cpu", "FROM cpu WHERE usage_user > 50.0"),
        "SELECT hostname, avg(usage_user) FROM cpu GROUP BY hostname",
        "SELECT ts, avg(usage_user * 2) RANGE '1h' FROM cpu ALIGN '1h'",
    ):
        with pytest.raises(UnsupportedError):
            eng.execute(plan_from_fields(_plan(sql)), tt)


def test_cpu_run_launches_no_kernel(tables):
    assert merge_gather.gather_planes.launches == 0
    assert ring_fold.blocked_fold_sum.launches == 0
