"""The slice as a whole: TSBS-shaped ingest -> compaction -> RANGE queries,
PyTorch port (device="cpu", plain kernel versions) against the JAX package.

Data: 64 hosts in 4 regions, 6 h at 10 s, four usage_* fields in [0, 100)
and a signed field g drawn from N(0, 1) with about half its cells null
(its own seeded generator), written as hourly runs plus one late
re-delivery run (new values for some keys, some tombstones). The JAX side writes them to a Standalone table and runs its
QueryEngine(prefer_device=True); the port writes the same runs to its
Table, compacts every hour window through merge_rows (fused, verify=True)
and runs its QueryEngine(device="cpu") on plan_from_fields(jax_plan).

Q1 is TSBS double-groupby-all (avg of every field, RANGE 1h ALIGN 1h BY
hostname: one series per group, no fold, disjoint windows). Q2 groups by
region (fold through K2) over overlapping 2 h windows (stride-doubling
window combine).

Exactness: counts, min/max, first/last, presence, timestamps and keys are
exact. Q2's folded sums and means are exact too: K2 adds in XLA's
segment_sum order and the window combine is elementwise. Bounds
(u = 2^-24):

- Disjoint windows (range == align: Q1, and the signed field's queries)
  reduce w cells per window in torch's order instead of XLA's
  (_disjoint_reduce); each order's rounding error is at most
  (w - 1) u sum|x| over the window's rows, so two orders differ by at most
  E1 = 2 (w - 1) u sum|x| per cell, and the means by E1 / n. sum|x| comes
  from the written rows (the compacted scan). For values >= 0 this is the
  relative bound 2 (w - 1) u on sum and mean; on signed data a sum may
  cancel far below sum|x|, so a bound relative to the sum does not hold.
- stddev, var: XLA:CPU contracts var = s2/n - mean*mean into one fused
  multiply-add, and so does the port (ops/window._fma), so with the same
  s1, s2 (overlapping windows) they are bit-equal. Over disjoint windows
  s1 = sum x and s2 = sum x^2 differ by the reduction orders, by at most E1
  and E2 = 2 (w - 1) u sum x^2, which moves var by at most
  c * (E2 + 2 |mean| E1) / n (to first order), with c = n/(n-1):
  |a^2 - b^2| <= c (E2 + 2 |mean| E1) / n.
"""

import contextlib
import re
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from greptimedb_tpu.instance import Standalone
from greptimedb_tpu.query import device_range as jdr
from greptimedb_tpu.query.executor import QueryEngine as JQueryEngine
from greptimedb_tpu.query.planner import plan_select
from greptimedb_tpu.sql.parser import parse_sql
from greptimedb_tpu_torch.catalog.table import Table
from greptimedb_tpu_torch.errors import UnsupportedError
from greptimedb_tpu_torch.parallel.kernels import merge_gather, ring_fold
from greptimedb_tpu_torch.parallel.mesh import MeshOptions, make_mesh
from greptimedb_tpu_torch.query import device_range as tdr
from greptimedb_tpu_torch.query.executor import QueryEngine
from greptimedb_tpu_torch.query.planner import plan_from_fields

HOSTS, REGIONS, HOURS, STEP_MS = 64, 4, 6, 10_000
FIELDS = ["usage_user", "usage_system", "usage_idle", "usage_nice"]
SIGNED = "g"          # N(0, 1), about half its cells null
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


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    hosts, region_of, runs = _runs()
    inst = Standalone(str(tmp_path_factory.mktemp("jax_tsbs")))
    cols = ", ".join(f"{f} double" for f in FIELDS + [SIGNED])
    inst.execute_sql(
        "create table cpu (ts timestamp time index, hostname string "
        f"primary key, region string primary key, {cols})"
    )
    jt = inst.catalog.table("public", "cpu")
    _write(jt, hosts, region_of, runs)
    tt = Table("cpu", ts_name="ts", tag_names=TAGS, fields=FIELDS + [SIGNED])
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


def _cell_stats(table, res, field, keys, range_ms):
    """Per output row of `res`: (n, sum|x|, sum x^2) in float64 over the
    valid `field` values of the written rows (the table's compacted scan)
    in the row's window [ts, ts + range_ms) of the series whose `keys` tags
    equal the row's (range == align, aligned to 0: disjoint windows)."""
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
    stats = [np.bincount(row_cell, weights=wt, minlength=size)[res_cell]
             for wt in (np.ones_like(x), np.abs(x), x * x)]
    return tuple(stats)


def _compare(want, got, *, w, exact_sums, stats=None):
    """exact_sums: sums and means must be bit-equal too (overlapping
    windows); else (disjoint windows) they are held to E1 and E1 / n, and
    stddev to the FMA gap plus the reorder gap, from stats[column] =
    _cell_stats(...) (module docstring). With exact_sums stddev must be
    bit-equal too."""
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
        if op == "stddev_samp" and exact_sums:
            assert av.dtype == bv.dtype, name
            assert np.array_equal(av.view(np.uint8), bv.view(np.uint8)), name
        elif op == "stddev_samp":
            n = np.asarray(want.cols[by_op["count"]].values)[m]
            mean = np.asarray(want.cols[by_op["avg"]].values)[m]
            c = n / np.maximum(n - 1, 1)
            _, abs1, sq = (v[m] for v in stats[name])
            e1, e2 = 2 * (w - 1) * U * abs1, 2 * (w - 1) * U * sq
            bound = c * (e2 + 2 * np.abs(mean) * e1) / n
            assert np.all(np.abs(bv * bv - av * av) <= bound), name
        elif name == "ts" or exact_sums or op in (
                "count", "min", "max", "first_value", "last_value"):
            assert np.array_equal(av.astype(np.float64),
                                  bv.astype(np.float64)), name
        else:
            cnt, abs1, _ = (v[m] for v in stats[name])
            bound = 2 * (w - 1) * U * abs1
            if op == "avg":
                bound = bound / cnt
            assert np.all(np.abs(av - bv) <= bound), name


def _stats(tt, res, keys, range_ms):
    """_cell_stats for every sum/avg/stddev column of `res`, by the field
    its name holds."""
    return {name: _cell_stats(tt, res, re.search(r"\((\w+)\)", name)[1],
                              keys, range_ms)
            for name in res.names if _op_of(name) in (
                "sum", "avg", "stddev_samp")}


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
    stats = None if exact else _stats(tt, want, ["hostname"], HOUR_MS)
    _compare(want, got, w=w, exact_sums=exact, stats=stats)
    # the second run reuses the cached grid
    again = eng.execute(plan_from_fields(jplan), tt)
    _compare(want, again, w=w, exact_sums=exact, stats=stats)
    assert eng.range_cache.hits >= 1


def _bits(v):
    v = np.asarray(v)
    return v.view(np.uint64) if v.dtype == np.float64 else v


@pytest.mark.parametrize("rng_s,key", [("10m", "hostname"), ("1h", "hostname"),
                                       ("10m", "region"), ("1h", "region")])
def test_signed_field_with_nulls_holds_the_stated_bounds(tables, rng_s, key):
    """sum, avg and stddev_samp of the signed, half-null field over
    disjoint windows: one device, four ring shards and four gather shards
    against the JAX engine, within the per-cell bounds of the module
    docstring (sums cancel here, so a bound relative to the sum would
    fail), and bit-identical to each other. The counts equal the valid
    rows of each window, which checks the windows _cell_stats assumes."""
    jt, tt = tables
    range_ms = {"10m": 600_000, "1h": HOUR_MS}[rng_s]
    q = (f"SELECT ts, {key}, " + ", ".join(
        f"{op}({SIGNED}) RANGE '{rng_s}'"
        for op in ("count", "sum", "avg", "stddev_samp"))
        + f" FROM cpu ALIGN '{rng_s}' BY ({key})")
    jplan = _plan(q)
    want = JQueryEngine(prefer_device=True).execute(jplan, jt)
    stats = _stats(tt, want, [key], range_ms)
    cnt = next(c for c in want.names if c.startswith("count"))
    m = want.column(cnt).valid_mask
    assert np.array_equal(np.asarray(want.column(cnt).values)[m],
                          stats[next(c for c in want.names
                                     if c.startswith("sum"))][0][m])
    low = {"shard_min_series": 1, "pallas_min_series": 1}
    engines = {
        "single": QueryEngine(device="cpu"),
        "ring": QueryEngine(device="cpu", mesh=make_mesh(["cpu"] * 4),
                            mesh_opts=MeshOptions(pallas_kernels="on",
                                                  **low)),
        "gather": QueryEngine(device="cpu", mesh=make_mesh(["cpu"] * 4),
                              mesh_opts=MeshOptions(pallas_kernels="off",
                                                    **low)),
    }
    w = range_ms // STEP_MS
    got = {}
    for name, eng in engines.items():
        got[name] = eng.execute(plan_from_fields(jplan), tt)
        _compare(want, got[name], w=w, exact_sums=False, stats=stats)
    assert engines["ring"].last_range["program"] == "sharded_ring"
    assert engines["gather"].last_range["program"] == "sharded_gather"
    for name in ("ring", "gather"):
        for a, b in zip(got["single"].cols, got[name].cols):
            assert np.array_equal(a.valid_mask, b.valid_mask)
            assert np.array_equal(_bits(a.values), _bits(b.values)), name
    # the data is what the bounds are about: sums that cancel well below
    # sum|x| (where the former bound, relative to the sum, breaks down)
    s = next(c for c in want.names if c.startswith("sum"))
    sm = want.column(s).valid_mask
    ws = np.asarray(want.column(s).values)[sm]
    assert (np.abs(ws) / stats[s][1][sm]).min() < 0.01
    if (rng_s, key) == ("10m", "hostname"):
        # the former bound 2 (w - 1) u |sum| fails on such cells
        gs = np.asarray(got["single"].column(s).values)[sm]
        assert (np.abs(gs - ws) > 2 * (w - 1) * U * np.abs(ws)).any()


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
    stats = None if exact else _stats(tt, want, ["hostname"], HOUR_MS)
    _compare(want, got, w=w, exact_sums=exact, stats=stats)


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
    """Plan shapes the port does not run yet. (The residual-filter and
    expression-argument RANGE shapes and the GROUP BY this list held are
    answered now, on the host RANGE path and the grouped reduce, and held
    against Standalone.sql in tests/test_torch_sql_host.py; the window
    function it held is answered too, tests/test_torch_window.py.)"""
    _, tt = tables
    eng = QueryEngine(device="cpu")
    for sql in (
        "SELECT hostname, sum(DISTINCT usage_user) FROM cpu "
        "GROUP BY hostname",
    ):
        with pytest.raises(UnsupportedError):
            eng.execute(plan_from_fields(_plan(sql)), tt)


def test_cpu_run_launches_no_kernel(tables):
    assert merge_gather.gather_planes.launches == 0
    assert ring_fold.blocked_fold_sum.launches == 0


@contextlib.contextmanager
def _jax_x64(on: bool):
    saved = bool(jax.config.read("jax_enable_x64"))
    jax.config.update("jax_enable_x64", on)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", saved)


def _fnmadd_cells(dtype, rng, m=4000):
    """Window states (n, s, s2) of `dtype` sums, drawn from `rng`, whose
    variance s2/n - mean*mean differs when mean*mean is rounded first
    (the uncontracted form, which numpy computes) from the one rounding of
    fma(-mean, mean, s2/n) (computed exactly with fractions)."""
    n = rng.integers(1, 40, m).astype(np.int32)
    nf = n.astype(np.float32)
    s = (rng.random(m) * 100.0 * n).astype(dtype)
    s2 = (s.astype(np.float64) ** 2 / n * (1.0 + rng.random(m))).astype(dtype)
    mean = s / nf.astype(dtype)
    q = s2 / nf.astype(dtype)
    loose = q - mean * mean
    tight = np.array([float(Fraction(float(b)) - Fraction(float(a)) ** 2)
                      for a, b in zip(mean, q)]).astype(dtype)
    pick = loose != tight
    return {"n": n[pick], "s": s[pick], "s2": s2[pick]}


@pytest.mark.parametrize("op", ["var_pop", "var_samp", "stddev_pop",
                                "stddev_samp"])
@pytest.mark.parametrize("dtype,x64", [(np.float32, False),
                                       (np.float32, True),
                                       (np.float64, True)],
                         ids=["f32", "f32_x64", "f64_x64"])
def test_range_variance_is_xlas_fnmadd(op, dtype, x64):
    """The RANGE programs' finalize on window sums whose contracted and
    uncontracted variances differ (ROADMAP C2): XLA:CPU computes the
    variance as one fnmadd, in float32 and in float64, and the port's bits
    equal the JAX program's on every such cell."""
    state = _fnmadd_cells(dtype, np.random.default_rng(17))
    assert len(state["n"]) > 100
    with _jax_x64(x64):
        fin = jax.jit(lambda st: jdr._finalize_j(op, st, jnp))
        want, wp = (np.asarray(a) for a in fin(
            {k: jnp.asarray(v) for k, v in state.items()}))
    got, gp = (t.numpy() for t in tdr._finalize_j(
        op, {k: torch.from_numpy(v) for k, v in state.items()}))
    assert np.array_equal(wp, gp)
    assert want.dtype == got.dtype == dtype
    assert np.array_equal(want.view(np.uint8), got.view(np.uint8))
