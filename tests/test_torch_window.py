"""SQL window functions (OVER) through the port's Standalone against the
JAX package's, on the CPU.

Both packages get the same rows, made from a seed with numpy, in tables of
the same schema, and run the same SQL text. Every function of
window_fns._dispatch runs over every frame mode (running with peers,
ROWS running, ROWS k PRECEDING, whole partition, explicit UNBOUNDED
FOLLOWING, no partition), with the JAX package's x64 mode on and off
(the port's Standalone(x64=...)), and the aggregates also with
DEVICE_THRESHOLD patched to 100 in both packages, so that their running
frames take the device path: the segmented scans (kernel S's plain
version) here, associative_scan there. Every answer is bit for bit, and
both engines report the same path (the JAX package's exec_path_window
note, the port's QueryEngine.last_window_path). Floats are held bit for
bit except NaN payloads, whose positions are held (`_same_result`).

The sharded ROWS k PRECEDING path runs over the port's process-wide mesh
of 8 shards on the CPU against the JAX package's mesh of 8 host devices,
bit for bit: the per-shard float64 cumsum copies XLA:CPU's order
(ops/window._xla_cumsum). The JAX package's own window tests
(tests/test_grid_window.py, tests/test_mesh_query.py and a seeded slice
of tests/fuzz/test_fuzz_window.py) have counterparts here, against the
same expected values or oracle, and against the JAX package.
"""

import contextlib

import jax
import numpy as np
import pytest

from greptimedb_tpu.instance import Standalone as JStandalone
from greptimedb_tpu.parallel import mesh as JM
from greptimedb_tpu.query import stats as jstats
from greptimedb_tpu.query import window_fns as JW
from greptimedb_tpu_torch.errors import PlanError, UnsupportedError
from greptimedb_tpu_torch.instance import Standalone
from greptimedb_tpu_torch.parallel import mesh as TM
from greptimedb_tpu_torch.query import window_fns as TW
from tests.fuzz.test_fuzz_window import _oracle

SCHEMA = ("create table t (ts timestamp time index, g string primary key, "
          "h string primary key, v double, b bigint, x double)")
SERIES, STEPS = 12, 60


def _rows(seed=0):
    """12 series (g; h = g % 3, so a partition by h holds peers on ts),
    60 steps at 1 s: v N(50, 20) with 10 % nulls, b in 0..4 (ties), x
    with NaN and +-inf."""
    rng = np.random.default_rng(seed)
    n = SERIES * STEPS
    gi = np.repeat(np.arange(SERIES), STEPS)
    tags = {"g": np.array([f"g{i:02d}" for i in gi], object),
            "h": np.array([f"h{i % 3}" for i in gi], object)}
    ts = np.tile(np.arange(STEPS, dtype=np.int64) * 1000, SERIES)
    x = rng.standard_normal(n)
    pick = rng.random(n)
    x[pick < 0.02] = np.nan
    x[(pick >= 0.02) & (pick < 0.04)] = np.inf
    x[(pick >= 0.04) & (pick < 0.06)] = -np.inf
    fields = {"v": np.round(rng.normal(50, 20, n), 3),
              "b": rng.integers(0, 5, n).astype(np.int64), "x": x}
    valid = {"v": rng.random(n) >= 0.1}
    return tags, ts, fields, valid


def _load(inst, rows):
    inst.execute_sql(SCHEMA)
    tags, ts, fields, valid = rows
    inst.catalog.table("public", "t").write(tags, ts, fields,
                                            field_valid=valid)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX Standalone, {x64: port Standalone}) over the same rows."""
    rows = _rows()
    root = tmp_path_factory.mktemp("window")
    j = JStandalone(str(root / "jax"), prefer_device=False,
                    warm_start=False)
    _load(j, rows)
    ports = {}
    for x64 in (False, True):
        ports[x64] = Standalone(str(root / f"port{x64}"), device="cpu",
                                x64=x64, warm_start=False)
        _load(ports[x64], rows)
    yield j, ports
    j.close()
    for p in ports.values():
        p.close()


@contextlib.contextmanager
def _jax_x64(on: bool):
    saved = bool(jax.config.read("jax_enable_x64"))
    jax.config.update("jax_enable_x64", on)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", saved)


def _run_both(j, port, sql, x64):
    """(JAX result, JAX window path, port result, port window path); an
    error in the JAX package must be the same error class in the port."""
    with _jax_x64(x64), jstats.collect() as st:
        try:
            want = j.sql(sql)
        except Exception as e:      # noqa: BLE001 - compared below
            with pytest.raises(Exception) as raised:
                port.sql(sql)
            assert type(raised.value).__name__ == type(e).__name__
            assert str(raised.value) == str(e)
            return None, None, None, None
    got = port.sql(sql)
    return (want, st.notes.get("exec_path_window"), got,
            port.query_engine.last_window_path)


def _same_result(want, got):
    assert want.names == got.names
    assert want.num_rows == got.num_rows
    for a, b in zip(want.cols, got.cols):
        assert np.array_equal(a.valid_mask, b.valid_mask)
        va, vb = np.asarray(a.values), np.asarray(b.values)
        assert va.dtype == vb.dtype, (va.dtype, vb.dtype)
        if va.dtype.kind == "f":
            # NaN positions, every other valid cell's bits: where NaNs of
            # both signs meet in a sum (an input NaN and inf + -inf's
            # default NaN), which survives is the compiler's choice on
            # both sides (ROADMAP C2's NaN bits)
            ok = a.valid_mask
            nan = np.isnan(va)
            assert np.array_equal(nan, np.isnan(vb))
            ok = ok & ~nan
            assert np.array_equal(va[ok].view(np.uint64),
                                  vb[ok].view(np.uint64))
        else:
            assert np.array_equal(va, vb)


FUNCS = ["row_number()", "rank()", "dense_rank()", "percent_rank()",
         "cume_dist()", "ntile(4)", "lag(v)", "lag(v, 2, 0.5)", "lead(v)",
         "lead(v, 3, -1.0)", "first_value(v)", "last_value(v)",
         "nth_value(v, 2)"]
AGGS = ["sum(v)", "count(v)", "count(*)", "avg(v)", "min(v)", "max(v)",
        "sum(x)", "max(x)"]
SPECS = {
    "running": "PARTITION BY h ORDER BY ts",
    "running_desc_nulls": "PARTITION BY g ORDER BY v DESC NULLS FIRST",
    "running_rows": ("PARTITION BY h ORDER BY ts, g ROWS BETWEEN "
                     "UNBOUNDED PRECEDING AND CURRENT ROW"),
    "rows_pre": ("PARTITION BY g ORDER BY ts ROWS BETWEEN 3 PRECEDING "
                 "AND CURRENT ROW"),
    "rows_pre_short": "PARTITION BY h ORDER BY ts, g ROWS 1 PRECEDING",
    "whole": "PARTITION BY h",
    "whole_explicit": ("PARTITION BY g ORDER BY ts ROWS BETWEEN UNBOUNDED "
                       "PRECEDING AND UNBOUNDED FOLLOWING"),
    "no_partition": "ORDER BY b",
}


def _sql(func, spec):
    return (f"SELECT g, ts, {func} OVER ({SPECS[spec]}) AS w FROM t "
            "ORDER BY g, ts")


@pytest.mark.parametrize("x64", [False, True], ids=["f32", "x64"])
@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("func", FUNCS)
def test_window_function_matches_jax(pair, func, spec, x64):
    j, ports = pair
    want, _, got, _ = _run_both(j, ports[x64], _sql(func, spec), x64)
    if want is not None:
        _same_result(want, got)


@pytest.mark.parametrize("x64", [False, True], ids=["f32", "x64"])
@pytest.mark.parametrize("threshold", [100, None],
                         ids=["device", "default"])
@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("func", AGGS)
def test_window_aggregate_matches_jax(pair, monkeypatch, func, spec,
                                      threshold, x64):
    j, ports = pair
    if threshold is not None:
        monkeypatch.setattr(JW, "DEVICE_THRESHOLD", threshold)
        monkeypatch.setattr(TW, "DEVICE_THRESHOLD", threshold)
    want, jpath, got, tpath = _run_both(j, ports[x64], _sql(func, spec),
                                        x64)
    if want is None:
        return
    _same_result(want, got)
    assert tpath == jpath
    if threshold is not None and spec in ("running", "running_rows",
                                          "no_partition"):
        # the guard keeps non-finite inputs off the device without x64
        host = not x64 and "(x)" in func
        assert tpath == ("host" if host else "device")


def test_two_windows_and_an_expression_in_one_query(pair, monkeypatch):
    j, ports = pair
    monkeypatch.setattr(JW, "DEVICE_THRESHOLD", 100)
    monkeypatch.setattr(TW, "DEVICE_THRESHOLD", 100)
    sql = ("SELECT g, ts, v - avg(v) OVER (PARTITION BY g ORDER BY ts) AS d,"
           " sum(v) OVER (PARTITION BY h) + 1 AS s FROM t "
           "ORDER BY sum(v) OVER (PARTITION BY g ORDER BY ts) DESC, g, ts")
    for x64 in (False, True):
        want, jpath, got, tpath = _run_both(j, ports[x64], sql, x64)
        _same_result(want, got)
        assert tpath == jpath == "device"


def test_window_with_group_by_is_refused_as_in_jax(pair):
    j, ports = pair
    sql = ("SELECT g, sum(v), rank() OVER (ORDER BY sum(v)) FROM t "
           "GROUP BY g")
    with pytest.raises(Exception) as jerr:
        j.sql(sql)
    with pytest.raises(PlanError) as terr:
        ports[True].sql(sql)
    assert str(terr.value) == str(jerr.value)


def test_unsupported_frame_raises_as_in_jax(pair):
    j, ports = pair
    sql = ("SELECT sum(v) OVER (PARTITION BY g ORDER BY ts ROWS BETWEEN 1 "
           "PRECEDING AND 1 FOLLOWING) FROM t")
    with pytest.raises(Exception) as jerr:
        j.sql(sql)
    with pytest.raises(UnsupportedError) as terr:
        ports[True].sql(sql)
    assert str(terr.value) == str(jerr.value)


# ----------------------------------------------------------------------
# bench.py's metric shape: 61 partitions x 4,320 rows = 263,520 rows,
# past the real DEVICE_THRESHOLD
# ----------------------------------------------------------------------

@pytest.mark.parametrize("x64", [False, True], ids=["f32", "x64"])
def test_running_sum_at_the_metric_shape(tmp_path, x64):
    hosts, steps = 61, 4320
    rng = np.random.default_rng(7)
    n = hosts * steps
    tags = {"hostname": np.repeat(
        np.array([f"host_{i}" for i in range(hosts)], object), steps)}
    ts = np.tile(np.arange(steps, dtype=np.int64) * 10_000, hosts)
    u = rng.random(n) * 100.0
    sql = ("SELECT hostname, ts, sum(usage_user) OVER (PARTITION BY "
           "hostname ORDER BY ts) AS s, max(usage_user) OVER (PARTITION BY "
           "hostname ORDER BY ts) AS m, count(usage_user) OVER (PARTITION "
           "BY hostname ORDER BY ts) AS c FROM cpu")
    ddl = ("create table cpu (ts timestamp time index, hostname string "
           "primary key, usage_user double)")
    j = JStandalone(str(tmp_path / "j"), prefer_device=False,
                    warm_start=False)
    port = Standalone(str(tmp_path / "p"), device="cpu", x64=x64,
                      warm_start=False)
    try:
        for inst in (j, port):
            inst.execute_sql(ddl)
            inst.catalog.table("public", "cpu").write(
                tags, ts, {"usage_user": u})
        assert n >= TW.DEVICE_THRESHOLD == JW.DEVICE_THRESHOLD
        want, jpath, got, tpath = _run_both(j, port, sql, x64)
        _same_result(want, got)
        assert tpath == jpath == "device"
    finally:
        j.close()
        port.close()


# ----------------------------------------------------------------------
# counterparts of tests/test_grid_window.py:172-307
# ----------------------------------------------------------------------

def _small(tmp_path, x64=True):
    inst = Standalone(str(tmp_path / "d"), device="cpu", x64=x64,
                      warm_start=False)
    inst.execute_sql("create table w (ts timestamp time index, g string "
                     "primary key, v double)")
    return inst


def test_window_rows_preceding_frames(tmp_path):
    inst = _small(tmp_path)
    try:
        inst.execute_sql(
            "insert into w (ts, g, v) values (1000,'a',1),(2000,'a',2),"
            "(3000,'a',3),(4000,'a',4),(1000,'b',10),(2000,'b',20)")
        r = inst.sql(
            "select g, ts, sum(v) over (partition by g order by ts "
            "rows between 1 preceding and current row) as s, "
            "avg(v) over (partition by g order by ts "
            "rows between 1 preceding and current row) as a, "
            "count(v) over (partition by g order by ts "
            "rows between 2 preceding and current row) as c "
            "from w order by g, ts").rows()
        assert [x[2] for x in r] == [1.0, 3.0, 5.0, 7.0, 10.0, 30.0]
        assert [x[3] for x in r] == [1.0, 1.5, 2.5, 3.5, 10.0, 15.0]
        assert [x[4] for x in r] == [1, 2, 3, 3, 1, 2]
        r = inst.sql(
            "select max(v) over (partition by g order by ts "
            "rows between 1 preceding and current row) as m "
            "from w order by g, ts").rows()
        assert [x[0] for x in r] == [1.0, 2.0, 3.0, 4.0, 10.0, 20.0]
        r = inst.sql(
            "select sum(v) over (partition by g order by ts "
            "rows 1 preceding) as s from w order by g, ts").rows()
        assert [x[0] for x in r] == [1.0, 3.0, 5.0, 7.0, 10.0, 30.0]
        r = inst.sql(
            "select sum(v) over (partition by g order by ts "
            "rows unbounded preceding) as s from w order by g, ts").rows()
        assert [x[0] for x in r] == [1.0, 3.0, 6.0, 10.0, 10.0, 30.0]
    finally:
        inst.close()


def _four_partitions(inst, rng, n, vals=None):
    tab = inst.catalog.table("public", "w")
    ts = np.tile(np.arange(n // 4) * 1000, 4).astype(np.int64)
    gs = np.repeat([f"g{i}" for i in range(4)], n // 4).astype(object)
    tab.write({"g": gs}, ts, {"v": rng.random(n) * 100 if vals is None
                              else vals})


@pytest.mark.parametrize("x64", [True, False], ids=["x64", "f32"])
def test_window_device_path_matches_host(tmp_path, monkeypatch, x64):
    """Running aggregates on the device path equal the host path (rtol
    1e-12 for sums: the scan's order; 1e-9 without x64, the compensated
    pair), with the JAX package's data shapes: without x64 large
    magnitudes plus tiny increments."""
    rng = np.random.default_rng(42)
    inst = _small(tmp_path, x64)
    try:
        n = 4000 if x64 else 8000
        vals = None if x64 else rng.random(n) * 1e6 + rng.random(n) * 1e-3
        _four_partitions(inst, rng, n, vals)
        agg = "min" if x64 else "max"
        q = ("select g, ts, sum(v) over (partition by g order by ts) "
             f"as s, {agg}(v) over (partition by g order by ts) as m, "
             "count(v) over (partition by g order by ts) as c "
             "from w order by g, ts")
        host = inst.sql(q).rows()
        assert inst.query_engine.last_window_path == "host"
        monkeypatch.setattr(TW, "DEVICE_THRESHOLD", 100)
        dev = inst.sql(q).rows()
        assert inst.query_engine.last_window_path == "device"
        assert len(host) == len(dev)
        for h, d in zip(host, dev):
            assert h[0] == d[0] and h[1] == d[1]
            np.testing.assert_allclose(h[2], d[2],
                                       rtol=1e-12 if x64 else 1e-9)
            if x64:
                assert h[3] == d[3]
            else:
                # two-float pairs carry 48 mantissa bits vs f64's 53
                np.testing.assert_allclose(h[3], d[3], rtol=1e-12)
            assert h[4] == d[4]
    finally:
        inst.close()


# ----------------------------------------------------------------------
# counterpart of tests/test_mesh_query.py:336-380: the port's mesh of 8
# shards on the CPU against the JAX package's 8 host devices
# ----------------------------------------------------------------------

@pytest.fixture
def meshes(devices):
    JM.reset_for_tests()
    TM.reset_for_tests()
    jmesh = JM.configure(JM.MeshOptions(enabled=True, shard_min_rows=1))
    tmesh = TM.configure(TM.MeshOptions(enabled=True, axis_size=8,
                                        shard_min_rows=1), device="cpu")
    assert jmesh.shape[JM.AXIS_SHARD] == TM.shard_count(tmesh) == 8
    yield
    JM.reset_for_tests()
    TM.reset_for_tests()


@pytest.mark.parametrize("k,n", [(1, 4000), (5, 4000), (40, 4000),
                                 (300, 264_000)])
def test_rows_preceding_window_on_global_mesh(tmp_path, monkeypatch, meshes,
                                              k, n):
    """At 4,000 rows with DEVICE_THRESHOLD patched to 100, and at 264,000
    rows past the real threshold (33,000 rows a shard: XLA:CPU's cumsum
    order over deeper block levels)."""
    if n < TW.DEVICE_THRESHOLD:
        monkeypatch.setattr(JW, "DEVICE_THRESHOLD", 100)
        monkeypatch.setattr(TW, "DEVICE_THRESHOLD", 100)
    rng = np.random.default_rng(k)
    vals = rng.random(n) * 100
    j = JStandalone(str(tmp_path / "j"), prefer_device=False,
                    warm_start=False)
    inst = _small(tmp_path)
    try:
        j.execute_sql("create table w (ts timestamp time index, g string "
                      "primary key, v double)")
        for x in (j, inst):
            _four_partitions(x, rng, n, vals)
        frame = f"rows between {k} preceding and current row"
        q = (f"select g, ts, sum(v) over (partition by g order by ts "
             f"{frame}) as s, count(v) over (partition by g order by ts "
             f"{frame}) as c, avg(v) over (order by ts, g {frame}) as a "
             "from w order by g, ts")
        want, jpath, got, tpath = _run_both(j, inst, q, True)
        assert jpath == tpath == "device_mesh"
        _same_result(want, got)
        # host baseline: with the global mesh dropped the same query
        # runs the host path, within the documented tolerance
        TM.reset_for_tests()
        host = inst.sql(q)
        assert inst.query_engine.last_window_path is None
        np.testing.assert_allclose(got.cols[2].values, host.cols[2].values,
                                   rtol=1e-9)
        assert np.array_equal(got.cols[3].values, host.cols[3].values)
    finally:
        j.close()
        inst.close()


def test_mesh_declines_without_x64_and_below_threshold(tmp_path,
                                                       monkeypatch, meshes):
    rng = np.random.default_rng(3)
    inst = _small(tmp_path, x64=False)
    try:
        _four_partitions(inst, rng, 4000)
        q = ("select sum(v) over (partition by g order by ts rows between "
             "5 preceding and current row) from w")
        monkeypatch.setattr(TW, "DEVICE_THRESHOLD", 100)
        inst.sql(q)
        assert inst.query_engine.last_window_path is None   # no x64
        inst.query_engine.x64 = True
        monkeypatch.setattr(TW, "DEVICE_THRESHOLD", 10_000)
        inst.sql(q)
        assert inst.query_engine.last_window_path is None   # too few rows
        monkeypatch.setattr(TW, "DEVICE_THRESHOLD", 100)
        inst.sql(q)
        assert inst.query_engine.last_window_path == "device_mesh"
    finally:
        inst.close()


# ----------------------------------------------------------------------
# a seeded slice of tests/fuzz/test_fuzz_window.py: the oracle, and the
# JAX package, on the same random frames and data
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_window_fuzz_slice(tmp_path, seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(20, 120))
    hosts = [f"h{int(x)}" for x in rng.integers(0, 4, n)]
    ts = [int(x) * 1000 for x in rng.integers(0, n // 3 + 2, n)]
    v = [None if rng.random() < 0.15 else round(float(x), 3)
         for x in rng.normal(50, 20, n)]
    rows = [{"k": i, "host": hosts[i], "ts": ts[i], "v": v[i]}
            for i in range(n)]
    ddl = ("create table t (rts timestamp time index, k bigint, "
           "host string primary key, ts bigint, v double)")
    values = ", ".join(
        f"({i}, {r['k']}, '{r['host']}', {r['ts']}, "
        f"{'NULL' if r['v'] is None else r['v']})"
        for i, r in enumerate(rows))
    j = JStandalone(str(tmp_path / "j"), prefer_device=False,
                    warm_start=False)
    inst = Standalone(str(tmp_path / "p"), device="cpu", x64=True,
                      warm_start=False)
    try:
        for x in (j, inst):
            x.execute_sql(ddl)
            x.execute_sql(f"insert into t (rts, k, host, ts, v) values "
                          f"{values}")
        for func in ("row_number", "rank", "dense_rank", "count", "sum",
                     "avg", "min", "max", "first_value", "last_value",
                     "lag", "lead"):
            partition = bool(rng.random() < 0.6)
            part_sql = "PARTITION BY host " if partition else ""
            order_keys = (["ts", "k"] if func in (
                "row_number", "first_value", "last_value", "lag", "lead")
                else ["ts"])
            order_sql = "ORDER BY " + ", ".join(order_keys)
            frame_mode, frame_sql = "running", ""
            if func in ("count", "sum", "avg", "min", "max"):
                pick = rng.random()
                if pick < 0.33:
                    # a ROWS frame is order-sensitive too: the unique key
                    frame_mode = "rows"
                    order_keys = ["ts", "k"]
                    order_sql = "ORDER BY ts, k"
                    frame_sql = (" ROWS BETWEEN UNBOUNDED PRECEDING "
                                 "AND CURRENT ROW")
                elif pick < 0.55:
                    frame_mode = "whole"
                    order_sql = ""
            args = "" if func in ("row_number", "rank", "dense_rank") \
                else "v"
            q = (f"SELECT k, {func}({args}) OVER ({part_sql}{order_sql}"
                 f"{frame_sql}) AS w FROM t")
            want, _, res, _ = _run_both(j, inst, q, True)
            _same_result(want, res)
            got = {int(kk): (x if ok else None) for kk, x, ok in zip(
                res.cols[0].values, res.cols[1].values,
                res.cols[1].valid_mask)}
            oracle = _oracle(rows, func, "host" if partition else None,
                             order_keys if order_sql else [], frame_mode)
            for kk, w in oracle.items():
                g = got[kk]
                if w is None or g is None:
                    assert g == w, (q, kk, g, w)
                else:
                    assert float(g) == pytest.approx(float(w), rel=1e-9), q
    finally:
        j.close()
        inst.close()
