"""The port's generic PromQL engine against the JAX package's, on the CPU.

The tables and queries of tests/test_promql_engine.py's engine tests
(http_requests: two counters, 41 samples at 15 s; mem_used: two gauges,
21 at 30 s; flip; latency_bucket), plus a table with NaN, +-inf, +-0.0,
absent samples and jittered timestamps for the functions the fast path
also serves, queried off the grid (step 20 s on 15 s data, and instant
queries, which step 1 s): selectors, range functions, subqueries,
aggregations (the generic engine's vectors are float64, as the JAX
package's tests run it with jax_enable_x64), binary and set operators,
vector matching, histogram_quantile and the host functions. Every answer
has the JAX engine's labels, presence and float32 bits.

Window sums of the gathered functions (stddev/stdvar_over_time, deriv,
predict_linear) are held bit for bit up to 15 cells a window only
(tests/test_torch_promql_ops.py says why), so their queries here keep to
windows of 12 cells (1m at a 5 s grid).
"""

import types

import numpy as np
import pytest

from greptimedb_tpu.instance import Standalone
from greptimedb_tpu.promql import fast as JF
from greptimedb_tpu.promql.engine import PromEngine as JPromEngine
from greptimedb_tpu.promql.engine import ScalarValue as JScalarValue
from greptimedb_tpu_torch.catalog.manager import CatalogManager
from greptimedb_tpu_torch.catalog.table import Table
from greptimedb_tpu_torch.errors import ExecutionError, PlanError
from greptimedb_tpu_torch.promql import fast as TF
from greptimedb_tpu_torch.promql.engine import PromEngine, ScalarValue
from greptimedb_tpu_torch.query.executor import QueryEngine

T0 = 1_700_000_000_000
I = 1000  # an instant query's step

# tests/test_promql_engine.py's engine tests: (query, start, end, step)
ENGINE_CASES = [
    ("mem_used", T0 + 60_000, T0 + 120_000, 30_000),
    ('mem_used{host="h2"}', T0 + 60_000, T0 + 60_000, I),
    ("rate(http_requests[1m])", T0 + 120_000, T0 + 300_000, 60_000),
    ("increase(http_requests[2m])", T0 + 180_000, T0 + 300_000, 60_000),
    ("avg_over_time(mem_used[2m])", T0 + 300_000, T0 + 300_000, I),
    ("min_over_time(mem_used[5m])", T0 + 300_000, T0 + 300_000, I),
    ("max_over_time(mem_used[5m])", T0 + 300_000, T0 + 300_000, I),
    ("delta(mem_used[2m])", T0 + 300_000, T0 + 300_000, I),
    ("changes(flip[10s])", T0 + 9_000, T0 + 9_000, I),
    ("resets(flip[10s])", T0 + 9_000, T0 + 9_000, I),
    ("sum(mem_used)", T0 + 60_000, T0 + 120_000, 30_000),
    ("sum by (host) (rate(http_requests[1m]))", T0 + 120_000,
     T0 + 120_000, I),
    ("avg without (host) (mem_used)", T0 + 120_000, T0 + 120_000, I),
    ("topk(1, mem_used)", T0 + 120_000, T0 + 120_000, I),
    ("quantile(0.5, mem_used)", T0 + 120_000, T0 + 120_000, I),
    ("count(mem_used)", T0 + 120_000, T0 + 120_000, I),
    ("mem_used / 2", T0 + 120_000, T0 + 120_000, I),
    ("mem_used > 60", T0 + 120_000, T0 + 120_000, I),
    ("mem_used > bool 60", T0 + 120_000, T0 + 120_000, I),
    ("mem_used + mem_used", T0 + 120_000, T0 + 120_000, I),
    ("2 + 3 * 4", T0, T0, I),
    ('mem_used and mem_used{host="h1"}', T0 + 120_000, T0 + 120_000, I),
    ('mem_used unless mem_used{host="h1"}', T0 + 120_000, T0 + 120_000,
     I),
    ("abs(mem_used - 100)", T0 + 120_000, T0 + 120_000, I),
    ("histogram_quantile(0.5, latency_bucket)", T0, T0, I),
    ('absent(mem_used{host="nope"})', T0 + 60_000, T0 + 60_000, I),
    ('label_replace(mem_used, "node", "$1", "host", "(h.)")',
     T0 + 60_000, T0 + 60_000, I),
    ('mem_used{host="h1"} offset 2m', T0 + 300_000, T0 + 300_000, I),
    ("max_over_time(rate(http_requests[1m])[5m:1m])", T0 + 420_000,
     T0 + 420_000, I),
]
# off the grid on the specials table: step 20 s on 15 s data (a 5 s grid,
# 12 cells a 1m window), then instant queries
OFF = (T0 + 300_000, T0 + 420_000, 20_000)
MORE_CASES = [(q, *OFF) for q in [
    "rate(spec[1m])", "irate(spec[1m])", "idelta(spec[1m])",
    "quantile_over_time(0.9, spec[1m])", "quantile_over_time(0, spec[1m])",
    "mad_over_time(spec[1m])", "deriv(spec[1m])",
    "predict_linear(spec[1m], 300)", "holt_winters(spec[1m], 0.5, 0.5)",
    "stddev_over_time(spec[1m])", "stdvar_over_time(spec[1m])",
    "last_over_time(spec[1m])", "first_over_time(spec[1m])",
    "present_over_time(spec[1m])", "count_over_time(spec[1m])",
    "sum_over_time(spec[1m])", "absent_over_time(spec[1m])",
    'absent_over_time(spec{host="nope"}[1m])',
    "sum by (dc) (rate(spec[1m]))", "stddev by (dc) (spec)",
    "stdvar(last_over_time(spec[1m]))", "avg by (dc) (spec)",
    "min by (dc) (spec)", "max(spec)", "group by (dc) (spec)",
    "bottomk(2, spec)", "limitk(1, spec)", "limit_ratio(0.5, spec)",
    'count_values("v", round(spec{host=~"h[0-2]"}))', "sort_desc(spec)", "sort(spec)",
    'scalar(spec{host="h1"})', "time()", "vector(1)", "timestamp(spec)",
    "clamp(spec, 0, 50)", "clamp_min(spec, 10)", "clamp_max(spec, 10)",
    "round(spec, 5)", "ln(spec)", "sqrt(spec)", "hour()", "minute(spec)",
    'label_join(spec, "hd", "-", "host", "dc")',
    'spec or spec{host="h9"}', "spec unless on(dc) spec",
    "spec * on(dc) group_left(host) sum by (dc) (spec)",
    "spec % 7", "spec ^ 0.5", "2 ^ spec", "-spec", "pi()",
    "sum by (dc) (spec) / ignoring(host) group_right sum by (dc) (spec)",
]] + [(q, T0 + 400_000, T0 + 400_000, I) for q in [
    "rate(spec[2m])", "quantile_over_time(0.5, spec[2m])",
    "holt_winters(spec[2m], 0.3, 0.7)", "max_over_time(spec[2m])",
    "sum by (dc) (increase(spec[5m]))",
    "histogram_quantile(0.9, sum by (le) (rate(latency_bucket[1m])))",
]]
RAISE_CASES = [
    ("spec[1m]", PlanError),
    ("spec + on(dc) spec", ExecutionError),
    # an infinite sample has no count_values label in either package
    ('count_values("v", spec)', OverflowError),
]


def _runs():
    runs = []
    ts = T0 + np.arange(41) * 15_000
    for host, rate in (("h1", 10.0), ("h2", 20.0)):
        runs.append(("http_requests", {"host": np.full(41, host, object),
                                       "job": np.full(41, "api", object)},
                     ts, np.arange(41) * 15.0 * rate))
    ts = T0 + np.arange(21) * 30_000
    runs.append(("mem_used", {"host": np.full(21, "h1", object)}, ts,
                 100.0 + 10.0 * np.sin(np.arange(21))))
    runs.append(("mem_used", {"host": np.full(21, "h2", object)}, ts,
                 np.full(21, 50.0)))
    runs.append(("flip", {}, T0 + np.arange(10) * 1000,
                 np.asarray([1.0, 1.0, 2.0, 1.0, 1.0, 3.0, 3.0, 0.0, 0.0,
                             5.0])))
    for le, c in (("0.1", 10.0), ("0.5", 60.0), ("1", 100.0),
                  ("+Inf", 100.0)):
        runs.append(("latency_bucket", {"le": np.asarray([le], object)},
                     np.asarray([T0]), np.asarray([c])))
    rng = np.random.default_rng(17)
    for h in range(6):
        n = 41
        keep = rng.random(n) < 0.8
        ts = (T0 + np.arange(n) * 15_000)[keep]
        vals = np.cumsum(rng.uniform(-2, 5, n))[keep]
        r = rng.random(len(vals))
        if h >= 3:      # three series with specials
            vals[r < 0.05] = np.nan
            vals[(r > 0.05) & (r < 0.08)] = np.inf
            vals[(r > 0.08) & (r < 0.1)] = -np.inf
            vals[(r > 0.1) & (r < 0.15)] = 0.0
            vals[(r > 0.15) & (r < 0.2)] = -0.0
        runs.append(("spec", {"host": np.full(len(ts), f"h{h}", object),
                              "dc": np.full(len(ts), f"dc{h % 2}", object)},
                     ts, vals))
    return runs


_DDL = {
    "http_requests": "CREATE TABLE http_requests (host STRING, job STRING, "
                     "greptime_value DOUBLE, ts TIMESTAMP TIME INDEX, "
                     "PRIMARY KEY (host, job))",
    "mem_used": "CREATE TABLE mem_used (host STRING, greptime_value DOUBLE, "
                "ts TIMESTAMP TIME INDEX, PRIMARY KEY (host))",
    "flip": "CREATE TABLE flip (greptime_value DOUBLE, "
            "ts TIMESTAMP TIME INDEX)",
    "latency_bucket": "CREATE TABLE latency_bucket (le STRING, "
                      "greptime_value DOUBLE, ts TIMESTAMP TIME INDEX, "
                      "PRIMARY KEY (le))",
    "spec": "CREATE TABLE spec (host STRING, dc STRING, "
            "greptime_value DOUBLE, ts TIMESTAMP TIME INDEX, "
            "PRIMARY KEY (host, dc))",
}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    JF.invalidate_cache()
    TF.invalidate_cache()
    inst = Standalone(str(tmp_path_factory.mktemp("jax_engine")))
    catalog = CatalogManager()
    for ddl in _DDL.values():
        inst.sql(ddl)
    for name, tags, ts, vals in _runs():
        inst.catalog.table("public", name).write(
            tags, ts, {"greptime_value": vals})
        table = catalog.maybe_table("public", name) or catalog.register(
            Table(name, ts_name="ts", tag_names=list(tags),
                  fields=["greptime_value"]))
        table.write(tags, ts, {"greptime_value": vals})
    holder = types.SimpleNamespace(catalog=catalog,
                                   query_engine=QueryEngine(device="cpu",
                                                            x64=True))
    yield JPromEngine(inst), PromEngine(holder)
    JF.invalidate_cache()
    TF.invalidate_cache()
    inst.close()


def _f32_bits(x):
    return np.asarray(x, np.float64).astype(np.float32).view(np.uint32)


def _same_values(a, b):
    return ((_f32_bits(a) == _f32_bits(b))
            | (np.isnan(np.asarray(a, np.float64))
               & np.isnan(np.asarray(b, np.float64)))).all()


def _assert_same(want, got, what):
    """Scalars: the same bits per step. Vectors: the same series (labels
    in order), presence, and float32 bits on every present slot."""
    if isinstance(want, JScalarValue):
        assert isinstance(got, ScalarValue), what
        assert _same_values(want.values, got.values), (what, want, got)
        return
    assert [sorted(lab.items()) for lab in want.labels] == [
        sorted(lab.items()) for lab in got.labels], what
    assert np.array_equal(want.present, got.present), what
    assert _same_values(want.values[want.present],
                        got.values[got.present]), (what, want.values,
                                                   got.values)


@pytest.mark.parametrize("promql,start,end,step", ENGINE_CASES)
def test_engine_shapes_match_jax(both, promql, start, end, step):
    jeng, teng = both
    want, _ = jeng.query_range(promql, start, end, step)
    got, _ = teng.query_range(promql, start, end, step)
    _assert_same(want, got, promql)


@pytest.mark.parametrize("promql,start,end,step", MORE_CASES)
def test_generic_functions_match_jax(both, promql, start, end, step):
    jeng, teng = both
    want, _ = jeng.query_range(promql, start, end, step)
    teng.last_fast = None
    got, _ = teng.query_range(promql, start, end, step)
    # the generic engine answered (latency_bucket's one sample makes a 1 s
    # grid, which the fast path serves)
    assert teng.last_fast is None or "bucket" in promql, promql
    _assert_same(want, got, promql)


@pytest.mark.parametrize("promql,err", RAISE_CASES)
def test_refused_in_both(both, promql, err):
    """Shapes the JAX engine refuses are refused the same way."""
    jeng, teng = both
    with pytest.raises(Exception) as jerr:
        jeng.query_range(promql, *OFF)
    assert type(jerr.value).__name__ == err.__name__
    with pytest.raises(err):
        teng.query_range(promql, *OFF)


def test_query_instant_off_the_grid(both):
    """query_instant steps 1 s: the fast path declines every grid and the
    generic engine answers."""
    jeng, teng = both
    for q in ("sum by (dc) (rate(spec[1m]))", "spec",
              "histogram_quantile(0.5, latency_bucket)",
              "topk(2, rate(spec[2m]))"):
        want, jev = jeng.query_instant(q, T0 + 300_000)
        got, tev = teng.query_instant(q, T0 + 300_000)
        assert jev.num_steps == tev.num_steps == 1
        _assert_same(want, got, q)


@pytest.mark.parametrize("promql", ["mem_used", "sum(rate(http_requests[1m]))",
                                    "2 * 3"])
def test_query_range_result_matches_jax(both, promql):
    """The SQL-shaped result (TQL EVAL's): the same column names, and the
    same ts, value and label columns."""
    jeng, teng = both
    span = (T0 + 60_000, T0 + 300_000, 30_000)
    want = jeng.query_range_result(promql, *span)
    got = teng.query_range_result(promql, *span)
    assert want.names == got.names
    for wc, gc in zip(want.cols, got.cols):
        wv, gv = np.asarray(wc.values), np.asarray(gc.values)
        if wv.dtype == object:
            assert wv.tolist() == gv.tolist()
        else:
            assert np.array_equal(wv, gv)
