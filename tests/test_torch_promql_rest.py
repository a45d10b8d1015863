"""The port's fast binary and histogram paths and the quantile family of
range functions against the JAX package's fast paths, on the CPU.

The data and queries are those of tests/test_promql_fast.py: req_total
(6 hosts in 2 dcs, 41 samples at 15 s) for the arg-taking range
functions (ARG_FN_QUERIES) and the vector/vector binaries
(BINARY_QUERIES), every operator of `_BINARY_FAST_OPS` with and without
`bool`; `_mk_histogram`'s lat_bucket (6 hosts x 4 le buckets) and the
pod/svc table `lb` for histogram_quantile, with and without an inner
`sum by (le, ...)` (by (le, pod): the scatter branch, G's member order).

Every query runs on the port on one device and on 2 and 4 shards, ring
(kernels on: their plain versions on the CPU) and gather; the sharded
results are bit-identical to one device, and the one-device results to
the JAX package's, float32 bits on every present slot. The one exception
is `^`: XLA:CPU's powf is within 0.50 ulp of the exact power and torch's
within 0.57 (measured on 10^5 random pairs), so the two differ by at most
1 ulp (ROADMAP C2). Explicit matching (`on`, `ignoring`) and histograms
the fast path cannot serve fall back to the generic engine, in both
packages, with the same answers.
"""

import types

import numpy as np
import pytest

from greptimedb_tpu.instance import Standalone
from greptimedb_tpu.promql import fast as JF
from greptimedb_tpu.promql.engine import PromEngine as JPromEngine
from greptimedb_tpu_torch.catalog.manager import CatalogManager
from greptimedb_tpu_torch.catalog.table import Table
from greptimedb_tpu_torch.parallel.mesh import MeshOptions, make_mesh
from greptimedb_tpu_torch.promql import fast as TF
from greptimedb_tpu_torch.promql.engine import PromEngine
from greptimedb_tpu_torch.query import sessions
from greptimedb_tpu_torch.query.executor import QueryEngine

T0 = 1_700_000_000_000
RANGE = (T0 + 120_000, T0 + 480_000, 30_000)
HIST_RANGE = (30_000, 50_000, 10_000)
SHARDS = [2, 4]

ARG_FN_QUERIES = [
    "sum by (host) (quantile_over_time(0.9, req_total[2m]))",
    "max by (dc) (min_over_time(req_total[1m]))",
    "sum by (dc) (max_over_time(req_total[2m]))",
    "avg by (dc) (stddev_over_time(req_total[2m]))",
    "sum by (host) (deriv(req_total[2m]))",
    "sum by (host) (predict_linear(req_total[2m], 600))",
    "sum by (dc) (holt_winters(req_total[2m], 0.5, 0.5))",
    "sum by (dc) (mad_over_time(req_total[2m]))",
    "max by (dc) (deriv(req_total[2m]))",
    "min(quantile_over_time(0.25, req_total[1m]))",
    "topk(2, holt_winters(req_total[2m], 0.3, 0.7))",
]
BINARY_QUERIES = [
    "rate(req_total[1m]) / last_over_time(req_total[1m])",
    "rate(req_total[1m]) + rate(req_total[2m])",
    "req_total - last_over_time(req_total[1m])",
    "rate(req_total[1m]) > rate(req_total[2m])",
    "rate(req_total[1m]) >= bool rate(req_total[2m])",
    'rate(req_total{dc="dc0"}[1m]) * rate(req_total[1m])',
    "sum by (dc) (rate(req_total[1m]) / last_over_time(req_total[1m]))",
    "avg by (host) (req_total + req_total)",
    "sum(rate(req_total[1m]) / last_over_time(req_total[1m]))",
    "stddev by (dc) (rate(req_total[1m]) - rate(req_total[2m]))",
    "count(rate(req_total[1m]) < bool rate(req_total[2m]))",
]
OPS = ["+", "-", "*", "/", "%", "^", ">", "<", ">=", "<=", "==", "!="]
OP_QUERIES = [f"last_over_time(req_total[1m]) {op} rate(req_total[1m])"
              for op in OPS[:6]]
OP_QUERIES += [f"rate(req_total[1m]) {op} rate(req_total[2m])"
               for op in OPS[6:]]
OP_QUERIES += [f"rate(req_total[1m]) {op} bool rate(req_total[2m])"
               for op in OPS[6:]]
OP_QUERIES += ["sum by (dc) (rate(req_total[1m]) ^ rate(req_total[2m]))",
               "rate(req_total[1m]) % rate(req_total[2m])"]
HIST_QUERIES = [
    "histogram_quantile(0.9, rate(lat_bucket[30s]))",
    "histogram_quantile(0.5, lat_bucket)",
    "histogram_quantile(0.9, sum by (le, svc) (rate(lb[30s])))",
    "histogram_quantile(0.75, sum by (le, pod) (rate(lb[30s])))",
    "histogram_quantile(1.5, rate(lat_bucket[30s]))",
    "histogram_quantile(-1, rate(lat_bucket[30s]))",
]
# queries the fast path declines: the generic engine answers them
FALLBACK_QUERIES = [
    ("rate(req_total[1m]) / on(host, dc) last_over_time(req_total[1m])",
     RANGE),
    ("rate(req_total[1m]) - ignoring(dc) rate(req_total[2m])", RANGE),
    ("rate(req_total[1m]) > 0.5", RANGE),
    ("histogram_quantile(0.9, rate(noinf_bucket[30s]))", HIST_RANGE),
    ("histogram_quantile(0.9, rate(req_total[1m]))", RANGE),
]


def _runs():
    """(table, tags, ts, {field: values}) writes of both packages."""
    runs = []
    ts = T0 + np.arange(41) * 15_000
    rng = np.random.default_rng(7)
    for h in range(6):
        runs.append(("req_total", {"host": np.full(41, f"h{h}", object),
                                   "dc": np.full(41, f"dc{h % 2}", object)},
                     ts, np.cumsum(rng.uniform(0, 5, 41))))
    for name, les in (("lat_bucket", ("0.1", "0.5", "1", "+Inf")),
                      ("noinf_bucket", ("0.1", "0.5", "1"))):
        rng = np.random.default_rng(5)
        counts = {f"h{i}": np.zeros(len(les)) for i in range(6)}
        hosts, les_c, tss, vals = [], [], [], []
        for s in range(6):
            for h in counts:
                counts[h] = counts[h] + np.sort(
                    rng.integers(0, 5, size=len(les))).cumsum()
                for bi, le in enumerate(les):
                    hosts.append(h)
                    les_c.append(le)
                    tss.append(s * 10_000)
                    vals.append(float(counts[h][bi]))
        runs.append((name, {"host": np.asarray(hosts, object),
                            "le": np.asarray(les_c, object)},
                     np.asarray(tss, np.int64), np.asarray(vals)))
    les = ["0.1", "0.5", "1", "+Inf"]
    rng = np.random.default_rng(5)
    cols = {"pod": [], "svc": [], "le": []}
    tss, vals, counts = [], [], {}
    for s in range(6):
        for p in range(12):
            pod, svc = f"p{p}", f"s{p % 3}"
            counts[pod] = counts.get(pod, np.zeros(4)) + np.sort(
                rng.integers(0, 5, 4)).cumsum()
            for bi, le in enumerate(les):
                cols["pod"].append(pod)
                cols["svc"].append(svc)
                cols["le"].append(le)
                tss.append(s * 10_000)
                vals.append(float(counts[pod][bi]))
    runs.append(("lb", {k: np.asarray(v, object) for k, v in cols.items()},
                 np.asarray(tss, np.int64), np.asarray(vals)))
    return runs


_DDL = {
    "req_total": "CREATE TABLE req_total (host STRING, dc STRING, "
                 "greptime_value DOUBLE, ts TIMESTAMP TIME INDEX, "
                 "PRIMARY KEY (host, dc))",
    "lat_bucket": "create table lat_bucket (ts timestamp time index, "
                  "host string, le string, greptime_value double, "
                  "primary key (host, le))",
    "noinf_bucket": "create table noinf_bucket (ts timestamp time index, "
                    "host string, le string, greptime_value double, "
                    "primary key (host, le))",
    "lb": "create table lb (ts timestamp time index, pod string, "
          "svc string, le string, greptime_value double, "
          "primary key (pod, svc, le))",
}


def _engines(catalog):
    def holder(**kw):
        return types.SimpleNamespace(
            catalog=catalog, query_engine=QueryEngine(device="cpu", x64=True,
                                                      **kw))

    out = {"single": holder()}
    for ns in SHARDS:
        mesh = make_mesh(["cpu"] * ns)
        out[f"ring{ns}"] = holder(mesh=mesh, mesh_opts=MeshOptions(
            shard_min_series=1, pallas_kernels="on", pallas_min_series=1))
        out[f"gather{ns}"] = holder(mesh=mesh, mesh_opts=MeshOptions(
            shard_min_series=1, pallas_kernels="off"))
    return out


def _span(q):
    return HIST_RANGE if "bucket" in q or "(lb[" in q else RANGE


FAST = ARG_FN_QUERIES + BINARY_QUERIES + OP_QUERIES + HIST_QUERIES


@pytest.fixture(scope="module")
def rest(tmp_path_factory):
    JF.invalidate_cache()
    TF.invalidate_cache()
    inst = Standalone(str(tmp_path_factory.mktemp("jax_rest")),
                      prefer_device=True, warm_start=False)
    catalog = CatalogManager()
    for name, ddl in _DDL.items():
        inst.sql(ddl)
    for name, tags, ts, vals in _runs():
        inst.catalog.table("public", name).write(
            tags, ts, {"greptime_value": vals})
        table = catalog.maybe_table("public", name) or catalog.register(
            Table(name, ts_name="ts", tag_names=list(tags),
                  fields=["greptime_value"]))
        table.write(tags, ts, {"greptime_value": vals})
    queries = FAST + [q for q, _ in FALLBACK_QUERIES]
    jax_res = {q: JPromEngine(inst).query_range(q, *_span(q))[0]
               for q in queries}
    port, notes = {}, {}
    for name, holder in _engines(catalog).items():
        eng = PromEngine(holder)
        for q in queries:
            eng.last_fast = None
            port[name, q] = eng.query_range(q, *_span(q))[0]
            notes[name, q] = eng.last_fast
    yield {"jax": jax_res, "port": port, "notes": notes, "inst": inst,
           "catalog": catalog}
    JF.invalidate_cache()
    TF.invalidate_cache()
    inst.close()


def _as_map(v):
    return {tuple(sorted(lab.items())): (v.values[i], v.present[i])
            for i, lab in enumerate(v.labels)}


def _f32_bits(x):
    return np.asarray(x, np.float64).astype(np.float32).view(np.uint32)


def _assert_same(want, got, what, ulps=0):
    """Same series (by labels), same presence, and the same float32 bits
    on every present slot (NaN equal to NaN), or within `ulps`."""
    a, b = _as_map(want), _as_map(got)
    assert set(a) == set(b), (what, set(a) ^ set(b))
    for key in a:
        (va, pa), (vb, pb) = a[key], b[key]
        assert np.array_equal(pa, pb), (what, key)
        x = np.asarray(va[pa], np.float64).astype(np.float32)
        y = np.asarray(vb[pb], np.float64).astype(np.float32)
        same = (_f32_bits(x) == _f32_bits(y)) | (np.isnan(x) & np.isnan(y))
        if ulps:
            fin = np.isfinite(x) & np.isfinite(y)
            gap = np.abs(x[fin].astype(np.float64) - y[fin])
            same[fin] |= gap <= ulps * np.spacing(np.abs(x[fin]))
        assert same.all(), (what, key, va[pa], vb[pb])


@pytest.mark.parametrize("promql", FAST)
def test_fast_path_matches_jax(rest, promql):
    want = rest["jax"][promql]
    # rates over 1m and 2m windows are never equal here
    assert want.num_series > 0 or " == " in promql, promql
    _assert_same(want, rest["port"]["single", promql], promql,
                 ulps=1 if "^" in promql and "sum" not in promql else 0)
    kind = rest["notes"]["single", promql]["kind"]
    assert kind == ("histogram" if "histogram" in promql else "binary"
                    if promql in BINARY_QUERIES + OP_QUERIES
                    and "topk" not in promql else kind), promql


@pytest.mark.parametrize("variant", ["ring", "gather"])
@pytest.mark.parametrize("ns", SHARDS)
def test_sharded_identical_to_one_device(rest, ns, variant):
    for q in FAST + [q for q, _ in FALLBACK_QUERIES]:
        _assert_same(rest["port"]["single", q],
                     rest["port"][f"{variant}{ns}", q], (ns, variant, q))
        note = rest["notes"][f"{variant}{ns}", q]
        if note is not None:
            assert note["shards"] == ns, q


def test_power_within_one_ulp_and_aggregated_power_bounded(rest):
    """`^` differs from XLA:CPU by at most one ulp per element; summed
    over a dc's three hosts the gap stays within 3 ulp of the largest
    term plus the sum's own rounding."""
    q = "sum by (dc) (rate(req_total[1m]) ^ rate(req_total[2m]))"
    a, b = _as_map(rest["jax"][q]), _as_map(rest["port"]["single", q])
    assert set(a) == set(b)
    for key in a:
        (va, pa), (vb, pb) = a[key], b[key]
        assert np.array_equal(pa, pb)
        x, y = va[pa], vb[pb]
        assert np.all(np.abs(x - y) <= 6 * np.spacing(
            np.abs(x).astype(np.float32))), key


@pytest.mark.parametrize("promql,span", FALLBACK_QUERIES)
def test_declined_shapes_match_jax_generic(rest, promql, span):
    """Explicit matching, vector/scalar binaries and histograms the fast
    path cannot serve take the generic engine in both packages."""
    _assert_same(rest["jax"][promql], rest["port"]["single", promql],
                 promql)
    note = rest["notes"]["single", promql]
    assert note is None or note["kind"] not in ("binary", "histogram"), note


def test_on_matching_never_enters_the_fused_binary(rest, monkeypatch):
    # the fixture ran the binary query already: drop its resident result
    # (query/sessions.py) so the query runs its program here
    sessions.global_sessions.clear()
    calls = []
    real = TF._fused_binary
    monkeypatch.setattr(TF, "_fused_binary",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    eng = PromEngine(_engines(rest["catalog"])["single"])
    v, _ = eng.query_range(FALLBACK_QUERIES[0][0], *RANGE)
    assert not calls and v.num_series == 6
    eng.query_range(BINARY_QUERIES[0], *RANGE)
    assert calls == [1]


def test_histogram_layouts_cached_and_refused(rest):
    """A table without a +Inf bucket or without an le tag is refused once
    and the refusal is cached (no le parse per query); the served layout
    is cached per entry."""
    holder = _engines(rest["catalog"])["single"]
    eng = PromEngine(holder)
    ev = types.SimpleNamespace(start_ms=30_000, end_ms=50_000,
                               step_ms=10_000, lookback_ms=300_000)
    from greptimedb_tpu_torch.promql.parser import parse_promql

    for table, want in (("noinf_bucket", None), ("lat_bucket", "served")):
        inner = parse_promql(f"rate({table}[30s])")
        resolved = TF._resolve_fast_selector(eng, inner, ev)
        entry, tab = resolved[0], resolved[1]
        first = TF._hist_grouping(entry, tab)
        assert (first is None) == (want is None)
        cached = entry.group_cache[("__hist__",)]
        assert (cached == "unservable") == (want is None)
        assert TF._hist_grouping(entry, tab) is first or first is None


def test_histogram_scatter_keeps_zero_bits(rest):
    """The histogram's (group, bucket) scatter adds each slot's one series
    onto +0.0: a bucket of -0.0 comes out +0.0, as segment_sum's."""
    import torch

    from greptimedb_tpu_torch.ops import promql as TK

    slot = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    out = torch.tensor([[-0.0], [1.0], [2.0], [2.0]])
    pres = torch.ones((4, 1), dtype=torch.bool)
    seg = slot.to(torch.int64)
    bsum = torch.zeros((5, 1))
    bsum.index_add_(0, seg, torch.where(pres, out, 0.0))
    assert not torch.signbit(bsum[0, 0])
    # and the fold of a histogram whose lowest bucket holds -0.0
    le = torch.tensor([0.1, 0.5, 1.0, float("inf")])
    q, ok = TK.histogram_quantile(le, bsum[:4].T[None], torch.ones(
        (1, 1, 4), dtype=torch.bool), 0.5)
    assert bool(ok.all()) and float(q[0, 0]) == 0.5
