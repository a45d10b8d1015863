"""The port's x64=False mode against the JAX package with jax_enable_x64 off.

The JAX package's tests run with x64 on (tests/conftest.py), its server
and bench.py with JAX's default, off. The port names the mode
`QueryEngine(x64=...)`, default False (promql/engine.PromEngine states the
rule). Here the JAX side runs with x64 switched off for the one call, as
tests/test_grid_window.py does, on the data of tests/test_torch_promql_rest
.py (6 counters in 2 dcs at 15 s, a histogram of 6 hosts x 4 buckets), and
the port's x64=False engine must equal it bit for bit on:

- rate and increase on the fast path (the fused program: XLA folds
  range_ticks and tps as float32 constants) and in the generic engine;
- a generic `sum by` (an instant query, off the grid) on the scatter
  branch, whose values go to the device as float32 (kernel G's float32
  sum form on the card);
- a generic histogram_quantile, on float32 bounds and buckets.

The same queries with x64=True must differ from x64=False somewhere (the
mode is not a no-op), and equal the JAX package under x64 on.
"""

import types

import jax
import numpy as np
import pytest

from greptimedb_tpu.instance import Standalone
from greptimedb_tpu.promql import fast as JF
from greptimedb_tpu.promql.engine import PromEngine as JPromEngine
from greptimedb_tpu_torch.catalog.manager import CatalogManager
from greptimedb_tpu_torch.catalog.table import Table
from greptimedb_tpu_torch.promql import fast as TF
from greptimedb_tpu_torch.promql.engine import PromEngine
from greptimedb_tpu_torch.query.executor import QueryEngine
from test_torch_promql_rest import _DDL, _runs

T0 = 1_700_000_000_000
RANGE = (T0 + 120_000, T0 + 480_000, 30_000)
AT = T0 + 300_000 + 1000           # off every grid cell: generic engine
HIST_AT = 40_000 + 1000

FAST_QUERIES = [
    "sum by (host) (rate(req_total[1m]))",
    "sum by (dc) (rate(req_total[2m]))",
    "sum by (host) (increase(req_total[1m]))",
    "max by (dc) (increase(req_total[2m]))",
]
GENERIC_QUERIES = [
    ("rate(req_total[1m])", AT),
    ("increase(req_total[2m])", AT),
    ("sum by (dc) (req_total)", AT),
    ("sum by (dc) (rate(req_total[1m]))", AT),
    ("histogram_quantile(0.9, lat_bucket)", HIST_AT),
    ("histogram_quantile(0.5, sum by (le) (lat_bucket))", HIST_AT),
]


def _jax(fn):
    """Run fn with jax_enable_x64 off (the grid caches built under one mode
    are not reused under the other)."""
    saved = bool(jax.config.read("jax_enable_x64"))
    JF.invalidate_cache()
    jax.config.update("jax_enable_x64", False)
    try:
        return fn()
    finally:
        jax.config.update("jax_enable_x64", saved)
        JF.invalidate_cache()


@pytest.fixture(scope="module")
def x64data(tmp_path_factory):
    JF.invalidate_cache()
    TF.invalidate_cache()
    inst = Standalone(str(tmp_path_factory.mktemp("jax_x64")),
                      prefer_device=True, warm_start=False)
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
    jeng = JPromEngine(inst)
    want = _jax(lambda: (
        {q: jeng.query_range(q, *RANGE)[0] for q in FAST_QUERIES},
        {q: jeng.query_instant(q, t)[0] for q, t in GENERIC_QUERIES}))

    def port(x64):
        eng = PromEngine(types.SimpleNamespace(
            catalog=catalog, query_engine=QueryEngine(device="cpu",
                                                      x64=x64)))
        fast, notes = {}, {}
        for q in FAST_QUERIES:
            eng.last_fast = None
            fast[q] = eng.query_range(q, *RANGE)[0]
            notes[q] = eng.last_fast
        gen = {q: eng.query_instant(q, t)[0] for q, t in GENERIC_QUERIES}
        return fast, gen, notes

    yield {"want": want, "off": port(False), "on": port(True)}
    JF.invalidate_cache()
    TF.invalidate_cache()
    inst.close()


def _as_map(v):
    return {tuple(sorted(lab.items())): (np.asarray(v.values[i]),
                                         np.asarray(v.present[i]))
            for i, lab in enumerate(v.labels)}


def _bits_equal(want, got):
    w, g = _as_map(want), _as_map(got)
    assert w.keys() == g.keys() and w
    for k in w:
        (wv, wp), (gv, gp) = w[k], g[k]
        assert np.array_equal(wp, gp), k
        a = wv[wp].astype(np.float64).view(np.uint64)
        b = gv[gp].astype(np.float64).view(np.uint64)
        assert np.array_equal(a, b), (k, wv[wp], gv[gp])


@pytest.mark.parametrize("q", FAST_QUERIES)
def test_fast_rate_matches_jax_without_x64(x64data, q):
    fast, _, notes = x64data["off"]
    assert notes[q] is not None and notes[q]["kind"] == "promql"
    _bits_equal(x64data["want"][0][q], fast[q])


@pytest.mark.parametrize("q", [q for q, _ in GENERIC_QUERIES])
def test_generic_engine_matches_jax_without_x64(x64data, q):
    _, gen, _ = x64data["off"]
    _bits_equal(x64data["want"][1][q], gen[q])


def test_x64_mode_changes_the_answer(x64data):
    """The mode is not a no-op: the float32 uploads and the fused rate's
    float32 constants move some value by at least one ulp."""
    on_fast, on_gen, _ = x64data["on"]
    off_fast, off_gen, _ = x64data["off"]
    moved = 0
    for a, b in [(on_fast[q], off_fast[q]) for q in FAST_QUERIES] + \
            [(on_gen[q], off_gen[q]) for q, _ in GENERIC_QUERIES]:
        ma, mb = _as_map(a), _as_map(b)
        for k in ma:
            moved += int((ma[k][0] != mb[k][0]).sum())
    assert moved > 0


def test_default_mode_is_off():
    assert QueryEngine(device="cpu").x64 is False
