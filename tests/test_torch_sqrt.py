"""ROADMAP C6: the port's square roots are correctly rounded on the CPU, as
XLA:CPU's are.

torch's vectorized CPU sqrt can be one ulp off in float32 and float64, so
every root of the port goes through ops/window.sqrt_rn: numpy's root on a
CPU tensor, CUDA's (correctly rounded) on a card. The tests feed values
whose torch and numpy roots differ on this CPU through the three sites
that take a root, in both packages, and hold the port to the JAX package
bit for bit:

- PromQL `stddev` over the unblocked aggregation's scatter branch, float32
  and float64 (ROADMAP C6's reproduction: 4,000 series in 2,000 groups x 8
  steps, plus groups whose variance is exactly such a value);
- the RANGE program's stddev_pop and stddev_samp (float32), over windows
  whose variance is exact in any reduction order and with or without
  XLA's fused multiply-add (mean 0, small quarter-integers), so the root
  is the only operation left to differ;
- the flow finalize's stddev (tests/test_torch_flow_device.py holds it;
  here its root is the shared one).
"""

import numpy as np
import pytest
import torch

from greptimedb_tpu.instance import Standalone
from greptimedb_tpu.ops import promql as JK
from greptimedb_tpu.query.executor import QueryEngine as JQueryEngine
from greptimedb_tpu.query.planner import plan_select
from greptimedb_tpu.sql.parser import parse_sql
from greptimedb_tpu_torch.catalog.table import Table
from greptimedb_tpu_torch.flow import device_state
from greptimedb_tpu_torch.ops import promql as TK
from greptimedb_tpu_torch.ops import window as TW
from greptimedb_tpu_torch.query.executor import QueryEngine
from greptimedb_tpu_torch.query.planner import plan_from_fields


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint64 if a.dtype == np.float64 else np.uint32)


def _torch_misses(x: np.ndarray) -> np.ndarray:
    """Where torch's CPU root differs from the correctly rounded one."""
    return _bits(torch.sqrt(torch.from_numpy(x)).numpy()) != _bits(
        np.sqrt(x))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sqrt_rn_is_the_correctly_rounded_root(dtype):
    rng = np.random.default_rng(6)
    x = (rng.random(1 << 20) * 10.0 ** rng.integers(-30, 30, 1 << 20)
         ).astype(dtype)
    x[:4] = [0.0, -0.0, np.inf, 2.0]
    got = TW.sqrt_rn(torch.from_numpy(x))
    assert got.dtype == torch.from_numpy(x).dtype
    assert np.array_equal(_bits(got.numpy()), _bits(np.sqrt(x)))
    # strided and 0-d inputs, and a negative value's NaN
    assert np.array_equal(_bits(TW.sqrt_rn(torch.from_numpy(x)[::3])),
                          _bits(np.sqrt(x[::3])))
    assert TW.sqrt_rn(torch.tensor(2.0, dtype=got.dtype)).item() == float(
        np.sqrt(dtype(2.0)))
    assert torch.isnan(TW.sqrt_rn(torch.tensor([-1.0], dtype=got.dtype)))


def test_flow_finalize_takes_the_shared_root():
    assert not hasattr(device_state, "_sqrt")
    assert device_state.W.sqrt_rn is TW.sqrt_rn


def _exact_variance_groups(dtype, per_group):
    """Series values of groups whose population variance is computed
    exactly and whose root torch gets wrong here: each group holds
    {a, -a, b, -b} (mean 0, variance (a^2 + b^2) / 2) for quarter-integer
    a, b."""
    q = np.arange(1, 120) / 4.0
    a, b = np.meshgrid(q, q)
    var = ((a * a + b * b) / 2).astype(dtype).ravel()
    pick = np.flatnonzero(_torch_misses(var))[:per_group]
    rows = []
    for i in pick:
        ai, bi = a.ravel()[i], b.ravel()[i]
        rows += [ai, -ai, bi, -bi]
    return np.asarray(rows, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_promql_stddev_scatter_branch_matches_jax(dtype):
    rng = np.random.default_rng(15)
    s, g, steps = 4000, 2000, 8
    vals = (rng.standard_normal((s, steps))
            * 10.0 ** rng.integers(-2, 3, (s, steps))).astype(dtype)
    pres = rng.random((s, steps)) < 0.9
    gid = rng.integers(0, g, s).astype(np.int32)
    extra = _exact_variance_groups(dtype, 16)
    k = len(extra) // 4
    vals = np.concatenate([vals, np.repeat(extra[:, None], steps, 1)])
    pres = np.concatenate([pres, np.ones((len(extra), steps), bool)])
    gid = np.concatenate([gid, g + np.repeat(np.arange(k), 4).astype(
        np.int32)])
    g += k
    assert not TK.uses_matmul("stddev", g, len(gid))
    for op in ("stddev", "stdvar"):
        want_v, want_p = (np.asarray(x) for x in JK.aggregate_across_series(
            vals, pres, gid, g, op))
        got_v, got_p = TK.aggregate_across_series(
            torch.from_numpy(vals), torch.from_numpy(pres),
            torch.from_numpy(gid), g, op)
        assert np.array_equal(want_p, got_p.numpy())
        same = (_bits(want_v) == _bits(got_v.numpy())) | (
            np.isnan(want_v) & np.isnan(got_v.numpy()))
        assert same.all(), (op, int((~same).sum()))


@pytest.mark.parametrize("op", ["stddev_pop", "stddev_samp"])
def test_range_program_stddev_matches_jax(tmp_path, op):
    hosts, windows, step = 8, 6, 10_000
    extra = _exact_variance_groups(np.float32, hosts * windows)
    rng = np.random.default_rng(16)
    need = hosts * windows * 4
    if len(extra) < need:
        # fill with more exact windows of random quarter-integers
        fill = rng.integers(1, 400, (need - len(extra)) // 4 * 2) / 4.0
        extra = np.concatenate([extra, np.stack(
            [fill[0::2], -fill[0::2], fill[1::2], -fill[1::2]], 1).ravel()])
    v = extra[:need].astype(np.float64)
    hi = np.repeat(np.arange(hosts), windows * 4)
    ts = np.tile(np.arange(windows * 4, dtype=np.int64) * step, hosts)
    names = np.array([f"host_{i}" for i in range(hosts)], object)
    sql = (f"SELECT ts, hostname, {op}(v) RANGE '40s' FROM cpu "
           "ALIGN '40s' BY (hostname)")
    inst = Standalone(str(tmp_path / "jax"))
    try:
        inst.execute_sql("create table cpu (ts timestamp time index, "
                         "hostname string primary key, v double)")
        jt = inst.catalog.table("public", "cpu")
        jt.write({"hostname": names[hi]}, ts, {"v": v})
        plan = plan_select(parse_sql(sql)[0], ts_name="ts",
                           tag_names=["hostname"], all_columns=None)
        jeng = JQueryEngine(prefer_device=True)
        want = jeng.execute(plan, jt)
        assert jeng.last_exec_path == "device"
    finally:
        inst.close()
    tt = Table("cpu", ts_name="ts", tag_names=["hostname"], fields=["v"])
    tt.write({"hostname": names[hi]}, ts, {"v": v})
    eng = QueryEngine(device="cpu")
    got = eng.execute(plan_from_fields(plan), tt)
    assert eng.last_exec_path == "device"
    w, t = want.cols[2], got.cols[2]
    assert np.array_equal(w.valid_mask, t.valid_mask)
    wv = np.asarray(w.values)[w.valid_mask]
    tv = np.asarray(t.values)[t.valid_mask]
    assert wv.dtype == tv.dtype and len(wv) == hosts * windows
    assert np.array_equal(_bits(wv), _bits(tv))
