"""Device-resident flow state: the port against the JAX package.

The cases of tests/test_flow_device.py (device state against the host
accumulators, incremental updates, 100k groups in one finalize, expiry,
keyless flows, first-value ties, all-null sums, NULL keys against "None",
demotion that keeps the state) run through both packages with
test_torch_flow.FlowPair: the sinks cell for cell and the device states
slot for slot, bit for bit, with x64 on and (float cases) off. A seeded
random workload covers every device accumulator at once over many deltas:
nulls, WHERE, ties, several key shapes. Kernel G's plain versions hold
against XLA's segment reductions on the flow's own shapes, its float64
max/min form (new for the flow state's x64 min/max) on edge bits: NaN
payloads of both signs, +-0.0 and +-inf. Every tolerance is exact
(tests/test_torch_flow.py says why).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from greptimedb_tpu_torch.parallel.kernels import grouped_reduce as gr
from test_torch_flow import X64_MODES, make_pair  # noqa: F401 - a fixture

T0 = 1_700_000_000_000


FLOW_SQL = (
    "CREATE FLOW f1 SINK TO out1 AS "
    "SELECT host, count(v) AS c, sum(v) AS s, avg(v) AS a, min(v) AS lo, "
    "max(v) AS hi, last_value(v ORDER BY ts) AS lv, stddev_pop(v) AS sd "
    "FROM src GROUP BY host"
)


def _setup(pair, flow_sql, table="src"):
    pair.sql(f"CREATE TABLE {table} (host STRING, v DOUBLE, ts TIMESTAMP "
             "TIME INDEX, PRIMARY KEY (host))")
    if flow_sql:
        pair.sql(flow_sql)


def _ingest(pair, hosts, vals, ts, table="src"):
    pair.sql(
        f"INSERT INTO {table} (host, v, ts) VALUES "
        + ", ".join(f"('{h}', {v}, {t})" for h, v, t in zip(hosts, vals, ts))
    )


@X64_MODES
def test_device_state_used_and_matches_host(make_pair, x64):
    pair = make_pair(x64)
    _setup(pair, FLOW_SQL)
    assert pair.port.flows.maybe_flow("f1").device_state is not None
    _ingest(pair, ["a", "b", "a"], [1.0, 5.0, 3.0], [T0, T0, T0 + 1000])
    _ingest(pair, ["a", "b", "c"], [7.0, 2.0, 9.0],
            [T0 + 2000, T0 + 3000, T0])
    pair.same_state("f1")
    pair.flush()
    dev = pair.same_sink("out1", "host")
    # the host accumulators on both packages: same flow, device state off
    pair.sql("DROP FLOW f1")
    pair.sql("DROP TABLE out1")
    pair.sql(FLOW_SQL.replace("f1", "f2").replace("out1", "out2"))

    def host_path(inst):
        inst.flows.maybe_flow("f2").device_state = None

    pair.both(host_path)
    _ingest(pair, ["a", "b", "a"], [1.0, 5.0, 3.0], [T0, T0, T0 + 1000])
    _ingest(pair, ["a", "b", "c"], [7.0, 2.0, 9.0],
            [T0 + 2000, T0 + 3000, T0])
    pair.flush()
    host = pair.same_sink("out2", "host")
    assert [r[0] for r in dev] == [r[0] for r in host] == ["a", "b", "c"]
    for d, h in zip(dev, host):
        # [count, sum, avg, min, max, last, stddev]: the float32 state
        # rounds the values' sums, the host adds float64
        np.testing.assert_allclose([float(x) for x in d[1:8]],
                                   [float(x) for x in h[1:8]], rtol=1e-6)
    pair.no_failures()


@X64_MODES
def test_incremental_updates_accumulate(make_pair, x64):
    pair = make_pair(x64)
    _setup(pair, FLOW_SQL)
    _ingest(pair, ["a"], [2.0], [T0])
    pair.flush()
    _ingest(pair, ["a"], [4.0], [T0 + 1000])
    pair.flush()
    rows = pair.same_sink("out1", "host")
    assert [float(x) for x in rows[0][1:7]] == [2.0, 6.0, 3.0, 2.0, 4.0, 4.0]
    pair.same_state("f1")


@X64_MODES
def test_100k_groups_one_program(make_pair, x64):
    """A tick over >= 100k groups finalizes every group in one pass and
    writes every group back."""
    pair = make_pair(x64)
    _setup(pair, "CREATE FLOW bigf SINK TO bigout AS SELECT host, "
                 "sum(v) AS s, count(v) AS c FROM big GROUP BY host",
           table="big")
    n = 120_000
    pair.write("big", {"host": np.asarray([f"h{i:06d}" for i in range(n)],
                                          object),
                       "ts": np.full(n, T0, np.int64),
                       "v": np.arange(n, dtype=np.float64)})
    ds = pair.same_state("bigf")
    assert ds.num_groups == n and ds.capacity == 131072
    pair.flush()
    got, want = pair.sql("SELECT count(*), sum(s), sum(c) FROM bigout")
    assert got.rows() == want.rows()
    assert got.rows()[0][0] == n
    assert float(got.rows()[0][2]) == float(n)
    # a second delta touches two groups only: the dirty slice stays small
    pair.write("big", {"host": np.asarray(["h000000", "h000001"], object),
                       "ts": np.full(2, T0 + 1000, np.int64),
                       "v": np.asarray([100.0, 200.0])})
    assert int(pair.same_state("bigf").dirty.sum()) == 2
    pair.flush()
    got, want = pair.sql("SELECT host, s, c FROM bigout WHERE host IN "
                         "('h000000', 'h000001') ORDER BY host")
    assert got.rows() == want.rows() == [["h000000", 100.0, 2.0],
                                         ["h000001", 201.0, 2.0]]


def test_expiry_compacts_device_state(make_pair):
    pair = make_pair()
    _setup(pair, "CREATE FLOW ef SINK TO eout EXPIRE AFTER '1h' AS "
                 "SELECT date_bin('1 minute', ts) AS w, sum(v) AS s "
                 "FROM esrc GROUP BY date_bin('1 minute', ts)",
           table="esrc")
    now = int(time.time() * 1000)
    old = now - 7_200_000   # 2 h ago: beyond EXPIRE AFTER '1h'
    _ingest(pair, ["x", "y"], [1.0, 2.0], [old, now], table="esrc")
    pair.same_state("ef")
    pair.flush()
    ds = pair.same_state("ef")
    assert ds.num_groups == 1   # the expired window dropped


def test_expiry_shrinks_large_state(make_pair):
    """Compacting from > 1024 groups down to a handful keeps the state
    usable."""
    pair = make_pair()
    _setup(pair, "CREATE FLOW ef SINK TO eout EXPIRE AFTER '1h' AS "
                 "SELECT date_bin('1 minute', ts) AS w, host, sum(v) AS s "
                 "FROM esrc GROUP BY date_bin('1 minute', ts), host",
           table="esrc")
    now = int(time.time() * 1000)
    n = 3000
    pair.write("esrc", {"host": np.asarray([f"h{i}" for i in range(n)],
                                           object),
                        "ts": np.full(n, now, np.int64), "v": np.ones(n)})
    assert pair.same_state("ef").num_groups == n
    pair.flush()

    def expire_after(seconds):
        def go(inst):
            inst.flows.maybe_flow("ef").expire_after_s = seconds
        pair.both(go)

    expire_after(-60)       # every group is now past the horizon
    pair.flush()
    assert pair.same_state("ef").num_groups == 0
    expire_after(3600)
    _ingest(pair, ["a"], [5.0], [now], table="esrc")
    pair.same_state("ef")
    pair.flush()
    got, want = pair.sql("SELECT s FROM eout WHERE host = 'a'")
    assert got.rows() == want.rows() == [[5.0]]


@X64_MODES
def test_keyless_flow_uses_device_and_matches(make_pair, x64):
    pair = make_pair(x64)
    _setup(pair, "CREATE FLOW kf SINK TO kout AS "
                 "SELECT count(v) AS c, sum(v) AS s FROM ksrc", table="ksrc")
    assert pair.port.flows.maybe_flow("kf").device_state is not None
    _ingest(pair, ["a", "b"], [2.0, 3.0], [T0, T0 + 1], table="ksrc")
    pair.flush()
    got, want = pair.sql("SELECT c, s FROM kout")
    assert got.rows() == want.rows() == [[2.0, 5.0]]
    pair.same_state("kf")


@X64_MODES
def test_first_value_tie_prefers_first_arrival(make_pair, x64):
    pair = make_pair(x64)
    _setup(pair, "CREATE FLOW ff SINK TO fout AS "
                 "SELECT host, first_value(v ORDER BY ts) AS fv, "
                 "last_value(v ORDER BY ts) AS lv FROM fsrc GROUP BY host",
           table="fsrc")
    # same host, same timestamp: the first arrival for first_value, the
    # last for last_value
    _ingest(pair, ["a", "a", "a"], [1.0, 2.0, 3.0], [T0, T0, T0],
            table="fsrc")
    pair.flush()
    got, want = pair.sql("SELECT fv, lv FROM fout WHERE host = 'a'")
    assert got.rows() == want.rows() == [[1.0, 3.0]]
    # a later batch at the SAME ts: first keeps, last replaces
    _ingest(pair, ["a"], [9.0], [T0], table="fsrc")
    pair.flush()
    got, want = pair.sql("SELECT fv, lv FROM fout WHERE host = 'a'")
    assert got.rows() == want.rows() == [[1.0, 9.0]]
    pair.same_state("ff")


def test_all_null_sum_is_null(make_pair):
    pair = make_pair()
    _setup(pair, "CREATE FLOW nf SINK TO nout AS "
                 "SELECT host, sum(v) AS s, count(v) AS c FROM nsrc "
                 "GROUP BY host", table="nsrc")
    pair.sql(f"INSERT INTO nsrc (host, v, ts) VALUES ('a', NULL, {T0})")
    pair.flush()
    got, want = pair.sql("SELECT s, c FROM nout WHERE host = 'a'")
    col = got.cols[0]
    assert col.validity is not None and not bool(col.validity[-1])
    assert got.rows() == want.rows()
    pair.same_state("nf")


def test_null_key_distinct_from_none_string(make_pair):
    """NULL and the literal string 'None' in a key column are distinct
    groups on the device path, as on the host path."""
    pair = make_pair()
    _setup(pair, "CREATE FLOW mf SINK TO mout AS "
                 "SELECT host, sum(v) AS s FROM msrc GROUP BY host",
           table="msrc")
    pair.sql(f"INSERT INTO msrc (host, v, ts) VALUES "
             f"('None', 1.0, {T0}), (NULL, 10.0, {T0})")
    assert pair.same_state("mf").num_groups == 2


@X64_MODES
def test_demotion_preserves_state(make_pair, x64):
    """A batch the device encoding cannot take (a negative ts) demotes the
    flow to the host path without losing accumulated state."""
    pair = make_pair(x64)
    _setup(pair, FLOW_SQL)
    _ingest(pair, ["a"], [2.0], [T0])
    _ingest(pair, ["a"], [4.0], [-5])   # pre-epoch ts: demote
    assert pair.same_state("f1") is None
    pair.flush()
    rows = pair.same_sink("out1", "host")
    assert [float(x) for x in rows[0][1:3]] == [2.0, 6.0]
    pair.no_failures()


# ----------------------------------------------------------------------
# every accumulator at once, seeded
# ----------------------------------------------------------------------

RANDOM_FLOWS = (
    "CREATE FLOW r1 SINK TO r1_out AS SELECT date_bin('1 minute', ts) AS w, "
    "host, count(v) AS c, count(*) AS n, sum(v) AS s, avg(v) AS a, "
    "min(v) AS lo, max(v) AS hi, var_pop(v) AS vp, var_samp(v) AS vs, "
    "stddev_pop(v) AS sp, stddev_samp(v) AS ss, "
    "first_value(v ORDER BY ts) AS fv, last_value(v ORDER BY ts) AS lv "
    "FROM rsrc GROUP BY w, host",
    "CREATE FLOW r2 SINK TO r2_out AS SELECT dc, max(v) AS hi, "
    "min(u) AS lo, sum(u) AS s, stddev_samp(u) AS ss FROM rsrc "
    "WHERE v > -50 GROUP BY dc",
    "CREATE FLOW r3 SINK TO r3_out AS SELECT avg(u) AS a, "
    "last_value(u ORDER BY ts) AS lv, count(v) AS c FROM rsrc",
)


def _random_batch(rng, k):
    # three batch sizes: each new size compiles the JAX program anew
    n = int(rng.choice([97, 256, 333]))
    hosts = np.asarray([f"h{i}" for i in rng.integers(0, 40, n)], object)
    dcs = np.asarray([f"dc{i}" for i in rng.integers(0, 3, n)], object)
    # few distinct timestamps: ties within and across batches
    ts = T0 + rng.integers(0, 6, n).astype(np.int64) * 20_000 + k * 15_000
    v = rng.normal(0, 100, n) * 10.0 ** rng.integers(-2, 3, n)
    v[rng.random(n) < 0.05] = 0.0
    v[rng.random(n) < 0.02] = -0.0
    u = 1e4 + rng.normal(0, 1, n)     # large mean, small spread
    vv = rng.random(n) > 0.1
    uv = rng.random(n) > 0.05
    return ({"host": hosts, "dc": dcs, "ts": ts, "v": v, "u": u},
            {"host": np.ones(n, bool), "dc": np.ones(n, bool),
             "ts": np.ones(n, bool), "v": vv, "u": uv})


@X64_MODES
def test_random_deltas_every_accumulator(make_pair, x64):
    pair = make_pair(x64)
    pair.sql("CREATE TABLE rsrc (host STRING, dc STRING, v DOUBLE, "
             "u DOUBLE, ts TIMESTAMP TIME INDEX, PRIMARY KEY (host, dc))")
    for sql in RANDOM_FLOWS:
        pair.sql(sql)
    rng = np.random.default_rng(1234)
    for k in range(24):
        data, valid = _random_batch(rng, k)
        pair.write("rsrc", data, valid)
        if k % 6 == 5:
            for name in ("r1", "r2", "r3"):
                pair.same_state(name)
            pair.flush()
    pair.flush()
    for name, order in (("r1", "w, host"), ("r2", "dc"), ("r3", "a")):
        assert pair.same_state(name) is not None
        pair.same_sink(f"{name}_out", order)
    pair.no_failures()


# ----------------------------------------------------------------------
# kernel G's plain versions on the flow's shapes
# ----------------------------------------------------------------------

_EDGE64 = np.array([0xFFF8000000000001, 0x7FF8000000000002,
                    0xFFF0000000000000, 0x7FF0000000000000,
                    0x8000000000000000, 0x0000000000000000,
                    0x7FF8000000000000, 0x8000000000000000], np.uint64)


def _edge_values(rng, n, dtype):
    v = (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n))
    k = rng.choice(n, min(n, 64), replace=False)
    if dtype == np.float64:
        v[k] = np.resize(_EDGE64, len(k)).view(np.float64)
        return v
    v = v.astype(np.float32)
    v[k] = np.resize(np.array(
        [0xFFC00001, 0x7FC00002, 0xFF800000, 0x7F800000, 0x80000000,
         0x00000000, 0x7FC00000, 0x80000000], np.uint32), len(k)).view(
        np.float32)
    return v


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("form", ["max", "min"])
@pytest.mark.parametrize("n,g", [(3000, 1024), (777, 4096), (50, 1024)])
def test_g_extreme_plain_matches_xla_segment_extreme(dtype, form, n, g):
    """G's max/min at the flow's shape (one block over the capacity) on
    edge bits equals jax.ops.segment_max/min bit for bit: XLA's maximum
    and minimum on float64 follow the float32 rule."""
    rng = np.random.default_rng(n + g)
    v = _edge_values(rng, n, dtype)
    gid = rng.integers(0, min(g, 200), n).astype(np.int32)
    fn = jax.ops.segment_max if form == "max" else jax.ops.segment_min
    want = np.asarray(jax.jit(lambda x, i: fn(x, i, num_segments=g))(
        jnp.asarray(v), jnp.asarray(gid)))
    members = gr.group_members(torch.from_numpy(gid),
                               torch.ones(n, dtype=torch.bool), 1, g)
    got = gr.grouped_block_reduce(torch.from_numpy(v), members, form).numpy()
    assert got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_g_sum_plain_matches_xla_segment_sum_at_flow_shape(dtype):
    """The flow's float sums: one block over the capacity, rows in order
    from +0.0, every segment bit for bit (edge values other than NaN:
    two NaN payloads meeting in one add come out in a compiler-chosen
    order)."""
    rng = np.random.default_rng(5)
    n, g = 5000, 2048
    v = _edge_values(rng, n, dtype)
    v[np.isnan(v)] = -0.0
    gid = rng.integers(0, 900, n).astype(np.int32)
    want = np.asarray(jax.jit(lambda x, i: jax.ops.segment_sum(
        x, i, num_segments=g))(jnp.asarray(v), jnp.asarray(gid)))
    members = gr.group_members(torch.from_numpy(gid),
                               torch.ones(n, dtype=torch.bool), 1, g)
    got = gr.grouped_block_reduce(torch.from_numpy(v), members,
                                  "sum")[0].numpy()
    assert got.tobytes() == want.tobytes()


def test_g_float64_extreme_form_checks_its_input():
    members = gr.group_members(torch.zeros(4, dtype=torch.int32),
                               torch.ones(4, dtype=torch.bool), 1, 2)
    out = gr.grouped_block_reduce(torch.tensor([1.0, -0.0, 0.0, 2.0],
                                               dtype=torch.float64),
                                  members, "max")
    assert out.dtype == torch.float64 and out.tolist() == [2.0, -np.inf]
    with pytest.raises(TypeError):
        gr.grouped_block_reduce(torch.zeros(4, dtype=torch.float16),
                                members, "max")
