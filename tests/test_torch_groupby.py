"""GROUP BY on the port: the fused device program with kernel G, the host
reduce, and the sharded program, against the JAX package.

Data: tests/test_groupby_device.py's table (20 hosts in 3 dcs, 150 rows
each at 1 s from an epoch-ms base, u with about 7 % nulls, v), plus a
field w with NaNs of both signs, +-inf and +-0.0, a field with NaN and
-0.0 among its summed values (z), and a BIGINT field n, built in both
packages from one numpy seed. The JAX side answers through
Standalone.sql; the port through Instance(device="cpu").sql, so kernel G
runs its plain version.

The contract, on one device against the JAX fused program and on the
host path against the JAX host path: bit-identical for every op. Two
NaN payloads meeting in one float add come out in an order the compiler
chooses on either side (ROADMAP C2), so the summed fields hold one NaN
payload (numpy's NaN); extremes are selections and w mixes NaN signs. The
sharded port at 2, 4 and 8 shards, ring (the kernels' plain versions) and
gather, equals the port on one device bit for bit, and the JAX 4-device
mesh with its ring kernels in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from greptimedb_tpu.errors import ArithmeticOverflowError as JOverflow
from greptimedb_tpu.instance import Standalone
from greptimedb_tpu.parallel import mesh as JM
from greptimedb_tpu.query import reduce as jreduce
from greptimedb_tpu.query.executor import QueryEngine as JQueryEngine
from greptimedb_tpu_torch.catalog.table import Table
from greptimedb_tpu_torch.errors import ArithmeticOverflowError
from greptimedb_tpu_torch.instance import Instance
from greptimedb_tpu_torch.parallel.kernels import grouped_reduce as gr
from greptimedb_tpu_torch.parallel.kernels import ring_fold
from greptimedb_tpu_torch.parallel.mesh import MeshOptions, make_mesh
from greptimedb_tpu_torch.query import reduce as treduce

N_HOSTS, T = 20, 150
BASE = 1_700_000_000_000    # epoch-ms: must survive the device exactly
NEG_NAN = np.array([0xFFF8000000000001], np.uint64).view(np.float64)[0]
POS_NAN = np.array([0x7FF8000000000002], np.uint64).view(np.float64)[0]

# tests/test_groupby_device.py's QUERIES
DEVICE_QUERIES = [
    "SELECT host, count(*), sum(u), avg(u), min(v), max(v) FROM cpu "
    "GROUP BY host ORDER BY host",
    "SELECT dc, stddev(u), var_pop(v), count(u) FROM cpu "
    "GROUP BY dc ORDER BY dc",
    "SELECT host, last_value(u), first_value(v) FROM cpu "
    "GROUP BY host ORDER BY host",
    "SELECT dc, last_value(v) FROM cpu GROUP BY dc ORDER BY dc",
    "SELECT count(*), avg(u), last_value(u) FROM cpu",
]
# the two GROUP BYs of chip_smoke.py's rows phase, on this table's tags
SMOKE_QUERIES = [
    "SELECT host, avg(u) FROM cpu GROUP BY host",
    "SELECT dc, count(*), sum(u), avg(u), min(u), max(v), stddev_samp(u), "
    "first_value(v), last_value(v) FROM cpu GROUP BY dc",
]
EDGE_QUERIES = [
    "SELECT host, min(w), max(w), first_value(w), last_value(w), count(w) "
    "FROM cpu GROUP BY host ORDER BY host",
    "SELECT dc, min(w), max(w), first_value(w), last_value(w) FROM cpu "
    "GROUP BY dc",
    "SELECT min(w), max(w), first_value(w), last_value(w) FROM cpu",
    "SELECT host, sum(z), avg(z), stddev_pop(z), var_samp(z), min(z), "
    "max(z) FROM cpu GROUP BY host",
    "SELECT dc, sum(z), avg(z), stddev_samp(z) FROM cpu GROUP BY dc",
    "SELECT dc, sum(n), avg(n), min(n), max(n), first_value(n) FROM cpu "
    "GROUP BY dc",
    "SELECT dc, host, count(*) AS c, max(u) FROM cpu GROUP BY dc, host "
    "HAVING c > 100 ORDER BY c DESC, host LIMIT 7",
    "SELECT v > 5.0 AS big, count(*), avg(u) FROM cpu GROUP BY big",
]
QUERIES = DEVICE_QUERIES + SMOKE_QUERIES + EDGE_QUERIES
# queries whose ops all fold exactly across shards (the rest stay on one
# device under SHARDABLE_ROW_OPS)
SHARDED = [q for q in QUERIES if not any(
    op in q for op in ("stddev", "var_"))]


def _data(seed=42):
    rng = np.random.default_rng(seed)
    n = N_HOSTS * T
    ts = (np.tile(np.arange(T) * 1000, N_HOSTS) + BASE).astype(np.int64)
    hosts = np.repeat([f"h{i:02d}" for i in range(N_HOSTS)], T).astype(object)
    dcs = np.repeat([f"d{i % 3}" for i in range(N_HOSTS)], T).astype(object)
    u = rng.random(n) * 100
    v = rng.random(n) * 10
    valid = rng.random(n) > 0.07
    # extremes and winners: NaNs of both signs and payloads, +-inf, +-0.0
    w = rng.standard_normal(n)
    w[rng.choice(n, 40, replace=False)] = -0.0
    w[rng.choice(n, 40, replace=False)] = 0.0
    for val in (NEG_NAN, POS_NAN, np.nan, np.inf, -np.inf):
        w[rng.choice(n, 6, replace=False)] = val
    w[T * 5:T * 6] = -0.0          # one host all -0.0
    w[T * 7:T * 8] = np.nan        # one host all NaN
    # sums: numpy's NaN only (one payload), -0.0, a null host
    z = rng.standard_normal(n)
    z[rng.choice(n, 5, replace=False)] = np.nan
    z[rng.choice(n, 30, replace=False)] = -0.0
    z_valid = rng.random(n) > 0.2
    z_valid[T * 3:T * 4] = False   # one host with no valid z
    big = rng.integers(-2**40, 2**40, n)
    fields = {"u": u, "v": v, "w": w, "z": z, "n": big}
    return ({"host": hosts, "dc": dcs}, ts, fields,
            {"u": valid, "z": z_valid})


COLS = "u double, v double, w double, z double, n bigint"
FIELD_TYPES = {"u": np.float64, "v": np.float64, "w": np.float64,
               "z": np.float64, "n": np.int64}


def _jax_instance(path, tags, ts, fields, valid):
    jinst = Standalone(str(path), prefer_device=True, warm_start=False)
    jinst.execute_sql("create table cpu (ts timestamp time index, host "
                      f"string primary key, dc string primary key, {COLS})")
    jinst.catalog.table("public", "cpu").write(tags, ts, fields,
                                               field_valid=valid)
    return jinst


def _port_table(tags, ts, fields, valid):
    tt = Table("cpu", ts_name="ts", tag_names=["host", "dc"],
               fields=FIELD_TYPES)
    tt.write(tags, ts, fields, field_valid=valid)
    return tt


def _instance(tt, **kw):
    inst = Instance(device="cpu", **kw)
    inst.catalog.register(tt)
    return inst


SHARD_OPTS = {
    "ring": MeshOptions(shard_min_rows=1, pallas_kernels="on",
                        pallas_min_rows=1),
    "gather": MeshOptions(shard_min_rows=1, pallas_kernels="off"),
}


@pytest.fixture(scope="module")
def setup(tmp_path_factory, devices):
    """Both packages' tables and the JAX answers: device path, host path
    and the 4-device mesh with the ring kernels (interpret mode)."""
    tags, ts, fields, valid = _data()
    jinst = _jax_instance(tmp_path_factory.mktemp("jax_groupby"), tags, ts,
                          fields, valid)
    tt = _port_table(tags, ts, fields, valid)
    want, paths = {}, {}
    for mode, eng in (
            ("device", JQueryEngine(prefer_device=True)),
            ("host", JQueryEngine(prefer_device=False)),
            ("mesh", JQueryEngine(
                prefer_device=True, mesh=JM.make_mesh(devices[:4]),
                mesh_opts=JM.MeshOptions(
                    shard_min_rows=1, pallas_kernels="on",
                    pallas_min_rows=1)))):
        jinst.query_engine = eng
        for q in QUERIES if mode != "mesh" else SHARDED:
            want[mode, q] = jinst.sql(q)
            paths[mode, q] = eng.last_exec_path
    # the JAX mesh leg ran its sharded program with the ring kernels
    assert any(kernel for _, kernel in jreduce._SHARDED_FUSED._entries)
    yield tt, want, paths
    jinst.close()


def _bits(v):
    v = np.asarray(v)
    return v.view(np.uint64) if v.dtype == np.float64 else v


def _assert_identical(a, b, what=""):
    """Every column bit for bit (NaN payloads included), presence too."""
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


@pytest.mark.parametrize("q", QUERIES)
def test_device_groupby_bit_identical_to_jax(setup, q):
    tt, want, paths = setup
    inst = _instance(tt)
    got = inst.sql(q)
    assert paths["device", q] == "device"
    assert inst.query_engine.last_exec_path == "device"
    assert inst.query_engine.last_reduce["program"] == "single"
    _assert_identical(want["device", q], got, q)


@pytest.mark.parametrize("q", QUERIES)
def test_host_groupby_bit_identical_to_jax(setup, q):
    tt, want, paths = setup
    inst = _instance(tt, prefer_device=False)
    got = inst.sql(q)
    assert paths["host", q] == inst.query_engine.last_exec_path == "host"
    assert inst.query_engine.last_reduce is None
    _assert_identical(want["host", q], got, q)


@pytest.mark.parametrize("ns", [2, 4, 8])
@pytest.mark.parametrize("variant", ["ring", "gather"])
def test_sharded_groupby_equals_one_device_and_jax_mesh(setup, ns, variant):
    tt, want, _ = setup
    one = _instance(tt)
    inst = _instance(tt, mesh=make_mesh(["cpu"] * ns),
                     mesh_opts=SHARD_OPTS[variant])
    before = (ring_fold.ring_pext_fused.launches,
              ring_fold.ring_psum_onehot_fused.launches)
    for q in SHARDED:
        got = inst.sql(q)
        note = inst.query_engine.last_reduce
        assert note["program"] == f"sharded_{variant}", q
        assert note["shards"] == ns and note["decision"] == (
            "shard(large_rowset)")
        _assert_identical(one.sql(q), got, q)
        _assert_identical(want["mesh", q], got, q)
    # replicated: var/stddev do not shard
    inst.sql(DEVICE_QUERIES[1])
    assert inst.query_engine.last_reduce["program"] == "single"
    assert inst.query_engine.last_reduce["decision"] == (
        "replicate(non_decomposable:stddev_samp)")
    # CPU tensors never launch a kernel
    assert (ring_fold.ring_pext_fused.launches,
            ring_fold.ring_psum_onehot_fused.launches) == before
    assert gr.grouped_block_reduce.launches == 0
    assert gr.column_tree_sum.launches == 0


def test_hop_ring_groupby_equals_one_device(setup, monkeypatch):
    """The ring hooks hop by hop (RingFoldCtx(ns, fused=False)) give the
    same bits as the one-launch ring forms."""
    tt, _, _ = setup
    one = _instance(tt)
    real = ring_fold.RingFoldCtx
    monkeypatch.setattr(ring_fold, "RingFoldCtx",
                        lambda ns: real(ns, fused=False))
    inst = _instance(tt, mesh=make_mesh(["cpu"] * 4),
                     mesh_opts=SHARD_OPTS["ring"])
    for q in SHARDED:
        got = inst.sql(q)
        assert inst.query_engine.last_reduce["ring_form"] == "hops"
        _assert_identical(one.sql(q), got, q)


def _seq_sums(v, mask, gid, blocks, gb):
    """numpy float32 sequential reference of the sum form."""
    n = len(v)
    per = -(-n // blocks)
    out = np.zeros((blocks, gb), np.float32)
    for i in range(n):
        if mask[i]:
            b = i // per
            out[b, gid[i]] = np.float32(out[b, gid[i]] + v[i])
    return out


def _seq_ext(v, mask, gid, gb, take_max):
    """The extreme form as one sequential fold with extreme_plain."""
    acc = torch.full((gb,), -torch.inf if take_max else torch.inf)
    tv = torch.from_numpy(v)
    for i in range(len(v)):
        if mask[i]:
            g = int(gid[i])
            acc[g] = ring_fold.extreme_plain(acc[g:g + 1], tv[i:i + 1],
                                             take_max)[0]
    return acc


@pytest.mark.parametrize("n,blocks,gb", [(1000, 8, 4), (1024, 256, 16),
                                         (777, 64, 1), (300, 512, 8),
                                         (2048, 1, 5)])
def test_grouped_block_reduce_plain_matches_sequential(n, blocks, gb):
    rng = np.random.default_rng(n + blocks)
    v = (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n)).astype(
        np.float32)
    v[rng.choice(n, 8, replace=False)] = -0.0
    mask = rng.random(n) > 0.2
    gid = rng.integers(0, gb, n).astype(np.int32)
    gid[~mask] = 0                # masked rows are padding: never group 0
    members = gr.group_members(torch.from_numpy(gid), torch.from_numpy(mask),
                               blocks, gb)
    assert int(members.ptr[-1]) == int(mask.sum())
    got = gr.grouped_block_reduce(torch.from_numpy(v), members, "sum")
    want = _seq_sums(v, mask, gid, blocks, gb)
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    # extremes over NaNs of both signs, +-inf and +-0.0
    w = v.copy()
    w[rng.choice(n, 12, replace=False)] = np.array(
        [0xFFC00001, 0x7FC00002, 0xFF800000, 0x7F800000, 0x80000000,
         0x00000000] * 2, np.uint32).view(np.float32)
    for form in ("max", "min"):
        got = gr.grouped_block_reduce(torch.from_numpy(w), members, form)
        want = _seq_ext(w, mask, gid, gb, form == "max")
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), form


@pytest.mark.parametrize("form", ["max", "min"])
def test_grouped_block_reduce_int32_extremes_match_sequential(form):
    """The int32 extremes of the first/last winner stages: every group's
    fold from the type's least/greatest value, sentinels included."""
    rng = np.random.default_rng(11)
    n, blocks, gb = 3000, 512, 8
    keys = rng.integers(-5, 2**31 - 1, n).astype(np.int32)
    keys[rng.random(n) < 0.3] = -1 if form == "max" else 2**31 - 1
    mask = rng.random(n) > 0.2
    gid = rng.integers(0, gb - 2, n).astype(np.int32)
    gid[~mask] = 0
    members = gr.group_members(torch.from_numpy(gid), torch.from_numpy(mask),
                               blocks, gb)
    got = gr.grouped_block_reduce(torch.from_numpy(keys), members, form)
    info = np.iinfo(np.int32)
    want = np.full(gb, info.min if form == "max" else info.max, np.int32)
    (np.maximum if form == "max" else np.minimum).at(want, gid[mask],
                                                     keys[mask])
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_grouped_block_reduce_forms_against_jax_segment_ops():
    """The sum form against pseg2 and the max/min forms against
    segment_max/segment_min on XLA:CPU, as the JAX program builds them."""
    rng = np.random.default_rng(7)
    n, blocks, gb = 4096, 128, 16
    v = rng.standard_normal(n).astype(np.float32)
    v[rng.choice(n, 16, replace=False)] = np.array(
        [0xFFC00001, 0x7FC00002, 0xFF800000, 0x7F800000, 0x80000000,
         0x00000000, 0x80000000, 0x7FC00003] * 2, np.uint32).view(np.float32)
    mask = rng.random(n) > 0.3
    gid = rng.integers(0, gb - 3, n).astype(np.int32)   # 3 empty groups
    members = gr.group_members(torch.from_numpy(gid), torch.from_numpy(mask),
                               blocks, gb)
    per = n // blocks
    block = jnp.arange(n, dtype=jnp.int32) // per
    jm, jg, jv = jnp.asarray(mask), jnp.asarray(gid), jnp.asarray(v)
    sums = [v.copy()]
    sums[0][np.isnan(sums[0])] = 1.0       # one NaN payload per sum
    for x in sums:
        s2 = jnp.where(jm, jg * blocks + block, gb * blocks)
        p = jax.ops.segment_sum(jnp.where(jm, jnp.asarray(x), 0.0), s2,
                                num_segments=gb * blocks + 1)
        want = np.asarray(p[:-1].reshape(gb, blocks).T)
        got = gr.grouped_block_reduce(torch.from_numpy(x), members, "sum")
        assert np.array_equal(got.numpy().view(np.uint32),
                              want.view(np.uint32))
    sg = jnp.where(jm, jg, gb)
    for form, ext, ident in (("max", jax.ops.segment_max, -jnp.inf),
                             ("min", jax.ops.segment_min, jnp.inf)):
        want = np.asarray(ext(jnp.where(jm, jv, ident), sg,
                              num_segments=gb + 1)[:-1])
        got = gr.grouped_block_reduce(torch.from_numpy(v), members, form)
        assert np.array_equal(got.numpy().view(np.uint32),
                              want.view(np.uint32)), form


@pytest.mark.parametrize("rows,cols", [(1, 3), (8, 16), (32, 5), (64, 16),
                                       (256, 4096), (4096, 16), (65536, 16),
                                       (2048, 1), (31, 3), (31, 16), (32, 3),
                                       (32, 16), (1 << 20, 3), (1 << 20, 16)])
def test_column_tree_sum_plain_matches_xla_sum(rows, cols):
    """Gt's order is XLA:CPU's jnp.sum(x, axis=0) over float32 (the mean
    of the var/stddev deviations), at the shapes _pick_blocks makes (a
    power-of-two row count) and up to 32 rows. Above 32 rows and off a
    multiple of 32, XLA:CPU orders the sum otherwise (33, 1025 and 32769
    rows differ); no GROUP BY gives it such a shape."""
    rng = np.random.default_rng(rows * 7 + cols)
    x = (rng.standard_normal((rows, cols))
         * 10.0 ** rng.integers(-3, 4, (rows, cols))).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=0))(x))
    got = gr.column_tree_sum(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_padding_rows_never_reach_group_zero():
    """bucket_size pads the rows with mask False and gid 0: the padded
    rows are listed after every segment and counted nowhere."""
    n, nb, blocks, gb = 3000, 4096, 4096, 4
    gid = np.zeros(nb, np.int32)
    gid[:n] = np.arange(n) % 3 + 1
    mask = np.zeros(nb, bool)
    mask[:n] = True
    members = gr.group_members(torch.from_numpy(gid), torch.from_numpy(mask),
                               blocks, gb)
    ones = torch.ones(nb)
    cnt = gr.grouped_block_reduce(ones, members, "sum").sum(0)
    assert cnt.tolist() == [0.0, 1000.0, 1000.0, 1000.0]
    assert gr.grouped_block_reduce(ones, members, "max").tolist() == [
        -float("inf"), 1.0, 1.0, 1.0]


def test_group_members_and_wrappers_refuse_bad_inputs():
    members = gr.group_members(torch.zeros(10, dtype=torch.int32),
                               torch.ones(10, dtype=torch.bool), 2, 1)
    with pytest.raises(ValueError):
        gr.grouped_block_reduce(torch.zeros(10), members, "mean")
    for dtype in (torch.float16, torch.int32):   # the sum form: f32, f64
        with pytest.raises(TypeError):
            gr.grouped_block_reduce(torch.zeros(10, dtype=dtype), members,
                                    "sum")
    for dtype in (torch.float16, torch.int64):   # max/min: f32, f64, i32
        with pytest.raises(TypeError):
            gr.grouped_block_reduce(torch.zeros(10, dtype=dtype), members,
                                    "max")
    with pytest.raises(TypeError):
        gr.grouped_block_reduce(torch.zeros(9), members, "sum")
    with pytest.raises(TypeError):
        gr.column_tree_sum(torch.zeros(4))
    with pytest.raises(ValueError):
        gr.group_members(torch.zeros(4, dtype=torch.int32),
                         torch.ones(4, dtype=torch.bool), 0, 1)


def test_pick_blocks_and_buckets_match_jax():
    for nb in (1024, 4096, 1 << 20, 1 << 25):
        for gb in (1, 2, 16, 256, 4096, 65536, 1 << 18):
            assert treduce._pick_blocks(nb, gb) == jreduce._pick_blocks(
                nb, gb)
    for g in (1, 3, 9, 4000, 4096, 5000):
        assert treduce._pad_group_count(g) == jreduce._pad_group_count(g)


@pytest.mark.parametrize("dtype", [np.int64, np.uint64])
def test_bigint_sum_overflow_raises_in_both_packages(dtype):
    hi = np.iinfo(dtype).max // 2 + 1
    vals = np.array([hi, hi, 1, 5], dtype)
    gid = np.array([0, 0, 1, 1])
    valid = np.ones(4, bool)
    with pytest.raises(JOverflow):
        jreduce._host_reduce("sum", vals, valid, gid, 2, None)
    with pytest.raises(ArithmeticOverflowError):
        treduce._host_reduce("sum", vals, valid, gid, 2, None)
    ok = np.array([hi - 10, 1, 5, 7], dtype)
    want = jreduce._host_reduce("sum", ok, valid, gid, 2, None)
    got = treduce._host_reduce("sum", ok, valid, gid, 2, None)
    assert np.array_equal(want[0], got[0])
    assert np.array_equal(want[1], got[1])


def test_groupby_sum_overflow_through_sql(tmp_path):
    """SUM over a BIGINT column past int64 raises on the host path of
    both packages."""
    big = np.full(4, 2**62, np.int64)
    tags = {"host": np.array(["a", "a", "b", "b"], object),
            "dc": np.array(["x"] * 4, object)}
    ts = np.arange(4, dtype=np.int64) * 1000
    fields = {"u": np.zeros(4), "v": np.zeros(4), "w": np.zeros(4),
              "z": np.zeros(4), "n": big}
    q = "SELECT dc, sum(n) FROM cpu GROUP BY dc"
    jinst = _jax_instance(tmp_path, tags, ts, fields, None)
    jinst.query_engine = JQueryEngine(prefer_device=False)
    with pytest.raises(JOverflow):
        jinst.sql(q)
    jinst.close()
    inst = _instance(_port_table(tags, ts, fields, None),
                     prefer_device=False)
    with pytest.raises(ArithmeticOverflowError):
        inst.sql(q)


def test_small_groupby_stays_on_host_when_prefer_device_is_none(setup):
    tt, _, _ = setup
    inst = _instance(tt, prefer_device=None)
    inst.sql(DEVICE_QUERIES[0])
    assert inst.query_engine.last_exec_path == "host"
    inst = _instance(tt)
    inst.sql("SELECT host, median(u) FROM cpu GROUP BY host")
    assert inst.query_engine.last_exec_path == "host"   # host:op
