"""The secondary tag index and its device label plane: the port against the
JAX package on the CPU.

The cases of tests/test_tag_index.py (postings against the registry's
full-plane compare, the version-validated result cache, the delta tail,
ALTER ADD TAG, the disabled path, matcher keys, registry versions, the
device plane's masks and census, SST and manifest sid pruning, the pool's
stats) run through both packages from the same numpy seed; every sid set
is compared exactly, as ascending int32. The device plane runs its plain
torch gather on CPU tensors, on one device and on four shards. The JAX
package's process counters and memory-pool registration wait for the
telemetry (ROADMAP A9): the port's tallies (`lookup_counts`,
`pruned_counts`, `pool_stats`) stand in for them.

The cases of tests/test_index_invalidation.py run through a Standalone of
each package (the port has one region a table; the JAX test's frontend and
datanodes wait for A10): each matcher query with the index on, then again
with it off after dropping every cache, equal to each other and to the JAX
package's. The JAX test's region migration becomes a reopen of the data
root, where the region rebuilds its registry and its index.
"""

import contextlib
import re

import numpy as np
import pytest
import torch

from greptimedb_tpu import index as jax_index
from greptimedb_tpu.index import device_plane as jax_plane
from greptimedb_tpu.index.tag_index import TagIndex as JaxTagIndex
from greptimedb_tpu.instance import Standalone as JaxStandalone
from greptimedb_tpu.storage.series import SeriesRegistry as JaxRegistry
from greptimedb_tpu_torch import index as _index
from greptimedb_tpu_torch.index import device_plane, tag_index
from greptimedb_tpu_torch.index.tag_index import TagIndex, _expand_csr
from greptimedb_tpu_torch.instance import Standalone
from greptimedb_tpu_torch.query import stats
from greptimedb_tpu_torch.storage.series import SeriesRegistry

CPU = torch.device("cpu")


def _columns(n, hosts, regions, seed):
    rng = np.random.default_rng(seed)
    return [
        np.asarray([f"h{v}" for v in rng.integers(0, hosts, n)], object),
        np.asarray([f"r{v}" for v in rng.integers(0, regions, n)], object),
    ]


def _registries(n=2000, hosts=16, regions=5, seed=0):
    """A port registry and a JAX one over the same interned rows."""
    cols = _columns(n, hosts, regions, seed)
    reg = SeriesRegistry(["host", "region"])
    jreg = JaxRegistry(["host", "region"])
    reg.intern_rows([c.copy() for c in cols])
    jreg.intern_rows([c.copy() for c in cols])
    return reg, jreg


def _intern_both(regs, *cols):
    for r in regs:
        r.intern_rows([np.asarray(c, object) for c in cols])


def _same(got, want, msg=""):
    assert got.dtype == np.int32 == want.dtype, msg
    np.testing.assert_array_equal(got, want, err_msg=msg)


CASES = [
    [("host", "eq", "h3")],
    [("host", "in", ["h1", "h5", "h7"])],
    [("host", "ne", "h0")],
    [("host", "re", re.compile(r"h1[12]?"))],
    [("host", "nre", re.compile(r"h[0-4]"))],
    [("host", "eq", "h2"), ("region", "eq", "r1")],
    [("host", "ne", ""), ("region", "in", ["r0", "r4"])],
    [("missing", "eq", "x")],          # absent tag: constant verdict
    [("missing", "eq", "")],           # matches everything (empty tag)
    [("host", "eq", "nosuchvalue")],
    [],                                # no matchers
]


@pytest.mark.parametrize("m", CASES, ids=[repr(c) for c in CASES])
def test_match_sids_bit_identical_to_registry(m):
    reg, jreg = _registries()
    want = jreg.match_sids(m) if m else np.arange(
        jreg.num_series, dtype=np.int32)
    _same(reg.match_sids(m) if m else _index.match_sids(reg, m), want)
    _same(_index.match_sids(reg, m), want, repr(m))
    _same(jax_index.match_sids(jreg, m), want, repr(m))
    if m:
        _same(TagIndex(reg).match_sids(m), JaxTagIndex(jreg).match_sids(m))


def test_match_sids_fuzz_against_oracle():
    rng = np.random.default_rng(7)
    reg, jreg = _registries(n=5000, hosts=40, regions=9, seed=1)
    ix, jix = TagIndex(reg), JaxTagIndex(jreg)
    ops = ["eq", "ne", "in", "nin", "re", "nre"]
    for _ in range(150):
        m = []
        for _ in range(rng.integers(1, 4)):
            tag = ["host", "region", "ghost"][rng.integers(0, 3)]
            op = ops[rng.integers(0, len(ops))]
            if op in ("in", "nin"):
                val = [f"h{rng.integers(0, 45)}" for _ in range(3)]
            elif op in ("re", "nre"):
                val = re.compile(f"[hr]{rng.integers(0, 45)}.*")
            else:
                val = f"h{rng.integers(0, 45)}"
            m.append((tag, op, val))
        got = ix.match_sids(m)
        _same(got, jix.match_sids(m), repr(m))
        _same(got, reg.match_sids(m), repr(m))


def test_result_cache_hits_and_version_invalidation():
    reg, jreg = _registries(n=500, hosts=4)
    ix, jix = TagIndex(reg), JaxTagIndex(jreg)
    m = [("host", "eq", "h1")]
    a = ix.match_sids(m)
    _same(a, jix.match_sids(m))
    h0 = ix.stats()["hits"]
    with stats.collect() as st:
        b = ix.match_sids(m)
    assert ix.stats()["hits"] == h0 + 1
    assert st.counters["index_lookups"] == 1
    _same(b, a)
    v0 = reg.version
    # a new series carrying h1 must appear despite the cached result
    _intern_both((reg, jreg), ["h1"], ["rz"])
    assert reg.version > v0 and reg.version == jreg.version
    c = ix.match_sids(m)
    assert len(c) == len(a) + 1
    _same(c, reg.match_sids(m))
    _same(c, jix.match_sids(m))


@contextlib.contextmanager
def _configured(**knobs):
    old = {k: tag_index._CFG[k] for k in knobs}
    jold = {k: jax_index.tag_index._CFG[k] for k in knobs}
    _index.configure(knobs)
    jax_index.configure(knobs)
    try:
        yield
    finally:
        _index.configure(old)
        jax_index.configure(jold)


def test_delta_tail_avoids_rebuild_then_rebuilds():
    with _configured(rebuild_threshold=64):
        reg, jreg = _registries(n=300, hosts=6)
        ix, jix = TagIndex(reg), JaxTagIndex(jreg)
        ix.match_sids([("host", "eq", "h1")])
        jix.match_sids([("host", "eq", "h1")])
        b0 = ix.stats()["builds"]
        assert b0 == jix.stats()["builds"]
        # small delta: evaluated from the tail, no re-sort
        _intern_both((reg, jreg), ["h1"] * 10, ["rd"] * 10)
        m = [("host", "eq", "h1")]
        _same(ix.match_sids(m), reg.match_sids(m))
        _same(ix.match_sids(m), jix.match_sids(m))
        assert ix.stats()["builds"] == b0 == jix.stats()["builds"]
        # past the threshold: postings rebuild
        _intern_both((reg, jreg), [f"x{i}" for i in range(200)],
                     ["rd"] * 200)
        m = [("host", "ne", "h1")]
        _same(ix.match_sids(m), reg.match_sids(m))
        _same(ix.match_sids(m), jix.match_sids(m))
        assert ix.stats()["builds"] == b0 + 1 == jix.stats()["builds"]


def test_add_tag_widens_and_rebuilds():
    reg, jreg = _registries(n=200, hosts=3)
    ix, jix = TagIndex(reg), JaxTagIndex(jreg)
    ix.match_sids([("host", "eq", "h0")])
    jix.match_sids([("host", "eq", "h0")])
    for r in (reg, jreg):
        r.add_tag("dc")
    _intern_both((reg, jreg), ["h0"], ["r0"], ["east"])
    for m in ([("dc", "eq", "east")], [("dc", "eq", "")],
              [("host", "eq", "h0"), ("dc", "ne", "east")]):
        got = ix.match_sids(m)
        _same(got, reg.match_sids(m), repr(m))
        _same(got, jix.match_sids(m), repr(m))


def test_disabled_index_falls_back_to_registry():
    reg, jreg = _registries(n=100)
    m = [("host", "eq", "h1")]
    with _configured(enable=False):
        v0 = tag_index.lookup_counts()["host"]
        got = _index.match_sids(reg, m)
        _same(got, reg.match_sids(m))
        _same(got, jax_index.match_sids(jreg, m))
        assert tag_index.lookup_counts()["host"] == v0 + 1
        assert not tag_index.device_plane_enabled()


def test_matcher_key_normalizes():
    r = re.compile("h.*")
    for key in (_index.matcher_key, jax_index.matcher_key):
        assert key([("host", "re", r)]) == key(
            [("host", "re", re.compile("h.*"))])
        assert key([("host", "in", ["b", "a"])]) == key(
            [("host", "in", ("a", "b"))])
    m = [("host", "re", r), ("dc", "nin", {"x", "w"}), ("os", "eq", "l")]
    assert _index.matcher_key(m) == jax_index.matcher_key(m)


def test_registry_version_bumps():
    versions = []
    for R in (SeriesRegistry, JaxRegistry):
        reg = R(["host"])
        seen = [reg.version]
        reg.intern_rows([np.asarray(["a", "b"], object)])
        seen.append(reg.version)
        reg.intern_rows([np.asarray(["a"], object)])  # no new series
        seen.append(reg.version)
        reg.ensure_series(2, ["c"])
        seen.append(reg.version)
        reg.add_tag("dc")
        seen.append(reg.version)
        restored = R.restore(reg.snapshot())
        assert restored.version == len(restored)
        assert seen[1] > seen[0] and seen[2] == seen[1]
        assert seen[3] > seen[2] and seen[4] > seen[3]
        versions.append(seen)
    assert versions[0] == versions[1]


def test_compile_matcher_memoized():
    from greptimedb_tpu.query.expr import compile_matcher as jax_compile
    from greptimedb_tpu_torch.query.expr import compile_matcher

    a = compile_matcher("h[0-9]+")
    assert a is compile_matcher("h[0-9]+")
    assert a.match("h12")
    assert a.pattern == jax_compile("h[0-9]+").pattern


def test_expand_csr_matches_jax():
    from greptimedb_tpu.index.tag_index import _expand_csr as jax_expand

    rng = np.random.default_rng(3)
    col = rng.integers(0, 9, 400).astype(np.int32)
    offsets = np.zeros(10, np.int64)
    np.cumsum(np.bincount(col, minlength=9), out=offsets[1:])
    order = np.argsort(col, kind="stable").astype(np.int32)
    for codes in ([], [4], [0, 3, 8], list(range(9))):
        cs = np.asarray(codes, np.int64)
        _same(_expand_csr(offsets, order, cs).astype(np.int32),
              jax_expand(offsets, order, cs).astype(np.int32))


# -- device plane ------------------------------------------------------

def _host_mask(jreg, m, s_pad):
    host = np.zeros(s_pad, bool)
    host[jreg.match_sids(m)] = True
    return host


@pytest.mark.parametrize("shards", [1, 4])
def test_device_plane_mask_parity_and_census(shards):
    device_plane.invalidate()
    jax_plane.invalidate()
    reg, jreg = _registries(n=700, hosts=9)
    s_pad = 1024
    devices = [CPU] * shards
    for m in CASES:
        if not m:
            continue
        out = device_plane.matcher_mask_dev(reg, m, s_pad, devices=devices)
        jout = jax_plane.matcher_mask_dev(jreg, m, s_pad)
        assert (out is None) == (jout is None), m
        if out is None:     # constant-true-only sets take the host path
            continue
        masks, any_match = out
        assert len(masks) == shards
        assert all(t.device == CPU and t.dtype == torch.bool for t in masks)
        got = torch.cat(masks).numpy()
        np.testing.assert_array_equal(got, np.asarray(jout[0]),
                                      err_msg=repr(m))
        np.testing.assert_array_equal(got, _host_mask(jreg, m, s_pad))
        assert any_match == bool(jout[1]) == bool(got.any())
    # census invariant: pool-reported bytes == sum of buffer bytes
    st = device_plane.pool_stats()
    bufs = device_plane.pool_buffers()
    assert st["bytes"] == sum(t.numel() * t.element_size() for t, _ in bufs)
    assert st["bytes"] > 0
    # the plane holds the (s_pad, 2) codes once, cut over the shards
    planes = [t for t, kind in bufs if kind == "tag_index:plane"]
    assert len(planes) == shards
    assert sum(t.shape[0] for t in planes) == s_pad


def test_device_plane_repeated_set_moves_nothing():
    device_plane.invalidate()
    reg, _ = _registries(n=300, hosts=5)
    m = [("host", "re", re.compile("h[12]"))]
    first = device_plane.matcher_mask_dev(reg, m, 512, devices=[CPU] * 2)
    s0 = device_plane.stats()
    again = device_plane.matcher_mask_dev(reg, m, 512, devices=[CPU] * 2)
    s1 = device_plane.stats()
    assert again is first
    assert s1["mask_hits"] == s0["mask_hits"] + 1
    assert s1["ok_upload_bytes"] == s0["ok_upload_bytes"]
    assert s1["plane_upload_bytes"] == s0["plane_upload_bytes"]
    # each ok-table crossed once per distinct device: 5 values -> 8 bools
    assert s0["ok_upload_bytes"] >= 8


def test_device_plane_declines_as_jax_does():
    device_plane.invalidate()
    reg, jreg = _registries(n=100, hosts=3)
    m = [("host", "eq", "h1")]
    for args in ((50,), (256,)):        # s_pad short of the series count
        got = device_plane.matcher_mask_dev(reg, m, *args, devices=[CPU],
                                            num_series=100)
        want = jax_plane.matcher_mask_dev(jreg, m, *args, num_series=100)
        assert (got is None) == (want is None)
    assert device_plane.matcher_mask_dev(
        reg, m, 256, devices=[CPU], num_series=99) is None
    tagless = SeriesRegistry([])
    tagless.intern_rows([], n=4)
    assert device_plane.matcher_mask_dev(tagless, m, 8, devices=[CPU]) is None
    with _configured(device_plane=False):
        assert device_plane.matcher_mask_dev(reg, m, 256,
                                             devices=[CPU]) is None
    # a missing tag that must hold a value: all-False, no column needed
    masks, any_match = device_plane.matcher_mask_dev(
        reg, [("ghost", "eq", "x")], 256, devices=[CPU] * 2)
    assert not any_match and not torch.cat(masks).any()


def test_device_plane_invalidates_on_registry_growth():
    device_plane.invalidate()
    jax_plane.invalidate()
    reg, jreg = _registries(n=100, hosts=3)
    m = [("host", "eq", "h1")]
    assert device_plane.matcher_mask_dev(reg, m, 256, devices=[CPU])
    _intern_both((reg, jreg), ["h1"], ["rn"])
    out2 = device_plane.matcher_mask_dev(reg, m, 256, devices=[CPU])
    jout2 = jax_plane.matcher_mask_dev(jreg, m, 256)
    assert out2 is not None and jout2 is not None
    got = out2[0][0].numpy()
    np.testing.assert_array_equal(got, _host_mask(jreg, m, 256))
    np.testing.assert_array_equal(got, np.asarray(jout2[0]))


# -- SST sid pruning ---------------------------------------------------

def test_sst_meta_carries_sid_range_and_prunes_row_groups(tmp_path):
    from greptimedb_tpu.storage import sst as JS
    from greptimedb_tpu.storage.memtable import ColumnarRows as JRows
    from greptimedb_tpu.storage.object_store import FsObjectStore as JFs
    from greptimedb_tpu_torch.storage import sst as TS
    from greptimedb_tpu_torch.storage.memtable import ColumnarRows
    from greptimedb_tpu_torch.storage.object_store import FsObjectStore

    n = 4000
    parts = dict(sid=np.arange(n, dtype=np.int32),
                 ts=np.arange(n, dtype=np.int64) + 1000)
    rows = ColumnarRows(seq=np.arange(n, dtype=np.uint64),
                        op=np.zeros(n, np.uint8),
                        fields={"v": np.arange(n, dtype=np.float64)}, **parts)
    jrows = JRows(seq=np.arange(n, dtype=np.int64), op=np.zeros(n, np.int8),
                  fields={"v": np.arange(n, dtype=np.float64)}, **parts)
    store = FsObjectStore(str(tmp_path / "port"))
    jstore = JFs(str(tmp_path / "jax"))
    meta = TS.write_sst(store, "t.sst", "f1", rows, row_group_rows=512)
    jmeta = JS.write_sst(jstore, "t.parquet", "f1", jrows,
                         row_group_rows=512)
    assert (meta.sid_min, meta.sid_max) == (jmeta.sid_min, jmeta.sid_max)
    assert (meta.sid_min, meta.sid_max) == (0, n - 1)
    before = tag_index.pruned_counts()
    with stats.collect() as st:
        out = TS.read_sst(store, meta, sids=np.asarray([5], np.int32))
    jout = JS.read_sst(jstore, jmeta, sids=np.asarray([5], np.int32))
    assert out.sid.tolist() == jout.sid.tolist() == [5]
    assert out.fields["v"].tolist() == jout.fields["v"].tolist()
    after = tag_index.pruned_counts()
    # 7 of 8 groups dropped, in the query's notes and the tallies
    assert st.counters["index_pruned_row_groups"] == 7
    assert st.counters["index_pruned_bytes"] > 0
    assert after["row_groups"] == before["row_groups"] + 7
    assert after["bytes_row_group"] > before["bytes_row_group"]


def test_region_scan_skips_disjoint_ssts(tmp_path):
    import test_compaction as tc
    from greptimedb_tpu_torch.storage.object_store import FsObjectStore
    from greptimedb_tpu_torch.storage.region import (
        Region,
        RegionMetadata,
        RegionOptions,
    )

    meta = RegionMetadata(
        region_id=1, table="t", tag_names=["h"], field_names=["v"],
        ts_name="ts", options=RegionOptions(compaction_trigger_files=100,
                                            compaction_window_ms=tc.WINDOW))
    r = Region(meta, FsObjectStore(str(tmp_path / "port")),
               str(tmp_path / "wal"))
    jr = tc.make_region(tmp_path, trigger=100)
    # two flushes; the second one's sids extend past the first's
    for reg in (r, jr):
        tc.write_flush(reg, ["a", "b"], [100, 101], [1.0, 2.0])
        tc.write_flush(reg, ["c", "d"], [200, 201], [3.0, 4.0])
    metas = r.manifest.state.ssts
    assert len(metas) == 2
    assert [(m.sid_min, m.sid_max) for m in metas] == [
        (m.sid_min, m.sid_max) for m in jr.manifest.state.ssts]
    before = tag_index.pruned_counts()["bytes_sst"]
    sids = r.match_sids([("h", "eq", "d")])
    _same(sids, jr.match_sids([("h", "eq", "d")]))
    with stats.collect() as st:
        rows = r.scan(sids=sids)
    assert rows.fields["v"].tolist() == [4.0]
    assert jr.scan(sids=sids).rows.fields["v"].tolist() == [4.0]
    # the whole first SST skipped by its manifest sid range
    assert st.counters["index_ssts_skipped"] == 1
    assert st.counters["index_pruned_bytes"] == metas[0].size_bytes
    assert tag_index.pruned_counts()["bytes_sst"] == (
        before + metas[0].size_bytes)
    r.close()
    jr.close()


def test_index_pool_stats():
    reg, _ = _registries(n=50)
    ix = _index.index_for(reg)
    assert _index.index_for(reg) is ix
    ix.match_sids([("host", "eq", "h1")])
    ix.match_sids([("host", "eq", "h1")])
    s = ix.stats()
    assert s["builds"] == 1 and s["hits"] == 1 and s["misses"] == 1
    assert s["cached_results"] == 1 and s["bytes"] == ix.nbytes() > 0
    pool = tag_index.pool_stats()
    assert pool["bytes"] >= s["bytes"] and pool["entries"] >= 1


# ----------------------------------------------------------------------
# invalidation through the SQL path (tests/test_index_invalidation.py)
# ----------------------------------------------------------------------

class _Pair:
    def __init__(self, root):
        self.root = root
        self.open()

    def open(self):
        self.port = Standalone(str(self.root / "port"), device="cpu",
                               x64=True, warm_start=False)
        self.jax = JaxStandalone(str(self.root / "jax"), prefer_device=False,
                                 warm_start=False)

    def close(self):
        self.port.close()
        self.jax.close()

    def both(self, stmt):
        self.port.sql(stmt)
        self.jax.sql(stmt)

    def clear_caches(self):
        """Drop every layer that could replay an index-era result to the
        oracle run: the merged-scan caches and the result caches."""
        for inst in (self.port, self.jax):
            for t in _tables(inst):
                for r in t.regions:
                    r.invalidate_scan_cache()
            inst.result_cache.clear()


def _tables(inst):
    cat = inst.catalog
    return [cat.table("public", n) for n in cat.table_names("public")]


@pytest.fixture()
def pair(tmp_path):
    p = _Pair(tmp_path)
    yield p
    p.close()


@contextlib.contextmanager
def index_disabled():
    with _configured(enable=False):
        yield


# matcher-carrying queries: eq (a posting lookup), ne (dictionary-domain
# evaluation), and LIKE (a regex matcher)
QS = (
    "select host, sum(v), count(*) from t1 where host = 'h1' "
    "group by host order by host",
    "select host, sum(v), count(*) from t1 where host != 'h0' "
    "group by host order by host",
    "select host, count(*) from t1 where host like 'h%' "
    "group by host order by host",
)


def _rows(res):
    return [list(r) for r in res.rows()]


def _assert_identical(p, queries=QS):
    got = [_rows(p.port.sql(q)) for q in queries]
    want_jax = [_rows(p.jax.sql(q)) for q in queries]
    p.clear_caches()
    with index_disabled():
        oracle = [_rows(p.port.sql(q)) for q in queries]
    for g, w, o, q in zip(got, want_jax, oracle, queries):
        assert g == o, f"index-on result diverged for: {q}"
        assert g == w, f"port diverged from the JAX package for: {q}"
    return got


def _seed(p, rows=40, table="t1"):
    p.both(f"create table {table} (ts timestamp time index, host string "
           "primary key, v double)")
    values = ", ".join(f"('h{i % 4}', {1_000_000 + i * 1000}, {float(i)})"
                       for i in range(rows))
    p.both(f"insert into {table} (host, ts, v) values {values}")


def _flush(p, table="t1"):
    for inst in (p.port, p.jax):
        inst.catalog.table("public", table).flush()


def test_seeded_matcher_queries_identical(pair):
    _seed(pair)
    got = _assert_identical(pair)
    assert got[0]   # the eq query actually matched something


def test_flush_and_new_series_invalidate(pair):
    _seed(pair)
    _assert_identical(pair)     # warm: result cache + postings built
    _flush(pair)
    _assert_identical(pair)
    # a NEW series after the warm lookups: the registry version bump must
    # invalidate cached sid sets
    pair.both("insert into t1 (host, ts, v) values ('h9', 99000000, 7.0)")
    q = "select host, sum(v) from t1 where host = 'h9' group by host"
    assert _rows(pair.port.sql(q)) == [["h9", 7.0]] == _rows(
        pair.jax.sql(q))
    _assert_identical(pair)


def test_compaction_device_merge_invalidates(pair):
    """Compaction rewrites SSTs (fresh sid ranges) through the device
    merge path (the plain torch merge on the CPU); matcher scans across
    the swap stay identical."""
    from greptimedb_tpu.storage.compaction import CompactionOptions as JCO
    from greptimedb_tpu_torch.storage.compaction import CompactionOptions

    pair.port.engine.config.compaction = CompactionOptions(
        device_merge_min_rows=1, verify_device_merge=True)
    pair.jax.engine.config.compaction = JCO(device_merge_min_rows=1,
                                            verify_device_merge=True)
    _seed(pair, rows=20)
    _flush(pair)
    for round_ in range(4):     # enough L0 runs to trip the picker
        pair.both("insert into t1 (host, ts, v) values " + ", ".join(
            f"('h{i % 4}', {2_000_000 + round_ * 40_000 + i * 1000}, "
            f"{float(i)})" for i in range(20)))
        _flush(pair)
    _assert_identical(pair)     # warm
    region = pair.port.catalog.table("public", "t1").regions[0]
    n0 = len(region.manifest.state.ssts)
    assert region.compact(force=True)
    assert pair.jax.catalog.table("public", "t1").regions[0].compact(
        force=True)
    assert len(region.manifest.state.ssts) < n0
    _assert_identical(pair)


def test_alter_add_tag_invalidates(pair):
    """ALTER adding a tag widens the registry's tag set: the postings must
    rebuild (k changed) and matchers on the new tag must work."""
    _seed(pair)
    _assert_identical(pair)     # warm with the old tag set
    pair.both("alter table t1 add column dc string primary key")
    pair.both("insert into t1 (host, dc, ts, v) values "
              "('h0', 'east', 50000000, 1.0), ('h5', 'west', 50001000, 2.0)")
    dc_qs = (
        "select host, sum(v) from t1 where dc = 'east' "
        "group by host order by host",
        "select host, sum(v) from t1 where dc != 'east' "
        "group by host order by host",
    )
    got = _assert_identical(pair, QS + dc_qs)
    assert got[3] == [["h0", 1.0]]


def test_truncate_then_refill_identical(pair):
    _seed(pair)
    _flush(pair)
    _assert_identical(pair)     # warm
    pair.both("truncate table t1")
    q = "select count(*) from t1 where host = 'h1'"
    assert _rows(pair.port.sql(q)) == [[0]] == _rows(pair.jax.sql(q))
    _assert_identical(pair)
    pair.both("insert into t1 (host, ts, v) values ('h1', 1000, 5.0)")
    got = _assert_identical(pair)
    assert got[0] == [["h1", 5.0, 1]]


def test_drop_and_recreate_identical(pair):
    _seed(pair)
    _assert_identical(pair)     # warm against the first incarnation
    pair.both("drop table t1")
    pair.both("create table t1 (ts timestamp time index, host string "
              "primary key, v double)")
    pair.both("insert into t1 (host, ts, v) values ('h1', 1000, 42.0)")
    got = _assert_identical(pair)
    assert got[0] == [["h1", 42.0, 1]]


def test_reopen_identical(pair):
    """The JAX test migrates the region to another datanode, which rebuilds
    its registry and index; a reopen of the data root does the same here."""
    _seed(pair)
    _flush(pair)
    q = ("select host, sum(v) from t1 where host = 'h1' "
         "group by host order by host",)
    warm = _assert_identical(pair, q)
    pair.close()
    pair.open()
    got = _assert_identical(pair, q)
    assert got == warm
    pair.both("insert into t1 (host, ts, v) values ('h1', 3000, 10.0)")
    got = _assert_identical(pair, q)
    assert got[0][0][1] == warm[0][0][1] + 10.0
