"""The dashboard poll path against the JAX package, on the CPU: the result
cache, the query sessions and the `since` delta cursor.

Every standalone case of tests/test_result_cache.py runs through both
packages: the port's Standalone(device="cpu"), the JAX package's under
JAX_PLATFORMS=cpu as its tests run it, each with its own result cache,
session registry and readback tallies. Each case asserts what the JAX
test asserts, on both sides, and the two sides' observations (results
bit for bit: names, dtypes, validity, value bits; rows; whether a tally
moved) must be equal. The data is integer-valued, so every float sum
and mean is exact in any order of adds and the grid's results are equal
bit for bit.

Port-only checks: a grid entry rebuilt after its predecessor was dropped
never meets the predecessor's session buffer, even where the new entry
gets the old one's id() (simulated by making every id() in
query/device_range.py and promql/fast.py answer one number); a delta
readback moves exactly planes x groups x (steps after the cursor) x 4
bytes; the sharded paths (gather and ring, four CPU shards) narrow
every part before the gather and answer the filtered full result.
"""

import json
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

from greptimedb_tpu.instance import Standalone as JaxStandalone
from greptimedb_tpu.query import readback as jax_readback
from greptimedb_tpu.query import sessions as jax_sessions
from greptimedb_tpu.query.result_cache import ResultCache as JaxResultCache
from greptimedb_tpu.servers import http as jax_http
from greptimedb_tpu.session import QueryContext as JaxCtx
from greptimedb_tpu_torch.catalog.table import Table
from greptimedb_tpu_torch.instance import Instance, Standalone
from greptimedb_tpu_torch.parallel.mesh import MeshOptions, make_mesh
from greptimedb_tpu_torch.promql import fast as tfast
from greptimedb_tpu_torch.promql.engine import PromEngine
from greptimedb_tpu_torch.query import device_range as tdr
from greptimedb_tpu_torch.query import readback, sessions
from greptimedb_tpu_torch.query.result_cache import (
    ResultCache,
    filter_since,
    plan_fingerprint,
    plan_volatile,
    ts_output_name,
)
from greptimedb_tpu_torch.servers import http
from greptimedb_tpu_torch.session import QueryContext

Q = "select host, sum(v), count(*) from t group by host order by host"


class Side:
    """One package's Standalone, its result cache and its tallies behind
    one face."""

    def __init__(self, pkg: str, root, prefer_device: bool):
        self.pkg = pkg
        if pkg == "port":
            self.inst = Standalone(str(root), device="cpu", x64=True,
                                   warm_start=False,
                                   prefer_device=prefer_device)
        else:
            self.inst = JaxStandalone(str(root), warm_start=False,
                                      prefer_device=prefer_device)

    def ctx(self, since=None):
        ctx = QueryContext() if self.pkg == "port" else JaxCtx()
        if since is not None:
            ctx.extensions["since_ms"] = since
        return ctx

    def sql(self, q, since=None):
        return self.inst.sql(q, self.ctx(since))

    def exec(self, q):
        return self.inst.execute_sql(q)

    def enable_rc(self, **kw):
        cls = ResultCache if self.pkg == "port" else JaxResultCache
        rc = cls(enabled=True, **kw)
        self.inst.result_cache = rc
        self.inst.catalog.result_cache = rc
        return rc

    def rc_hits(self) -> int:
        rc = self.inst.result_cache
        return rc.hits if self.pkg == "port" else rc._hits

    def rc_misses(self) -> int:
        rc = self.inst.result_cache
        return rc.misses if self.pkg == "port" else rc._misses

    def session_hits(self) -> int:
        if self.pkg == "port":
            return sessions.global_sessions.hits
        return jax_sessions.global_sessions._hits

    def delta_bytes(self) -> int:
        if self.pkg == "port":
            return readback.readback_bytes("delta")
        return int(jax_readback.readback_bytes("delta"))

    def configure_sessions(self, options):
        (sessions if self.pkg == "port" else jax_sessions).configure(options)

    def http_server(self):
        mod = http if self.pkg == "port" else jax_http
        return mod.HttpServer(self.inst, port=0).start()

    def close(self):
        self.inst.close()


def _col_key(c):
    v = np.asarray(c.values)
    m = np.asarray(c.valid_mask, bool)
    if v.dtype.kind == "f":
        vals = v.view(f"u{v.dtype.itemsize}")[m].tolist()
    elif v.dtype == object:
        vals = v[m].tolist()
    else:
        vals = v[m].tolist()
    return (str(v.dtype), m.tolist(), vals)


def key(res):
    """A result as comparable data: names, then each column's dtype,
    validity and value bits."""
    return (list(res.names), [_col_key(c) for c in res.cols])


def both(tmp_path, scenario, prefer_device=False):
    """Run `scenario(side)` on each package; their observations must be
    equal."""
    got = {}
    for pkg in ("port", "jax"):
        side = Side(pkg, tmp_path / pkg, prefer_device)
        try:
            got[pkg] = scenario(side)
        finally:
            side.close()
    assert got["port"] == got["jax"]
    return got["port"]


def _seed(side, table="t", rows=24):
    side.exec(f"create table {table} (ts timestamp time index, host string "
              "primary key, v double)")
    values = ", ".join(f"('h{i % 3}', {1_000_000 + i * 1000}, {float(i)})"
                       for i in range(rows))
    side.exec(f"insert into {table} (host, ts, v) values {values}")


# ----------------------------------------------------------------------
# the result cache: hits and invalidation
# ----------------------------------------------------------------------

def test_result_cache_hit_serves_same_rows(tmp_path):
    def scenario(s):
        rc = s.enable_rc()
        _seed(s)
        cold = key(s.sql(Q))
        h0 = s.rc_hits()
        warm = key(s.sql(Q))
        assert warm == cold
        assert s.rc_hits() > h0
        assert rc.entry_count >= 1 and rc.byte_count > 0
        return [cold, s.rc_hits() - h0, rc.entry_count]

    both(tmp_path, scenario)


def test_insert_invalidates(tmp_path):
    def scenario(s):
        s.enable_rc()
        _seed(s)
        before = s.sql(Q).rows()
        s.sql(Q)
        s.exec("insert into t (host, ts, v) values ('h0', 99000000, 1000.0)")
        after = s.sql(Q)
        rows = after.rows()
        assert rows != before
        h0 = next(r for r in rows if r[0] == "h0")
        b0 = next(r for r in before if r[0] == "h0")
        assert h0[1] == b0[1] + 1000.0 and h0[2] == b0[2] + 1
        return [key(after)]

    both(tmp_path, scenario)


def test_flush_and_compact_invalidate(tmp_path):
    def scenario(s):
        s.enable_rc()
        _seed(s)
        cold = key(s.sql(Q))
        s.sql(Q)
        m0 = s.rc_misses()
        table = s.inst.catalog.table("public", "t")
        table.flush()   # the physical version moves, the rows do not
        assert key(s.sql(Q)) == cold
        assert s.rc_misses() > m0
        for round_ in range(4):
            s.exec("insert into t (host, ts, v) values " + ", ".join(
                f"('h{i % 3}', {2_000_000 + round_ * 40_000 + i * 1000}, "
                f"{float(i)})" for i in range(12)))
            table.flush()
        want = key(s.sql(Q))
        s.sql(Q)
        m1 = s.rc_misses()
        compacted = sum(1 for r in table.regions if r.compact())
        assert compacted > 0
        assert key(s.sql(Q)) == want
        assert s.rc_misses() > m1
        return [cold, want, compacted]

    both(tmp_path, scenario)


def test_truncate_and_alter_invalidate(tmp_path):
    def scenario(s):
        s.enable_rc()
        _seed(s)
        s.sql(Q)
        s.sql(Q)
        s.exec("alter table t add column extra double")
        # the schema change moves the version (it holds the column names)
        a = s.sql("select count(*) from t").rows()
        assert a == [[24]]
        s.inst.catalog.table("public", "t").truncate()
        b = s.sql("select count(*) from t").rows()
        assert b == [[0]]
        return [a, b]

    both(tmp_path, scenario)


def test_drop_purges_entries(tmp_path):
    def scenario(s):
        rc = s.enable_rc()
        _seed(s)
        s.sql(Q)
        n = rc.entry_count
        assert n >= 1
        s.exec("drop table t")
        assert rc.entry_count == 0
        return [n]

    both(tmp_path, scenario)


def test_volatile_ttl_and_explain_bypass(tmp_path):
    now = int(time.time() * 1000)

    def scenario(s):
        rc = s.enable_rc()
        _seed(s)
        n0 = rc.entry_count
        # now() in the projection depends on evaluation time: not cached
        s.sql("select count(*), now() from t")
        counts = [rc.entry_count]
        # a now()-folded WHERE bound fingerprints anew every call
        q = "select host, v from t where ts > now() - interval '100y'"
        first = key(s.sql(q))
        assert key(s.sql(q)) == first
        counts.append(rc.entry_count)
        s.exec("create table tt (ts timestamp time index, host string "
               "primary key, v double) with (ttl = '1h')")
        s.exec(f"insert into tt (host, ts, v) values ('a', {now - 60_000}, "
               "1.0)")
        ttl = key(s.sql("select host, sum(v) from tt group by host"))
        counts.append(rc.entry_count)   # a TTL window is wall-clock
        assert counts == [n0] * 3
        # EXPLAIN ANALYZE runs for real, never from a cached result
        s.sql(Q)
        res = s.sql("explain analyze " + Q)
        text = "\n".join(res.cols[0].values.tolist())
        assert "Metrics:" in text
        assert "result_cache: bypass" in text
        return [counts, first, ttl]

    both(tmp_path, scenario)


# ----------------------------------------------------------------------
# the `since` delta cursor
# ----------------------------------------------------------------------

def test_since_filters_plain_select(tmp_path):
    def scenario(s):
        _seed(s)
        res = s.sql("select ts, host, v from t order by ts",
                    since=1_000_000 + 11 * 1000)
        ts = np.asarray(res.cols[0].values, np.int64)
        assert len(ts) == 12 and ts.min() > 1_011_000
        return [key(res)]

    both(tmp_path, scenario)


def test_since_with_result_cache_serves_delta_from_full(tmp_path):
    def scenario(s):
        rc = s.enable_rc()
        _seed(s)
        full = s.sql("select ts, host, v from t").rows()
        assert rc.entry_count == 1
        h0 = s.rc_hits()
        delta = s.sql("select ts, host, v from t",
                      since=1_000_000 + 11 * 1000)
        # served from the cached full result by a host row filter
        assert s.rc_hits() > h0
        assert delta.rows() == [r for r in full if r[0] > 1_011_000]
        # a cursor past everything answers no rows
        none = s.sql("select ts, host, v from t", since=99_000_000_000)
        assert none.rows() == []
        return [key(delta), key(none)]

    both(tmp_path, scenario)


def test_since_with_limit_executes_delta_not_cached_slice(tmp_path):
    """The cursor applies before ORDER BY/LIMIT: a LIMIT plan's cached
    result holds only its first page, so a since poll executes the
    delta."""
    def scenario(s):
        s.enable_rc()
        _seed(s)
        q = "select ts, host, v from t order by ts limit 10"
        first = s.sql(q).rows()
        assert len(first) == 10
        delta = s.sql(q, since=first[-1][0])
        rows = delta.rows()
        assert len(rows) == 10
        assert min(r[0] for r in rows) > first[-1][0]
        return [key(delta)]

    both(tmp_path, scenario)


def test_since_without_ts_projection_executes_delta(tmp_path):
    def scenario(s):
        s.enable_rc()
        _seed(s)
        s.sql("select host, v from t")      # the cached full result
        delta = s.sql("select host, v from t", since=1_011_000)
        assert delta.num_rows == 12         # rows past the cursor
        return [key(delta)]

    both(tmp_path, scenario)


def test_since_range_device_delta_readback(tmp_path):
    """The grid path: a since poll narrows the session's resident result
    before the readback; rows equal the full result filtered by ts."""
    q = ("select ts, host, avg(v) range '10s' from t "
         "align '10s' by (host) order by ts, host")

    def scenario(s):
        _seed(s, rows=60)
        full = s.sql(q)
        assert s.inst.query_engine.last_exec_path == "device"
        rows = full.rows()
        steps = sorted({r[0] for r in rows})
        cut = steps[len(steps) // 2]
        d0, s0 = s.delta_bytes(), s.session_hits()
        delta = s.sql(q, since=cut)
        assert delta.rows() == [r for r in rows if r[0] > cut]
        assert s.delta_bytes() > d0
        # the repeated shape reused the resident result
        assert s.session_hits() > s0
        return [key(full), key(delta)]

    both(tmp_path, scenario, prefer_device=True)


def test_since_range_fill_prev_matches_full(tmp_path):
    """FILL PREV + since: the fill runs over the whole grid, then only the
    cells past the cursor are emitted."""
    q = ("select ts, host, avg(v) range '10s' fill prev from f "
         "align '10s' by (host) order by ts")

    def scenario(s):
        s.exec("create table f (ts timestamp time index, host string "
               "primary key, v double)")
        values = ", ".join(f"('h0', {ts}, {v})"
                           for ts, v in ((0, 1.0), (10_000, 2.0),
                                         (40_000, 5.0)))
        s.exec(f"insert into f (host, ts, v) values {values}")
        full = s.sql(q)
        delta = s.sql(q, since=10_000)
        rows = delta.rows()
        assert rows == [r for r in full.rows() if r[0] > 10_000]
        filled = [r for r in rows if r[0] in (20_000, 30_000)]
        assert filled and all(r[2] == 2.0 for r in filled)
        return [key(full), key(delta)]

    both(tmp_path, scenario, prefer_device=True)


def test_session_registry_invalidation(tmp_path):
    q = "select ts, host, max(v) range '10s' from t align '10s' by (host)"

    def scenario(s):
        _seed(s, rows=60)
        before = s.sql(q)
        s0 = s.session_hits()
        assert key(s.sql(q)) == key(before)
        assert s.session_hits() > s0
        s.exec("insert into t (host, ts, v) values ('h0', 1000000, 500.0)")
        after = s.sql(q)    # the write invalidated the session buffer
        assert after.rows() != before.rows()
        assert any(r[2] == 500.0 for r in after.rows())
        return [key(before), key(after)]

    both(tmp_path, scenario, prefer_device=True)


def test_sessions_disabled_still_correct(tmp_path):
    q = "select ts, host, min(v) range '10s' from t align '10s' by (host)"

    def scenario(s):
        _seed(s, rows=60)
        want = key(s.sql(q))
        s.configure_sessions({"enable": False})
        try:
            s0 = s.session_hits()
            got = [key(s.sql(q)), key(s.sql(q))]
            assert got == [want, want] and s.session_hits() == s0
        finally:
            s.configure_sessions({"enable": True})
        return [want]

    both(tmp_path, scenario, prefer_device=True)


# ----------------------------------------------------------------------
# HTTP: the ?since= parameter
# ----------------------------------------------------------------------

def _http_sql(port, q, since=None):
    url = (f"http://127.0.0.1:{port}/v1/sql?sql=" + urllib.parse.quote(q))
    if since is not None:
        url += f"&since={since}"
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            doc = json.loads(resp.read())
            doc.pop("execution_time_ms", None)
            return resp.status, doc
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_since_param(tmp_path):
    def scenario(s):
        s.enable_rc()
        _seed(s)
        srv = s.http_server()
        try:
            q = "select ts, host, v from t order by ts"
            st, full = _http_sql(srv.port, q)
            rows = full["output"][0]["records"]["rows"]
            st2, delta = _http_sql(srv.port, q, since=1_011_000)
            assert st == st2 == 200
            assert delta["output"][0]["records"]["rows"] == [
                r for r in rows if r[0] > 1_011_000]
            bad = [_http_sql(srv.port, q, since=v)
                   for v in ("nan", "-1", "inf", "abc")]
            assert [b[0] for b in bad] == [400] * 4
            return [full, delta, bad]
        finally:
            srv.stop()

    both(tmp_path, scenario)


# ----------------------------------------------------------------------
# the port alone
# ----------------------------------------------------------------------

def _mem_table(name, values):
    """An in-memory table of 4 hosts x 30 rows at 1 s: the same writes in
    the same order (so the same data version) whatever `values` holds."""
    t = Table(name, ts_name="ts", tag_names=["host"], fields=["v"])
    hosts = np.array([f"h{i % 4}" for i in range(120)], object)
    ts = 1_000_000 + np.arange(120, dtype=np.int64) * 1000
    t.write({"host": hosts}, ts, {"v": np.asarray(values, np.float64)})
    return t


def _fake_id(monkeypatch, *mods):
    """Every id() in `mods` answers one number: each new grid entry gets
    its predecessor's id, the case a freed entry's address reused."""
    for mod in mods:
        monkeypatch.setattr(mod, "id", lambda o: 7, raising=False)


@pytest.mark.parametrize("drop", ["lru", "stale", "replace", "clear"])
def test_rebuilt_entry_never_hits_a_dropped_entrys_session(monkeypatch,
                                                           drop):
    """Two tables whose grids have the same shape and version but other
    values; with every entry id the same, the second table's poll after
    the first table's entry was dropped (an LRU victim, a stale version,
    a replaced entry, a cleared cache) must answer its own values. Without
    the release on the drop path it would be served the first table's
    buffer."""
    _fake_id(monkeypatch, tdr)
    x = _mem_table("x", np.arange(120.0))
    y = _mem_table("y", np.arange(120.0) + 1000.0)
    qx = "select ts, host, max(v) range '10s' from x align '10s' by (host)"
    qy = qx.replace("from x", "from y")
    other = Instance(device="cpu", prefer_device=True)
    other.catalog.register(y)
    want_y = key(other.sql(qy))
    other.query_engine.range_cache.clear()
    sessions.global_sessions.clear()

    inst = Instance(device="cpu", prefer_device=True)
    inst.catalog.register(x)
    inst.catalog.register(y)
    eng = inst.query_engine
    cache = eng.range_cache
    assert key(inst.sql(qx)) != want_y and eng.last_session == "miss"
    inst.sql(qx)
    assert eng.last_session == "hit"
    # held, so the registry's collection path cannot purge for the drop
    held = list(cache._entries.values())
    if drop == "lru":
        # y's entry evicts x's on insert
        monkeypatch.setattr(tdr, "_MAX_ENTRIES", 1)
    elif drop == "stale":
        # x's next lookup finds its entry stale and drops it
        tkey = next(iter(cache._entries))[0]
        x.write({"host": np.array(["h0"], object)},
                np.array([1_000_000], np.int64), {"v": np.array([0.0])})
        assert cache.lookup_compatible(tkey, x.data_version(), 10_000,
                                       0) is None
    elif drop == "replace":
        k, entry = next(iter(cache._entries.items()))
        twin = tdr._Entry(**{f: getattr(entry, f)
                             for f in entry.__dataclass_fields__})
        cache.insert(k, twin)    # the old entry is released
    else:
        cache.clear()
    if drop != "lru":
        assert sessions.global_sessions.entry_count == 0
    got = inst.sql(qy)
    assert eng.last_session == "miss"
    assert key(got) == want_y
    del held


def test_collected_engine_leaves_no_session_buffers():
    """An engine dropped without clearing its grid cache: its entries'
    buffers go once the entries are collected, before the registry
    answers again."""
    import gc

    sessions.global_sessions.clear()
    inst = Instance(device="cpu", prefer_device=True)
    inst.catalog.register(_mem_table("x", np.arange(120.0)))
    inst.sql("select ts, host, max(v) range '10s' from x align '10s' "
             "by (host)")
    assert sessions.global_sessions.entry_count == 1
    del inst
    gc.collect()
    assert sessions.global_sessions.entry_count == 0


def test_promql_rebuilt_entry_never_hits_a_dropped_entrys_session(
        monkeypatch):
    _fake_id(monkeypatch, tfast)
    sessions.global_sessions.clear()
    tfast.invalidate_cache()
    inst = Instance(device="cpu", prefer_device=True)
    for name, base in (("x", 0.0), ("y", 1000.0)):
        t = Table(name, ts_name="ts", tag_names=["host"],
                  fields=["greptime_value"])
        hosts = np.array([f"h{i % 4}" for i in range(120)], object)
        t.write({"host": hosts},
                np.arange(120, dtype=np.int64) // 4 * 15_000,
                {"greptime_value": np.arange(120.0) + base})
        inst.catalog.register(t)
    eng = PromEngine(inst)

    def poll(q):
        val, _ = eng.query_range(q, 60_000, 300_000, 60_000)
        return eng.last_fast["session"], np.asarray(val.values)

    assert poll("sum(x)")[0] == "miss"
    assert poll("sum(x)")[0] == "hit"
    # held, so the registry's collection path cannot purge for the drop
    held = list(tfast._CACHE._entries.values())
    tfast.drop_table_entries(inst.catalog.table("public", "x"))
    sess, vals = poll("sum(y)")
    assert sess == "miss" and vals.min() >= 1000.0
    sess2, vals2 = poll("sum(y)")
    assert sess2 == "hit" and np.array_equal(vals, vals2)
    del held


def _delta_cases(inst, q, expect_program):
    """Full poll, then `since` polls at every step: rows equal the full
    result filtered by ts, and each delta readback moves exactly planes x
    groups x (steps after the cursor) x 4 bytes."""
    eng = inst.query_engine
    full = inst.sql(q)
    assert eng.last_exec_path == "device"
    assert eng.last_range["program"] == expect_program
    f0 = readback.readback_bytes("full")
    again = inst.sql(q)         # a session hit: the result alone crosses
    assert eng.last_session == "hit" and key(again) == key(full)
    full_bytes = readback.readback_bytes("full") - f0
    ts = np.asarray(full.cols[0].values, np.int64)
    steps = np.unique(ts)
    groups = full.num_rows // len(steps)
    assert groups * len(steps) == full.num_rows      # every cell present
    assert full_bytes % (groups * len(steps) * 4) == 0
    planes = full_bytes // (groups * len(steps) * 4)
    assert planes in (1, 2)
    for j0, cut in enumerate(steps[:-1].tolist(), start=1):
        ctx = QueryContext()
        ctx.extensions["since_ms"] = cut
        d0 = readback.readback_bytes("delta")
        delta = inst.sql(q, ctx)
        assert eng.last_session == "hit"
        moved = readback.readback_bytes("delta") - d0
        assert moved == planes * groups * (len(steps) - j0) * 4
        keep = ts > cut
        assert delta.num_rows == int(keep.sum())
        for a, b in zip(delta.cols, full.cols):
            assert np.array_equal(np.asarray(a.values),
                                  np.asarray(b.values)[keep])
    ctx = QueryContext()
    ctx.extensions["since_ms"] = int(steps[-1])
    d0 = readback.readback_bytes("delta")
    assert inst.sql(q, ctx).num_rows == 0
    assert readback.readback_bytes("delta") == d0   # nothing to read


@pytest.mark.parametrize("by", ["host", "region"])
def test_delta_readback_bytes_are_exact(by):
    inst = Instance(device="cpu", prefer_device=True)
    t = Table("cpu", ts_name="ts", tag_names=["host", "region"],
              fields=["v"])
    n = 8 * 60
    hosts = np.array([f"h{i % 8}" for i in range(n)], object)
    regions = np.array([f"r{i % 8 % 3}" for i in range(n)], object)
    t.write({"host": hosts, "region": regions},
            1_000_000 + np.arange(n, dtype=np.int64) // 8 * 1000,
            {"v": np.arange(n, dtype=np.float64)})
    inst.catalog.register(t)
    _delta_cases(inst, f"select ts, {by}, avg(v) range '10s', "
                       f"count(v) range '10s' from cpu align '10s' "
                       f"by ({by}) order by ts, {by}", "single")


@pytest.mark.parametrize("kernels", ["off", "on"])
@pytest.mark.parametrize("by", ["host", "region"])
def test_sharded_delta_narrows_every_part(kernels, by):
    """Four CPU shards: BY host keeps one part per shard (identity
    grouping), BY region folds them; either way the delta narrows before
    the gather and moves exactly its bytes."""
    inst = Instance(device="cpu", prefer_device=True,
                    mesh=make_mesh(["cpu"] * 4),
                    mesh_opts=MeshOptions(shard_min_series=1,
                                          pallas_kernels=kernels,
                                          pallas_min_series=1))
    t = Table("cpu", ts_name="ts", tag_names=["host", "region"],
              fields=["v"])
    n = 16 * 60
    hosts = np.array([f"h{i % 16:02d}" for i in range(n)], object)
    regions = np.array([f"r{i % 16 % 3}" for i in range(n)], object)
    t.write({"host": hosts, "region": regions},
            1_000_000 + np.arange(n, dtype=np.int64) // 16 * 1000,
            {"v": np.arange(n, dtype=np.float64)})
    inst.catalog.register(t)
    program = "sharded_ring" if kernels == "on" else "sharded_gather"
    _delta_cases(inst, f"select ts, {by}, sum(v) range '10s' from cpu "
                       f"align '10s' by ({by}) order by ts, {by}", program)


@pytest.mark.parametrize("lo", [-1, 0, 1, 5, 6])
def test_read_delta_moves_exactly_the_delta(lo):
    import torch

    t = torch.arange(2 * 3 * 6, dtype=torch.float32).reshape(2, 3, 6)
    f0, d0 = readback.readback_bytes("full"), readback.readback_bytes("delta")
    got = readback.read_delta(t, lo)
    assert np.array_equal(got, t.numpy()[..., max(lo, 0):])
    moved = (readback.readback_bytes("full") - f0,
             readback.readback_bytes("delta") - d0)
    assert moved == ((t.numel() * 4, 0) if lo <= 0
                     else (0, 2 * 3 * (6 - lo) * 4))
    mid = readback.read_delta(t, 2, axis=1)
    assert np.array_equal(mid, t.numpy()[:, 2:, :])


def test_result_cache_helpers():
    """plan_volatile, plan_fingerprint, ts_output_name and filter_since
    against the JAX package's on the same statements."""
    from greptimedb_tpu.query import result_cache as JRC
    from greptimedb_tpu.query.planner import plan_select as jplan
    from greptimedb_tpu.sql.parser import parse_sql as jparse
    from greptimedb_tpu_torch.query.planner import plan_select
    from greptimedb_tpu_torch.sql.parser import parse_sql

    t = Table("t", ts_name="ts", tag_names=["host"], fields=["v"])
    for q in (
        "select ts, host, v from t",
        "select host, v from t",
        "select ts as x, v from t where v > random()",
        "select count(*), now() from t",
        "select host, sum(v) from t group by host",
        "select ts, host, avg(v) range '10s' from t align '10s' by (host)",
        "select ts as w, avg(v) range '10s' from t align '10s'",
        "select host, v from t where host =~ 'h[0-9]+' order by v",
    ):
        p = plan_select(parse_sql(q)[0], ts_name="ts", tag_names=["host"],
                        all_columns=["ts", "host", "v"])
        jp = jplan(jparse(q)[0], ts_name="ts", tag_names=["host"],
                   all_columns=["ts", "host", "v"])
        assert plan_volatile(p) == JRC.plan_volatile(jp), q
        assert ts_output_name(p, t) == JRC.ts_output_name(jp, t), q
        assert plan_fingerprint(p) == plan_fingerprint(p), q
    res = Instance(device="cpu").sql("select 1 as a")
    assert filter_since(res, None, 0) is res


def test_result_cache_lru_budget_and_options():
    rc = ResultCache.from_options({"enable": True, "bytes": 100})
    assert rc.enabled and rc.max_bytes == 100
    assert not ResultCache.from_options(None).enabled
    inst = Instance(device="cpu")
    t = inst.catalog.register(_mem_table("x", np.arange(120.0)))
    res = inst.sql("select v from x limit 5")       # 40 bytes
    v = t.physical_version()
    for k in range(3):
        rc.put("public", t, f"fp{k}", v, res, None, "host")
    assert rc.entry_count == 2 and rc.byte_count == 80
    assert rc.get("public", t, "fp0", v) is None        # the LRU victim
    assert rc.get("public", t, "fp2", v).result is res
    assert rc.get("public", t, "fp2", ("other",)) is None   # stale
    assert rc.entry_count == 1 and rc.evictions == 2
    rc.put("public", t, "big", v, inst.sql("select v from x limit 20"),
           None, "host")                                # past the budget
    assert rc.get("public", t, "big", v) is None
    rc.purge_table("public", t.info.table_id)
    assert rc.entry_count == 0
