"""SQL statements beyond SELECT: the port's Standalone against the JAX
package's, on the CPU.

The same scripts run through `greptimedb_tpu_torch.instance.Standalone(tmp,
device="cpu")` and `greptimedb_tpu.instance.Standalone(tmp)`: DDL, INSERT
(defaults, nulls, typed fields, INSERT … SELECT), DELETE, TRUNCATE, ALTER,
USE, the SHOW/DESCRIBE family, TQL and ADMIN. Every statement's names and
rows must be equal (floats exactly), a statement that fails must fail on
both with the same error class, and the answers after close() and a
reopen must be equal too. Statements that wait raise UnsupportedError
naming their ROADMAP item; those the relational slice ported (set
operations, views, joins, CTEs) and the introspection and session slice
ported (EXPLAIN, information_schema, SET, PREPARE/EXECUTE, SHOW
PROCESSLIST, ADMIN kill) run as on the JAX package.
"""

import math

import pytest

from greptimedb_tpu.instance import Standalone as JaxStandalone
from greptimedb_tpu.session import QueryContext as JaxCtx
from greptimedb_tpu_torch.errors import UnsupportedError
from greptimedb_tpu_torch.instance import Standalone
from greptimedb_tpu_torch.session import QueryContext


def _norm(v):
    if isinstance(v, float) and math.isnan(v):
        return "NaN"
    return (type(v).__name__, v) if isinstance(v, (bool, float)) else v


def _run(inst, ctx, stmt):
    try:
        out = inst.execute_sql(stmt, ctx)[-1]
    except Exception as e:  # noqa: BLE001 - the class is compared
        return ("error", type(e).__name__)
    if out.result is None:
        return ("rows", out.affected_rows)
    res = out.result
    return ("result", list(res.names),
            [[_norm(v) for v in row] for row in res.rows()])


class Pair:
    """The two Standalones over their own data roots."""

    def __init__(self, tmp_path):
        self.roots = (str(tmp_path / "port"), str(tmp_path / "jax"))
        self.open()

    def open(self):
        self.port = Standalone(self.roots[0], device="cpu", x64=True,
                               warm_start=False)
        self.jax = JaxStandalone(self.roots[1], warm_start=False)
        self.pctx, self.jctx = QueryContext(), JaxCtx()

    def close(self):
        self.port.close()
        self.jax.close()

    def reopen(self):
        self.close()
        self.open()

    def same(self, stmt):
        got = _run(self.port, self.pctx, stmt)
        want = _run(self.jax, self.jctx, stmt)
        assert got == want, f"{stmt!r}:\nport {got}\njax  {want}"
        return got


@pytest.fixture
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.close()


DDL = [
    "CREATE TABLE cpu (ts TIMESTAMP TIME INDEX, host STRING, dc STRING, "
    "usage DOUBLE, PRIMARY KEY (host, dc))",
    "CREATE TABLE cpu (ts TIMESTAMP TIME INDEX, v DOUBLE)",
    "CREATE TABLE IF NOT EXISTS cpu (ts TIMESTAMP TIME INDEX, v DOUBLE)",
    "CREATE TABLE cpu2 LIKE cpu",
    "CREATE TABLE IF NOT EXISTS cpu2 LIKE cpu",
    "CREATE TABLE opts (ts TIMESTAMP TIME INDEX, v DOUBLE) "
    "WITH (ttl = '7d', append_mode = 'true')",
    "CREATE TABLE badttl (ts TIMESTAMP TIME INDEX, v DOUBLE) "
    "WITH (ttl = '-1d')",
    "CREATE TABLE notime (v DOUBLE)",
    "SHOW TABLES",
    "SHOW TABLES LIKE 'cpu%'",
    "SHOW CREATE TABLE cpu",
    "SHOW CREATE TABLE opts",
    "DESCRIBE cpu2",
    "DESC TABLE opts",
    "SHOW COLUMNS FROM cpu",
    "SHOW FULL COLUMNS FROM cpu LIKE 'u%'",
    "SHOW INDEX FROM cpu",
    "CREATE DATABASE d2",
    "CREATE DATABASE d2",
    "CREATE DATABASE IF NOT EXISTS d2",
    "SHOW DATABASES",
    "SHOW DATABASES LIKE 'd%'",
    "CREATE TABLE d2.t (ts TIMESTAMP TIME INDEX, v DOUBLE)",
    "SHOW TABLES FROM d2",
    "USE d2",
    "SHOW TABLES",
    "USE nope",
    "USE public",
    "DROP TABLE cpu2",
    "DROP TABLE cpu2",
    "DROP TABLE IF EXISTS cpu2",
    "DROP DATABASE d2",
    "DROP DATABASE IF EXISTS d2",
    "DROP DATABASE public",
    "SHOW DATABASES",
    "SHOW TABLES",
]


def test_ddl(pair):
    for stmt in DDL:
        pair.same(stmt)
    pair.reopen()
    for stmt in ("SHOW TABLES", "SHOW DATABASES", "SHOW CREATE TABLE opts",
                 "DESCRIBE cpu"):
        pair.same(stmt)


DML = [
    "CREATE TABLE t (ts TIMESTAMP TIME INDEX, host STRING, "
    "v DOUBLE, i BIGINT DEFAULT 7, u BIGINT UNSIGNED, b BOOLEAN, "
    "s STRING DEFAULT 'none', f FLOAT, PRIMARY KEY (host))",
    "INSERT INTO t (ts, host, v, u, b, f) VALUES "
    "(1000, 'a', 1.5, 3, true, 0.25), (2000, 'b', NULL, 4, false, NULL), "
    "('1970-01-01 00:00:03', 'a', -0.0, NULL, NULL, 1.5)",
    "INSERT INTO t VALUES (4000, 'c', 2.5, NULL, 9, true, NULL, 2.0)",
    "INSERT INTO t (ts, host) VALUES (5000, 'a', 1)",
    "INSERT INTO t (ts, host, v) VALUES (6000, 'd', 'x')",
    "INSERT INTO nope (ts) VALUES (1)",
    "SELECT * FROM t ORDER BY ts",
    "SELECT host, count(v), sum(i), max(s) FROM t GROUP BY host "
    "ORDER BY host",
    "INSERT INTO t (ts, host, v) VALUES (1000, 'a', 99.0)",
    "SELECT ts, host, v, i FROM t ORDER BY ts, host",
    "CREATE TABLE t2 (ts TIMESTAMP TIME INDEX, host STRING, "
    "v DOUBLE, PRIMARY KEY (host))",
    "INSERT INTO t2 SELECT ts, host, v FROM t WHERE host = 'a'",
    "INSERT INTO t2 (ts, host, v) SELECT ts + 100000, host, v * 2 FROM t",
    "SELECT * FROM t2 ORDER BY ts, host",
    "DELETE FROM t WHERE host = 'b'",
    "DELETE FROM t WHERE ts >= 4000 AND host IN ('c', 'zz')",
    "DELETE FROM t WHERE host = 'nobody'",
    "SELECT * FROM t ORDER BY ts",
    "ALTER TABLE t ADD COLUMN w DOUBLE",
    "ALTER TABLE t ADD COLUMN w DOUBLE",
    "ALTER TABLE t ADD COLUMN region STRING PRIMARY KEY",
    "INSERT INTO t (ts, host, region, w) VALUES (7000, 'a', 'eu', 3.5)",
    "SELECT * FROM t ORDER BY ts, host",
    "ALTER TABLE t DROP COLUMN f",
    "ALTER TABLE t DROP COLUMN host",
    "ALTER TABLE t DROP COLUMN nope",
    "DESCRIBE t",
    "SELECT * FROM t ORDER BY ts, host",
    "ALTER TABLE t RENAME t3",
    "ALTER TABLE t2 RENAME t3",
    "SELECT count(*) FROM t",
    "SELECT * FROM t3 ORDER BY ts, host",
    "SHOW CREATE TABLE t3",
    "TRUNCATE TABLE t2",
    "SELECT count(*) FROM t2",
    "INSERT INTO t2 (ts, host, v) VALUES (10, 'z', 1.0)",
    "SELECT * FROM t2",
    "TRUNCATE t3",
    "SELECT * FROM t3",
]


def test_dml_and_alter(pair):
    for stmt in DML:
        pair.same(stmt)
    pair.reopen()
    for stmt in ("SELECT * FROM t3", "SELECT * FROM t2", "DESCRIBE t3",
                 "SHOW TABLES"):
        pair.same(stmt)


def _series_rows(n_hosts=4, n=30):
    rows = []
    for h in range(n_hosts):
        for k in range(n):
            rows.append(f"({k * 15000}, 'h{h}', 'dc{h % 2}', "
                        f"{(h * 7 + k * 3) % 11 + 0.5})")
    return ", ".join(rows)


def test_tql_and_admin(pair):
    pair.same("CREATE TABLE m (ts TIMESTAMP TIME INDEX, host STRING, "
              "dc STRING, greptime_value DOUBLE, PRIMARY KEY (host, dc))")
    pair.same(f"INSERT INTO m (ts, host, dc, greptime_value) VALUES "
              f"{_series_rows()}")
    pair.same("ADMIN flush_table('m')")
    pair.same(f"INSERT INTO m (ts, host, dc, greptime_value) VALUES "
              f"(15000, 'h0', 'dc0', 100.0), (30000, 'h9', 'dc1', 1.0)")
    for stmt in (
        "TQL EVAL (0, 300, '30s') m",
        "TQL EVAL (0, 300, '30s') sum by (dc) (rate(m[1m]))",
        "TQL EVAL (0, 300, '30s') max(m{host=~'h[01]'}) + 1",
        "TQL EVAL (60, 420, '1m') avg_over_time(m[2m])",
        "TQL EVAL (0, 300, '30s', '1m') m",
        "TQL EXPLAIN (0, 300, '30s') sum by (dc) (rate(m[1m]))",
        "TQL ANALYZE (0, 300, '30s') count(m)",
        "ADMIN flush_table('m')",
        "ADMIN flush_table('m')",
        "ADMIN compact_table('m')",
        "ADMIN flush_table('nope')",
        "SELECT host, count(greptime_value), sum(greptime_value) FROM m "
        "GROUP BY host ORDER BY host",
    ):
        pair.same(stmt)
    rid = pair.port.catalog.table("public", "m").info.region_id
    assert [rid] == pair.jax.catalog.table("public", "m").info.region_ids()
    pair.same(f"INSERT INTO m (ts, host, dc, greptime_value) VALUES "
              f"(45000, 'h1', 'dc1', 5.0)")
    for stmt in (f"ADMIN flush_region({rid})", f"ADMIN flush_region({rid})",
                 f"ADMIN compact_region({rid})", "ADMIN flush_region(1)",
                 "ADMIN flush_table(1)"):
        pair.same(stmt)
    pair.reopen()
    pair.same("TQL EVAL (0, 300, '30s') sum by (dc) (rate(m[1m]))")
    pair.same("SELECT * FROM m ORDER BY ts, host")


# each statement with the ROADMAP item that ports it; None: ported (the
# relational slice, then the introspection and session slice), and then
# it runs as on the JAX package
WAITING = [
    ("SELECT 1 UNION SELECT 2", None),
    ("CREATE VIEW v AS SELECT * FROM t", None),
    ("DROP VIEW v", None),
    ("SHOW VIEWS", None),
    ("EXPLAIN SELECT * FROM t", None),
    ("SET time_zone = 'UTC'", None),
    ("SHOW VARIABLES", None),
    ("SHOW PROCESSLIST", None),
    ("PREPARE s FROM 'SELECT 1'", None),
    ("EXECUTE s", None),
    ("ADMIN kill('1')", None),
    ("SHOW STATUS", None),
    ("SHOW COLLATION", None),
    ("SELECT * FROM information_schema.tables", None),
    ("SELECT a.ts FROM t a JOIN t b ON a.ts = b.ts", None),
    ("WITH c AS (SELECT * FROM t) SELECT * FROM c", None),
    ("SELECT a.ts FROM t a JOIN information_schema.tables b ON a.v = b.v",
     None),
    ("COPY t TO '/tmp/x.parquet'", "A2's tail"),
    ("CREATE TABLE p (ts TIMESTAMP TIME INDEX, h STRING, v DOUBLE, "
     "PRIMARY KEY (h)) PARTITION ON COLUMNS (h) (h < 'm', h >= 'm')", "A10"),
    ("CREATE TABLE r (ts TIMESTAMP TIME INDEX, v DOUBLE) "
     "WITH (num_regions = 2)", "A10"),
    ("CREATE EXTERNAL TABLE e (ts TIMESTAMP TIME INDEX, v DOUBLE) "
     "WITH (location = '/tmp/e.csv', format = 'csv')", "A2's tail"),
]
# ported statements that fail on the JAX package too: nothing was
# prepared, and the join's condition names no column of the system table
# (no equality condition is left); both packages must raise the same
# error, class and text
FAILS_ON_BOTH = {
    "EXECUTE s",
    "SELECT a.ts FROM t a JOIN information_schema.tables b ON a.v = b.v",
}
# the process list's Time column is a clock: every other column compared
CLOCK_COLUMNS = {"SHOW PROCESSLIST": "Time"}


def _error_of(inst, ctx, stmt):
    try:
        inst.execute_sql(stmt, ctx)
    except Exception as e:  # noqa: BLE001 - the class and text are compared
        return type(e).__name__, str(e)
    return None


def _without(res, name):
    keep = [i for i, n in enumerate(res.names) if n != name]
    return ([res.names[i] for i in keep],
            [[row[i] for i in keep] for row in res.rows()])


@pytest.mark.parametrize("stmt,item", WAITING, ids=[w[0][:24] for w in WAITING])
def test_waiting_statements_name_their_item(tmp_path, stmt, item):
    if item is None:
        p = Pair(tmp_path)
        try:
            for setup in ("CREATE TABLE t (ts TIMESTAMP TIME INDEX, v DOUBLE)",
                          "INSERT INTO t VALUES (1000, 1.5), (2000, 2.5)",
                          "CREATE VIEW v AS SELECT * FROM t"):
                if setup != stmt:
                    p.same(setup)
            if stmt in FAILS_ON_BOTH:
                got = _error_of(p.port, p.pctx, stmt)
                assert got is not None and "ROADMAP" not in got[1], got
                assert got == _error_of(p.jax, p.jctx, stmt)
            elif stmt in CLOCK_COLUMNS:
                got = p.port.sql(stmt, p.pctx)
                want = p.jax.sql(stmt, p.jctx)
                assert got.names == want.names
                assert (_without(got, CLOCK_COLUMNS[stmt])
                        == _without(want, CLOCK_COLUMNS[stmt]))
            else:
                assert p.same(stmt)[0] != "error"
        finally:
            p.close()
        return
    inst = Standalone(str(tmp_path), device="cpu", warm_start=False)
    try:
        inst.sql("CREATE TABLE t (ts TIMESTAMP TIME INDEX, v DOUBLE)")
        with pytest.raises(UnsupportedError, match=f"ROADMAP {item}"):
            inst.sql(stmt)
    finally:
        inst.close()


FLOW_STATEMENTS = [
    "CREATE FLOW f2 SINK TO s2 AS SELECT count(v) AS c FROM t",
    "SHOW FLOWS",
    "ADMIN flush_flow('f')",
]


@pytest.mark.parametrize("stmt", FLOW_STATEMENTS,
                         ids=[s[:24] for s in FLOW_STATEMENTS])
def test_flow_statements_run(pair, stmt):
    """Flow statements run on the port as on the JAX package (the flow
    engine's own cases are tests/test_torch_flow*.py)."""
    pair.same("CREATE TABLE t (ts TIMESTAMP TIME INDEX, v DOUBLE)")
    pair.same("CREATE FLOW f SINK TO s AS SELECT count(v) AS c FROM t")
    pair.same("INSERT INTO t VALUES (1000, 1.5), (2000, 2.5)")
    assert pair.same(stmt)[0] != "error"
    pair.port.flows.flush_all()
    pair.jax.flows.flush_all()
    pair.same("SHOW FLOWS")
    pair.same("SELECT c FROM s")


def test_instance_without_engine_refuses_ddl():
    from greptimedb_tpu_torch.instance import Instance

    inst = Instance(device="cpu")
    with pytest.raises(UnsupportedError, match="storage engine"):
        inst.sql("CREATE TABLE t (ts TIMESTAMP TIME INDEX, v DOUBLE)")
    assert inst.sql("SHOW DATABASES").rows() == [["public"]]


def test_warm_start_restores_snapshots_in_a_thread(tmp_path):
    """A reopened Standalone restores the grid snapshot on its warm
    thread; the first RANGE query then takes it."""
    root = str(tmp_path)
    inst = Standalone(root, device="cpu", prefer_device=True,
                      warm_start=False)
    inst.sql("CREATE TABLE c (ts TIMESTAMP TIME INDEX, h STRING, "
             "u DOUBLE, PRIMARY KEY (h))")
    inst.sql("INSERT INTO c VALUES " + ", ".join(
        f"({k * 10000}, 'h{k % 3}', {k}.5)" for k in range(60)))
    q = "SELECT ts, h, avg(u) RANGE '5m' FROM c ALIGN '5m' BY (h)"
    want = inst.sql(q).rows()
    entry = next(iter(inst.query_engine.range_cache._entries.values()))
    entry.persist_thread.join()
    inst.close()
    inst = Standalone(root, device="cpu", prefer_device=True)
    try:
        inst.warm_thread.join()
        assert inst.sql(q).rows() == want
        assert inst.query_engine.last_grid == "hit"
    finally:
        inst.close()
