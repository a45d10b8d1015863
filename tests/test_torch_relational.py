"""The relational layer (joins, CTEs, set operations, subqueries, views):
the port's Standalone against the JAX package's, on the CPU.

The same statements run through `greptimedb_tpu_torch.instance.Standalone(
tmp, device="cpu", x64=True)` and `greptimedb_tpu.instance.Standalone(tmp)`
over tables written from one numpy seed. Every answer must be equal bit
for bit: names, row order (many statements have no ORDER BY, so the
joins' and set operations' emission order is compared), dtypes, values
(floats by their bits) and validity; the JAX package promises that for
every case here, since its relational layer is numpy on the host and its
aggregates hold the GROUP BY contract (tests/test_torch_groupby.py), so
no case needs an ulp bound. A statement that fails must fail on both with
the same error class and message. The frames that reach GROUP BY are
taken below and above the grouped reduce's device threshold (262,144
rows), where the port runs kernel G's plain version as the JAX package
runs its fused program.
"""

import numpy as np
import pytest

from greptimedb_tpu.instance import Standalone as JaxStandalone
from greptimedb_tpu.query import relational as jrel
from greptimedb_tpu.session import QueryContext as JaxCtx
from greptimedb_tpu.sql import ast as JA
from greptimedb_tpu_torch.instance import Standalone
from greptimedb_tpu_torch.query import relational as trel
from greptimedb_tpu_torch.query import reduce as treduce
from greptimedb_tpu_torch.query import stats
from greptimedb_tpu_torch.session import QueryContext
from greptimedb_tpu_torch.sql import ast as TA

SEED = 18
BASE = 1_700_000_000_000
BIG_HOSTS, BIG_T = 2_000, 150          # 300,000 rows: above the threshold


def _lit(v, ok=True):
    if not ok:
        return "NULL"
    if isinstance(v, str):
        return f"'{v}'"
    if isinstance(v, float):
        return repr(v)
    return str(int(v))


def _small_tables(rng):
    """DDL and INSERTs of the small tables: m (metrics), tags (one row a
    host, some hosts missing and one extra), l and r (nullable keys of
    every type)."""
    hosts = [f"h{i}" for i in range(8)]
    stmts = [
        "CREATE TABLE m (ts TIMESTAMP TIME INDEX, host STRING, region "
        "STRING, u DOUBLE, n BIGINT, PRIMARY KEY (host, region))",
        "CREATE TABLE tags (ts TIMESTAMP TIME INDEX, host STRING, dc "
        "STRING, rack BIGINT, os STRING, w DOUBLE, PRIMARY KEY (host))",
        "CREATE TABLE l (ts TIMESTAMP TIME INDEX, id STRING, ki BIGINT, "
        "kf DOUBLE, ks STRING, v DOUBLE, PRIMARY KEY (id))",
        "CREATE TABLE r (ts TIMESTAMP TIME INDEX, id STRING, ki BIGINT, "
        "kf DOUBLE, ks STRING, w DOUBLE, PRIMARY KEY (id))",
    ]
    rows = []
    for h, host in enumerate(hosts):
        for k in range(12):
            u = float(rng.standard_normal() * 20 + 50)
            rows.append(
                f"({BASE + k * 10_000}, '{host}', 'r{h % 3}', "
                f"{_lit(u, rng.random() > 0.1)}, "
                f"{_lit(int(rng.integers(-50, 50)), rng.random() > 0.1)})")
    stmts.append("INSERT INTO m VALUES " + ", ".join(rows))
    rows = []
    for h, host in enumerate(hosts[2:] + ["h99"]):
        rows.append(
            f"(0, '{host}', 'dc{h % 3}', {_lit(h % 4, h != 3)}, "
            f"'{['linux', 'bsd'][h % 2]}', {float(rng.random())!r})")
    stmts.append("INSERT INTO tags VALUES " + ", ".join(rows))
    for name, n, keys in (("l", 40, "abcde"), ("r", 30, "abcd")):
        rows = []
        for i in range(n):
            ki = int(rng.integers(0, 6))
            kf = float(rng.choice([0.5, 1.0, 2.0, 3.0, 4.5, 5.0]))
            ks = str(rng.choice(list(keys)))
            rows.append(
                f"({int(rng.integers(0, 5)) * 1000}, '{name}{i}', "
                f"{_lit(ki, rng.random() > 0.15)}, "
                f"{_lit(kf, rng.random() > 0.15)}, "
                f"{_lit(ks, rng.random() > 0.15)}, "
                f"{_lit(float(rng.standard_normal()), rng.random() > 0.1)})")
        stmts.append(f"INSERT INTO {name} VALUES " + ", ".join(rows))
    return stmts


def _big_columns(rng):
    """big: BIG_HOSTS hosts x BIG_T seconds; bigtags: one row a host."""
    n = BIG_HOSTS * BIG_T
    hosts = np.asarray([f"host_{i:04d}" for i in range(BIG_HOSTS)], object)
    big = ({"host": np.repeat(hosts, BIG_T)},
           (np.tile(np.arange(BIG_T) * 1000, BIG_HOSTS) + BASE).astype(
               np.int64),
           {"u": rng.random(n) * 100, "v": rng.standard_normal(n)},
           {"u": rng.random(n) > 0.05})
    tags = ({"host": hosts}, np.zeros(BIG_HOSTS, np.int64),
            {"dc": np.asarray([f"dc{i % 7}" for i in range(BIG_HOSTS)],
                              object),
             "rack": np.arange(BIG_HOSTS, dtype=np.int64) % 40},
            None)
    return big, tags


BIG_DDL = [
    "CREATE TABLE big (ts TIMESTAMP TIME INDEX, host STRING PRIMARY KEY, "
    "u DOUBLE, v DOUBLE)",
    "CREATE TABLE bigtags (ts TIMESTAMP TIME INDEX, host STRING PRIMARY "
    "KEY, dc STRING, rack BIGINT)",
]


class Pair:
    """The two Standalones over their own data roots, with the same
    tables."""

    def __init__(self, tmp_path, big=False):
        self.roots = (str(tmp_path / "port"), str(tmp_path / "jax"))
        self.open()
        rng = np.random.default_rng(SEED)
        for stmt in _small_tables(rng):
            self.run_both(stmt)
        if big:
            for stmt in BIG_DDL:
                self.run_both(stmt)
            for name, (tags, ts, fields, valid) in zip(
                    ("big", "bigtags"), _big_columns(rng)):
                for inst in (self.port, self.jax):
                    inst.catalog.table("public", name).write(
                        tags, ts, fields, field_valid=valid)

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

    def run_both(self, stmt):
        got = _run(self.port, self.pctx, stmt)
        want = _run(self.jax, self.jctx, stmt)
        return got, want

    def same(self, stmt):
        got, want = self.run_both(stmt)
        assert got == want, f"{stmt!r}:\nport {got}\njax  {want}"
        return got


def _col_key(c):
    """A column as comparable data: dtype, validity, and the valid values
    (floats by their bits, NaN payloads included)."""
    v = np.asarray(c.values)
    m = np.asarray(c.valid_mask, bool)
    if v.dtype.kind == "f":
        vals = v.view(f"u{v.dtype.itemsize}")[m].tolist()
    elif v.dtype == object:
        vals = [(type(x).__name__, x) for x in v[m].tolist()]
    else:
        vals = v[m].tolist()
    return (str(v.dtype), m.tolist(), vals)


def _run(inst, ctx, stmt):
    try:
        out = inst.execute_sql(stmt, ctx)[-1]
    except Exception as e:  # noqa: BLE001 - class and text are compared
        return ("error", type(e).__name__, str(e))
    if out.result is None:
        return ("rows", out.affected_rows)
    res = out.result
    return ("result", list(res.names), [_col_key(c) for c in res.cols])


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    p = Pair(tmp_path_factory.mktemp("rel"))
    yield p
    p.close()


@pytest.fixture(scope="module")
def big_pair(tmp_path_factory):
    p = Pair(tmp_path_factory.mktemp("relbig"), big=True)
    yield p
    p.close()


JOINS = [
    # inner joins over a tag key, with and without qualifiers and aliases
    "SELECT m.host, m.ts, m.u, t.dc FROM m JOIN tags t ON m.host = t.host",
    "SELECT * FROM m INNER JOIN tags ON m.host = tags.host "
    "ORDER BY m.host, m.ts",
    "SELECT a.host, b.dc FROM tags b JOIN m a ON a.host = b.host "
    "WHERE a.u > 50 AND b.os = 'linux'",
    # outer joins: NULL-padded sides, WHERE never pushed into them
    "SELECT m.host, m.ts, t.dc, t.rack FROM m LEFT JOIN tags t "
    "ON m.host = t.host",
    "SELECT m.host, t.host, t.dc FROM m RIGHT JOIN tags t "
    "ON m.host = t.host WHERE t.dc = 'dc1'",
    "SELECT m.host, t.host, m.u, t.w FROM m FULL JOIN tags t "
    "ON m.host = t.host AND m.ts = t.ts",
    "SELECT m.host, t.dc FROM m LEFT JOIN tags t ON m.host = t.host "
    "WHERE t.dc IS NULL",
    # USING: one key column, coalesced on outer joins
    "SELECT * FROM l JOIN r USING (ks)",
    "SELECT ks, l.v, r.w FROM l FULL JOIN r USING (ks)",
    "SELECT host, dc, u FROM m LEFT JOIN tags USING (host) "
    "ORDER BY host, m.ts",
    # cross join
    "SELECT l.id, r.id FROM l CROSS JOIN r WHERE l.ki = 1 AND r.ki = 2",
    # NULL keys (never match), int, float, string, timestamp keys,
    # int against float, two columns
    "SELECT l.id, r.id, l.ki FROM l JOIN r ON l.ki = r.ki",
    "SELECT l.id, r.id FROM l LEFT JOIN r ON l.kf = r.kf",
    "SELECT l.id, r.id, l.ks FROM l JOIN r ON l.ks = r.ks",
    "SELECT l.id, r.id, l.ts FROM l JOIN r ON l.ts = r.ts",
    "SELECT l.id, r.id, l.ki, r.kf FROM l JOIN r ON l.ki = r.kf",
    "SELECT l.id, r.id FROM l RIGHT JOIN r ON l.ki = r.ki "
    "AND l.ks = r.ks",
    # residual ON conditions
    "SELECT l.id, r.id FROM l JOIN r ON l.ki = r.ki AND l.v > r.w",
    "SELECT l.id, r.id, l.v FROM l LEFT JOIN r ON r.ks = l.ks "
    "AND l.ts < r.ts",
    # three-way join, GROUP BY over the frame, expressions of both sides
    "SELECT t.dc, count(*), sum(m.u), avg(m.n), min(l.v) FROM m "
    "JOIN tags t ON m.host = t.host JOIN l ON l.ki = t.rack "
    "GROUP BY t.dc ORDER BY t.dc",
    "SELECT t.os, m.region, count(m.u), max(m.u + t.w) FROM m "
    "JOIN tags t ON m.host = t.host GROUP BY t.os, m.region",
    "SELECT DISTINCT t.dc FROM m JOIN tags t ON m.host = t.host",
    "SELECT m.host, m.u * t.w AS x FROM m JOIN tags t ON m.host = t.host "
    "ORDER BY x DESC LIMIT 5 OFFSET 2",
    # a subquery in FROM
    "SELECT s.host, s.c FROM (SELECT host, count(*) AS c FROM m "
    "GROUP BY host) s JOIN tags t ON s.host = t.host WHERE s.c > 3",
]

SETOPS = [
    "SELECT host FROM m UNION SELECT host FROM tags",
    "SELECT host FROM m UNION ALL SELECT host FROM tags",
    "SELECT ki FROM l INTERSECT SELECT ki FROM r",
    "SELECT ki, ks FROM l INTERSECT ALL SELECT ki, ks FROM r",
    "SELECT ks FROM l EXCEPT SELECT ks FROM r",
    "SELECT ki FROM l EXCEPT ALL SELECT ki FROM r",
    # coercion: int with float, int with string
    "SELECT ki FROM l UNION SELECT kf FROM r",
    "SELECT ki FROM l UNION ALL SELECT ks FROM r",
    "SELECT kf FROM l INTERSECT SELECT ki FROM r",
    "SELECT 1 AS a, 'x' AS b UNION ALL SELECT 2.5, 'y' ORDER BY a DESC",
    "SELECT host FROM m EXCEPT SELECT host FROM tags ORDER BY host "
    "LIMIT 2",
    "SELECT ki FROM l UNION SELECT ki FROM r EXCEPT SELECT rack "
    "FROM tags",
    "SELECT ki FROM l UNION SELECT ki, ks FROM r",
]

CTES = [
    "WITH c AS (SELECT host, avg(u) AS a FROM m GROUP BY host) "
    "SELECT * FROM c WHERE a > 40 ORDER BY host",
    # nested: a CTE reads an earlier one
    "WITH a AS (SELECT * FROM l WHERE ki > 1), b AS (SELECT id, ki FROM a "
    "WHERE v > 0) SELECT b.id, r.id FROM b JOIN r ON b.ki = r.ki",
    # shadowing: the CTE named like a table hides it
    "WITH tags AS (SELECT host, 'x' AS dc FROM m WHERE n > 0) "
    "SELECT tags.host, min(tags.dc), count(*) FROM tags "
    "GROUP BY tags.host ORDER BY tags.host",
    "WITH r AS (SELECT id, ki FROM l) SELECT count(*) FROM r",
    # a CTE inside a subquery, and a set operation over CTEs
    "SELECT id FROM l WHERE ki IN (WITH x AS (SELECT ki FROM r "
    "WHERE w > 0) SELECT ki FROM x)",
    "WITH x AS (SELECT ks FROM l), y AS (SELECT ks FROM r) "
    "SELECT ks FROM x UNION SELECT ks FROM y",
    # a RANGE query inside a CTE runs on its single table
    "WITH h AS (SELECT ts, host, avg(u) RANGE '20s' AS a FROM m "
    "ALIGN '20s' BY (host)) SELECT t.dc, h.ts, max(h.a) FROM h "
    "JOIN tags t ON h.host = t.host GROUP BY t.dc, h.ts "
    "ORDER BY t.dc, h.ts",
]

SUBQUERIES = [
    # uncorrelated scalar, IN, NOT IN (with NULLs inside), EXISTS
    "SELECT host, u FROM m WHERE u > (SELECT avg(u) FROM m) "
    "ORDER BY host, ts",
    "SELECT (SELECT max(w) FROM r) AS mx, count(*) FROM l",
    "SELECT id FROM l WHERE ki IN (SELECT ki FROM r)",
    "SELECT id FROM l WHERE ki NOT IN (SELECT ki FROM r WHERE w > 0)",
    "SELECT id, ks FROM l WHERE ks NOT IN (SELECT ks FROM r)",
    "SELECT count(*) FROM l WHERE EXISTS (SELECT 1 FROM r WHERE w > 5)",
    "SELECT count(*) FROM l WHERE NOT EXISTS (SELECT 1 FROM r "
    "WHERE w > 0)",
    "SELECT host, count(*) FROM m WHERE host IN (SELECT host FROM m "
    "GROUP BY host HAVING avg(u) > 48) GROUP BY host ORDER BY host",
    "SELECT id FROM l WHERE ki = (SELECT min(ki) FROM r)",
    "SELECT id FROM l WHERE ki = (SELECT ki FROM r WHERE id = 'none')",
    "SELECT id FROM l WHERE ki = (SELECT ki FROM r)",
    # correlated: EXISTS, NOT EXISTS, IN, scalar (aggregate and not)
    "SELECT l.id FROM l WHERE EXISTS (SELECT 1 FROM r "
    "WHERE r.ki = l.ki AND r.w > 0)",
    "SELECT l.id FROM l WHERE NOT EXISTS (SELECT 1 FROM r "
    "WHERE r.ks = l.ks)",
    "SELECT l.id FROM l WHERE l.kf IN (SELECT r.kf FROM r "
    "WHERE r.ks = l.ks)",
    "SELECT l.id FROM l WHERE l.kf NOT IN (SELECT r.kf FROM r "
    "WHERE r.ks = l.ks)",
    "SELECT l.id, (SELECT count(*) FROM r WHERE r.ki = l.ki) AS c FROM l",
    "SELECT l.id, (SELECT sum(r.w) FROM r WHERE r.ki = l.ki "
    "AND r.ks = l.ks) AS s FROM l",
    "SELECT c.host, c.ts, c.u FROM m c WHERE c.u > (SELECT avg(d.u) + 5 "
    "FROM m d WHERE d.host = c.host) ORDER BY c.host, c.ts",
    "SELECT t.host, (SELECT max(m.u) FROM m WHERE m.host = t.host) AS mx "
    "FROM tags t ORDER BY t.host",
    "SELECT t.host, (SELECT m.region FROM m WHERE m.host = t.host "
    "AND m.ts = 1700000000000) AS reg FROM tags t",
    "SELECT t.dc, count(*) FROM tags t WHERE EXISTS (SELECT 1 FROM m "
    "WHERE m.host = t.host) GROUP BY t.dc ORDER BY t.dc",
]

# the JAX package's restrictions: same class, same text
RESTRICTIONS = [
    # RANGE inside a join
    "SELECT ts, m.host, avg(u) RANGE '20s' FROM m JOIN tags t "
    "ON m.host = t.host ALIGN '20s' BY (m.host)",
    # correlated placeholders in HAVING
    "SELECT host, count(*) AS c FROM m GROUP BY host HAVING count(*) > "
    "(SELECT count(*) FROM tags t WHERE t.host = m.host)",
    # ambiguous columns
    "SELECT host FROM m JOIN tags ON m.host = tags.host",
    "SELECT ts FROM l JOIN r ON l.ki = r.ki",
    # joins without an equality
    "SELECT l.id FROM l JOIN r ON l.ki < r.ki",
    # decorrelation's refusals
    "SELECT id FROM l WHERE EXISTS (SELECT 1 FROM r WHERE r.ki < l.ki)",
    "SELECT id FROM l WHERE ki IN (SELECT ki FROM r WHERE r.ks = l.ks "
    "GROUP BY ki)",
    "SELECT id FROM l WHERE EXISTS (SELECT r.ki + l.ki FROM r "
    "WHERE r.ks = l.ks)",
    "SELECT id FROM l WHERE EXISTS (SELECT 1 FROM r "
    "WHERE r.ks = l.ks || r.ks)",
    "SELECT l.id, (SELECT r.w FROM r WHERE r.ki = l.ki) FROM l",
    # scalar subqueries of the wrong shape
    "SELECT (SELECT ki, ks FROM r)",
    "SELECT id FROM l WHERE ki IN (SELECT ki, ks FROM r)",
    # unknown columns and tables
    "SELECT l.nope FROM l JOIN r ON l.ki = r.ki",
    "SELECT * FROM l JOIN nope ON l.ki = nope.ki",
]


@pytest.mark.parametrize("stmt", JOINS, ids=[s[:40] for s in JOINS])
def test_joins(pair, stmt):
    assert pair.same(stmt)[0] == "result"


@pytest.mark.parametrize("stmt", SETOPS, ids=[s[:40] for s in SETOPS])
def test_set_operations(pair, stmt):
    pair.same(stmt)


@pytest.mark.parametrize("stmt", CTES, ids=[s[:40] for s in CTES])
def test_ctes(pair, stmt):
    assert pair.same(stmt)[0] == "result"


@pytest.mark.parametrize("stmt", SUBQUERIES,
                         ids=[s[:40] for s in SUBQUERIES])
def test_subqueries(pair, stmt):
    pair.same(stmt)


@pytest.mark.parametrize("stmt", RESTRICTIONS,
                         ids=[s[:40] for s in RESTRICTIONS])
def test_restrictions_raise_the_jax_errors(pair, stmt):
    got = pair.same(stmt)
    assert got[0] == "error" and "ROADMAP" not in got[2], got


def test_cross_join_guard(big_pair):
    got = big_pair.same("SELECT count(*) FROM big CROSS JOIN bigtags "
                        "WHERE bigtags.rack < 30")
    assert got[:2] == ("error", "ExecutionError"), got


def test_information_schema_join_names_its_item(pair):
    """A join over information_schema runs as on the JAX package (it
    named ROADMAP A4 before the introspection slice ported it)."""
    got = pair.same("SELECT t.table_name, t.table_id, m.host FROM "
                    "information_schema.tables t JOIN m ON t.table_name = "
                    "m.host ORDER BY m.host")
    assert got[0] == "result", got
    got = pair.same("SELECT c.table_name, c.column_name, t.engine FROM "
                    "information_schema.columns c JOIN "
                    "information_schema.tables t ON c.table_name = "
                    "t.table_name WHERE t.table_schema = 'public' "
                    "ORDER BY c.table_name, c.column_name")
    assert got[0] == "result" and got[2][0][2], got


def test_scan_dtypes_reach_the_join_as_in_jax(pair):
    """The frames a join reads: tags as object strings, timestamps int64,
    fields float64/int64, as the JAX package's scans hand them over."""
    for name in ("m", "tags", "l", "r"):
        got = trel._frame_for_table(pair.port, TA.TableName(name),
                                    pair.pctx, {}, [])[0]
        want = jrel._frame_for_table(pair.jax, JA.TableName(name),
                                     pair.jctx, {}, [])[0]
        assert got.names == want.names and got.quals == want.quals
        assert [c.values.dtype for c in got.cols] == [
            c.values.dtype for c in want.cols], name
        assert [_col_key(c) for c in got.cols] == [
            _col_key(c) for c in want.cols], name


def test_join_stats_are_collected(pair):
    stmt = "SELECT m.host, t.dc FROM m JOIN tags t ON m.host = t.host"
    with stats.collect() as s:
        res = pair.port.sql(stmt, pair.pctx)
    assert s.counters["join_rows"] == res.num_rows > 0
    assert s.counters["join_ms"] >= 0.0
    # no collector: nothing recorded, nothing raised
    assert stats.active() is None
    pair.port.sql(stmt, pair.pctx)


BIG_GROUPBY = [
    # 300,000 joined rows: kernel G's plain version on the port, the
    # fused program on the JAX package
    ("SELECT t.dc, count(*), sum(b.u), avg(b.u), min(b.v), max(b.v) "
     "FROM big b JOIN bigtags t ON b.host = t.host GROUP BY t.dc "
     "ORDER BY t.dc", "device"),
    ("SELECT t.rack, count(b.u), max(b.u), stddev(b.v) FROM big b "
     "JOIN bigtags t USING (host) GROUP BY t.rack", "device"),
    # 100,000 joined rows: the host reduce on both
    (f"SELECT t.dc, count(*), sum(b.u), avg(b.u), min(b.v), max(b.v) "
     f"FROM big b JOIN bigtags t ON b.host = t.host "
     f"WHERE b.ts < {BASE + 50_000} GROUP BY t.dc ORDER BY t.dc", "host"),
    (f"SELECT t.rack, count(b.u), max(b.u), stddev(b.v) FROM big b "
     f"JOIN bigtags t USING (host) WHERE b.ts < {BASE + 50_000} "
     f"GROUP BY t.rack", "host"),
]


@pytest.mark.parametrize("stmt,path", BIG_GROUPBY,
                         ids=[f"{p}-{i}" for i, (_, p) in
                              enumerate(BIG_GROUPBY)])
def test_joined_frame_groupby_below_and_above_the_threshold(
        big_pair, stmt, path):
    got = big_pair.same(stmt)
    assert got[0] == "result"
    assert big_pair.port.query_engine.last_exec_path == path
    n = 300_000 if path == "device" else 100_000
    assert (n >= treduce.DEVICE_THRESHOLD) == (path == "device")


def test_views(tmp_path):
    p = Pair(tmp_path)
    try:
        for stmt in (
            "CREATE VIEW hot AS SELECT host, avg(u) AS a FROM m "
            "GROUP BY host",
            "CREATE VIEW hot AS SELECT 1",
            "CREATE VIEW m AS SELECT 1",
            "CREATE TABLE hot (ts TIMESTAMP TIME INDEX, v DOUBLE)",
            "SELECT * FROM hot ORDER BY host",
            "SELECT h.host, h.a, t.dc FROM hot h JOIN tags t "
            "ON h.host = t.host ORDER BY h.host",
            "CREATE VIEW joined AS SELECT m.host, t.dc, m.u FROM m "
            "JOIN tags t ON m.host = t.host",
            "SELECT dc, count(*), max(u) FROM joined GROUP BY dc "
            "ORDER BY dc",
            "CREATE VIEW sets AS SELECT ki FROM l UNION SELECT ki FROM r",
            "SELECT * FROM sets",
            "SHOW VIEWS",
            "SHOW CREATE VIEW hot",
            "SHOW CREATE VIEW nope",
            "CREATE OR REPLACE VIEW hot AS SELECT host, max(u) AS a FROM m "
            "GROUP BY host",
            "SELECT * FROM hot ORDER BY a",
            "SELECT host FROM m WHERE host IN (SELECT host FROM hot "
            "WHERE a > 60)",
            "DROP VIEW sets",
            "DROP VIEW sets",
            "DROP VIEW IF EXISTS sets",
            "SHOW VIEWS",
        ):
            p.same(stmt)
        p.reopen()
        for stmt in ("SHOW VIEWS", "SHOW CREATE VIEW joined",
                     "SELECT * FROM hot ORDER BY host",
                     "SELECT dc, count(*) FROM joined GROUP BY dc "
                     "ORDER BY dc",
                     "CREATE DATABASE d2",
                     "CREATE VIEW d2.v AS SELECT 1 AS x",
                     "SELECT * FROM d2.v",
                     "DROP DATABASE d2",
                     "SELECT * FROM d2.v"):
            p.same(stmt)
    finally:
        p.close()
