"""EXPLAIN and EXPLAIN ANALYZE, information_schema and pg_catalog, and the
session statements: the port's Standalone against the JAX package's, on
the CPU.

The same statements run through `greptimedb_tpu_torch.instance.Standalone(
tmp, device="cpu", x64=True)` and `greptimedb_tpu.instance.Standalone(tmp)`
over tables written with the same rows, made with numpy from a seed.
Answers are compared exactly (names, dtypes, validity, values by their
bits); a statement that fails must fail on both with the same error class
and text.

EXPLAIN ANALYZE is compared in parts: the plan lines and the row count
exactly; every count and note key of the collector, whole, with equal
values, except the time keys (`*_ms`), the device program ids
(`device_program_<site>`: a hash of the program's key, which each
package spells its own way) and the roofline notes (achieved rates), of
which only the presence and form are compared; and the `Trace:` block's
span names.
"""

import re
import threading

import numpy as np
import pytest

from greptimedb_tpu.instance import Standalone as JaxStandalone
from greptimedb_tpu.instance import (
    count_placeholders as jax_count_placeholders,
)
from greptimedb_tpu.instance import (
    substitute_placeholders as jax_substitute,
)
from greptimedb_tpu.query import window_fns as JW
from greptimedb_tpu.session import QueryContext as JaxCtx
from greptimedb_tpu_torch import cancellation
from greptimedb_tpu_torch import information_schema as IS
from greptimedb_tpu_torch.errors import ExecutionError, UnsupportedError
from greptimedb_tpu_torch.instance import (
    Standalone,
    count_placeholders,
    substitute_placeholders,
)
from greptimedb_tpu_torch.query import stats
from greptimedb_tpu_torch.query import window_fns as TW
from greptimedb_tpu_torch.session import QueryContext

SEED = 19
HOSTS = 8
STEPS = 180             # 30 min at 10 s
STEP_MS = 10_000

# notes whose values are the package's own (a program id hashes the
# program's key; a roofline carries achieved rates): compared by form
PROGRAM_PREFIX = "device_program_"
ROOFLINE_PREFIX = "roofline_"


def _cpu_columns(rng):
    hosts = np.array([f"host_{i}" for i in range(HOSTS)], object)
    regions = np.array([f"r{i % 3}" for i in range(HOSTS)], object)
    h = np.repeat(np.arange(HOSTS), STEPS)
    ts = np.tile(np.arange(STEPS, dtype=np.int64) * STEP_MS, HOSTS)
    user = np.round(rng.uniform(0, 100, len(h)), 3)
    system = rng.uniform(0, 10, len(h))
    valid = rng.random(len(h)) > 0.1
    return ({"hostname": hosts[h], "region": regions[h]}, ts,
            {"usage_user": user, "usage_system": system},
            {"usage_system": valid})


SETUP = [
    "CREATE TABLE cpu (ts TIMESTAMP TIME INDEX, hostname STRING, "
    "region STRING, usage_user DOUBLE, usage_system DOUBLE, "
    "PRIMARY KEY (hostname, region))",
    "CREATE TABLE flushed (ts TIMESTAMP TIME INDEX, hostname STRING, "
    "region STRING, usage_user DOUBLE, usage_system DOUBLE, "
    "PRIMARY KEY (hostname, region))",
    "CREATE TABLE tags (ts TIMESTAMP TIME INDEX, hostname STRING PRIMARY "
    "KEY, dc STRING, os STRING)",
    "INSERT INTO tags VALUES " + ", ".join(
        f"(0, 'host_{i}', 'dc{i % 2}', 'os{i % 3}')" for i in range(HOSTS)),
    "CREATE VIEW hot AS SELECT hostname, avg(usage_user) AS u FROM cpu "
    "GROUP BY hostname",
    "CREATE DATABASE other",
    "CREATE TABLE other.t (ts TIMESTAMP TIME INDEX, v DOUBLE)",
]


def _col_key(c):
    """A column as comparable data: dtype, validity, and the valid values
    (floats by their bits)."""
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


class Pair:
    """The two Standalones over their own data roots, with the same
    tables and rows."""

    def __init__(self, root, prefer_device=None):
        self.port = Standalone(str(root / "port"), device="cpu", x64=True,
                               warm_start=False, prefer_device=prefer_device)
        self.jax = JaxStandalone(str(root / "jax"), warm_start=False,
                                 prefer_device=prefer_device)
        self.pctx, self.jctx = QueryContext(), JaxCtx()
        for stmt in SETUP:
            self.same(stmt)
        tags, ts, fields, valid = _cpu_columns(np.random.default_rng(SEED))
        for name in ("cpu", "flushed"):
            for inst in (self.port, self.jax):
                inst.catalog.table("public", name).write(
                    tags, ts, fields, field_valid=valid)
        self.same("ADMIN flush_table('flushed')")

    def close(self):
        self.port.close()
        self.jax.close()

    def both(self, stmt):
        return (_run(self.port, self.pctx, stmt),
                _run(self.jax, self.jctx, stmt))

    def same(self, stmt):
        got, want = self.both(stmt)
        assert got == want, f"{stmt!r}:\nport {got}\njax  {want}"
        return got

    def results(self, stmt):
        return (self.port.sql(stmt, self.pctx), self.jax.sql(stmt, self.jctx))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    p = Pair(tmp_path_factory.mktemp("session"))
    yield p
    p.close()


@pytest.fixture(scope="module")
def device_pair(tmp_path_factory):
    """prefer_device=True: the grid, G's path and (past a lowered
    threshold) the window scans, as the plain versions on the CPU."""
    p = Pair(tmp_path_factory.mktemp("session_dev"), prefer_device=True)
    yield p
    p.close()


@pytest.fixture
def fresh(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.close()


# ----------------------------------------------------------------------
# EXPLAIN
# ----------------------------------------------------------------------

EXPLAIN_QUERIES = [
    "SELECT * FROM cpu",
    "SELECT hostname, usage_user FROM cpu WHERE ts >= 60000 AND ts < "
    "600000 AND usage_user > 50 ORDER BY usage_user DESC LIMIT 7 OFFSET 2",
    "SELECT ts, usage_user FROM cpu WHERE hostname = 'host_3' AND region "
    "!= 'r9' ORDER BY ts",
    "SELECT hostname, max(usage_user), count(*) FROM cpu GROUP BY hostname "
    "ORDER BY hostname",
    "SELECT region, avg(usage_user) + 1, sum(usage_system) FROM cpu WHERE "
    "usage_user > 10 GROUP BY region HAVING count(*) > 3 ORDER BY region "
    "DESC LIMIT 2",
    "SELECT count(*) FROM cpu",
    "SELECT ts, hostname, avg(usage_user) RANGE '1m' FROM cpu ALIGN '1m' "
    "BY (hostname)",
    "SELECT ts, region, max(usage_user) RANGE '5m', min(usage_system) "
    "RANGE '1m' FROM cpu WHERE hostname IN ('host_1', 'host_2') ALIGN '1m' "
    "TO '1970-01-01 00:00:30' BY (region) ORDER BY region, ts",
    "SELECT hostname, ts, sum(usage_user) OVER (PARTITION BY hostname "
    "ORDER BY ts) FROM cpu ORDER BY hostname, ts LIMIT 5",
    "SELECT c.hostname, t.dc FROM cpu c JOIN tags t ON c.hostname = "
    "t.hostname WHERE c.ts < 20000",
    "WITH h AS (SELECT hostname FROM cpu) SELECT count(*) FROM h",
    "SELECT x.hostname FROM (SELECT hostname FROM cpu) x",
    "SELECT hostname FROM cpu UNION SELECT hostname FROM tags",
    "SELECT 1 + 2",
]


@pytest.mark.parametrize("q", EXPLAIN_QUERIES,
                         ids=[q[:40] for q in EXPLAIN_QUERIES])
def test_explain_lines(pair, q):
    got = pair.same(f"EXPLAIN {q}")
    assert got[0] == "result" and got[1] == ["plan"], got


@pytest.mark.parametrize("stmt", [
    "EXPLAIN INSERT INTO tags VALUES (0, 'x', 'y', 'z')",
    "EXPLAIN SELECT * FROM nope",
    "EXPLAIN ANALYZE SELECT * FROM nope",
    # a view and a system table plan as a table name, as on the JAX
    # package
    "EXPLAIN SELECT h.hostname, h.u FROM hot h",
    "EXPLAIN ANALYZE SELECT count(*), max(u) FROM hot",
    "EXPLAIN ANALYZE SELECT table_name, count(*) FROM "
    "information_schema.columns GROUP BY table_name",
])
def test_explain_errors(pair, stmt):
    got = pair.same(stmt)
    assert got[0] == "error", got


def _analyze(res):
    """(plan lines, row count, {key: value}, span names of the Trace
    block) of an EXPLAIN ANALYZE."""
    lines = [str(v) for v in res.cols[0].values]
    i = next(k for k, ln in enumerate(lines) if ln.startswith("  Metrics:"))
    m = re.fullmatch(r"  Metrics: rows=(\d+) elapsed=([0-9.]+)ms", lines[i])
    assert m, lines[i]
    notes = {}
    spans = None
    for ln in lines[i + 1:]:
        if ln.startswith("  Trace:"):
            spans = []
            continue
        if spans is not None:
            # "    <indent><name> <ms>ms {attrs}"
            spans.append(ln.strip().split(" ", 1)[0])
            continue
        key, value = ln.strip().split(": ", 1)
        notes[key] = value
    return lines[:i], int(m.group(1)), notes, spans


def _same_analyze(pair, q, ctxs=None):
    """EXPLAIN ANALYZE of `q` on both packages, compared in parts; returns
    the port's notes."""
    pctx, jctx = ctxs or (pair.pctx, pair.jctx)
    got = pair.port.sql(f"EXPLAIN ANALYZE {q}", pctx)
    want = pair.jax.sql(f"EXPLAIN ANALYZE {q}", jctx)
    plan, rows, notes, spans = _analyze(got)
    jplan, jrows, jnotes, jspans = _analyze(want)
    assert plan == jplan
    assert rows == jrows == pair.port.sql(q, pctx).num_rows
    assert set(notes) == set(jnotes), (sorted(notes), sorted(jnotes))
    for k, v in notes.items():
        if k.endswith("_ms"):
            float(v)            # a time: only its presence is compared
        elif k.startswith(PROGRAM_PREFIX):
            assert re.fullmatch(r"[0-9a-f]{12}", v), (k, v)
        elif k.startswith(ROOFLINE_PREFIX):
            assert v.split(" ", 1)[0] == jnotes[k].split(" ", 1)[0], (
                k, v, jnotes[k])
        else:
            assert v == jnotes[k], (k, v, jnotes[k])
    assert spans is not None and sorted(spans) == sorted(jspans), (
        spans, jspans)
    return notes


ANALYZE_QUERIES = {
    "plain": "SELECT * FROM cpu ORDER BY hostname, ts LIMIT 5",
    "plain_residual": "SELECT hostname, usage_user FROM cpu WHERE "
                      "usage_user > 50 ORDER BY usage_user LIMIT 3",
    "plain_matchers": "SELECT ts, usage_user FROM cpu WHERE hostname IN "
                      "('host_1', 'host_5') AND ts < 100000 ORDER BY ts",
    "aggregate": "SELECT hostname, max(usage_user), count(usage_system) "
                 "FROM cpu GROUP BY hostname ORDER BY hostname",
    "aggregate_matcher": "SELECT region, avg(usage_user) FROM cpu WHERE "
                         "region = 'r1' GROUP BY region",
    "range": "SELECT ts, hostname, avg(usage_user) RANGE '1m' FROM cpu "
             "ALIGN '1m' BY (hostname) ORDER BY hostname, ts",
    "window": "SELECT hostname, ts, sum(usage_user) OVER (PARTITION BY "
              "hostname ORDER BY ts) FROM cpu ORDER BY hostname, ts LIMIT 4",
    "join": "SELECT t.dc, count(*), max(c.usage_user) FROM cpu c JOIN tags "
            "t ON c.hostname = t.hostname GROUP BY t.dc ORDER BY t.dc",
    "setop": "SELECT hostname FROM cpu WHERE usage_user > 99 UNION "
             "SELECT hostname FROM tags WHERE os = 'os1'",
    "flushed_aggregate": "SELECT hostname, sum(usage_user) FROM flushed "
                         "GROUP BY hostname ORDER BY hostname",
    "flushed_twice": "SELECT region, min(usage_system) FROM flushed WHERE "
                     "hostname = 'host_2' GROUP BY region",
}


@pytest.mark.parametrize("name", list(ANALYZE_QUERIES))
def test_explain_analyze(pair, name):
    notes = _same_analyze(pair, ANALYZE_QUERIES[name])
    if name.startswith("flushed"):
        assert "row_groups_read" in notes and "page_cache_miss_cols" in notes
    if name == "join":
        assert int(notes["join_rows"]) == HOSTS * STEPS


@pytest.mark.parametrize("name", ["aggregate", "range", "range_again",
                                  "range_matcher", "window"])
def test_explain_analyze_device_paths(device_pair, name, monkeypatch):
    """prefer_device=True: GROUP BY through G's path, RANGE on the grid
    (built, then a hit), the window scans past a lowered threshold."""
    monkeypatch.setattr(JW, "DEVICE_THRESHOLD", 100)
    monkeypatch.setattr(TW, "DEVICE_THRESHOLD", 100)
    q = {
        "aggregate": ANALYZE_QUERIES["aggregate"],
        "range": ANALYZE_QUERIES["range"],
        "range_again": ANALYZE_QUERIES["range"],
        "range_matcher": "SELECT ts, hostname, max(usage_user) RANGE '1m' "
                         "FROM cpu WHERE hostname = 'host_4' ALIGN '1m' BY "
                         "(hostname) ORDER BY ts",
        "window": ANALYZE_QUERIES["window"],
    }[name]
    notes = _same_analyze(device_pair, q)
    kind = {"aggregate": "aggregate", "window": "window"}.get(name, "range")
    assert notes[f"exec_path_{kind}"] == "device"
    if kind == "range":
        assert notes["grid_cache"] in ("hit", "miss(build)")


def test_explain_analyze_leaves_no_collector(pair):
    pair.port.sql(f"EXPLAIN ANALYZE {ANALYZE_QUERIES['aggregate']}")
    assert stats.active() is None


# ----------------------------------------------------------------------
# information_schema and pg_catalog
# ----------------------------------------------------------------------

# columns that hold a clock or the process's start, and SST bytes (the
# port writes its own SST format)
UNCOMPARED = {
    "cluster_info": {"start_time_ms", "uptime_s", "active_time"},
    "region_statistics": {"sst_size"},
}
SYSTEM_TABLES = [("information_schema", n) for n in sorted(IS._PROVIDERS)] \
    + [("pg_catalog", n) for n in sorted(IS._PG_PROVIDERS)]


# the telemetry's tables read process-wide registries that each package
# fills from its own history: their columns are compared here, their
# rows by tests/test_torch_telemetry.py over one statement sequence
TELEMETRY_TABLES = {"runtime_metrics", "slow_queries", "traces",
                    "memory_pools", "statement_statistics",
                    "device_programs"}


@pytest.mark.parametrize("db,name", SYSTEM_TABLES,
                         ids=[f"{d}.{n}" for d, n in SYSTEM_TABLES])
def test_system_table(pair, db, name):
    got, want = pair.results(f"SELECT * FROM {db}.{name}")
    assert got.names == want.names
    if name in TELEMETRY_TABLES:
        return
    skip = UNCOMPARED.get(name, set())
    for n, a, b in zip(got.names, got.cols, want.cols):
        if n in skip:
            assert np.asarray(a.values).dtype == np.asarray(b.values).dtype
            continue
        assert _col_key(a) == _col_key(b), (name, n)
    assert got.num_rows == want.num_rows


@pytest.mark.parametrize("q", [
    "SELECT table_name, table_type, engine, region_count FROM "
    "information_schema.tables WHERE table_schema = 'public' ORDER BY "
    "table_name",
    "SELECT column_name, data_type, semantic_type, is_nullable FROM "
    "information_schema.columns WHERE table_name = 'cpu' ORDER BY "
    "column_name",
    "SELECT constraint_name, column_name, ordinal_position FROM "
    "information_schema.key_column_usage WHERE table_name IN ('cpu', "
    "'tags') ORDER BY table_name, constraint_name, ordinal_position",
    "SELECT t.table_name, c.column_name FROM information_schema.tables t "
    "JOIN information_schema.columns c ON c.table_name = t.table_name "
    "WHERE t.table_schema = 'public' ORDER BY t.table_name, c.column_name",
    "SELECT c.relname FROM pg_catalog.pg_class c JOIN "
    "pg_catalog.pg_namespace n ON n.oid = c.relnamespace WHERE n.nspname = "
    "'public' AND c.relkind = 'r' ORDER BY c.relname",
    "SELECT table_schema, count(*) FROM information_schema.tables GROUP BY "
    "table_schema ORDER BY table_schema",
    "SELECT typname, typlen FROM pg_type WHERE typlen > 0 ORDER BY oid",
    "SELECT r.region_rows, t.table_name FROM "
    "information_schema.region_statistics r JOIN information_schema.tables "
    "t ON r.table_id = t.table_id ORDER BY t.table_name",
    "SELECT * FROM information_schema.nope",
    "SELECT * FROM pg_catalog.nope",
    "SELECT ts, max(v) RANGE '1m' FROM information_schema.tables ALIGN '1m'",
])
def test_system_queries(pair, q):
    pair.same(q)


def test_bare_names_in_information_schema_database(pair):
    ctx, jctx = QueryContext(database="information_schema"), JaxCtx(
        database="information_schema")
    got = _run(pair.port, ctx, "SELECT table_name FROM tables ORDER BY "
                               "table_name")
    assert got == _run(pair.jax, jctx, "SELECT table_name FROM tables "
                                       "ORDER BY table_name")
    assert got[0] == "result"


def test_bare_pg_type_and_a_table_that_shadows_it(fresh):
    """A bare pg_type is the shim until a user table takes the name; the
    join reads both (the relational layer asks the instance's
    predicates, as the JAX package's does)."""
    q = ("SELECT p.typname, t.hostname FROM pg_type p JOIN tags t ON "
         "p.typlen = 8 AND t.os = 'os0' ORDER BY p.typname, t.hostname")
    fresh.same("SELECT typname FROM pg_type WHERE oid = 16")
    fresh.same("SELECT p.typname, t.dc FROM pg_type p JOIN tags t ON "
               "p.typname = t.dc")
    fresh.same(q)
    fresh.same("CREATE TABLE pg_type (ts TIMESTAMP TIME INDEX, typname "
               "STRING PRIMARY KEY, typlen BIGINT)")
    fresh.same("INSERT INTO pg_type VALUES (0, 'mine', 8), (0, 'yours', 4)")
    got = fresh.same("SELECT u.typname, p.oid FROM pg_type u JOIN "
                     "pg_catalog.pg_type p ON u.typlen = p.typlen ORDER BY "
                     "u.typname, p.oid")
    assert got[0] == "result"
    fresh.same("SELECT typname FROM pg_type ORDER BY typname")


@pytest.mark.parametrize("name,item", sorted(IS.WAITING_TABLES.items()))
def test_waiting_system_tables_name_their_item(pair, name, item):
    with pytest.raises(UnsupportedError, match=f"ROADMAP {item}"):
        pair.port.sql(f"SELECT * FROM information_schema.{name}")
    # the JAX package answers it
    pair.jax.sql(f"SELECT * FROM information_schema.{name}")


# ----------------------------------------------------------------------
# SET, SHOW VARIABLES, SHOW STATUS/CHARSET/COLLATION
# ----------------------------------------------------------------------

SET_FORMS = [
    "SET time_zone = '+08:00'",
    "SET max_execution_time = 1000",
    "SET TIME ZONE 'UTC'",
    "SET NAMES utf8mb4",
    "SET autocommit = 1, sql_mode = ANSI",
    "SET NAMES utf8mb4 COLLATE utf8mb4_general_ci",
    "SET SESSION TRANSACTION ISOLATION LEVEL READ COMMITTED",
    "SET TRANSACTION READ ONLY",
    "SET TRANSACTION ISOLATION LEVEL REPEATABLE READ",
    "SET TRANSACTION ISOLATION LEVEL SERIALIZABLE READ ONLY",
    "SET SESSION read_preference = 'leader'",
    "SET timezone = 'Asia/Shanghai'",
    "SET session_time_zone = '-03:00'",
]


@pytest.mark.parametrize("k", range(len(SET_FORMS)))
def test_set_forms(fresh, k):
    """Each SET form, after the ones before it, leaves the same session
    as on the JAX package; SHOW VARIABLES reads it back."""
    for stmt in SET_FORMS[:k + 1]:
        assert fresh.same(stmt) == ("rows", 0)
    assert fresh.pctx.timezone == fresh.jctx.timezone
    assert fresh.pctx.variables == fresh.jctx.variables
    for stmt in ("SHOW VARIABLES", "SHOW VARIABLES LIKE 'time_zone'",
                 "SHOW VARIABLES LIKE 'transaction%'",
                 "SHOW VARIABLES LIKE 'NAMES'",
                 "SHOW VARIABLES LIKE 'read_preference'"):
        fresh.same(stmt)


def test_set_leaves_results_alone(fresh):
    """The session's zone is read by no result, as on the JAX package."""
    q = "SELECT ts, usage_user FROM cpu WHERE hostname = 'host_0' LIMIT 3"
    before = fresh.same(q)
    fresh.same("SET time_zone = '+05:00'")
    assert fresh.same(q) == before


def test_default_timezone(fresh):
    from greptimedb_tpu_torch import session

    assert QueryContext().timezone == session.default_timezone() == "UTC"
    session.set_default_timezone("+02:00")
    try:
        assert QueryContext().timezone == "+02:00"
        got = fresh.port.sql("SHOW VARIABLES LIKE '%time_zone'",
                             QueryContext())
        assert got.rows() == [["system_time_zone", "+02:00"],
                              ["time_zone", "+02:00"]]
    finally:
        session.set_default_timezone("UTC")
    assert QueryContext().timezone == "UTC"


@pytest.mark.parametrize("stmt", ["SHOW STATUS", "SHOW CHARSET",
                                  "SHOW CHARACTER SET", "SHOW COLLATION",
                                  "SHOW GLOBAL STATUS"])
def test_show_status_charset_collation(pair, stmt):
    assert pair.same(stmt)[0] == "result"


def test_show_processlist_lists_itself(pair):
    got, want = pair.results("SHOW PROCESSLIST")
    assert got.names == want.names
    assert [r[2:5] + r[6:] for r in got.rows()] == \
        [r[2:5] + r[6:] for r in want.rows()] == \
        [["public", "Query", "Running", "ShowProcesslist"]]


# ----------------------------------------------------------------------
# PREPARE / EXECUTE / DEALLOCATE
# ----------------------------------------------------------------------

SUBSTITUTIONS = [
    ("select ?", [1]),
    ("select * from t where a = ? and b = ?", [1.5, "x'y"]),
    ("select $2, $1", ["a", None]),
    ("select '?', ?", [5]),
    ("select \"?\", `$1`, ?", [True]),
    ("select ? -- ?\n, ?", [1, 2]),
    ("select /* ? $1 */ ?", [-0.0]),
    ("select 'it''s ?', ?", [7]),
    ("select 'a\\'?', ?", ["b"]),
    ("select * from t where a = ? and b = ?", ["x\\", "', (select 1) --"]),
    ("select ?", [float("inf")]),
    ("select $1, $1, ?", [3]),
    ("select ?, ?", [1]),
    ("select $3", [1]),
    ("select $0", [1]),
    ("select 'unterminated ?", [1]),
]


@pytest.mark.parametrize("k", range(len(SUBSTITUTIONS)))
def test_substitute_placeholders(k):
    text, args = SUBSTITUTIONS[k]

    def run(fn):
        try:
            return fn(text, list(args))
        except Exception as e:  # noqa: BLE001 - class and text compared
            return (type(e).__name__, str(e))

    assert run(substitute_placeholders) == run(jax_substitute)
    assert count_placeholders(text) == jax_count_placeholders(text)


def test_binding_is_injection_safe():
    from greptimedb_tpu_torch.instance import format_sql_literal
    from greptimedb_tpu_torch.sql.lexer import Tok, tokenize

    bound = substitute_placeholders(
        "select * from t where a = ? and b = ?",
        ["x\\", "', (select 1) --"])
    strings = [t.text for t in tokenize(bound) if t.kind == Tok.STRING]
    assert strings == ["x\\", "', (select 1) --"]
    assert format_sql_literal("C:\\new\\temp") == "'C:\\\\new\\\\temp'"


PREPARED = [
    "PREPARE q FROM 'select hostname from cpu where usage_user > ? and "
    "ts < 30000 order by hostname, ts'",
    "EXECUTE q (99.0)",
    "EXECUTE q (0)",
    "PREPARE p AS select usage_user from cpu where hostname = $1 and ts = $2",
    "EXECUTE p ('host_1', 20000)",
    "EXECUTE p USING 'host_2', 10000",
    "PREPARE s FROM 'select hostname from cpu where hostname = ?'",
    "EXECUTE s ('x\\\\')",
    "EXECUTE s ('host_3'' OR ''1''=''1')",
    "PREPARE g AS SELECT hostname, max(usage_user) FROM cpu WHERE ts >= $1 "
    "AND ts < $2 GROUP BY hostname ORDER BY hostname",
    "EXECUTE g (0, 600000)",
    "EXECUTE g (600000, 1200000)",
    "EXECUTE q",
    "EXECUTE p ('host_1')",
    "PREPARE two FROM 'select 1; select 2'",
    "EXECUTE two",
    "PREPARE Q2 FROM 'select ?'",
    "EXECUTE q2 ('upper name')",
    "DEALLOCATE PREPARE q",
    "EXECUTE q (1)",
    "DEALLOCATE q",
    "DEALLOCATE ALL",
    "EXECUTE p (1)",
    "EXECUTE nothing",
]


def test_prepare_execute_deallocate(fresh):
    for stmt in PREPARED:
        fresh.same(stmt)
    assert fresh.pctx.extensions.get("prepared") == {}


def test_execute_equals_the_literal_query(fresh):
    fresh.same(PREPARED[9])
    got = fresh.same("EXECUTE g (0, 600000)")
    assert got == fresh.same(
        "SELECT hostname, max(usage_user) FROM cpu WHERE ts >= 0 AND ts < "
        "600000 GROUP BY hostname ORDER BY hostname")
    assert got[0] == "result"


# ----------------------------------------------------------------------
# SHOW PROCESSLIST and ADMIN kill
# ----------------------------------------------------------------------

@pytest.mark.parametrize("stmt", ["ADMIN kill('424242')",
                                  "ADMIN kill('not a number')",
                                  "KILL QUERY 99999", "KILL 7",
                                  "ADMIN kill()"])
def test_kill_of_a_missing_id(pair, stmt):
    pair.same(stmt)


VICTIMS = {
    # a grid no snapshot of the earlier tests can serve (35 s is no
    # multiple of their cells), so it is built from a scan; max and count
    # are exact on both packages (a window mean is held to C2's bound in
    # tests/test_torch_sql.py)
    "range": "SELECT ts, hostname, max(usage_user) RANGE '35s', "
             "count(usage_system) RANGE '35s' FROM cpu ALIGN '35s' BY "
             "(hostname) ORDER BY hostname, ts",
    "explain_analyze": "EXPLAIN ANALYZE SELECT hostname, max(usage_user) "
                       "FROM cpu GROUP BY hostname",
    "union": "SELECT hostname FROM cpu WHERE ts < 60000 GROUP BY hostname "
             "UNION ALL SELECT hostname FROM cpu WHERE ts >= 60000 GROUP BY "
             "hostname",
}


@pytest.mark.parametrize("name", list(VICTIMS))
def test_kill_lands_at_a_checkpoint(device_pair, monkeypatch, name):
    """A kill lands at the victim's next scan checkpoint (made slow and
    deterministic: it waits for the kill), as the JAX package's test does.
    The victim raises and leaves nothing behind: no grid entry, no
    collector, no process-list entry; run again it answers as the JAX
    package does."""
    inst = device_pair.port
    inst.query_engine.range_cache = type(inst.query_engine.range_cache)()
    q = VICTIMS[name]
    started, killed, out = threading.Event(), threading.Event(), {}
    real = cancellation.checkpoint

    def slow_checkpoint():
        started.set()
        assert killed.wait(10)
        real()

    def victim():
        try:
            out["res"] = inst.sql(q, QueryContext())
        except ExecutionError as e:
            out["err"] = str(e)
        out["collector"] = stats.active()

    monkeypatch.setattr(cancellation, "checkpoint", slow_checkpoint)
    th = threading.Thread(target=victim)
    th.start()
    assert started.wait(10)
    procs = inst.sql("SHOW PROCESSLIST")
    rows = [dict(zip(procs.names, r)) for r in procs.rows()]
    running = [r for r in rows if r["Info"] != "ShowProcesslist"]
    assert len(running) == 1 and running[0]["State"] == "Running", rows
    pid = running[0]["Id"]
    ack = inst.sql(f"ADMIN kill('{pid}')")
    assert ack.rows() == [[1]]
    killed.set()
    th.join(10)
    assert not th.is_alive()
    assert out.get("err") == f"query {pid} was killed", out
    assert out["collector"] is None
    assert inst._process_list.snapshot() == []
    assert inst.query_engine.range_cache._entries == {}
    monkeypatch.setattr(cancellation, "checkpoint", real)
    if name == "explain_analyze":
        _same_analyze(device_pair, q[len("EXPLAIN ANALYZE "):])
    else:
        device_pair.same(q)


def test_kill_lands_in_a_running_multi_statement_batch(device_pair,
                                                       monkeypatch):
    """A killed statement raises out of its batch: the statements after
    it do not run."""
    inst = device_pair.port
    started, killed, out = threading.Event(), threading.Event(), {}
    real = cancellation.checkpoint
    calls = []

    def slow_checkpoint():
        calls.append(1)
        if len(calls) == 1:
            started.set()
            assert killed.wait(10)
        real()

    def victim():
        try:
            out["res"] = inst.execute_sql(
                "SELECT count(*) FROM cpu; SELECT count(*) FROM tags")
        except ExecutionError as e:
            out["err"] = str(e)

    monkeypatch.setattr(cancellation, "checkpoint", slow_checkpoint)
    th = threading.Thread(target=victim)
    th.start()
    assert started.wait(10)
    pid = inst._process_list.snapshot()[0]["id"]
    assert inst.sql(f"ADMIN kill('{pid}')").rows() == [[1]]
    killed.set()
    th.join(10)
    assert not th.is_alive()
    assert out.get("err") == f"query {pid} was killed"
    assert len(calls) == 1
