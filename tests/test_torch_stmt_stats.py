"""Statement statistics (telemetry/stmt_stats.py) of the port against the
JAX package's, on the CPU.

Every statement of the golden SQL files (tests/golden/*.sql, read, never
edited) gets the same fingerprint, normalized text and EXPLAIN inner
fingerprint from both packages, statement by statement and over each
file's text at once. The registry folds the same seeded observation
sequence into the same rows (counts exactly; times only by kind), collapses
its least-recently-used rows into `_other` alike, and exports the same
gtpu_stmt_* family names and label sets.
"""

import numpy as np
import pytest

from greptimedb_tpu.telemetry import metrics as jax_metrics
from greptimedb_tpu.telemetry import stmt_stats as jax_ss
from greptimedb_tpu_torch.telemetry import metrics
from greptimedb_tpu_torch.telemetry import stmt_stats as ss
from tests.test_golden import golden_files, parse_cases

GOLDEN = golden_files()


def _fps(module, sql):
    return [(f.fp, f.text, f.inner_fp) for f in module.fingerprint_sql(sql)]


@pytest.mark.parametrize("path", GOLDEN, ids=[p.stem for p in GOLDEN])
def test_golden_fingerprints_match(path):
    text = path.read_text()
    n = 0
    for stmt, _expected, _line in parse_cases(text):
        got = _fps(ss, stmt)
        assert got == _fps(jax_ss, stmt), stmt
        n += len(got)
    assert n > 0
    assert _fps(ss, text) == _fps(jax_ss, text)


@pytest.mark.parametrize("sql", [
    "SELECT * FROM t WHERE a = 1 AND b = 'x'",
    "select * from t where a = 2 and b = 'y'",
    "EXPLAIN ANALYZE SELECT avg(v) RANGE '5m' FROM t ALIGN '1m'",
    "INSERT INTO t VALUES (1, 2), (3, 4); SELECT 1; ",
    "SELECT 'a;b' ; SELECT \"x\" FROM t",
    "TQL EVAL (0, 10, '5s') rate(m[1m])",
    "SELECT ts, v FROM t WHERE v IN (1, 2, 3) LIMIT 10",
    "-- a comment\nSELECT 1",
    "",
])
def test_edge_fingerprints_match(sql):
    assert _fps(ss, sql) == _fps(jax_ss, sql)


class _Ctx:
    def __init__(self, db):
        self.database = db
        self.channel = "http"
        self.username = ""
        self.extensions = {}
        self.variables = {}


def _observe(module, seed, max_fingerprints=4):
    reg = module.StmtStatsRegistry(module.StmtStatsConfig(
        max_fingerprints=max_fingerprints, metric_fingerprints=2))
    rng = np.random.default_rng(seed)
    queries = [f"SELECT v{i} FROM t WHERE x = {i}" for i in range(7)]
    for _ in range(80):
        q = queries[int(rng.integers(len(queries)))]
        fp = module.fingerprint_sql(q)[0]
        token = module.bind_fingerprint(fp)
        try:
            with reg.observe(_Ctx(f"db{int(rng.integers(2))}"),
                             "Select") as obs:
                obs.add("rows", int(rng.integers(100)))
                module.add("readback_full_bytes", int(rng.integers(64)))
                module.add("compile_first" if rng.random() < 0.2
                           else "compile_cache_hit")
                module.note_exec_path(("device", "host:shape")[
                    int(rng.integers(2))])
        finally:
            module.reset_fingerprint(token)
    return reg


COUNT_KEYS = ("fingerprint", "schema_name", "query", "calls", "errors",
              "rows_returned", "exec_path", "compile_count",
              "compile_cache_hits", "readback_full_bytes")


@pytest.mark.parametrize("seed", range(3))
def test_registry_folds_alike(seed):
    p, j = _observe(ss, seed), _observe(jax_ss, seed)
    pd = sorted((tuple(d[k] for k in COUNT_KEYS)
                 for d in p.snapshot()), key=repr)
    jd = sorted((tuple(d[k] for k in COUNT_KEYS)
                 for d in j.snapshot()), key=repr)
    assert pd == jd
    assert any(d["fingerprint"] == ss.OTHER for d in p.snapshot())
    for d in p.snapshot():
        assert isinstance(d["total_ms"], float) and d["p99_ms"] >= 0.0


def test_stmt_families_match():
    def fams(module):
        return {n: (type(m).__name__, m.label_names)
                for n, m in module.global_registry._metrics.items()
                if n.startswith("gtpu_stmt_")}

    port = fams(metrics)
    assert port and port == fams(jax_metrics)
