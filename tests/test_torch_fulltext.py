"""The flush-time fulltext index in puffin sidecars: the port against the
JAX package on the CPU.

The cases of tests/test_fulltext_index.py run through a Standalone of each
package over the same log rows: `matches()` queries skip the row groups
whose term index cannot hold a hit, and the survivors are filtered
exactly. Counts and the row-group notes of the query are compared between
the packages. The puffin container is compared byte for byte: a sidecar
written by one package is read by the other, both ways, and the port's
sidecar for a flushed SST equals the JAX package's for the same rows.
"""

import numpy as np
import pytest

from greptimedb_tpu.instance import Standalone as JaxStandalone
from greptimedb_tpu.query import stats as jax_stats
from greptimedb_tpu.query.fulltext import (
    eval_matches as jax_eval_matches,
)
from greptimedb_tpu.query.fulltext import (
    eval_matches_term as jax_eval_matches_term,
)
from greptimedb_tpu.query.fulltext import required_terms as jax_required
from greptimedb_tpu.storage import puffin as JP
from greptimedb_tpu.storage import region as JR
from greptimedb_tpu.storage import sst as JS
from greptimedb_tpu_torch.errors import InvalidArgumentError
from greptimedb_tpu_torch.instance import Standalone
from greptimedb_tpu_torch.query import stats
from greptimedb_tpu_torch.query.fulltext import (
    eval_matches,
    eval_matches_term,
    required_terms,
)
from greptimedb_tpu_torch.storage import puffin as TP
from greptimedb_tpu_torch.storage import sst as TS


def _container(P):
    w = P.PuffinWriter()
    w.add_blob("type-a", b"hello", {"column": "c1"})
    w.add_blob("type-a", b"world", {"column": "c2"})
    w.add_blob("type-b", b"x" * 100)
    return w.finish()


@pytest.mark.parametrize("writer,reader", [(TP, JP), (JP, TP), (TP, TP)],
                         ids=["port-to-jax", "jax-to-port", "port"])
def test_puffin_container_roundtrip(writer, reader):
    data = _container(writer)
    assert data == _container(JP)       # the same bytes, whoever writes
    r = reader.PuffinReader(data)
    assert len(r.blobs) == 3
    b = r.find("type-a", column="c2")
    assert r.read(b) == b"world"
    assert r.find("type-a", column="zz") is None
    with pytest.raises(ValueError):
        reader.PuffinReader(b"garbage")


QUERIES = ["error AND timeout", "timeout OR slow", "NOT error",
           '"disk err"', "(disk OR warning) -slow", "+query path",
           "nonexistentterm", '"slow query" AND NOT info']


@pytest.mark.parametrize("q", QUERIES)
def test_query_grammar_matches_jax(q):
    rng = np.random.default_rng(5)
    words = ["disk", "error", "timeout", "warning", "slow", "query", "path",
             "info", "ok", "Error", "net)", "raid-5"]
    vals = np.asarray([" ".join(rng.choice(words, 5)) for _ in range(300)],
                      object)
    np.testing.assert_array_equal(eval_matches(vals, q),
                                  jax_eval_matches(vals, q))
    assert required_terms(q) == jax_required(q)
    term = q.split()[0].strip('"()+-')
    np.testing.assert_array_equal(eval_matches_term(vals, term),
                                  jax_eval_matches_term(vals, term))


# values that stress the column-at-once evaluation: case, punctuation,
# words glued to non-word characters, overlapping occurrences, non-ASCII
# letters (the Kelvin sign lowers to "k", the dotted capital I to "i" and
# a combining dot), a separator byte inside a value and inside a phrase,
# empty values
_MESSY = ["aaa aa", "AA-aa_a", "x\x00y net", "\u212aelvin k", "\u0130stanbul",
          "", "  ", "net)", "(net", "NET.err", "error42 error_4", "a\nb",
          "\u00e9t\u00e9 ete", "wp_login.php?x=1", "\u03a3\u03a3 sigma", "-"]
_MESSY_QUERIES = ["aa", "a", "aaa OR x", "k", "kelvin", "i", "istanbul",
                  "net", "err", "error42", "error_4", '"a a"', '"aa a"',
                  '"x"', '""', '"net)"', "b", "wp_login", '"wp_login.php"',
                  "NOT aa", "-net err", "+ete", '"\u00e9t\u00e9"', "sigma",
                  '"\u03c3\u03c3"', "y OR (a AND NOT b)", '"x\x00y"',
                  '"\x00"', '"\x00" OR "y\x01"', '"t\x00a"']


@pytest.mark.parametrize("q", _MESSY_QUERIES)
def test_messy_values_match_jax(q):
    rng = np.random.default_rng(len(q))
    vals = np.asarray(list(rng.choice(np.asarray(_MESSY, object), 200))
                      + [None, 7, 3.5], object)
    np.testing.assert_array_equal(eval_matches(vals, q),
                                  jax_eval_matches(vals, q), err_msg=q)
    clean = np.asarray([v for v in vals if "\x00" not in str(v)], object)
    np.testing.assert_array_equal(eval_matches(clean, q),
                                  jax_eval_matches(clean, q), err_msg=q)


@pytest.mark.parametrize("groups", [1, 7, 64])
def test_sidecar_bytes_equal_jax_on_messy_rows(groups):
    from greptimedb_tpu.storage.memtable import ColumnarRows as JRows
    from greptimedb_tpu_torch.storage.memtable import ColumnarRows

    rng = np.random.default_rng(groups)
    n = 300
    msgs = np.asarray([" ".join(rng.choice(np.asarray(_MESSY, object), 3))
                       for _ in range(n)], object)
    valid = rng.random(n) > 0.2
    parts = dict(sid=np.zeros(n, np.int32), ts=np.arange(n, dtype=np.int64),
                 fields={"m": msgs, "o": msgs[::-1].copy()},
                 field_valid={"m": valid, "o": np.ones(n, bool)})
    rows = ColumnarRows(seq=np.arange(n, dtype=np.uint64),
                        op=np.zeros(n, np.uint8), **parts)
    jrows = JRows(seq=np.arange(n, dtype=np.int64), op=np.zeros(n, np.int8),
                  **parts)
    got = TS._build_fulltext_sidecar(rows, ["m", "o", "absent"], groups)
    want = JS._build_fulltext_sidecar(jrows, ["m", "o", "absent"], groups)
    assert got == want
    assert TS._build_fulltext_sidecar(rows, [], groups) is None


def test_bad_query_raises_like_jax():
    from greptimedb_tpu.errors import InvalidArgumentError as JaxErr

    for q in ["(error", "error)", ""]:
        with pytest.raises(InvalidArgumentError) as got:
            eval_matches(np.asarray(["x"], object), q)
        with pytest.raises(JaxErr) as want:
            jax_eval_matches(np.asarray(["x"], object), q)
        assert str(got.value) == str(want.value)


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

    def count(self, q, counters=None):
        """count(*) of `q` on both packages, equal; with `counters`, the
        row-group keys of both collectors too."""
        with stats.collect() as st, jax_stats.collect() as jst:
            got = int(self.port.sql(q).rows()[0][0])
            want = int(self.jax.sql(q).rows()[0][0])
        assert got == want, q
        for k in counters or ():
            assert st.counters.get(k) == jst.counters.get(k), (k, q)
        return got, st.counters


@pytest.fixture()
def pair(tmp_path):
    p = _Pair(tmp_path)
    yield p
    p.close()


N_PER_GROUP = 2000


def _mk_logs(pair, monkeypatch):
    # append_mode: the log-table shape — no dedup, so value-based
    # row-group pruning is sound
    pair.both(
        "CREATE TABLE logs (host STRING, msg STRING FULLTEXT, "
        "ts TIMESTAMP TIME INDEX, PRIMARY KEY (host)) "
        "WITH (append_mode = 'true')")
    # three batches flushed as one SST with small row groups: group 0 has
    # "error timeout", group 1 "warning slow", group 2 "info ok". An SST
    # is sorted by (series, ts), so each message kind has a host of its
    # own (the JAX test spreads 7 hosts over all three, and its row-group
    # patch misses the name its region imported: one group, no pruning)
    msgs = (["disk error timeout on raid"] * N_PER_GROUP
            + ["warning slow query path"] * N_PER_GROUP
            + ["info everything ok"] * N_PER_GROUP)
    n = len(msgs)
    ts = np.arange(n, dtype=np.int64) * 1000
    hosts = np.asarray([f"h{i // N_PER_GROUP}" for i in range(n)], object)
    for inst, S, M in ((pair.port, TS, TS), (pair.jax, JS, JR)):
        table = inst.catalog.table("public", "logs")
        region = table.regions[0]
        assert region.meta.fulltext_fields == ["msg"]
        table.write({"host": hosts.copy()}, ts.copy(),
                    {"msg": np.asarray(msgs, object)})
        orig = M.write_sst

        def small_groups(*a, _orig=orig, **k):
            k["row_group_rows"] = N_PER_GROUP
            return _orig(*a, **k)

        monkeypatch.setattr(M, "write_sst", small_groups)
        region.flush()
        monkeypatch.setattr(M, "write_sst", orig)
        meta = region.manifest.state.ssts[0]
        assert meta.fulltext, "sidecar missing"
        assert region.store.exists(S.sidecar_path(meta.path))


def _sidecars(pair):
    out = []
    for inst, S in ((pair.port, TS), (pair.jax, JS)):
        region = inst.catalog.table("public", "logs").regions[0]
        meta = region.manifest.state.ssts[0]
        out.append(region.store.read(S.sidecar_path(meta.path)))
    return out


def test_sidecar_bytes_equal_jax(pair, monkeypatch):
    _mk_logs(pair, monkeypatch)
    port_bytes, jax_bytes = _sidecars(pair)
    assert port_bytes == jax_bytes
    # and each package's reader finds the other's blob
    for data, R in ((port_bytes, JP), (jax_bytes, TP)):
        r = R.PuffinReader(data)
        assert r.find(TS.FULLTEXT_BLOB, column="msg") is not None


def test_fulltext_prunes_row_groups(pair, monkeypatch):
    _mk_logs(pair, monkeypatch)
    got, counters = pair.count(
        "SELECT count(*) FROM logs WHERE matches(msg, 'error AND timeout')",
        counters=["row_groups_read", "row_groups_pruned_fulltext"])
    assert got == N_PER_GROUP
    # only 1 of 3 row groups decoded
    assert counters["row_groups_read"] == 1
    assert counters["row_groups_pruned_fulltext"] == 2


def test_fulltext_term_absent_skips_sst(pair, monkeypatch):
    _mk_logs(pair, monkeypatch)
    got, counters = pair.count(
        "SELECT count(*) FROM logs WHERE matches(msg, 'nonexistentterm')",
        counters=["ssts_pruned_fulltext", "row_groups_read"])
    assert got == 0
    assert counters["ssts_pruned_fulltext"] == 1


def test_fulltext_or_still_correct(pair, monkeypatch):
    _mk_logs(pair, monkeypatch)
    # OR has no single required term -> no pruning, results still exact
    got, counters = pair.count(
        "SELECT count(*) FROM logs WHERE matches(msg, 'timeout OR slow')",
        counters=["row_groups_read", "row_groups_pruned_fulltext"])
    assert got == 2 * N_PER_GROUP
    assert "row_groups_pruned_fulltext" not in counters
    # NOT semantics untouched
    got, _ = pair.count(
        "SELECT count(*) FROM logs WHERE matches(msg, 'NOT error')")
    assert got == 2 * N_PER_GROUP


def test_fulltext_phrase_edges_not_overpruned(pair, monkeypatch):
    _mk_logs(pair, monkeypatch)
    # '"disk err"' substring-matches "disk error ..." rows; the edge word
    # "err" must NOT be used for pruning (it's not a whole token)
    got, _ = pair.count(
        "SELECT count(*) FROM logs WHERE matches(msg, '\"disk err\"')",
        counters=["row_groups_read"])
    assert got == N_PER_GROUP


def test_no_pruning_under_dedup_overwrites(pair):
    """Last-write-wins tables must NOT index-prune: an overwrite whose new
    text lacks the term would resurrect the shadowed old row."""
    pair.both("CREATE TABLE ow (host STRING, msg STRING FULLTEXT, "
              "ts TIMESTAMP TIME INDEX, PRIMARY KEY (host))")
    regions = [inst.catalog.table("public", "ow").regions[0]
               for inst in (pair.port, pair.jax)]
    pair.both("INSERT INTO ow (host, msg, ts) VALUES "
              "('a', 'fatal error in disk', 1000)")
    for r in regions:
        r.flush()
    pair.both("INSERT INTO ow (host, msg, ts) VALUES "
              "('a', 'all fine now', 1000)")     # overwrite same (host, ts)
    for r in regions:
        r.flush()
    got, counters = pair.count(
        "SELECT count(*) FROM ow WHERE matches(msg, 'error')",
        counters=["ssts_pruned_fulltext", "row_groups_pruned_fulltext"])
    assert got == 0      # the old version must stay dead
    assert "ssts_pruned_fulltext" not in counters


def test_fulltext_survives_restart_and_truncate(pair, monkeypatch):
    _mk_logs(pair, monkeypatch)
    pair.close()
    pair.open()
    got, counters = pair.count(
        "SELECT count(*) FROM logs WHERE matches(msg, 'slow AND query')",
        counters=["row_groups_read"])
    assert got == N_PER_GROUP and counters["row_groups_read"] == 1
    for inst, S in ((pair.port, TS), (pair.jax, JS)):
        region = inst.catalog.table("public", "logs").regions[0]
        paths = [m.path for m in region.manifest.state.ssts]
        inst.sql("TRUNCATE TABLE logs")
        for p in paths:
            assert not region.store.exists(S.sidecar_path(p))


def test_compaction_rebuilds_and_purges_sidecars(pair, monkeypatch):
    """A merged SST gets its own sidecar; its inputs' sidecars go with
    them, and a reopen's orphan sweep keeps the live one."""
    _mk_logs(pair, monkeypatch)
    pair.both("INSERT INTO logs (host, msg, ts) VALUES "
              "('h0', 'late error timeout', 5000500)")
    for inst, S in ((pair.port, TS), (pair.jax, JS)):
        region = inst.catalog.table("public", "logs").regions[0]
        region.flush()
        old = [m.path for m in region.manifest.state.ssts]
        assert len(old) == 2
        assert region.compact(force=True)
        (merged,) = region.manifest.state.ssts
        assert merged.fulltext
        assert region.store.exists(S.sidecar_path(merged.path))
        for p in old:
            assert not region.store.exists(S.sidecar_path(p))
    pair.close()
    pair.open()
    for inst, S in ((pair.port, TS), (pair.jax, JS)):
        (merged,) = inst.catalog.table(
            "public", "logs").regions[0].manifest.state.ssts
        assert inst.catalog.table("public", "logs").regions[0].store.exists(
            S.sidecar_path(merged.path))
    got, _ = pair.count("SELECT count(*) FROM logs WHERE "
                        "matches(msg, 'error AND timeout')")
    assert got == N_PER_GROUP + 1


def test_catalog_keeps_the_flags(pair):
    """The column document carries fulltext and inverted_index, a reopen
    refills the region's fulltext fields, and a document written before
    the flags still opens."""
    import json

    pair.both("CREATE TABLE ft (host STRING, msg STRING FULLTEXT, "
              "n DOUBLE, ts TIMESTAMP TIME INDEX, PRIMARY KEY (host))")
    pair.close()
    pair.open()
    for inst in (pair.port, pair.jax):
        t = inst.catalog.table("public", "ft")
        assert [c.name for c in t.schema.columns if c.fulltext] == ["msg"]
        assert t.regions[0].meta.fulltext_fields == ["msg"]
    path = pair.root / "port" / "meta" / "catalog.json"
    doc = json.loads(path.read_text())
    cols = [c for t in _docs(doc) for c in t["columns"]]
    assert any(c.get("fulltext") for c in cols)
    for c in cols:
        c.pop("fulltext", None)
        c.pop("inverted_index", None)
    path.write_text(json.dumps(doc))
    pair.close()
    pair.open()
    t = pair.port.catalog.table("public", "ft")
    assert not any(c.fulltext for c in t.schema.columns)
    assert t.regions[0].meta.fulltext_fields == []


def _docs(doc):
    """Every table document in a catalog file."""
    out = []
    stack = [doc]
    while stack:
        d = stack.pop()
        if isinstance(d, dict):
            if "columns" in d and "table_id" in d:
                out.append(d)
            else:
                stack.extend(d.values())
        elif isinstance(d, list):
            stack.extend(d)
    return out
