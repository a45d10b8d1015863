"""The JSON, geo and network scalar functions, signed intervals and the
integer SUM overflow checks: the port against the JAX package on the CPU.

The 14 cases of tests/test_functions_ext.py run through a Standalone of
each package: every statement's answer (names, dtypes, validity, values by
their bits) or error (class and text) is compared between the two, and the
JAX test's own expectations are asserted on the port's answers. The
helpers the JAX test calls directly (`parse_interval_ms`,
`_interval_months`, `_host_reduce`) are called in both packages.
"""

import numpy as np
import pytest

from greptimedb_tpu.instance import Standalone as JaxStandalone
from greptimedb_tpu_torch.errors import (
    ArithmeticOverflowError,
    GreptimeError,
    InvalidSyntaxError,
)
from greptimedb_tpu_torch.instance import Standalone


def _col_key(c):
    v = np.asarray(c.values)
    m = np.asarray(c.valid_mask, bool)
    if v.dtype.kind == "f":
        vals = v.view(f"u{v.dtype.itemsize}")[m].tolist()
    elif v.dtype == object:
        vals = [(type(x).__name__, x) for x in v[m].tolist()]
    else:
        vals = v[m].tolist()
    return (str(v.dtype), m.tolist(), vals)


def _answer(inst, stmt):
    try:
        res = inst.sql(stmt)
    except Exception as e:  # noqa: BLE001 - class and text are compared
        return ("error", type(e).__name__, str(e)), None
    if res is None or not hasattr(res, "cols"):
        return ("ok",), res
    return ("result", list(res.names), [_col_key(c) for c in res.cols]), res


class _Pair:
    def __init__(self, root):
        self.port = Standalone(str(root / "port"), device="cpu", x64=True,
                               warm_start=False)
        self.jax = JaxStandalone(str(root / "jax"), prefer_device=False,
                                 warm_start=False)

    def close(self):
        self.port.close()
        self.jax.close()

    def sql(self, stmt):
        """Run on both; the answers must agree; returns the port's rows
        (or raises the port's error)."""
        got, res = _answer(self.port, stmt)
        want, _ = _answer(self.jax, stmt)
        assert got == want, stmt
        if got[0] == "error":
            return self.port.sql(stmt)      # re-raise the port's error
        return res


@pytest.fixture()
def inst(tmp_path):
    p = _Pair(tmp_path)
    yield p
    p.close()


@pytest.fixture()
def jt(inst):
    inst.sql("CREATE TABLE jt (doc STRING, ts TIMESTAMP TIME INDEX)")
    inst.sql(
        'INSERT INTO jt (doc, ts) VALUES '
        '(\'{"a": {"b": 7}, "tags": ["x", "y"], "ok": true, "pi": 3.5}\', '
        "1), ('not json', 2), "
        '(\'{"a": {}}\', 3)'
    )
    return inst


def test_json_get(jt):
    rows = jt.sql("SELECT json_get_int(doc, '$.a.b') FROM jt "
                  "ORDER BY ts").rows()
    assert rows[0][0] == 7 and rows[1][0] is None and rows[2][0] is None
    r = jt.sql("SELECT json_get_string(doc, '$.tags[1]') FROM jt "
               "WHERE ts = 1")
    assert r.rows()[0][0] == "y"
    r = jt.sql("SELECT json_get_bool(doc, 'ok'), "
               "json_get_float(doc, 'pi') FROM jt WHERE ts = 1")
    assert r.rows()[0] == [True, 3.5]
    for q in ("SELECT json_get_string(doc, '$.a') FROM jt ORDER BY ts",
              "SELECT json_get_int(doc, '$.tags[-1]') FROM jt ORDER BY ts",
              "SELECT parse_json(doc), to_json(doc) FROM jt ORDER BY ts"):
        jt.sql(q)


def test_json_predicates(jt):
    rows = jt.sql("SELECT json_path_exists(doc, '$.a.b'), "
                  "json_is_object(doc) FROM jt ORDER BY ts").rows()
    assert rows[0] == [True, True]
    assert rows[1] == [False, False]
    assert rows[2] == [False, True]
    jt.sql("SELECT json_is_array(doc), json_is_string(doc), "
           "json_is_number(doc), json_is_bool(doc), json_is_null(doc) "
           "FROM jt ORDER BY ts")
    with pytest.raises(GreptimeError):
        jt.sql("SELECT json_is_object(doc, doc) FROM jt")


def test_json_in_where(jt):
    r = jt.sql("SELECT ts FROM jt WHERE json_get_int(doc, '$.a.b') = 7")
    assert [row[0] for row in r.rows()] == [1]


def test_geo_functions(inst):
    inst.sql("CREATE TABLE gt (lat DOUBLE, lon DOUBLE, "
             "ts TIMESTAMP TIME INDEX)")
    # San Francisco and New York
    inst.sql("INSERT INTO gt (lat, lon, ts) VALUES "
             "(37.7749, -122.4194, 1), (40.7128, -74.0060, 2)")
    r = inst.sql("SELECT st_distance(lat, lon, 40.7128, -74.0060) "
                 "FROM gt ORDER BY ts")
    d = float(r.rows()[0][0])
    assert abs(d - 4_129_000) < 15_000   # ~4129 km great-circle
    assert float(r.rows()[1][0]) == 0.0

    r = inst.sql("SELECT geohash(lat, lon, 6) FROM gt ORDER BY ts")
    assert r.rows()[0][0].startswith("9q8yy")   # SF geohash prefix

    r = inst.sql("SELECT st_point(lat, lon) FROM gt WHERE ts = 2")
    assert r.rows()[0][0] == "POINT(-74.006 40.7128)"

    # cell bucketing groups nearby points to the same id
    r = inst.sql("SELECT h3_latlng_to_cell(lat, lon, 8) FROM gt "
                 "ORDER BY ts")
    ids = [row[0] for row in r.rows()]
    assert ids[0] != ids[1] and all(isinstance(i, int) for i in ids)
    inst.sql("SELECT haversine(lat, lon, 0.0, 0.0), "
             "latlng_to_cell(lat, lon, 3) FROM gt ORDER BY ts")
    with pytest.raises(GreptimeError):
        inst.sql("SELECT st_distance(lat, lon) FROM gt")


def test_net_functions(inst):
    inst.sql("CREATE TABLE nt (ip STRING, ts TIMESTAMP TIME INDEX)")
    inst.sql("INSERT INTO nt (ip, ts) VALUES ('10.0.0.1', 1), "
             "('192.168.1.5', 2), ('garbage', 3)")
    r = inst.sql("SELECT ipv4_string_to_num(ip) FROM nt ORDER BY ts")
    rows = [row[0] for row in r.rows()]
    assert rows[0] == 10 * 2**24 + 1 and rows[2] is None
    r = inst.sql("SELECT ipv4_num_to_string(167772161) FROM nt LIMIT 1")
    assert r.rows()[0][0] == "10.0.0.1"
    r = inst.sql("SELECT ts FROM nt WHERE ipv4_in_range(ip, "
                 "'192.168.0.0/16')")
    assert [row[0] for row in r.rows()] == [2]
    inst.sql("SELECT ipv4_to_string(ipv4_to_num(ip)) FROM nt ORDER BY ts")
    with pytest.raises(GreptimeError):
        inst.sql("SELECT ipv4_in_range(ip, 'not a net') FROM nt")


# ----------------------------------------------------------------------
# signed intervals: date_add(ts, INTERVAL '-1 month') must subtract
# ----------------------------------------------------------------------

def test_parse_interval_ms_signed():
    from greptimedb_tpu.sql.parser import parse_interval_ms as jax_parse
    from greptimedb_tpu_torch.sql.parser import parse_interval_ms

    for text, want in (("-90 minutes", -5_400_000), ("-1h", -3_600_000),
                       ("1 day -1 hour", 82_800_000),
                       ("- 1 day", -86_400_000)):
        assert parse_interval_ms(text) == jax_parse(text) == want


def test_interval_months_signed():
    from greptimedb_tpu.query.functions import _interval_months as jax_m
    from greptimedb_tpu.sql import ast as JA
    from greptimedb_tpu_torch.query.functions import _interval_months
    from greptimedb_tpu_torch.sql import ast as A

    for raw, want in (("-1 month", -1), ("-2 years", -24),
                      ("1 year -1 month", 11), ("- 1 month", -1),
                      ("-1 day", None)):
        assert _interval_months(A.IntervalLit(0, raw)) == want
        assert jax_m(JA.IntervalLit(0, raw)) == want


def test_date_add_negative_month_over_table(inst):
    inst.sql("CREATE TABLE sd (ts TIMESTAMP TIME INDEX, v DOUBLE)")
    # 2024-03-31: minus 1 month clamps to 2024-02-29 (leap year)
    inst.sql("INSERT INTO sd VALUES (1711843200000, 1.0)")
    r = inst.sql("SELECT date_add(ts, INTERVAL '-1 month') FROM sd")
    assert r.rows()[0][0] == 1709164800000
    # date_sub of a negative interval ADDS
    r = inst.sql("SELECT date_sub(ts, INTERVAL '-1 month') FROM sd")
    assert r.rows()[0][0] == 1714435200000  # 2024-04-30 (clamped)


def test_negative_range_interval_rejected(inst):
    inst.sql("CREATE TABLE nr (ts TIMESTAMP TIME INDEX, v DOUBLE)")
    with pytest.raises(InvalidSyntaxError):
        inst.sql("SELECT ts, avg(v) RANGE '-1h' FROM nr ALIGN '1h'")
    with pytest.raises(InvalidSyntaxError):
        inst.sql("SELECT ts, avg(v) RANGE '1h' FROM nr ALIGN '-1h'")


# ----------------------------------------------------------------------
# integer SUM overflow detection: raise, don't wrap
# ----------------------------------------------------------------------

def test_sum_bigint_overflow_raises(inst):
    inst.sql("CREATE TABLE so (ts TIMESTAMP TIME INDEX, n BIGINT)")
    big = 2**63 - 1
    inst.sql(f"INSERT INTO so VALUES (1, {big}), (2, {big})")
    with pytest.raises(ArithmeticOverflowError, match="overflows"):
        inst.sql("SELECT sum(n) FROM so")


def test_sum_uint64_above_int63_raises_not_wraps(inst):
    inst.sql("CREATE TABLE su (ts TIMESTAMP TIME INDEX, "
             "n BIGINT UNSIGNED)")
    inst.sql(f"INSERT INTO su VALUES (1, {2**63 - 1}), (2, 100)")
    with pytest.raises(ArithmeticOverflowError):
        inst.sql("SELECT sum(n) FROM su")


def test_reduce_uint64_value_above_int63_raises():
    """A single uint64 value above 2^63 must raise, not mis-cast negative;
    big-but-representable uint64 sums stay exact."""
    from greptimedb_tpu.errors import ArithmeticOverflowError as JaxOverflow
    from greptimedb_tpu.query.reduce import _host_reduce as jax_reduce
    from greptimedb_tpu_torch.query.reduce import _host_reduce

    valid = np.ones(2, bool)
    gid = np.zeros(2, np.int64)
    vals = np.asarray([2**63 + 10, 5], np.uint64)
    with pytest.raises(ArithmeticOverflowError) as got:
        _host_reduce("sum", vals, valid, gid, 1, None)
    with pytest.raises(JaxOverflow) as want:
        jax_reduce("sum", vals, valid, gid, 1, None)
    assert str(got.value) == str(want.value)
    vals = np.asarray([2**62, 2**61], np.uint64)
    out, present = _host_reduce("sum", vals, valid, gid, 1, None)
    jout, jpresent = jax_reduce("sum", vals, valid, gid, 1, None)
    assert int(out[0]) == int(jout[0]) == 2**62 + 2**61
    assert bool(present[0]) and bool(jpresent[0])
    assert np.asarray(out).dtype == np.asarray(jout).dtype


def test_sum_bigint_exact_above_2_53(inst):
    """Sums past float53 but inside int64 stay exact."""
    inst.sql("CREATE TABLE se (ts TIMESTAMP TIME INDEX, n BIGINT, "
             "g STRING PRIMARY KEY)")
    a = 2**62
    inst.sql(f"INSERT INTO se (ts, g, n) VALUES (1, 'x', {a}), "
             f"(2, 'x', 1), (3, 'y', -5)")
    r = inst.sql("SELECT g, sum(n) FROM se GROUP BY g ORDER BY g")
    assert r.rows() == [["x", a + 1], ["y", -5]]


def test_negative_ttl_and_window_rejected(inst):
    """A negative TTL would compute a cutoff in the future and expire
    everything: both refuse it."""
    with pytest.raises(GreptimeError, match="positive"):
        inst.sql("CREATE TABLE nt1 (ts TIMESTAMP TIME INDEX, v DOUBLE) "
                 "WITH (ttl = '-1 day')")
    with pytest.raises(GreptimeError, match="positive"):
        inst.sql("CREATE TABLE nt2 (ts TIMESTAMP TIME INDEX, v DOUBLE) "
                 "WITH ('compaction.twcs.time_window' = '-1h')")
