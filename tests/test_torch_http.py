"""The port's HTTP server against the JAX package's, on the CPU.

Both packages' HttpServers run on port 0 over their own Standalone; the
same requests go to each. Status codes must be equal, and bodies equal
after dropping the timing field (`execution_time_ms`). Covered: /v1/sql in
its three formats and its errors, /v1/promql and the Prometheus API
endpoints, InfluxDB v1 and v2 writes at every precision with
auto-widening, Prometheus remote write and read with snappy bodies,
/health, a join and a view over /v1/sql, and EXPLAIN, information_schema,
SHOW VARIABLES and SHOW PROCESSLIST over /v1/sql. The snappy codec is
also held against the JAX package's.
"""

import json
import random
import struct
import urllib.error
import urllib.parse
import urllib.request

import pytest

from greptimedb_tpu.instance import Standalone as JaxStandalone
from greptimedb_tpu.servers import http as jax_http
from greptimedb_tpu.servers import snappy as jax_snappy
from greptimedb_tpu_torch.instance import Standalone
from greptimedb_tpu_torch.servers import http, snappy
from greptimedb_tpu_torch.servers.prom_store import (
    _field_bytes,
    _field_double,
    _field_varint,
    parse_read_request,
    parse_write_request,
)

HOUR_MS = 3_600_000


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("http")
    port = Standalone(str(root / "port"), device="cpu", x64=True,
                      warm_start=False)
    jax = JaxStandalone(str(root / "jax"), warm_start=False)
    srvs = (http.HttpServer(port, port=0).start(),
            jax_http.HttpServer(jax, port=0).start())
    yield srvs
    for s in srvs:
        s.stop()
    port.close()
    jax.close()


def _request(srv, path, data=None, headers=None, method=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}", data=data,
        headers=headers or {}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _body(raw: bytes, ctype: str):
    if "json" in (ctype or "") and raw:
        doc = json.loads(raw)
        if isinstance(doc, dict):
            doc.pop("execution_time_ms", None)
        return doc
    return raw


def same(servers, path, data=None, headers=None, method=None):
    """One request to both servers: equal status and body."""
    got, want = (_request(s, path, data, headers, method) for s in servers)
    assert got[0] == want[0], (path, got[:2], want[:2])
    a = _body(got[1], got[2].get("Content-Type"))
    b = _body(want[1], want[2].get("Content-Type"))
    assert a == b, (path, a, b)
    return got[0], a


def sql(servers, text, **params):
    q = urllib.parse.urlencode({"sql": text, **params})
    return same(servers, f"/v1/sql?{q}", data=b"", method="POST")


def sql_form(servers, text, **params):
    body = urllib.parse.urlencode({"sql": text, **params}).encode()
    return same(servers, "/v1/sql", data=body, headers={
        "Content-Type": "application/x-www-form-urlencoded"})


def _lines(n_hosts=6, hours=2, step_ms=60_000):
    rng = random.Random(3)
    out = []
    for h in range(n_hosts):
        for k in range(hours * HOUR_MS // step_ms):
            out.append(
                f"cpu,hostname=host_{h},region=r{h % 3} "
                f"usage_user={rng.random() * 100!r},"
                f"usage_system={rng.random() * 100!r} {k * step_ms}")
    return "\n".join(out)


def test_health_and_unknown_routes(servers):
    assert same(servers, "/health")[0] == 200
    assert same(servers, "/ready")[0] == 200
    assert same(servers, "/nope")[0] == 404
    # /metrics answers the exposition on both: the same content type, and
    # the request counter family with its kind and labels (values are
    # each process's own)
    (status, body, hdr), (jstatus, jbody, jhdr) = (
        _request(s, "/metrics") for s in servers)
    assert status == jstatus == 200
    assert hdr["Content-Type"] == jhdr["Content-Type"]
    for text in (body, jbody):
        assert (b"# TYPE greptime_servers_http_requests_total counter"
                in text)
    assert _request(servers[0], "/status")[0] == 200


@pytest.mark.parametrize("path", [
    "/status", "/health?deep=1", "/v1/traces?limit=5",
    "/v1/stats/statements?limit=3", "/debug/prof/device?format=json",
    "/debug/prof/hbm?format=json&top=2", "/debug/prof/cpu?seconds=0.05",
    "/debug/prof/mem?top=3", "/debug/prof/device",
])
def test_telemetry_routes_answer(servers, path):
    """The telemetry's routes answer on both servers: the same status,
    content type and, for a JSON document, the same keys (values are each
    process's own)."""
    (status, body, hdr), (jstatus, jbody, jhdr) = (
        _request(s, path) for s in servers)
    assert status == jstatus == 200, (path, body[:200])
    ctype = hdr["Content-Type"]
    assert ctype == jhdr["Content-Type"]
    if "json" in ctype:
        got, want = json.loads(body), json.loads(jbody)
        assert set(got) == set(want), path
    else:
        assert body and jbody


def test_influx_write_then_sql_formats(servers):
    same(servers, "/v1/influxdb/write?db=public&precision=ms",
         data=_lines().encode(), method="POST")
    assert sql(servers, "select count(*) from cpu")[1]["output"][0][
        "records"]["rows"] == [[720]]
    for q in (
        "select * from cpu order by ts, hostname limit 20",
        "select hostname, avg(usage_user), max(usage_system) from cpu "
        "group by hostname order by hostname",
        "select ts, region, avg(usage_user) range '1h' from cpu "
        "align '1h' by (region) order by ts, region",
        "describe cpu",
        "show tables",
        "select count(*) from cpu; select max(ts) from cpu",
    ):
        sql(servers, q)
        sql_form(servers, q)
        for fmt in ("csv", "table", "greptimedb_v1"):
            sql(servers, q, format=fmt)


def test_sql_errors(servers):
    for q, params in (
        ("select * from nope", {}),
        ("selec 1", {}),
        ("select 1", {"format": "xml"}),
        ("select 1", {"timeout": "abc"}),
        ("select 1", {"timeout": "-1"}),
        ("select 1", {"timeout": "nan"}),
        ("select 1", {"timeout": "5"}),
        ("select * from cpu", {"db": "nodb"}),
        ("insert into cpu (ts, nope) values (1, 2)", {}),
    ):
        sql(servers, q, **params)
    same(servers, "/v1/sql", data=b"", method="POST")


def test_ddl_and_insert_over_http(servers):
    sql(servers, "create database web")
    sql(servers, "create table t (ts timestamp time index, k string, "
                 "v double, n bigint, b boolean, primary key (k))",
        db="web")
    sql(servers, "insert into t values (1, 'a', 1.5, 2, true), "
                 "(2, 'b', null, null, false)", db="web")
    sql(servers, "select * from t order by ts", db="web")
    sql(servers, "show databases")
    sql(servers, "admin flush_table('web.t')")


def test_join_and_view_over_http(servers):
    """A join and a view through /v1/sql: equal across the packages, and
    the port's body equal to its in-process answer."""
    from greptimedb_tpu_torch.session import QueryContext

    sql(servers, "create database rel")
    sql(servers, "create table m (ts timestamp time index, host string, "
                 "v double, primary key (host))", db="rel")
    sql(servers, "create table tags (ts timestamp time index, host string, "
                 "dc string, primary key (host))", db="rel")
    sql(servers, "insert into m values (1000, 'a', 1.5), (2000, 'a', 2.5), "
                 "(1000, 'b', 4.0), (1000, 'c', null)", db="rel")
    sql(servers, "insert into tags values (0, 'a', 'east'), "
                 "(0, 'b', 'west'), (0, 'd', 'east')", db="rel")
    sql(servers, "create view hot as select host, avg(v) as u from m "
                 "group by host", db="rel")
    for q in (
        "select t.dc, count(*), sum(m.v) from m join tags t "
        "on m.host = t.host group by t.dc order by t.dc",
        "select m.host, t.dc, m.v from m left join tags t "
        "on m.host = t.host order by m.host, m.ts",
        "select h.host, h.u, t.dc from hot h join tags t using (host) "
        "order by h.host",
        "show views",
        "show create view hot",
    ):
        status, body = sql(servers, q, db="rel")
        assert status == 200, body
        inproc = servers[0].instance.sql(q, QueryContext(database="rel"))
        want = json.loads(json.dumps(http.result_to_json(inproc)))
        assert body["output"][0] == want, q


SESSION_QUERIES = [
    "explain select host, avg(v) from m where v > 1 group by host "
    "order by host",
    "select table_name, column_name, semantic_type from "
    "information_schema.columns where table_schema = 'ses' order by "
    "table_name, column_name",
    "show variables",
]


@pytest.mark.parametrize("q", SESSION_QUERIES,
                         ids=[q.split()[0] for q in SESSION_QUERIES])
def test_session_statements_over_http(servers, q):
    """EXPLAIN, an information_schema query and SHOW VARIABLES through
    /v1/sql: equal across the packages, and the port's body equal to its
    in-process answer."""
    from greptimedb_tpu_torch.session import QueryContext

    sql(servers, "create database if not exists ses")
    sql(servers, "create table if not exists m (ts timestamp time index, "
                 "host string, v double, primary key (host))", db="ses")
    status, body = sql(servers, q, db="ses")
    assert status == 200, body
    inproc = servers[0].instance.sql(q, QueryContext(database="ses"))
    want = json.loads(json.dumps(http.result_to_json(inproc)))
    assert body["output"][0] == want, q


def test_processlist_over_http_sees_another_request(servers, monkeypatch):
    """SHOW PROCESSLIST from one request sees the statement another
    request runs (each request has a thread of its own; the statement is
    held at its scan checkpoint until the list has been read)."""
    import threading

    from greptimedb_tpu_torch import cancellation

    srv = servers[0]
    q = urllib.parse.urlencode({"sql": "select count(*) from ps",
                                "db": "ses"})
    sql(servers, "create database if not exists ses")
    sql(servers, "create table if not exists ps (ts timestamp time index, "
                 "v double)", db="ses")
    started, release, out = threading.Event(), threading.Event(), {}
    real = cancellation.checkpoint

    def held():
        started.set()
        assert release.wait(30)
        real()

    def other_request():
        out["resp"] = _request(srv, f"/v1/sql?{q}", data=b"", method="POST")

    monkeypatch.setattr(cancellation, "checkpoint", held)
    th = threading.Thread(target=other_request)
    th.start()
    try:
        assert started.wait(30)
        lq = urllib.parse.urlencode({"sql": "show processlist"})
        status, raw, _ = _request(srv, f"/v1/sql?{lq}", data=b"",
                                  method="POST")
    finally:
        release.set()
        th.join(30)
    assert not th.is_alive()
    assert status == 200, raw
    rows = json.loads(raw)["output"][0]["records"]["rows"]
    assert ["ses", "Query", "Running", "Select"] in [
        [r[2], r[3], r[4], r[6]] for r in rows], rows
    assert out["resp"][0] == 200, out["resp"]


@pytest.mark.parametrize("precision", ["ns", "u", "us", "ms", "s", "m",
                                       "h"])
def test_influx_precisions_and_widening(servers, precision):
    table = f"lp_{precision}"
    ts = 1_700_000_000_123_456_789 if precision == "ns" else 28_333_333
    first = f"{table},host=a v=1i,s=\"x\",ok=t {ts}"
    # v widens int64 -> float64 within one batch; a later batch adds a
    # tag and a field
    same(servers, f"/v1/influxdb/write?precision={precision}",
         data=f"{first}\n{table},host=b v=2.5 {ts + 1}".encode(),
         method="POST")
    same(servers, f"/v1/influxdb/api/v2/write?bucket=public&precision="
                  f"{precision}",
         data=f"{table},host=c,dc=eu v=3i,w=4.5 {ts + 2}".encode(),
         method="POST")
    same(servers, f"/influxdb/write?precision={precision}",
         data=f"{table},host=d v=5.5 {ts + 3}".encode(), method="POST")
    sql(servers, f"select * from {table} order by ts, host")
    sql(servers, f"describe {table}")


def test_influx_rows_with_different_keys(servers):
    """Rows of one body that carry different tags and fields, in
    different orders: columns, their order and the nulls as the JAX
    package writes them."""
    body = "\n".join([
        "mixed,b=1,a=2 y=1i,x=2.5 1000",
        "mixed,a=3 x=3.5 2000",
        "mixed,c=4,a=5 z=t,y=7i 3000",
        "mixed,a=6,b=7 x=4i,y=8.5,w=\"s\" 4000",
        "mixed x=1.25 5000",
    ])
    same(servers, "/v1/influxdb/write?precision=ms", data=body.encode(),
         method="POST")
    sql(servers, "select * from mixed order by ts")
    sql(servers, "describe mixed")


def test_influx_errors(servers):
    same(servers, "/v1/influxdb/write?precision=xs", data=b"m v=1 1",
         method="POST")
    same(servers, "/v1/influxdb/write", data=b"m novalue 1", method="POST")
    same(servers, "/v1/influxdb/write", data=b"bad,t v=1 1", method="POST")


def test_prometheus_api(servers):
    same(servers, "/v1/influxdb/write?precision=ms",
         data=_lines().encode(), method="POST")
    rng = {"start": "0", "end": "7200", "step": "300"}
    for q in ('sum by (region) (rate(cpu{__field__="usage_user"}[10m]))',
              'max by (region) (cpu{__field__="usage_system"})',
              'cpu{__field__="usage_user", hostname="host_1"}',
              'topk(2, cpu{__field__="usage_user"})',
              "1 + 2", "nope_metric", "sum(("):
        enc = urllib.parse.urlencode({"query": q, **rng})
        same(servers, f"/v1/prometheus/api/v1/query_range?{enc}")
        same(servers, "/v1/promql", data=enc.encode(), headers={
            "Content-Type": "application/x-www-form-urlencoded"})
        enc = urllib.parse.urlencode({"query": q, "time": "3600"})
        same(servers, f"/v1/prometheus/api/v1/query?{enc}")
    for p in ("labels", "label/hostname/values", "label/__name__/values",
              "label/region/values?match[]=cpu", "labels?match[]=cpu",
              "series?match[]=cpu%7B__field__%3D%22usage_user%22%7D"
              "&start=0&end=3600", "status/buildinfo", "metadata",
              "metadata?limit=1", "nope"):
        same(servers, f"/v1/prometheus/api/v1/{p}")


def _write_request(series):
    ts_bytes = b""
    for labels, samples in series:
        body = b"".join(
            _field_bytes(1, _field_bytes(1, k.encode())
                         + _field_bytes(2, v.encode()))
            for k, v in labels.items())
        body += b"".join(
            _field_bytes(2, _field_double(1, v) + _field_varint(2, t))
            for v, t in samples)
        ts_bytes += _field_bytes(1, body)
    return ts_bytes


def _read_request(start, end, matchers):
    q = _field_varint(1, start) + _field_varint(2, end)
    for mtype, name, value in matchers:
        q += _field_bytes(3, _field_varint(1, mtype)
                          + _field_bytes(2, name.encode())
                          + _field_bytes(3, value.encode()))
    return _field_bytes(1, q)


def test_remote_write_and_read(servers):
    series = [({"__name__": f"rw_{m}", "job": f"j{s % 2}",
                "instance": f"i{s}"},
               [(float(m * 100 + s + k) / 3, k * 15_000) for k in range(8)])
              for m in range(3) for s in range(5)]
    raw = _write_request(series)
    assert len(parse_write_request(raw)) == len(series)
    body = snappy.compress(raw)
    assert body == jax_snappy.compress(raw)
    same(servers, "/v1/prometheus/write", data=body, method="POST",
         headers={"Content-Encoding": "snappy"})
    sql(servers, "select * from rw_1 order by ts, instance")
    enc = urllib.parse.urlencode({
        "query": "sum by (job) (rate(rw_0[1m]))", "start": "0",
        "end": "105", "step": "15"})
    same(servers, f"/v1/prometheus/api/v1/query_range?{enc}")
    for matchers in ([(0, "__name__", "rw_1")],
                     [(2, "__name__", "rw_.*"), (0, "job", "j1")],
                     [(0, "__name__", "rw_2"), (3, "instance", "i[01]")],
                     [(1, "__name__", "rw_0"), (2, "__name__", "rw.*")]):
        req = _read_request(0, 200_000, matchers)
        assert parse_read_request(req)[0][2] == matchers
        status, resp, hdr = _request(
            servers[0], "/v1/prometheus/read", data=snappy.compress(req),
            method="POST")
        status_j, resp_j, _ = _request(
            servers[1], "/v1/prometheus/read", data=snappy.compress(req),
            method="POST")
        assert status == status_j == 200
        assert hdr["Content-Encoding"] == "snappy"
        assert snappy.decompress(resp) == jax_snappy.decompress(resp_j)
        assert len(resp) > 8
    same(servers, "/v1/prometheus/write", data=b"\x07garbage",
         method="POST")


@pytest.mark.parametrize("n", [0, 1, 7, 60, 1000, 70_000])
def test_snappy_round_trips_against_the_jax_codec(n):
    rng = random.Random(n)
    data = bytes(rng.choice(b"abcab\x00\xff") for _ in range(n))
    data += b"repeat" * (n // 10)
    c = snappy.compress(data)
    assert c == jax_snappy.compress(data)
    assert snappy.decompress(c) == data
    assert snappy.decompress(jax_snappy.compress(data)) == data
    assert jax_snappy.decompress(c) == data


def test_sample_formatting_round_trips_floats():
    from greptimedb_tpu_torch.servers.http import _fmt_sample

    for x in (0.1 + 0.2, -0.0, 1e300, float("nan"), float("inf"),
              -float("inf"), struct.unpack("<d", b"\x01" * 8)[0]):
        assert _fmt_sample(x) == jax_http._fmt_sample(x)
