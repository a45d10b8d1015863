"""HTTP protocol server (the JAX package's servers/http.py, for the routes
the port serves):

- GET  /health, /ready                     liveness (`?deep=1`: the
                                           per-role readiness checks)
- GET  /status, /metrics                   build info; the exposition
- GET  /v1/traces[/<id>], /v1/stats/statements
                                           the trace ring; statement
                                           statistics
- GET  /debug/prof/{cpu,mem,hbm,device,device/trace}
                                           CPU samples, heap, the
                                           memory ledger, the device-
                                           program registry, a
                                           torch.profiler capture
- POST /v1/sql                             SQL in the GreptimeDB JSON
                                           envelope, or csv / table text
- POST /v1/promql, GET/POST /v1/prometheus/api/v1/{query,query_range,
  labels,label/<n>/values,series,status/buildinfo,metadata}
                                           Prometheus HTTP API
- POST /v1/prometheus/write|read           remote write and read (snappy
                                           protobuf)
- POST /v1/influxdb/write, /v1/influxdb/api/v2/write, /influxdb/write
                                           line protocol

`/v1/sql` takes `?timeout=` (or X-Greptime-Timeout), the statement's
deadline in seconds, enforced by admission control (sched/), and `?since=`
(or X-Greptime-Since), the delta cursor in epoch ms: a row-returning
SELECT answers only rows whose time index is past it (query/sessions.py).
With a user provider (auth.py) every route but /health and /ready wants
HTTP Basic credentials (401 without them), and the user is the
statement's tenant. Overload and quota sheds answer 429; a queue timeout
or a lapsed deadline 503.

Every request but the probes and scrapes runs under an `http <route>`
span continuing the client's W3C `traceparent`; requests, latency and
ingested rows count in the `greptime_servers_*` families.

Routes that wait answer 404 as unknown routes do, with their ROADMAP item
in the body: the cluster routes (A10), OTLP, OpenTSDB and events (A3),
scripts (A10).

A stdlib ThreadingHTTPServer: the host plane is IO-bound glue, the card
does the math. `HttpServer(instance, port=0).start()` binds a free port
(`.port`), `stop()` shuts it down.
"""

from __future__ import annotations

import gzip
import json
import math
import threading
import time
import traceback
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from greptimedb_tpu_torch.errors import GreptimeError, StatusCode
from greptimedb_tpu_torch.promql.engine import (
    PromEngine,
    ScalarValue,
    VectorValue,
)
from greptimedb_tpu_torch.servers import influx, prom_store
from greptimedb_tpu_torch.session import QueryContext
from greptimedb_tpu_torch.telemetry import global_registry
from greptimedb_tpu_torch.version import __version__

_REQS = global_registry.counter(
    "greptime_servers_http_requests_total", "HTTP requests", ("path", "code")
)
_LATENCY = global_registry.histogram(
    "greptime_servers_http_latency_seconds", "HTTP latency", ("path",)
)
_INGEST_ROWS = global_registry.counter(
    "greptime_servers_ingest_rows_total", "Rows ingested", ("api",)
)

# route prefixes that wait, and the ROADMAP item that ports them
_WAITING_ROUTES = (
    ("/v1/cluster/", "A10"), ("/v1/otlp/", "A3"), ("/v1/opentsdb/", "A3"), ("/opentsdb/", "A3"),
    ("/api/put", "A3"), ("/v1/events", "A3"), ("/v1/scripts", "A10"),
    ("/v1/run-script", "A10"),
)


def _type_name(tn: str) -> str:
    names = {
        "int8": "Int8", "int16": "Int16", "int32": "Int32", "int64": "Int64",
        "uint8": "UInt8", "uint16": "UInt16", "uint32": "UInt32",
        "uint64": "UInt64", "float32": "Float32", "float64": "Float64",
        "string": "String", "bool": "Boolean", "binary": "Binary",
        "timestamp_s": "TimestampSecond",
        "timestamp_ms": "TimestampMillisecond",
        "timestamp_us": "TimestampMicrosecond",
        "timestamp_ns": "TimestampNanosecond",
        "date": "Date", "json": "Json",
    }
    if tn.startswith("decimal("):
        return "Decimal128" + tn[len("decimal"):]
    return names.get(tn, tn)


def result_to_json(res) -> dict:
    schema = {"column_schemas": [
        {"name": n, "data_type": _type_name(res.type_name(i))}
        for i, n in enumerate(res.names)]}
    return {"records": {"schema": schema, "rows": res.rows(),
                        "total_rows": res.num_rows}}


# wire status of the overload and deadline errors: a quota or overload
# shed is the client's to back off from (429); a saturated queue, a lapsed
# deadline or unreachable storage is the server's state (503); every
# other GreptimeError answers 400
_HTTP_STATUS = {
    StatusCode.RATE_LIMITED: 429,
    StatusCode.QUERY_OVERLOADED: 429,
    StatusCode.QUERY_QUEUE_TIMEOUT: 503,
    StatusCode.DEADLINE_EXCEEDED: 503,
    StatusCode.STORAGE_UNAVAILABLE: 503,
}
# routes open without credentials
_OPEN_ROUTES = ("/health", "/ready")


class HttpServer:
    def __init__(self, instance, *, addr: str = "127.0.0.1",
                 port: int = 4000, user_provider=None):
        self.instance = instance
        self.addr = addr
        self.port = port
        # auth.UserProvider: HTTP Basic on every route but health
        self.user_provider = user_provider
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def start(self):
        handler = _make_handler(self.instance, self.user_provider)
        self._httpd = ThreadingHTTPServer((self.addr, self.port), handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="http-server")
        self._thread.start()
        return self

    def stop(self):
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)


def _make_handler(instance, user_provider=None):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):
            pass

        # --------------------------------------------------------------
        def _send(self, code: int, body: bytes,
                  content_type: str = "application/json"):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            _REQS.labels(self._route(), str(code)).inc()

        _KNOWN_ROUTES = (
            "/health", "/ready", "/status", "/metrics", "/v1/sql",
            "/v1/promql", "/v1/prometheus/api/v1/", "/v1/prometheus/write",
            "/v1/prometheus/read", "/v1/influxdb/", "/influxdb/",
            "/v1/events", "/v1/opentsdb/api/put", "/api/put",
            "/v1/otlp/v1/metrics", "/v1/traces", "/v1/traces/",
            "/v1/stats/statements",
            "/v1/cluster/metrics", "/v1/cluster/health",
            "/debug/prof/cpu", "/debug/prof/mem", "/debug/prof/hbm",
            "/debug/prof/device", "/debug/prof/device/trace",
        )

        def _raw_path(self) -> str:
            return urllib.parse.urlparse(self.path).path

        def _route(self) -> str:
            """Metric-label-safe route: unknown paths collapse to 'other'
            (unbounded label cardinality would leak memory per 404)."""
            path = self._raw_path()
            for r in self._KNOWN_ROUTES:
                if path == r:
                    return path
                if r.endswith("/") and path.startswith(r):
                    return r + "*"
            return "other"

        def _json(self, code: int, obj):
            self._send(code, json.dumps(obj).encode())

        def _error(self, code: int, msg: str):
            self._json(code, {"error": msg, "code": code})

        def _body(self) -> bytes:
            ln = int(self.headers.get("Content-Length") or 0)
            data = self.rfile.read(ln) if ln else b""
            if self.headers.get("Content-Encoding") == "gzip":
                data = gzip.decompress(data)
            return data

        def _params(self) -> dict:
            q = urllib.parse.urlparse(self.path).query
            return self._merge_qs({}, urllib.parse.parse_qs(q))

        @staticmethod
        def _merge_qs(params: dict, parsed: dict) -> dict:
            # repeatable keys (match[]) keep every value as a list
            for k, v in parsed.items():
                if k.endswith("[]"):
                    params.setdefault(k, [])
                    params[k] = list(params[k]) + v
                else:
                    params[k] = v[-1]
            return params

        def _form(self) -> dict:
            body = self._body()
            ctype = self.headers.get("Content-Type", "")
            params = self._params()
            if "application/x-www-form-urlencoded" in ctype:
                self._merge_qs(params, urllib.parse.parse_qs(body.decode()))
            elif body and "json" in ctype:
                try:
                    params.update(json.loads(body))
                except json.JSONDecodeError:
                    pass
            return params

        # --------------------------------------------------------------
        def do_GET(self):
            self._dispatch()

        def do_POST(self):
            self._dispatch()

        def _deny(self, msg: str):
            body = json.dumps({"error": msg, "code": 401}).encode()
            self.send_response(401)
            self.send_header("WWW-Authenticate", 'Basic realm="greptime"')
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            _REQS.labels(self._route(), "401").inc()

        _UNTRACED = ("/health", "/ready", "/metrics", "/v1/traces",
                     "/v1/stats/statements", "/v1/cluster/metrics",
                     "/v1/cluster/health")

        def _dispatch(self):
            from greptimedb_tpu_torch.telemetry import tracing

            path = self._raw_path()
            t0 = time.perf_counter()
            if path in self._UNTRACED or path.startswith("/v1/traces/"):
                # probe and scrape noise would churn real query traces
                # out of the bounded ring
                return self._dispatch_traced(path, t0)
            with tracing.start_remote(
                    self.headers.get("traceparent"),
                    f"http {self._route()}", method=self.command):
                self._dispatch_traced(path, t0)

        def _dispatch_traced(self, path: str, t0: float):
            try:
                if user_provider is not None and path not in _OPEN_ROUTES:
                    from greptimedb_tpu_torch.auth import (
                        AccessDeniedError,
                        check_basic_auth,
                    )

                    try:
                        # kept for the route handlers: /v1/sql makes the
                        # user the statement's tenant without checking
                        # the credentials again
                        self._auth_user = check_basic_auth(
                            self.headers.get("Authorization"),
                            user_provider) or ""
                    except AccessDeniedError as e:
                        return self._deny(str(e))
                self._route_request(path)
            except GreptimeError as e:
                self._error(_HTTP_STATUS.get(e.status_code, 400), str(e))
            except BrokenPipeError:
                pass
            except Exception as e:  # noqa: BLE001 - the wire answers 500
                traceback.print_exc()
                self._error(500, f"internal error: {e}")
            finally:
                _LATENCY.labels(self._route()).observe(
                    time.perf_counter() - t0)

        def _route_request(self, path: str):
            if path in ("/health", "/ready"):
                if self._params().get("deep") not in (None, "", "0",
                                                      "false"):
                    # per-role readiness (telemetry/node_stats.py); 503
                    # when degraded so probes can act on it
                    from greptimedb_tpu_torch.telemetry import (
                        node_stats as _ns,
                    )

                    doc = _ns.deep_health(instance)
                    return self._json(
                        200 if doc["status"] == "ok" else 503, doc)
                return self._json(200, {})
            if path == "/status":
                return self._json(200, {
                    "source_time": "", "commit": "", "branch": "",
                    "rustc_version": "n/a (python/torch)",
                    "hostname": "localhost", "version": __version__,
                })
            if path == "/metrics":
                return self._send(200, global_registry.render().encode(),
                                  "text/plain; version=0.0.4")
            if path == "/v1/traces" or path.startswith("/v1/traces/"):
                return self._handle_traces(path)
            if path == "/v1/stats/statements":
                return self._handle_statements()
            if path.startswith("/debug/prof/"):
                return self._handle_prof(path)
            if path == "/v1/sql":
                return self._handle_sql()
            if path == "/v1/promql":
                return self._handle_promql_range(self._form())
            if path.startswith("/v1/prometheus/api/v1/"):
                return self._handle_prom_api(
                    path.removeprefix("/v1/prometheus/api/v1/"))
            if path == "/v1/prometheus/write":
                return self._handle_remote_write()
            if path == "/v1/prometheus/read":
                return self._handle_remote_read()
            if path in ("/v1/influxdb/write", "/v1/influxdb/api/v2/write",
                        "/influxdb/write"):
                return self._handle_influx_write()
            for prefix, item in _WAITING_ROUTES:
                if path.startswith(prefix):
                    return self._error(
                        404, f"no route: {path} (not ported yet: ROADMAP "
                             f"{item})")
            self._error(404, f"no route: {path}")

        # --------------------------------------------------------------
        def _handle_sql(self):
            params = self._form()
            sql = params.get("sql")
            if not sql:
                return self._error(400, "missing sql parameter")
            db = params.get("db", "public")
            fmt = params.get("format", "greptimedb_v1").lower()
            if fmt not in ("csv", "table", "greptimedb_v1"):
                return self._error(400, f"unknown format {fmt!r}")
            ctx = QueryContext(database=db)
            # the user the dispatch gate authenticated: the statement's
            # tenant for admission control
            ctx.username = getattr(self, "_auth_user", "")
            # the statement's deadline in seconds; admission control
            # binds it for every checkpoint of the statement
            timeout = (params.get("timeout")
                       or self.headers.get("X-Greptime-Timeout"))
            if timeout is not None:
                try:
                    t = float(timeout)
                except ValueError:
                    return self._error(400, f"bad timeout {timeout!r}")
                # nan or inf would make the deadline's arithmetic
                # nonsense; <= 0 is a spent budget: client errors
                if not math.isfinite(t) or t <= 0:
                    return self._error(400, f"bad timeout {timeout!r}")
                ctx.extensions["deadline_s"] = t
            # the delta cursor (epoch ms): a row-returning SELECT answers
            # only rows whose time index is past it; the client advances
            # it to the largest ts it has seen
            since = (params.get("since")
                     or self.headers.get("X-Greptime-Since"))
            if since is not None:
                try:
                    v = float(since)
                except ValueError:
                    return self._error(400, f"bad since {since!r}")
                if not math.isfinite(v) or v < 0:
                    return self._error(400, f"bad since {since!r}")
                ctx.extensions["since_ms"] = int(v)
            t0 = time.perf_counter()
            outputs = instance.execute_sql(sql, ctx)
            elapsed = (time.perf_counter() - t0) * 1000
            if fmt in ("csv", "table"):
                res = next((o.result for o in reversed(outputs)
                            if o.result is not None), None)
                if res is None:
                    return self._send(200, b"", "text/plain")
                body = (_format_csv(res) if fmt == "csv"
                        else _format_table(res))
                return self._send(
                    200, body.encode(),
                    "text/csv" if fmt == "csv" else "text/plain")
            out_json = []
            for o in outputs:
                if o.result is not None:
                    out_json.append(result_to_json(o.result))
                else:
                    out_json.append({"affectedrows": o.affected_rows or 0})
            self._json(200, {"output": out_json,
                             "execution_time_ms": round(elapsed, 3)})

        # --------------------------------------------------------------
        def _handle_prom_api(self, endpoint: str):
            params = self._form()
            db = params.get("db", "public")
            engine = PromEngine(instance, QueryContext(database=db))
            if endpoint == "status/buildinfo":
                return self._json(200, {"status": "success", "data": {
                    "version": "2.53.0", "revision": __version__,
                    "branch": "HEAD", "buildUser": "", "buildDate": "",
                    "goVersion": "", "application": "greptimedb-tpu",
                }})
            if endpoint == "metadata":
                data = {}
                limit = int(params.get("limit", "-1") or -1)
                for t in instance.catalog.all_tables():
                    if t.info.database != db or _prom_hidden(t):
                        continue
                    if limit >= 0 and len(data) >= limit:
                        break
                    data[t.name] = [{"type": "gauge", "help": "",
                                     "unit": ""}]
                return self._json(200, {"status": "success", "data": data})
            if endpoint == "query_range":
                return self._handle_promql_range(params)
            if endpoint == "query":
                q = params.get("query", "")
                t = _parse_prom_time(params.get("time"), time.time())
                try:
                    val, ev = engine.query_instant(q, t)
                except GreptimeError as e:
                    return self._prom_error(str(e))
                return self._json(200, _prom_instant_json(val, ev))
            if endpoint == "labels":
                names = {"__name__"}
                for match in _match_params(params):
                    table = _match_table(instance, db, match)
                    if table:
                        names.update(table.tag_names)
                if not _match_params(params):
                    for t in instance.catalog.all_tables():
                        if t.info.database != db or _prom_hidden(t):
                            continue
                        names.update(t.tag_names)
                names = {n for n in names
                         if n == "__name__" or not n.startswith("__")}
                return self._json(200, {"status": "success",
                                        "data": sorted(names)})
            if endpoint.startswith("label/") and endpoint.endswith(
                    "/values"):
                label = endpoint[len("label/"):-len("/values")]
                values = set()
                if label == "__name__":
                    for t in instance.catalog.all_tables():
                        if t.info.database == db and not _prom_hidden(t):
                            values.add(t.name)
                else:
                    tables = [
                        _match_table(instance, db, m)
                        for m in _match_params(params)
                    ] or [
                        t for t in instance.catalog.all_tables()
                        if t.info.database == db and not _prom_hidden(t)
                    ]
                    for t in tables:
                        if t is None or label not in t.tag_names:
                            continue
                        values.update(_table_label_values(t, label))
                return self._json(200, {"status": "success",
                                        "data": sorted(values)})
            if endpoint == "series":
                out = []
                start = _parse_prom_time(params.get("start"), 0)
                end = _parse_prom_time(params.get("end"), time.time())
                for match in _match_params(params):
                    try:
                        val, ev = engine.query_instant(
                            match, end, lookback_ms=max(end - start, 1))
                    except GreptimeError:
                        continue
                    if isinstance(val, VectorValue):
                        for i, lab in enumerate(val.labels):
                            if val.present[i].any():
                                out.append(lab)
                return self._json(200, {"status": "success", "data": out})
            self._error(404, f"prometheus api: {endpoint}")

        def _handle_promql_range(self, params):
            db = params.get("db", "public")
            engine = PromEngine(instance, QueryContext(database=db))
            q = params.get("query", "")
            now = time.time()
            # the default window is in the data's time domain (epoch s)
            start = _parse_prom_time(params.get("start"), now - 300)
            end = _parse_prom_time(params.get("end"), now)
            try:
                step_ms = P_parse_step_ms(params.get("step", "60"))
                val, ev = engine.query_range(q, start, end, step_ms)
            except GreptimeError as e:
                return self._prom_error(str(e))
            self._json(200, _prom_matrix_json(val, ev))

        def _prom_error(self, msg: str):
            self._json(400, {"status": "error", "errorType": "bad_data",
                             "error": msg})

        # --------------------------------------------------------------
        def _handle_remote_write(self):
            params = self._params()
            db = params.get("db", "public")
            compressed = "snappy" in (
                self.headers.get("Content-Encoding") or "snappy")
            _series, samples = prom_store.remote_write(
                instance, self._body(), db=db, compressed=compressed)
            _INGEST_ROWS.labels("prom_remote_write").inc(samples)
            self._send(204, b"")

        def _handle_remote_read(self):
            params = self._params()
            db = params.get("db", "public")
            resp = prom_store.remote_read(instance, self._body(), db=db)
            self.send_response(200)
            self.send_header("Content-Type", "application/x-protobuf")
            self.send_header("Content-Encoding", "snappy")
            self.send_header("Content-Length", str(len(resp)))
            self.end_headers()
            self.wfile.write(resp)
            _REQS.labels(self._route(), "200").inc()

        def _handle_influx_write(self):
            params = self._params()
            db = params.get("db", params.get("bucket", "public"))
            precision = params.get("precision", "ns")
            body = self._body().decode("utf-8", "replace")
            rows = influx.write_lines(instance, body, db=db,
                                      precision=precision)
            _INGEST_ROWS.labels("influx_line").inc(rows)
            self._send(204, b"")

        # --------------------------------------------------------------
        # telemetry surfaces
        # --------------------------------------------------------------
        def _handle_traces(self, path: str):
            from greptimedb_tpu_torch.telemetry.tracing import global_traces

            params = self._params()
            tid = params.get("trace_id")
            if path.startswith("/v1/traces/"):
                tid = path.rsplit("/", 1)[-1]
            if tid:
                # one stitched trace
                return self._json(200, {"trace_id": tid,
                                        "spans": global_traces.trace(tid)})
            try:
                limit = int(params.get("limit", "50") or 50)
            except ValueError:
                return self._error(400, "bad limit")
            return self._json(200, {"traces": global_traces.traces(limit)})

        def _handle_statements(self):
            # ?order_by=calls|total_ms|p99_ms|...&limit=N
            from greptimedb_tpu_torch.telemetry.stmt_stats import (
                global_stmt_stats,
            )

            params = self._params()
            try:
                limit = int(params.get("limit", "0") or 0)
            except ValueError:
                return self._error(400, "bad limit")
            if limit < 0:
                return self._error(400, "bad limit")
            return self._json(200, {
                "statements": global_stmt_stats.snapshot(
                    order_by=params.get("order_by", "total_ms"),
                    limit=limit),
            })

        def _handle_prof(self, path: str):
            from greptimedb_tpu_torch.telemetry import device_programs as _dp
            from greptimedb_tpu_torch.telemetry import memory as _memory
            from greptimedb_tpu_torch.telemetry import pprof

            params = self._params()
            if path == "/debug/prof/cpu":
                # sampling CPU profile of the whole process
                try:
                    seconds = float(params.get("seconds", "1"))
                except ValueError:
                    return self._error(400, "bad seconds")
                stacks = pprof.sample_cpu(seconds)
                fmt = params.get("format", "text")
                if fmt == "speedscope":
                    return self._send(
                        200, pprof.render_speedscope(stacks).encode(),
                        "application/json")
                body = (pprof.render_collapsed(stacks)
                        if fmt == "collapsed"
                        else pprof.render_report(stacks))
                return self._send(200, body.encode(), "text/plain")
            if path == "/debug/prof/mem":
                # the host heap (tracemalloc)
                try:
                    top = int(params.get("top", "30"))
                except ValueError:
                    return self._error(400, "bad top")
                diff = params.get("diff", "0") not in ("0", "", "false")
                return self._send(
                    200, pprof.mem_profile(top, diff=diff).encode(),
                    "text/plain")
            if path == "/debug/prof/hbm":
                # the memory ledger: per-pool bytes, the census and its
                # unaccounted residue
                try:
                    top = int(params.get("top", "10"))
                except ValueError:
                    return self._error(400, "bad top")
                doc = _memory.hbm_report(top=top)
                if params.get("format", "text") == "json":
                    return self._json(200, doc)
                return self._send(200, _memory.render_hbm_text(doc).encode(),
                                  "text/plain")
            if path == "/debug/prof/device":
                # the device-program registry, top-N by device time
                try:
                    top = int(params.get("top", "20"))
                except ValueError:
                    return self._error(400, "bad top")
                doc = _dp.global_programs.report(top=top)
                if params.get("format", "text") == "json":
                    return self._json(200, doc)
                return self._send(200, _dp.render_text(doc).encode(),
                                  "text/plain")
            if path == "/debug/prof/device/trace":
                # a torch.profiler capture of ?seconds=, written as a
                # Chrome trace under [profiling] trace_dir
                try:
                    seconds = float(params.get("seconds", "1"))
                except ValueError:
                    return self._error(400, "bad seconds")
                if not (0.0 < seconds <= 60.0):
                    return self._error(400, "seconds must be in (0, 60]")
                try:
                    doc = _dp.capture_trace(seconds,
                                            params.get("dir") or None)
                except _dp.CaptureBusyError as e:
                    return self._error(409, str(e))
                return self._json(200, doc)
            return self._error(404, f"no route: {path}")

    return Handler


# ----------------------------------------------------------------------
# prometheus json shaping
# ----------------------------------------------------------------------
def _parse_prom_time(v, default) -> int:
    """RFC3339 or unix seconds -> ms."""
    if v is None or v == "":
        return int(float(default) * 1000)
    try:
        return int(float(v) * 1000)
    except ValueError:
        from greptimedb_tpu_torch.query.expr import parse_ts_literal

        return parse_ts_literal(v)


def P_parse_step_ms(v) -> int:
    try:
        return max(int(float(v) * 1000), 1)
    except (TypeError, ValueError):
        from greptimedb_tpu_torch.promql.parser import parse_duration_ms

        return max(parse_duration_ms(str(v)), 1)


def _fmt_sample(x: float) -> str:
    if x != x:
        return "NaN"
    if x in (float("inf"), float("-inf")):
        return "+Inf" if x > 0 else "-Inf"
    return repr(float(x))


def _prom_matrix_json(val, ev) -> dict:
    if isinstance(val, ScalarValue):
        values = [[t / 1000.0, _fmt_sample(v)]
                  for t, v in zip(ev.step_ts.tolist(), val.values.tolist())]
        return {"status": "success",
                "data": {"resultType": "matrix",
                         "result": [{"metric": {}, "values": values}]}}
    result = []
    step_s = ev.step_ts / 1000.0
    for i, lab in enumerate(val.labels):
        idx = np.nonzero(val.present[i])[0]
        if len(idx) == 0:
            continue
        result.append({
            "metric": lab,
            "values": [[float(step_s[j]), _fmt_sample(float(val.values[i, j]))]
                       for j in idx],
        })
    return {"status": "success",
            "data": {"resultType": "matrix", "result": result}}


def _prom_instant_json(val, ev) -> dict:
    t = float(ev.step_ts[-1]) / 1000.0
    if isinstance(val, ScalarValue):
        return {"status": "success",
                "data": {"resultType": "scalar",
                         "result": [t, _fmt_sample(float(val.values[-1]))]}}
    result = []
    for i, lab in enumerate(val.labels):
        if not val.present[i][-1]:
            continue
        result.append({"metric": lab,
                       "value": [t, _fmt_sample(float(val.values[i, -1]))]})
    return {"status": "success",
            "data": {"resultType": "vector", "result": result}}


def _format_csv(res) -> str:
    import csv
    import io

    buf = io.StringIO()
    w = csv.writer(buf, lineterminator="\r\n")
    w.writerow(res.names)
    for row in res.rows():
        w.writerow(["" if v is None else v for v in row])
    return buf.getvalue()


def _format_table(res) -> str:
    """psql-style ASCII table."""
    rows = [[("NULL" if v is None else str(v)) for v in r]
            for r in res.rows()]
    widths = [max(len(n), *(len(r[i]) for r in rows)) if rows else len(n)
              for i, n in enumerate(res.names)]

    def line(ch="-", sep="+"):
        return sep + sep.join(ch * (w + 2) for w in widths) + sep

    def fmt(vals):
        return "|" + "|".join(
            f" {v}{' ' * (widths[i] - len(v))} " for i, v in enumerate(vals)
        ) + "|"

    out = [line(), fmt(res.names), line()]
    out.extend(fmt(r) for r in rows)
    out.append(line())
    return "\n".join(out) + "\n"


def _prom_hidden(t) -> bool:
    """The metric engine's shared physical table never surfaces through
    the Prometheus discovery APIs."""
    from greptimedb_tpu_torch.metric_engine import PHYSICAL_TABLE

    return t.name == PHYSICAL_TABLE


def _table_label_values(t, label: str) -> set:
    """Distinct non-empty values of `label` among this table's series (a
    logical metric table filters the shared registry by its table id)."""
    from greptimedb_tpu_torch import metric_engine as ME

    out: set = set()
    if isinstance(t, ME.LogicalTable):
        for region in t.regions:
            sids = t.scoped_sids(region)
            if len(sids) == 0:
                continue
            vals = region.series.tag_values(label)
            out.update(v for v in vals[sids] if v != "")
        return out
    for region in t.regions:
        idx = region.series.tag_names.index(label)
        out.update(v for v in region.series.dicts[idx].values if v != "")
    return out


def _match_params(params: dict) -> list[str]:
    out = []
    v = params.get("match[]")
    if isinstance(v, list):
        out.extend(v)
    elif v is not None:
        out.append(v)
    if "match" in params:
        out.append(params["match"])
    return out


def _match_table(instance, db: str, match: str):
    from greptimedb_tpu_torch.promql.parser import (
        VectorSelector,
        parse_promql,
    )

    try:
        sel = parse_promql(match)
    except GreptimeError:
        return None
    if isinstance(sel, VectorSelector) and sel.name:
        return instance.catalog.maybe_table(db, sel.name)
    return None
