"""The port's metric engine against the JAX package's: Prometheus-style
metrics as logical tables over one shared physical table, label widening,
reopen, and the physical table hidden from the Prometheus API (the shapes
of tests/test_metric_engine_rw.py, each run through both packages)."""

import json
import urllib.request

import numpy as np
import pytest

from greptimedb_tpu.instance import Standalone as JaxStandalone
from greptimedb_tpu.servers import http as jax_http
from greptimedb_tpu.servers.prom_store import apply_series as jax_apply
from greptimedb_tpu_torch.instance import Standalone
from greptimedb_tpu_torch.metric_engine import PHYSICAL_TABLE
from greptimedb_tpu_torch.servers import http
from greptimedb_tpu_torch.servers.prom_store import apply_series


class Pair:
    def __init__(self, tmp_path):
        self.roots = (str(tmp_path / "port"), str(tmp_path / "jax"))
        self.open()

    def open(self):
        self.port = Standalone(self.roots[0], device="cpu", x64=True,
                               prefer_device=False, warm_start=False)
        self.jax = JaxStandalone(self.roots[1], prefer_device=False,
                                 warm_start=False)

    def close(self):
        self.port.close()
        self.jax.close()

    def apply(self, series):
        # apply_series pops __name__: each package gets its own copy
        a = apply_series(self.port, [(dict(lab), list(s))
                                     for lab, s in series])
        b = jax_apply(self.jax, [(dict(lab), list(s)) for lab, s in series])
        assert a == b
        return a

    def sql(self, text):
        a, b = self.port.sql(text), self.jax.sql(text)
        assert a.names == b.names
        assert a.rows() == b.rows(), text
        return a.rows()


@pytest.fixture
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.close()


def _series(n_metrics: int, t0: int = 0):
    return [({"__name__": f"metric_{m}", "host": f"h{m % 3}"},
             [(float(m), t0 + 1000), (float(m) + 0.5, t0 + 2000)])
            for m in range(n_metrics)]


def test_many_metrics_share_one_physical_table(pair):
    assert pair.apply(_series(20)) == 40
    for m in (0, 7, 19):
        assert pair.port.catalog.table("public", f"metric_{m}"
                                       ).info.engine == "metric"
    phys = pair.port.catalog.table("public", PHYSICAL_TABLE)
    assert len(pair.port.engine.regions()) == len(phys.regions) == 1
    assert pair.sql("select greptime_value from metric_7 order by ts") == [
        [7.0], [7.5]]
    assert pair.sql(f"select count(greptime_value) from {PHYSICAL_TABLE}"
                    ) == [[40]]
    pair.sql("select * from metric_3 order by ts")
    pair.sql("show tables")
    pair.sql("describe metric_3")


def test_new_label_widens_physical(pair):
    pair.apply(_series(2))
    pair.apply([({"__name__": "metric_0", "host": "h0", "dc": "west"},
                 [(9.0, 5000)])])
    assert pair.sql("select dc, greptime_value from metric_0 "
                    "where dc != ''") == [["west", 9.0]]
    pair.sql("select * from metric_0 order by ts")
    pair.sql("describe metric_1")
    phys = pair.port.catalog.table("public", PHYSICAL_TABLE)
    assert phys.schema.maybe_column("dc") is not None


def test_metric_tables_survive_restart(pair):
    pair.apply(_series(5))
    pair.apply([({"__name__": "metric_1", "host": "h9", "zone": "z1"},
                 [(42.0, 9000)])])
    pair.port.catalog.table("public", PHYSICAL_TABLE).flush()
    pair.jax.catalog.table("public", PHYSICAL_TABLE).flush()
    pair.close()
    pair.open()
    assert pair.sql("select greptime_value from metric_1 "
                    "where zone = 'z1'") == [[42.0]]
    t = pair.port.catalog.table("public", "metric_1")
    assert t.info.engine == "metric"
    assert t.schema.maybe_column("zone") is not None
    pair.sql("select * from metric_4 order by ts")


def test_alter_collision_leaves_schema_unchanged(pair):
    pair.apply(_series(2))
    for inst in (pair.port, pair.jax):
        inst.execute_sql("alter table metric_0 add column foo double")
        with pytest.raises(Exception):
            inst.execute_sql(
                "alter table metric_1 add column foo string primary key")
    assert pair.port.catalog.table("public", "metric_1"
                                   ).schema.maybe_column("foo") is None
    assert pair.apply(_series(2, t0=60_000)) == 4
    pair.sql("select * from metric_0 order by ts")


def test_truncate_logical_table_keeps_the_others(pair):
    pair.apply(_series(3))
    for inst in (pair.port, pair.jax):
        inst.execute_sql("truncate table metric_1")
    assert pair.sql("select count(*) from metric_1") == [[0]]
    assert pair.sql("select count(*) from metric_2") == [[2]]


def test_discovery_apis_hide_internals(pair):
    pair.apply(_series(2))
    servers = [http.HttpServer(pair.port, port=0).start(),
               jax_http.HttpServer(pair.jax, port=0).start()]
    try:
        def get(srv, p):
            url = f"http://127.0.0.1:{srv.port}/v1/prometheus/api/v1{p}"
            with urllib.request.urlopen(url, timeout=30) as r:
                return json.load(r)["data"]

        for p in ("/labels", "/label/__name__/values",
                  "/label/host/values?match[]=metric_1", "/metadata",
                  "/label/__table_id/values"):
            got, want = get(servers[0], p), get(servers[1], p)
            assert got == want, p
        assert get(servers[0], "/labels") == ["__name__", "host"]
        assert PHYSICAL_TABLE not in get(servers[0], "/label/__name__/values")
        assert get(servers[0], "/label/host/values?match[]=metric_1") == [
            "h1"]
        assert PHYSICAL_TABLE not in get(servers[0], "/metadata")
    finally:
        for s in servers:
            s.stop()


def test_promql_over_metric_engine(pair):
    from greptimedb_tpu.promql.engine import PromEngine as JaxProm
    from greptimedb_tpu_torch.promql.engine import PromEngine

    pair.apply(_series(3, t0=1_700_000_000_000))
    t = 1_700_000_000_000 + 2000
    a, _ = PromEngine(pair.port).query_instant("metric_2", t)
    b, _ = JaxProm(pair.jax).query_instant("metric_2", t)
    assert a.labels == b.labels == [{"__name__": "metric_2", "host": "h2"}]
    assert np.array_equal(np.asarray(a.values), np.asarray(b.values))
