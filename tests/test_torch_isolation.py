"""The PyTorch port stands alone: it imports neither jax nor anything of the
JAX package, nor pyarrow or msgpack (the card machine has neither), and its
entry points never fall back to the CPU silently."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "greptimedb_tpu_torch"


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


_FOREIGN = ("jax", "jaxlib", "greptimedb_tpu", "pyarrow", "msgpack")


def _foreign(mod: str) -> bool:
    return mod.split(".")[0] in _FOREIGN


def test_ast_scan_finds_no_jax_or_reference_imports():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 17
    bad = [(f.relative_to(ROOT), m) for f in files
           for m in _imported_modules(f) if _foreign(m)]
    assert bad == []


_WORKLOAD = r"""
import sys
import numpy as np
from greptimedb_tpu_torch.catalog.table import Table
from greptimedb_tpu_torch.query.executor import QueryEngine
from greptimedb_tpu_torch.query.planner import (
    Column, KeySpec, RangeItemSpec, SelectPlan)

rng = np.random.default_rng(0)
t = Table("cpu", ts_name="ts", tag_names=["hostname", "region"],
          fields=["u"])
hosts = np.array([f"h{i}" for i in range(16)], object)
ts = np.tile(np.arange(720) * 10_000, 16)
hi = np.repeat(np.arange(16), 720)
t.write({"hostname": hosts[hi], "region": hosts[hi % 4]}, ts,
        {"u": rng.random(len(ts))})
t.compact(device="cpu", kernels="on", kernel_min_rows=1,
          device_min_rows=1, verify=True)
plan = SelectPlan(
    kind="range", keys=[KeySpec("__key_0", Column("region"), "region")],
    range_items=[RangeItemSpec("__r_0", "sum", Column("u"), 7_200_000)],
    post_items=[(Column("__ts"), "ts"), (Column("__key_0"), "region"),
                (Column("__r_0"), "s")],
    align_ms=3_600_000)
res = QueryEngine(device="cpu").execute(plan, t)
assert res.num_rows > 0

import types
from greptimedb_tpu_torch.catalog.manager import CatalogManager
from greptimedb_tpu_torch.parallel.mesh import MeshOptions, make_mesh
from greptimedb_tpu_torch.promql.engine import PromEngine

catalog = CatalogManager()
catalog.register(t)
for mesh in (None, make_mesh(["cpu"] * 4)):
    holder = types.SimpleNamespace(catalog=catalog, query_engine=QueryEngine(
        device="cpu", mesh=mesh, mesh_opts=MeshOptions(
            shard_min_series=1, pallas_kernels="on", pallas_min_series=1)))
    for q in ("sum by (region) (rate(cpu[1m]))", "topk(3, rate(cpu[1m]))"):
        v, _ = PromEngine(holder).query_range(q, 600_000, 1_200_000, 60_000)
        assert v.num_series > 0

from greptimedb_tpu_torch.instance import Instance

for mesh in (None, make_mesh(["cpu"] * 4)):
    inst = Instance(device="cpu", mesh=mesh, mesh_opts=MeshOptions(
        shard_min_series=1, pallas_kernels="on", pallas_min_series=1))
    inst.catalog.register(t)
    res = inst.sql("SELECT ts, region, sum(u) RANGE '2h' FROM cpu WHERE "
                   "hostname IN ('h1', 'h2', 'h7') ALIGN '1h' BY (region) "
                   "ORDER BY ts DESC LIMIT 3")
    assert res.num_rows == 3
    assert PromEngine(inst).query_range(
        "sum by (region) (rate(cpu[1m]))", 600_000, 1_200_000,
        60_000)[0].num_series > 0
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "greptimedb_tpu",
                                       "pyarrow", "msgpack"))
print("LEAKED", leaked)
"""

_DURABLE_WORKLOAD = r"""
import sys, tempfile
import numpy as np
from greptimedb_tpu_torch.catalog.manager import CatalogManager
from greptimedb_tpu_torch.datatypes.schema import Schema
from greptimedb_tpu_torch.storage.engine import EngineConfig, TsdbEngine

root = tempfile.mkdtemp()
def open_catalog():
    eng = TsdbEngine(EngineConfig(data_root=root, enable_background=False),
                     device="cpu")
    return eng, CatalogManager(eng)
eng, cat = open_catalog()
t = cat.create_table("public", "cpu",
                     Schema.of("ts", ["h"], {"u": np.float64}), options={"compaction_trigger_files": 2})
for k in range(3):
    t.write({"h": np.array(["a", "b"], object)}, np.array([k, k]),
            {"u": np.array([1.0, 2.0])})
    t.flush()
t.compact()
eng.close()
eng, cat = open_catalog()
assert len(cat.table("public", "cpu").scan().rows) == 6
eng.close()
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "greptimedb_tpu",
                                       "pyarrow", "msgpack"))
print("LEAKED", leaked)
"""

_SERVER_WORKLOAD = r"""
import json, sys, tempfile, urllib.parse, urllib.request
from greptimedb_tpu_torch import native
from greptimedb_tpu_torch.instance import Standalone
from greptimedb_tpu_torch.servers import http, snappy
from greptimedb_tpu_torch.servers.prom_store import (
    _field_bytes, _field_double, _field_varint)

inst = Standalone(tempfile.mkdtemp(), device="cpu")
srv = http.HttpServer(inst, port=0).start()
def post(path, data, headers={}):
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}",
                                 data=data, headers=headers)
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.read()
lines = "\n".join(f"cpu,h=h{i % 3} u={i}.5 {i * 1000}" for i in range(300))
assert post("/v1/influxdb/write?precision=ms", lines.encode())[0] == 204
assert native.lib_path().exists()
for q in ("admin flush_table('cpu')", "admin compact_table('cpu')",
          "delete from cpu where h = 'h1'",
          "select h, count(u) from cpu group by h",
          "tql eval (0, 300, '1m') sum(rate(cpu[1m]))"):
    status, body = post("/v1/sql", urllib.parse.urlencode(
        {"sql": q}).encode())
    assert status == 200, body
series = _field_bytes(1, _field_bytes(1, _field_bytes(1, b"__name__")
                                      + _field_bytes(2, b"m"))
                      + _field_bytes(2, _field_double(1, 1.0)
                                     + _field_varint(2, 1000)))
assert post("/v1/prometheus/write", snappy.compress(series))[0] == 204
q = urllib.parse.urlencode({"query": "sum(m)", "start": 0, "end": 60,
                            "step": 15})
with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/v1/prometheus/"
                            f"api/v1/query_range?{q}") as r:
    assert json.load(r)["status"] == "success"
srv.stop()
inst.close()
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "greptimedb_tpu",
                                       "pyarrow", "msgpack"))
print("LEAKED", leaked)
"""

_FLOW_WORKLOAD = r"""
import sys, tempfile
from greptimedb_tpu_torch.instance import Standalone
from greptimedb_tpu_torch.servers import influx

root = tempfile.mkdtemp()
inst = Standalone(root, device="cpu")
inst.enable_flows(tick_interval_s=3600)
inst.sql("CREATE TABLE cpu (h STRING PRIMARY KEY, u DOUBLE, "
         "ts TIMESTAMP TIME INDEX)")
inst.sql("CREATE FLOW f SINK TO f_out AS SELECT h, date_bin('1 hour', ts) "
         "AS w, avg(u) AS a, max(u) AS m, stddev_samp(u) AS s, "
         "first_value(u ORDER BY ts) AS fv FROM cpu GROUP BY h, w")
inst.sql("INSERT INTO cpu VALUES ('a', 1.0, 1000), ('b', 2.0, 2000)")
influx.write_lines(inst, "cpu,h=a u=3.5 3000\ncpu,h=b u=4.5 4000\n",
                   precision="ms")
assert inst.flows.maybe_flow("f").device_state is not None
inst.sql("ADMIN flush_flow('f')")
assert inst.sql("SELECT h, a FROM f_out ORDER BY h").rows() == [
    ["a", 2.25], ["b", 3.25]]
inst.close()
inst = Standalone(root, device="cpu")
inst.enable_flows(tick_interval_s=3600)
assert inst.sql("SHOW FLOWS").rows() == [["f"]]
assert inst.flows.failed_applies == inst.flows.failed_ticks == 0
inst.close()
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "greptimedb_tpu",
                                       "pyarrow", "msgpack"))
print("LEAKED", leaked)
"""


_POLL_WORKLOAD = """
import base64, json, sys, tempfile, urllib.request
from greptimedb_tpu_torch.auth import StaticUserProvider
from greptimedb_tpu_torch.instance import Standalone
from greptimedb_tpu_torch.query.result_cache import ResultCache
from greptimedb_tpu_torch.sched import AdmissionController, SchedulerConfig
from greptimedb_tpu_torch.servers.http import HttpServer

inst = Standalone(tempfile.mkdtemp(), device="cpu", prefer_device=True)
inst.result_cache = inst.catalog.result_cache = ResultCache(enabled=True)
inst.scheduler = AdmissionController(SchedulerConfig(max_concurrency=1))
inst.sql("CREATE TABLE cpu (h STRING PRIMARY KEY, u DOUBLE, "
         "ts TIMESTAMP TIME INDEX)")
inst.sql("INSERT INTO cpu VALUES " + ", ".join(
    f"('h{i % 3}', {float(i)}, {i * 1000})" for i in range(60)))
srv = HttpServer(inst, port=0, user_provider=StaticUserProvider(
    {"u": "p"})).start()
q = "SELECT ts, h, avg(u) RANGE '10s' FROM cpu ALIGN '10s' BY (h)"
tok = base64.b64encode(b"u:p").decode()
for since in ("", "&since=30000", "&since=30000"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/v1/sql?sql={q.replace(' ', '+')}"
        + since, data=b"", headers={"Authorization": f"Basic {tok}"})
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.status == 200
        rows = json.load(r)["output"][0]["records"]["rows"]
    assert rows and all(r[0] > 30000 for r in rows) == bool(since)
assert inst.query_engine.last_exec_path == "device"
assert inst.result_cache.hits == 2
srv.stop()
inst.close()
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "greptimedb_tpu",
                                       "pyarrow", "msgpack"))
print("LEAKED", leaked)
"""


_INDEX_WORKLOAD = """
import sys, tempfile
from greptimedb_tpu_torch.index import device_plane
from greptimedb_tpu_torch.instance import Standalone
from greptimedb_tpu_torch.promql.engine import PromEngine

inst = Standalone(tempfile.mkdtemp(), device="cpu", prefer_device=True)
inst.sql("CREATE TABLE logs (host STRING PRIMARY KEY, msg STRING FULLTEXT, "
         "ip STRING, doc STRING, lat DOUBLE, lon DOUBLE, "
         "ts TIMESTAMP TIME INDEX) WITH (append_mode = 'true')")
inst.sql("INSERT INTO logs VALUES " + ", ".join(
    f"('h{i % 3}', 'GET /p{i % 5} error {i}', '10.0.0.{i}', "
    f"'{{\\"a\\": {i}}}', 37.5, -122.1, {i * 1000})" for i in range(60)))
inst.sql("ADMIN flush_table('logs')")
res = inst.sql("SELECT count(*) FROM logs WHERE matches(msg, 'p3 AND error')")
assert res.rows() == [[12]]
res = inst.sql("SELECT json_get_int(doc, '$.a'), ipv4_string_to_num(ip), "
               "geohash(lat, lon, 5) FROM logs WHERE ts = 2000")
assert res.rows()[0][:2] == [2, 167772162]
inst.sql("CREATE TABLE cpu (h STRING PRIMARY KEY, u DOUBLE, "
         "ts TIMESTAMP TIME INDEX)")
inst.sql("INSERT INTO cpu VALUES " + ", ".join(
    f"('h{i % 3}', {float(i)}, {i * 10000})" for i in range(90)))
v, _ = PromEngine(inst).query_range('sum(rate(cpu{h=~"h[12]"}[1m]))',
                                    300_000, 600_000, 60_000)
assert v.num_series == 1 and device_plane.stats()["mask_misses"] == 1
res = inst.sql("SELECT h, sum(u) FROM cpu WHERE h = 'h1' GROUP BY h")
assert res.num_rows == 1
inst.close()
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "greptimedb_tpu",
                                       "pyarrow", "msgpack"))
print("LEAKED", leaked)
"""


def _run_workload(workload):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", workload], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout


def test_port_workload_loads_no_jax():
    _run_workload(_WORKLOAD)


def test_durable_workload_loads_no_jax_pyarrow_or_msgpack():
    """Write, flush, compact and reopen a durable table: the storage path
    loads neither pyarrow nor msgpack (the card machine has neither)."""
    _run_workload(_DURABLE_WORKLOAD)


def test_server_workload_loads_no_jax():
    """DDL, line protocol (the native tokenizer), DELETE, ADMIN, GROUP BY,
    TQL, remote write and the Prometheus API over HTTP: the server path
    loads nothing of JAX, the JAX package, pyarrow or msgpack."""
    _run_workload(_SERVER_WORKLOAD)


def test_flow_workload_loads_no_jax():
    """Flows (CREATE FLOW, INSERT and line protocol deltas on the device
    state, ADMIN flush_flow, a reopen that reloads the flow) load nothing
    of JAX, the JAX package, pyarrow or msgpack."""
    _run_workload(_FLOW_WORKLOAD)


def test_poll_workload_loads_no_jax():
    """The poll path (the result cache, the grid's session and `since`
    delta over HTTP, admission control, basic auth) loads nothing of JAX,
    the JAX package, pyarrow or msgpack."""
    _run_workload(_POLL_WORKLOAD)


def test_index_workload_loads_no_jax():
    """A FULLTEXT log table flushed with its puffin sidecar, matches(),
    the json, geo and net functions, a PromQL matcher through the label
    plane and a pruned GROUP BY load nothing of JAX, the JAX package,
    pyarrow or msgpack."""
    _run_workload(_INDEX_WORKLOAD)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_to_fall_back_without_cuda(no_cuda):
    from greptimedb_tpu_torch.query.executor import QueryEngine
    from greptimedb_tpu_torch.storage.device_merge import merge_rows
    from greptimedb_tpu_torch.storage.memtable import ColumnarRows

    with pytest.raises(RuntimeError, match="CUDA"):
        QueryEngine()
    rows = ColumnarRows(sid=np.zeros(4, np.int32), ts=np.arange(4),
                        seq=np.arange(4, dtype=np.uint64),
                        op=np.zeros(4, np.uint8), fields={})
    with pytest.raises(RuntimeError, match="CUDA"):
        merge_rows(rows)
    # an explicit CPU request runs the plain versions
    out, path = merge_rows(rows, device="cpu")
    assert path == "host" and len(out) == 4


def test_storage_engine_refuses_to_fall_back_without_cuda(no_cuda,
                                                          tmp_path):
    from greptimedb_tpu_torch.storage.engine import EngineConfig, TsdbEngine

    with pytest.raises(RuntimeError, match="CUDA"):
        TsdbEngine(EngineConfig(data_root=str(tmp_path)))
    eng = TsdbEngine(EngineConfig(data_root=str(tmp_path)), device="cpu")
    assert eng.device.type == "cpu"
    eng.close()


def test_instance_refuses_to_fall_back_without_cuda(no_cuda):
    from greptimedb_tpu_torch.instance import Instance

    with pytest.raises(RuntimeError, match="CUDA"):
        Instance()
    with pytest.raises(RuntimeError, match="CUDA"):
        Instance(device="cuda")
    assert Instance(device="cpu").query_engine.device.type == "cpu"


def test_standalone_refuses_to_fall_back_without_cuda(no_cuda, tmp_path):
    from greptimedb_tpu_torch.instance import Standalone

    with pytest.raises(RuntimeError, match="CUDA"):
        Standalone(str(tmp_path / "a"))
    inst = Standalone(str(tmp_path / "b"), device="cpu")
    assert inst.query_engine.device.type == "cpu"
    assert inst.engine.device.type == "cpu"
    inst.close()


def test_device_plane_refuses_to_fall_back_without_cuda(no_cuda):
    import numpy as np

    from greptimedb_tpu_torch.index import device_plane
    from greptimedb_tpu_torch.storage.series import SeriesRegistry

    reg = SeriesRegistry(["h"])
    reg.intern_rows([np.asarray(["a", "b"], object)])
    with pytest.raises(RuntimeError, match="CUDA"):
        device_plane.matcher_mask_dev(reg, [("h", "eq", "a")], 8)


def test_kernel_gate_semantics():
    from greptimedb_tpu_torch.device import kernel_mode, kernels_enabled

    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert kernel_mode(None) == kernel_mode("bogus") == "auto"
    assert kernels_enabled("auto", cuda) and not kernels_enabled("auto", cpu)
    assert kernels_enabled("on", cpu) and kernels_enabled("on", cuda)
    assert not kernels_enabled("off", cuda)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    # in the checkout: no card -> non-zero exit, no result line
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    # alone in a directory, without the package beside it
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
