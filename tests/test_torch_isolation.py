"""The PyTorch port stands alone: it imports neither jax nor anything of the
JAX package, and its entry points never fall back to the CPU silently."""

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


def _foreign(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "greptimedb_tpu")


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
                if m.split(".")[0] in ("jax", "jaxlib", "greptimedb_tpu"))
print("LEAKED", leaked)
"""


def test_port_workload_loads_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", _WORKLOAD], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout


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


def test_instance_refuses_to_fall_back_without_cuda(no_cuda):
    from greptimedb_tpu_torch.instance import Instance

    with pytest.raises(RuntimeError, match="CUDA"):
        Instance()
    with pytest.raises(RuntimeError, match="CUDA"):
        Instance(device="cuda")
    assert Instance(device="cpu").query_engine.device.type == "cpu"


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
