"""Query mesh: the devices the series axis of a large grid shards over.

A `Mesh` is a list of shard devices along AXIS_SHARD. A list may name one
card several times: each shard's grid rows are then separate tensors on
that card, and every ring hop (`tensor.to(next_shard_device)`) is a no-op;
across cards the same hop is a peer copy. The replicate-vs-shard decision
per query lives in query/planner.py (decide_mesh_execution).

The time axis of the JAX package's (shard, time) mesh belongs to the
window-function slice, and the process-wide mesh (configure/global_mesh)
to the instance slice; this module holds neither yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from greptimedb_tpu_torch.device import resolve_device

AXIS_SHARD = "shard"   # series axis (region/data parallel analog)

# Series-axis block count of the exact blocked group fold. Block
# boundaries are part of the numeric contract: per-block f32 partials are
# combined in one fixed left-fold order, so results agree bit for bit with
# the JAX package and across mesh sizes 1/2/4/8.
FOLD_BLOCKS = 8


@dataclass(frozen=True)
class MeshOptions:
    """The `[mesh]` knobs the range and GROUP BY paths read (the JAX
    package's MeshOptions fields of the same names)."""

    shard_min_series: int = 4096    # grids below this replicate
    shard_min_rows: int = 262144    # row paths: rows below this replicate
    # ring-fold kernels: auto = CUDA tensors only; on = everywhere (the
    # plain versions stand in on the CPU); off = never (gather twin)
    pallas_kernels: str = "auto"
    pallas_min_series: int = 4096   # kernel grid paths below this gather
    pallas_min_rows: int = 262144   # kernel row paths below this gather
    pallas_max_k: int = 128         # the topk merge kernel is O(k^2) a hop


class Mesh:
    """The shard-axis device list; `shape` maps AXIS_SHARD to its size,
    as a jax Mesh's shape does."""

    def __init__(self, devices):
        self.devices = [resolve_device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.shape = {AXIS_SHARD: len(self.devices)}

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(devices: list | None = None) -> Mesh:
    """A series-sharded mesh over `devices` (default: every visible CUDA
    card). Naming one card n times gives n shards on that card."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return Mesh(devices)


def shard_count(mesh) -> int:
    """Shard-axis size of a mesh (1 when mesh is None)."""
    return 1 if mesh is None else int(mesh.shape[AXIS_SHARD])
