"""Query mesh: the devices the series axis of a large grid shards over.

A `Mesh` is a list of shard devices along AXIS_SHARD. A list may name one
card several times: each shard's grid rows are then separate tensors on
that card, and every ring hop (`tensor.to(next_shard_device)`) is a no-op;
across cards the same hop is a peer copy. The replicate-vs-shard decision
per query lives in query/planner.py (decide_mesh_execution).

The process-wide mesh (configure/global_mesh) is the one the sites
without an engine mesh in reach read, as in the JAX package: SQL window
functions shard ROWS k PRECEDING frames over its shard count
(query/window_fns.py), every shard on the engine's device. Built with
`MeshOptions(enabled=True, axis_size=N)` it holds N shards on one card.
The time axis of the JAX package's (shard, time) mesh (time_parallel,
halo_exchange_prev) is not ported yet (ROADMAP A5).
"""

from __future__ import annotations

import threading
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
    """The `[mesh]` knobs the range, GROUP BY and window paths read (the
    JAX package's MeshOptions fields of the same names)."""

    enabled: bool = False           # configure() builds a mesh at all
    # shards of the process-wide mesh, all on configure's device;
    # 0 = one shard per visible CUDA card
    axis_size: int = 0
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


# ----------------------------------------------------------------------
# process-wide mesh
# ----------------------------------------------------------------------

_state_lock = threading.Lock()
_global_mesh: Mesh | None = None
_global_opts: MeshOptions | None = None
_configured = False


def configure(opts: MeshOptions, device=None) -> Mesh | None:
    """Build (once) and return the process-wide query mesh, or None when
    disabled or when it would hold one shard. `opts.axis_size` shards all
    on `device` (default CUDA), or with axis_size 0 one shard per visible
    CUDA card. The first configuration wins until reset_for_tests."""
    global _global_mesh, _global_opts, _configured
    with _state_lock:
        if _configured:
            return _global_mesh
        _configured = True
        _global_opts = opts
        if not opts.enabled:
            return None
        if opts.axis_size:
            devices = [resolve_device(device)] * opts.axis_size
        else:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        if len(devices) <= 1:
            return None
        _global_mesh = Mesh(devices)
        from greptimedb_tpu_torch.telemetry.metrics import global_registry

        global_registry.gauge(
            "gtpu_mesh_devices",
            "Devices in the process-wide query mesh (shard axis)",
        ).set(len(devices))
        return _global_mesh


def global_mesh() -> Mesh | None:
    """The process-wide mesh, or None when not configured/enabled."""
    with _state_lock:
        return _global_mesh


def global_mesh_opts() -> MeshOptions | None:
    """The MeshOptions configure() ran with, or None before configure.
    Sites without an engine in reach (query/window_fns.py) use this so
    the operator's `[mesh]` thresholds apply everywhere."""
    with _state_lock:
        return _global_opts


def reset_for_tests() -> None:
    """Drop the process-wide mesh so tests can reconfigure."""
    global _global_mesh, _global_opts, _configured
    with _state_lock:
        _global_mesh = None
        _global_opts = None
        _configured = False
