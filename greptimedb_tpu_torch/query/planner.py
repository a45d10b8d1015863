"""RANGE plan dataclasses (the fields of the JAX package's SelectPlan that
device_range and result assembly read) and the replicate-vs-shard planner.

SQL text is not part of this slice: a plan is either built directly or
copied with `plan_from_fields` from any object shaped like a JAX
SelectPlan (attribute access only — nothing of the JAX package is
imported). Expressions reduce to column references; any other expression
is kept as an `Unported` marker, and the executor raises UnsupportedError
naming it.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field


@dataclass(frozen=True)
class Column:
    """A column reference (the only expression this slice evaluates)."""

    name: str


@dataclass(frozen=True)
class Unported:
    """An expression shape the port does not evaluate yet."""

    text: str


@dataclass
class ScanSpec:
    ts_min: int | None = None
    ts_max: int | None = None
    matchers: list = dc_field(default_factory=list)
    residual: object = None


@dataclass
class KeySpec:
    key: str                      # internal column name "__key_i"
    expr: object
    name: str                     # output display name


@dataclass
class RangeItemSpec:
    key: str
    op: str
    arg: object                   # Column, Unported or None (count(*))
    range_ms: int
    fill: str | None = None       # per-item fill override


@dataclass
class SelectPlan:
    kind: str                     # only "range" executes in this slice
    scan: ScanSpec = dc_field(default_factory=ScanSpec)
    keys: list[KeySpec] = dc_field(default_factory=list)
    range_items: list[RangeItemSpec] = dc_field(default_factory=list)
    post_items: list = dc_field(default_factory=list)   # (expr, name)
    having: object = None
    order_by: list = dc_field(default_factory=list)
    limit: int | None = None
    offset: int | None = None
    distinct: bool = False
    align_ms: int | None = None
    align_to: int = 0
    fill: str | None = None
    ts_out_name: str | None = None
    grid_ts_min: int | None = None
    grid_ts_max: int | None = None


# ----------------------------------------------------------------------
# replicate-vs-shard planning (copied from the JAX package's planner)
#
# Small grids replicate (one device: launch and hop latency dominate);
# large decomposable reductions shard the series axis across the mesh.
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class MeshDecision:
    mode: str            # "shard" | "replicate"
    reason: str          # why (no mesh, mesh geometry, grid size)
    devices: int = 1     # shard-axis devices the query will use
    # program variant of a sharded execution: "ring" when the ring
    # kernels carry the cross-shard combine (parallel/kernels/ring_fold.
    # RingFoldCtx), "gather" for the gather-and-left-fold twin
    # (parallel/dist.ShardFoldCtx)
    kernel: str = "gather"
    kernel_reason: str = ""

    @property
    def shard(self) -> bool:
        return self.mode == "shard"

    def label(self) -> str:
        return f"{self.mode}({self.reason})"

    def kernel_label(self) -> str:
        return f"{self.kernel}({self.kernel_reason})"


def decide_mesh_execution(mesh, *, kind: str = "range", series: int,
                          opts=None) -> MeshDecision:
    """Choose replicate vs shard for one grid of `series` rows (the JAX
    package's gate for the grid kinds: "range" for the RANGE grid,
    "promql" for the PromQL selector grid). Every op the port lowers to a
    grid folds exactly across shards (device_range._DEVICE_RANGE_OPS and
    ops/promql's aggregations), so the JAX gate's non-decomposable-op
    branch has no counterpart here."""
    from greptimedb_tpu_torch.parallel.mesh import (
        FOLD_BLOCKS, MeshOptions, shard_count,
    )

    if kind not in ("range", "promql"):
        raise ValueError(f"unknown grid kind: {kind}")
    n_dev = shard_count(mesh)
    if mesh is None or n_dev <= 1:
        return MeshDecision("replicate", "no_mesh")
    opts = opts or MeshOptions()
    if FOLD_BLOCKS % n_dev != 0:
        # blocked exact folds need the shard count to divide the fixed
        # block count; other geometries run replicated (still correct)
        return MeshDecision("replicate", "mesh_indivisible", devices=n_dev)
    if series < max(opts.shard_min_series, 1):
        return MeshDecision("replicate", "small_grid", devices=n_dev)
    kernel, kreason = decide_kernel(kind, series=series, opts=opts,
                                    device=mesh.devices[0])
    return MeshDecision("shard", "large_grid", devices=n_dev,
                        kernel=kernel, kernel_reason=kreason)


def decide_kernel(kind: str = "range", *, series: int, k: int | None = None,
                  opts=None, device=None) -> tuple[str, str]:
    """Choose the program variant of one sharded grid: "ring" runs the
    ring kernels (ring_fold's for "range"/"promql", topk_merge's for
    "topk"), "gather" the gather twin. "auto" means kernels for CUDA
    tensors (device.kernels_enabled), where the JAX package's means the
    native TPU backend. `k` caps the topk merge kernel (O(k^2) rank
    comparisons per hop)."""
    from greptimedb_tpu_torch.device import kernel_mode, kernels_enabled
    from greptimedb_tpu_torch.parallel.mesh import MeshOptions

    opts = opts or MeshOptions()
    mode = kernel_mode(opts.pallas_kernels)
    if mode == "off":
        return "gather", "kernels_off"
    if not kernels_enabled(mode, "cpu" if device is None else device):
        return "gather", "no_cuda"
    if k is not None and k > max(opts.pallas_max_k, 1):
        return "gather", "k_too_large"
    if series < max(opts.pallas_min_series, 1):
        return "gather", "small_grid"
    return "ring", ("ring_topk" if kind == "topk" or k is not None
                    else "ring_fold")


def convert_expr(e):
    """A port expression from any expression object: objects of a class
    named Column with a `name` become Column; None stays None; anything
    else becomes Unported."""
    if e is None or isinstance(e, (Column, Unported)):
        return e
    if type(e).__name__ == "Column" and isinstance(getattr(e, "name", None),
                                                   str):
        return Column(e.name)
    return Unported(repr(e))


def plan_from_fields(obj) -> SelectPlan:
    """Copy a SelectPlan-shaped object's fields into a port plan."""
    s = obj.scan
    return SelectPlan(
        kind=obj.kind,
        scan=ScanSpec(
            ts_min=s.ts_min, ts_max=s.ts_max,
            matchers=list(getattr(s, "matchers", []) or []),
            residual=(None if getattr(s, "residual", None) is None
                      else convert_expr(s.residual)),
        ),
        keys=[KeySpec(k.key, convert_expr(k.expr), k.name)
              for k in getattr(obj, "keys", [])],
        range_items=[
            RangeItemSpec(key=r.key, op=r.op, arg=convert_expr(r.arg),
                          range_ms=int(r.range_ms), fill=r.fill)
            for r in getattr(obj, "range_items", [])
        ],
        post_items=[(convert_expr(e), name)
                    for e, name in getattr(obj, "post_items", [])],
        having=(None if getattr(obj, "having", None) is None
                else convert_expr(obj.having)),
        order_by=list(getattr(obj, "order_by", []) or []),
        limit=getattr(obj, "limit", None),
        offset=getattr(obj, "offset", None),
        distinct=bool(getattr(obj, "distinct", False)),
        align_ms=getattr(obj, "align_ms", None),
        align_to=int(getattr(obj, "align_to", 0) or 0),
        fill=getattr(obj, "fill", None),
        ts_out_name=getattr(obj, "ts_out_name", None),
        grid_ts_min=getattr(obj, "grid_ts_min", None),
        grid_ts_max=getattr(obj, "grid_ts_max", None),
    )
