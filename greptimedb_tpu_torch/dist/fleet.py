"""Who is in the cluster (the standalone branch of the JAX package's
dist/fleet.py): `cluster_nodes(inst)` is the serving process alone, as
`local_node_doc(inst)` describes it. A metasrv's fleet view waits for
ROADMAP A10."""

from __future__ import annotations

import time


def local_node_doc(inst) -> dict:
    """The serving process as a cluster_nodes-shaped doc."""
    from greptimedb_tpu_torch.telemetry import node_stats as _ns

    stats = _ns.build_node_stats(inst)
    return {
        "node_id": getattr(inst, "node_id", 0) or 0,
        "role": stats["role"],
        "addr": stats["addr"],
        # the node assembled this answer: alive
        "status": "ALIVE",
        "phi": 0.0,
        "last_heartbeat_ms": time.time() * 1000,
        "region_count": stats.get("regions", 0),
        "stats": stats,
        "local": True,
    }


def cluster_nodes(inst) -> list[dict]:
    """Every known fleet member: on a standalone, its one local doc."""
    return [local_node_doc(inst)]
