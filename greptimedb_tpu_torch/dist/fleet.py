"""Who is in the cluster (the standalone branch of the JAX package's
dist/fleet.py): `cluster_nodes(inst)` is the serving process alone, as
`local_node_doc(inst)` describes it. A metasrv's fleet view waits for
ROADMAP A10."""

from __future__ import annotations

import time

from greptimedb_tpu_torch.version import __version__


def local_node_doc(inst) -> dict:
    """The serving process as a cluster_nodes-shaped doc."""
    # the JAX package's node-stats payload (telemetry/node_stats.py) also
    # carries start_ms, uptime_s, regions, wal_backlog_rows,
    # memtable_bytes, sst_count, sst_bytes, compaction_backlog,
    # mem_host_bytes, mem_device_bytes, device_live_bytes,
    # ingest_rows_total, queries_total and flows; they wait for ROADMAP
    # A9, and readers take the default of a missing stat (0, 0.0)
    stats = {
        "role": getattr(inst, "node_role", "standalone"),
        "addr": getattr(inst, "node_addr", "") or "",
        "version": __version__,
    }
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
