"""Per-node telemetry payloads for the fleet observability plane.

Two local-only builders live here (no network I/O — gtlint GT019
enforces that the scrape/heartbeat paths can never hang a node):

- `build_node_stats(inst)` — the compact node-stats document every role
  (datanode / flownode / frontend / standalone) attaches to its metasrv
  heartbeat: role, addr, version, uptime, region count, WAL/compaction
  backlog, memory-pool bytes per tier (the memory accountant), ingest +
  query rate counters and resident device bytes. The metasrv keeps a
  bounded per-node ring of these samples next to its phi-accrual
  verdict (meta/metasrv.py), and `information_schema.cluster_node_stats`
  is the SQL face of that ring.

- `deep_health(inst)` — the `/health?deep=1` readiness probe: per-role
  checks (engine open, WAL/data dir appendable, object store reachable,
  device dispatch OK, metasrv heartbeat fresh), each timed and isolated
  so one failing subsystem degrades the verdict instead of erroring the
  probe. `/v1/cluster/health` aggregates this JSON across the fleet.
"""

from __future__ import annotations

import logging
import os
import time

from greptimedb_tpu_torch.version import __version__

_log = logging.getLogger("greptimedb_tpu_torch.telemetry.node_stats")

# process birth, pinned at import: uptime is monotonic-derived (GT011 —
# wall clock is for data timestamps, not intervals); start_ms is the
# epoch-ms constructor form for display
_START_MONOTONIC = time.monotonic()
_START_EPOCH_MS = int(time.time() * 1000)


def process_uptime_s() -> float:
    return time.monotonic() - _START_MONOTONIC


def _registry_total(name: str) -> float:
    """Sum of every label child of a registered counter/gauge; 0.0 when
    the owning module has not registered it yet (role never imported
    it). Pure in-process reads — never blocks."""
    from greptimedb_tpu_torch.telemetry.metrics import global_registry

    try:
        metric = global_registry.get(name)
    except KeyError:
        return 0.0
    return float(sum(c.value for _k, c in metric._snapshot()))


def build_node_stats(inst) -> dict:
    """The heartbeat-carried node-stats payload. Compact (one small
    JSON object), cheap (in-memory registry/accountant reads only) and
    bounded (no network, no device sync) — it rides EVERY heartbeat."""
    from greptimedb_tpu_torch.telemetry import memory as _memory

    role = getattr(inst, "node_role", "standalone")
    doc = {
        "role": role,
        "addr": getattr(inst, "node_addr", "") or "",
        "version": __version__,
        "start_ms": _START_EPOCH_MS,
        "uptime_s": round(process_uptime_s(), 3),
        "regions": 0,
        "wal_backlog_rows": 0,
        "memtable_bytes": 0,
        "sst_count": 0,
        "sst_bytes": 0,
        "compaction_backlog": 0,
        "mem_host_bytes": 0,
        "mem_device_bytes": 0,
        "device_live_bytes": 0,
        "ingest_rows_total": 0.0,
        "queries_total": 0.0,
        "flows": 0,
    }
    engine = getattr(inst, "engine", None)
    if engine is not None:
        try:
            regions = engine.regions()
            doc["regions"] = len(regions)
            # rows still only in the memtable = what a restart would
            # replay from the WAL; manifest state is in memory
            doc["wal_backlog_rows"] = int(
                sum(r.memtable.rows for r in regions)
            )
            doc["memtable_bytes"] = int(
                sum(r.memtable.bytes for r in regions)
            )
            doc["sst_count"] = int(
                sum(len(r.manifest.state.ssts) for r in regions)
            )
            doc["sst_bytes"] = int(sum(
                m.size_bytes for r in regions
                for m in r.manifest.state.ssts
            ))
        except Exception as e:  # noqa: BLE001 - engine mid-teardown:
            # the payload ships partial rather than failing liveness
            _log.debug("node-stats engine read failed: %s", e)
    acct = _memory.global_accountant
    try:
        for st in acct.snapshot():
            if st.tier == "device":
                doc["mem_device_bytes"] += int(st.bytes)
            else:
                doc["mem_host_bytes"] += int(st.bytes)
            if st.name == "compaction":
                # in-flight merge jobs on the bounded scheduler pool
                doc["compaction_backlog"] = int(st.entries)
        doc["device_live_bytes"] = int(acct.device_bytes_cached())
    except Exception as e:  # noqa: BLE001 - accountant is advisory here
        _log.debug("node-stats accountant read failed: %s", e)
    # rate counters: whichever of the role's surfaces registered them
    doc["ingest_rows_total"] = (
        _registry_total("gtpu_ingest_rows_total")
        + _registry_total("greptime_servers_ingest_rows_total")
    )
    doc["queries_total"] = _registry_total("gtpu_sched_admitted_total")
    flows = getattr(inst, "flows", None)
    if flows is not None:
        try:
            doc["flows"] = len(flows.flow_infos())
        except Exception as e:  # noqa: BLE001 - flows mid-teardown
            _log.debug("node-stats flow read failed: %s", e)
    return doc


# ----------------------------------------------------------------------
# deep health
# ----------------------------------------------------------------------

# device dispatch probe result is cached: the readiness probe may be
# polled aggressively and a dispatch per poll would be waste
_DEVICE_PROBE_TTL_S = 60.0
_device_probe: tuple[float, bool, str] = (-1e18, False, "never ran")


def _check(fn) -> dict:
    t0 = time.perf_counter()
    try:
        ok, detail = fn()
    except Exception as e:  # noqa: BLE001 - a probe failure IS the result
        ok, detail = False, f"{type(e).__name__}: {e}"
    out = {"ok": bool(ok),
           "ms": round((time.perf_counter() - t0) * 1000.0, 2)}
    if detail:
        out["detail"] = str(detail)
    return out


def _probe_device() -> tuple[bool, str]:
    global _device_probe
    now = time.monotonic()
    ts, ok, detail = _device_probe
    if now - ts <= _DEVICE_PROBE_TTL_S:
        return ok, detail
    try:
        import torch

        if not torch.cuda.is_available():
            ok, detail = True, "cpu"
        else:
            n = torch.cuda.device_count()
            v = torch.ones(1, device="cuda") + 1
            ok = float(v.item()) == 2.0
            detail = f"{n} device(s)"
    except Exception as e:  # noqa: BLE001 - no backend / poisoned chip
        ok, detail = False, f"{type(e).__name__}: {e}"
    _device_probe = (now, ok, detail)
    return ok, detail


def deep_health(inst) -> dict:
    """Per-role readiness: every check runs (one failure never hides
    another), each is timed, and the aggregate verdict is `ok` only
    when all of them pass. Local probes only — the fleet aggregation
    (`/v1/cluster/health`) fans this out with its own bounds."""
    role = getattr(inst, "node_role", "standalone")
    checks: dict[str, dict] = {}

    engine = getattr(inst, "engine", None)
    if engine is not None:
        def engine_open():
            regions = engine.regions()
            return True, f"{len(regions)} region(s) open"

        checks["engine"] = _check(engine_open)

        def data_appendable():
            # a real (tiny) write probe: WAL segments and manifests
            # live under data_root, so an unwritable/full volume fails
            # here before it fails an ingest
            root = engine.config.data_root
            os.makedirs(root, exist_ok=True)
            probe = os.path.join(root, ".health_probe")
            with open(probe, "w") as f:
                f.write("ok")
            os.remove(probe)
            return True, root

        checks["wal_appendable"] = _check(data_appendable)

        store = getattr(engine, "store", None)
        if store is not None:
            def store_reachable():
                # bounded metadata round trip against the object store
                # (the recovery/compaction read path dies first when
                # this is broken)
                store.exists("__health_probe__")
                return True, type(store).__name__

            checks["object_store"] = _check(store_reachable)

    checks["device"] = _check(_probe_device)

    meta = getattr(inst, "meta", None)
    if meta is not None:
        # dist roles: the metasrv lease/heartbeat channel. The
        # heartbeat loop stamps its last success (fleet.start_heartbeat)
        # — a fresh stamp proves the channel without a network probe;
        # without one (no loop running) probe the metasrv directly,
        # bounded by the MetaClient timeout.
        def metasrv_held():
            at = getattr(inst, "fleet_heartbeat_at", None)
            if at is not None:
                from greptimedb_tpu_torch.dist import fleet

                # freshness bound scales with the CONFIGURED cadence
                # (a 15s heartbeat interval must not read as degraded
                # between perfectly healthy beats)
                bound = max(
                    10.0,
                    3.0 * fleet.config()["heartbeat_interval_s"],
                )
                age = time.monotonic() - at
                return age < bound, f"last heartbeat {age:.1f}s ago"
            meta._get("/health")
            return True, "metasrv reachable"

        checks["metasrv_lease"] = _check(metasrv_held)

    flows = getattr(inst, "flows", None)
    if flows is not None:
        def flows_live():
            return True, f"{len(flows.flow_infos())} flow(s)"

        checks["flows"] = _check(flows_live)

    ok = all(c["ok"] for c in checks.values())
    return {
        "status": "ok" if ok else "degraded",
        "role": role,
        "addr": getattr(inst, "node_addr", "") or "",
        "version": __version__,
        "uptime_s": round(process_uptime_s(), 3),
        "checks": checks,
    }
