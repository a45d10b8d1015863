"""information_schema and the pg_catalog shims (the JAX package's
information_schema.py).

Each system table is a provider: a function of the instance that returns
its columns as {name: list}, built on demand from the catalog, the flows
and the version. `_query_system_doc` types each column from its first
value (bool, int64, float64, else object) and runs the SELECT through the
query engine's plain and aggregate paths, so WHERE, GROUP BY, ORDER BY
and LIMIT work on them, and a join reads them as frames.

Tables of one region each: `partitions`, `region_statistics` and
`region_peers` list that region. The tables the telemetry fills
(`runtime_metrics`, `slow_queries`, `traces`, `memory_pools`,
`statement_statistics`, `device_programs`, `autotune_*`) raise
UnsupportedError naming ROADMAP A9; the cluster fan-out tables
(`cluster_*`) name A10.
"""

from __future__ import annotations

import zlib

import numpy as np

from greptimedb_tpu_torch.errors import TableNotFoundError, UnsupportedError
from greptimedb_tpu_torch.query.executor import Col, DictSource, QueryResult
from greptimedb_tpu_torch.query.expr import eval_expr
from greptimedb_tpu_torch.query.planner import plan_select
from greptimedb_tpu_torch.sql import ast as A
from greptimedb_tpu_torch.version import __version__


def _region_ssts(region) -> list:
    """The SSTs of a region (an in-memory region has none)."""
    if region.manifest is None:
        return []
    return region.manifest.state.ssts


def _region_rows(region) -> int:
    """Rows held: the memtable's and the SSTs' (an in-memory region's
    compacted runs in place of SSTs)."""
    if region.manifest is None:
        return region.rows
    return region.memtable.rows + sum(m.rows for m in _region_ssts(region))


def _tables_doc(inst) -> dict[str, list]:
    rows = {
        "table_catalog": [], "table_schema": [], "table_name": [],
        "table_type": [], "table_id": [], "engine": [], "region_count": [],
    }
    for db in inst.catalog.database_names():
        for name in inst.catalog.table_names(db):
            t = inst.catalog.table(db, name)
            rows["table_catalog"].append("greptime")
            rows["table_schema"].append(db)
            rows["table_name"].append(name)
            rows["table_type"].append("BASE TABLE")
            rows["table_id"].append(t.info.table_id)
            rows["engine"].append(t.info.engine)
            rows["region_count"].append(t.info.num_regions)
    return rows


def _columns_doc(inst) -> dict[str, list]:
    rows = {
        "table_catalog": [], "table_schema": [], "table_name": [],
        "column_name": [], "data_type": [], "semantic_type": [],
        "is_nullable": [],
    }
    for db in inst.catalog.database_names():
        for name in inst.catalog.table_names(db):
            t = inst.catalog.table(db, name)
            for c in t.schema.columns:
                rows["table_catalog"].append("greptime")
                rows["table_schema"].append(db)
                rows["table_name"].append(name)
                rows["column_name"].append(c.name)
                rows["data_type"].append(c.data_type.name)
                rows["semantic_type"].append(
                    "TIMESTAMP" if c.is_time_index
                    else ("TAG" if c.is_tag else "FIELD"))
                rows["is_nullable"].append("Yes" if c.nullable else "No")
    return rows


def _region_statistics_doc(inst) -> dict[str, list]:
    rows = {
        "region_id": [], "table_id": [], "region_rows": [],
        "memtable_size": [], "sst_size": [], "sst_num": [],
    }
    for t in inst.catalog.all_tables():
        for r in t.regions:
            ssts = _region_ssts(r)
            rows["region_id"].append(r.meta.region_id)
            rows["table_id"].append(t.info.table_id)
            rows["region_rows"].append(_region_rows(r))
            rows["memtable_size"].append(r.memtable.bytes)
            rows["sst_size"].append(sum(m.size_bytes for m in ssts))
            rows["sst_num"].append(len(ssts))
    return rows


def _schemata_doc(inst) -> dict[str, list]:
    names = inst.catalog.database_names()
    return {"catalog_name": ["greptime"] * len(names), "schema_name": names}


def _flows_doc(inst) -> dict[str, list]:
    rows = {"flow_name": [], "source_table": [], "sink_table": [],
            "processed_rows": []}
    if inst.flows is not None:
        for f in inst.flows.flow_infos():
            rows["flow_name"].append(f["name"])
            rows["source_table"].append(f["source_table"])
            rows["sink_table"].append(f["sink_table"])
            rows["processed_rows"].append(f["processed_rows"])
    return rows


def _views_doc(inst) -> dict[str, list]:
    rows = {"table_catalog": [], "table_schema": [], "table_name": [],
            "view_definition": []}
    for db in inst.catalog.database_names():
        for name in inst.catalog.view_names(db):
            rows["table_catalog"].append("greptime")
            rows["table_schema"].append(db)
            rows["table_name"].append(name)
            rows["view_definition"].append(
                inst.catalog.maybe_view(db, name) or "")
    return rows


def _key_column_usage_doc(inst) -> dict[str, list]:
    rows = {"constraint_catalog": [], "constraint_schema": [],
            "constraint_name": [], "table_catalog": [],
            "table_schema": [], "table_name": [], "column_name": [],
            "ordinal_position": []}
    for db in inst.catalog.database_names():
        for name in inst.catalog.table_names(db):
            t = inst.catalog.table(db, name)
            pos = {"PRIMARY": 0, "TIME INDEX": 0}  # 1-based per constraint
            for c in t.schema.columns:
                if not (c.is_tag or c.is_time_index):
                    continue
                cname = "TIME INDEX" if c.is_time_index else "PRIMARY"
                pos[cname] += 1
                rows["constraint_catalog"].append("def")
                rows["constraint_schema"].append(db)
                rows["constraint_name"].append(cname)
                rows["table_catalog"].append("def")
                rows["table_schema"].append(db)
                rows["table_name"].append(name)
                rows["column_name"].append(c.name)
                rows["ordinal_position"].append(pos[cname])
    return rows


def _table_constraints_doc(inst) -> dict[str, list]:
    rows = {"constraint_catalog": [], "constraint_schema": [],
            "constraint_name": [], "table_schema": [], "table_name": [],
            "constraint_type": []}
    for db in inst.catalog.database_names():
        for name in inst.catalog.table_names(db):
            t = inst.catalog.table(db, name)
            for cname, ctype in (("TIME INDEX", "TIME INDEX"),
                                 ("PRIMARY", "PRIMARY KEY")):
                if cname == "PRIMARY" and not t.tag_names:
                    continue
                rows["constraint_catalog"].append("def")
                rows["constraint_schema"].append(db)
                rows["constraint_name"].append(cname)
                rows["table_schema"].append(db)
                rows["table_name"].append(name)
                rows["constraint_type"].append(ctype)
    return rows


def _partitions_doc(inst) -> dict[str, list]:
    # one region a table, and no partition rule (ROADMAP A10): one
    # partition each, with an empty expression
    rows = {"table_catalog": [], "table_schema": [], "table_name": [],
            "partition_name": [], "partition_expression": [],
            "greptime_partition_id": []}
    for db in inst.catalog.database_names():
        for name in inst.catalog.table_names(db):
            t = inst.catalog.table(db, name)
            for i, r in enumerate(t.regions):
                rows["table_catalog"].append("greptime")
                rows["table_schema"].append(db)
                rows["table_name"].append(name)
                rows["partition_name"].append(f"p{i}")
                rows["partition_expression"].append("")
                rows["greptime_partition_id"].append(r.meta.region_id)
    return rows


def _region_peers_doc(inst) -> dict[str, list]:
    """Every region is local: this process is its peer, and its own
    writability is its state."""
    rows = {"region_id": [], "table_id": [], "peer_id": [],
            "peer_addr": [], "is_leader": [], "status": []}
    local_id = int(getattr(inst, "node_id", 0) or 0)
    local_addr = getattr(inst, "node_addr", "") or ""
    for t in inst.catalog.all_tables():
        for r in t.regions:
            rows["region_id"].append(r.meta.region_id)
            rows["table_id"].append(t.info.table_id)
            rows["peer_id"].append(local_id)
            rows["peer_addr"].append(local_addr)
            rows["is_leader"].append("Yes")
            rows["status"].append(
                "ALIVE" if getattr(r, "writable", True) else "DOWNGRADED")
    return rows


def _cluster_info_doc(inst) -> dict[str, list]:
    """One row per fleet member: the local process, on a standalone."""
    from greptimedb_tpu_torch.dist import fleet

    rows = {"peer_id": [], "peer_type": [], "peer_addr": [],
            "version": [], "git_commit": [], "start_time_ms": [],
            "uptime_s": [], "active_time": [], "status": []}
    nodes = fleet.cluster_nodes(inst)
    standalone = len(nodes) == 1 and nodes[0].get("role") == "standalone"
    for node in nodes:
        st = node.get("stats") or {}
        rows["peer_id"].append(int(node.get("node_id", 0)))
        rows["peer_type"].append(
            "STANDALONE" if standalone
            else str(node.get("role", "")).upper())
        rows["peer_addr"].append(str(node.get("addr", "") or ""))
        rows["version"].append(str(st.get("version") or __version__))
        rows["git_commit"].append("")
        rows["start_time_ms"].append(int(st.get("start_ms", 0) or 0))
        rows["uptime_s"].append(float(st.get("uptime_s", 0.0) or 0.0))
        rows["active_time"].append(
            str(int(node.get("last_heartbeat_ms") or 0)))
        rows["status"].append(str(node.get("status", "UNKNOWN")))
    return rows


def _procedure_info_doc(inst) -> dict[str, list]:
    rows = {"procedure_id": [], "procedure_type": [], "status": [],
            "error": []}
    pm = getattr(inst, "procedure_manager", None)
    if pm is not None:
        for m in pm.list_procedures():
            rows["procedure_id"].append(m.proc_id)
            rows["procedure_type"].append(m.type_name)
            rows["status"].append(m.state)
            rows["error"].append(m.error or "")
    return rows


def _engines_doc(inst) -> dict[str, list]:
    names = ["tsdb", "metric", "file"]
    comments = [
        "TPU-native LSM time-series engine (mito analog)",
        "logical metric tables over the tsdb engine",
        "external tables over CSV/JSON/Parquet files",
    ]
    return {
        "engine": names,
        "support": ["DEFAULT", "YES", "YES"],
        "comment": comments,
        "transactions": ["NO"] * 3,
        "xa": ["NO"] * 3,
        "savepoints": ["NO"] * 3,
    }


def _build_info_doc(inst) -> dict[str, list]:
    return {
        "git_branch": [""], "git_commit": [""],
        "git_commit_short": [""], "git_clean": ["true"],
        "pkg_version": [__version__],
    }


def _character_sets_doc(inst) -> dict[str, list]:
    return {
        "character_set_name": ["utf8"],
        "default_collate_name": ["utf8_bin"],
        "description": ["UTF-8 Unicode"],
        "maxlen": [4],
    }


def _collations_doc(inst) -> dict[str, list]:
    return {
        "collation_name": ["utf8_bin"],
        "character_set_name": ["utf8"],
        "id": [1],
        "is_default": ["Yes"],
        "is_compiled": ["Yes"],
        "sortlen": [1],
    }


_PROVIDERS = {
    "tables": _tables_doc,
    "columns": _columns_doc,
    "region_statistics": _region_statistics_doc,
    "schemata": _schemata_doc,
    "flows": _flows_doc,
    "views": _views_doc,
    "key_column_usage": _key_column_usage_doc,
    "table_constraints": _table_constraints_doc,
    "partitions": _partitions_doc,
    "region_peers": _region_peers_doc,
    "cluster_info": _cluster_info_doc,
    "procedure_info": _procedure_info_doc,
    "engines": _engines_doc,
    "build_info": _build_info_doc,
    "character_sets": _character_sets_doc,
    "collations": _collations_doc,
}

# the system tables that wait, and the ROADMAP item that ports them:
# the telemetry's (A9) and the cluster fan-out's (A10)
WAITING_TABLES = {
    "runtime_metrics": "A9", "slow_queries": "A9", "traces": "A9",
    "memory_pools": "A9", "statement_statistics": "A9",
    "device_programs": "A9", "autotune_decisions": "A9",
    "autotune_knobs": "A9", "cluster_node_stats": "A10",
    "cluster_runtime_metrics": "A10",
    "cluster_statement_statistics": "A10",
    "cluster_device_programs": "A10", "cluster_memory_pools": "A10",
}


# ----------------------------------------------------------------------
# pg_catalog shims: the tables psql's \d and \dt and ORM introspection
# read. OIDs are stable per name (crc32, masked positive) except
# pg_type's, which are the wire protocol's type OIDs.
# ----------------------------------------------------------------------

def _pg_oid(name: str) -> int:
    return (zlib.crc32(name.encode()) & 0x7FFFFFFF) or 1


def _pg_namespace_doc(inst) -> dict[str, list]:
    rows = {"oid": [], "nspname": []}
    for db in ["pg_catalog", "information_schema",
               *inst.catalog.database_names()]:
        rows["oid"].append(_pg_oid(f"ns:{db}"))
        rows["nspname"].append(db)
    return rows


def _pg_class_doc(inst) -> dict[str, list]:
    rows = {"oid": [], "relname": [], "relnamespace": [], "relkind": [],
            "relowner": []}
    for db in inst.catalog.database_names():
        ns = _pg_oid(f"ns:{db}")
        for name in inst.catalog.table_names(db):
            rows["oid"].append(_pg_oid(f"rel:{db}.{name}"))
            rows["relname"].append(name)
            rows["relnamespace"].append(ns)
            rows["relkind"].append("r")
            rows["relowner"].append(10)
        for vname in inst.catalog.view_names(db):
            rows["oid"].append(_pg_oid(f"rel:{db}.{vname}"))
            rows["relname"].append(vname)
            rows["relnamespace"].append(ns)
            rows["relkind"].append("v")
            rows["relowner"].append(10)
    return rows


def _pg_database_doc(inst) -> dict[str, list]:
    rows = {"oid": [], "datname": []}
    for db in inst.catalog.database_names():
        rows["oid"].append(_pg_oid(f"db:{db}"))
        rows["datname"].append(db)
    return rows


def _pg_type_doc(inst) -> dict[str, list]:
    from greptimedb_tpu_torch.servers.postgres import PG_TYPES

    return {
        "oid": [oid for _n, oid, _l in PG_TYPES],
        "typname": [n for n, _o, _l in PG_TYPES],
        "typlen": [ln for _n, _o, ln in PG_TYPES],
    }


PG_CATALOG_TABLES = frozenset(
    {"pg_namespace", "pg_class", "pg_database", "pg_type"})
_PG_PROVIDERS = {
    "pg_namespace": _pg_namespace_doc,
    "pg_class": _pg_class_doc,
    "pg_database": _pg_database_doc,
    "pg_type": _pg_type_doc,
}


def _bare_name(stmt: A.Select) -> str:
    name = stmt.from_table
    if "." in name:
        name = name.split(".", 1)[1]
    return name.lower()


def query_pg_catalog(inst, stmt: A.Select, ctx) -> QueryResult:
    name = _bare_name(stmt)
    provider = _PG_PROVIDERS.get(name)
    if provider is None:
        raise TableNotFoundError(f"pg_catalog.{name}")
    return _query_system_doc(inst, stmt, provider(inst))


def query_information_schema(inst, stmt: A.Select, ctx) -> QueryResult:
    name = _bare_name(stmt)
    item = WAITING_TABLES.get(name)
    if item is not None:
        raise UnsupportedError(f"information_schema.{name} is not ported "
                               f"yet (ROADMAP {item})")
    provider = _PROVIDERS.get(name)
    if provider is None:
        raise TableNotFoundError(f"information_schema.{name}")
    return _query_system_doc(inst, stmt, provider(inst))


def _query_system_doc(inst, stmt: A.Select, doc) -> QueryResult:
    cols = {}
    n = len(next(iter(doc.values()))) if doc else 0
    for k, vals in doc.items():
        if vals and isinstance(vals[0], bool):
            cols[k] = Col(np.asarray(vals, bool))
        elif vals and isinstance(vals[0], (int, np.integer)):
            cols[k] = Col(np.asarray(vals, np.int64))
        elif vals and isinstance(vals[0], (float, np.floating)):
            cols[k] = Col(np.asarray(vals, np.float64))
        else:
            cols[k] = Col(np.asarray(vals, object))
    src = DictSource(cols, n)

    plan = plan_select(stmt, ts_name=None, tag_names=[],
                       all_columns=list(doc.keys()))
    if plan.kind == "range":
        raise UnsupportedError("RANGE over system tables is not supported")
    if plan.scan.residual is not None and n:
        cond = eval_expr(plan.scan.residual, src)
        mask = cond.values.astype(bool) & cond.valid_mask
        cols = {
            k: Col(c.values[mask],
                   None if c.validity is None else c.validity[mask])
            for k, c in cols.items()
        }
        src = DictSource(cols, int(mask.sum()))
    # system tables run through the engine's ordinary paths: aggregates,
    # window functions, DISTINCT/ORDER/LIMIT included
    if plan.kind == "aggregate":
        return inst.query_engine._execute_aggregate(plan, src, None)
    return inst.query_engine._execute_plain(plan, src, None)
