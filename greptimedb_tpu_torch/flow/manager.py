"""Continuous aggregation (flow) engine (the JAX package's
flow/manager.py on torch).

- inserts into a flow's source table (INSERT, line protocol, remote write)
  are mirrored to the flow as columnar deltas;
- each flow keeps accumulable per-group state (count/sum/min/max/...),
  on the Standalone's device when every aggregate has a dense form
  (flow/device_state.py: the grouped reduce G folds each delta), else in
  host accumulators (count_distinct, string arguments, and a flow demoted
  by negative timestamps or non-numeric input);
- a tick finalizes dirty groups and upserts them into the sink table
  through the normal write path: the storage engine's last-write-wins
  dedup makes writeback idempotent;
- EXPIRE AFTER drops state (and emission) for windows older than the
  horizon.

A delta or a tick that raises is printed and counted (`failed_applies`,
`failed_ticks`), never turned into a demotion: a user's write is not
refused for its flow, and a caller that must see every failure reads the
counts.
"""

from __future__ import annotations

import json
import logging

import time

import numpy as np

from greptimedb_tpu_torch import concurrency
from greptimedb_tpu_torch.datatypes.schema import (
    ColumnSchema,
    Schema,
    SemanticType,
)
from greptimedb_tpu_torch.datatypes.types import ConcreteDataType
from greptimedb_tpu_torch.errors import (
    FlowAlreadyExistsError,
    FlowNotFoundError,
    PlanError,
    UnsupportedError,
)
from greptimedb_tpu_torch.flow import device_state as DS
from greptimedb_tpu_torch.query.executor import Col, DictSource
from greptimedb_tpu_torch.query.expr import (
    collect_columns,
    eval_expr,
    format_expr,
)
from greptimedb_tpu_torch.query.planner import plan_select
from greptimedb_tpu_torch.sql import ast as A
from greptimedb_tpu_torch.sql.parser import parse_sql

_log = logging.getLogger("greptimedb_tpu_torch.flow.manager")

FLOWS_PATH = "meta/flows.json"

_ACC_OPS = {"count", "count_distinct", "sum", "mean", "min", "max",
            "first_value", "last_value", "var_pop", "var_samp",
            "stddev_pop", "stddev_samp"}


class _GroupState:
    """Accumulable state for one group: per agg spec a small dict."""

    __slots__ = ("accs", "dirty")

    def __init__(self, n_aggs: int):
        self.accs = [None] * n_aggs
        self.dirty = True


class Flow:
    def __init__(self, name: str, stmt: A.CreateFlow, source_table: str,
                 db: str):
        self.name = name
        self.db = db
        self.stmt = stmt
        self.source_table = source_table
        self.sink_table = stmt.sink_table
        self.expire_after_s = stmt.expire_after_s
        self.comment = stmt.comment
        self.processed_rows = 0
        self.state: dict[tuple, _GroupState] = {}
        self.lock = concurrency.Lock()
        # serializes whole flushes: ADMIN flush_flow must not return
        # while a concurrent tick-flush still holds this flow's dirty
        # snapshot mid-emit (the sink would materialize only later)
        self.flush_lock = concurrency.Lock()
        self.plan = None          # lazily planned against the source schema
        self.device_state = None  # DeviceFlowState when the plan allows
        self.last_tick_ms = 0
        # restart recovery pending: state must re-derive from the source
        # before deltas may apply (deltas while set are ALSO in the
        # source, so the eventual backfill covers them)
        self.needs_backfill = False
        # a delta was skipped while a backfill scan was running: its row
        # may postdate the scan snapshot, so the backfill must re-run.
        # backfill_gate makes the skip-vs-clear handoff atomic without
        # blocking inserts behind the (long) scan itself.
        self.missed_during_backfill = False
        self.backfill_gate = concurrency.Lock()

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "db": self.db,
            "source_table": self.source_table,
            "sink_table": self.sink_table,
            "expire_after_s": self.expire_after_s,
            "comment": self.comment,
            "raw_sql": self.raw_sql,
        }


def _source_of(stmt: A.CreateFlow) -> str:
    q = stmt.query
    if not q.from_table:
        raise PlanError("flow query must read FROM a source table")
    return q.from_table.split(".")[-1]


class FlowManager:
    """Hosts all flows in-process (the Standalone's flownode role)."""

    def __init__(self, instance, *, tick_interval_s: float | None = None):
        import uuid

        self.instance = instance
        self.tick_interval_s = (
            1.0 if tick_interval_s is None else tick_interval_s
        )
        # process incarnation: frontends compare this to detect a
        # restart (state was re-derived from source; stale mirror
        # backlogs must be dropped, not replayed)
        self.epoch = uuid.uuid4().hex
        self._flows: dict[str, Flow] = {}
        self._by_source: dict[str, list[Flow]] = {}
        self._lock = concurrency.RLock()
        self._stop = concurrency.Event()
        # deltas and ticks that raised (printed, and counted here), and
        # the tick thread's passes
        self.failed_applies = 0
        self.failed_ticks = 0
        self.ticks = 0
        self._load()
        # the ticker is a manager-lifetime daemon
        self._ticker = concurrency.Thread(
            target=self._tick_loop, daemon=True, name="flow-ticker",
        )
        self._ticker.start()

    # ------------------------------------------------------------------
    # DDL
    # ------------------------------------------------------------------
    def create_flow(self, stmt: A.CreateFlow, ctx) -> Flow:
        with self._lock:
            if stmt.name in self._flows:
                if stmt.if_not_exists:
                    return self._flows[stmt.name]
                raise FlowAlreadyExistsError(
                    f"flow already exists: {stmt.name}"
                )
            source = _source_of(stmt)
            db = getattr(ctx, "database", "public")
            # validate source exists + plan is an aggregate
            table = self.instance.catalog.table(db, source)
            flow = Flow(stmt.name, stmt, source, db)
            flow.raw_sql = _render_flow_sql(stmt)
            self._plan_flow(flow, table)
            self._flows[stmt.name] = flow
            self._by_source.setdefault(source, []).append(flow)
            self._persist()
            return flow

    def drop_flow(self, name: str, *, if_exists: bool = False):
        with self._lock:
            flow = self._flows.pop(name, None)
            if flow is None:
                if if_exists:
                    return
                raise FlowNotFoundError(f"flow not found: {name}")
            self._by_source.get(flow.source_table, []).remove(flow)
            self._persist()

    def flush_flow(self, name: str) -> bool:
        """Flush ONE flow's accumulated state into its sink (ADMIN
        flush_flow)."""
        with self._lock:
            flow = self._flows.get(name)
        if flow is None:
            raise FlowNotFoundError(f"flow not found: {name}")
        self._flush_flow(flow)
        return True

    def flow_names(self) -> list[str]:
        with self._lock:
            return sorted(self._flows)

    def maybe_flow(self, name: str) -> "Flow | None":
        with self._lock:
            return self._flows.get(name)

    def flow_sources(self) -> list[tuple[str, str]]:
        """(db, source_table) pairs that feed some flow — what a
        frontend needs to decide which inserts to mirror."""
        with self._lock:
            return sorted({
                (f.db, f.source_table) for f in self._flows.values()
            })

    def flow_infos(self) -> list[dict]:
        with self._lock:
            return [
                {
                    "name": f.name,
                    "source_table": f.source_table,
                    "sink_table": f.sink_table,
                    "processed_rows": f.processed_rows,
                }
                for f in self._flows.values()
            ]

    def stop(self):
        self._stop.set()
        self._ticker.join(timeout=5)
        self.flush_all()

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------
    def _persist(self):
        doc = [f.to_json() for f in self._flows.values()]
        self.instance.engine.store.write(
            FLOWS_PATH, json.dumps(doc).encode()
        )

    def _load(self):
        store = self.instance.engine.store
        if not store.exists(FLOWS_PATH):
            return
        for doc in json.loads(store.read(FLOWS_PATH)):
            try:
                stmts = parse_sql(doc["raw_sql"])
                stmt = stmts[0]
                flow = Flow(doc["name"], stmt, doc["source_table"],
                            doc.get("db", "public"))
                flow.raw_sql = doc["raw_sql"]
                table = self.instance.catalog.maybe_table(
                    flow.db, flow.source_table
                )
                # crash recovery: accumulated state died with the
                # process — re-derive it from the DURABLE source rows
                # (mirror backlogs covering these rows are dropped by
                # the frontend on epoch change). Source unreachable or
                # not yet visible => retry from the tick loop; deltas
                # are skipped until the backfill lands.
                flow.needs_backfill = True
                if table is not None:
                    self._plan_flow(flow, table)
                    try:
                        self._backfill(flow, table)
                        flow.needs_backfill = False
                    except Exception as e:  # noqa: BLE001
                        # needs_backfill stays set; the tick loop
                        # retries once the source is reachable
                        _log.info("backfill of flow %s deferred: %s",
                                  flow.name, e)
                self._flows[flow.name] = flow
                self._by_source.setdefault(
                    flow.source_table, []
                ).append(flow)
            except Exception:
                import traceback

                traceback.print_exc()

    def _backfill(self, flow: Flow, table):
        data = table.scan()
        rows = data.rows
        if rows is None or len(rows) == 0:
            return
        reg = data.registry
        cols: dict = {table.ts_name: rows.ts}
        for t in table.tag_names:
            cols[t] = reg.tag_values(t)[rows.sid]
        valid: dict = {}
        for f, arr in rows.fields.items():
            cols[f] = arr
            if rows.field_valid and f in rows.field_valid:
                valid[f] = rows.field_valid[f]
        self._apply_delta(flow, table, cols, valid)

    # ------------------------------------------------------------------
    # planning
    # ------------------------------------------------------------------
    def _plan_flow(self, flow: Flow, table):
        plan = plan_select(
            flow.stmt.query,
            ts_name=table.ts_name,
            tag_names=table.tag_names,
            all_columns=table.schema.column_names,
        )
        if plan.kind != "aggregate":
            raise UnsupportedError(
                "flows support aggregate queries (GROUP BY) only"
            )
        for a in plan.aggs:
            if a.op not in _ACC_OPS:
                raise UnsupportedError(
                    f"aggregate {a.op} is not accumulable in a flow"
                )
        # which key expr is the time window (date_bin/date_trunc on ts)?
        flow.time_key_idx = None
        for i, k in enumerate(plan.keys):
            if _is_time_bucket(k.expr, table.ts_name):
                flow.time_key_idx = i
                break
        flow.source_ts_name = table.ts_name
        # accumulators with a dense-array form keep their state on the
        # query engine's device (flow/device_state.py, float64 slots in
        # x64 mode); set/string state stays on the host path
        qe = self.instance.query_engine

        def _string_arg(a) -> bool:
            if a.arg is None or not isinstance(a.arg, A.Column):
                return False
            cs = table.schema.maybe_column(a.arg.name)
            return cs is not None and cs.data_type.is_string()

        flow.device_state = (
            DS.DeviceFlowState(plan, time_key_idx=flow.time_key_idx,
                               device=qe.device, x64=qe.x64)
            if DS.plan_supports_device(plan)
            and not any(_string_arg(a) for a in plan.aggs)
            else None
        )
        # published LAST: _apply_delta's unlocked fast path keys off it
        flow.plan = plan

    # ------------------------------------------------------------------
    # ingest (mirrored inserts)
    # ------------------------------------------------------------------
    def on_insert(self, db: str, table_name: str, table, data: dict,
                  valid: dict):
        flows = self._by_source.get(table_name)
        if not flows:
            return
        for flow in flows:
            if flow.db != db:
                continue
            with flow.backfill_gate:
                if flow.needs_backfill:
                    # state not re-derived yet: this delta's rows are
                    # durable in the source, so the pending backfill
                    # covers them — applying now would double-count.
                    # Mark the skip (under the gate) so a backfill
                    # racing this delta re-runs: the row may postdate
                    # its scan snapshot.
                    flow.missed_during_backfill = True
                    continue
            try:
                self._apply_delta(flow, table, data, valid or {})
            except Exception:
                import traceback

                with self._lock:
                    self.failed_applies += 1
                traceback.print_exc()

    def _apply_delta(self, flow: Flow, table, data: dict, valid: dict):
        from greptimedb_tpu_torch.telemetry import tracing

        # joins the triggering insert's trace; tick-driven backfills
        # carry no trace and skip the span
        with tracing.child_span("flow.eval", flow=flow.name):
            self._apply_delta_traced(flow, table, data, valid)

    def _apply_delta_traced(self, flow: Flow, table, data: dict,
                            valid: dict):
        if flow.plan is None:
            with flow.lock:
                # concurrent first inserts must not each build a plan +
                # device state (the loser's rows would be orphaned)
                if flow.plan is None:
                    self._plan_flow(flow, table)
        plan = flow.plan
        n = len(next(iter(data.values())))
        if n == 0:
            return
        cols = {}
        for k, v in data.items():
            vv = valid.get(k)
            cols[k] = Col(np.asarray(v),
                          None if vv is None or vv.all() else vv)
        src = DictSource(cols, n)

        mask = np.ones(n, bool)
        if plan.scan.residual is not None:
            cond = eval_expr(plan.scan.residual, src)
            mask &= cond.values.astype(bool) & cond.valid_mask
        # tag matchers from the WHERE clause apply to raw columns here
        for mname, op, value in plan.scan.matchers:
            c = cols.get(mname)
            if c is None:
                mask[:] = False
                break
            vals = c.values.astype(str)
            if op == "eq":
                mask &= vals == value
            elif op == "ne":
                mask &= vals != value
            elif op == "in":
                mask &= np.isin(vals, list(value))
            elif op == "nin":
                mask &= ~np.isin(vals, list(value))
            elif op in ("re", "nre"):
                hit = np.asarray(
                    [bool(value.fullmatch(s)) for s in vals]
                )
                mask &= hit if op == "re" else ~hit
        ts_col = cols.get(flow.source_ts_name)
        if ts_col is None:
            return
        ts = ts_col.values.astype(np.int64)
        if plan.scan.ts_min is not None:
            mask &= ts >= plan.scan.ts_min
        if plan.scan.ts_max is not None:
            mask &= ts <= plan.scan.ts_max
        if flow.expire_after_s is not None:
            horizon = int(time.time() * 1000) - flow.expire_after_s * 1000
            mask &= ts >= horizon
        if not mask.any():
            return

        key_vals = []
        for k in plan.keys:
            kv = eval_expr(k.expr, src)
            key_vals.append(kv.values)
        agg_args = []
        for a in plan.aggs:
            if a.arg is None:
                agg_args.append((None, None))
            else:
                c = eval_expr(a.arg, src)
                agg_args.append((c.values, c.validity))

        idxs = np.nonzero(mask)[0]
        ds = flow.device_state
        if ds is not None and len(idxs) and int(ts[idxs].min()) < 0:
            # device ts encoding assumes epoch >= 0
            self._demote_flow(flow)
            ds = None
        if ds is not None:
            key_cols = [np.asarray(kv, object)[idxs] for kv in key_vals]
            try:
                arg_sub = [
                    (None if vals is None
                     else np.asarray(vals[idxs], np.float64),
                     None if validity is None else validity[idxs])
                    for vals, validity in agg_args
                ]
            except (ValueError, TypeError):
                # non-numeric aggregate input: this flow is host-only
                self._demote_flow(flow)
            else:
                applied = False
                with flow.lock:
                    # a concurrent batch may have demoted the flow since
                    # ds was read; only apply if it is still live
                    if flow.device_state is ds:
                        gids = ds.intern_keys(key_cols, len(idxs))
                        ds.apply(gids, ts[idxs], arg_sub)
                        flow.processed_rows += len(idxs)
                        applied = True
                if applied:
                    return
        with flow.lock:
            flow.processed_rows += len(idxs)
            state = flow.state
            for i in idxs:
                key = tuple(
                    kv[i].item() if isinstance(kv[i], np.generic) else kv[i]
                    for kv in key_vals
                )
                gs = state.get(key)
                if gs is None:
                    gs = _GroupState(len(plan.aggs))
                    state[key] = gs
                gs.dirty = True
                for j, a in enumerate(plan.aggs):
                    vals, validity = agg_args[j]
                    v = None
                    if vals is not None:
                        if validity is not None and not validity[i]:
                            continue
                        v = float(vals[i]) if not isinstance(
                            vals[i], str
                        ) else vals[i]
                    gs.accs[j] = _accumulate(
                        a.op, gs.accs[j], v, int(ts[i])
                    )

    # ------------------------------------------------------------------
    # tick / writeback
    # ------------------------------------------------------------------
    def _tick_loop(self):
        while not self._stop.wait(self.tick_interval_s):
            try:
                self.flush_all()
            except Exception:
                import traceback

                with self._lock:
                    self.failed_ticks += 1
                traceback.print_exc()
            self.ticks += 1

    def flush_all(self):
        with self._lock:
            flows = list(self._flows.values())
        for flow in flows:
            if flow.needs_backfill:
                # restart recovery: keep retrying the source re-derive
                # until the datanodes are reachable. State resets before
                # every attempt (a failed attempt may have half-applied
                # the scan), and the pass re-runs if a mirror delta was
                # skipped mid-scan — its row may postdate the snapshot.
                # NOT under flow.lock: _backfill -> _apply_delta takes
                # it internally (non-reentrant). Concurrent deltas are
                # excluded by the needs_backfill gate, and this tick
                # thread is the only backfill runner.
                try:
                    table = self.instance.catalog.maybe_table(
                        flow.db, flow.source_table
                    )
                    if table is None:
                        continue
                    if flow.plan is None:
                        with flow.lock:
                            if flow.plan is None:
                                self._plan_flow(flow, table)
                    clean = False
                    for _attempt in range(3):
                        flow.state = {}
                        flow.device_state = None
                        flow.missed_during_backfill = False
                        self._backfill(flow, table)
                        with flow.backfill_gate:
                            if not flow.missed_during_backfill:
                                # atomically open the delta gate: any
                                # delta that marked a miss did so under
                                # this gate and is visible here
                                flow.needs_backfill = False
                                clean = True
                        if clean:
                            break
                    # 3 missed passes (continuous ingest): keep the
                    # flag set — the freshly scanned state flushes
                    # below and the next tick rescans until a pass
                    # completes without a concurrent delta
                except Exception:
                    continue
            try:
                self._flush_flow(flow)
            except Exception:
                import traceback

                with self._lock:
                    self.failed_ticks += 1
                traceback.print_exc()

    def _demote_flow(self, flow: Flow):
        """Move a flow's device state back to host accumulators (input
        the device encoding can't represent: the flow keeps running on
        the host path with nothing lost)."""
        with flow.lock:
            ds = flow.device_state
            flow.device_state = None
            if ds is None or flow.plan is None:
                return
            rows, dirty = ds.export_host_accs()
            for gid, key in enumerate(ds.key_rows()):
                gs = flow.state.get(key)
                if gs is None:
                    gs = _GroupState(len(flow.plan.aggs))
                    flow.state[key] = gs
                gs.accs = rows[gid]
                gs.dirty = bool(dirty[gid]) or gs.dirty

    def _expire_horizon(self, flow: Flow):
        return int(time.time() * 1000) - flow.expire_after_s * 1000

    def _emit_groups(self, flow: Flow, key_rows, per_agg):
        """Finalized groups -> post-projection -> sink write. key_rows is
        a list of key tuples; per_agg a list of (values, present) arrays
        aligned with plan.aggs."""
        plan = flow.plan
        g = len(key_rows)
        out_cols: dict[str, Col] = {}
        for i, k in enumerate(plan.keys):
            vals = [key[i] for key in key_rows]
            arr = np.asarray(vals, object) if isinstance(
                vals[0], str
            ) else np.asarray(vals)
            out_cols[k.key] = Col(arr)
        for j, a in enumerate(plan.aggs):
            vals, present = per_agg[j]
            out_cols[a.key] = Col(
                vals, None if present.all() else present
            )
        gsrc = DictSource(out_cols, g)
        names = [nm for _, nm in plan.post_items]
        results = [eval_expr(e, gsrc) for e, _ in plan.post_items]
        self._write_sink(flow, names, results, out_cols)

    def _flush_flow(self, flow: Flow):
        if flow.plan is None:
            return
        # flush_lock covers the whole flush INCLUDING the sink write:
        # ADMIN flush_flow must not return while a tick-flush still holds
        # this flow's dirty snapshot mid-emit. Only other flushers of the
        # SAME flow ever wait here; inserts take flow.lock, which is
        # released before the sink write
        with flow.flush_lock:
            self._flush_flow_locked(flow)

    def _flush_flow_locked(self, flow: Flow):
        ds = flow.device_state
        if ds is not None and self._flush_flow_device(flow, ds):
            return
        plan = flow.plan
        with flow.lock:
            dirty = [
                (key, gs) for key, gs in flow.state.items() if gs.dirty
            ]
            for _, gs in dirty:
                gs.dirty = False
            if flow.expire_after_s is not None and flow.time_key_idx is not None:
                horizon = self._expire_horizon(flow)
                expired = [
                    k for k in flow.state
                    if isinstance(k[flow.time_key_idx], (int, float))
                    and k[flow.time_key_idx] < horizon
                ]
                for k in expired:
                    del flow.state[k]
        if not dirty:
            return
        g = len(dirty)
        per_agg = []
        for j, a in enumerate(plan.aggs):
            vals = np.zeros(g)
            present = np.zeros(g, bool)
            for gi, (_, gs) in enumerate(dirty):
                out = _finalize(a.op, gs.accs[j])
                if out is not None:
                    vals[gi] = out
                    present[gi] = True
            per_agg.append((vals, present))
        try:
            self._emit_groups(flow, [key for key, _ in dirty], per_agg)
        except Exception:
            # keep the updates flushable: re-mark the groups dirty
            with flow.lock:
                for key, gs in dirty:
                    if key in flow.state:
                        gs.dirty = True
            raise

    def _flush_flow_device(self, flow: Flow, ds) -> bool:
        """Device-state tick: one finalize program over every group with
        a device-side dirty gather, then writeback of the dirty slice.
        Expiry compacts only after a successful write so the failure
        path's gids stay valid. Returns False (caller runs the host
        flush) if a concurrent batch demoted the flow."""
        with flow.lock:
            if flow.device_state is not ds:
                return False
            snap = ds.snapshot_dirty()
            dirty_gids = snap[2] if snap else np.zeros(0, np.int64)
            keys = [ds.key_rows()[i] for i in dirty_gids]
        if len(dirty_gids):
            # the state tuple in snap is never written in place; the
            # finalize and the readback run here without stalling ingest
            _, per_agg = ds.finalize_snapshot(snap)
            try:
                self._emit_groups(
                    flow, keys,
                    [per_agg[j] for j in range(len(flow.plan.aggs))],
                )
            except Exception:
                with flow.lock:
                    if flow.device_state is ds:
                        ds.dirty[dirty_gids] = True
                    else:
                        # demoted mid-emit: re-dirty the host groups
                        for k in keys:
                            gs = flow.state.get(k)
                            if gs is not None:
                                gs.dirty = True
                raise
        if flow.expire_after_s is not None and \
                flow.time_key_idx is not None:
            with flow.lock:
                if flow.device_state is ds:
                    ds.expire_older_than(self._expire_horizon(flow))
        return True

    def _write_sink(self, flow: Flow, names, results, out_cols):
        sink = self.instance.catalog.maybe_table(flow.db, flow.sink_table)
        if sink is None:
            sink = self._create_sink(flow, names, results)
        n = len(results[0]) if results else 0
        tags = {}
        fields = {}
        fvalid = {}
        ts = None
        now_ms = int(time.time() * 1000)
        for nm, col in zip(names, results):
            cs = sink.schema.maybe_column(nm)
            if cs is None:
                continue
            if cs.is_time_index:
                ts = col.values.astype(np.int64)
            elif cs.is_tag:
                tags[nm] = np.asarray(
                    ["" if v is None else str(v) for v in col.values], object
                )
            else:
                fields[nm] = col.values
                if col.validity is not None:
                    fvalid[nm] = col.validity
        if ts is None:
            # placeholder time index (constant 0): writeback must UPSERT
            # per group key via last-write-wins dedup, never append
            ts = np.zeros(n, np.int64)
        if "update_at" in sink.schema:
            fields["update_at"] = np.full(n, now_ms, np.int64)
        sink.write(tags, ts, fields, field_valid=fvalid or None)

    def _create_sink(self, flow: Flow, names, results):
        """Auto-create the sink table: time-bucket key -> TIME INDEX,
        string keys -> TAGs, aggregates -> FIELDs."""
        plan = flow.plan
        cols = []
        have_ts = False
        key_outs = set()
        for i, k in enumerate(plan.keys):
            for (e, nm) in plan.post_items:
                if isinstance(e, A.Column) and e.name == k.key:
                    key_outs.add(nm)
                    if i == flow.time_key_idx and not have_ts:
                        cols.append(ColumnSchema(
                            nm, ConcreteDataType.timestamp_millisecond(),
                            SemanticType.TIMESTAMP, nullable=False,
                        ))
                        have_ts = True
                    else:
                        cols.append(ColumnSchema(
                            nm, ConcreteDataType.string(),
                            SemanticType.TAG,
                        ))
                    break
        for (e, nm), col in zip(plan.post_items, results):
            if nm in key_outs:
                continue
            dt = (ConcreteDataType.string()
                  if col.values.dtype == object
                  else ConcreteDataType.float64())
            cols.append(ColumnSchema(nm, dt, SemanticType.FIELD))
        if not have_ts:
            # non-windowed flow: constant-0 placeholder TIME INDEX makes
            # writeback an upsert; update_at (a FIELD) carries freshness
            cols.append(ColumnSchema(
                "update_at", ConcreteDataType.timestamp_millisecond(),
                SemanticType.FIELD,
            ))
            cols.append(ColumnSchema(
                "__ts_placeholder",
                ConcreteDataType.timestamp_millisecond(),
                SemanticType.TIMESTAMP, nullable=False,
            ))
        return self.instance.catalog.create_table(
            flow.db, flow.sink_table, Schema(cols), if_not_exists=True,
        )


# ----------------------------------------------------------------------
# host accumulators
# ----------------------------------------------------------------------

def _accumulate(op: str, acc, v, ts: int):
    if op == "count":
        return (acc or 0) + 1
    if op == "count_distinct":
        s = acc if acc is not None else set()
        s.add(v)
        return s
    if v is None:
        return acc
    if op == "sum":
        return (acc or 0.0) + v
    if op == "mean":
        s, n = acc if acc is not None else (0.0, 0)
        return (s + v, n + 1)
    if op == "min":
        return v if acc is None else min(acc, v)
    if op == "max":
        return v if acc is None else max(acc, v)
    if op in ("var_pop", "var_samp", "stddev_pop", "stddev_samp"):
        s, s2, n = acc if acc is not None else (0.0, 0.0, 0)
        return (s + v, s2 + v * v, n + 1)
    if op == "last_value":
        if acc is None or ts >= acc[1]:
            return (v, ts)
        return acc
    if op == "first_value":
        if acc is None or ts < acc[1]:
            return (v, ts)
        return acc
    raise UnsupportedError(op)


def _finalize(op: str, acc):
    if acc is None:
        return 0 if op in ("count", "count_distinct") else None
    if op == "count":
        return acc
    if op == "count_distinct":
        return len(acc)
    if op == "sum":
        return acc
    if op == "mean":
        s, n = acc
        return s / max(n, 1)
    if op in ("min", "max"):
        return acc
    if op in ("var_pop", "var_samp", "stddev_pop", "stddev_samp"):
        s, s2, n = acc
        ddof = 1 if op.endswith("_samp") else 0
        if n <= ddof:
            return None
        mean = s / n
        var = max(s2 / n - mean * mean, 0.0) * (n / (n - ddof))
        return var ** 0.5 if op.startswith("stddev") else var
    if op in ("first_value", "last_value"):
        return acc[0]
    raise UnsupportedError(op)


def _is_time_bucket(e: A.Expr, ts_name: str) -> bool:
    if isinstance(e, A.FuncCall) and e.name in ("date_bin", "date_trunc"):
        return ts_name in collect_columns(e)
    if isinstance(e, A.Column) and e.name == ts_name:
        return True
    return False


def _render_flow_sql(stmt: A.CreateFlow) -> str:
    """Re-render CREATE FLOW for persistence/forwarding (the original
    text is not kept by the parser). IF NOT EXISTS renders only when
    the statement had it — a forwarded duplicate-name CREATE must still
    raise on the flownode."""
    ine = "IF NOT EXISTS " if stmt.if_not_exists else ""
    parts = [f"CREATE FLOW {ine}{stmt.name} SINK TO "
             f"{stmt.sink_table}"]
    if stmt.expire_after_s is not None:
        parts.append(f"EXPIRE AFTER '{stmt.expire_after_s}s'")
    if stmt.comment:
        parts.append(f"COMMENT '{stmt.comment}'")
    parts.append("AS " + _render_select(stmt.query))
    return " ".join(parts)


def _render_select(q: A.Select) -> str:
    items = ", ".join(
        format_expr(it.expr) + (f" AS {it.alias}" if it.alias else "")
        for it in q.items
    )
    out = f"SELECT {items}"
    if q.from_table:
        out += f" FROM {q.from_table}"
    if q.where is not None:
        out += f" WHERE {format_expr(q.where)}"
    if q.group_by:
        out += " GROUP BY " + ", ".join(format_expr(g) for g in q.group_by)
    if q.having is not None:
        out += f" HAVING {format_expr(q.having)}"
    return out
