"""The telemetry (metrics, tracing, the device-program registry and the
statement hooks) of the port against the JAX package's, on the CPU.

- Metrics: the same seeded sequence of counter, gauge and histogram
  operations renders byte-identical exposition text in both packages, and
  the same re-registrations raise MetricRegistrationError.
- `traceparent`: the same headers parse to the same ids (or to a fresh
  root on both).
- The device-program registry folds the same dispatch sequence into the
  same rows; on the card its execute times come from CUDA events, folded
  once the end event has completed (a stand-in event shows the deferral
  here).
- One Standalone sequence (CREATE, INSERT, Q1, Q2, a GROUP BY, a PromQL
  query, a `since` poll, a kill and a slow query) through the JAX
  package's Standalone and the port's (device="cpu"), in a fresh spawned
  process so that the process-wide registries hold the sequence alone:
  statement rows,
  /metrics families, event counts, program sites and calls, memory pools
  and span names are compared. Timings are compared by kind (present, a
  number), never by value. The stated differences, each named where it
  is asserted:
  - C7: the port's range prelude reads its four int32 bounds back through
    query/readback.py, so they count in readback_full_bytes (16 bytes a
    prelude run); the JAX package converts them with int() outside its
    counter;
  - families and pools of modules the port has not yet (the autotuner,
    ROADMAP A12; the distributed partial results, A10; the JAX package's
    warm-start precompile pass, which the port has no counterpart of);
  - the JAX catalog opens a new table's region through the engine's
    batch open (a `recovery.open_regions` span), the port's through
    `open_region` alone.
"""

import numpy as np
import pytest

import greptimedb_tpu.telemetry as jax_tel
from greptimedb_tpu.instance import Standalone as JaxStandalone
from greptimedb_tpu.session import QueryContext as JaxCtx
from greptimedb_tpu.telemetry import device_programs as jax_dp
from greptimedb_tpu.telemetry import memory as jax_mem
from greptimedb_tpu.telemetry import metrics as jax_metrics
from greptimedb_tpu.telemetry import stmt_stats as jax_ss
from greptimedb_tpu.telemetry import tracing as jax_tr
import greptimedb_tpu_torch.telemetry as tel
from greptimedb_tpu_torch.instance import Standalone
from greptimedb_tpu_torch.session import QueryContext
from greptimedb_tpu_torch.telemetry import device_programs as dp
from greptimedb_tpu_torch.telemetry import memory as mem
from greptimedb_tpu_torch.telemetry import metrics
from greptimedb_tpu_torch.telemetry import stmt_stats as ss
from greptimedb_tpu_torch.telemetry import tracing as tr

SEED = 22


# ----------------------------------------------------------------------
# metrics
# ----------------------------------------------------------------------

def _ops(seed: int) -> list:
    """A seeded sequence of registry operations (names carry no
    gtpu_/greptime_ prefix: these families exist in this test only)."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(60):
        kind = ("counter", "gauge", "histogram")[int(rng.integers(3))]
        name = f"parity_{kind}_{int(rng.integers(4))}"
        labels = tuple(f"l{j}" for j in range(int(rng.integers(3))))
        vals = tuple(f"v{int(rng.integers(3))}" for _ in labels)
        x = float(np.round(rng.random() * 10 ** int(rng.integers(-3, 3)),
                           6))
        ops.append((kind, name, labels, vals, x, int(rng.integers(3))))
    return ops


def _apply(module, ops) -> str:
    reg = module.MetricsRegistry()
    for kind, name, labels, vals, x, sub in ops:
        try:
            fam = getattr(reg, kind)(name, f"help {name}", labels)
        except module.MetricRegistrationError:
            continue
        child = fam.labels(*vals)
        if kind == "counter":
            child.inc(x)
        elif kind == "gauge":
            (child.set, child.inc, child.dec)[sub](x)
        else:
            child.observe(x)
    return reg.render()


@pytest.mark.parametrize("seed", range(6))
def test_exposition_is_byte_identical(seed):
    ops = _ops(SEED + seed)
    assert _apply(metrics, ops) == _apply(jax_metrics, ops)


@pytest.mark.parametrize("first,second", [
    (("counter", ("a",)), ("gauge", ("a",))),
    (("counter", ("a",)), ("counter", ("b",))),
    (("gauge", ()), ("histogram", ())),
    (("histogram", ("a", "b")), ("histogram", ("b", "a"))),
    (("counter", ()), ("counter", ())),
])
def test_reregistration_raises_alike(first, second):
    raised = []
    for module in (metrics, jax_metrics):
        reg = module.MetricsRegistry()
        getattr(reg, first[0])("parity_x", "h", first[1])
        try:
            getattr(reg, second[0])("parity_x", "h", second[1])
            raised.append(None)
        except module.MetricRegistrationError as e:
            raised.append(str(e))
    assert raised[0] == raised[1]


def test_bucket_quantiles_match():
    rng = np.random.default_rng(SEED)
    bounds = (0.1, 1.0, 10.0, 100.0)
    a, b = [0] * 5, [0] * 5
    for v in rng.exponential(5.0, 500):
        metrics.observe_bucket(a, bounds, float(v))
        jax_metrics.observe_bucket(b, bounds, float(v))
    assert a == b
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert (metrics.bucket_quantile(a, bounds, q)
                == jax_metrics.bucket_quantile(b, bounds, q))


# ----------------------------------------------------------------------
# tracing
# ----------------------------------------------------------------------

TRACEPARENTS = [
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-00",
    " 00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01 ",
    "00-4BF92F3577B34DA6A3CE929D0E0E4736-00F067AA0BA902B7-01",
    "00-00000000000000000000000000000000-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902-01",
    "01-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "garbage",
    "",
    None,
]


@pytest.mark.parametrize("header", TRACEPARENTS)
def test_traceparent_parses_alike(header):
    got = []
    for module in (tr, jax_tr):
        with module.start_remote(header, "parity") as sp:
            got.append(sp)
    p, j = got
    if p.parent_id is None:
        # a fresh root on both: new ids, no parent
        assert j.parent_id is None and p.trace_id != j.trace_id
    else:
        assert (p.trace_id, p.parent_id) == (j.trace_id, j.parent_id)


def test_render_tree_matches():
    docs = [
        {"span_id": "a", "parent_id": None, "name": "sql.execute",
         "start_ms": 1.0, "duration_ms": 5.0, "attributes": {"db": "x"}},
        {"span_id": "b", "parent_id": "a", "name": "query.scan",
         "start_ms": 2.0, "duration_ms": 1.5, "attributes": {}},
        {"span_id": "c", "parent_id": "a", "name": "device.execute",
         "start_ms": 1.5, "duration_ms": None,
         "attributes": {"site": "range", "keep": True}},
        {"span_id": "d", "parent_id": "zz", "name": "remote",
         "start_ms": 0.5, "duration_ms": 0.25, "attributes": {}},
    ]
    assert tr.render_tree(docs) == jax_tr.render_tree(docs)


# ----------------------------------------------------------------------
# the device-program registry
# ----------------------------------------------------------------------

def _fold(module, seq):
    reg = module.DeviceProgramRegistry(
        module.ProfilingConfig(max_programs=3, metric_programs=2))
    # the JAX registry also takes the program's arguments (for its lazy
    # XLA cost analysis); the port's sites declare their cost instead
    extra = () if module is dp else ((), {})
    for site, key, ms, up, rb in seq:
        row, _first = reg.prepare(site, key, None, *extra)
        reg.finish(row, execute_ms=ms, upload=up, readback=rb)
    return reg


ROW_KEYS = ("site", "program", "key", "calls", "errors", "compile_ms",
            "execute_ms_total", "execute_p50_ms", "execute_p99_ms",
            "device_ms_total", "upload_bytes", "readback_bytes",
            "dispatch_only")


def test_program_registry_folds_alike():
    rng = np.random.default_rng(SEED)
    seq = [(("range", "groupby", "promql")[int(rng.integers(3))],
             ("k", int(rng.integers(3))),
             None if rng.random() < 0.05 else float(rng.random() * 40),
             int(rng.integers(1000)), int(rng.integers(1000)))
           for _ in range(200)]
    p, j = _fold(dp, seq), _fold(jax_dp, seq)
    pdocs = [{k: d[k] for k in ROW_KEYS} for d in p.snapshot()]
    jdocs = [{k: d[k] for k in ROW_KEYS} for d in j.snapshot(analyze=False)]
    assert pdocs == jdocs
    assert p.evicted_rows == j.evicted_rows > 0


class _Event:
    """A stand-in CUDA event: completes when the test says so."""

    def __init__(self, t_ms: float):
        self.t_ms = t_ms
        self.done = False

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done
        return end.t_ms - self.t_ms


def test_event_timed_dispatch_folds_once_completed():
    reg = dp.DeviceProgramRegistry()
    row, _ = reg.prepare("range", "k")
    reg.finish(row, execute_ms=1.0, upload=0, readback=0)   # first call
    ev0, ev1 = _Event(10.0), _Event(12.5)
    reg.finish(row, execute_ms=99.0, upload=8, readback=4,
               events=(ev0, ev1))
    # the end event has not completed: nothing folds, nothing syncs
    assert reg.snapshot()[0]["calls"] == 1
    ev0.done = ev1.done = True
    doc = reg.snapshot()[0]
    assert doc["calls"] == 2 and doc["execute_ms_total"] == 2.5
    assert doc["upload_bytes"] == 8 and doc["readback_bytes"] == 4


def test_declared_cost_gives_the_roofline():
    reg = dp.DeviceProgramRegistry(dp.ProfilingConfig(
        peak_tflops=67.0, peak_hbm_gbps=3350.0))
    row, _ = reg.prepare("groupby", "k")
    reg.declare(row, 1e6, 3.35e9)
    for ms in (5.0, 1.0, 1.0, 1.0):
        reg.finish(row, execute_ms=ms, upload=0, readback=0)
    doc = reg.report()["programs"][0]
    assert doc["analysis"] == "ok" and doc["bound"] == "memory"
    assert doc["execute_p50_ms"] > 0 and doc["pct_of_peak"] > 0
    assert reg.report()["peak_source"] == "configured"


def test_cpu_peaks_are_achieved_only():
    assert dp.global_programs.peaks()[2:] == ("cpu", "achieved_only")


# ----------------------------------------------------------------------
# one Standalone sequence through both packages
# ----------------------------------------------------------------------

def _rows() -> str:
    rng = np.random.default_rng(SEED)
    return ", ".join(
        f"('host_{h}', 'dc{h % 2}', {k * 60_000}, "
        f"{rng.random() * 100:.3f}, {rng.random() * 100:.3f})"
        for h in range(6) for k in range(120))


Q1 = ("SELECT ts, max(usage_user) RANGE '1m' FROM cpu WHERE hostname = "
      "'host_1' ALIGN '1m' BY (hostname) ORDER BY ts")
Q2 = ("SELECT ts, hostname, avg(usage_user) RANGE '1h' FROM cpu ALIGN '1h' "
      "BY (hostname) ORDER BY hostname, ts")
GROUP_BY = ("SELECT hostname, max(usage_user), count(*) FROM cpu GROUP BY "
            "hostname ORDER BY hostname")
SEQUENCE = [
    ("CREATE TABLE cpu (hostname STRING, dc STRING, ts TIMESTAMP TIME "
     "INDEX, usage_user DOUBLE, usage_system DOUBLE, PRIMARY KEY "
     "(hostname, dc))", {}),
    (f"INSERT INTO cpu VALUES {_rows()}", {}),
    (Q1, {}),
    (Q2, {}),
    (GROUP_BY, {}),
    ("TQL EVAL (0, 7200, '60s') max by (dc) "
     "(cpu{__field__=\"usage_user\"})", {}),
    (Q2, {"since_ms": 0}),          # a poll with `since`: a delta
    ("ADMIN kill('424242')", {}),
    ("SELECT hostname FROM cpu WHERE usage_user > 99.9 ORDER BY hostname",
     {"slow": True}),
]

EVENT_COUNTERS = (
    "greptime_promql_fast_path_total", "gtpu_session_hits_total",
    "gtpu_session_misses_total", "gtpu_readback_bytes_total",
    "gtpu_query_exec_path_total", "gtpu_index_lookups_total",
    "gtpu_index_scans_total", "gtpu_sched_admitted_total",
    "gtpu_sched_shed_total", "gtpu_result_cache_hits_total",
    "gtpu_result_cache_misses_total",
)
# the JAX package's families of modules the port has not yet: the
# autotuner (ROADMAP A12) and the distributed partial results (A10)
JAX_ONLY_FAMILIES = {
    "gtpu_autotune_controller_errors_total", "gtpu_autotune_decisions_total",
    "gtpu_autotune_frozen", "gtpu_autotune_knob_value",
    "gtpu_autotune_ticks_total", "gtpu_sched_partial_results_total",
}
JAX_ONLY_POOLS = {("warm_precompile", "device")}
JAX_ONLY_SPANS = {"recovery.open_regions"}
# C7: the four int32 bounds of a range prelude run
PRELUDE_BOUNDS_BYTES = 16
STMT_KEYS = ("query", "schema_name", "channel", "calls", "errors",
             "errors_by_code", "rows_returned", "exec_path",
             "mesh_decision", "compile_count", "compile_cache_hits",
             "upload_bytes", "readback_delta_bytes", "session_hit_rate",
             "result_cache_hit_rate")


def _events(registry) -> dict:
    out = {}
    for name in EVENT_COUNTERS:
        try:
            fam = registry.get(name)
        except KeyError:
            continue
        for labels, child in fam._snapshot():
            out[(name, *labels)] = child.value
    return out


def _run(inst, ctx, stmt):
    try:
        out = inst.execute_sql(stmt, ctx)[-1]
    except Exception as e:  # noqa: BLE001 - class and text are compared
        return ("error", type(e).__name__, str(e))
    if out.result is None:
        return ("rows", out.affected_rows)
    return ("result", out.result.num_rows)


def _program_calls(docs) -> dict:
    calls = {}
    for d in docs:
        calls[d["site"]] = calls.get(d["site"], 0) + d["calls"]
    return calls


def _three_surfaces(inst) -> tuple:
    """(the gtpu_device_program_calls_total series, the /debug/prof/device
    document's calls, information_schema.device_programs' calls), each
    by (site, program), read at one scrape."""
    text = tel.global_registry.render()
    exported = {}
    for line in text.splitlines():
        if line.startswith("gtpu_device_program_calls_total{"):
            labels, value = line.rsplit(" ", 1)
            site = labels.split('site="', 1)[1].split('"', 1)[0]
            prog = labels.split('program="', 1)[1].split('"', 1)[0]
            exported[(site, prog)] = float(value)
    doc = {(d["site"], d["program"]): d["calls"]
           for d in dp.global_programs.report(top=0)["programs"]}
    res = inst.sql("SELECT site, program, calls FROM "
                   "information_schema.device_programs")
    table = {(s, p): int(c) for s, p, c in zip(*(c.values
                                                 for c in res.cols))}
    return exported, doc, table


def _run_sequence(root: str) -> dict:
    """The sequence through both packages in this (fresh) process: what
    the process-wide registries hold then depends on the sequence alone,
    not on the tests a worker ran before. Returns plain data."""
    import jax

    jax.config.update("jax_enable_x64", True)
    port = Standalone(f"{root}/port", device="cpu", x64=True,
                      warm_start=False, prefer_device=True)
    jax_inst = JaxStandalone(f"{root}/jax", warm_start=False,
                             prefer_device=True)
    out = {"answers": []}
    try:
        ev0 = (_events(tel.global_registry),
               _events(jax_tel.global_registry))
        for stmt, opts in SEQUENCE:
            got = []
            for inst, ctx in ((port, QueryContext()), (jax_inst, JaxCtx())):
                if "since_ms" in opts:
                    ctx.extensions["since_ms"] = opts["since_ms"]
                if opts.get("slow"):
                    inst.slow_query_log.threshold_s = 0.0
                got.append(_run(inst, ctx, stmt))
                if opts.get("slow"):
                    inst.slow_query_log.threshold_s = 5.0
            out["answers"].append(got)
        ev1 = (_events(tel.global_registry),
               _events(jax_tel.global_registry))
        out["events"] = [
            {k: v - e0.get(k, 0.0) for k, v in e1.items()
             if v != e0.get(k, 0.0)}
            for e0, e1 in zip(ev0, ev1)]
        out["stmts"] = [m.global_stmt_stats.snapshot() for m in (ss, jax_ss)]
        out["programs"] = [dp.global_programs.snapshot(),
                           jax_dp.global_programs.snapshot(analyze=False)]
        out["families"] = [
            {n: (type(m).__name__, m.label_names)
             for n, m in reg._metrics.items()}
            for reg in (tel.global_registry, jax_tel.global_registry)]
        out["exposition"] = tel.global_registry.render()
        out["pools"] = [
            {(p.name, p.tier): p.entries
             for p in m.global_accountant.snapshot()}
            for m in (mem, jax_mem)]
        out["spans"] = [[s["name"] for t in m.global_traces.traces(256)
                         for s in t["spans"]] for m in (tr, jax_tr)]
        out["slow"] = [[(e["query"], e["fingerprint"], e["schema"])
                        for e in inst.slow_query_log.entries()]
                       for inst in (port, jax_inst)]
        res = port.sql("SELECT count(*) FROM information_schema."
                       "slow_queries")
        out["slow_table_rows"] = int(res.cols[0].values[0])
        out["surfaces"] = _three_surfaces(port)
        out["resets"] = []
        for stmt in ("ADMIN reset_statement_statistics()",
                     "ADMIN reset_device_profiler()"):
            got, want = port.sql(stmt), jax_inst.sql(stmt)
            out["resets"].append((got.names, int(got.cols[0].values[0]),
                                  want.names))
        out["programs_after_reset"] = dp.global_programs.snapshot()
    finally:
        port.close()
        jax_inst.close()
    return out


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    import concurrent.futures
    import multiprocessing

    root = tmp_path_factory.mktemp("telemetry")
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=1,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        return pool.submit(_run_sequence, str(root)).result(timeout=600)


def test_sequence_answers_match(sequence):
    for (stmt, _), (got, want) in zip(SEQUENCE, sequence["answers"]):
        assert got == want, stmt[:60]
        assert got[0] != "error", got


def test_statement_statistics_match(sequence):
    port, jax = ({d["fingerprint"]: d for d in docs}
                 for docs in sequence["stmts"])
    assert set(port) == set(jax) and len(port) == len(SEQUENCE) - 1
    extra = 0
    for fp, d in port.items():
        j = jax[fp]
        assert {k: d[k] for k in STMT_KEYS} == {k: j[k] for k in STMT_KEYS}
        for k in ("total_ms", "p50_ms", "p99_ms", "queue_total_ms"):
            assert isinstance(d[k], float) and d[k] >= 0.0
        assert len(d["program_ids"]) == len(j["program_ids"])
        extra += d["readback_full_bytes"] - j["readback_full_bytes"]
    # C7: 16 bytes a prelude run, and nothing else
    assert extra == PRELUDE_BOUNDS_BYTES * _program_calls(
        sequence["programs"][0])["range_prelude"]


def test_device_program_sites_and_calls_match(sequence):
    port, jax = (_program_calls(docs) for docs in sequence["programs"])
    assert port == jax
    assert {"range", "range_prelude", "groupby", "promql"} <= set(port)


def test_event_counts_match(sequence):
    port, jax = (dict(d) for d in sequence["events"])
    full = ("gtpu_readback_bytes_total", "full")
    assert port.pop(full) - jax.pop(full) == PRELUDE_BOUNDS_BYTES * \
        _program_calls(sequence["programs"][0])["range_prelude"]   # C7
    assert port == jax and port[("greptime_promql_fast_path_total", "hit")]


def test_metric_families_match(sequence):
    port, jax = sequence["families"]
    assert set(port) == set(jax) - JAX_ONLY_FAMILIES
    for name, schema in port.items():
        assert schema == jax[name], name
    for name, (kind, _) in port.items():     # the exposition names them
        assert f"# TYPE {name} {kind.lower()}" in sequence["exposition"]


def test_memory_pools_match(sequence):
    port, jax = sequence["pools"]
    assert set(port) == set(jax) - JAX_ONLY_POOLS
    jax_spans = sum(n in JAX_ONLY_SPANS for n in sequence["spans"][1])
    for key, entries in port.items():
        if key[1] != "host":
            continue
        want = jax[key] - (jax_spans if key[0] == "trace_ring" else 0)
        assert entries == want, key


def test_span_names_match(sequence):
    port, jax = (set(names) for names in sequence["spans"])
    assert port == jax - JAX_ONLY_SPANS
    assert {"sql.execute", "sql.Select", "query.plan", "device.execute",
            "sched.admit"} <= port


def test_slow_query_and_system_tables(sequence):
    port, jax = sequence["slow"]
    assert port == jax and len(port) == sequence["slow_table_rows"] == 1


def test_three_registry_surfaces_agree(sequence):
    """information_schema.device_programs, /debug/prof/device's document
    and the gtpu_device_program_* families, at one scrape."""
    exported, doc, table = sequence["surfaces"]
    assert exported == {k: float(v) for k, v in doc.items()}
    assert table == doc and doc


def test_reset_statements(sequence):
    for got_names, n, want_names in sequence["resets"]:
        assert got_names == want_names and n >= 1
    assert sequence["programs_after_reset"] == []


# ----------------------------------------------------------------------
# export (the self-import through the remote-write path) and report
# ----------------------------------------------------------------------

def test_export_self_imports_the_registry(tmp_path):
    from greptimedb_tpu_torch.telemetry.export import ExportMetricsTask

    inst = Standalone(str(tmp_path), device="cpu")
    try:
        inst.sql("SELECT 1")            # an admission, tenant "public"
        task = ExportMetricsTask(inst, interval_s=60.0, node="n1",
                                 role="standalone")
        inst.catalog.create_database(task.db, if_not_exists=True)
        want = tel.global_registry.get(
            "gtpu_sched_admitted_total").labels("public").value
        task.tick()
        assert task.runs == 1 and task.samples_written > 0
        res = inst.sql("SELECT tenant, node, greptime_value FROM "
                       "greptime_metrics.gtpu_sched_admitted_total WHERE "
                       "tenant = 'public'")
        assert [list(c.values) for c in res.cols] == [
            ["public"], ["n1"], [want]]
    finally:
        inst.close()


def test_report_payload_matches(tmp_path):
    from greptimedb_tpu.telemetry import report as jax_report
    from greptimedb_tpu_torch.telemetry import report

    got = report.build_payload(str(tmp_path / "port"))
    want = jax_report.build_payload(str(tmp_path / "jax"))
    assert set(got) == set(want)
    assert {k: got[k] for k in ("os", "arch", "mode", "nodes")} == \
        {k: want[k] for k in ("os", "arch", "mode", "nodes")}
    # the id is random, persisted in the data home, and stable
    assert report.install_uuid(str(tmp_path / "port")) == got["uuid"]
