"""Device program profiler: the cost registry behind every
``device_call``.

The north star is "as fast as the hardware allows", but tracing,
memory and statement statistics all attribute per-query
— the device programs that actually burn the device time stayed
anonymous. This module is the process-wide registry every program
dispatched through ``telemetry/device_trace.device_call.run`` folds
into, one row per program (site + static program key):

- per-call stats: calls, compile_ms (time of the process's FIRST
  execution, which includes the kernel library's first load or build),
  cumulative execute_ms and
  p50/p99 from a bucketed histogram, upload/readback bytes;
- declared cost: PyTorch has no compiler to ask for a program's cost,
  so each dispatching site declares, at the first dispatch of a
  program, the least bytes its program must read and write and the
  flops it does, from the shapes of that dispatch
  (``device_call.declare``). A row without a declaration reports no
  roofline verdict. On the card the execute time is the span between
  two CUDA events recorded around the program on its stream, read
  once the end event has completed (``finish`` defers the fold until
  then; ``drain_pending`` folds what has completed since);
- roofline attribution: operational intensity I = flops / bytes
  accessed compared against the machine balance peak_flops / peak_bw
  classifies each program ``bound=compute|memory``; achieved GFLOP/s
  and HBM GB/s derive from the p50 execute time, and %-of-peak is the
  achieved fraction of the BOUNDING resource. Peaks come from the
  ``[profiling]`` knobs; on an H100 80GB HBM3 they default to its
  data sheet's HBM rate and float32 CUDA-core rate, and elsewhere the
  registry reports achieved-only (no verdict) unless peaks are
  configured explicitly.

Surfaces: ``information_schema.device_programs``, ``/debug/prof/device``
(text + ?format=json, top-N by cumulative device time),
``gtpu_device_program_*`` pull-model metrics (published from the rows
at scrape time), roofline attrs on ``device.execute`` spans and EXPLAIN
ANALYZE, ``ADMIN reset_device_profiler()``, and a per-statement
``program_ids`` link from every statement_statistics row to the
programs it dispatched. Unlike the gtpu_stmt_* families (carried-base
monotone), ADMIN reset here resets the exported series too — the
3-surface agreement contract (information_schema == /debug/prof/device
== gtpu_device_program_*) is exact at every scrape, and Prometheus
consumers treat the drop as an ordinary counter reset.

On-demand trace capture (``/debug/prof/device/trace?seconds=``) runs
``torch.profiler`` for the given seconds and writes a Chrome/perfetto-
loadable trace (``export_chrome_trace``) under ``[profiling]
trace_dir``.
"""

from __future__ import annotations

import hashlib
import itertools
import os
import time
from collections import OrderedDict

from greptimedb_tpu_torch import concurrency
from greptimedb_tpu_torch.telemetry import metrics
from greptimedb_tpu_torch.telemetry.metrics import (
    global_registry,
    set_child_value as _set_value,
)

# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

# H100 SXM roofline peaks (NVIDIA H100 data sheet): 3,350 GB/s HBM3
# and 67 TFLOP/s float32 on the CUDA cores (the kernels add float32/
# float64 on CUDA cores and use no tensor cores). Used when the card is
# an H100 80GB HBM3 and the [profiling] knobs leave a peak at 0
# (= auto); every other platform reports achieved-only unless both
# peaks are configured explicitly.
H100_DEVICE_NAME = "H100 80GB HBM3"
H100_PEAK_TFLOPS = 67.0
H100_PEAK_HBM_GBPS = 3350.0


class ProfilingConfig:
    """`[profiling]` options (config.py DEFAULTS documents each)."""

    __slots__ = ("enable", "max_programs", "metric_programs",
                 "peak_tflops", "peak_hbm_gbps", "analysis",
                 "trace_dir")

    def __init__(self, *, enable: bool = True, max_programs: int = 256,
                 metric_programs: int = 128,
                 peak_tflops: float = 0.0, peak_hbm_gbps: float = 0.0,
                 analysis: bool = True, trace_dir: str = ""):
        self.enable = bool(enable)
        self.max_programs = max(1, int(max_programs))
        # /metrics label cap: prometheus series can never be evicted,
        # so real (site, program) labels are granted FIRST-COME (like
        # stmt_stats' metric_fingerprints); later programs export
        # under program="_other"
        self.metric_programs = max(0, int(metric_programs))
        self.peak_tflops = float(peak_tflops or 0.0)
        self.peak_hbm_gbps = float(peak_hbm_gbps or 0.0)
        self.analysis = bool(analysis)
        self.trace_dir = str(trace_dir or "")


# ---------------------------------------------------------------------------
# metrics — PULL-model like gtpu_stmt_*: families publish from the
# registry rows at scrape time via a MetricsRegistry collector, so the
# dispatch hot path never touches a prometheus child lock. Label
# cardinality is bounded by [profiling] max_programs (LRU rows collapse
# into a per-site "_other" row). ADMIN reset zeroes the exported
# series (an ordinary prometheus counter reset) so all three surfaces
# stay exactly equal.
# ---------------------------------------------------------------------------

_M_CALLS = global_registry.counter(
    "gtpu_device_program_calls_total",
    "device program dispatches per (site, program)",
    labels=("site", "program"),
)
_M_EXEC = global_registry.counter(
    "gtpu_device_program_execute_ms_total",
    "cumulative steady-state execute ms per (site, program) "
    "(excludes the first call, whose wall time is compile_ms)",
    labels=("site", "program"),
)
_M_UPLOAD = global_registry.counter(
    "gtpu_device_program_upload_bytes_total",
    "host->device bytes uploaded by dispatches of (site, program)",
    labels=("site", "program"),
)
_M_READBACK = global_registry.counter(
    "gtpu_device_program_readback_bytes_total",
    "device->host bytes read back by dispatches of (site, program)",
    labels=("site", "program"),
)
_M_COMM = global_registry.counter(
    "gtpu_device_program_comm_bytes_total",
    "declared inter-chip bytes moved by collective kernel dispatches "
    "of (site, program)",
    labels=("site", "program"),
)
_M_COMPILE = global_registry.gauge(
    "gtpu_device_program_compile_ms",
    "wall time of the first execution (includes the kernel library's "
    "first load or build)",
    labels=("site", "program"),
)
_M_P50 = global_registry.gauge(
    "gtpu_device_program_execute_p50_ms",
    "p50 steady-state execute ms per (site, program)",
    labels=("site", "program"),
)
_M_P99 = global_registry.gauge(
    "gtpu_device_program_execute_p99_ms",
    "p99 steady-state execute ms per (site, program)",
    labels=("site", "program"),
)
_M_FLOPS = global_registry.gauge(
    "gtpu_device_program_flops",
    "per-call FLOPs the dispatching site declares (0 when undeclared)",
    labels=("site", "program"),
)
_M_BYTES = global_registry.gauge(
    "gtpu_device_program_bytes_accessed",
    "per-call least HBM bytes read and written, as the site declares",
    labels=("site", "program"),
)
_M_GFLOPS = global_registry.gauge(
    "gtpu_device_program_achieved_gflops",
    "achieved GFLOP/s at the p50 execute time",
    labels=("site", "program"),
)
_M_GBPS = global_registry.gauge(
    "gtpu_device_program_achieved_hbm_gbps",
    "achieved HBM GB/s at the p50 execute time",
    labels=("site", "program"),
)
_M_PCT = global_registry.gauge(
    "gtpu_device_program_pct_of_peak",
    "achieved fraction of the roofline-bounding resource (percent; "
    "0 when peaks are unknown on this platform)",
    labels=("site", "program"),
)
_M_COUNT = global_registry.gauge(
    "gtpu_device_programs",
    "distinct program rows currently tracked by the profiler",
)

OTHER = "_other"

# execute-time histogram bounds (ms) for the per-row p50/p99; one
# OVERFLOW slot past the last bound like stmt_stats' buckets
_EXEC_BUCKETS_MS = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 60000.0,
)
_N_BUCKETS = len(_EXEC_BUCKETS_MS) + 1


def _observe(buckets: list[int], v_ms: float):
    metrics.observe_bucket(buckets, _EXEC_BUCKETS_MS, v_ms)


def _quantile(buckets: list[int], q: float) -> float:
    return metrics.bucket_quantile(buckets, _EXEC_BUCKETS_MS, q)


def _platform() -> tuple[str, str]:
    """(platform, device name) WITHOUT initializing CUDA: a process that
    never touched the card scrapes /metrics without a context bring-up.
    "cuda" once CUDA is initialized, else "cpu"."""
    import torch

    try:
        if torch.cuda.is_initialized():
            return "cuda", str(torch.cuda.get_device_name())
    except Exception:  # noqa: BLE001 - no usable card
        pass
    return "cpu", ""


def _prog_id(site: str, key) -> str:
    return hashlib.blake2b(
        repr((site, key)).encode(), digest_size=6
    ).hexdigest()


class _Program:
    """One compiled program's aggregate row."""

    __slots__ = (
        "site", "prog_id", "key_text", "calls", "compile_ms",
        "execute_ms_total", "exec_buckets", "upload_bytes",
        "readback_bytes", "dispatch_only", "errors",
        "first_seen_ms", "last_seen_ms",
        "analysis", "analysis_error", "flops", "bytes_accessed",
        "temp_bytes", "output_bytes", "argument_bytes",
        "aot_compile_ms", "_compile_done", "metric_prog",
        "collective", "comm_bytes",
    )

    def __init__(self, site: str, prog_id: str, key_text: str):
        self.site = site
        self.prog_id = prog_id
        self.key_text = key_text
        self.calls = 0
        self.compile_ms: float | None = None
        self.execute_ms_total = 0.0
        self.exec_buckets = [0] * _N_BUCKETS
        self.upload_bytes = 0
        self.readback_bytes = 0
        # True when at least one fold timed only the DISPATCH (the
        # caller did not block_until_ready — flow apply): achieved
        # rates would overstate, so they are suppressed for the row
        self.dispatch_only = False
        self.errors = 0
        self.first_seen_ms = int(time.time() * 1000)
        self.last_seen_ms = self.first_seen_ms
        # pending (no declaration yet) | ok (declared) | off
        self.analysis = "pending"
        self.analysis_error = ""
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.temp_bytes = 0
        self.output_bytes = 0
        self.argument_bytes = 0
        self.aot_compile_ms = 0.0
        # collective kernel programs (Pallas ring/merge paths) declare
        # their inter-chip copy sizes per dispatch; cumulative here so
        # communication share per program is computable from the row
        self.collective = False
        self.comm_bytes = 0
        # monotonic instant the first call finished: dispatches that
        # STARTED before it waited on the shared first load or build and
        # are not steady-state samples
        self._compile_done: float | None = None
        # the /metrics label this row publishes under (its own id, or
        # "_other" past the metric_programs first-come cap) — decided
        # once at row creation
        self.metric_prog = prog_id

    # -- folding -------------------------------------------------------
    def fold_call(self, execute_ms: float | None, upload: int,
                  readback: int, *, dispatch_only: bool,
                  run_start: float | None = None,
                  collective: bool = False, comm_bytes: int = 0):
        self.calls += 1
        self.last_seen_ms = int(time.time() * 1000)
        self.upload_bytes += upload
        self.readback_bytes += readback
        if collective:
            self.collective = True
        self.comm_bytes += int(comm_bytes)
        if execute_ms is None:
            # failed dispatch: if it was the compile attempt,
            # compile_ms stays None and the NEXT successful call (which
            # pays the compile) records it
            self.errors += 1
            return
        if self.compile_ms is None:
            # the first SUCCESSFUL execution's time carries the kernel
            # library's first load (or nvcc build); keep it out of the
            # steady-state percentiles
            self.compile_ms = execute_ms
            self._compile_done = time.monotonic()
            return
        if (run_start is not None and self._compile_done is not None
                and run_start < self._compile_done):
            # concurrent cold dispatch: it waited on the creator's
            # shared first load, so its time would poison the
            # steady-state percentiles (calls/bytes still counted)
            return
        if dispatch_only:
            self.dispatch_only = True
        self.execute_ms_total += execute_ms
        _observe(self.exec_buckets, execute_ms)

    def fold_row(self, other: "_Program"):
        """Merge an LRU-evicted row into this (_other) one."""
        self.calls += other.calls
        self.errors += other.errors
        self.execute_ms_total += other.execute_ms_total
        for i in range(_N_BUCKETS):
            self.exec_buckets[i] += other.exec_buckets[i]
        self.upload_bytes += other.upload_bytes
        self.readback_bytes += other.readback_bytes
        self.collective = self.collective or other.collective
        self.comm_bytes += other.comm_bytes
        self.dispatch_only = self.dispatch_only or other.dispatch_only
        if other.compile_ms:
            self.compile_ms = (self.compile_ms or 0.0) + other.compile_ms
        self.first_seen_ms = min(self.first_seen_ms, other.first_seen_ms)
        self.last_seen_ms = max(self.last_seen_ms, other.last_seen_ms)

    # -- derived -------------------------------------------------------
    def exec_p50_ms(self) -> float:
        return _quantile(self.exec_buckets, 0.50)

    def exec_p99_ms(self) -> float:
        return _quantile(self.exec_buckets, 0.99)

    def device_ms(self) -> float:
        return (self.compile_ms or 0.0) + self.execute_ms_total

    def achieved(self) -> tuple[float, float]:
        """(GFLOP/s, HBM GB/s) at the p50 execute time; (0, 0) until
        the program is analyzed, has steady-state samples, and its
        timing covers the completed computation (not dispatch-only)."""
        p50 = self.exec_p50_ms()
        if (self.analysis != "ok" or p50 <= 0.0 or self.dispatch_only
                or sum(self.exec_buckets) == 0):
            return 0.0, 0.0
        s = p50 / 1000.0
        return self.flops / s / 1e9, self.bytes_accessed / s / 1e9

    def roofline(self, peak_tflops: float, peak_hbm_gbps: float
                 ) -> tuple[str, float]:
        """(bound, pct_of_peak). bound classifies by operational
        intensity vs the machine balance (static — no timing needed);
        pct is achieved/peak for the bounding resource, 0.0 when
        unmeasurable. ("", 0.0) when unanalyzed or peaks unknown."""
        if (self.analysis != "ok" or peak_tflops <= 0
                or peak_hbm_gbps <= 0 or self.bytes_accessed <= 0):
            return "", 0.0
        intensity = self.flops / self.bytes_accessed  # FLOP / byte
        balance = (peak_tflops * 1e12) / (peak_hbm_gbps * 1e9)
        bound = "compute" if intensity >= balance else "memory"
        gflops, gbps = self.achieved()
        if bound == "compute":
            pct = gflops / (peak_tflops * 1e3) * 100.0
        else:
            pct = gbps / peak_hbm_gbps * 100.0
        return bound, pct

    def to_doc(self, peak_tflops: float, peak_hbm_gbps: float) -> dict:
        gflops, gbps = self.achieved()
        bound, pct = self.roofline(peak_tflops, peak_hbm_gbps)
        return {
            "site": self.site,
            "program": self.prog_id,
            "key": self.key_text,
            "calls": self.calls,
            "errors": self.errors,
            "compile_ms": round(self.compile_ms or 0.0, 3),
            "execute_ms_total": round(self.execute_ms_total, 3),
            "execute_p50_ms": round(self.exec_p50_ms(), 3),
            "execute_p99_ms": round(self.exec_p99_ms(), 3),
            "device_ms_total": round(self.device_ms(), 3),
            "upload_bytes": int(self.upload_bytes),
            "readback_bytes": int(self.readback_bytes),
            "collective": self.collective,
            "comm_bytes": int(self.comm_bytes),
            "dispatch_only": self.dispatch_only,
            "analysis": self.analysis,
            "analysis_error": self.analysis_error,
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "temp_bytes": int(self.temp_bytes),
            "output_bytes": int(self.output_bytes),
            "argument_bytes": int(self.argument_bytes),
            "aot_compile_ms": round(self.aot_compile_ms, 3),
            "achieved_gflops": round(gflops, 3),
            "achieved_hbm_gbps": round(gbps, 3),
            "bound": bound,
            "pct_of_peak": round(pct, 3),
            "first_seen_ms": self.first_seen_ms,
            "last_seen_ms": self.last_seen_ms,
        }


class DeviceProgramRegistry:
    """Process-wide registry; one per process (``global_programs``)."""

    def __init__(self, config: ProfilingConfig | None = None):
        self.config = config or ProfilingConfig()
        self._lock = concurrency.Lock()
        self._rows: OrderedDict[tuple, _Program] = OrderedDict()
        # finished dispatches whose end event had not completed at the
        # span's close: (row, start event, end event, fold kwargs),
        # folded by drain_pending once the end event has completed
        self._pending: list[tuple] = []
        # serializes whole publish passes (snapshot + child writes):
        # two concurrent scrapes interleaving their writes could
        # expose a STALE aggregate after a newer one — a counter
        # decrease to Prometheus (same contract as stmt_stats'
        # publish lock)
        self._publish_lock = concurrency.Lock()
        # labels this process has published, so a scrape after ADMIN
        # reset (or LRU collapse) zeroes vanished series instead of
        # leaving them frozen at stale values
        self._published: set[tuple[str, str]] = set()
        # program ids granted a real /metrics label (first-come,
        # bounded by metric_programs — exported series can never be
        # evicted, so churn past the cap exports as "_other")
        self._metric_progs: set[str] = set()
        self.evicted_rows = 0

    # -- dispatch-side hot path ---------------------------------------
    def prepare(self, site: str, key, fn=None
                ) -> tuple[_Program, bool] | None:
        """Called by device_call.run just before the dispatch. Returns
        (row, is_first_dispatch) or None when disabled. The first
        dispatch of a program is where its site declares the cost
        (device_call.declare)."""
        if not self.config.enable:
            return None
        if key is None:
            # keyless dispatch: the callable IS the identity (process-
            # local, like the jit cache itself)
            key = repr(fn)
        try:
            hkey = (site, key)
            hash(hkey)
        except TypeError:
            key = repr(key)
            hkey = (site, key)
        with self._lock:
            row = self._rows.get(hkey)
            if row is not None:
                self._rows.move_to_end(hkey)
                return row, False
            # make room INCLUDING the row about to be inserted; a
            # collapse that merely CREATED a db's _other row has not
            # shrunk anything yet, so keep collapsing until the bound
            # holds or only _other rows remain
            while len(self._rows) >= self.config.max_programs:
                if not self._collapse_lru_locked():
                    break  # only _other rows remain
            key_text = repr(key)
            if len(key_text) > 160:
                key_text = key_text[:157] + "..."
            row = _Program(site, _prog_id(site, key), key_text)
            row.metric_prog = self._metric_prog_locked(row.prog_id)
            self._rows[hkey] = row
        if not self.config.analysis:
            row.analysis = "off"
        return row, True

    def declare(self, row: _Program, flops: float, bytes_accessed: float):
        """The site's declared per-call cost of `row`'s program: the
        least bytes it must read and write and the flops it does, from
        the shapes of its first dispatch."""
        if row.analysis != "pending":
            return
        with self._lock:
            row.flops = float(flops)
            row.bytes_accessed = float(bytes_accessed)
            row.analysis = "ok"

    def lookup(self, site: str, key) -> _Program | None:
        """Read-only row lookup for ATTRIBUTION on no-dispatch paths
        (session hits keep their device.execute span and EXPLAIN
        ANALYZE notes, but do not count a call). Never creates a row."""
        if not self.config.enable:
            return None
        if key is None:
            return None
        try:
            hkey = (site, key)
            hash(hkey)
        except TypeError:
            hkey = (site, repr(key))
        with self._lock:
            row = self._rows.get(hkey)
            if row is not None:
                # a session-served program is HOT: refresh its LRU
                # recency so the steady-state rows are the last to
                # collapse into _other, not the first
                self._rows.move_to_end(hkey)
            return row

    def finish(self, row: _Program, *,
               execute_ms: float | None, upload: int, readback: int,
               dispatch_only: bool = False,
               run_start: float | None = None,
               collective: bool = False, comm_bytes: int = 0,
               events: tuple | None = None):
        """Fold one dispatch. `events` (start, end) are the CUDA events
        around the program: their elapsed time is the execute time, read
        only once the end event has completed (a query, never a
        synchronize) — here when it already has, else at the next
        drain_pending."""
        kw = dict(upload=upload, readback=readback,
                  dispatch_only=dispatch_only, run_start=run_start,
                  collective=collective, comm_bytes=comm_bytes)
        if events is not None:
            if not events[1].query():
                with self._lock:
                    self._pending.append((row, events, kw))
                return
            execute_ms = events[0].elapsed_time(events[1])
        with self._lock:
            row.fold_call(execute_ms, **kw)

    def drain_pending(self):
        """Fold every deferred dispatch whose end event has completed;
        the rest stay pending (no synchronize)."""
        with self._lock:
            if not self._pending:
                return
            keep = []
            for row, (ev0, ev1), kw in self._pending:
                if ev1.query():
                    row.fold_call(ev0.elapsed_time(ev1), **kw)
                else:
                    keep.append((row, (ev0, ev1), kw))
            self._pending = keep

    def _metric_prog_locked(self, prog_id: str) -> str:
        if prog_id in self._metric_progs:
            return prog_id
        if len(self._metric_progs) < self.config.metric_programs:
            self._metric_progs.add(prog_id)
            return prog_id
        return OTHER

    def _collapse_lru_locked(self) -> bool:
        """Merge the least-recently-dispatched row into its site's
        _other row. Returns False when only _other rows remain."""
        for hkey in self._rows:
            if self._rows[hkey].prog_id != OTHER:
                victim = self._rows.pop(hkey)
                break
        else:
            return False
        okey = (victim.site, OTHER)
        other = self._rows.get(okey)
        if other is None:
            other = _Program(victim.site, OTHER, OTHER)
            other.analysis = "off"
            other.metric_prog = OTHER
            self._rows[okey] = other
        else:
            self._rows.move_to_end(okey)
        other.fold_row(victim)
        self.evicted_rows += 1
        return True

    # -- peaks ---------------------------------------------------------
    def peaks(self) -> tuple[float, float, str, str]:
        """(peak_tflops, peak_hbm_gbps, platform, source). Peaks are 0
        when unknown (achieved-only reporting)."""
        pf = self.config.peak_tflops
        pb = self.config.peak_hbm_gbps
        plat, name = _platform()
        if pf > 0 and pb > 0:
            return pf, pb, plat, "configured"
        if plat == "cuda" and H100_DEVICE_NAME in name:
            return (pf if pf > 0 else H100_PEAK_TFLOPS,
                    pb if pb > 0 else H100_PEAK_HBM_GBPS,
                    plat, "h100_default")
        return 0.0, 0.0, plat, "achieved_only"

    # -- surfaces ------------------------------------------------------
    def snapshot(self, *, top: int = 0) -> list[dict]:
        """Row docs ordered by cumulative device time (compile +
        execute), top-N bounded when top > 0. Folds the deferred
        dispatches whose events have completed first."""
        self.drain_pending()
        pf, pb, _plat, _src = self.peaks()
        with self._lock:
            docs = [r.to_doc(pf, pb) for r in self._rows.values()]
        docs.sort(key=lambda d: d["device_ms_total"], reverse=True)
        if top > 0:
            docs = docs[:top]
        return docs

    def report(self, *, top: int = 20) -> dict:
        pf, pb, plat, src = self.peaks()
        with self._lock:
            total = len(self._rows)
        return {
            "platform": plat,
            "peak_tflops": pf,
            "peak_hbm_gbps": pb,
            "peak_source": src,
            "programs_tracked": total,
            "evicted_rows": self.evicted_rows,
            "programs": self.snapshot(top=top),
        }

    def reset(self) -> int:
        """ADMIN reset_device_profiler(): drop every row. The exported
        gtpu_device_program_* series zero at the next scrape (a plain
        prometheus counter reset) so all three surfaces stay equal."""
        with self._lock:
            n = len(self._rows)
            self._rows.clear()
            self._pending = []
            self.evicted_rows = 0
        return n

    # -- scrape-time publisher ----------------------------------------
    def _publish_metrics(self):
        """MetricsRegistry collector: refresh every
        gtpu_device_program_* family from the rows, after folding the
        deferred dispatches whose events have completed. The publish
        lock covers snapshot AND writes: publishes
        serialize, so each scrape exposes a consistent, never-older
        aggregate (and the _published bookkeeping can't race)."""
        with self._publish_lock:
            self._publish_locked()

    def _publish_locked(self):
        self.drain_pending()
        pf, pb, _plat, _src = self.peaks()
        with self._lock:
            rows = [(r.to_doc(pf, pb), r.metric_prog)
                    for r in self._rows.values()]
            n_rows = len(rows)
        # aggregate by the EXPORTED label: past the metric_programs
        # first-come cap, churned programs share the per-site "_other"
        # label (counters sum; the per-program gauges publish only for
        # labels backed by their own row) — the exported series set
        # stays bounded no matter how many program shapes a
        # long-running server mints
        agg: dict[tuple[str, str], dict] = {}
        for d, mp in rows:
            lab = (d["site"], mp)
            a = agg.get(lab)
            if a is None:
                a = agg[lab] = {"calls": 0, "exec": 0.0, "up": 0,
                                "rb": 0, "comm": 0, "doc": None}
            a["calls"] += d["calls"]
            a["exec"] += d["execute_ms_total"]
            a["up"] += d["upload_bytes"]
            a["rb"] += d["readback_bytes"]
            a["comm"] += d["comm_bytes"]
            if mp == d["program"]:
                a["doc"] = d
        live: set[tuple[str, str]] = set()
        for lab, a in agg.items():
            live.add(lab)
            _set_value(_M_CALLS.labels(*lab), a["calls"])
            _set_value(_M_EXEC.labels(*lab), a["exec"])
            _set_value(_M_UPLOAD.labels(*lab), a["up"])
            _set_value(_M_READBACK.labels(*lab), a["rb"])
            _set_value(_M_COMM.labels(*lab), a["comm"])
            d = a["doc"]
            if d is None:
                # an over-cap aggregate label: per-program gauges are
                # meaningless for a mixed bucket
                d = {"compile_ms": 0.0, "execute_p50_ms": 0.0,
                     "execute_p99_ms": 0.0, "flops": 0.0,
                     "bytes_accessed": 0.0, "achieved_gflops": 0.0,
                     "achieved_hbm_gbps": 0.0, "pct_of_peak": 0.0}
            _M_COMPILE.labels(*lab).set(d["compile_ms"])
            _M_P50.labels(*lab).set(d["execute_p50_ms"])
            _M_P99.labels(*lab).set(d["execute_p99_ms"])
            _M_FLOPS.labels(*lab).set(d["flops"])
            _M_BYTES.labels(*lab).set(d["bytes_accessed"])
            _M_GFLOPS.labels(*lab).set(d["achieved_gflops"])
            _M_GBPS.labels(*lab).set(d["achieved_hbm_gbps"])
            _M_PCT.labels(*lab).set(d["pct_of_peak"])
        for lab in self._published - live:
            # vanished rows (ADMIN reset / LRU collapse): zero, don't
            # freeze — the surfaces must agree at every scrape
            for fam in (_M_CALLS, _M_EXEC, _M_UPLOAD, _M_READBACK,
                        _M_COMM):
                _set_value(fam.labels(*lab), 0)
            for fam in (_M_COMPILE, _M_P50, _M_P99, _M_FLOPS, _M_BYTES,
                        _M_GFLOPS, _M_GBPS, _M_PCT):
                fam.labels(*lab).set(0.0)
        self._published = live
        _M_COUNT.set(n_rows)


def render_text(doc: dict) -> str:
    """Human face of /debug/prof/device: top-N by device time."""
    out = [
        f"device programs: {doc['programs_tracked']} tracked "
        f"({doc['evicted_rows']} collapsed), platform "
        f"{doc['platform']}",
    ]
    if doc["peak_tflops"] > 0:
        out.append(
            f"roofline peaks [{doc['peak_source']}]: "
            f"{doc['peak_tflops']:g} TFLOP/s, "
            f"{doc['peak_hbm_gbps']:g} GB/s HBM"
        )
    else:
        out.append("roofline peaks: unknown (achieved-only; set "
                   "[profiling] peak_tflops / peak_hbm_gbps)")
    hdr = (f"{'site':<16} {'program':<13} {'calls':>7} "
           f"{'compile':>9} {'p50ms':>9} {'p99ms':>9} {'GFLOP/s':>9} "
           f"{'GB/s':>8} {'%peak':>6} {'bound':<7}")
    out.append(hdr)
    out.append("-" * len(hdr))
    for d in doc["programs"]:
        pct = f"{d['pct_of_peak']:.1f}" if d["bound"] else "-"
        bound = d["bound"] or ("dispatch" if d["dispatch_only"]
                               else d["analysis"])
        out.append(
            f"{d['site']:<16.16} {d['program']:<13.13} "
            f"{d['calls']:>7} {d['compile_ms']:>9.1f} "
            f"{d['execute_p50_ms']:>9.3f} {d['execute_p99_ms']:>9.3f} "
            f"{d['achieved_gflops']:>9.2f} "
            f"{d['achieved_hbm_gbps']:>8.2f} {pct:>6} {bound:<7}"
        )
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# on-demand trace capture (torch.profiler)
# ---------------------------------------------------------------------------


class CaptureBusyError(RuntimeError):
    """A trace capture is already in progress in this process."""


_capture_seq = itertools.count(1)
_capture_lock = concurrency.Lock()
_capture_active = False


def capture_trace(seconds: float, out_dir: str | None = None) -> dict:
    """Capture `seconds` of host and card activity with torch.profiler
    into a Chrome/perfetto-loadable trace directory (`trace.json`). One
    capture at a time per process (CaptureBusyError otherwise)."""
    global _capture_active

    seconds = float(seconds)
    if not (0.0 < seconds <= 60.0):
        raise ValueError("seconds must be in (0, 60]")
    import tempfile

    base = (out_dir or global_programs.config.trace_dir
            or os.path.join(tempfile.gettempdir(), "gtpu_device_traces"))
    with _capture_lock:
        if _capture_active:
            raise CaptureBusyError("a trace capture is already running")
        _capture_active = True
    try:
        # dir creation AFTER the busy check: a 409'd caller must not
        # litter trace_dir with empty capture directories
        path = os.path.join(
            base, f"capture_{os.getpid()}_{next(_capture_seq)}"
        )
        os.makedirs(path, exist_ok=True)
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_initialized():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            time.sleep(seconds)
        prof.export_chrome_trace(os.path.join(path, "trace.json"))
    finally:
        with _capture_lock:
            _capture_active = False
    files = []
    for root, _dirs, names in os.walk(path):
        for name in names:
            files.append(os.path.relpath(os.path.join(root, name), path))
    return {
        "trace_dir": path,
        "seconds": seconds,
        "files": sorted(files),
    }


# ---------------------------------------------------------------------------
# process-wide instance + wiring
# ---------------------------------------------------------------------------

global_programs = DeviceProgramRegistry()
# scrape-time publisher: /metrics (and runtime_metrics, and the
# self-export loop) refresh the gtpu_device_program_* families from the
# registry rows on every render — zero prometheus work at dispatch
global_registry.register_collector(global_programs._publish_metrics)


def configure(options: dict | None) -> ProfilingConfig:
    """Apply the `[profiling]` TOML section to this process."""
    o = options or {}
    cfg = ProfilingConfig(
        enable=o.get("enable", True),
        max_programs=o.get("max_programs", 256),
        metric_programs=o.get("metric_programs", 128),
        peak_tflops=o.get("peak_tflops", 0.0),
        peak_hbm_gbps=o.get("peak_hbm_gbps", 0.0),
        analysis=o.get("analysis", True),
        trace_dir=o.get("trace_dir", ""),
    )
    with global_programs._lock:
        global_programs.config = cfg
        # the label grant set re-derives under the new cap (already-
        # exported series keep counting regardless)
        global_programs._metric_progs.clear()
    return cfg


def enabled() -> bool:
    return global_programs.config.enable
