"""Device-time attribution for traces + the program-profiler boundary.

A query's database time splits into the kernel library's first load (the
first call of a program in this process), device execution, and
host<->device transfer (uploads of masks/grids, result readback). This
module wraps the program CALL BOUNDARY in query/device_range.py,
query/reduce.py, promql/fast.py, storage/device_merge.py and
flow/device_state.py, always from host code.

Each wrapped call produces one `device.execute` span carrying:
- site: which program family ran (range / groupby / promql / topk / ...)
- compile: "first_call" (this process had not executed this static
  program shape before: the time includes the kernel library's first
  load, or its nvcc build) or "cache_hit" (steady state)
- execute_ms: host time from the span's start to `executed()`
- upload_bytes / readback_bytes: host->device and device->host traffic
  attributable to this call
- program + roofline attribution (telemetry/device_programs.py): the
  program-registry id and, where the site declared its cost, flops,
  bound=compute|memory and this call's achieved GFLOP/s / %-of-peak

Dispatching THROUGH `device_call.run(fn, *args, **kw)` additionally
folds the call into the process-wide device-program registry
(telemetry/device_programs.py). On the card (`device=` a CUDA device)
the program's execute time is the elapsed time between a CUDA event
recorded on the device's current stream at `run()` and one at
`executed()`; the registry reads it once the end event has completed (at
the span's close, after the readback, or at the next snapshot/scrape)
and never synchronizes, so telemetry adds no sync to a query. On the
CPU (the caller asked for it) the execute time is host time. A session
hit that skips the dispatch keeps its span but does NOT count as a
program call — the registry describes real dispatches.
"""

from __future__ import annotations

import time

import torch

from greptimedb_tpu_torch import concurrency
from greptimedb_tpu_torch.telemetry import stmt_stats, tracing

# (site, static program key) shapes this process has already executed:
# membership decides first_call vs cache_hit attribution. Bounded the
# same way the jit caches are in practice (program shapes are few).
_SEEN_MAX = 4096
_seen: set = set()
_seen_lock = concurrency.Lock()


def note_compile(site: str, key) -> str:
    """Record one execution of (site, key); returns the compile
    attribution for THIS call."""
    k = (site, key)
    with _seen_lock:
        if k in _seen:
            return "cache_hit"
        if len(_seen) >= _SEEN_MAX:
            _seen.clear()  # rare; worst case a few re-labelled firsts
        _seen.add(k)
        return "first_call"


class device_call:
    """`with device_trace.device_call("range", key=spec, device=dev) as
    d:` — wraps one program. The span duration covers dispatch +
    execute + readback; dispatch the program via `d.run(fn, *args,
    **kw)` so it registers with the device-program profiler, call
    `d.executed()` right after the program's last launch, before its
    readback, so execute time splits from readback (pass
    `dispatch_only=True` where the caller times the dispatch alone —
    the flow apply), `d.declare(flops, bytes)` on the program's first
    dispatch (`d.first`), and `d.transfer(nbytes, "upload"|"readback")`
    for host<->device traffic."""

    __slots__ = ("_cm", "_span", "_mono0", "site", "_stmt", "key",
                 "_rec", "_first", "_run_t0", "_exec_ms", "_up", "_rb",
                 "_dispatch_only", "collective", "comm_bytes", "_dev",
                 "_ev0", "_ev1")

    def __init__(self, site: str, *, key=None, collective: bool = False,
                 comm_bytes: int = 0, device=None, **attrs):
        self.site = site
        self.key = key
        # a CUDA device times the program by events on its stream; any
        # other (the CPU, or none given) by host time
        dev = torch.device(device) if device is not None else None
        self._dev = dev if dev is not None and dev.type == "cuda" else None
        self._ev0 = self._ev1 = None
        # collective-time attribution (kernel programs with declared
        # inter-chip copies): rides the span AND the program row, so
        # bench multichip can report communication share per mesh size
        self.collective = bool(collective)
        self.comm_bytes = int(comm_bytes)
        if self.collective:
            attrs = dict(attrs)
            attrs["collective"] = True
            attrs["comm_bytes"] = self.comm_bytes
        self._rec = None
        self._first = False
        self._run_t0 = 0.0
        self._exec_ms = None
        self._up = 0
        self._rb = 0
        self._dispatch_only = False
        # skip the compile-memo lookup entirely when NEITHER a trace
        # nor a statement observation is active: the memo only feeds
        # attribution, and the bare hot path must stay zero-cost
        self._stmt = stmt_stats.active() is not None
        traced = tracing.enabled() and tracing.current_span() is not None
        if traced or self._stmt:
            comp = note_compile(site, key)
            if self._stmt:
                # per-statement compile-vs-program-cache attribution:
                # a repeatedly polled fingerprint shows compile=1 /
                # cache_hit=N-1 in statement_statistics
                stmt_stats.add("compile_first" if comp == "first_call"
                               else "compile_cache_hit")
        if traced:
            self._cm = tracing.child_span(
                "device.execute", site=site, compile=comp, **attrs,
            )
        else:
            self._cm = tracing.child_span("device.execute")
        self._span = None
        self._mono0 = 0.0

    def __enter__(self) -> "device_call":
        self._span = self._cm.__enter__()
        self._mono0 = time.monotonic()
        return self

    def run(self, fn, *args, **kw):
        """Dispatch the program. Registers (site, key) with the
        device-program registry and anchors the execute timer at the
        dispatch (a CUDA event on the card), so session lookups before
        it never count as device time."""
        from greptimedb_tpu_torch.telemetry import device_programs

        reg = device_programs.global_programs
        if reg.config.enable:
            prep = reg.prepare(self.site, self.key, fn)
            if prep is not None:
                self._rec, self._first = prep
        self._run_t0 = time.monotonic()
        if self._rec is not None and self._dev is not None:
            self._ev0 = torch.cuda.Event(enable_timing=True)
            self._ev0.record(torch.cuda.current_stream(self._dev))
        return fn(*args, **kw)

    @property
    def first(self) -> bool:
        """True on the first dispatch of this program in the process:
        where the site declares its cost."""
        return self._first

    def declare(self, flops: float, bytes_accessed: float):
        """The program's per-call cost: its flops and the least bytes it
        must read and write (each input read once, each output written
        once), from this dispatch's shapes."""
        if self._rec is not None:
            from greptimedb_tpu_torch.telemetry import device_programs

            device_programs.global_programs.declare(
                self._rec, flops, bytes_accessed)

    def executed(self, *, dispatch_only: bool = False):
        """Mark the program's launches complete (call right after its
        last launch, before the readback); the remainder of the span is
        readback. dispatch_only=True records that the timing covers the
        dispatch, not the computation, so the profiler suppresses
        achieved-rate claims for this program."""
        now = time.monotonic()
        self._exec_ms = (now - (self._run_t0 or self._mono0)) * 1000.0
        self._dispatch_only = dispatch_only
        if self._ev0 is not None and not dispatch_only:
            self._ev1 = torch.cuda.Event(enable_timing=True)
            self._ev1.record(torch.cuda.current_stream(self._dev))
        self._span.attributes["execute_ms"] = round(
            (now - self._mono0) * 1000.0, 3
        )

    def transfer(self, nbytes: int, direction: str = "readback"):
        nbytes = int(nbytes)
        if direction == "upload":
            self._up += nbytes
        else:
            self._rb += nbytes
        key = f"{direction}_bytes"
        attrs = self._span.attributes
        attrs[key] = int(attrs.get(key, 0)) + nbytes
        if self._stmt and direction == "upload":
            # readback bytes are attributed (full vs delta) at the one
            # blessed crossing in query/readback.py; uploads only here
            stmt_stats.add("upload_bytes", int(nbytes))

    def _fold_program(self, sp, rec, *, dispatched: bool):
        """Fold the dispatch into the program registry (when one
        happened) + attach the program / roofline attribution to the
        span, EXPLAIN ANALYZE stats and the statement observation.
        A no-dispatch path (session hit) attributes without folding —
        and without per-call achieved rates, since no compute ran."""
        from greptimedb_tpu_torch.telemetry import device_programs

        reg = device_programs.global_programs
        # this call's execute ms: the events' span on the card once the
        # end event has completed (None while it has not), host time
        # elsewhere
        call_ms = self._exec_ms
        events = None
        if dispatched and self._ev1 is not None and call_ms is not None:
            events = (self._ev0, self._ev1)
            call_ms = (self._ev0.elapsed_time(self._ev1)
                       if self._ev1.query() else None)
        if dispatched:
            reg.finish(rec, execute_ms=self._exec_ms,
                       upload=self._up, readback=self._rb,
                       dispatch_only=self._dispatch_only,
                       run_start=self._run_t0 or None,
                       collective=self.collective,
                       comm_bytes=self.comm_bytes, events=events)
        if self._stmt:
            # program-registry link: the statement_statistics row lists
            # the program ids its executions used (dispatched, or
            # served from the program's session buffer)
            stmt_stats.note_program(rec.prog_id)
        roof = None
        if rec.analysis == "ok":
            pf, pb, _plat, _src = reg.peaks()
            bound, _pct = rec.roofline(pf, pb)
            gflops = gbps = pct = 0.0
            if (dispatched and call_ms and call_ms > 0
                    and not self._dispatch_only and not self._first):
                s = call_ms / 1000.0
                gflops = rec.flops / s / 1e9
                gbps = rec.bytes_accessed / s / 1e9
                if bound == "compute":
                    pct = gflops / (pf * 1e3) * 100.0
                elif bound == "memory":
                    pct = gbps / pb * 100.0
            roof = (bound, gflops, gbps, pct)
        traced = sp is not None and sp.trace_id
        if traced:
            sp.attributes["program"] = rec.prog_id
            if roof is not None:
                sp.attributes["flops"] = rec.flops
                if roof[0]:
                    sp.attributes["roofline_bound"] = roof[0]
                    if dispatched:
                        sp.attributes["pct_of_peak"] = round(roof[3], 3)
                if dispatched:
                    sp.attributes["achieved_gflops"] = round(roof[1], 3)
        from greptimedb_tpu_torch.query import stats as qstats

        if qstats.active() is not None:
            qstats.note(f"device_program_{self.site}", rec.prog_id)
            if roof is not None and roof[0]:
                if dispatched:
                    qstats.note(
                        f"roofline_{self.site}",
                        f"{roof[0]}-bound {roof[3]:.1f}% of peak "
                        f"({roof[1]:.1f} GFLOP/s, {roof[2]:.1f} GB/s)",
                    )
                else:
                    # steady-state row numbers: this call served from
                    # the session buffer, no program ran
                    _bound, row_pct = rec.roofline(pf, pb)
                    g, b = rec.achieved()
                    qstats.note(
                        f"roofline_{self.site}",
                        f"{roof[0]}-bound {row_pct:.1f}% of peak at "
                        f"p50 ({g:.1f} GFLOP/s, {b:.1f} GB/s; served "
                        "from the session buffer)",
                    )

    def __exit__(self, exc_type, exc, tb):
        sp = self._span
        rec = self._rec
        dispatched = rec is not None
        if rec is None:
            # no dispatch happened (session hit): when someone is
            # watching (trace / statement stats / EXPLAIN ANALYZE),
            # attribute the program row read-only — the warm steady
            # state must not lose the program link
            watching = self._stmt or (sp is not None and sp.trace_id)
            if not watching:
                from greptimedb_tpu_torch.query import stats as qstats

                watching = qstats.active() is not None
            if watching:
                from greptimedb_tpu_torch.telemetry import device_programs

                rec = device_programs.global_programs.lookup(
                    self.site, self.key
                )
        if rec is not None:
            self._fold_program(sp, rec, dispatched=dispatched)
        if sp is not None and sp.trace_id:
            # per-query device-bytes attribution: the HBM pinned by the
            # registered device pools at the moment this call finished
            # (telemetry/memory.py ledger), so every device.* span on a
            # trace shows what the chip was holding when it ran
            from greptimedb_tpu_torch.telemetry import memory as _memory

            acct = _memory.global_accountant
            if acct.enabled:
                # TTL-cached: a burst of traced device calls must not
                # take every pool's lock per span
                sp.attributes["device_pool_bytes"] = (
                    acct.device_bytes_cached()
                )
        return self._cm.__exit__(exc_type, exc, tb)
