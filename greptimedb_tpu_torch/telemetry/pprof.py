"""On-demand CPU and heap profiling behind HTTP debug routes.

Capability counterpart of the reference's pprof integration
(GreptimeDB's src/common/pprof/src/nix.rs — pprof-rs sampling CPU
profiler behind /debug/prof/cpu, src/servers/src/http/pprof.rs) and the
jemalloc heap dumps (GreptimeDB's src/common/mem-prof/, http/mem_prof.rs).

CPU: a sampling profiler over `sys._current_frames()` — the Python analog
of a SIGPROF sampler. Output is collapsed-stack (flamegraph) text or an
aggregated self/total report. Heap: tracemalloc snapshots with top
allocation sites.
"""

from __future__ import annotations

import sys
import threading

import time
from collections import Counter

from greptimedb_tpu_torch import concurrency

def sample_cpu(seconds: float = 1.0, hz: int = 99,
               *, skip_threads: tuple[str, ...] = ("pprof-sampler",)
               ) -> Counter:
    """Sample all thread stacks for `seconds` at `hz`. Returns a Counter
    of collapsed stacks ('outer;inner;leaf' -> samples)."""
    seconds = max(0.01, min(float(seconds), 60.0))
    hz = max(1, min(int(hz), 1000))
    interval = 1.0 / hz
    stacks: Counter = Counter()
    names = {}

    def loop():
        deadline = time.monotonic() + seconds
        while time.monotonic() < deadline:
            for tid, frame in sys._current_frames().items():
                name = names.get(tid)
                if name is None:
                    name = "thread"
                    for t in threading.enumerate():
                        if t.ident == tid:
                            name = t.name
                            break
                    names[tid] = name
                if name in skip_threads:
                    continue
                parts = []
                f = frame
                depth = 0
                while f is not None and depth < 128:
                    code = f.f_code
                    parts.append(
                        f"{code.co_name} "
                        f"({code.co_filename.rsplit('/', 1)[-1]}:"
                        f"{f.f_lineno})"
                    )
                    f = f.f_back
                    depth += 1
                parts.reverse()
                stacks[name + ";" + ";".join(parts)] += 1
            time.sleep(interval)

    t = concurrency.Thread(target=loop, name="pprof-sampler", daemon=True)
    t.start()
    t.join(seconds + 5.0)
    return stacks


def render_collapsed(stacks: Counter) -> str:
    """flamegraph.pl / speedscope-compatible collapsed stack lines."""
    return "\n".join(
        f"{stack} {count}" for stack, count in stacks.most_common()
    ) + ("\n" if stacks else "")


def render_speedscope(stacks: Counter, name: str = "cpu") -> str:
    """Speedscope file-format JSON (https://www.speedscope.app) from
    collapsed stacks: one `sampled` profile aggregating every thread,
    weights = sample counts. Drag the response onto speedscope (or
    `speedscope profile.json`) for an interactive flamegraph."""
    import json

    frame_index: dict[str, int] = {}
    frames: list[dict] = []
    samples: list[list[int]] = []
    weights: list[int] = []
    for stack, count in stacks.most_common():
        parts = stack.split(";")  # parts[0] is the thread name
        idxs = []
        for fr in parts:
            i = frame_index.get(fr)
            if i is None:
                i = frame_index[fr] = len(frames)
                frames.append({"name": fr})
            idxs.append(i)
        samples.append(idxs)
        weights.append(count)
    total = sum(weights)
    return json.dumps({
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "shared": {"frames": frames},
        "profiles": [{
            "type": "sampled",
            "name": name,
            "unit": "none",
            "startValue": 0,
            "endValue": total,
            "samples": samples,
            "weights": weights,
        }],
        "exporter": "greptimedb-tpu pprof",
    })


def render_report(stacks: Counter, top: int = 40) -> str:
    """Aggregated self-time report (like `pprof -top`)."""
    total = sum(stacks.values())
    self_c: Counter = Counter()
    total_c: Counter = Counter()
    for stack, n in stacks.items():
        frames = stack.split(";")[1:]  # drop the thread name
        if not frames:
            continue
        self_c[frames[-1]] += n
        for fr in set(frames):
            total_c[fr] += n
    lines = [f"samples: {total}", "",
             f"{'self':>8} {'self%':>7} {'total%':>7}  function"]
    for fn, n in self_c.most_common(top):
        lines.append(
            f"{n:>8} {100.0 * n / max(total, 1):>6.1f}% "
            f"{100.0 * total_c[fn] / max(total, 1):>6.1f}%  {fn}"
        )
    return "\n".join(lines) + "\n"


# ----------------------------------------------------------------------
# heap profiling (tracemalloc)
# ----------------------------------------------------------------------

_tracemalloc_lock = concurrency.Lock()
# previous snapshot for the ?diff=1 mode: growth since the LAST
# mem_profile call (either mode updates it), so two diff requests
# bracket exactly the interval between them
_last_snapshot = None


def mem_profile(top: int = 30, diff: bool = False) -> str:
    """Top heap allocation sites. Starts tracemalloc on first use (the
    first call reports allocations made after it — like enabling jemalloc
    profiling at runtime).

    diff=True reports top allocation-site GROWTH since the previous
    snapshot instead of absolute bytes — the mode that finds a slow
    host-side leak that absolute top-N hides under steady large
    allocations."""
    global _last_snapshot
    import tracemalloc

    with _tracemalloc_lock:
        if not tracemalloc.is_tracing():
            tracemalloc.start(8)
            return (
                "tracemalloc started; allocations are now being tracked.\n"
                "Request this endpoint again to see a snapshot.\n"
            )
        snap = tracemalloc.take_snapshot()
        prev, _last_snapshot = _last_snapshot, snap
    top = max(1, min(int(top), 200))
    current, peak = tracemalloc.get_traced_memory()
    head = f"traced current={current / 1e6:.1f}MB peak={peak / 1e6:.1f}MB"
    if diff:
        if prev is None:
            return (
                head + "\nno previous snapshot; request again to see "
                "allocation-site growth since this one.\n"
            )
        stats = snap.compare_to(prev, "lineno")
        lines = [
            head, "",
            f"{'growth':>12} {'count+':>8}  site (since previous "
            "snapshot)",
        ]
        shown = 0
        # compare_to sorts by ABS(size_diff): a large deallocation can
        # rank above every real growth site, so skip non-positive
        # entries instead of stopping at the first one
        for st in stats:
            if st.size_diff <= 0:
                continue
            if shown >= top:
                break
            frame = st.traceback[0]
            lines.append(
                f"{st.size_diff:>+12} {st.count_diff:>+8}  "
                f"{frame.filename.rsplit('/', 1)[-1]}:{frame.lineno}"
            )
            shown += 1
        if shown == 0:
            lines.append("(no allocation-site growth since the "
                         "previous snapshot)")
        return "\n".join(lines) + "\n"
    stats = snap.statistics("lineno")
    lines = [head, "", f"{'bytes':>12} {'count':>8}  site"]
    for st in stats[:top]:
        frame = st.traceback[0]
        lines.append(
            f"{st.size:>12} {st.count:>8}  "
            f"{frame.filename.rsplit('/', 1)[-1]}:{frame.lineno}"
        )
    return "\n".join(lines) + "\n"
