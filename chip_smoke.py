#!/usr/bin/env python3
"""Run the PyTorch/CUDA port of greptimedb_tpu on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--hosts 4000] [--hours 12]
                          [--mesh-hosts 8192] [--mesh-hours 6]
                          [--prom-series 1000000] [--hist-pods 12500]
                          [--rest-warm 5]

Phases (each failure raises; the script then exits non-zero and prints no
result line):

1. build   — compile the CUDA kernels from greptimedb_tpu_torch's sources
             (one nvcc per source, all at once) and print the card's name
             and power limit as nvidia-smi reports them.
2. slice   — the port's main path at TSBS devops cpu-only size: 4000 hosts
             (each in one of TSBS's 9 AWS regions), 12 h at 10 s, ten
             usage_* float64 fields = 17.28 M rows. Every hour is written
             as four 15-minute runs plus a late re-delivery run (10% of the
             hour's keys, new values, higher seq) and a tombstone run (1%).
             Every 1 h window is compacted on the card (merge program + K1,
             verify=True against the host merge), the range grid is built,
             and two RANGE queries run: Q1 = TSBS double-groupby-all
             (avg of all ten fields RANGE 1h ALIGN 1h BY hostname) and Q2 =
             count/sum/min/max/avg/stddev_samp/first/last of usage_user
             RANGE 2h ALIGN 1h BY region (the grouped fold, through K2).
             Kernel launch counts are zeroed just before this phase and
             read just after it.
3. check   — Q1/Q2 equal the same port run on the CPU (exact for counts,
             min/max, first/last, presence; Q1's sums within the stated
             reduction-order bound) and Q1 equals numpy hourly means over
             the deduplicated rows (rtol 1e-5).
4. kernels — K1 and K2 at the shapes the main path gave them, held against
             their plain PyTorch versions on the same inputs (bit-exact),
             and timed with CUDA events beside their plain versions, one
             PyTorch library call computing the same function, and the
             card's bound for the work.
5. profile — one warm Q1, Q2 and one window's merge under torch.profiler.
6. mesh    — the series-sharded RANGE path: TSBS devops at 8192 hosts (the
             JAX package's multichip probe size, past the planner's
             shard_min_series = 4096), 6 h at 10 s, written like phase 2
             and compacted on the card. Three engines run Q1 and Q2 cold,
             then warm (median of 5): one device; a mesh of the card named
             four times (four shards on one card) with default options,
             which must decide shard(large_grid) with the ring kernels;
             and the same mesh with kernels off (the gather twin). Q2 and
             Q1's keys, timestamps and presence must be bit-identical
             across the three; Q1's sums and means too, or within the
             reduction-order bound. Kernel counts are zeroed before each
             engine and read after it. Every shard lies on the one card, so
             the ring engine runs every ring in one launch: the fused ring
             kernel for each group fold, ring_pext_fused for each extreme
             and ring_psum_onehot_fused for each one-hot sum (12, 10 and 4
             per warm Q2), with no seed, continuation or hop combine; none
             of them may launch on the gather engine. Then each ring kernel
             at the shapes the mesh path gave it (the fused ring, fold_cont
             and block_partials also on edge bits and on misaligned rows,
             the fused ring against the hop ring; the hop combines on
             shards 0 and 1, their ring forms on all four) is held against
             its plain version and timed, with an empty kernel through the
             same launch path as the floor of a launch; one warm sharded Q2
             is profiled on every engine and on the hop ring (which must
             launch 12 seeds and 36 fold_cont per warm Q2, and the gather
             engine 48 block_partials); and each step of the kernels'
             host-side launch path is timed per call.
7. promql  — the PromQL fast path at the JAX package's PromQL benchmark
             size: 1,000,000 series (host_i, dc = i % 32), 10 samples at
             30 s, seed 11 (10 M rows), written through the port's Table.
             Four queries (sum by (dc) (rate(...[1m])), topk(5, ...),
             topk(100, ...), bottomk(100, ...), 8 steps) run through
             PromEngine.query_range on one device, on the card named four
             times with default options (shard(large_grid), the topk ring
             in one launch: ring_topk_merge_fused) and with kernels off
             (the gather twin), then the three topk queries on the ring
             engine with the ring hop by hop (merge_candidates): cold, warm
             (median of 5) and one profiled warm call each. The engines
             must agree bit for bit; the one-device topk results must equal
             the port on the CPU bit for bit, and the aggregate the CPU run
             within the bound of two matrix-product orders; per warm topk
             query the ring must launch ring_topk_merge_fused once and
             merge_candidates never, the hop ring merge_candidates three
             times, and the gather engine neither. Then both kernels at the
             path's shapes and on edge cases (ties, -inf, -0.0, NaN
             payloads and keys, unsorted, kl < k, 8 shards) are held
             against their plain versions and the ring also against the
             hop ring (bit for bit), and timed.
8. sql     — SQL in: Instance(...).sql(text) answers bench.py's TSBS RANGE
             suite (the headline double-groupby-all and its nine device
             shapes, bench.py:2131-2201, cut to the table's hours) and Q2
             written as SQL, over the tables of phases 2 and 6 (no new
             ingest): one device on the 4000-host table; one device, the
             fused ring (the default), the hop ring (RingFoldCtx with
             fused=False: K2's seed, then fold_cont hop by hop) and the
             gather twin on the 8192-host table over make_mesh([dev] * 4),
             each Instance on the query engine of phase 2 or 6 (its grid
             built; the hop ring shares the ring engine's). Each query
             runs cold (the first SQL run on that engine), warm (median
             of 3) and once under the profiler. Every shape must take the
             device path with bench.py's row count at the table's size;
             the SQL Q1/Q2 must equal the plan-built Q1/Q2 of phases 2
             and 6 bit for bit; the four mesh engines must agree bit for
             bit (Q1-shaped means within the reduction-order bound); the
             fused kernel must launch on every sharded query that folds
             groups, and on no other engine; the one-ring forms only on
             the fused ring and the hop combines only on the hop ring (per
             warm SQL Q2: 10 ring extremes and 4 ring one-hot sums, or 30
             extreme and 12 one-hot add hops, and none on gather).
             Kernel counts are zeroed before the phase and read after it.
             Then the warm SQL Q2 runs on the fused ring and the hop ring
             in turn, 30 times each, for their host walls.
9. rows    — SQL beyond RANGE on the tables of phases 2 and 6: GROUP BY on
             the card (bench.py's GROUP BY hostname probe, a nine-op GROUP
             BY region and its twin without stddev_samp, which the mesh
             shards) on one device per table, and on the 8192-host table
             as the fused ring (the ring extremes and one-hot sums, 4r and
             5r), the hop ring (4 and 5 hop by hop) and gather: cold, warm
             (median of 3) and one profiled warm call each. Every GROUP BY
             must take the device path and launch kernel G; the four mesh
             engines must agree bit for bit; group counts must equal a
             numpy bincount over the scan and avg the float64 mean (1e-5
             relative); per warm sharded GROUP BY the ring must launch 8
             ring extremes and 2 ring one-hot sums, the hop ring 24 and 6
             hops, gather none. Then the host paths on the 4000-host table:
             TSBS high-cpu-1 and high-cpu-all (twice: the second served by
             the merged-scan cache) against a numpy filter of the scan, and
             five RANGE shapes the device grid declines, cut to the first
             3 hours, each on the host path (the OR shape also against its
             IN twin on the grid, 1e-5 relative). Then G (both forms) and
             Gt at the shapes the GROUP BYs gave them, G's sum form also
             on 2^25 rows with uniform random group ids (4096 groups x
             256 blocks), and both on edge inputs (NaN, +-0, +-inf,
             masked and empty groups, misaligned rows, one group; ids
             uniform or in series order) against their plain versions,
             bit for bit, and timed, with each timed shape's segment
             statistics; Gt must make one kernel launch a call. Kernel
             counts are zeroed before the phase and read after its main
             path.
10. promql_rest — the rest of PromQL on phase 7's prom_bench table (no new
             ingest) and bench.py's hist_bucket (bench.py:2575-2616:
             12,500 pods x 8 le buckets = 100,000 series over 50 services,
             10 samples at 30 s, seed 13), 8 steps as bench.py runs them:
             a. sum by (dc) (rate / last_over_time) — bench's vector_div,
                the fast binary, matmul branch;
             b. sum by (dc) (quantile_over_time(0.9, ...[2m])) — bench's
                metric, the blocked fast path;
             c. max by (dc) (deriv(...[2m])) — the linear fit, its extreme
                through ring_pext_fused (4r) on the ring engine;
             d. sum by (dc) (holt_winters(...[2m], 0.5, 0.5));
             e. histogram_quantile(0.9, sum by (le, svc) (rate(hist_bucket
                [1m]))) — bench's histogram, matmul branch;
             f. the same by (le, pod): 100,000 aggregated series put G S
                past 2^28, so the scatter branch sums through kernel G;
             g. the generic engine on hist_bucket: query_instant of e at
                the last step (off the grid) and query_range of
                rate(hist_bucket[1m]) > 1;
             h. query_instant of f: the generic engine's float64 vectors
                through the scatter branch, G's float64 sum form.
             The phase runs in the JAX package's x64 mode
             (QueryEngine(x64=True)); h runs once more without it: float32
             vectors through G's float32 sum form, one G launch a warm
             query, exact against the port on the CPU in the same mode.
             Each query runs on one device, the card named four times with
             default options (ring) and with kernels off (gather): cold,
             warm (median of --rest-warm) and one profiled warm call. The
             engines must agree bit for bit; one device must equal the
             port on the CPU bit for bit (c, f, g's range query, h) or
             within the matrix-product bound (a, b, d, which also stay
             within MATMUL_READ_K sqrt(n) u sum|x|, a limit set from
             readings; e and g's instant query through the bound of their
             bucket sums); per warm query G must launch once a step on f
             and h on every engine and never on the others,
             ring_pext_fused once on c on the ring engine and nowhere else
             (counts zeroed before each query). A probe at a's product
             shape shows whether the check can tell full float32 from
             TF32: exactly summable data must come out exact, and TF32
             must not. Then G at f's shape (float32) and at h's (float64)
             against its plain version (bit for bit), timed beside
             index_add_ and its bound.
11. durable — durable storage: phase 2's writes (same seed, same rows in
             the same order, so the same sequences) through a table that
             a storage engine opened in a temporary data root, WAL on and
             wal_sync at its default (an acknowledged write survives a
             process crash, not a power loss): each hour's four runs as
             one batch (bench.py:2103-2120's hourly WAL batches), then its
             re-delivery and tombstone runs, a flush after each write.
             Compaction merges each hour's three SSTs on the card (K1 at
             262,144 rows and above, verified against the host merge).
             Hard checks: the full scan equals phase 2's in-memory region
             bit for bit after compaction and after a reopen; K1 launches
             once or more a merge of 262,144 rows or more; Q1 and Q2 on
             the recovered table equal phase 2's answers bit for bit (Q2
             through K2); after persist_entry a fresh engine's snapshot
             answers Q1/Q2 bit for bit without a rebuild; a child process
             writes one more 15-minute run and dies with os._exit before
             any flush, and the reopen reads back every acknowledged row;
             a second reopen after the recovery flush replays 0 WAL
             entries. Printed: rows/s with the WAL, flush and compaction
             seconds, K1 launches a merge, manifest load, WAL replay, SST
             restore (serial and pipelined) and open ms, snapshot cold
             time beside the rebuild's. K1 and K2 counts are zeroed before
             the phase and read after it. The data root is removed.

Output: one JSON line per phase, the nvidia-smi line, a {"kernels": [...]}
line, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

FIELDS = [
    "usage_user", "usage_system", "usage_idle", "usage_nice",
    "usage_iowait", "usage_irq", "usage_softirq", "usage_steal",
    "usage_guest", "usage_guest_nice",
]
AWS_REGIONS = [
    "us-east-1", "us-west-1", "us-west-2", "eu-west-1", "eu-central-1",
    "ap-southeast-1", "ap-southeast-2", "ap-northeast-1", "sa-east-1",
]
STEP_MS = 10_000
HOUR_MS = 3_600_000
Q2_OPS = ["count", "sum", "min", "max", "mean", "stddev_samp",
          "first_value", "last_value"]
# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s and float32
# and float64 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12   # float64 outside the tensor cores
U = 2.0 ** -24
# warm SQL Q2 runs per ring form in the sql phase's interleaved timing
Q2_WALL_REPS = 30


def _device() -> torch.device:
    return torch.device("cuda")


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20, warm=3) -> float:
    """Median of `reps` single-launch CUDA-event timings after warm-up."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def host_ms(fn, reps=20, warm=3) -> float:
    """Median host time of one call (its return, not its kernels': the
    card is synchronized after each call, outside the timing)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
    return float(np.median(times))


def profiled(fn, top=4):
    """One call of fn under torch.profiler: wall ms, summed device ms of
    kernels, copies and sets (None when the profiler saw no device
    activity), the copies' and sets' share of it (`copy_ms`), the device's
    idle share of the wall time, and the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    rows = []
    for evt in prof.key_averages():
        # device-side events only (kernels, memcpys, memsets): a CPU op's
        # device time repeats the time of the kernels it launched
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or evt.key.startswith("Activity Buffer")):
            continue
        us = evt.self_device_time_total
        if us:
            rows.append((us / 1e3, evt.key, evt.count))
    rows.sort(reverse=True)
    dev_ms = sum(r[0] for r in rows) if rows else None
    copy_ms = sum(r[0] for r in rows if r[1].startswith(("Memcpy", "Memset")))
    # the port's own kernels (csrc/*.cu keep them in an anonymous
    # namespace; torch's there name at:: types), by name with template
    # arguments
    ours = {}
    for ms, k, c in rows:
        k = k.removeprefix("void ")
        name = k.split("::", 1)[-1].split("(")[0]
        if k.startswith("(anonymous namespace)::") and "at::" not in name:
            ours[name] = {"ms": ms, "calls": c}
    return {
        "wall_ms": wall, "device_ms": dev_ms, "copy_ms": copy_ms,
        "idle_share": None if dev_ms is None else 1.0 - dev_ms / wall,
        "top": [{"kernel": k[:80], "ms": ms, "calls": c}
                for ms, k, c in rows[:top]],
        "ours": ours,
    }


def device_ms_per_launch(prof, match) -> float | None:
    """Profiler device time per launch of the port's kernels whose names
    satisfy `match` (None when the profile saw none)."""
    hits = [v for k, v in prof.get("ours", {}).items() if match(k)]
    calls = sum(v["calls"] for v in hits)
    return sum(v["ms"] for v in hits) / calls if calls else None


def make_plans(P):
    q1 = P.SelectPlan(
        kind="range",
        keys=[P.KeySpec("__key_0", P.Column("hostname"), "hostname")],
        range_items=[P.RangeItemSpec(f"__r_{i}", "mean", P.Column(f),
                                     HOUR_MS) for i, f in enumerate(FIELDS)],
        post_items=[(P.Column("__ts"), "ts"),
                    (P.Column("__key_0"), "hostname")]
        + [(P.Column(f"__r_{i}"), f"avg({f})") for i, f in enumerate(FIELDS)],
        align_ms=HOUR_MS, ts_out_name="__ts",
    )
    q2 = P.SelectPlan(
        kind="range",
        keys=[P.KeySpec("__key_0", P.Column("region"), "region")],
        range_items=[P.RangeItemSpec(f"__r_{i}", op, P.Column("usage_user"),
                                     2 * HOUR_MS)
                     for i, op in enumerate(Q2_OPS)],
        post_items=[(P.Column("__ts"), "ts"), (P.Column("__key_0"), "region")]
        + [(P.Column(f"__r_{i}"), f"{op}(usage_user)")
           for i, op in enumerate(Q2_OPS)],
        align_ms=HOUR_MS, ts_out_name="__ts",
    )
    return q1, q2


def tsbs_hours(rng, hosts, region_of, hours):
    """The TSBS runs, hour by hour: per hour the four 15-minute runs, then
    a late re-delivery of 10% of the hour's keys, then 1% tombstones, as
    ("put" | "delete", tags, ts, fields) in write order."""
    per_hour = HOUR_MS // STEP_MS
    per_run = per_hour // 4
    n_hosts = len(hosts)
    for h in range(hours):
        runs = []
        for r in range(4):
            t0 = h * per_hour + r * per_run
            ts = np.tile(np.arange(t0, t0 + per_run, dtype=np.int64)
                         * STEP_MS, n_hosts)
            hi = np.repeat(np.arange(n_hosts), per_run)
            fields = {f: (rng.random(len(ts), dtype=np.float32)
                          * 100.0).astype(np.float64) for f in FIELDS}
            runs.append(("put", {"hostname": hosts[hi],
                                 "region": region_of[hi]}, ts, fields))
        ts_h = np.tile(np.arange(h * per_hour, (h + 1) * per_hour,
                                 dtype=np.int64) * STEP_MS, n_hosts)
        hi_h = np.repeat(np.arange(n_hosts), per_hour)
        re = rng.random(len(ts_h)) < 0.10
        runs.append(("put", {"hostname": hosts[hi_h[re]],
                             "region": region_of[hi_h[re]]}, ts_h[re],
                     {f: (rng.random(int(re.sum()), dtype=np.float32)
                          * 100.0).astype(np.float64) for f in FIELDS}))
        dl = rng.random(len(ts_h)) < 0.01
        runs.append(("delete", {"hostname": hosts[hi_h[dl]],
                                "region": region_of[hi_h[dl]]}, ts_h[dl],
                     None))
        yield runs


def write_run(table, run):
    kind, tags, ts, fields = run
    if kind == "delete":
        return table.delete(tags, ts)
    return table.write(tags, ts, fields)


def ingest(table, rng, hosts, region_of, hours):
    """Write the TSBS runs; returns rows written."""
    written = 0
    for runs in tsbs_hours(rng, hosts, region_of, hours):
        for run in runs:
            written += write_run(table, run)
    return written


def compare_results(name, gpu, cpu, exact_ops, w):
    """GPU result vs the port's CPU result: exact for `exact_ops` columns,
    keys and ts; other float columns within the reduction-order bound
    2 * (w - 1) * 2^-24 (relative, values >= 0). Returns max |diff|."""
    if gpu.names != cpu.names or gpu.num_rows != cpu.num_rows:
        raise AssertionError(f"{name}: shape {gpu.names}/{gpu.num_rows} "
                             f"vs {cpu.names}/{cpu.num_rows}")
    worst = 0.0
    for i, col in enumerate(gpu.names):
        a, b = gpu.cols[i], cpu.cols[i]
        if not np.array_equal(a.valid_mask, b.valid_mask):
            raise AssertionError(f"{name}: presence of {col}")
        av, bv = np.asarray(a.values), np.asarray(b.values)
        if av.dtype == object or col == "ts":
            if not np.array_equal(av, bv):
                raise AssertionError(f"{name}: column {col}")
            continue
        m = a.valid_mask
        diff = np.abs(av[m] - bv[m])
        worst = max(worst, float(diff.max()) if diff.size else 0.0)
        if col.split("(")[0] in exact_ops:
            if not np.array_equal(av[m], bv[m]):
                raise AssertionError(f"{name}: {col} not bit-equal")
        elif not np.all(diff <= 2 * (w - 1) * U * np.abs(bv[m])):
            raise AssertionError(f"{name}: {col} past the bound")
    return worst


def check_q1_against_numpy(table, res, hosts):
    rows = table.scan(FIELDS).rows
    reg = table.region.series
    n_s = reg.num_series
    hours = int(rows.ts.max() // HOUR_MS) + 1
    key = rows.sid.astype(np.int64) * hours + rows.ts // HOUR_MS
    cnt = np.bincount(key, minlength=n_s * hours)
    host_sid = {h: i for i, h in enumerate(reg.tag_values("hostname"))}
    r_sid = np.array([host_sid[h] for h in res.column("hostname").values])
    r_key = r_sid * hours + res.column("ts").values // HOUR_MS
    worst = 0.0
    for f in FIELDS:
        mean = np.bincount(key, weights=rows.fields[f],
                           minlength=n_s * hours) / np.maximum(cnt, 1)
        got = res.column(f"avg({f})").values
        want = mean[r_key]
        if not np.allclose(got, want, rtol=1e-5, atol=0):
            raise AssertionError(f"Q1 {f} differs from numpy hourly means")
        worst = max(worst, float(np.max(np.abs(got - want) / want)))
    return worst


def window_rows(table, window):
    """The memtable runs of one compaction window, concatenated."""
    from greptimedb_tpu_torch.storage.memtable import _concat_rows

    return _concat_rows(table.region.memtable.partitions()[window],
                        table.field_names)


def k1_inputs(rows0, dev):
    """K1's main-path inputs for one window: the fused merge program's
    source indices and the (26, 2^21) plane matrix of the window's rows."""
    from greptimedb_tpu_torch.parallel.kernels import merge_gather as mg
    from greptimedb_tpu_torch.storage import device_merge as dm

    n = len(rows0)
    up, valids, pad = dm._prep_uploads(rows0, backfill=False, device=dev)
    n_keep_d, src_keep, _ = dm._merge_program(up, n, valids,
                                              drop_deletes=True, fused=True)
    n_out = dm._pad_to_bucket(int(n_keep_d))
    cols = [rows0.sid, rows0.ts, rows0.seq, rows0.op]
    cols += [rows0.fields[f] for f in FIELDS]
    big = np.concatenate([mg.pack_planes(np.asarray(c)) for c in cols])
    big = np.concatenate(
        [big, np.zeros((big.shape[0], pad - n), np.uint32)], axis=1)
    planes = torch.from_numpy(big.view(np.int32)).to(dev)
    return planes, src_keep[:n_out].contiguous()


def kernel_checks(dev, planes, src, entry, memo, launches):
    from greptimedb_tpu_torch.parallel.kernels import merge_gather as mg
    from greptimedb_tpu_torch.parallel.kernels import ring_fold as rf

    out = []
    # ---- K1 -------------------------------------------------------------
    p, n = planes.shape
    n_out = src.shape[0]
    got = mg.gather_planes(planes, src)
    want = mg.gather_planes_plain(planes, src)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K1 gather_planes differs from its plain version")
    # planes are bit patterns: the error is the largest difference of the
    # 32-bit words
    k1_err = float((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    k1_bytes = 4 * n_out * (1 + 2 * p)
    src64 = src.to(torch.int64)
    out.append({
        "name": "gather_planes", "route": "cuda",
        "source": "greptimedb_tpu_torch/parallel/kernels/csrc/merge_gather.cu",
        "replaces": "greptimedb_tpu/parallel/kernels/merge_gather.py:104",
        "launches": launches["gather_planes"],
        "max_abs_err": k1_err,
        "ms": cuda_ms(lambda: mg.gather_planes(planes, src)),
        "host_ms": host_ms(lambda: mg.gather_planes(planes, src)),
        "plain_ms": cuda_ms(lambda: mg.gather_planes_plain(planes, src)),
        "bound_ms": k1_bytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": cuda_ms(lambda: torch.index_select(planes, 1, src64)),
        "shape": {"P": p, "n": n, "n_out": n_out}, "bytes": k1_bytes,
    })
    # ---- K2 -------------------------------------------------------------
    # one device: every per-shard list of the entry holds one tensor
    fm = memo["fold_members"][0]
    arr_f = entry.fields["usage_user"]["s"][0]
    arr_i = entry.nrow[0]
    err = 0.0
    for arr in (arr_f, arr_i):
        got = rf.blocked_fold_sum(arr, fm)
        want = rf.blocked_fold_sum_plain(arr, fm)
        torch.cuda.synchronize()
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        if not same:
            raise AssertionError(
                f"K2 blocked_fold_sum ({arr.dtype}) differs from its plain "
                f"version")
        err = max(err, float((got.double() - want.double()).abs().max()))
    s, nb = arr_f.shape
    m = fm.member.numel()
    k2_bytes = 4 * m * nb + 4 * fm.g * nb + 4 * m + 4 * fm.ptr.numel()
    k2_ops = m * nb
    gid64 = memo["gid"][0].clamp(max=fm.g).to(torch.int64)

    def library():
        acc = torch.zeros((fm.g + 1, nb), dtype=arr_f.dtype, device=dev)
        return acc.index_add_(0, gid64, arr_f)

    bytes_ms = k2_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = k2_ops / F32_OPS_PER_S * 1e3
    out.append({
        "name": "blocked_fold_sum", "route": "cuda",
        "source": "greptimedb_tpu_torch/parallel/kernels/csrc/ring_fold.cu",
        "replaces": "greptimedb_tpu/parallel/kernels/ring_fold.py:34 "
                    "(_fold_seed_kernel) with "
                    "greptimedb_tpu/query/device_range.py:1509",
        "launches": launches["blocked_fold_sum"],
        "max_abs_err": err,
        "ms": cuda_ms(lambda: rf.blocked_fold_sum(arr_f, fm)),
        "host_ms": host_ms(lambda: rf.blocked_fold_sum(arr_f, fm)),
        "plain_ms": cuda_ms(lambda: rf.blocked_fold_sum_plain(arr_f, fm)),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": cuda_ms(library),
        "ms_int32": cuda_ms(lambda: rf.blocked_fold_sum(arr_i, fm)),
        "shape": {"S": s, "nb": nb, "g": fm.g, "fb": fm.fb, "members": m},
        "bytes": k2_bytes,
    })
    return out


RING_KERNELS = ("fold_cont", "extreme", "onehot_add", "ring_fold_fused",
                "ring_pext_fused", "ring_psum_onehot_fused")
# the hop ring's combines: phase 8's fused=False engine runs them
HOP_KERNELS = ("blocked_fold_sum", "fold_cont", "extreme", "onehot_add")
# the one-launch ring forms, on shards that share a card
ONE_RING_KERNELS = ("ring_fold_fused", "ring_pext_fused",
                    "ring_psum_onehot_fused")
# per warm mesh Q2 on four shards: 10 ring extremes and 4 ring one-hot
# sums (3 hops each on the hop ring)
Q2_RINGS = {"ring_pext_fused": 10, "ring_psum_onehot_fused": 4,
            "ring_fold_fused": 12}
Q2_HOPS = {"extreme": 30, "onehot_add": 12}
# per warm mesh Q2 on four shards: the hop ring's 12 folds (a seed and
# three fold_cont each), the gather twin's (block_partials on each shard)
Q2_HOP_FOLDS = {"blocked_fold_sum": 12, "fold_cont": 36}
Q2_GATHER_FOLDS = {"block_partials": 48}
FOLD_KERNELS = ("blocked_fold_sum", "block_partials") + RING_KERNELS
# the topk ring's kernels: the merge hop and the ring in one launch
TOPK_KERNELS = ("merge_candidates", "ring_topk_merge_fused")


def counts(rf, mg):
    """Launch counts of every kernel wrapper."""
    return {"gather_planes": mg.gather_planes.launches,
            **{f: getattr(rf, f).launches for f in FOLD_KERNELS}}


def zero_counts(rf, mg):
    mg.gather_planes.launches = 0
    for f in FOLD_KERNELS:
        getattr(rf, f).launches = 0


@contextlib.contextmanager
def ring_form(form):
    """Run the ring engines' rings as `form`: "fused" is the devices' own
    choice for shards on one card (one launch a ring); "hops" is
    RingFoldCtx(ns, fused=False) (K2's seed, then fold_cont hop by hop)
    and ring_topk_merge_hops (merge_candidates hop by hop), which the
    query paths take while this block is open."""
    if form != "hops":
        yield
        return
    from greptimedb_tpu_torch.parallel.kernels import ring_fold
    from greptimedb_tpu_torch.parallel.kernels import topk_merge as tm

    real, real_topk = ring_fold.RingFoldCtx, tm.ring_topk_merge
    ring_fold.RingFoldCtx = functools.partial(real, fused=False)
    tm.ring_topk_merge = tm.ring_topk_merge_hops
    try:
        yield
    finally:
        ring_fold.RingFoldCtx, tm.ring_topk_merge = real, real_topk


def _bits(v):
    v = np.asarray(v)
    return v.view(np.uint64) if v.dtype == np.float64 else v


def same_column(a, b) -> bool:
    """Values bit for bit (NaN equal to NaN) and presence."""
    va, vb = np.asarray(a.values), np.asarray(b.values)
    if not np.array_equal(a.valid_mask, b.valid_mask) or va.shape != vb.shape:
        return False
    if va.dtype == object:
        return bool((va == vb).all())
    return bool(np.array_equal(_bits(va), _bits(vb)))


def compare_engines(name, ref, got, w, bounded=(), names=True):
    """`got` against `ref` column by column: bit-identical, except the
    columns named in `bounded` (Q1's disjoint-window means), whose keys,
    presence and timestamps must still be identical and whose values stay
    within 2 (w - 1) 2^-24 relative. names=False compares columns by
    position (a SQL result against a plan-built one). Returns (identical,
    max rel diff)."""
    if ((names and got.names != ref.names)
            or len(got.names) != len(ref.names)
            or got.num_rows != ref.num_rows):
        raise AssertionError(f"{name}: shape {got.names}/{got.num_rows} vs "
                             f"{ref.names}/{ref.num_rows}")
    identical, worst = True, 0.0
    for col, a, b in zip(ref.names, ref.cols, got.cols):
        if same_column(a, b):
            continue
        if col not in bounded or not np.array_equal(a.valid_mask,
                                                     b.valid_mask):
            raise AssertionError(f"{name}: column {col} differs")
        identical = False
        m = a.valid_mask
        av, bv = np.asarray(a.values)[m], np.asarray(b.values)[m]
        rel = np.abs(av - bv) / np.abs(av)
        worst = max(worst, float(rel.max()))
        if not np.all(np.abs(av - bv) <= 2 * (w - 1) * U * np.abs(av)):
            raise AssertionError(f"{name}: {col} past the bound")
    return identical, worst


def mesh_kernel_rows(dev, entry, memo, launches):
    """The ring kernels and K2's partials form at the shapes the sharded
    Q2 gave them (shards 0 and 1 of the ring engine's grid), held against
    their plain versions and timed."""
    from greptimedb_tpu_torch.parallel.kernels import ring_fold as rf
    from greptimedb_tpu_torch.query import device_range as dr

    fms, gids, g = memo["fold_members"], memo["gid"], memo["g"]
    st = entry.fields["usage_user"]
    nb = entry.nb
    plane = g * nb

    def exact(name, got, want):
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"{name} differs from its plain version")
        return float((got.double() - want.double()).abs().max())

    def bound(nbytes, ops):
        b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
        return {"bound_ms": max(b_ms, o_ms),
                "bound_by": "bytes" if b_ms >= o_ms else "operations"}

    src = "greptimedb_tpu_torch/parallel/kernels/csrc/ring_fold.cu"
    walk_src = ("greptimedb_tpu_torch/parallel/kernels/csrc/"
                "ring_fold_fused.cu")
    rows = []
    # ---- row 3: K2's continuation, shard 1 onto shard 0's seed ----------
    fm = fms[1]
    m = fm.member.numel()
    err = 0.0
    for arr0, arr1 in ((st["s"][0], st["s"][1]), (entry.nrow[0],
                                                  entry.nrow[1])):
        acc = rf.blocked_fold_sum(arr0, fms[0])
        err = max(err, exact("fold_cont", rf.fold_cont(acc, arr1, fm),
                             rf.fold_cont_plain(acc, arr1, fm)))
    # the walk's two single-shard forms on edge bits, on rows one element
    # past a 16-byte boundary (the 4-byte copies) and on an odd cell count
    rng = np.random.default_rng(29)
    s_local = st["s"][1].shape[0]
    for width, off in ((nb, 0), (nb, 1), (nb + 1, 1)):
        flat = torch.from_numpy(ring_edge_input(
            rng, s_local + 1, width, "f32")).to(dev).reshape(-1)
        x = flat[off:off + s_local * width].view(s_local, width)
        a0 = torch.from_numpy(ring_edge_input(rng, g, width, "f32")).to(dev)
        a0[:, ::7] = -0.0
        what = f"({width} cells, {'misaligned' if off else 'aligned'})"
        exact(f"fold_cont {what}", rf.fold_cont(a0, x, fm),
              rf.fold_cont_plain(a0, x, fm))
        exact(f"block_partials {what}", rf.block_partials(x, fm),
              rf.block_partials_plain(x, fm))
    acc = rf.blocked_fold_sum(st["s"][0], fms[0])
    acc_i = rf.blocked_fold_sum(entry.nrow[0], fms[0])
    arr1 = st["s"][1]
    gid64 = gids[1].clamp(max=g).to(torch.int64)

    def index_add():
        return torch.zeros((g + 1, nb), dtype=torch.float32,
                           device=dev).index_add_(0, gid64, arr1)

    cont_bytes = 4 * m * nb + 2 * 4 * plane
    rows.append({
        "name": "fold_cont", "route": "cuda", "source": walk_src,
        "replaces": "greptimedb_tpu/parallel/kernels/ring_fold.py:44 "
                    "(_fold_cont_kernel, through _call2:84)",
        "launches": launches["fold_cont"], "max_abs_err": err,
        "ms": cuda_ms(lambda: rf.fold_cont(acc, arr1, fm)),
        "host_ms": host_ms(lambda: rf.fold_cont(acc, arr1, fm)),
        "plain_ms": cuda_ms(lambda: rf.fold_cont_plain(acc, arr1, fm)),
        **bound(cont_bytes, m * nb + fm.fb * plane),
        "library_ms": cuda_ms(index_add),
        "ms_int32": cuda_ms(lambda: rf.fold_cont(acc_i, entry.nrow[1], fm)),
        "shape": {"s_local": arr1.shape[0], "nb": nb, "g": g,
                  "fb_local": fm.fb, "members": m},
        "bytes": cont_bytes, "design": walk_design(rf, "fold_cont"),
    })
    # ---- rows 4 and 5: the hop form on shards 0 and 1, the one-launch
    # ring form over all ns shards: the extreme, f32 (the m plane) and
    # int32 (win_t), and the one-hot add (first/last winner values) ------
    ns = len(fms)
    xs = {tm: [dr._segment_ext(st["mx" if tm else "mn"][k], gids[k], g, tm)
               for k in range(ns)] for tm in (True, False)}
    ts = [dr._segment_ext(st["il"][k], gids[k], g, True) for k in range(ns)]
    err = 0.0
    for tm in (True, False):
        a, b = xs[tm][:2]
        err = max(err, exact("extreme", rf.extreme(a, b, tm),
                             rf.extreme_plain(a, b, tm)))
    exact("extreme int32", rf.extreme(ts[0], ts[1], True),
          rf.extreme_plain(ts[0], ts[1], True))
    ring_err = 0.0
    for planes in (xs[True], xs[False], ts):
        for tm in (True, False):
            got = rf.ring_pext_fused(planes, tm)[0]
            want = rf.ring_pext_fused_plain(planes, tm)[0]
            ring_err = max(ring_err, exact("ring_pext_fused", got, want))
            exact("ring_pext_fused against the hop ring", got,
                  rf.ring_pext(planes, tm)[0])
    win_t = rf.ring_pext_fused(ts, True)[0]
    has = [st["n"][k] > 0 for k in range(ns)]
    oh = [dr._segment_sum_onehot(torch.where(
        has[k] & (st["il"][k] == win_t[gids[k].clamp(max=g - 1).long()]),
        st["vl"][k], 0.0), gids[k], g) for k in range(ns)]
    floor = {"launch_floor_ms": cuda_ms(lambda: rf.noop(dev)),
             "launch_floor_host_ms": host_ms(lambda: rf.noop(dev))}
    pext4 = xs[True]
    a, b = pext4[:2]

    def max_chain():
        acc = pext4[0]
        for x in pext4[1:]:
            acc = torch.maximum(acc, x)
        return acc

    pext_ring = {
        "ring_ms": cuda_ms(lambda: rf.ring_pext_fused(pext4, True)),
        "ring_host_ms": host_ms(lambda: rf.ring_pext_fused(pext4, True)),
        "ring_plain_ms": cuda_ms(
            lambda: rf.ring_pext_fused_plain(pext4, True)),
        "ring_bound_ms": 4 * (ns + 1) * plane / HBM_BYTES_PER_S * 1e3,
        "library_chain_ms": cuda_ms(max_chain),
        "ring_ms_int32": cuda_ms(lambda: rf.ring_pext_fused(ts, True)),
    }
    rows.append({
        "name": "extreme", "route": "cuda", "source": src,
        "replaces": "greptimedb_tpu/parallel/kernels/ring_fold.py:53 "
                    "(_ext_max_kernel) and :59 (_ext_min_kernel), through "
                    "_call2:84",
        "launches": launches["extreme"], "max_abs_err": err,
        "ms": cuda_ms(lambda: rf.extreme(a, b, True)),
        "host_ms": host_ms(lambda: rf.extreme(a, b, True)),
        "plain_ms": cuda_ms(lambda: rf.extreme_plain(a, b, True)),
        **bound(3 * 4 * plane, plane),
        "library_ms": cuda_ms(lambda: torch.maximum(a, b)),
        "ms_int32": cuda_ms(lambda: rf.extreme(ts[0], ts[1], True)),
        **pext_ring, **floor,
        "shape": {"g": g, "nb": nb, "ring_shards": ns},
    })
    rows.append({
        "name": "ring_pext_fused", "route": "cuda", "source": src,
        "replaces": "greptimedb_tpu/parallel/kernels/ring_fold.py:109 "
                    "ring_pext (the chain of _ext_max_kernel:53 or "
                    "_ext_min_kernel:59 through _call2:80, hop by hop)",
        "launches": launches["ring_pext_fused"], "max_abs_err": ring_err,
        "ms": pext_ring["ring_ms"], "host_ms": pext_ring["ring_host_ms"],
        "plain_ms": pext_ring["ring_plain_ms"],
        **bound(4 * (ns + 1) * plane, (ns - 1) * plane),
        "library_ms": pext_ring["library_chain_ms"],
        "ms_int32": pext_ring["ring_ms_int32"], **floor,
        "shape": {"shards": ns, "g": g, "nb": nb},
    })

    def add_chain():
        acc = oh[0]
        for x in oh[1:]:
            acc = torch.add(acc, x)
        return acc

    err = exact("onehot_add", rf.onehot_add(oh[0], oh[1]),
                rf.onehot_add_plain(oh[0], oh[1]))
    got = rf.ring_psum_onehot_fused(oh)[0]
    ring_err = exact("ring_psum_onehot_fused", got,
                     rf.ring_psum_onehot_fused_plain(oh)[0])
    exact("ring_psum_onehot_fused against the hop ring", got,
          rf.ring_psum_onehot(oh)[0])
    psum_ring = {
        "ring_ms": cuda_ms(lambda: rf.ring_psum_onehot_fused(oh)),
        "ring_host_ms": host_ms(lambda: rf.ring_psum_onehot_fused(oh)),
        "ring_plain_ms": cuda_ms(
            lambda: rf.ring_psum_onehot_fused_plain(oh)),
        "ring_bound_ms": 4 * (ns + 1) * plane / HBM_BYTES_PER_S * 1e3,
        "library_chain_ms": cuda_ms(add_chain),
    }
    rows.append({
        "name": "onehot_add", "route": "cuda", "source": src,
        "replaces": "greptimedb_tpu/parallel/kernels/ring_fold.py:65 "
                    "(_add_kernel, through _call2:84)",
        "launches": launches["onehot_add"], "max_abs_err": err,
        "ms": cuda_ms(lambda: rf.onehot_add(oh[0], oh[1])),
        "host_ms": host_ms(lambda: rf.onehot_add(oh[0], oh[1])),
        "plain_ms": cuda_ms(lambda: rf.onehot_add_plain(oh[0], oh[1])),
        **bound(3 * 4 * plane, plane),
        "library_ms": cuda_ms(lambda: torch.add(oh[0], oh[1])),
        **psum_ring, **floor,
        "shape": {"g": g, "nb": nb, "ring_shards": ns},
    })
    rows.append({
        "name": "ring_psum_onehot_fused", "route": "cuda", "source": src,
        "replaces": "greptimedb_tpu/parallel/kernels/ring_fold.py:122 "
                    "ring_psum_onehot (the chain of _add_kernel:65 through "
                    "_call2:80, hop by hop)",
        "launches": launches["ring_psum_onehot_fused"],
        "max_abs_err": ring_err,
        "ms": psum_ring["ring_ms"], "host_ms": psum_ring["ring_host_ms"],
        "plain_ms": psum_ring["ring_plain_ms"],
        **bound(4 * (ns + 1) * plane, (ns - 1) * plane),
        "library_ms": psum_ring["library_chain_ms"], **floor,
        "shape": {"shards": ns, "g": g, "nb": nb},
    })
    # ---- K2's partials form (the gather twin's block partials) ----------
    err = exact("block_partials", rf.block_partials(arr1, fm),
                rf.block_partials_plain(arr1, fm))
    per = fm.s // fm.fb
    bid = torch.arange(fm.s, device=dev) // per
    seg = torch.where(gids[1] < g, bid * g + gids[1], fm.fb * g).long()
    partials_bytes = 4 * m * nb + 4 * fm.fb * plane
    rows.append({
        "name": "block_partials", "route": "cuda", "source": walk_src,
        "replaces": "greptimedb_tpu/query/device_range.py:1509 (blocked_sum"
                    "'s per-block segment_sum, which the gather program "
                    "concatenates across shards)",
        "launches": launches["block_partials"], "max_abs_err": err,
        "ms": cuda_ms(lambda: rf.block_partials(arr1, fm)),
        "host_ms": host_ms(lambda: rf.block_partials(arr1, fm)),
        "plain_ms": cuda_ms(lambda: rf.block_partials_plain(arr1, fm)),
        **bound(partials_bytes, m * nb),
        "library_ms": cuda_ms(lambda: torch.zeros(
            (fm.fb * g + 1, nb), device=dev).index_add_(0, seg, arr1)),
        "shape": {"s_local": arr1.shape[0], "nb": nb, "g": g,
                  "fb_local": fm.fb, "members": m},
        "bytes": partials_bytes, "design": walk_design(rf, "block_partials"),
    })
    # ---- row 6: the fused ring over every shard, one launch a fold ------
    s_f, s_i = list(st["s"]), list(entry.nrow)
    err = 0.0
    for arrs in (s_f, s_i):
        got, want = rf.ring_fold_fused(arrs, fms), rf.ring_fold_fused_plain(
            arrs, fms)
        hops = rf.ring_fold_blocks(arrs, fms)
        for k in range(ns):
            err = max(err, exact("ring_fold_fused", got[k], want[k]))
            exact("ring_fold_fused against the hop ring", got[k], hops[k])
    # edge bits at the path's shapes and member lists: NaN payloads, -0.0,
    # ±inf, int32 sums that wrap (the card's add gives its canonical NaN
    # in kernel and plain version alike)
    rng = np.random.default_rng(23)
    for dtype in ("f32", "i32"):
        edge = [torch.from_numpy(ring_edge_input(rng, s_local, nb, dtype))
                .to(dev) for _ in range(ns)]
        got, want = rf.ring_fold_fused(edge, fms), rf.ring_fold_fused_plain(
            edge, fms)
        for k in range(ns):
            exact(f"ring_fold_fused ({dtype} edge bits)", got[k], want[k])
    # rows one element past a 16-byte boundary (views into a larger
    # tensor), at the path's cell count and at an odd one: the 4-byte
    # copies, on ragged tiles
    s_local = s_f[0].shape[0]
    for width in (nb, nb + 1):
        flat = [torch.from_numpy(ring_edge_input(
            rng, s_local + 1, width, "f32")).to(dev).reshape(-1)
            for _ in range(ns)]
        mis = [f[1:1 + s_local * width].view(s_local, width) for f in flat]
        got, want = rf.ring_fold_fused(mis, fms), rf.ring_fold_fused_plain(
            mis, fms)
        for k in range(ns):
            exact(f"ring_fold_fused (misaligned, {width} cells)", got[k],
                  want[k])
    m_all = sum(f.member.numel() for f in fms)
    # what the function must move: the member rows in, ns outputs out. The
    # ring's hops (2(ns - 1) stores and loads of the plane) are the
    # algorithm's, pass through L2 on one card, and are reported apart for
    # the cell where they cross cards
    fused_bytes = 4 * m_all * nb + 4 * ns * plane
    hop_bytes = 2 * 2 * (ns - 1) * 4 * plane
    arr_all = torch.cat(s_f)
    gid_all = torch.cat([gd.clamp(max=g) for gd in gids]).to(torch.int64)
    rows.append({
        "name": "ring_fold_fused", "route": "cuda",
        "source": "greptimedb_tpu_torch/parallel/kernels/csrc/"
                  "ring_fold_fused.cu",
        "replaces": "greptimedb_tpu/parallel/kernels/ring_fold.py:217 "
                    "_tpu_ring_fold_call",
        "launches": launches["ring_fold_fused"], "max_abs_err": err,
        "ms": cuda_ms(lambda: rf.ring_fold_fused(s_f, fms)),
        "plain_ms": cuda_ms(lambda: rf.ring_fold_fused_plain(s_f, fms)),
        **bound(fused_bytes, m_all * nb + ns * fms[0].fb * plane),
        # the total once (not on every shard), over the shards' rows laid
        # end to end
        "library_ms": cuda_ms(lambda: torch.zeros(
            (g + 1, nb), device=dev).index_add_(0, gid_all, arr_all)),
        "ms_int32": cuda_ms(lambda: rf.ring_fold_fused(s_i, fms)),
        # the hop ring on the same inputs: K2's seed + ns - 1 fold_cont
        "hops_ms": cuda_ms(lambda: rf.ring_fold_blocks(s_f, fms)),
        # the wrappers' host time alone (events time = host time until
        # the launch + the kernels' time)
        "host_ms": host_ms(lambda: rf.ring_fold_fused(s_f, fms)),
        "hops_host_ms": host_ms(lambda: rf.ring_fold_blocks(s_f, fms)),
        "shape": {"shards": ns, "s_local": s_local, "nb": nb, "g": g,
                  "fb_local": fms[0].fb, "members": m_all},
        "bytes": fused_bytes, "bytes_hops": hop_bytes,
        "design": walk_design(rf, "ring_fold_fused"),
    })
    return rows


def walk_design(rf, row):
    """The constants that csrc/ring_fold_fused.cu was built with, as its
    library reports them: cells a tile, rows in a thread's ring of cp.async
    slots, rows a wait, rows in flight, the bytes of one copy on aligned
    and on misaligned rows, and 1 where this row's form runs full groups
    of rows unrolled. The tile must be the one the wrappers size the
    counts by."""
    from greptimedb_tpu_torch.parallel.kernels import build

    out = (ctypes.c_int * (6 + len(WALK_FORMS)))()
    build.load("ring_fold_fused").gtt_ring_fold_fused_design(out)
    keys = ("tile_cells", "ring_slots", "rows_per_wait", "rows_in_flight",
            "copy_bytes", "misaligned_copy_bytes")
    design = dict(zip(keys, out))
    design["unrolled_groups"] = out[6 + WALK_FORMS[row]]
    if design["tile_cells"] != rf._FUSED_CELLS:
        raise AssertionError(f"ring_fold_fused built with tiles of "
                             f"{design['tile_cells']} cells, the wrappers "
                             f"size them as {rf._FUSED_CELLS}")
    return design


def ring_edge_input(rng, s_local, nb, dtype):
    """One shard's (s_local, nb) states with the fold's edge bits: float32
    with wide magnitudes, -0.0 (a whole cell of it), ±inf in two cells of
    three and NaN payloads in the third; int32 with extremes whose sums
    wrap."""
    if dtype == "i32":
        x = rng.integers(-1000, 1000, (s_local, nb)).astype(np.int32)
        r = rng.random(x.shape)
        x[r < 0.05] = 2**31 - 1
        x[(r >= 0.05) & (r < 0.1)] = -(2**31)
        return x
    x = (rng.standard_normal((s_local, nb))
         * 10.0 ** rng.integers(-4, 5, (s_local, nb))).astype(np.float32)
    r = rng.random(x.shape)
    x[r < 0.1] = -0.0
    x[:, nb // 2] = -0.0
    inf_cell = np.arange(nb) % 3 != 0
    inf_cell[nb // 2] = False
    x[(r >= 0.1) & (r < 0.12) & inf_cell] = np.inf
    x[(r >= 0.12) & (r < 0.14) & inf_cell] = -np.inf
    nan = (r >= 0.14) & (r < 0.15) & ~inf_cell
    bits = (rng.integers(0, 2**22, x.shape) | 0x7FC00000).astype(np.uint32)
    x[nan] = bits.view(np.float32)[nan]
    return x


def mesh_phase(args, dev, P):
    from greptimedb_tpu_torch.catalog.table import Table
    from greptimedb_tpu_torch.parallel.kernels import merge_gather as mg
    from greptimedb_tpu_torch.parallel.kernels import ring_fold as rf
    from greptimedb_tpu_torch.parallel.mesh import MeshOptions, make_mesh
    from greptimedb_tpu_torch.query.executor import QueryEngine

    t_phase = time.perf_counter()
    rng = np.random.default_rng(args.seed + 1)
    hosts = np.array([f"host_{i}" for i in range(args.mesh_hosts)])
    region_of = np.array(AWS_REGIONS)[rng.integers(0, len(AWS_REGIONS),
                                                    args.mesh_hosts)]
    table = Table("cpu", ts_name="ts", tag_names=["hostname", "region"],
                  fields=FIELDS)
    q1, q2 = make_plans(P)
    zero_counts(rf, mg)
    seconds = {}
    t = time.perf_counter()
    written = ingest(table, rng, hosts, region_of, args.mesh_hours)
    seconds["ingest"] = time.perf_counter() - t
    t = time.perf_counter()
    table.compact(device=dev, kernels="on")
    torch.cuda.synchronize()
    seconds["compact"] = time.perf_counter() - t
    compact_counts = counts(rf, mg)

    mesh = make_mesh([dev] * 4)
    engines = {
        "single": QueryEngine(device=dev),
        "ring": QueryEngine(device=dev, mesh=mesh),
        "gather": QueryEngine(device=dev, mesh=mesh,
                              mesh_opts=MeshOptions(pallas_kernels="off")),
    }
    results, per_engine, info = {}, {}, {}
    for name, eng in engines.items():
        zero_counts(rf, mg)
        timing, warm_launches = {}, {}
        for qn, plan in (("q1", q1), ("q2", q2)):
            t = time.perf_counter()
            results[name, qn] = eng.execute(plan, table)
            torch.cuda.synchronize()
            timing[f"{qn}_cold"] = time.perf_counter() - t
        for qn, plan in (("q1", q1), ("q2", q2)):
            times = []
            before = counts(rf, mg)
            for _ in range(5):
                t = time.perf_counter()
                eng.execute(plan, table)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
            after = counts(rf, mg)
            warm_launches[qn] = {k: (after[k] - before[k]) / 5
                                 for k in after if after[k] > before[k]}
            timing[f"{qn}_warm_median"] = float(np.median(times))
            info[name, qn] = dict(eng.last_range)
        per_engine[name] = {"seconds": timing, "launches": counts(rf, mg),
                            "launches_per_warm_query": warm_launches,
                            "q1": info[name, "q1"], "q2": info[name, "q2"]}
    launches = {k: compact_counts[k] + sum(
        per_engine[e]["launches"][k] for e in engines) for k in compact_counts}

    ring_q2 = info["ring", "q2"]
    if (ring_q2["decision"] != "shard(large_grid)"
            or ring_q2["kernel"] != "ring(ring_fold)"
            or ring_q2["ring_form"] != "fused"
            or ring_q2["shards"] != 4):
        raise AssertionError(f"ring engine decided {ring_q2}")
    if info["gather", "q2"]["kernel"] != "gather(kernels_off)":
        raise AssertionError(f"gather engine decided {info['gather', 'q2']}")
    # every ring is one launch on shards that share the card: no seed,
    # continuation or hop combine on the ring engine (the hop ring runs in
    # phase 8)
    ring_l = per_engine["ring"]["launches"]
    for k in ONE_RING_KERNELS:
        if ring_l[k] == 0:
            raise AssertionError(f"{k} never launched on the ring engine")
    for k in HOP_KERNELS:
        if ring_l[k] != 0:
            raise AssertionError(f"{k} launched on the fused ring engine")
    warm_q2 = per_engine["ring"]["launches_per_warm_query"]["q2"]
    for k, n in {**Q2_RINGS, "extreme": 0, "onehot_add": 0}.items():
        if warm_q2.get(k, 0) != n:
            raise AssertionError(f"{k}: {warm_q2.get(k, 0)} launches per "
                                 f"warm mesh Q2 on the ring engine, not {n}")
    for k in RING_KERNELS:
        if per_engine["gather"]["launches"][k] != 0:
            raise AssertionError(f"{k} launched on the gather engine")
    for k, n in launches.items():
        if n == 0 and k not in ("fold_cont", *Q2_HOPS):
            raise AssertionError(f"kernel {k} never launched on the mesh "
                                 f"path")

    # ---- checks -------------------------------------------------------
    w1, w2 = HOUR_MS // STEP_MS, 2 * HOUR_MS // STEP_MS
    r1, r2 = results["single", "q1"], results["single", "q2"]
    if r1.num_rows != args.mesh_hosts * args.mesh_hours:
        raise AssertionError(f"mesh Q1 rows {r1.num_rows}")
    if r2.num_rows != len(set(region_of)) * (args.mesh_hours + 1):
        raise AssertionError(f"mesh Q2 rows {r2.num_rows}")
    means = {f"avg({f})" for f in FIELDS}
    checks = {}
    for name in ("ring", "gather"):
        compare_engines(f"{name} Q2", r2, results[name, "q2"], w2)
        ident, worst = compare_engines(f"{name} Q1", r1, results[name, "q1"],
                                       w1, bounded=means)
        checks[name] = {"q2_identical": True, "q1_identical": ident,
                        "q1_max_rel_diff": worst}
    compare_engines("ring vs gather Q2", results["ring", "q2"],
                    results["gather", "q2"], w2)

    # ---- kernels at the mesh path's shapes, and one warm profile -------
    ring = engines["ring"]
    entry = next(iter(ring.range_cache._entries.values()))
    memo = next(m for m in entry.query_memo.values() if m["fold"])
    t = time.perf_counter()
    rows = mesh_kernel_rows(dev, entry, memo, launches)
    kernel_seconds = time.perf_counter() - t
    profs = {name: profiled(lambda: eng.execute(q2, table))
             for name, eng in engines.items()}
    # the hop ring on the ring engine's grid (one warm-up run first): the
    # hop combines' device time, which the fused engine no longer launches
    with ring_form("hops"):
        ring.execute(q2, table)
        before = counts(rf, mg)
        profs["hops"] = profiled(lambda: ring.execute(q2, table))
        after = counts(rf, mg)
    hops_q2 = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    gather_q2 = per_engine["gather"]["launches_per_warm_query"]["q2"]
    for engine_name, warm, want in (("hop ring", hops_q2, Q2_HOP_FOLDS),
                                    ("gather", gather_q2, Q2_GATHER_FOLDS)):
        for k, n in want.items():
            if warm.get(k, 0) != n:
                raise AssertionError(f"{k}: {warm.get(k, 0)} launches per "
                                     f"warm mesh Q2 on the {engine_name} "
                                     f"engine, not {n}")
    # device time per launch on the warm Q2 (the events' times above
    # include the wrapper's host overhead when it outlasts the kernel)
    per_launch = {
        "extreme": device_ms_per_launch(
            profs["hops"], lambda k: k.startswith("extreme_")),
        "onehot_add": device_ms_per_launch(
            profs["hops"], lambda k: k.startswith("onehot_add")),
        "fold_cont": device_ms_per_launch(profs["hops"], walk("fold_cont")),
        "block_partials": device_ms_per_launch(profs["gather"],
                                               walk("block_partials")),
        "ring_fold_fused": device_ms_per_launch(profs["ring"],
                                                walk("ring_fold_fused")),
        "ring_pext_fused": device_ms_per_launch(profs["ring"],
                                                ring_combine(0, 1, 2, 3)),
        "ring_psum_onehot_fused": device_ms_per_launch(profs["ring"],
                                                       ring_combine(4)),
    }
    # launches per warm Q2 on the engine that runs each row: the walk's
    # single-shard forms on the hop ring and the gather twin, the rest on
    # the ring engine
    warm_by_row = {"fold_cont": hops_q2, "block_partials": gather_q2}
    for row in rows:
        if row["name"] in per_launch:
            row["device_ms_per_launch_q2"] = per_launch[row["name"]]
        row["launches_per_warm_q2"] = warm_by_row.get(
            row["name"], warm_q2).get(row["name"], 0)
    by_name = {row["name"]: row for row in rows}
    for name in WALK_FORMS:
        walk_row = by_name[name]
        dev_ms = walk_row.get("device_ms_per_launch_q2")
        if dev_ms:
            walk_row["share_of_bound"] = walk_row["bound_ms"] / dev_ms
            walk_row["achieved_gb_s"] = walk_row["bytes"] / dev_ms / 1e6
    for hop, one in (("extreme", "ring_pext_fused"),
                     ("onehot_add", "ring_psum_onehot_fused")):
        by_name[hop]["ring_device_ms_per_launch_q2"] = per_launch[one]
    a, b = (t.contiguous() for t in entry.fields["usage_user"]["mx"][:2])
    steps = launch_path_steps(a[:9], b[:9])
    emit({"phase": "mesh", "seconds": seconds, "rows_written": written,
          "hosts": args.mesh_hosts, "hours": args.mesh_hours,
          "grid": {"series": entry.num_series, "cells": entry.nb,
                   "shards": len(entry.devices),
                   "device_bytes": entry.bytes()},
          "engines": per_engine, "checks": checks, "launches": launches,
          "q2_hop_bytes": ring_q2["comm_bytes"],
          "hop_ring_launches_per_warm_q2": hops_q2,
          "q2_warm_profiles": profs, "kernel_seconds": kernel_seconds,
          "launch_path_ns": steps,
          "phase_seconds": time.perf_counter() - t_phase})
    return {"rows": rows, "table": table, "engines": engines,
            "hosts": args.mesh_hosts,
            "hours": args.mesh_hours, "regions": len(set(region_of)),
            "q1": results["single", "q1"], "q2": results["single", "q2"]}


def launch_path_steps(a, b):
    """Host ns per call of each step that ring_fold's launch path took on
    every call before its launchers were bound once, and of what took
    their place: the median over 7 batches of 1000 calls (after 200
    warm-up calls; the card is synchronized between batches, outside the
    timing). `empty_call` is the loop's own cost, included in every other
    number. `a`, `b` are two (9, nb) float32 planes on the card."""
    from greptimedb_tpu_torch.parallel.kernels import build
    from greptimedb_tpu_torch.parallel.kernels import ring_fold as rf

    idx = a.get_device()
    dev = a.device
    entry = build.entry("ring_fold", "gtt_noop", ())
    lib, fn = entry
    stream = build.stream(idx)

    def bind():
        f = getattr(build.load("ring_fold"), "gtt_noop")
        f.argtypes = [ctypes.c_void_p]
        f.restype = ctypes.c_int

    def device_context():
        with torch.cuda.device(dev):
            pass

    def before_path():
        # the launch path as it was: bind, context, stream object, call
        f = getattr(build.load("ring_fold"), "gtt_noop")
        f.argtypes = [ctypes.c_void_p]
        f.restype = ctypes.c_int
        with torch.cuda.device(dev):
            rc = f(torch.cuda.current_stream(dev).cuda_stream)
        build.check_launch(lib, rc, "noop")

    steps = {
        "empty_call": lambda: None,
        "load_lookup_and_type": bind,
        "bound_entry_lookup": lambda: build.entry("ring_fold", "gtt_noop",
                                                  ()),
        "device_context": device_context,
        "current_device_check": lambda: torch._C._cuda_getDevice() == idx,
        "stream_object": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw_stream": lambda: build.stream(idx),
        "check_pair": lambda: rf._check_pair("extreme", a, b,
                                             rf._FOLD_TYPES),
        "check_ring_4": lambda: rf._check_ring("ring_pext_fused",
                                               [a, b, a, b], rf._FOLD_TYPES),
        "shard_pointer_array_4": lambda: build.SHARD_PTRS(
            a.data_ptr(), b.data_ptr(), a.data_ptr(), b.data_ptr()),
        "device_type_check": lambda: a.device.type == "cpu",
        "is_cpu": lambda: a.is_cpu,
        "empty_like": lambda: torch.empty_like(a),
        "new_empty": lambda: a.new_empty(a.shape),
        "ring_form_4": lambda: rf.RingFoldCtx(4).form(
            [x.device for x in (a, b, a, b)]),
        "noop_ctypes_call": lambda: fn(stream),
        "noop_launch_before": before_path,
        "noop_launch_bound": lambda: build.launch(entry, "noop", idx),
    }
    return time_steps(steps)


def is_seed_kernel(k):
    """Profiler-name matcher of K2's seed, fold_kernel<T>."""
    return k.startswith("fold_kernel<")


# the forms of the pipelined member walk, ring_fold_fused_kernel<T,
# aligned, form> (csrc/ring_fold_fused.cu kRing, kCont, kPartials)
WALK_FORMS = {"ring_fold_fused": 0, "fold_cont": 1, "block_partials": 2}


def walk(row):
    """Profiler-name matcher of one row's form of the member walk: the
    fused ring (row 6), fold_cont (row 3) or block_partials, each
    matching its own launches only."""
    form = str(WALK_FORMS[row])
    return lambda k: (k.startswith("ring_fold_fused_kernel<")
                      and k.rstrip(">").rsplit(",", 1)[-1].strip() == form)


def ring_combine(*ops):
    """Profiler-name matcher of the one-launch ring combines,
    ring_combine_kernel<T, op, vec>: ops 0-3 the extreme (f32 max, min,
    int32 max, min), 4 the one-hot sum."""
    return lambda k: (k.startswith("ring_combine_kernel<")
                      and int(k.split(",")[1]) in ops)


PROM_T0 = 1_700_000_000_000
PROM_QUERIES = ("sum by (dc) (rate(prom_bench[1m]))",
                "topk(5, rate(prom_bench[1m]))",
                "topk(100, rate(prom_bench[1m]))",
                "bottomk(100, rate(prom_bench[1m]))")
# bench.py's query span: start t0 + 60 s, end t0 + 270 s, step 30 s
PROM_SPAN = (PROM_T0 + 60_000, PROM_T0 + 270_000, 30_000)


def prom_ingest(table, n_series):
    """bench.py's prom_bench data: n_series series (host_i, dc = i % 32),
    10 samples at 30 s, each a fresh cumsum of seeded uniforms plus 50
    per sample. Returns rows written."""
    hosts = np.asarray([f"host_{i}" for i in range(n_series)], object)
    dcs = np.asarray([f"dc{i % 32}" for i in range(n_series)], object)
    rng = np.random.default_rng(11)
    written = 0
    for s in range(10):
        ts = np.full(n_series, PROM_T0 + s * 30_000, np.int64)
        written += table.write(
            {"host": hosts, "dc": dcs}, ts,
            {"greptime_value": np.cumsum(rng.random(n_series)) + s * 50.0})
    return written


def same_vector(a, b) -> bool:
    """Two PromQL vectors: labels in order, presence, and the float32 bits
    of every present value."""
    if a.labels != b.labels or not np.array_equal(a.present, b.present):
        return False
    va = a.values[a.present].astype(np.float32).view(np.uint32)
    vb = b.values[b.present].astype(np.float32).view(np.uint32)
    return bool(np.array_equal(va, vb))


def topk_kernel_rows(dev, ring_entry, launches, per_launch):
    """Row 7 (the merge hop) and row 7r (the ring topk in one launch) at
    the ring's shapes (every shard's candidates of the warm topk(100)
    query: J = 8, k = kl = 100, four shards) and on edge cases, held
    against their plain versions bit for bit and timed."""
    from greptimedb_tpu_torch.parallel.kernels import topk_merge as tm
    from greptimedb_tpu_torch.promql import fast as TF
    from greptimedb_tpu_torch.promql.engine import EvalParams

    ev = EvalParams(*PROM_SPAN)
    win = TF._plan_windows(ring_entry, ev, 60_000, 0)
    smask, _ = TF._matcher_mask_dev(ring_entry, [])
    ns = ring_entry.shards
    s_loc = ring_entry.s_pad // ns
    cands = []
    outs, press = TF._eval_shards(ring_entry, smask, win, fname="rate",
                                  fargs=(), lookback_ticks=300_000)
    for s, (out, pres) in enumerate(zip(outs, press)):
        cands.append(TF._local_candidates(
            out, pres, TF._topk_key(out, pres, True), 100, s * s_loc))
    acc, loc = cands[:2]

    def same(got, want, what):
        """Raise unless every plane agrees bit for bit; the largest
        absolute difference of the planes' values (NaN - NaN and
        inf - inf left out)."""
        torch.cuda.synchronize()
        err = 0.0
        for g, w in zip(got, want):
            gi = g.view(torch.int32) if g.dtype == torch.float32 else g
            wi = w.view(torch.int32) if w.dtype == torch.float32 else w
            if not torch.equal(gi, wi):
                raise AssertionError(f"{what} differs")
            d = (g.double() - w.double()).abs()
            d = d[~d.isnan()]
            if d.numel():
                err = max(err, float(d.max()))
        return err

    errs = {"hop": 0.0, "ring": 0.0}

    def check(a, b, what):
        errs["hop"] = max(errs["hop"], same(
            tm.merge_candidates(a, b), tm.merge_candidates_plain(a, b),
            f"merge_candidates ({what}) from its plain version"))

    def check_ring(local, k, what):
        got = tm.ring_topk_merge_fused(local, k)[0]
        errs["ring"] = max(errs["ring"], same(
            got, tm.ring_topk_merge_fused_plain(local, k)[0],
            f"ring_topk_merge_fused ({what}) from its plain version"))
        same(got, tm.ring_topk_merge_hops(local, k)[0],
             f"ring_topk_merge_fused ({what}) from the hop ring")

    check(acc, loc, "main path")
    check_ring(cands, 100, "main path")
    rng = np.random.default_rng(7)

    def edge(j, width, sort=True):
        key = rng.choice(np.array([2.0, 1.0, 0.0, -0.0, -np.inf],
                                  np.float32), (j, width))
        if sort:
            key = -np.sort(-key, axis=1)
        else:
            key[rng.random((j, width)) < 0.1] = np.nan
        val = rng.standard_normal((j, width)).astype(np.float32)
        val[:, ::3] = -0.0
        val[:, 1::5] = np.frombuffer(np.full(
            val[:, 1::5].size, 0x7FC12345, np.uint32).tobytes(), np.float32
        ).reshape(val[:, 1::5].shape)
        idx = rng.integers(0, 2**31 - 1, (j, width)).astype(np.int32)
        pres = rng.random((j, width)) < 0.8
        return tm.Candidates(*(torch.from_numpy(np.ascontiguousarray(p))
                               .to(dev) for p in (key, val, idx, pres)))

    check(edge(8, 100), edge(8, 100), "cross-list ties, -inf, NaN, -0.0")
    check(edge(8, 100), edge(8, 37), "kl < kk")
    check(edge(5, 64, sort=False), edge(5, 64, sort=False), "unsorted")
    check_ring([edge(8, 100) for _ in range(4)], 100,
               "cross-list ties, -inf, NaN, -0.0")
    check_ring([edge(8, 37) for _ in range(4)], 100, "kl < k")
    check_ring([edge(5, 64, sort=False) for _ in range(8)], 64,
               "unsorted, NaN keys, 8 shards")

    def bound(nbytes, ops):
        b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
        return {"bound_ms": max(b_ms, o_ms),
                "bound_by": "bytes" if b_ms >= o_ms else "operations"}

    j, kk = acc.key.shape
    kl = loc.key.shape[1]
    hop_bytes = 13 * j * (kk + kl) + 13 * j * kk
    cat_key = torch.cat([acc.key, loc.key], dim=1)
    ring_bytes = 13 * j * (kk + (ns - 1) * kl) + 13 * j * kk
    ring_ops = 2 * (ns - 1) * j * kk * kl
    ring_key = torch.cat([c.key for c in cands], dim=1)
    src = "greptimedb_tpu_torch/parallel/kernels/csrc/topk_merge.cu"
    ring = {
        "ring_ms": cuda_ms(lambda: tm.ring_topk_merge_fused(cands, kk)),
        "ring_host_ms": host_ms(lambda: tm.ring_topk_merge_fused(cands, kk)),
        "ring_device_ms_per_launch": per_launch["ring_topk_merge_fused"],
        "ring_bound_ms": bound(ring_bytes, ring_ops)["bound_ms"],
        "ring_plain_ms": cuda_ms(
            lambda: tm.ring_topk_merge_fused_plain(cands, kk)),
        # the one library call that selects the same top k
        "library_ms_ring": cuda_ms(
            lambda: torch.topk(ring_key, kk, dim=1)),
        # the hop chain on the same inputs: ns - 1 merge launches
        "hops_ms": cuda_ms(lambda: tm.ring_topk_merge_hops(cands, kk)),
        "hops_host_ms": host_ms(lambda: tm.ring_topk_merge_hops(cands, kk)),
    }
    hop = {
        "name": "merge_candidates", "route": "cuda", "source": src,
        "replaces": "greptimedb_tpu/parallel/kernels/topk_merge.py:87 "
                    "(merge_candidates, body _merge_topk_kernel:29)",
        "launches": launches["merge_candidates"],
        "max_abs_err": errs["hop"],
        "ms": cuda_ms(lambda: tm.merge_candidates(acc, loc)),
        "host_ms": host_ms(lambda: tm.merge_candidates(acc, loc)),
        "plain_ms": cuda_ms(lambda: tm.merge_candidates_plain(acc, loc)),
        **bound(hop_bytes, 2 * j * kk * kl),
        "library_ms": cuda_ms(lambda: torch.topk(cat_key, kk, dim=1)),
        "device_ms_per_launch": per_launch["merge_candidates"],
        **ring,
        "shape": {"J": j, "kk": kk, "kl": kl}, "bytes": hop_bytes,
        "launch_path_ns": topk_launch_path_steps(acc, loc),
    }
    fused = {
        "name": "ring_topk_merge_fused", "route": "cuda", "source": src,
        "replaces": "greptimedb_tpu/parallel/kernels/topk_merge.py:103 "
                    "ring_topk_merge (the chain of merge_candidates:87 "
                    "hops through sequential_ring)",
        "launches": launches["ring_topk_merge_fused"],
        "max_abs_err": errs["ring"],
        "ms": ring["ring_ms"], "host_ms": ring["ring_host_ms"],
        "plain_ms": ring["ring_plain_ms"], **bound(ring_bytes, ring_ops),
        "library_ms": ring["library_ms_ring"],
        "device_ms_per_launch": ring["ring_device_ms_per_launch"],
        "hops_ms": ring["hops_ms"], "hops_host_ms": ring["hops_host_ms"],
        "shape": {"shards": ns, "J": j, "k": kk, "kl": kl},
        "bytes": ring_bytes,
    }
    return [hop, fused]


def topk_launch_path_steps(acc, loc):
    """Host ns per call of each step of merge_candidates' launch path as it
    was before it was bound once, and of what took each step's place (as
    launch_path_steps does for ring_fold). `acc`, `loc` are (J, 100)
    candidate planes on the card."""
    from greptimedb_tpu_torch.parallel.kernels import build
    from greptimedb_tpu_torch.parallel.kernels import topk_merge as tm

    dev = acc.key.device
    idx = acc.key.get_device()
    j, kk = acc.key.shape
    kl = loc.key.shape[1]
    types = (torch.float32, torch.float32, torch.int32, torch.bool)

    def check_before():
        # the per-plane checks as they were
        for planes in (acc, loc):
            for p, t in zip(planes, types):
                if p.dtype != t:
                    raise TypeError
                if p.dim() != 2 or p.shape != planes.key.shape:
                    raise ValueError
                if p.device != acc.key.device:
                    raise ValueError
                if not p.is_contiguous():
                    raise ValueError

    def check_now():
        tm._check("acc", acc)
        tm._check("loc", loc)

    def bind():
        f = build.load("topk_merge").gtt_merge_topk
        f.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        f.restype = ctypes.c_int

    def device_context():
        with torch.cuda.device(dev):
            pass

    def two_allocations():
        # one int32 (3, J, kk) buffer (key, value, index as views) and one
        # bool presence plane
        buf = torch.empty((3, j, kk), dtype=torch.int32, device=dev)
        return (buf[0].view(torch.float32), buf[1].view(torch.float32),
                buf[2], torch.empty((j, kk), dtype=torch.bool, device=dev))

    out = tm._alloc(acc, j, kk)
    entry = build.entry("topk_merge", "gtt_merge_topk",
                        (ctypes.c_void_p,) * 12 + (ctypes.c_int,) * 3)
    ptrs = [p.data_ptr() for p in (*acc, *loc, *out)]

    def launch_before():
        lib = build.load("topk_merge")
        fn = lib.gtt_merge_topk
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(*ptrs, j, kk, kl, stream)
        build.check_launch(lib, rc, "merge_candidates")

    steps = {
        "empty_call": lambda: None,
        "check_before": check_before,
        "check": check_now,
        # ring_topk_merge_fused's checks over four shards
        "check_ring_4": lambda: [tm._check("ring", c)
                                 for c in (acc, loc, acc, loc)],
        "load_lookup_and_type": bind,
        "bound_entry_lookup": lambda: build.entry(
            "topk_merge", "gtt_merge_topk",
            (ctypes.c_void_p,) * 12 + (ctypes.c_int,) * 3),
        "device_context": device_context,
        "stream_object": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw_stream": lambda: build.stream(idx),
        "empty_like_4": lambda: [torch.empty_like(p) for p in acc],
        "empty_4": lambda: [torch.empty((j, kk), dtype=t, device=dev)
                            for t in types],
        "alloc": lambda: tm._alloc(acc, j, kk),
        "alloc_2_and_views": two_allocations,
        "data_ptr_12": lambda: [p.data_ptr() for p in (*acc, *loc, *out)],
        "launch_before": launch_before,
        "launch_bound": lambda: build.launch(entry, "merge_candidates", idx,
                                             *ptrs, j, kk, kl),
        "merge_candidates": lambda: tm.merge_candidates(acc, loc),
    }
    return time_steps(steps)


def time_steps(steps):
    """Host ns per call of each step: the median over 7 batches of 1000
    calls (after 200 warm-up calls; the card is synchronized between
    batches, outside the timing)."""
    out = {}
    for name, step in steps.items():
        for _ in range(200):
            step()
        torch.cuda.synchronize()
        batches = []
        for _ in range(7):
            t = time.perf_counter_ns()
            for _ in range(1000):
                step()
            batches.append((time.perf_counter_ns() - t) / 1000)
            torch.cuda.synchronize()
        out[name] = float(np.median(batches))
    return out


def promql_phase(args, dev):
    import types

    from greptimedb_tpu_torch.catalog.manager import CatalogManager
    from greptimedb_tpu_torch.catalog.table import Table
    from greptimedb_tpu_torch.parallel.kernels import topk_merge as tm
    from greptimedb_tpu_torch.parallel.mesh import MeshOptions, make_mesh
    from greptimedb_tpu_torch.promql import fast as TF
    from greptimedb_tpu_torch.promql.engine import PromEngine
    from greptimedb_tpu_torch.query.executor import QueryEngine

    t_phase = time.perf_counter()
    n = args.prom_series
    table = Table("prom_bench", ts_name="ts", tag_names=["host", "dc"],
                  fields=["greptime_value"])
    t = time.perf_counter()
    written = prom_ingest(table, n)
    seconds = {"ingest": time.perf_counter() - t}
    catalog = CatalogManager()
    catalog.register(table)

    # the phase runs in the JAX package's x64 mode (h takes G's float64
    # sum form); h runs once more without it below
    def engine(device, mesh=None, opts=None, x64=True):
        return PromEngine(types.SimpleNamespace(
            catalog=catalog, query_engine=QueryEngine(
                device=device, mesh=mesh, mesh_opts=opts, x64=x64)))

    mesh = make_mesh([dev] * 4)
    engines = {"single": engine(dev), "ring": engine(dev, mesh),
               "gather": engine(dev, mesh,
                                MeshOptions(pallas_kernels="off"))}
    # the ring engine's topk queries again with the ring hop by hop
    # (merge_candidates, ns - 1 launches a ring), after the other engines
    runs = [(name, eng, "fused", PROM_QUERIES)
            for name, eng in engines.items()]
    runs.append(("hops", engines["ring"], "hops", PROM_QUERIES[1:]))
    results, per_engine, notes = {}, {}, {}

    def topk_counts():
        return {k: getattr(tm, k).launches for k in TOPK_KERNELS}

    for name, eng, form, queries in runs:
        stats = {}
        for q in queries:
            run = (lambda eng=eng, q=q: eng.query_range(q, *PROM_SPAN)[0])
            with ring_form(form):
                for k in TOPK_KERNELS:
                    getattr(tm, k).launches = 0
                t = time.perf_counter()
                results[name, q] = run()
                torch.cuda.synchronize()
                cold = time.perf_counter() - t
                cold_launches = topk_counts()
                times = []
                for k in TOPK_KERNELS:
                    getattr(tm, k).launches = 0
                for _ in range(5):
                    t = time.perf_counter()
                    run()
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t)
                warm_launches = topk_counts()
                prof = profiled(run)
            notes[name, q] = dict(eng.last_fast)
            stats[q] = {"cold_s": cold, "warm_median_s": float(
                np.median(times)), "launches_cold": cold_launches,
                "launches_per_warm": {k: n / 5 for k, n in
                                      warm_launches.items()},
                "device_ms": prof["device_ms"],
                "idle_share": prof["idle_share"], "top": prof["top"],
                "ours": prof["ours"], "note": notes[name, q]}
        per_engine[name] = stats

    # ---- checks -------------------------------------------------------
    topk_qs = PROM_QUERIES[1:]
    # per warm topk query: one ring launch on shards that share the card,
    # ns - 1 merge hops on the hop ring, none elsewhere
    want_launches = {
        "ring": {"ring_topk_merge_fused": 1, "merge_candidates": 0},
        "hops": {"ring_topk_merge_fused": 0, "merge_candidates": 3},
        "gather": {"ring_topk_merge_fused": 0, "merge_candidates": 0},
        "single": {"ring_topk_merge_fused": 0, "merge_candidates": 0},
    }
    for q in PROM_QUERIES:
        for name in ("ring", "gather", "hops"):
            if (name, q) in results and not same_vector(
                    results["single", q], results[name, q]):
                raise AssertionError(f"promql {name} differs from one "
                                     f"device on {q}")
        note = notes["ring", q]
        if note["decision"] != "shard(large_grid)" or note["shards"] != 4:
            raise AssertionError(f"ring engine decided {note} on {q}")
        if q in topk_qs and note["kernel"] != "ring(ring_topk)":
            raise AssertionError(f"ring engine kernel {note} on {q}")
        for name, want in want_launches.items():
            if q not in per_engine[name]:
                continue
            got = per_engine[name][q]["launches_per_warm"]
            want = want if q in topk_qs else {k: 0 for k in want}
            if got != want:
                raise AssertionError(f"topk launches per warm {q} on the "
                                     f"{name} engine: {got}, not {want}")
    agg = results["single", PROM_QUERIES[0]]
    if agg.num_series != 32 or not agg.present.all():
        raise AssertionError(f"aggregate has {agg.num_series} groups")
    for q in topk_qs:
        v = results["single", q]
        if not np.isfinite(v.values[v.present]).all():
            raise AssertionError(f"non-finite winners on {q}")
        k = int(q.split("(")[1].split(",")[0])
        if not (v.present.sum(axis=0) == k).all():
            raise AssertionError(f"{q}: not {k} winners at every step")
    t = time.perf_counter()
    cpu = engine("cpu")
    cpu_res = {q: cpu.query_range(q, *PROM_SPAN)[0] for q in PROM_QUERIES}
    seconds["cpu_reference"] = time.perf_counter() - t
    for q in topk_qs:
        if not same_vector(results["single", q], cpu_res[q]):
            raise AssertionError(f"promql one device differs from the CPU "
                                 f"on {q}")
    # the aggregate: both runs add each fold block's rows in a float32
    # matrix product, in cuBLAS's order on the card and the CPU BLAS's
    # here: |diff| <= 2 gamma_n sum |x_i|, n = rows per block + 8 blocks
    a, c = results["single", PROM_QUERIES[0]], cpu_res[PROM_QUERIES[0]]
    if a.labels != c.labels or not np.array_equal(a.present, c.present):
        raise AssertionError("aggregate groups differ from the CPU run")
    s_pad = 1 << max(3, (n - 1).bit_length())
    rows = s_pad // 8 + 8
    gamma = rows * U / (1 - rows * U)
    rates = results["single", "topk(100, rate(prom_bench[1m]))"]
    max_rate = float(np.abs(rates.values[rates.present]).max())
    members = np.bincount(np.arange(n) % 32, minlength=32)
    bound = 2 * gamma * members[:, None] * max_rate
    diff = np.abs(a.values - c.values)
    if not np.all(diff <= bound):
        raise AssertionError("aggregate past the matrix-product bound")
    agg_rel = float(np.max(diff / np.abs(c.values)))

    # ---- the topk kernels --------------------------------------------
    ring_entry = next(e for k, e in TF._CACHE._entries.items()
                      if k[3] is not None and k[4] is None)
    q100 = "topk(100, rate(prom_bench[1m]))"
    per_launch = {
        "ring_topk_merge_fused": device_ms_per_launch(
            per_engine["ring"][q100], lambda k: k.startswith(
                "ring_topk_merge")),
        "merge_candidates": device_ms_per_launch(
            per_engine["hops"][q100], lambda k: k.startswith("merge_topk")),
    }
    # every launch of the main-path runs: the one-launch ring on the ring
    # engine, the merge hop on the hop ring
    launches = {k: int(sum(
        st["launches_cold"][k] + 5 * st["launches_per_warm"][k]
        for e in ("ring", "hops") for st in per_engine[e].values()))
        for k in TOPK_KERNELS}
    for k, count in launches.items():
        if count == 0:
            raise AssertionError(f"{k} never launched in phase promql")
    rows = topk_kernel_rows(dev, ring_entry, launches, per_launch)
    emit({"phase": "promql", "seconds": seconds, "rows_written": written,
          "series": n, "grid": {"s_pad": ring_entry.s_pad,
                                "cells": ring_entry.spec.num_cells,
                                "device_bytes": ring_entry.nbytes},
          "engines": per_engine,
          "checks": {"engines_identical": True, "topk_equal_cpu": True,
                     "agg_max_rel_diff_vs_cpu": agg_rel,
                     "agg_groups": agg.num_series},
          "ring_comm_bytes": notes["ring", topk_qs[1]]["comm_bytes"],
          "phase_seconds": time.perf_counter() - t_phase})
    return rows, {"catalog": catalog, "series": n}


# ---- phase 10: promql_rest -------------------------------------------

HIST_LES = ("0.05", "0.1", "0.25", "0.5", "1", "2.5", "5", "+Inf")
HIST_SERVICES = 50
# bench.py's histogram span: t0 + 60 s to t0 + 270 s at 30 s (8 steps)
HIST_SPAN = (PROM_T0 + 60_000, PROM_T0 + 270_000, 30_000)
REST_E = "histogram_quantile(0.9, sum by (le, svc) (rate(hist_bucket[1m])))"
# name -> (query, span, branch of its aggregation): "matmul" results are
# held to the CPU run within their bound, the others bit for bit
REST_QUERIES = {
    "a": ("sum by (dc) (rate(prom_bench[1m]) / "
          "last_over_time(prom_bench[1m]))", PROM_SPAN, "matmul"),
    "b": ("sum by (dc) (quantile_over_time(0.9, prom_bench[2m]))",
          PROM_SPAN, "matmul"),
    "c": ("max by (dc) (deriv(prom_bench[2m]))", PROM_SPAN, "extreme"),
    "d": ("sum by (dc) (holt_winters(prom_bench[2m], 0.5, 0.5))",
          PROM_SPAN, "matmul"),
    "e": (REST_E, HIST_SPAN, "matmul"),
    "f": ("histogram_quantile(0.9, sum by (le, pod) "
          "(rate(hist_bucket[1m])))", HIST_SPAN, "scatter"),
    "g_instant": (REST_E, None, "matmul"),
    "g_range": ("rate(hist_bucket[1m]) > 1", HIST_SPAN, "none"),
    # the per-pod panel as an instant query: the generic engine's float64
    # vectors through the scatter branch, G's float64 sum form
    "h": ("histogram_quantile(0.9, sum by (le, pod) "
          "(rate(hist_bucket[1m])))", None, "scatter"),
}
# the card's matrix products on a, b and d are also held to a limit set
# from readings: MATMUL_READ_K sqrt(n) u sum|x| (PERF.md section 6)
MATMUL_READ_K = 8
# the inner sums behind the histogram quantiles, and the per-group
# member magnitudes behind the sums' bounds (one device, untimed)
REST_AUX = {
    "a": "{op} by (dc) (rate(prom_bench[1m]) / "
         "last_over_time(prom_bench[1m]))",
    "b": "{op} by (dc) (quantile_over_time(0.9, prom_bench[2m]))",
    "d": "{op} by (dc) (holt_winters(prom_bench[2m], 0.5, 0.5))",
}


def hist_ingest(table, pods):
    """bench.py's hist_bucket (bench.py:2575-2616): `pods` pods x 8 le
    buckets, pod i in svc_(i % 50), 10 samples at 30 s from seed 13,
    cumulative over time and over buckets. Returns rows written."""
    n_series = pods * len(HIST_LES)
    pod_col = np.repeat(np.asarray([f"pod_{i}" for i in range(pods)],
                                   object), len(HIST_LES))
    svc_col = np.repeat(np.asarray([f"svc_{i % HIST_SERVICES}"
                                    for i in range(pods)], object),
                        len(HIST_LES))
    le_col = np.tile(np.asarray(HIST_LES, object), pods)
    rng = np.random.default_rng(13)
    per_bucket = rng.random((n_series,)) * 5.0
    base = np.cumsum(per_bucket.reshape(pods, len(HIST_LES)), axis=1).ravel()
    written = 0
    for s in range(10):
        ts = np.full(n_series, PROM_T0 + s * 30_000, np.int64)
        written += table.write({"pod": pod_col, "svc": svc_col,
                                "le": le_col}, ts,
                               {"greptime_value": base * (s + 1)})
    return written


def run_rest_query(eng, name):
    query, span, _ = REST_QUERIES[name]
    if span is None:     # an instant query at the last step, steps 1 s
        return eng.query_instant(query, HIST_SPAN[1])[0]
    return eng.query_range(query, *span)[0]


def quantile_gap_bound(sums, le, q, bound):
    """The largest change of histogram_quantile(q) over buckets whose
    cumulative sums move by at most `bound` each (same bucket located):
    out = lb + (ub - lb) (rank - lo) / (hi - lo) with rank = q total, so
    |d out| <= (ub - lb) (q + 1 + 2 frac) bound / width. sums: (B, J)
    of one group in le order."""
    b = np.maximum.accumulate(np.where(np.isnan(sums), 0, sums), axis=0)
    total = b[-1]
    rank = q * total
    idx = np.clip((b < rank[None, :]).sum(axis=0), 0, len(le) - 1)
    lo = np.where(idx > 0, b[np.maximum(idx - 1, 0), np.arange(b.shape[1])],
                  0)
    hi = b[idx, np.arange(b.shape[1])]
    width = np.where(hi - lo == 0, 1, hi - lo)
    ub = le[idx]
    lb = np.where(idx > 0, le[np.maximum(idx - 1, 0)], 0)
    span = np.where(np.isfinite(ub), ub - lb, 0)
    frac = np.clip((rank - lo) / width, 0, 1)
    return span * (q + 1 + 2 * frac) * bound / width


def promql_rest_phase(args, dev, prom):
    """Phase 10 (see the module docstring). Returns every kernel's
    launches over the phase's main path and G's numbers at query f's
    shape."""
    import types

    from greptimedb_tpu_torch.catalog.table import Table
    from greptimedb_tpu_torch.parallel.kernels import grouped_reduce as gr
    from greptimedb_tpu_torch.parallel.kernels import merge_gather as mg
    from greptimedb_tpu_torch.parallel.kernels import ring_fold as rf
    from greptimedb_tpu_torch.parallel.kernels import topk_merge as tm
    from greptimedb_tpu_torch.parallel.mesh import MeshOptions, make_mesh
    from greptimedb_tpu_torch.promql.engine import PromEngine
    from greptimedb_tpu_torch.query.executor import QueryEngine

    t_phase = time.perf_counter()
    catalog = prom["catalog"]
    hist = Table("hist_bucket", ts_name="ts", tag_names=["pod", "svc", "le"],
                 fields=["greptime_value"])
    t = time.perf_counter()
    written = hist_ingest(hist, args.hist_pods)
    seconds = {"hist_ingest": time.perf_counter() - t}
    catalog.register(hist)

    # the phase runs in the JAX package's x64 mode (h takes G's float64
    # sum form); h runs once more without it below
    def engine(device, mesh=None, opts=None, x64=True):
        return PromEngine(types.SimpleNamespace(
            catalog=catalog, query_engine=QueryEngine(
                device=device, mesh=mesh, mesh_opts=opts, x64=x64)))

    mesh = make_mesh([dev] * 4)
    engines = {"single": engine(dev), "ring": engine(dev, mesh),
               "gather": engine(dev, mesh,
                                MeshOptions(pallas_kernels="off"))}

    def all_counts():
        return {**counts(rf, mg),
                **{k: getattr(gr, k).launches for k in GROUPED_KERNELS},
                **{k: getattr(tm, k).launches for k in TOPK_KERNELS}}

    def zero_all():
        zero_counts(rf, mg)
        for k in GROUPED_KERNELS:
            getattr(gr, k).launches = 0
        for k in TOPK_KERNELS:
            getattr(tm, k).launches = 0

    results, stats, notes = {}, {}, {}
    launches = {}
    store = {}
    for ename, eng in engines.items():
        per_q = {}
        for name in REST_QUERIES:
            run = (lambda eng=eng, name=name: run_rest_query(eng, name))
            zero_all()
            eng.last_fast = None
            t = time.perf_counter()
            with capture_grouped(gr, store):
                results[ename, name] = run()
            torch.cuda.synchronize()
            cold = time.perf_counter() - t
            cold_launches = all_counts()
            zero_all()
            times = []
            for _ in range(args.rest_warm):
                t = time.perf_counter()
                run()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
            warm_launches = all_counts()
            prof = profiled(run, top=5)
            notes[ename, name] = eng.last_fast
            for k in set(cold_launches) | set(warm_launches):
                launches[k] = (launches.get(k, 0) + cold_launches.get(k, 0)
                               + warm_launches.get(k, 0))
            per_q[name] = {
                "cold_s": cold, "warm_median_s": float(np.median(times)),
                "launches_cold": {k: v for k, v in cold_launches.items()
                                  if v},
                "launches_per_warm": {k: v / args.rest_warm
                                      for k, v in warm_launches.items()
                                      if v},
                "device_ms": prof["device_ms"],
                "idle_share": prof["idle_share"], "top": prof["top"],
                "ours": prof["ours"], "note": notes[ename, name],
                "series": results[ename, name].num_series}
        stats[ename] = per_q

    # ---- checks -------------------------------------------------------
    for name, (query, span, branch) in REST_QUERIES.items():
        ref = results["single", name]
        for ename in ("ring", "gather"):
            if not same_vector(ref, results[ename, name]):
                raise AssertionError(f"promql_rest {ename} differs from one "
                                     f"device on {name}: {query}")
        if ref.num_series == 0 or not ref.present.any():
            raise AssertionError(f"promql_rest {name} answered nothing")
        for ename in engines:
            got = stats[ename][name]["launches_per_warm"]
            g_launch = got.get("grouped_block_reduce", 0)
            # one G launch a step column of f's and h's sums, none
            # elsewhere
            want_g = len(results[ename, name].present[0]) \
                if branch == "scatter" else 0
            if g_launch != want_g:
                raise AssertionError(f"G launched {g_launch} times per warm "
                                     f"{name} on {ename}, not {want_g}")
            p_launch = got.get("ring_pext_fused", 0)
            want_p = 1 if (name == "c" and ename == "ring") else 0
            if p_launch != want_p:
                raise AssertionError(f"4r launched {p_launch} times per warm "
                                     f"{name} on {ename}, not {want_p}")
    for name in ("a", "b", "c", "d"):
        if results["single", name].num_series != 32:
            raise AssertionError(f"{name}: not 32 dc groups")
    if results["single", "e"].num_series != HIST_SERVICES:
        raise AssertionError("e: not one quantile per service")
    for name in ("f", "h"):
        if results["single", name].num_series != args.hist_pods:
            raise AssertionError(f"{name}: not one quantile per pod")
    for name in REST_QUERIES:
        v = results["single", name]
        if not np.isfinite(v.values[v.present]).all():
            raise AssertionError(f"{name}: non-finite values")

    # h without x64 (the JAX package's default): float32 vectors through
    # G's float32 sum form, one launch a warm query, exact against the
    # port on the CPU in the same mode
    h32 = engine(dev, x64=False)
    zero_all()
    got32 = run_rest_query(h32, "h")
    torch.cuda.synchronize()
    h32_cold = all_counts()
    zero_all()
    run_rest_query(h32, "h")
    torch.cuda.synchronize()
    h32_warm = all_counts()
    for k in set(h32_cold) | set(h32_warm):
        launches[k] = (launches.get(k, 0) + h32_cold.get(k, 0)
                       + h32_warm.get(k, 0))
    if h32_warm.get("grouped_block_reduce") != 1:
        raise AssertionError(f"h without x64 launched G "
                             f"{h32_warm.get('grouped_block_reduce')} times "
                             f"a warm query, not 1")
    if not same_vector(got32, run_rest_query(engine("cpu", x64=False), "h")):
        raise AssertionError("h without x64 differs from the CPU")
    h32_note = {"launches_per_warm": h32_warm["grouped_block_reduce"],
                "exact_equal_cpu": True}

    # the port on the CPU: bit for bit where no matrix product adds, else
    # within 2 gamma_n sum|x| over a group's members (n: the product's
    # length: S_pad, or per fold block S_pad / 8 + 8 on the blocked path)
    t = time.perf_counter()
    cpu = engine("cpu")
    cpu_res = {name: run_rest_query(cpu, name) for name in REST_QUERIES}
    seconds["cpu_reference"] = time.perf_counter() - t
    rel, read = {}, {}
    s_pad = 1 << max(3, (prom["series"] - 1).bit_length())
    for name, (query, span, branch) in REST_QUERIES.items():
        a, c = results["single", name], cpu_res[name]
        if branch != "matmul":
            if not same_vector(a, c):
                raise AssertionError(f"promql_rest one device differs from "
                                     f"the CPU on {name}: {query}")
            continue
        if a.labels != c.labels or not np.array_equal(a.present, c.present):
            raise AssertionError(f"{name}: groups differ from the CPU run")
        diff = np.abs(a.values - c.values)[a.present]
        rel[name] = float(np.max(diff / np.maximum(np.abs(c.values[
            c.present]), 1e-30)))
        if name in REST_AUX:
            n = s_pad if name == "a" else s_pad // 8 + 8
            gamma = n * U / (1 - n * U)
            eng1 = engines["single"]
            mx = eng1.query_range(REST_AUX[name].format(op="max"),
                                  *span)[0]
            mn = eng1.query_range(REST_AUX[name].format(op="min"),
                                  *span)[0]
            cnt = eng1.query_range(REST_AUX[name].format(op="count"),
                                   *span)[0]
            mag = np.maximum(np.abs(mx.values), np.abs(mn.values))
            bound = 2 * gamma * cnt.values * mag
            if not np.all(np.abs(a.values - c.values) <= bound):
                raise AssertionError(f"{name} past the matrix-product bound")
            # the limit from readings: sum|x| is the sum itself where no
            # member is negative, else at most count * max|x|
            abs_sum = np.where(mn.values >= 0, np.abs(c.values),
                               cnt.values * mag)
            limit = MATMUL_READ_K * np.sqrt(n) * U * abs_sum
            gap = np.abs(a.values - c.values)
            read[name] = float(np.max(np.where(c.present, gap / np.maximum(
                limit, 1e-300), 0)))
            if not np.all(gap <= limit):
                raise AssertionError(f"{name} past the read limit "
                                     f"{MATMUL_READ_K} sqrt(n) u sum|x|")
            continue
        # e and g_instant: quantiles of matrix-product bucket sums. The
        # sums on the card stay within their bound of the CPU's (checked
        # here on the inner sum), and the quantile moves at most as far as
        # those sums can move it (quantile_gap_bound)
        inner = "sum by (le, svc) (rate(hist_bucket[1m]))"
        if span is None:
            card = engines["single"].query_instant(inner, HIST_SPAN[1])[0]
            ref_in = cpu.query_instant(inner, HIST_SPAN[1])[0]
            n = args.hist_pods * len(HIST_LES)   # the generic engine's S
            mags = engines["single"].query_instant(
                "max by (le, svc) (rate(hist_bucket[1m]))", HIST_SPAN[1])[0]
            cnts = engines["single"].query_instant(
                "count by (le, svc) (rate(hist_bucket[1m]))", HIST_SPAN[1])[0]
            u = 2.0 ** -53      # float64 vectors in the generic engine
        else:
            card = engines["single"].query_range(inner, *span)[0]
            ref_in = cpu.query_range(inner, *span)[0]
            n = 1 << max(3, (args.hist_pods * len(HIST_LES) - 1).bit_length())
            mags = engines["single"].query_range(
                "max by (le, svc) (rate(hist_bucket[1m]))", *span)[0]
            cnts = engines["single"].query_range(
                "count by (le, svc) (rate(hist_bucket[1m]))", *span)[0]
            u = U
        gamma = n * u / (1 - n * u)

        def by_label(v):
            return {(lab["svc"], lab["le"]): (v.values[i], v.present[i])
                    for i, lab in enumerate(v.labels)}

        card, ref_in = by_label(card), by_label(ref_in)
        mags, cnts = by_label(mags), by_label(cnts)
        sum_bound = {k: 2 * gamma * cnts[k][0] * np.abs(mags[k][0])
                     for k in ref_in}
        for k, (want, _) in ref_in.items():
            if not np.all(np.abs(card[k][0] - want) <= sum_bound[k]):
                raise AssertionError(f"{name}: bucket sums past the "
                                     "matrix-product bound")
        le_vals = np.asarray([float(x.replace("+Inf", "inf"))
                              for x in HIST_LES])
        for gi, lab in enumerate(c.labels):
            keys = [(lab["svc"], le) for le in HIST_LES]
            gap = quantile_gap_bound(
                np.stack([ref_in[k][0] for k in keys]), le_vals, 0.9,
                np.stack([sum_bound[k] for k in keys]).max(axis=0))
            d = np.abs(a.values[gi] - c.values[gi])
            if not np.all(d <= gap + 4 * np.spacing(
                    np.abs(c.values[gi]).astype(np.float32))):
                raise AssertionError(f"{name}: quantile past its bound")

    # ---- G at query f's shape ------------------------------------------
    v, members = store["sum"][0]
    exact = gr.grouped_block_reduce(v, members, "sum")
    plain = gr.grouped_block_reduce_plain(v, members, "sum")
    torch.cuda.synchronize()
    if not torch.equal(exact.view(torch.int32), plain.view(torch.int32)):
        raise AssertionError("G at f's shape differs from its plain version")
    f_launch = stats["single"]["f"]["launches_per_warm"][
        "grouped_block_reduce"]
    dev_ms = device_ms_per_launch(
        {"ours": stats["single"]["f"]["ours"]},
        lambda k: k.startswith("segment_walk_kernel<float, 0>"))
    live = members.perm[:int(members.ptr[-1])].long()
    nseg = members.gb * members.blocks
    seg = (torch.repeat_interleave(
        torch.arange(nseg, device=dev),
        (members.ptr[1:] - members.ptr[:-1]).long()))
    nbytes = 8 * int(members.ptr[-1]) + 4 * (nseg + 1) + 4 * nseg
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    g_row = {
        "f64_at_h": g_f64_row(dev, gr, store, stats),
        "ms": cuda_ms(lambda: gr.grouped_block_reduce(v, members, "sum")),
        "burst_ms": burst_ms(lambda: gr.grouped_block_reduce(v, members,
                                                             "sum")),
        "device_ms_per_launch": dev_ms,
        "plain_ms": cuda_ms(lambda: gr.grouped_block_reduce_plain(
            v, members, "sum"), reps=3, warm=1),
        "library_ms": cuda_ms(lambda: torch.zeros(
            nseg, device=dev).index_add_(0, seg, v[live])),
        "bound_ms": bound, "bound_by": "bytes", "bytes": nbytes,
        "share_of_bound": bound / dev_ms if dev_ms else None,
        "launches_per_warm_f": f_launch,
        "max_abs_err": float(torch.nan_to_num(
            (exact.double() - plain.double()).abs(), nan=0.0).max()),
        "shape": {"rows": v.numel(), "blocks": members.blocks,
                  "gb": members.gb, **segment_stats(members)},
    }
    emit({"phase": "promql_rest", "seconds": seconds,
          "rows_written": written, "hist_series": args.hist_pods * len(
              HIST_LES),
          "engines": stats, "launches": launches,
          "checks": {"engines_identical": True, "exact_equal_cpu": True,
                     "matmul_max_rel_diff_vs_cpu": rel,
                     "matmul_gap_over_read_limit": read,
                     "tf32_probe": tf32_probe(dev, s_pad),
                     "h_without_x64": h32_note},
          "g_at_f": g_row,
          "phase_seconds": time.perf_counter() - t_phase})
    for k in ("grouped_block_reduce", "ring_pext_fused"):
        if not launches.get(k):
            raise AssertionError(f"{k} never launched in phase promql_rest")
    return launches, g_row


def g_f64_row(dev, gr, store, stats):
    """G's float64 sum form at query h's shape (the generic engine's
    instant sum by (le, pod)): kernel against its plain version bit for
    bit, timed beside index_add_ and its bound."""
    v, members = store[("sum", "float64")][0]
    exact = gr.grouped_block_reduce(v, members, "sum")
    plain = gr.grouped_block_reduce_plain(v, members, "sum")
    torch.cuda.synchronize()
    if not torch.equal(exact.view(torch.int64), plain.view(torch.int64)):
        raise AssertionError("G float64 at h's shape differs from its plain "
                             "version")
    live = members.perm[:int(members.ptr[-1])].long()
    nseg = members.gb * members.blocks
    seg = torch.repeat_interleave(
        torch.arange(nseg, device=dev),
        (members.ptr[1:] - members.ptr[:-1]).long())
    # 8 bytes a value and 4 a member index read, the pointers read, 8
    # bytes a segment written; one float64 add a live row
    nbytes = 12 * int(members.ptr[-1]) + 4 * (nseg + 1) + 8 * nseg
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = int(members.ptr[-1]) / F64_OPS_PER_S * 1e3
    dev_ms = device_ms_per_launch(
        {"ours": stats["single"]["h"]["ours"]},
        lambda k: k.startswith("segment_walk_kernel<double, 0>"))
    return {
        "ms": cuda_ms(lambda: gr.grouped_block_reduce(v, members, "sum")),
        "device_ms_per_launch": dev_ms,
        "plain_ms": cuda_ms(lambda: gr.grouped_block_reduce_plain(
            v, members, "sum"), reps=3, warm=1),
        "library_ms": cuda_ms(lambda: torch.zeros(
            nseg, dtype=torch.float64, device=dev).index_add_(
                0, seg, v[live])),
        "bound_ms": max(b_ms, o_ms),
        "bound_by": "bytes" if b_ms >= o_ms else "operations",
        "bytes": nbytes,
        "launches_per_warm_h": stats["single"]["h"]["launches_per_warm"][
            "grouped_block_reduce"],
        "max_abs_err": float(torch.nan_to_num(
            (exact - plain).abs(), nan=0.0).max()),
        "shape": {"rows": v.numel(), "blocks": members.blocks,
                  "gb": members.gb, **segment_stats(members)}}


def tf32_probe(dev, s_pad):
    """Whether the main path's group product can tell full float32 from
    TF32, at query a's shape (32 groups over s_pad series, eight step
    columns). Column "exact": 1000 members a group hold 1 + 2^-13 and the
    rest 0, so every partial sum is a float32 and any full-float32 order
    gives the exact sum; TF32 keeps 10 bits of each input and drops the
    2^-13. Column "uniform": values in [0.5, 1.5), as a rate over a last
    value. Returns each product's largest gap to the float64 sum, relative
    to the sum, and the read limit's relative size there."""
    from greptimedb_tpu_torch.ops.promql import _group_matmul

    g, j = 32, 8
    gid = torch.arange(s_pad, device=dev) % g
    onehot_t = (gid[None, :] == torch.arange(g, device=dev)[:, None]).float()
    gen = torch.Generator(device=dev).manual_seed(10)
    x = torch.zeros((s_pad, j), device=dev)
    x[:g * 1000, :j // 2] = 1 + 2.0 ** -13
    x[:, j // 2:] = 0.5 + torch.rand((s_pad, j // 2), device=dev,
                                     generator=gen)
    want = onehot_t.double() @ x.double()
    full = _group_matmul(x, onehot_t)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32 = torch.matmul(onehot_t, x)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False

    def gap(got, cols):
        return float(((got.double() - want).abs() / want.abs())[:, cols]
                     .max())

    exact, uniform = slice(0, j // 2), slice(j // 2, j)
    out = {"full_f32": {"exact": gap(full, exact),
                        "uniform": gap(full, uniform)},
           "tf32": {"exact": gap(tf32, exact), "uniform": gap(tf32, uniform)},
           "read_limit_rel": MATMUL_READ_K * float(np.sqrt(s_pad)) * U}
    if out["full_f32"]["exact"] != 0.0:
        raise AssertionError("the full-float32 group product is not exact "
                             "on exactly summable data")
    if out["tf32"]["exact"] == 0.0:
        raise AssertionError("the TF32 probe did not round")
    return out


SQL_Q2_OPS = ["count", "sum", "min", "max", "avg", "stddev_samp",
              "first_value", "last_value"]


def sql_suite(hosts, hours, regions):
    """bench.py's TSBS RANGE suite (bench.py:2131-2201: the headline and
    the nine device shapes) at a table of `hosts` x `hours`, and Q2 as
    SQL: (name, sql, rows bench.py wants at that size, disjoint-window
    mean columns)."""
    end_ms = hours * HOUR_MS
    hosts8 = ", ".join(f"'host_{i}'" for i in range(8))

    def items(op, rng, fields):
        return ", ".join(f"{op}({f}) RANGE '{rng}'" for f in fields)

    means = [f"avg({f}) RANGE '1h'" for f in FIELDS]
    return [
        ("double_groupby_all", f"SELECT ts, hostname, "
         f"{items('avg', '1h', FIELDS)} FROM cpu ALIGN '1h' BY (hostname)",
         hosts * hours, means),
        ("lastpoint", "SELECT ts, hostname, last_value(usage_user) RANGE "
         "'12h' FROM cpu ALIGN '12h' TO '1970-01-01 00:00:00' BY (hostname)",
         hosts * -(-hours // 12), ()),
        ("groupby_orderby_limit", "SELECT ts, max(usage_user) RANGE '1m' "
         f"FROM cpu WHERE ts < {end_ms - HOUR_MS} ALIGN '1m' BY () "
         "ORDER BY ts DESC LIMIT 5", min(5, (hours - 1) * 60), ()),
        ("single_groupby_1_1_1", "SELECT ts, max(usage_user) RANGE '1m' "
         f"FROM cpu WHERE hostname = 'host_17' AND ts >= {end_ms - HOUR_MS} "
         f"AND ts < {end_ms} ALIGN '1m' BY (hostname)", 60, ()),
        ("single_groupby_1_1_12", "SELECT ts, max(usage_user) RANGE '1m' "
         "FROM cpu WHERE hostname = 'host_17' ALIGN '1m' BY (hostname)",
         hours * 60, ()),
        ("single_groupby_5_8_1", f"SELECT ts, hostname, "
         f"{items('max', '1m', FIELDS[:5])} FROM cpu WHERE hostname IN "
         f"({hosts8}) AND ts >= {end_ms - HOUR_MS} AND ts < {end_ms} "
         "ALIGN '1m' BY (hostname)", 8 * 60, ()),
        ("cpu_max_all_1", f"SELECT ts, {items('max', '1h', FIELDS)} FROM cpu "
         "WHERE hostname = 'host_42' ALIGN '1h' BY (hostname) LIMIT 8",
         min(8, hours), ()),
        ("cpu_max_all_8", f"SELECT ts, hostname, "
         f"{items('max', '1h', FIELDS)} FROM cpu WHERE hostname IN "
         f"({hosts8}) AND ts < {8 * HOUR_MS} ALIGN '1h' BY (hostname)",
         8 * min(8, hours), ()),
        ("double_groupby_1", "SELECT ts, hostname, avg(usage_user) RANGE "
         "'1h' FROM cpu ALIGN '1h' BY (hostname)", hosts * hours,
         means[:1]),
        ("double_groupby_5", f"SELECT ts, hostname, "
         f"{items('avg', '1h', FIELDS[:5])} FROM cpu ALIGN '1h' "
         "BY (hostname)", hosts * hours, means[:5]),
        ("q2_by_region", "SELECT ts, region, " + ", ".join(
            f"{op}(usage_user) RANGE '2h'" for op in SQL_Q2_OPS)
         + " FROM cpu ALIGN '1h' BY (region)", regions * (hours + 1), ()),
    ]


def sql_phase(args, dev, slice_out, mesh_out):
    """Phase 8 (see the module docstring). Returns the phase's launch
    counts, those of the hop-ring engine alone, and per kernel the
    profiler's device time per launch on the warm SQL Q2 (K2's seed and
    fold_cont on the hop ring, the fused ring on the default ring)."""
    from greptimedb_tpu_torch.instance import Instance
    from greptimedb_tpu_torch.parallel.kernels import merge_gather as mg
    from greptimedb_tpu_torch.parallel.kernels import ring_fold as rf

    t_phase = time.perf_counter()
    mesh_engines = mesh_out["engines"]
    # (table's phase, engine) -> (table, query engine, ring form). Each
    # Instance runs on the query engine that answered the plan-built
    # Q1/Q2 of its phase, so its grid is built already (cold is the SQL
    # shape's state growth); the hop ring runs on the ring engine's grid.
    runs = {
        ("slice", "single"): (slice_out, slice_out["engine"], "fused"),
        ("mesh", "single"): (mesh_out, mesh_engines["single"], "fused"),
        ("mesh", "fused"): (mesh_out, mesh_engines["ring"], "fused"),
        ("mesh", "hops"): (mesh_out, mesh_engines["ring"], "hops"),
        ("mesh", "gather"): (mesh_out, mesh_engines["gather"], "fused"),
    }
    zero_counts(rf, mg)
    results, stats, run_launches = {}, {}, {}
    insts = {}
    for (tname, ename), (tab, engine, form) in runs.items():
        before_run = counts(rf, mg)
        inst = insts[tname, ename] = Instance(device=dev, mesh=engine.mesh,
                                              mesh_opts=engine.mesh_opts)
        inst.query_engine = engine
        inst.catalog.register(tab["table"])
        suite = sql_suite(tab["hosts"], tab["hours"], tab["regions"])
        per_shape = {}
        with ring_form(form):
            for name, sql, want_rows, _ in suite:
                t = time.perf_counter()
                res = inst.sql(sql)
                torch.cuda.synchronize()
                cold = time.perf_counter() - t
                eng = inst.query_engine
                if eng.last_exec_path != "device":
                    raise AssertionError(f"{name} ran {eng.last_exec_path}")
                if res.num_rows != want_rows:
                    raise AssertionError(f"{tname} {ename} {name}: "
                                         f"{res.num_rows} rows, bench.py "
                                         f"wants {want_rows}")
                results[tname, ename, name] = res
                times = []
                before = counts(rf, mg)
                for _ in range(3):
                    t = time.perf_counter()
                    inst.sql(sql)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t)
                after = counts(rf, mg)
                prof = profiled(lambda: inst.sql(sql))
                info = dict(eng.last_range)
                per_shape[name] = {
                    "cold_s": cold, "warm_median_s": float(np.median(times)),
                    "device_ms": prof["device_ms"],
                    "idle_share": prof["idle_share"],
                    "launches_per_warm": {
                        k: (after[k] - before[k]) / 3 for k in after
                        if after[k] > before[k]},
                    "folds": info["comm_bytes"] > 0, "program":
                    info["program"], "ring_form": info["ring_form"],
                    "ours": prof["ours"]}
        stats[f"{tname}_{ename}"] = per_shape
        after_run = counts(rf, mg)
        run_launches[f"{tname}_{ename}"] = {
            k: after_run[k] - before_run[k] for k in after_run
            if after_run[k] > before_run[k]}
    launches = counts(rf, mg)

    # ---- checks -------------------------------------------------------
    w1 = HOUR_MS // STEP_MS
    for tname, out in (("slice", slice_out), ("mesh", mesh_out)):
        # SQL Q1/Q2 against the plan-built Q1/Q2 of the same table, one
        # device (the mesh engines are held to one device below)
        compare_engines(f"{tname} SQL Q1", out["q1"],
                        results[tname, "single", "double_groupby_all"], w1,
                        names=False)
        compare_engines(f"{tname} SQL Q2", out["q2"],
                        results[tname, "single", "q2_by_region"], w1,
                        names=False)
    suite = sql_suite(mesh_out["hosts"], mesh_out["hours"],
                      mesh_out["regions"])
    checks = {}
    for name, _, _, means in suite:
        ref = results["mesh", "single", name]
        worst = 0.0
        for ename in ("fused", "hops", "gather"):
            _, rel = compare_engines(f"mesh {ename} {name}", ref,
                                     results["mesh", ename, name], w1,
                                     bounded=set(means))
            worst = max(worst, rel)
            st = stats[f"mesh_{ename}"][name]
            want_prog = ("sharded_gather" if ename == "gather"
                         else "sharded_ring")
            if st["program"] != want_prog or (
                    ename != "gather" and st["ring_form"] != ename):
                raise AssertionError(f"mesh {ename} {name} ran {st}")
            warm = st["launches_per_warm"]
            launched = warm.get("ring_fold_fused", 0)
            if ename == "fused" and st["folds"] and launched < 1:
                raise AssertionError(f"{name}: the fused ring never "
                                     f"launched on a folding query")
            if (ename != "fused" or not st["folds"]) and launched:
                raise AssertionError(f"{name}: the fused ring launched on "
                                     f"the {ename} engine")
            # the one-ring forms only where the shards share the card's
            # fused ring, the hop combines only on the hop ring
            for k in ONE_RING_KERNELS if ename != "fused" else ():
                if warm.get(k):
                    raise AssertionError(f"{name}: {k} on the {ename} "
                                         f"engine")
            for k in HOP_KERNELS if ename != "hops" else ():
                if warm.get(k):
                    raise AssertionError(f"{name}: {k} on the {ename} "
                                         f"engine")
        checks[name] = {"engines_identical": worst == 0.0,
                        "max_rel_diff_means": worst,
                        "folds": stats["mesh_fused"][name]["folds"]}
    if not any(c["folds"] for c in checks.values()):
        raise AssertionError("no suite query folded groups on the mesh")
    for k in ONE_RING_KERNELS + HOP_KERNELS:
        if launches[k] == 0:
            raise AssertionError(f"kernel {k} never launched in phase sql")
    # launches per warm SQL Q2 on four shards: one launch per ring on the
    # fused engine, ns - 1 hops per ring on the hop ring
    q2 = "q2_by_region"
    for ename, want in (("fused", {**Q2_RINGS, "extreme": 0,
                                   "onehot_add": 0}),
                        ("hops", {**Q2_HOPS, **{k: 0 for k in Q2_RINGS}}),
                        ("gather", {k: 0 for k in (*Q2_RINGS, *Q2_HOPS)})):
        warm = stats[f"mesh_{ename}"][q2]["launches_per_warm"]
        for k, n in want.items():
            if warm.get(k, 0) != n:
                raise AssertionError(f"{k}: {warm.get(k, 0)} launches per "
                                     f"warm SQL Q2 on the {ename} engine, "
                                     f"not {n}")

    # warm SQL Q2 of the two ring forms on the same grid, one after the
    # other in turn so both see the same host (after the main-path counts
    # were read)
    q2_sql = next(sql for name, sql, _, _ in suite if name == q2)
    walls = {"fused": [], "hops": []}
    for _ in range(Q2_WALL_REPS):
        for form in walls:
            with ring_form(form):
                t = time.perf_counter()
                insts["mesh", form].sql(q2_sql)
                torch.cuda.synchronize()
                walls[form].append((time.perf_counter() - t) * 1e3)
    q2_walls = {form: {"median_ms": float(np.median(w)),
                       "min_ms": float(np.min(w)), "reps": len(w)}
                for form, w in walls.items()}
    per_launch = {
        "ring_fold_fused": device_ms_per_launch(
            {"ours": stats["mesh_fused"][q2]["ours"]},
            walk("ring_fold_fused")),
        "blocked_fold_sum": device_ms_per_launch(
            {"ours": stats["mesh_hops"][q2]["ours"]}, is_seed_kernel),
        "fold_cont": device_ms_per_launch(
            {"ours": stats["mesh_hops"][q2]["ours"]}, walk("fold_cont")),
        "extreme": device_ms_per_launch(
            {"ours": stats["mesh_hops"][q2]["ours"]},
            lambda k: k.startswith("extreme_")),
        "onehot_add": device_ms_per_launch(
            {"ours": stats["mesh_hops"][q2]["ours"]},
            lambda k: k.startswith("onehot_add")),
        "ring_pext_fused": device_ms_per_launch(
            {"ours": stats["mesh_fused"][q2]["ours"]},
            ring_combine(0, 1, 2, 3)),
        "ring_psum_onehot_fused": device_ms_per_launch(
            {"ours": stats["mesh_fused"][q2]["ours"]}, ring_combine(4)),
    }
    engine_q2 = {e: {"device_ms": stats[f"mesh_{e}"][q2]["device_ms"],
                     "idle_share": stats[f"mesh_{e}"][q2]["idle_share"],
                     "launches_per_warm": stats[f"mesh_{e}"][q2][
                         "launches_per_warm"]}
                 for e in ("single", "fused", "hops", "gather")}
    emit({"phase": "sql", "engines": stats, "checks": checks,
          "launches": launches, "launches_by_engine": run_launches,
          "device_ms_per_launch_q2": per_launch,
          "q2_by_engine": engine_q2,
          "q2_warm_wall_by_ring_form": q2_walls,
          "phase_seconds": time.perf_counter() - t_phase})
    return (launches, run_launches["mesh_hops"], per_launch,
            {e: v["launches_per_warm"] for e, v in engine_q2.items()})



# ---- phase 9: rows ----------------------------------------------------

# the GROUP BYs of the rows phase: bench.py:411-412's probe, the nine-op
# GROUP BY region (stddev_samp keeps it on one device: the row path's
# var/stddev do not shard), and the same without stddev_samp, which the
# mesh engines shard (the ring forms carry its extremes and winners)
GROUPBY_OPS = ("count(*), sum(usage_user), avg(usage_user), "
               "min(usage_user), max(usage_system), {}first_value("
               "usage_idle), last_value(usage_idle)")
GROUPBY_QUERIES = [
    ("hostname_avg", "SELECT hostname, avg(usage_user) FROM cpu "
     "GROUP BY hostname"),
    ("region_all", "SELECT region, " + GROUPBY_OPS.format(
        "stddev_samp(usage_user), ") + " FROM cpu GROUP BY region"),
    ("region_ring", "SELECT region, " + GROUPBY_OPS.format("")
     + " FROM cpu GROUP BY region"),
]
# per warm region_ring on four shards: 8 ring extremes (min, max, three
# winner stages each of first and last) and 2 ring one-hot sums; on the
# hop ring 3 hops each
GROUPBY_RINGS = {"ring_pext_fused": 8, "ring_psum_onehot_fused": 2}
GROUPBY_HOPS = {"extreme": 24, "onehot_add": 6}
GROUPED_KERNELS = ("grouped_block_reduce", "column_tree_sum")
HOST_CUT_MS = 3 * HOUR_MS     # the host RANGE shapes read the first 3 h


def host_shapes():
    """TSBS high-cpu-1 and high-cpu-all (bench.py:2202-2213) and the five
    RANGE shapes the device grid declines (a residual OR, a residual
    filter, an expression argument, a ts bound off a cell edge, NOT LIKE),
    those five cut to the first 3 hours."""
    cut = f"ts < {HOST_CUT_MS}"
    q2 = ", ".join(f"{op}(usage_user) RANGE '1h'" for op in (
        "count", "sum", "min", "max", "avg", "stddev_samp", "first_value",
        "last_value"))
    return [
        ("high_cpu_1", "SELECT ts, usage_user, usage_system FROM cpu "
         "WHERE usage_user > 90.0 AND hostname = 'host_17'"),
        ("high_cpu_all", "SELECT * FROM cpu WHERE usage_user > 90.0"),
        ("high_cpu_all_cached", "SELECT * FROM cpu WHERE usage_user > 90.0"),
        ("or_hosts", "SELECT ts, hostname, avg(usage_user) RANGE '1h' FROM "
         "cpu WHERE (hostname = 'host_3' OR hostname = 'host_4') AND "
         f"{cut} ALIGN '1h' BY (hostname)"),
        ("usage_filter", f"SELECT ts, region, {q2} FROM cpu WHERE "
         f"usage_user > 50 AND {cut} ALIGN '1h' BY (region)"),
        ("expression_arg", "SELECT ts, hostname, avg(usage_user + "
         f"usage_system) RANGE '1h' FROM cpu WHERE {cut} ALIGN '1h' "
         "BY (hostname)"),
        ("ts_off_edge", "SELECT ts, region, max(usage_user) RANGE '1h' FROM "
         f"cpu WHERE ts > 3600000 AND {cut} ALIGN '1h' BY (region)"),
        ("not_like", "SELECT ts, region, avg(usage_idle) RANGE '1h' FROM "
         f"cpu WHERE hostname NOT LIKE 'host_1%' AND {cut} ALIGN '1h' "
         "BY (region)"),
    ]


@contextlib.contextmanager
def capture_grouped(gr, store):
    """Record the inputs of the first two calls of each form of G and of
    Gt, and of the first member build of each group count, while this
    block is open; the real wrappers run as they would. A wrapper counts
    its launches on the module attribute of its name, so each recorder
    carries the count while it stands in and hands it back after."""
    real = (gr.grouped_block_reduce, gr.column_tree_sum, gr.group_members)

    def keep(key, item):
        calls = store.setdefault(key, [])
        if len(calls) < 2:
            calls.append(item)

    def g(v, members, form):
        keep(form if v.dtype != torch.float64 else (form, "float64"),
             (v, members))
        return real[0](v, members, form)

    def t(x):
        keep("tree", x)
        return real[1](x)

    def m(gid, mask, blocks, gb):
        keep(("members", gb), (gid, mask, blocks, gb))
        return real[2](gid, mask, blocks, gb)

    g.launches, t.launches = real[0].launches, real[1].launches
    gr.grouped_block_reduce, gr.column_tree_sum, gr.group_members = g, t, m
    try:
        yield
    finally:
        real[0].launches, real[1].launches = g.launches, t.launches
        gr.grouped_block_reduce, gr.column_tree_sum, gr.group_members = real


def groupby_reference(table, key):
    """numpy over the scan: per key value (sorted) the row count and the
    float64 mean of usage_user."""
    rows = table.scan(["usage_user"]).rows
    vals = np.asarray(table.region.series.tag_values(key))[rows.sid]
    names, inv = np.unique(vals, return_inverse=True)
    cnt = np.bincount(inv)
    mean = np.bincount(inv, weights=rows.fields["usage_user"]) / cnt
    return names, cnt, mean


def check_groupby(name, res, ref):
    names, cnt, mean = ref
    key = np.asarray(res.cols[0].values, object)
    order = np.argsort(key)
    if res.num_rows != len(names) or not (key[order] == names).all():
        raise AssertionError(f"{name}: groups {res.num_rows} vs {len(names)}")
    avg = np.asarray(res.column("avg(usage_user)").values)[order]
    worst = float(np.max(np.abs(avg - mean) / np.abs(mean)))
    if worst > 1e-5:
        raise AssertionError(f"{name}: avg off the numpy mean by {worst}")
    if "count(*)" in res.names:
        got = np.asarray(res.column("count(*)").values)[order]
        if not np.array_equal(got, cnt):
            raise AssertionError(f"{name}: count(*) differs from bincount")
    return worst


def edge_members(dev, gr, rng, n, blocks, gb, layout="random"):
    """Edge inputs of G: NaNs of both signs, +-0.0, +-inf, an all-masked
    group and groups with no rows, padding rows (mask False, gid 0). Group
    ids are uniform ("random") or in series order ("runs": contiguous runs
    of 1, 31, 32, 33, 64, 65 and 4096+ rows, the padding after the live
    rows)."""
    v = (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n)).astype(
        np.float32)
    k = rng.choice(n, min(n, 64), replace=False)
    v[k] = np.resize(np.array(
        [0xFFC00001, 0x7FC00002, 0xFF800000, 0x7F800000, 0x80000000,
         0x00000000, 0x7FC00000, 0x80000000], np.uint32), len(k)).view(
        np.float32)
    mask = rng.random(n) > 0.15
    gid = rng.integers(0, max(gb - 2, 1), n).astype(np.int32)
    if layout == "runs":
        live = n - n // 7
        lens = rng.choice([1, 31, 32, 33, 64, 65, 4096], n)
        lens[lens == 4096] += rng.integers(0, 500, int((lens == 4096).sum()))
        runs = int(np.searchsorted(np.cumsum(lens), live)) + 1
        run_of = np.repeat(np.arange(runs), lens[:runs])[:live]
        gid[:live] = (run_of % max(gb - 2, 1)).astype(np.int32)
        mask[live:] = False
    if gb > 2:
        mask[gid == 1] = False
    gid[~mask] = 0
    return (torch.from_numpy(v).to(dev),
            gr.group_members(torch.from_numpy(gid).to(dev),
                             torch.from_numpy(mask).to(dev), blocks, gb))


def segment_stats(members):
    """Non-empty segments of a member order, their mean and largest row
    count: the regime the walk runs in."""
    lens = (members.ptr[1:] - members.ptr[:-1]).long()
    busy = lens[lens > 0]
    return {"segments": lens.numel(), "nonempty": busy.numel(),
            "mean_rows": float(busy.double().mean()) if busy.numel() else 0.0,
            "max_rows": int(busy.max()) if busy.numel() else 0}


def burst_ms(fn, reps=50) -> float:
    """Device time per call of a kernel that runs longer than its launch:
    CUDA events around `reps` back-to-back calls after a warm one."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def scattered_members(dev, gr, seed):
    """G's sum form where one thread a segment is at home: 2^25 live rows
    with uniform random ids over 4096 groups, 256 row blocks (~32 rows a
    segment), values and ids made on the card from `seed`."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n, gb, blocks = 1 << 25, 4096, 256
    v = (torch.randn(n, device=dev, generator=g)
         * 10.0 ** torch.randint(-3, 4, (n,), device=dev, generator=g))
    gid = torch.randint(0, gb, (n,), device=dev, generator=g,
                        dtype=torch.int32)
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    return v, gid, gr.group_members(gid, mask, blocks, gb)


def grouped_kernel_rows(dev, gr, store, launches, per_launch):
    """G and Gt at the shapes the GROUP BYs gave them (the hostname probe's
    sums, the region query's extremes and int32 winner stages, its
    var/stddev mean) and G's sum form on scattered rows, held against
    their plain versions on the card and on edge inputs, bit for bit, and
    timed beside their bounds, plain versions and library calls."""
    errs = {}

    def exact(what, got, want):
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"{what} differs from its plain version")
        diff = (got.double() - want.double()).abs()
        errs[what] = float(torch.nan_to_num(diff, nan=0.0).max())

    rng = np.random.default_rng(17)
    for layout in ("random", "runs"):
        for n, blocks, gb in ((100_003, 256, 64), (1 << 17, 65536, 16),
                              (50_000, 8, 1), (4097, 4096, 4),
                              (1 << 20, 256, 16)):
            v, members = edge_members(dev, gr, rng, n, blocks, gb, layout)
            for form in ("sum", "max", "min"):
                exact(f"G {form} edge {layout} {n}x{blocks}x{gb}",
                      gr.grouped_block_reduce(v, members, form),
                      gr.grouped_block_reduce_plain(v, members, form))
    # the main path's sections: the hostname probe's avg(usage_user) sums
    # (its second sum section; the first is the count), the region query's
    # min/max, and its stddev mean's column sum (the second tree: the
    # first is the count's)
    inputs = {"sum": store["sum"][1], "max": store["max"][0],
              "min": store["min"][0]}
    for form, (v, members) in inputs.items():
        exact(f"G {form}", gr.grouped_block_reduce(v, members, form),
              gr.grouped_block_reduce_plain(v, members, form))
    # the int32 extremes of last_value's and first_value's first stage
    for form in ("max", "min"):
        keys, members = store[form][1]
        if keys.dtype != torch.int32:
            raise AssertionError(f"G {form}: no int32 winner stage captured")
        exact(f"G {form} int32", gr.grouped_block_reduce(keys, members, form),
              gr.grouped_block_reduce_plain(keys, members, form))
    sv, sgid, sm = scattered_members(dev, gr, 23)
    exact("G sum scattered", gr.grouped_block_reduce(sv, sm, "sum"),
          gr.grouped_block_reduce_plain(sv, sm, "sum"))
    tree_x = store["tree"][1]
    exact("Gt", gr.column_tree_sum(tree_x), gr.column_tree_sum_plain(tree_x))
    x = (torch.randn(65536, 16, device=dev)
         * 10.0 ** torch.randint(-3, 4, (65536, 16), device=dev))
    exact("Gt edge", gr.column_tree_sum(x), gr.column_tree_sum_plain(x))

    def sum_bytes(members):
        nseg = members.gb * members.blocks
        return 8 * int(members.ptr[-1]) + 4 * (nseg + 1) + 4 * nseg

    def ext_bytes(members):
        return (8 * int(members.ptr[-1])
                + 4 * (members.gb * members.blocks + 1) + 4 * members.gb)

    def live_rows(members):
        # the library calls run over the live rows only (the padding
        # would pile onto one trash slot)
        return members.perm[:int(members.ptr[-1])].long()

    out = []
    # ---- G: the sum form at the hostname probe's shape and on scattered
    # rows, the extremes at the region query's
    v, members = inputs["sum"]
    gid, mask, blocks, gb = store["members", members.gb][0]
    n, nseg = v.numel(), members.gb * members.blocks
    per = -(-n // blocks)
    rows_live = live_rows(members)
    seg = (gid.long() * blocks + torch.arange(n, device=dev) // per)[
        rows_live]
    v_live = v[rows_live]
    sum_ms = per_launch.get("sum")
    bound = sum_bytes(members) / HBM_BYTES_PER_S * 1e3
    s_live = live_rows(sm)
    s_seg = (sgid.long() * sm.blocks + torch.arange(sm.n, device=dev)
             // -(-sm.n // sm.blocks))[s_live]
    s_bound = sum_bytes(sm) / HBM_BYTES_PER_S * 1e3
    key32 = gid.masked_fill(~mask, gb)
    key16 = key32.to(torch.int16)
    vx, mx = inputs["max"]
    gid_x = store["members", mx.gb][0][0]
    rx = live_rows(mx)
    keys, mk = store["max"][1]
    gid_k = store["members", mk.gb][0][0]
    rk = live_rows(mk)
    out.append({
        "name": "grouped_block_reduce", "route": "cuda",
        "source": "greptimedb_tpu_torch/parallel/kernels/csrc/"
                  "grouped_reduce.cu",
        "replaces": "greptimedb_tpu/query/reduce.py:250 pseg2 / :278 "
                    "segment_max (XLA, no Pallas kernel)",
        "launches": launches["grouped_block_reduce"],
        "max_abs_err": max(v for k, v in errs.items() if k.startswith("G ")),
        "ms": cuda_ms(lambda: gr.grouped_block_reduce(v, members, "sum")),
        "host_ms": host_ms(lambda: gr.grouped_block_reduce(v, members,
                                                           "sum")),
        "device_ms_per_launch": sum_ms,
        "burst_ms": burst_ms(lambda: gr.grouped_block_reduce(v, members,
                                                             "sum")),
        "plain_ms": cuda_ms(lambda: gr.grouped_block_reduce_plain(
            v, members, "sum"), reps=3, warm=1),
        "bound_ms": bound,
        "bound_by": "bytes",
        "library_ms": cuda_ms(lambda: torch.zeros(
            nseg, device=dev).index_add_(0, seg, v_live)),
        "share_of_bound": bound / sum_ms if sum_ms else None,
        "shape": {"rows": n, "live_rows": int(members.ptr[-1]),
                  "blocks": blocks, "gb": gb, **segment_stats(members)},
        "bytes": sum_bytes(members),
        "members_ms": cuda_ms(lambda: gr.group_members(gid, mask, blocks,
                                                       gb), reps=5),
        "members_sort_ms": {
            "int16": cuda_ms(lambda: torch.sort(key16, stable=True), reps=5),
            "int32": cuda_ms(lambda: torch.sort(key32, stable=True),
                             reps=5)},
        "scattered": {
            "burst_ms": burst_ms(lambda: gr.grouped_block_reduce(sv, sm,
                                                                 "sum")),
            "bound_ms": s_bound,
            "library_ms": cuda_ms(lambda: torch.zeros(
                sm.gb * sm.blocks, device=dev).index_add_(0, s_seg,
                                                         sv[s_live])),
            "shape": {"rows": sm.n, "live_rows": int(sm.ptr[-1]),
                      "blocks": sm.blocks, "gb": sm.gb,
                      **segment_stats(sm)},
            "bytes": sum_bytes(sm)},
        "max_form": {
            "ms": cuda_ms(lambda: gr.grouped_block_reduce(vx, mx, "max")),
            "device_ms_per_launch": per_launch.get("max"),
            "walk_ms_per_call": per_launch.get("max_walk"),
            "fold_ms_per_call": per_launch.get("max_fold"),
            "plain_ms": cuda_ms(lambda: gr.grouped_block_reduce_plain(
                vx, mx, "max"), reps=3, warm=1),
            "bound_ms": ext_bytes(mx) / HBM_BYTES_PER_S * 1e3,
            "library_ms": cuda_ms(lambda: torch.full(
                (mx.gb,), -torch.inf, device=dev).scatter_reduce_(
                0, gid_x.long()[rx], vx[rx], "amax")),
            "shape": {"rows": vx.numel(), "live_rows": int(mx.ptr[-1]),
                      "blocks": mx.blocks, "gb": mx.gb,
                      **segment_stats(mx)},
            "bytes": ext_bytes(mx)},
        "int32_form": {
            "ms": cuda_ms(lambda: gr.grouped_block_reduce(keys, mk, "max")),
            "device_ms_per_launch": per_launch.get("int32"),
            "walk_ms_per_call": per_launch.get("int32_walk"),
            "fold_ms_per_call": per_launch.get("int32_fold"),
            "bound_ms": ext_bytes(mk) / HBM_BYTES_PER_S * 1e3,
            "library_ms": cuda_ms(lambda: torch.full(
                (mk.gb,), torch.iinfo(torch.int32).min, dtype=torch.int32,
                device=dev).scatter_reduce_(0, gid_k.long()[rk], keys[rk],
                                            "amax")),
            "shape": {"rows": keys.numel(), "live_rows": int(mk.ptr[-1]),
                      "blocks": mk.blocks, "gb": mk.gb},
            "bytes": ext_bytes(mk)},
        "design": "a warp a 32-segment chunk of one group, chunk-major, "
                  "one launch of a warp a chunk: a chunk holding a segment "
                  f"of >= {gr._WARP_ROWS} rows streams as one coalesced "
                  "range through a shared-memory stage (12 batches of 32 "
                  "rows, the next chunk's loads in flight while this one "
                  "folds in order), any other walks a lane a segment with "
                  "16 rows of loads in flight; max/min fold a chunk's "
                  "segments in a warp, then a group's chunks in a second "
                  "kernel; members by a stable torch.sort of int16 group "
                  "ids",
    })
    # ---- Gt at the var/stddev mean's shape
    rows_t, cols_t = tree_x.shape
    tree_bytes = 4 * rows_t * cols_t + 4 * cols_t
    out.append({
        "name": "column_tree_sum", "route": "cuda",
        "source": "greptimedb_tpu_torch/parallel/kernels/csrc/"
                  "grouped_reduce.cu",
        "replaces": "greptimedb_tpu/query/reduce.py:274 jnp.sum(sp, axis=0)"
                    " (XLA, no Pallas kernel)",
        "launches": launches["column_tree_sum"],
        "max_abs_err": max(errs["Gt"], errs["Gt edge"]),
        "ms": cuda_ms(lambda: gr.column_tree_sum(tree_x)),
        "host_ms": host_ms(lambda: gr.column_tree_sum(tree_x)),
        "device_ms_per_launch": per_launch.get("tree"),
        "kernel_launches_per_call": per_launch.get("tree_launches"),
        "plain_ms": cuda_ms(lambda: gr.column_tree_sum_plain(tree_x)),
        "bound_ms": max(tree_bytes / HBM_BYTES_PER_S,
                        rows_t * cols_t / F32_OPS_PER_S) * 1e3,
        "bound_by": ("bytes" if tree_bytes / HBM_BYTES_PER_S
                     >= rows_t * cols_t / F32_OPS_PER_S else "operations"),
        "library_ms": cuda_ms(lambda: tree_x.sum(dim=0)),
        "shape": {"rows": rows_t, "cols": cols_t}, "bytes": tree_bytes,
        "design": "every level in one launch: a block a slab of 1024 rows "
                  "of a column tile (two levels in shared memory), the last "
                  "block of a tile to arrive runs the rest over the slab "
                  "sums",
    })
    return out


def per_call(ours, match, calls):
    """Profiler device ms of the kernels `match` selects over `calls`
    wrapper calls (None when either is missing)."""
    ms = sum(v["ms"] for k, v in ours.items() if match(k))
    return ms / calls if calls and ms else None


def rows_phase(args, dev, slice_out, mesh_out):
    """Phase 9 (see the module docstring). Returns the rows of G and Gt
    for the kernels line and every kernel's launches over the phase's main
    path."""
    from greptimedb_tpu_torch.instance import Instance
    from greptimedb_tpu_torch.parallel.kernels import grouped_reduce as gr
    from greptimedb_tpu_torch.parallel.kernels import merge_gather as mg
    from greptimedb_tpu_torch.parallel.kernels import ring_fold as rf
    from greptimedb_tpu_torch.parallel.mesh import MeshOptions, make_mesh

    t_phase = time.perf_counter()
    mesh = make_mesh([dev] * 4)
    runs = {
        ("slice", "single"): (slice_out, None, None, "fused"),
        ("mesh", "single"): (mesh_out, None, None, "fused"),
        ("mesh", "fused"): (mesh_out, mesh, None, "fused"),
        ("mesh", "hops"): (mesh_out, mesh, None, "hops"),
        ("mesh", "gather"): (mesh_out, mesh,
                             MeshOptions(pallas_kernels="off"), "fused"),
    }
    zero_counts(rf, mg)
    for k in GROUPED_KERNELS:
        getattr(gr, k).launches = 0
    store = {}
    results, stats, by_engine = {}, {}, {}

    def all_counts():
        return {**counts(rf, mg),
                **{k: getattr(gr, k).launches for k in GROUPED_KERNELS}}

    for (tname, ename), (tab, m, opts, form) in runs.items():
        inst = Instance(device=dev, mesh=m, mesh_opts=opts)
        inst.catalog.register(tab["table"])
        before_run = all_counts()
        per_query = {}
        capture = (capture_grouped(gr, store) if (tname, ename) == (
            "slice", "single") else contextlib.nullcontext())
        with ring_form(form), capture:
            for qname, sql in GROUPBY_QUERIES:
                if qname == "region_ring" and tname == "slice":
                    continue
                t = time.perf_counter()
                res = inst.sql(sql)
                torch.cuda.synchronize()
                cold = time.perf_counter() - t
                eng = inst.query_engine
                if eng.last_exec_path != "device":
                    raise AssertionError(f"{tname} {ename} {qname} ran "
                                         f"{eng.last_exec_path}")
                results[tname, ename, qname] = res
                times = []
                before = all_counts()
                for _ in range(3):
                    t = time.perf_counter()
                    inst.sql(sql)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t)
                after = all_counts()
                prof = profiled(lambda: inst.sql(sql))
                per_query[qname] = {
                    "cold_s": cold, "warm_median_s": float(np.median(times)),
                    "device_ms": prof["device_ms"],
                    "copy_ms": prof["copy_ms"],
                    "idle_share": prof["idle_share"],
                    "launches_per_warm": {
                        k: (after[k] - before[k]) / 3 for k in after
                        if after[k] > before[k]},
                    "program": dict(eng.last_reduce), "top": prof["top"],
                    "ours": prof["ours"]}
        stats[f"{tname}_{ename}"] = per_query
        after_run = all_counts()
        by_engine[f"{tname}_{ename}"] = {
            k: after_run[k] - before_run[k] for k in after_run
            if after_run[k] > before_run[k]}
    launches = all_counts()

    # ---- checks -------------------------------------------------------
    checks = {}
    for tname, tab in (("slice", slice_out), ("mesh", mesh_out)):
        table = tab["table"]
        for qname, key in (("hostname_avg", "hostname"),
                           ("region_all", "region")):
            checks[f"{tname}_{qname}_max_rel_vs_numpy"] = check_groupby(
                f"{tname} {qname}", results[tname, "single", qname],
                groupby_reference(table, key))
    for qname, _ in GROUPBY_QUERIES:
        ref = results["mesh", "single", qname]
        for ename in ("fused", "hops", "gather"):
            compare_engines(f"rows mesh {ename} {qname}", ref,
                            results["mesh", ename, qname], 1)
            prog = stats[f"mesh_{ename}"][qname]["program"]
            want = ("single" if qname == "region_all" else
                    "sharded_gather" if ename == "gather" else
                    "sharded_ring")
            if prog["program"] != want or (
                    want == "sharded_ring" and prog["ring_form"] != ename):
                raise AssertionError(f"rows mesh {ename} {qname} ran {prog}")
    for eng_name, got in by_engine.items():
        if not got.get("grouped_block_reduce"):
            raise AssertionError(f"G never launched on {eng_name}")
    for ename, want in (
            ("fused", {**GROUPBY_RINGS, "extreme": 0, "onehot_add": 0}),
            ("hops", {**GROUPBY_HOPS, **{k: 0 for k in GROUPBY_RINGS}}),
            ("gather", {k: 0 for k in (*GROUPBY_RINGS, *GROUPBY_HOPS)})):
        warm = stats[f"mesh_{ename}"]["region_ring"]["launches_per_warm"]
        for k, n in want.items():
            if warm.get(k, 0) != n:
                raise AssertionError(f"{k}: {warm.get(k, 0)} launches per "
                                     f"warm region_ring GROUP BY on the "
                                     f"{ename} engine, not {n}")

    # ---- the host paths on the slice table ----------------------------
    table = slice_out["table"]
    host_inst = Instance(device=dev)
    host_inst.catalog.register(table)
    host = {}
    hits0 = table.region.scan_cache_hits
    for name, sql in host_shapes():
        hits = table.region.scan_cache_hits
        t = time.perf_counter()
        res = host_inst.sql(sql)
        wall = time.perf_counter() - t
        if host_inst.query_engine.last_exec_path != "host":
            raise AssertionError(f"{name} ran "
                                 f"{host_inst.query_engine.last_exec_path}")
        if res.num_rows == 0:
            raise AssertionError(f"{name} returned no rows")
        host[name] = {"wall_s": wall, "rows": res.num_rows,
                      "scan_cache_hit": table.region.scan_cache_hits > hits}
        if name.startswith("high_cpu"):
            host[name]["rows_vs_numpy"] = check_high_cpu(table, name, res)
    if not host["high_cpu_all_cached"]["scan_cache_hit"]:
        raise AssertionError("the second high-cpu-all missed the merged-"
                             "scan cache")
    # the OR of two hosts on the host path against the same hosts as a
    # matcher on the device grid
    dev_or = host_inst.sql(host_shapes()[3][1].replace(
        "(hostname = 'host_3' OR hostname = 'host_4')",
        "hostname IN ('host_3', 'host_4')"))
    if host_inst.query_engine.last_exec_path != "device":
        raise AssertionError("the IN twin of or_hosts left the device grid")
    host_or = host_inst.sql(host_shapes()[3][1])
    a = np.asarray(host_or.cols[2].values)
    b = np.asarray(dev_or.cols[2].values)
    if host_or.num_rows != dev_or.num_rows or not np.allclose(
            a, b, rtol=1e-5, atol=0):
        raise AssertionError("or_hosts on the host differs from the grid")
    host["scan_cache_hits"] = table.region.scan_cache_hits - hits0

    # ---- kernels G and Gt --------------------------------------------
    # device time per wrapper call on the warm profiled GROUP BYs of the
    # slice table: a max/min call is a segment walk and a group fold (the
    # float32 extremes of min/max, the int32 ones of the winner stages),
    # each also apart; a Gt call is one launch
    slice_stats = stats["slice_single"]
    region = slice_stats["region_all"]
    ours = region["ours"]
    per_launch = {"sum": device_ms_per_launch(
        {"ours": slice_stats["hostname_avg"]["ours"]},
        lambda k: k.startswith("segment_walk_kernel<float, 0>"))}
    for t, key in (("float", "max"), ("int", "int32")):
        walks = tuple(f"segment_walk_kernel<{t}, {f}>" for f in (1, 2))
        fold = f"group_fold_kernel<{t}"
        calls = sum(v["calls"] for k, v in ours.items()
                    if k.startswith(walks))
        per_launch[key] = per_call(
            ours, lambda k: k.startswith((*walks, fold)), calls)
        per_launch[f"{key}_walk"] = per_call(
            ours, lambda k: k.startswith(walks), calls)
        per_launch[f"{key}_fold"] = per_call(
            ours, lambda k: k.startswith(fold), calls)
    tree_calls = region["launches_per_warm"].get("column_tree_sum")
    tree_kernels = sum(v["calls"] for k, v in ours.items()
                       if k.startswith("column_tree_kernel"))
    per_launch["tree"] = per_call(
        ours, lambda k: k.startswith("column_tree_kernel"), tree_calls)
    # the region query's var/stddev mean makes Gt calls: none counted, or
    # none profiled, is a failed measurement
    if not tree_calls or tree_kernels != tree_calls:
        raise AssertionError(f"Gt: {tree_kernels} kernels profiled over "
                             f"{tree_calls} calls, not one a call")
    per_launch["tree_launches"] = tree_kernels / tree_calls
    t = time.perf_counter()
    rows = grouped_kernel_rows(dev, gr, store, launches, per_launch)
    emit({"phase": "rows", "engines": stats, "checks": checks,
          "launches": launches, "launches_by_engine": by_engine,
          "host": host, "host_cut_ms": HOST_CUT_MS,
          "kernel_seconds": time.perf_counter() - t,
          "phase_seconds": time.perf_counter() - t_phase})
    return rows, launches, {
        e: stats[f"mesh_{e}"]["region_ring"]["launches_per_warm"]
        for e in ("fused", "hops")}


# ---- phase 11: durable ------------------------------------------------

# the child of the crash check: reopen the durable catalog, write one more
# 15-minute run past the data, acknowledge it, and die before any flush
CRASH_CHILD = r"""
import os, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from chip_smoke import durable_catalog, crash_batch
eng, cat = durable_catalog(sys.argv[2], sys.argv[3])
table = cat.table("public", "cpu")
tags, ts, fields = crash_batch(int(sys.argv[4]), int(sys.argv[5]),
                               int(sys.argv[6]))
table.write(tags, ts, fields)
print("ACK", len(ts), flush=True)
os._exit(0)
"""


def durable_catalog(root, device):
    """A storage engine over `root` (WAL on, wal_sync at its default, merges
    verified against the host merge) and the catalog on it."""
    from greptimedb_tpu_torch.catalog.manager import CatalogManager
    from greptimedb_tpu_torch.storage.compaction import CompactionOptions
    from greptimedb_tpu_torch.storage.engine import EngineConfig, TsdbEngine

    eng = TsdbEngine(EngineConfig(
        data_root=root, enable_background=False,
        compaction=CompactionOptions(verify_device_merge=True)),
        device=device)
    return eng, CatalogManager(eng)


def crash_batch(seed, hosts, hours):
    """The crash child's write: a 15-minute run of every host right after
    the data's last hour, values from `seed`."""
    rng = np.random.default_rng(seed + 1)
    per_run = HOUR_MS // STEP_MS // 4
    t0 = hours * (HOUR_MS // STEP_MS)
    names = np.array([f"host_{i}" for i in range(hosts)], object)
    ts = np.tile(np.arange(t0, t0 + per_run, dtype=np.int64) * STEP_MS,
                 hosts)
    hi = np.repeat(np.arange(hosts), per_run)
    fields = {f: rng.random(len(ts)) for f in FIELDS}
    return {"hostname": names[hi], "region": np.full(len(ts), "crash",
                                                     object)}, ts, fields


def same_scan(name, want, got):
    """Two full scans bit for bit: sids, timestamps, sequences, ops, every
    field's bits and validity (a validity of None reads as all valid)."""
    if len(want) != len(got):
        raise AssertionError(f"{name}: {len(got)} rows, not {len(want)}")
    for k in ("sid", "ts", "seq", "op"):
        if not np.array_equal(getattr(want, k), getattr(got, k)):
            raise AssertionError(f"{name}: column {k} differs")
    for f in FIELDS:
        if not np.array_equal(want.fields[f].view(np.uint64),
                              got.fields[f].view(np.uint64)):
            raise AssertionError(f"{name}: field {f} differs")
        va = (want.field_valid or {}).get(f)
        vb = (got.field_valid or {}).get(f)
        va = np.ones(len(want), bool) if va is None else va
        vb = np.ones(len(got), bool) if vb is None else vb
        if not np.array_equal(va, vb):
            raise AssertionError(f"{name}: validity of {f} differs")


def durable_phase(args, dev, slice_out, P):
    """Phase 11 (see the module docstring). Returns K1's and K2's launches
    over the phase's main path."""
    import shutil
    import tempfile

    from greptimedb_tpu_torch.parallel.kernels import merge_gather as mg
    from greptimedb_tpu_torch.parallel.kernels import ring_fold as rf
    from greptimedb_tpu_torch.query import device_range as DR
    from greptimedb_tpu_torch.query.executor import QueryEngine
    from greptimedb_tpu_torch.storage import recovery as R
    from greptimedb_tpu_torch.storage.device_merge import (
        DEFAULT_KERNEL_MIN_ROWS,
    )
    from greptimedb_tpu_torch.storage.page_cache import global_page_cache

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="chip_smoke_durable_")
    out = {"guarantee": "wal_sync=False: an acknowledged write survives a "
                        "process crash (the WAL is written and flushed to "
                        "the OS before the write returns), not a power "
                        "loss (no fsync)"}
    q1, q2 = make_plans(P)
    mg.gather_planes.launches = 0
    rf.blocked_fold_sum.launches = 0
    try:
        eng, cat = durable_catalog(root, dev)
        table = cat.create_table(
            "public", "cpu", ts_name="ts", tag_names=["hostname", "region"],
            fields=FIELDS, options={"compaction_trigger_files": 2,
                                    "compaction_window_ms": HOUR_MS,
                                    "memtable_window_ms": HOUR_MS})
        # ---- ingest: phase 2's writes, each hour's four runs as one
        # batch (bench.py's hourly WAL batches), then its re-delivery
        # and tombstone runs; a flush after each write
        rng = np.random.default_rng(args.seed)
        hosts = np.array([f"host_{i}" for i in range(args.hosts)])
        region_of = np.array(AWS_REGIONS)[rng.integers(
            0, len(AWS_REGIONS), args.hosts)]
        written, write_s, flush_s, flushes = 0, 0.0, 0.0, 0
        for runs in tsbs_hours(rng, hosts, region_of, args.hours):
            puts = runs[:4]
            hourly = ("put",
                      {k: np.concatenate([r[1][k] for r in puts])
                       for k in puts[0][1]},
                      np.concatenate([r[2] for r in puts]),
                      {f: np.concatenate([r[3][f] for r in puts])
                       for f in FIELDS})
            for run in (hourly, runs[4], runs[5]):
                t = time.perf_counter()
                written += write_run(table, run)
                write_s += time.perf_counter() - t
                t = time.perf_counter()
                table.flush()
                flush_s += time.perf_counter() - t
                flushes += 1
        out["ingest"] = {"rows": written, "write_s": write_s,
                         "rows_per_s_wal": written / write_s,
                         "flushes": flushes, "flush_s": flush_s,
                         "flush_s_each": flush_s / flushes}
        # ---- compaction: every window's three files merge on the card
        region = table.region
        k1 = mg.gather_planes.launches
        t = time.perf_counter()
        if not table.compact():
            raise AssertionError("durable compaction merged nothing")
        torch.cuda.synchronize()
        compact_s = time.perf_counter() - t
        k1 = mg.gather_planes.launches - k1
        big = [p for p, n in zip(region.merge_paths, region.merge_rows_in)
               if n >= DEFAULT_KERNEL_MIN_ROWS]
        if not big or set(big) != {"fused"} or k1 < len(big):
            raise AssertionError(f"durable merges {region.merge_paths} "
                                 f"{region.merge_rows_in}: K1 launched {k1}"
                                 f" times for {len(big)} merges of "
                                 f">= {DEFAULT_KERNEL_MIN_ROWS} rows")
        out["compaction"] = {
            "seconds": compact_s, "merges": len(region.merge_paths),
            "seconds_per_merge": compact_s / len(region.merge_paths),
            "rows_in": region.merge_rows_in, "paths": region.merge_paths,
            "k1_launches": k1, "k1_launches_per_merge": k1 / len(big),
            "ssts_after": len(region.manifest.state.ssts)}
        want = slice_out["table"].scan(FIELDS).rows
        t = time.perf_counter()
        same_scan("after compaction", want, table.scan(FIELDS).rows)
        out["scan_after_compaction_s"] = time.perf_counter() - t
        eng.close()

        # ---- reopen: manifest load, WAL replay, SST restore
        global_page_cache.clear()
        t = time.perf_counter()
        eng, cat = durable_catalog(root, dev)
        open_ms = (time.perf_counter() - t) * 1e3
        table = cat.table("public", "cpu")
        region = table.region
        restore = {}
        for depth in (0, 4):
            global_page_cache.clear()
            st = R.restore_region_ssts(region, prefetch_depth=depth)
            restore["serial_ms" if depth == 0 else "pipelined_ms"] = st["ms"]
            restore["files"], restore["bytes"] = st["files"], st["bytes"]
        stats = region.recovery_stats
        out["reopen"] = {
            "open_ms": open_ms,
            "manifest_load_ms": stats["manifest_load_ms"],
            "wal_replay_ms": stats["wal_replay_ms"],
            "replayed_entries": stats["replayed_entries"],
            "region_open_total_ms": stats["total_ms"],
            "sst_restore": restore}
        same_scan("after reopen", want, table.scan(FIELDS).rows)

        # ---- Q1/Q2 on the recovered table: phase 2's answers bit for bit
        qe = QueryEngine(device=dev)
        k2 = rf.blocked_fold_sum.launches
        t = time.perf_counter()
        r1 = qe.execute(q1, table)
        torch.cuda.synchronize()
        q1_build_s = time.perf_counter() - t
        t = time.perf_counter()
        r2 = qe.execute(q2, table)
        torch.cuda.synchronize()
        q2_cold_s = time.perf_counter() - t
        if rf.blocked_fold_sum.launches == k2:
            raise AssertionError("Q2 on the recovered table did not run K2")
        compare_engines("durable Q1", slice_out["q1"], r1, 1)
        compare_engines("durable Q2", slice_out["q2"], r2, 1)
        # ---- the grid's restart snapshot: persist the grown entry, then
        # a fresh engine loads it and answers without a rebuild
        entry = next(iter(qe.range_cache._entries.values()))
        if entry.persist_thread is not None:
            entry.persist_thread.join()
        t = time.perf_counter()
        if not DR.persist_entry(entry, table):
            raise AssertionError("the grid snapshot was not written")
        persist_s = time.perf_counter() - t
        eng.close()
        eng, cat = durable_catalog(root, dev)
        table = cat.table("public", "cpu")
        qe = QueryEngine(device=dev)
        t = time.perf_counter()
        s1 = qe.execute(q1, table)
        torch.cuda.synchronize()
        q1_snap_s = time.perf_counter() - t
        restored = qe.last_grid
        entry = next(iter(qe.range_cache._entries.values()))
        nbytes = entry.nbytes
        t = time.perf_counter()
        s2 = qe.execute(q2, table)
        torch.cuda.synchronize()
        q2_snap_s = time.perf_counter() - t
        if restored != "restored" or qe.last_grid != "hit" \
                or entry.nbytes != nbytes:
            raise AssertionError(f"the snapshot did not answer alone: "
                                 f"{restored}, {qe.last_grid}")
        compare_engines("snapshot Q1", slice_out["q1"], s1, 1)
        compare_engines("snapshot Q2", slice_out["q2"], s2, 1)
        out["snapshot"] = {
            "persist_s": persist_s, "grid_bytes": nbytes,
            "q1_cold_rebuild_s": q1_build_s, "q2_after_rebuild_s": q2_cold_s,
            "q1_cold_from_snapshot_s": q1_snap_s,
            "q2_after_snapshot_s": q2_snap_s}
        eng.close()

        # ---- a crash before flush: the child's acknowledged rows come
        # back, and the second reopen replays nothing
        child = subprocess.run(
            [sys.executable, "-c", CRASH_CHILD, here, root, str(dev),
             str(args.seed), str(args.hosts), str(args.hours)],
            capture_output=True, text=True, timeout=300, cwd=here)
        if child.returncode != 0 or "ACK" not in child.stdout:
            raise AssertionError(f"crash child failed: {child.stderr}")
        t = time.perf_counter()
        eng, cat = durable_catalog(root, dev)
        crash_open_ms = (time.perf_counter() - t) * 1e3
        table = cat.table("public", "cpu")
        replayed = table.region.recovery_stats["replayed_entries"]
        tags, ts, fields = crash_batch(args.seed, args.hosts, args.hours)
        got = table.scan(FIELDS, ts_min=int(ts.min())).rows
        order = np.lexsort((ts, np.repeat(np.arange(args.hosts),
                                          len(ts) // args.hosts)))
        if (replayed < 1 or got is None or len(got) != len(ts)
                or not np.array_equal(got.ts, ts[order])
                or any(not np.array_equal(got.fields[f], fields[f][order])
                       for f in FIELDS)):
            raise AssertionError("acknowledged rows lost in the crash")
        eng.close()
        eng, cat = durable_catalog(root, dev)
        second = cat.table("public", "cpu").region.recovery_stats[
            "replayed_entries"]
        eng.close()
        if second != 0:
            raise AssertionError(f"second reopen replayed {second} entries")
        out["crash"] = {"acked_rows": len(ts), "replayed_entries": replayed,
                        "reopen_ms": crash_open_ms,
                        "recovery_flush_ms": table.region.recovery_stats.get(
                            "recovery_flush_ms"),
                        "second_reopen_replayed": second}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = {"gather_planes": mg.gather_planes.launches,
                "blocked_fold_sum": rf.blocked_fold_sum.launches}
    emit({"phase": "durable", **out, "launches": launches,
          "checks": {"scan_identical_after_compaction": True,
                     "scan_identical_after_reopen": True,
                     "q1_q2_identical": True, "snapshot_identical": True,
                     "crash_rows_read_back": True,
                     "second_reopen_replays_nothing": True},
          "phase_seconds": time.perf_counter() - t_phase})
    for k, n in launches.items():
        if n == 0:
            raise AssertionError(f"{k} never launched in phase durable")
    return launches


def check_high_cpu(table, name, res):
    """A high-cpu result against a numpy mask over the table's scan."""
    rows = table.scan(["usage_user", "usage_system"]).rows
    sel = rows.fields["usage_user"] > 90.0
    if name == "high_cpu_1":
        host = np.asarray(table.region.series.tag_values("hostname"))
        sel &= host[rows.sid] == "host_17"
    if res.num_rows != int(sel.sum()) or not np.array_equal(
            np.asarray(res.column("ts").values), rows.ts[sel]) or not (
            np.array_equal(np.asarray(res.column("usage_system").values),
                           rows.fields["usage_system"][sel])):
        raise AssertionError(f"{name} differs from a numpy filter")
    return int(sel.sum())


def run(args) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:
        sys.path.insert(0, here)
    from greptimedb_tpu_torch.catalog.table import Table
    from greptimedb_tpu_torch.parallel.kernels import build
    from greptimedb_tpu_torch.parallel.kernels import merge_gather as mg
    from greptimedb_tpu_torch.parallel.kernels import ring_fold as rf
    from greptimedb_tpu_torch.query import planner as P
    from greptimedb_tpu_torch.query.executor import QueryEngine

    dev = _device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. build -----------------------------------------------------
    t0 = time.perf_counter()
    built = build.build_all()
    for name in build.SOURCES:
        build.load(name)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": built})
    for name, log in build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                emit({"ptxas": name, "line": line.strip()})
    smi = nvidia_smi_line()
    print(smi, flush=True)

    # ---- 2. the slice ------------------------------------------------
    rng = np.random.default_rng(args.seed)
    hosts = np.array([f"host_{i}" for i in range(args.hosts)])
    region_of = np.array(AWS_REGIONS)[rng.integers(0, len(AWS_REGIONS),
                                                    args.hosts)]
    table = Table("cpu", ts_name="ts", tag_names=["hostname", "region"],
                  fields=FIELDS)
    q1, q2 = make_plans(P)
    mg.gather_planes.launches = 0
    rf.blocked_fold_sum.launches = 0
    torch.cuda.reset_peak_memory_stats()
    phases = {}

    t = time.perf_counter()
    written = ingest(table, rng, hosts, region_of, args.hours)
    phases["ingest"] = time.perf_counter() - t
    rows0 = window_rows(table, 0)       # K1's inputs for phase 4

    t = time.perf_counter()
    merged = table.compact(device=dev, verify=True, kernels="on")
    torch.cuda.synchronize()
    phases["compact"] = time.perf_counter() - t
    paths = table.region.merge_paths
    if merged != args.hours or set(paths) != {"fused"}:
        raise AssertionError(f"compaction paths {paths}")

    eng = QueryEngine(device=dev)
    t = time.perf_counter()
    r1 = eng.execute(q1, table)
    torch.cuda.synchronize()
    phases["q1_cold_with_grid_build"] = time.perf_counter() - t
    t = time.perf_counter()
    r2 = eng.execute(q2, table)
    torch.cuda.synchronize()
    phases["q2_cold_with_state_growth"] = time.perf_counter() - t
    warm = {}
    for name, plan in (("q1", q1), ("q2", q2)):
        times = []
        for _ in range(5):
            t = time.perf_counter()
            eng.execute(plan, table)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        warm[name] = float(np.median(times))
    phases["q1_warm_median"] = warm["q1"]
    phases["q2_warm_median"] = warm["q2"]
    launches = {"gather_planes": mg.gather_planes.launches,
                "blocked_fold_sum": rf.blocked_fold_sum.launches}
    grid_peak = torch.cuda.max_memory_allocated()
    entry = next(iter(eng.range_cache._entries.values()))
    emit({"phase": "slice", "seconds": phases, "rows_written": written,
          "rows_after_compaction": int(table.row_count()),
          "merges": merged, "merge_paths": sorted(set(paths)),
          "grid": {"series": entry.num_series, "cells": entry.nb,
                   "device_bytes": entry.bytes()},
          "max_memory_allocated": grid_peak, "launches": launches})
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"main path")

    # ---- 3. check ----------------------------------------------------
    t = time.perf_counter()
    n_steps1 = args.hours
    if r1.num_rows != args.hosts * n_steps1:
        raise AssertionError(f"Q1 rows {r1.num_rows}")
    for c in r1.cols[2:]:
        if c.validity is not None or not np.isfinite(c.values).all():
            raise AssertionError("Q1 has missing or non-finite cells")
    if r2.num_rows != len(set(region_of)) * (args.hours + 1):
        raise AssertionError(f"Q2 rows {r2.num_rows}")
    cpu = QueryEngine(device="cpu")
    c1 = cpu.execute(q1, table)
    c2 = cpu.execute(q2, table)
    exact = {"count", "min", "max", "first_value", "last_value"}
    q1_err = compare_results("Q1", r1, c1, exact, w=HOUR_MS // STEP_MS)
    q2_err = compare_results("Q2", r2, c2, exact | {
        "sum", "mean", "stddev_samp"}, w=2 * HOUR_MS // STEP_MS)
    q1_np = check_q1_against_numpy(table, r1, hosts)
    emit({"phase": "check", "seconds": time.perf_counter() - t,
          "q1_rows": r1.num_rows, "q2_rows": r2.num_rows,
          "q1_max_abs_diff_vs_cpu": q1_err,
          "q2_max_abs_diff_vs_cpu": q2_err,
          "q1_max_rel_diff_vs_numpy": q1_np})

    # ---- 4. kernels --------------------------------------------------
    t = time.perf_counter()
    planes, src = k1_inputs(rows0, dev)
    memo = next(m for m in entry.query_memo.values() if m["fold"])
    kernels = kernel_checks(dev, planes, src, entry, memo, launches)
    emit({"phase": "kernels", "seconds": time.perf_counter() - t})

    # ---- 5. profile: device busy time of one warm query each and of
    # one window's merge (no verify), under torch.profiler ------------
    from greptimedb_tpu_torch.storage.device_merge import merge_rows

    t = time.perf_counter()
    profs = {"q1_warm": profiled(lambda: eng.execute(q1, table)),
             "q2_warm": profiled(lambda: eng.execute(q2, table))}
    merge_prof = profs["merge_one_window"] = profiled(lambda: merge_rows(
        rows0, drop_deletes=True, device=dev, kernels="on"))
    emit({"phase": "profile", **profs,
          "seconds": time.perf_counter() - t})
    # K1's device time in the profiled merge of window 0
    kernels[0]["device_ms_per_launch_merge"] = device_ms_per_launch(
        merge_prof, lambda k: k.startswith("gather_planes"))
    # ---- 6. mesh -----------------------------------------------------
    mesh_out = mesh_phase(args, dev, P)
    kernels += mesh_out["rows"]
    # ---- 7. promql ---------------------------------------------------
    prom_rows, prom_out = promql_phase(args, dev)
    kernels += prom_rows
    # ---- 8. sql ------------------------------------------------------
    slice_out = {"table": table, "engine": eng, "hosts": args.hosts,
                 "hours": args.hours, "regions": len(set(region_of)),
                 "q1": r1, "q2": r2}
    sql_launches, hop_launches, sql_per_launch, q2_warm = sql_phase(
        args, dev, slice_out, mesh_out)
    # ---- 9. rows -----------------------------------------------------
    grouped_rows, rows_launches, rows_warm = rows_phase(args, dev,
                                                        slice_out, mesh_out)
    kernels += grouped_rows
    # ---- 10. promql_rest ----------------------------------------------
    rest_launches, g_at_f = promql_rest_phase(args, dev, prom_out)
    # ---- 11. durable ---------------------------------------------------
    durable_launches = durable_phase(args, dev, slice_out, P)
    # every kernel's launches over the main-path runs of phases 2 and 6
    # to 10; the hop ring's seed, continuation and combines ran in phase 8
    # only, Gt in phase 9 only, G in phases 9 and 10
    extreme_row = next(r for r in mesh_out["rows"] if r["name"] == "extreme")
    floor = {k: v for k, v in extreme_row.items()
             if k.startswith("launch_floor")}
    for row in kernels:
        name = row["name"]
        row["launches"] += sql_launches.get(name, 0)
        if rest_launches.get(name):
            row["launches"] += rest_launches[name]
            row["launches_promql_rest"] = rest_launches[name]
        if name == "grouped_block_reduce":
            row["promql_f"] = g_at_f
        if name not in GROUPED_KERNELS and rows_launches.get(name):
            row["launches"] += rows_launches[name]
            row["launches_groupby"] = rows_launches[name]
            row["launches_per_warm_groupby"] = rows_warm[
                "hops" if name in GROUPBY_HOPS else "fused"].get(name, 0)
        if name == "blocked_fold_sum":
            row["launches_hop_ring_sql"] = hop_launches["blocked_fold_sum"]
            row["device_ms_per_launch_hop_ring_q2"] = sql_per_launch[
                "blocked_fold_sum"]
        elif name in sql_per_launch:
            row["device_ms_per_launch_sql_q2"] = sql_per_launch[name]
        if name in Q2_HOPS:
            row["launches_per_warm_sql_q2_hop_ring"] = q2_warm["hops"].get(
                name, 0)
        elif name in ONE_RING_KERNELS:
            row["launches_per_warm_sql_q2"] = q2_warm["fused"].get(name, 0)
        elif name in TOPK_KERNELS:
            row.update(floor)
        if durable_launches.get(name):
            row["launches"] += durable_launches[name]
            row["launches_durable"] = durable_launches[name]
        if row["launches"] == 0:
            raise AssertionError(f"kernel {name} never launched")
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hosts", type=int, default=4000)
    ap.add_argument("--hours", type=int, default=12)
    ap.add_argument("--mesh-hosts", type=int, default=8192)
    ap.add_argument("--mesh-hours", type=int, default=6)
    ap.add_argument("--prom-series", type=int, default=1_000_000)
    ap.add_argument("--hist-pods", type=int, default=12_500)
    ap.add_argument("--rest-warm", type=int, default=5,
                    help="warm runs of each phase-10 query (median)")
    args = ap.parse_args()
    try:
        return run(args)
    except Exception:
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
