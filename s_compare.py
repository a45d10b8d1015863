#!/usr/bin/env python3
"""Time S (segmented_scan) of this tree against another checkout's on one
CUDA card, in one process, in turns: other, this, this, other.

    python3 s_compare.py --other DIR [--stream-blocks 1,2]

DIR holds another checkout of the repository (for instance the parent
commit, unpacked with `git archive <rev> | tar -x -C DIR`). Its
csrc/segmented_scan.cu is compiled with this tree's nvcc flags for that
source and called through ctypes with the earlier C interface (x0, x1,
reset, y0, y1, scratch, n, stream; the scratch sized by its
`_scratch_bytes` twin); this tree's S runs through its wrapper. Each
`--stream-blocks` B also builds this tree's source with B blocks an SM
for the streaming form in place of its own bound (`this_b<B>`, through
ctypes with this tree's interface), to compare the bound the source
picks with the others. Shapes, from seeded data with a reset every 4,320
rows (a host of chip_smoke.py phase 14's table):

- full: 17.28 M rows (phase 14's table) in the f64 add, int32 add and
  two-float compensated forms;
- metric: 263,520 rows (the window metric's) in the f64 add and
  compensated forms.

Every output is held bit for bit against the plain version. Prints one
JSON line per shape (each leg's CUDA-event median ms of one launch, the
per-launch ms of a burst of 50, and the profiler's device ms of one
launch with the launches it saw in 5 calls) and the card's name and
power limit; exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

SRC = "greptimedb_tpu_torch/parallel/kernels/csrc/segmented_scan.cu"
BOUND = "__launch_bounds__(kThreads, kKeep ? 1 : 3)"
_P, _LL = ctypes.c_void_p, ctypes.c_longlong
SHAPES = [("full", "add", torch.float64, 17_280_000),
          ("full", "add", torch.int32, 17_280_000),
          ("full", "comp", torch.float32, 17_280_000),
          ("metric", "add", torch.float64, 263_520),
          ("metric", "comp", torch.float32, 263_520)]
_SUFFIX = {torch.int32: "i32", torch.float64: "f64", torch.float32: "f32"}


def compile_lib(src_text: str, name: str) -> ctypes.CDLL:
    """A copy of S's source, built with this tree's flags for it."""
    from greptimedb_tpu_torch.parallel.kernels import build

    out = build.BUILD_DIR / f"libsegscan_{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    src = out.with_suffix(".cu")
    src.write_text(src_text)
    subprocess.run([build._nvcc(), *build._flags("segmented_scan"), "-o",
                    str(out), str(src)], check=True, capture_output=True,
                   text=True)
    return ctypes.CDLL(str(out))


def other_leg(lib, form, dtype, n):
    """The other checkout's launcher (its earlier interface) as a call."""
    sym = f"gtt_segscan_{form}_{_SUFFIX[dtype]}"
    fn = getattr(lib, sym)
    fn.argtypes = [_P] * 6 + [_LL, _P]
    fn.restype = ctypes.c_int
    size = getattr(lib, f"{sym}_scratch_bytes")
    size.argtypes = [_LL]
    size.restype = _LL
    scratch = torch.empty(size(n), dtype=torch.uint8, device="cuda")

    def call(xs, r, out):
        two = out.dim() == 2
        return fn(xs[0].data_ptr(), xs[1].data_ptr() if two else None,
                  r.data_ptr(), out[0].data_ptr() if two else out.data_ptr(),
                  out[1].data_ptr() if two else None, scratch.data_ptr(), n,
                  torch.cuda.current_stream().cuda_stream)
    return call


def variant_leg(lib, form, dtype, n):
    """A build of this tree's source (its interface) as a call."""
    sym = f"gtt_segscan_{form}_{_SUFFIX[dtype]}"
    fn = getattr(lib, sym)
    fn.argtypes = [_P] * 6 + [_LL, _LL, ctypes.c_int, _P]
    fn.restype = ctypes.c_int
    size = getattr(lib, f"{sym}_scratch_bytes")
    size.argtypes = [_LL]
    size.restype = _LL
    nbytes = size(n)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device="cuda")

    def call(xs, r, out):
        two = out.dim() == 2
        return fn(xs[0].data_ptr(), xs[1].data_ptr() if two else None,
                  r.data_ptr(), out[0].data_ptr() if two else out.data_ptr(),
                  out[1].data_ptr() if two else None, scratch.data_ptr(),
                  nbytes, n, 0, torch.cuda.current_stream().cuda_stream)
    return call


def inputs(form, dtype, n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = torch.zeros(n, dtype=torch.bool, device="cuda")
    r[::4320] = True
    if dtype == torch.int32:
        return [torch.randint(0, 2, (n,), generator=g, device="cuda",
                              dtype=dtype)], r
    v = torch.rand(n, generator=g, device="cuda", dtype=torch.float64) * 100
    if dtype == torch.float64:
        return [v], r
    hi = v.float()
    return [hi, (v - hi.double()).float()], r


def timings(run) -> dict:
    """Event median of one launch, per-launch ms of a burst of 50, and
    the profiler's device ms of one launch over 5 calls."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    one, burst = [], []
    for reps, calls, into in ((20, 1, one), (5, 50, burst)):
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(calls):
                run()
            b.record()
            b.synchronize()
            into.append(a.elapsed_time(b) / calls)
    seen = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: seen.extend(
                     p.key_averages())) as prof:
        run()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(5):
            run()
        torch.cuda.synchronize()
        prof.step()
    ours = [e for e in seen if e.device_type == torch.autograd.DeviceType.CUDA
            and ("segscan_kernel<" in e.key or "up_kernel<" in e.key
                 or "down_kernel<" in e.key)]
    launches = sum(e.count for e in ours)
    one.sort()
    burst.sort()
    return {"ms": one[len(one) // 2], "burst_ms": burst[len(burst) // 2],
            "device_ms_a_call": (sum(e.self_device_time_total for e in ours)
                                 / 1e3 / 5) if launches else None,
            "kernel_launches_in_5_calls": launches}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--stream-blocks", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("s_compare: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from greptimedb_tpu_torch.parallel.kernels import segmented_scan as ss

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    other = compile_lib((args.other / SRC).read_text(), "other")
    text = Path(SRC).read_text()
    if BOUND not in text:
        raise SystemExit(f"s_compare: {BOUND} is not in {SRC}")
    variants = {f"this_b{b}": compile_lib(
        text.replace(BOUND, f"__launch_bounds__(kThreads, kKeep ? 1 : {b})"),
        f"b{b}") for b in filter(None, args.stream_blocks.split(","))}
    for shape, form, dtype, n in SHAPES:
        xs, r = inputs(form, dtype, n, seed=n)
        want = ss.segmented_scan_plain(form, xs[0], r, *xs[1:])
        two = form in ss.TWO_FLOAT
        legs = {"other": other_leg(other, form, dtype, n)}
        legs.update({k: variant_leg(v, form, dtype, n)
                     for k, v in variants.items()})
        row = {"shape": shape, "form": f"{form}_{_SUFFIX[dtype]}",
               "rows": n}
        order = ["other", "this", *variants, "this", "other"]
        for leg in order:
            if leg == "this":
                def run():
                    return ss.segmented_scan(form, xs[0], r, *xs[1:])
                got = run()
            else:
                out = torch.empty((2, n) if two else (n,), dtype=xs[0].dtype,
                                  device="cuda")

                def run(call=legs[leg], out=out):
                    if call(xs, r, out):
                        raise RuntimeError(f"s_compare: {leg} refused")
                    return out
                got = run()
            torch.cuda.synchronize()
            exact = torch.equal(got.view(torch.uint8), want.view(torch.uint8)
                                ) if got.is_floating_point() else torch.equal(
                                    got, want)
            if not exact:
                raise SystemExit(f"s_compare: {leg} differs from the plain "
                                 f"scan at {row['form']} {n}")
            row.setdefault(leg, []).append(timings(run))
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
