#!/usr/bin/env python3
"""Time K2 (blocked_fold_sum) of this tree against another checkout's
on one CUDA card, in one process, in turns: other, this, this, other.

    python3 k2_compare.py --other DIR [--reps 50] [--seed 0]

DIR holds another checkout of the repository (for instance the parent
commit, unpacked with `git archive <rev> | tar -x -C DIR`). Its
csrc/ring_fold.cu is compiled with this tree's nvcc flags and its
`gtt_blocked_fold_sum_f32` is called through ctypes with that file's
earlier C interface (arr, member, ptr, out, g, fb, nb, stream); this
tree's K2 runs through its wrapper. Three shapes, from seeded data:

- q2: the one-device Q2 of chip_smoke.py phase 2 (4000 series, 9
  regions, 4320 ten-second cells, 8 series blocks);
- mesh_shard: one shard of phase 6's mesh Q2 (2048 series, 9 regions,
  2160 cells, 2 series blocks), the hop ring's seed;
- promql_c: the count of `max by (dc) (deriv(prom_bench[2m]))` over
  1,000,000 series padded to 2^20 (dc = i % 32, 8 steps, 8 blocks, 33
  groups, the padding in group 32), once with the member lists that list
  the padding (`with_padding`) and once without it (`fast_lists`, what
  promql/fast._fold_members builds), the other kernel on both.

Where this tree's K2 picks its per-cell form (q2, mesh_shard), its
staged form runs too (`this_staged`: the launcher called with the form
set, as the wrapper would call it), so both sides of the form rule are
timed. Every output is held bit for bit against the plain version (and
the kernels against each other on the same lists). Prints one JSON line
per leg (CUDA-event median ms of one launch and profiler device ms a
launch) and the card's name and power limit; exits non-zero without a
card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch


def other_kernel(root: Path, index: int):
    """The other checkout's float32 K2 launcher, built into its _build."""
    from greptimedb_tpu_torch.parallel.kernels import build

    src = root / "greptimedb_tpu_torch/parallel/kernels/csrc/ring_fold.cu"
    out = root / "greptimedb_tpu_torch/_build/libring_fold_other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    fn = lib.gtt_blocked_fold_sum_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(arr, fm):
        out_t = torch.empty((fm.g, arr.shape[1]), dtype=arr.dtype,
                            device=arr.device)
        rc = fn(arr.data_ptr(), fm.member.data_ptr(), fm.ptr.data_ptr(),
                out_t.data_ptr(), fm.g, fm.fb, arr.shape[1],
                build.stream(index))
        if rc:
            raise RuntimeError(f"the other K2 failed to launch ({rc})")
        return out_t
    return run


def this_staged(arr, fm):
    """This tree's K2 in its staged form whatever the shape: the
    wrapper's launch with the form set."""
    from greptimedb_tpu_torch.parallel.kernels import build
    from greptimedb_tpu_torch.parallel.kernels import ring_fold as rf

    g, fb, nb = fm.g, fm.fb, arr.shape[1]
    out = torch.empty((g, nb), dtype=arr.dtype, device=arr.device)
    index = arr.get_device()
    lib, fn = build.entry("ring_fold", "gtt_blocked_fold_sum_f32",
                          (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 4)
    with build.scratch_lock:
        stream = build.stream(index)
        part, count = build.stream_scratch(arr.device, stream).take(
            4 * fb * g * nb, g * -(-nb // rf._FUSED_CELLS))
        rc = fn(arr.data_ptr(), fm.member.data_ptr(), fm.ptr.data_ptr(),
                out.data_ptr(), part, count, g, fb, nb,
                rf._K2_FORMS["staged"], stream)
    if rc:
        build.check_launch(lib, rc, "blocked_fold_sum (staged)")
    return out


def shapes(rng, dev):
    """{name: (arr, {lists: FoldMembers})} from seeded data."""
    from greptimedb_tpu_torch.parallel.kernels import ring_fold as rf

    out = {}
    s, nb, g = 4000, 4320, 9
    arr = rng.standard_normal((s, nb)).astype(np.float32)
    gid = rng.integers(0, g, s)
    out["q2"] = (torch.from_numpy(arr).to(dev),
                 {"q2": rf.fold_members(gid, g, 8, dev)})
    s, nb = 2048, 2160
    arr = rng.standard_normal((s, nb)).astype(np.float32)
    gid = rng.integers(0, g, s)
    out["mesh_shard"] = (torch.from_numpy(arr).to(dev),
                         {"mesh_shard": rf.fold_members(gid, g, 2, dev)})
    s, n, g = 1 << 20, 1_000_000, 32
    present = (rng.random((s, 8)) < 0.97).astype(np.float32)
    present[n:] = 0.0
    sid = np.arange(s)
    gid = np.where(sid < n, sid % 32, g)
    out["promql_c"] = (torch.from_numpy(present).to(dev), {
        "with_padding": rf.fold_members(gid, g + 1, 8, dev),
        "fast_lists": rf.fold_members(np.where(gid < g, gid, g + 1), g + 1,
                                      8, dev),
    })
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="another checkout of the repository")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k2_compare: no CUDA card", file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    import chip_smoke as cs
    from greptimedb_tpu_torch.parallel.kernels import build
    from greptimedb_tpu_torch.parallel.kernels import ring_fold as rf

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build.build_all(("ring_fold",))
    other = other_kernel(Path(args.other).resolve(), dev.index or 0)
    add_ns = cs.add_chain_ns(dev)
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "dependent_add_ns": add_ns}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    for name, (arr, lists) in shapes(np.random.default_rng(args.seed),
                                     dev).items():
        for lname, fm in lists.items():
            kernels = {"other": other, "this": rf.blocked_fold_sum}
            form = rf.blocked_fold_form(fm.g, arr.shape[1], fm.member.numel())
            if form == "cells":
                kernels["this_staged"] = this_staged
            want = rf.blocked_fold_sum_plain(arr, fm)
            got = {k: fn(arr, fm) for k, fn in kernels.items()}
            torch.cuda.synchronize()
            for k, t in got.items():
                if not torch.equal(t.view(torch.int32),
                                   want.view(torch.int32)):
                    raise AssertionError(f"{k} K2 differs from the plain "
                                         f"version on {name}/{lname}")
            legs = ["other", "this", "this", "other"]
            if "this_staged" in kernels:
                legs[2:2] = ["this_staged", "this_staged"]
            for leg, k in enumerate(legs):
                fn = kernels[k]
                prof = cs.profiled(lambda: [fn(arr, fm) for _ in range(10)],
                                   top=2)
                print(json.dumps({
                    "shape": name, "lists": lname, "leg": leg, "kernel": k,
                    "form": {"other": "cells", "this": form,
                             "this_staged": "staged"}[k],
                    "ms": cs.cuda_ms(lambda: fn(arr, fm), reps=args.reps),
                    "device_ms_per_launch": cs.device_ms_per_launch(
                        prof, cs.is_seed_kernel),
                    **cs.k2_bound(fm, arr.shape[1], add_ns),
                }), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
