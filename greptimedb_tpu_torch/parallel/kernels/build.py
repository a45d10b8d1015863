"""Build the CUDA kernels from the package's own sources and load them.

Each source in csrc/ compiles with nvcc for sm_90a into a shared library
with a plain C interface, loaded with ctypes (no PyTorch headers, so a
build takes seconds). Libraries land in greptimedb_tpu_torch/_build/,
named by a hash of the source and the flags, so an edited source rebuilds
and an unchanged one is reused. `build_all` starts one nvcc per source at
once and waits for all of them.

Nothing here runs at import time: the kernel wrappers call `load` the
first time they launch on a CUDA tensor.

The launch path is bound once per symbol (`entry`: library, symbol,
argtypes) and called on the caller's current stream of the tensors' card
(`launch`), so that a launch costs the ctypes call alone.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from greptimedb_tpu_torch.device import native_available

SOURCES = ("merge_gather", "ring_fold", "ring_fold_fused", "topk_merge",
           "grouped_reduce", "segmented_scan")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# flags of one source on top of NVCC_FLAGS: S's bit contract is its IEEE
# operations one by one, so nvcc contracts nothing there
SOURCE_FLAGS = {"segmented_scan": ("-fmad=false",)}

_PKG = Path(__file__).resolve().parents[2]
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = _PKG / "_build"

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# per-source compiler output (ptxas register/spill report) and build time
build_log: dict[str, str] = {}
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names=SOURCES) -> dict[str, float]:
    """Compile every missing library in `names` concurrently (one nvcc
    each). Returns {name: seconds} for the ones built; raises with the
    compiler output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(name), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        ), tmp, out, time.perf_counter())
    built = {}
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        built[name] = build_seconds[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return built


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not native_available():
                raise RuntimeError(
                    "the CUDA kernels are built for sm_90a and need a "
                    "Hopper card (compute capability 9.x)")
            path = lib_path(name)
            if not path.exists():
                build_all((name,))
            lib = ctypes.CDLL(str(path))
            lib.gtt_error_string.argtypes = [ctypes.c_int]
            lib.gtt_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a launch reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc != 0:
        msg = lib.gtt_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA launch failed ({rc}): {msg}")


# up to 8 shard pointers travel by value in a kernel parameter (FOLD_BLOCKS:
# a ring shard holds >= 1 series block)
MAX_SHARDS = 8
SHARD_PTRS = ctypes.c_void_p * MAX_SHARDS

_entries: dict = {}


def entry(source: str, symbol: str, argtypes: tuple):
    """(library, launcher) of one kernel symbol: loaded, looked up and
    typed on its first call and kept. `argtypes` leaves out the trailing
    stream."""
    found = _entries.get((source, symbol))
    if found is None:
        lib = load(source)
        fn = getattr(lib, symbol)
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        found = _entries[source, symbol] = (lib, fn)
    return found


def stream(index: int) -> int:
    """The caller's current stream on card `index`, as a raw handle."""
    return torch._C._cuda_getCurrentRawStream(index)


def on_card(index: int, fn, *args) -> int:
    """fn(*args) with card `index` current: a kernel launches on the
    current device, into a stream of that device. The device context is
    entered only when another card is current."""
    if torch._C._cuda_getDevice() == index:
        return fn(*args)
    with torch.cuda.device(index):
        return fn(*args)


class StreamScratch:
    """Device scratch of one (device, stream), kept from launch to launch
    and shared in stream order by the kernels that need one (ring_fold's
    walk forms, grouped_reduce's column tree sum): untyped bytes for
    partials and int32 arrival counts, one per tile. Both only grow; every
    launch leaves the counts at 0."""

    def __init__(self, dev):
        self.part = torch.empty(0, dtype=torch.uint8, device=dev)
        self.count = torch.empty(0, dtype=torch.int32, device=dev)

    def take(self, part_bytes: int, counts: int) -> tuple:
        """(partials, counts) pointers of at least `part_bytes` bytes and
        `counts` zeroed counts."""
        if self.part.numel() < part_bytes:
            self.part = torch.empty(part_bytes, dtype=torch.uint8,
                                    device=self.part.device)
        if self.count.numel() < counts:
            self.count = torch.zeros(counts, dtype=torch.int32,
                                     device=self.count.device)
        return self.part.data_ptr(), self.count.data_ptr()


# {(device, stream): StreamScratch}
scratches: dict = {}
# one launch at a time takes a scratch and launches: a buffer that grows
# is freed on its stream, so no launch may still hold its pointer
scratch_lock = threading.Lock()


def stream_scratch(dev, stream_handle: int) -> StreamScratch:
    """The scratch of (dev, stream_handle); the caller holds scratch_lock
    until its launch is issued."""
    sc = scratches.get((dev, stream_handle))
    if sc is None:
        sc = scratches[dev, stream_handle] = StreamScratch(dev)
    return sc


def launch(bound, what: str, index: int, *args) -> None:
    """Launch a bound launcher (`entry`) on the current stream of card
    `index` and raise if the launch was refused."""
    lib, fn = bound
    rc = on_card(index, fn, *args, stream(index))
    if rc:
        check_launch(lib, rc, what)
