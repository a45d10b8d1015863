"""The port's launch path binding and per-stream scratch
(greptimedb_tpu_torch/parallel/kernels/build.py) on the CPU, with stand-in
libraries: nothing is compiled."""

from __future__ import annotations

import ctypes
import types

import torch

from greptimedb_tpu_torch.parallel.kernels import build


def test_entry_binds_each_library_s_symbol_apart(monkeypatch):
    """Every library exports gtt_error_string: `entry` keeps one launcher
    per (source, symbol), loads a library once and types its launcher
    once, with the stream as the trailing argument."""
    loads = []

    def load(source):
        loads.append(source)
        return types.SimpleNamespace(
            gtt_error_string=types.SimpleNamespace(source=source))

    monkeypatch.setattr(build, "load", load)
    monkeypatch.setattr(build, "_entries", {})
    a = build.entry("ring_fold", "gtt_error_string", (ctypes.c_int,))
    b = build.entry("topk_merge", "gtt_error_string", (ctypes.c_int,))
    assert a[1].source == "ring_fold" and b[1].source == "topk_merge"
    assert build.entry("ring_fold", "gtt_error_string", ()) is a
    assert loads == ["ring_fold", "topk_merge"]
    assert a[1].argtypes == [ctypes.c_int, ctypes.c_void_p]
    assert a[1].restype is ctypes.c_int


def test_stream_scratch_is_kept_per_stream_and_only_grows(monkeypatch):
    """One scratch per (device, stream), shared by every kernel that takes
    one: untyped partial bytes and zeroed int32 counts, grown on demand and
    never shrunk, so a smaller request reuses the same buffers."""
    monkeypatch.setattr(build, "scratches", {})
    dev = torch.device("cpu")
    sc = build.stream_scratch(dev, 7)
    assert build.stream_scratch(dev, 7) is sc
    assert build.stream_scratch(dev, 8) is not sc
    part, count = sc.take(40, 3)
    assert sc.part.dtype == torch.uint8 and sc.part.numel() == 40
    assert sc.count.dtype == torch.int32 and not sc.count.any()
    assert (part, count) == (sc.part.data_ptr(), sc.count.data_ptr())
    assert sc.take(8, 1) == (part, count)
    sc.take(100, 5)
    assert sc.part.numel() == 100 and sc.count.numel() == 5
