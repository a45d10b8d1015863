"""The port's launch path binding (greptimedb_tpu_torch/parallel/kernels/
build.py) on the CPU, with stand-in libraries: nothing is compiled."""

from __future__ import annotations

import ctypes
import types

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
