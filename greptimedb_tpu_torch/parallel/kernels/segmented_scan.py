"""S: the segmented scans of SQL window running frames, in JAX's tree.

The JAX package runs each running frame of a window function as a
jax.lax.associative_scan over (value..., flag) cells, the flag marking the
first row of a partition (greptimedb_tpu/ops/segment.py:211-292). The scan
adds in the fixed combine tree of associative_scan's odd/even recursion,
which is Brent and Kung's in-place scan: an up-sweep, for L = 1, 2, ...
while 2^L <= n, of a[i] = comb(a[i - 2^(L-1)], a[i]) at i = m 2^L - 1
(m >= 1), then a down-sweep, for L from the top level down to 1, of the
same combine at i = m 2^L + 2^(L-1) - 1 (m >= 1). The float bits rest on
that tree, and no torch call adds in it (torch.cumsum is sequential), so
the card runs one hand kernel for every form (csrc/segmented_scan.cu):

- "add": int32, int64 or float64 values (segmented_cumsum);
- "max" / "min": float64 values, XLA's maximum/minimum
  (segmented_cumextreme);
- "comp": the two-float compensated sum of float32 (hi, lo) pairs
  (segmented_cumsum_compensated);
- "max2" / "min2": the lexicographic extreme of float32 (hi, lo) pairs
  (segmented_cumextreme2).

associative_scan also adds +0.0 to every output of a scan of two or more
cells (its interleave), which turns -0.0 into +0.0; S writes its outputs
the same way (`positive_zero`).

`segmented_scan_plain` is the plain PyTorch version: the same tree, one
vectorized step a level. It runs for CPU tensors; on a CUDA tensor
`segmented_scan` launches the kernel (one cooperative launch a scan) or
raises, with the CUDA error when the card refuses the launch.
"""

from __future__ import annotations

import ctypes

import torch

from greptimedb_tpu_torch.parallel.kernels import build
from greptimedb_tpu_torch.parallel.kernels.ring_fold import extreme_plain

_PTR = ctypes.c_void_p
_LL = ctypes.c_longlong
# form -> the value dtypes it takes; the two-float forms take (hi, lo)
FORMS = {
    "add": (torch.int32, torch.int64, torch.float64),
    "max": (torch.float64,),
    "min": (torch.float64,),
    "comp": (torch.float32,),
    "max2": (torch.float32,),
    "min2": (torch.float32,),
}
TWO_FLOAT = ("comp", "max2", "min2")
_SUFFIX = {torch.int32: "i32", torch.int64: "i64", torch.float64: "f64",
           torch.float32: "f32"}


# ----------------------------------------------------------------------
# the combines, as jnp computes them in ops/segment.py
# ----------------------------------------------------------------------

def _comb_add(a, b):
    av, af = a
    bv, bf = b
    return torch.where(bf, bv, av + bv), af | bf


def _comb_ext(take_max):
    def comb(a, b):
        av, af = a
        bv, bf = b
        return torch.where(bf, bv, extreme_plain(av, bv, take_max)), af | bf
    return comb


def _comb_comp(a, b):
    a_s, a_c, a_f = a
    b_s, b_c, b_f = b
    t = a_s + b_s
    e = torch.where(a_s.abs() >= b_s.abs(), (a_s - t) + b_s,
                    (b_s - t) + a_s)
    return (torch.where(b_f, b_s, t), torch.where(b_f, b_c, a_c + b_c + e),
            a_f | b_f)


def _comb_ext2(take_max):
    def comb(a, b):
        ah, al, af = a
        bh, bl, bf = b
        if take_max:
            pick_a = (ah > bh) | ((ah == bh) & (al >= bl))
        else:
            pick_a = (ah < bh) | ((ah == bh) & (al <= bl))
        mh = torch.where(pick_a, ah, bh)
        ml = torch.where(pick_a, al, bl)
        return torch.where(bf, bh, mh), torch.where(bf, bl, ml), af | bf
    return comb


COMBINES = {"add": _comb_add, "max": _comb_ext(True),
            "min": _comb_ext(False), "comp": _comb_comp,
            "max2": _comb_ext2(True), "min2": _comb_ext2(False)}


# ----------------------------------------------------------------------
# plain version (the CPU path, and the card's reference)
# ----------------------------------------------------------------------

def _level(cells: list, comb, first: int, stride: int, half: int) -> None:
    """One level of the tree: cell i = first, first + stride, ... takes
    comb(cell i - half, cell i). The targets and their left cells are
    disjoint strided views, so the level is one vectorized step."""
    n = cells[0].numel()
    if first >= n:
        return
    right = [c[first::stride] for c in cells]
    k = right[0].numel()
    left = [c[first - half::stride][:k] for c in cells]
    for dst, val in zip(right, comb(left, right)):
        dst.copy_(val)


def tree_scan(cells: tuple, comb) -> list:
    """associative_scan's combine tree over 1-D cells (copies): the
    up-sweep, then the down-sweep."""
    cells = [c.clone() for c in cells]
    n = cells[0].numel()
    lev = 1
    while (1 << lev) <= n:
        stride = 1 << lev
        _level(cells, comb, stride - 1, stride, stride >> 1)
        lev += 1
    for lev in range(lev - 1, 0, -1):
        stride = 1 << lev
        half = stride >> 1
        _level(cells, comb, stride + half - 1, stride, half)
    return cells


def positive_zero(x: torch.Tensor) -> torch.Tensor:
    """-0.0 as +0.0, every other value as it is. associative_scan
    interleaves each level's halves by adding two zero-padded arrays, so
    every output of a scan of two or more cells passed through x + 0.0:
    its -0.0 came out +0.0 (and its quiet NaNs unchanged). Zero signs are
    the only difference that this makes inside the tree (every combine
    gives the same value on -0.0 and +0.0 up to the sign of a zero
    result), so applying it once to the outputs gives XLA's bits."""
    if not x.dtype.is_floating_point:
        return x
    return torch.where(x == 0, torch.zeros_like(x), x)


def segmented_scan_plain(form: str, x: torch.Tensor, reset: torch.Tensor,
                         lo: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of S: (n,) for the one-value forms, (2, n)
    (sum and compensation, or hi and lo) for the two-float forms."""
    cells = (x,) if lo is None else (x, lo)
    out = tree_scan((*cells, reset), COMBINES[form])[:len(cells)]
    if x.numel() > 1:
        out = [positive_zero(o) for o in out]
    if form in TWO_FLOAT:
        return torch.stack(out)
    return out[0]


# ----------------------------------------------------------------------
# kernel wrapper: launch on a CUDA tensor, plain version on a CPU one
# ----------------------------------------------------------------------

def _check(form: str, x: torch.Tensor, reset: torch.Tensor,
           lo: torch.Tensor | None) -> None:
    dtypes = FORMS.get(form)
    if dtypes is None:
        raise ValueError(f"segmented_scan form {form!r} is not one of "
                         f"{tuple(FORMS)}")
    ins = (x, reset) if lo is None else (x, lo, reset)
    if (x.dtype not in dtypes or x.dim() != 1 or reset.dtype != torch.bool
            or (lo is None) == (form in TWO_FLOAT)
            or (lo is not None and lo.dtype != x.dtype)
            or any(t.shape != x.shape for t in ins)):
        got = [(t.dtype, tuple(t.shape)) for t in ins]
        raise TypeError(
            f"segmented_scan {form} takes 1-D values of {dtypes}"
            f"{' (hi and lo)' if form in TWO_FLOAT else ''} and a bool "
            f"reset of one length, not {got}")
    if any(t.device != x.device for t in ins):
        raise ValueError("segmented_scan takes its inputs on one device")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("segmented_scan takes contiguous inputs")


# blocks of a launch; 0: as many as the card holds at once (a larger
# cooperative grid is refused by the card, and the wrapper raises)
GRID = 0
# (device, symbol) -> (rows, scratch bytes) of the largest scan sized so far
_sized: dict = {}


def _scratch_bytes(lib, symbol: str, dev, n: int) -> int:
    """Bytes of the tiles' totals that n rows need (the library's own
    count, asked only when n exceeds the rows sized so far: the count
    only grows with n)."""
    rows, nbytes = _sized.get((dev, symbol), (-1, 0))
    if n > rows:
        fn = getattr(lib, f"{symbol}_scratch_bytes")
        fn.argtypes = [_LL]
        fn.restype = _LL
        nbytes = int(fn(n))
        _sized[dev, symbol] = (n, nbytes)
    return nbytes


def tile_rows() -> int:
    """Rows a block of the kernel scans at once (its kTile)."""
    lib = build.load("segmented_scan")
    lib.gtt_segscan_tile.restype = ctypes.c_int
    return int(lib.gtt_segscan_tile())


def resident_tiles(form: str, dtype: torch.dtype, device) -> int:
    """The most tiles whose scan the card of `device` runs in the
    resident form (each block keeps its one tile in registers from the
    up-sweep to the down-sweep): the blocks that it holds at once."""
    lib = build.load("segmented_scan")
    fn = getattr(lib, f"gtt_segscan_{form}_{_SUFFIX[dtype]}_resident_tiles")
    fn.restype = _LL
    got = int(build.on_card(torch.device(device).index or 0, fn))
    if got < 0:
        raise RuntimeError("segmented_scan: the card's occupancy could not "
                           "be asked")
    return got


def segmented_scan(form: str, x: torch.Tensor, reset: torch.Tensor,
                   lo: torch.Tensor | None = None) -> torch.Tensor:
    """S over the rows of `x` (and `lo` for the two-float forms),
    restarting at every row whose `reset` is set: (n,) for "add", "max"
    and "min", (2, n) for "comp" (sum, compensation) and "max2"/"min2"
    (hi, lo). On the card: one cooperative launch, its totals in the
    (device, stream) scratch (build.stream_scratch)."""
    _check(form, x, reset, lo)
    if x.is_cpu:
        return segmented_scan_plain(form, x, reset, lo)
    n = x.numel()
    if n >= 1 << 31:
        raise ValueError(f"segmented_scan takes fewer than 2^31 rows, "
                         f"not {n}")
    two = form in TWO_FLOAT
    out = torch.empty((2, n) if two else (n,), dtype=x.dtype,
                      device=x.device)
    if n == 0:
        return out
    symbol = f"gtt_segscan_{form}_{_SUFFIX[x.dtype]}"
    lib, fn = build.entry("segmented_scan", symbol,
                          (_PTR,) * 6 + (_LL, _LL, ctypes.c_int))
    index = x.get_device()
    with build.scratch_lock:
        stream = build.stream(index)
        sc = build.stream_scratch(x.device, stream)
        ptr, _ = sc.take(_scratch_bytes(lib, symbol, x.device, n), 0)
        rc = build.on_card(index, fn, x.data_ptr(),
                           lo.data_ptr() if two else None, reset.data_ptr(),
                           out[0].data_ptr() if two else out.data_ptr(),
                           out[1].data_ptr() if two else None, ptr,
                           sc.part.numel(), n, GRID, stream)
    if rc:
        build.check_launch(lib, rc, "segmented_scan")
    segmented_scan.launches += 1
    return out


segmented_scan.launches = 0
