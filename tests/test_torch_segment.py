"""The segmented scans (the port's ops/segment.py over kernel S's plain
version) against the JAX package's ops/segment.py on the CPU.

Every case feeds the same seeded inputs to both packages and holds the
port's result to the JAX package's bit for bit: at n in {1, 2, 3, 5, 31,
33, 4097, 263520} (263,520 rows is bench.py's window metric shape), with
random resets, a reset on every row and a reset on row 0 only; large
values with tiny increments for the compensated form; NaN, +-0.0 and
+-inf for the float64 (x64) forms. Where two NaN payloads of different
signs meet in one float64 add (an input NaN, or the default NaN of
inf + -inf), which survives is the compiler's choice on both sides
(ROADMAP C2's NaN bits), so those sums hold the NaN positions and every
other cell's bits; with one NaN payload and one sign of inf they are
exact, and the extremes always are.

Kernel S cuts the tree at tiles (csrc/segmented_scan.cu): a tile-local
up-sweep, the same scan over the tiles' last cells, a tile-local
down-sweep. `_tiled` models that order at any tile size, and it must
equal the level order bit for bit. Inside a tile the kernel splits the
levels again: a thread's 2^j contiguous cells in registers, its warp's
lanes' last cells by shuffles, one warp over the warps' last cells, and
the down-sweep back with the previous thread's, warp's or tile's last
cell. `_split_scan` models that split (at the card's 16 cells x 32 lanes x
8 warps and at smaller ones, so that the totals need two levels and more
at test sizes), and it must equal the level order and the JAX package's
associative_scan bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from greptimedb_tpu.ops import segment as JS
from greptimedb_tpu_torch.ops import segment as TS
from greptimedb_tpu_torch.parallel.kernels import segmented_scan as SS

SIZES = [1, 2, 3, 5, 31, 33, 4097, 263_520]
RESETS = ["random", "every_row", "row0_only"]


def _reset(rng, n, kind):
    if kind == "every_row":
        return np.ones(n, bool)
    if kind == "row0_only":
        r = np.zeros(n, bool)
        r[0] = True
        return r
    r = rng.random(n) < 0.01
    r[0] = rng.random() < 0.5     # a scan may start mid-segment
    return r


def _bits(a):
    a = np.asarray(a)
    if a.dtype.kind == "f":
        return a.view(np.uint64 if a.dtype.itemsize == 8 else np.uint32)
    return a


def _same(want, got, nan_positions=False):
    want, got = np.asarray(want), np.asarray(got)
    assert want.dtype == got.dtype and want.shape == got.shape
    if nan_positions:
        nan = np.isnan(want)
        assert np.array_equal(nan, np.isnan(got))
        want, got = want[~nan], got[~nan]
    assert np.array_equal(_bits(want), _bits(got))


def _split(v):
    hi = v.astype(np.float32)
    lo = np.where(np.isfinite(hi), v - hi.astype(np.float64),
                  0.0).astype(np.float32)
    return hi, lo


def _run(fn, *arrays, **kw):
    """(JAX result, port result) as numpy arrays (tuples for pairs)."""
    want = getattr(JS, fn)(*(jnp.asarray(a) for a in arrays), **kw)
    got = getattr(TS, fn)(*(torch.from_numpy(np.ascontiguousarray(a))
                            for a in arrays), **kw)
    if isinstance(want, tuple):
        return ([np.asarray(w) for w in want],
                [g.numpy() for g in got])
    return [np.asarray(want)], [got.numpy()]


@pytest.mark.parametrize("reset", RESETS)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float64])
def test_segmented_cumsum_matches_jax(dtype, n, reset):
    rng = np.random.default_rng(n)
    r = _reset(rng, n, reset)
    if dtype == np.float64:
        v = rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n)
    else:
        # wide words: int32 running sums wrap, as XLA's do
        info = np.iinfo(dtype)
        v = rng.integers(info.min // 4, info.max // 4, n, dtype=dtype)
    want, got = _run("segmented_cumsum", v, r)
    _same(want[0], got[0])


@pytest.mark.parametrize("take_max", [True, False], ids=["max", "min"])
@pytest.mark.parametrize("reset", RESETS)
@pytest.mark.parametrize("n", SIZES)
def test_segmented_cumextreme_matches_jax(n, reset, take_max):
    rng = np.random.default_rng(n + 1)
    r = _reset(rng, n, reset)
    v = np.round(rng.standard_normal(n), 1)     # ties
    want, got = _run("segmented_cumextreme", v, r, take_max=take_max)
    _same(want[0], got[0])


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "pair"])
@pytest.mark.parametrize("reset", RESETS)
@pytest.mark.parametrize("n", SIZES)
def test_segmented_cumsum_compensated_matches_jax(n, reset, packed):
    rng = np.random.default_rng(n + 2)
    r = _reset(rng, n, reset)
    # large magnitudes plus tiny increments, both signs: the low parts
    # and the two-sum residues carry what float32 drops
    v = (rng.random(n) * 1e6 + rng.random(n) * 1e-3) * np.where(
        rng.random(n) < 0.3, -1.0, 1.0)
    hi, lo = _split(v)
    fn = ("segmented_cumsum_compensated_packed" if packed
          else "segmented_cumsum_compensated")
    want, got = _run(fn, hi, lo, r)
    for w, g in zip(want, got):
        _same(w, g)


@pytest.mark.parametrize("take_max", [True, False], ids=["max", "min"])
@pytest.mark.parametrize("reset", RESETS)
@pytest.mark.parametrize("n", SIZES)
def test_segmented_cumextreme2_matches_jax(n, reset, take_max):
    rng = np.random.default_rng(n + 3)
    r = _reset(rng, n, reset)
    # values whose float32 roundings tie, ordered by their low parts
    base = rng.integers(0, 50, n).astype(np.float64) * 1e6
    v = base + rng.integers(0, 4, n) * 1e-3
    hi, lo = _split(v)
    want, got = _run("segmented_cumextreme2", hi, lo, r, take_max=take_max)
    for w, g in zip(want, got):
        _same(w, g)


def _specials(rng, n, nan_signs):
    """Values with +-0.0, NaN and inf. With one NaN sign there is no
    -inf either: inf + -inf makes the CPU's default NaN, whose sign is
    negative, and that NaN would meet the input's."""
    v = rng.standard_normal(n)
    pick = rng.random(n)
    v[pick < 0.03] = np.inf
    v[(pick >= 0.03) & (pick < 0.06)] = -np.inf if nan_signs == 2 else 7.0
    v[(pick >= 0.06) & (pick < 0.10)] = 0.0
    v[(pick >= 0.10) & (pick < 0.14)] = -0.0
    nan = (pick >= 0.14) & (pick < 0.17)
    v[nan] = np.nan
    if nan_signs == 2:
        neg = nan & (rng.random(n) < 0.5)
        v[neg] = -np.nan
    return v


@pytest.mark.parametrize("nan_signs", [1, 2], ids=["one_nan", "both_nans"])
@pytest.mark.parametrize("reset", RESETS)
@pytest.mark.parametrize("n", [33, 4097])
def test_x64_forms_on_nan_zero_and_inf(n, reset, nan_signs):
    rng = np.random.default_rng(n + nan_signs)
    r = _reset(rng, n, reset)
    v = _specials(rng, n, nan_signs)
    want, got = _run("segmented_cumsum", v, r)
    _same(want[0], got[0], nan_positions=nan_signs == 2)
    for take_max in (True, False):
        # extremes select operands: every NaN payload passes, exact
        want, got = _run("segmented_cumextreme", v, r, take_max=take_max)
        _same(want[0], got[0])


# ----------------------------------------------------------------------
# the kernel's tiled order against the level order
# ----------------------------------------------------------------------

def _up(rows, comb, length):
    """Up-sweep every row (tile) of `rows` over its first `length` cells."""
    lev = 1
    while (1 << lev) <= length:
        s, h = 1 << lev, 1 << (lev - 1)
        right = [t[:, s - 1:length:s] for t in rows]
        k = right[0].shape[1]
        left = [t[:, h - 1:length:s][:, :k] for t in rows]
        for dst, val in zip(right, comb(left, right)):
            dst.copy_(val)
        lev += 1


def _down(rows, comb, length, tile_log, first_tile):
    """Down-sweep levels tile_log .. 1 of tiles whose column 0 holds the
    previous tile's scanned last cell (the tile's cells follow it); the
    first tile of the array starts at m = 1."""
    for lev in range(tile_log, 0, -1):
        s, h = 1 << lev, 1 << (lev - 1)
        start = h + s if first_tile else h      # column of m * s + h - 1
        right = [t[:, start:length + 1:s] for t in rows]
        k = right[0].shape[1]
        src = s if first_tile else 0            # column of m * s - 1
        left = [t[:, src::s][:, :k] for t in rows]
        for dst, val in zip(right, comb(left, right)):
            dst.copy_(val)


def _tiled(cells, comb, tile):
    """associative_scan's tree in kernel S's three phases at `tile`."""
    tile_log = tile.bit_length() - 1
    n = cells[0].numel()
    full, tiles = n // tile, -(-n // tile)
    pad = tiles * tile - n
    rows = [torch.cat([c, c[:1].expand(pad)]).view(tiles, tile).clone()
            for c in cells]
    # phase 1: the full tiles' totals
    aux = None
    if tiles > 1:
        up = [r[:full].clone() for r in rows]
        _up(up, comb, tile)
        aux = [u[:, -1].contiguous() for u in up]
        if full > 1:
            aux = _tiled(aux, comb, tile)
    # phase 3: every tile again, its last cell and the previous one's
    out = []
    for t in range(tiles):
        length = min(tile, n - t * tile)
        row = [torch.cat([r[t, :1], r[t]])[None].clone() for r in rows]
        _up([x[:, 1:] for x in row], comb, length)
        if aux is not None:
            for x, a in zip(row, aux):
                if t > 0:
                    x[0, 0] = a[t - 1]
                if length == tile:
                    x[0, tile] = a[t]
        _down(row, comb, length, tile_log, t == 0)
        out.append([x[0, 1:length + 1] for x in row])
    return [torch.cat([o[i] for o in out]) for i in range(len(cells))]


@pytest.mark.parametrize("n", [1, 3, 33, 100, 4097, 20_000])
@pytest.mark.parametrize("tile", [2, 8, 32, 2048, 4096])
def test_tiled_order_equals_level_order(tile, n):
    rng = np.random.default_rng(tile * 7 + n)
    r = torch.from_numpy(_reset(rng, n, "random"))
    v = rng.random(n) * 1e6 + rng.random(n) * 1e-3
    hi, lo = (torch.from_numpy(a) for a in _split(v))
    f64 = torch.from_numpy(rng.standard_normal(n))
    for form, cells in (("add", (f64, r)), ("max", (f64, r)),
                        ("comp", (hi, lo, r)), ("min2", (hi, lo, r))):
        comb = SS.COMBINES[form]
        want = SS.tree_scan(cells, comb)
        got = _tiled(cells, comb, tile)
        for w, g in zip(want, got):
            _same(w.numpy(), g.numpy())


# ----------------------------------------------------------------------
# the kernel's thread, warp and block split against the level order
# ----------------------------------------------------------------------

def _up_last(fields, comb, log):
    """Up-sweep levels 1 .. log over the last axis (2^log cells) of every
    row of `fields`, in place."""
    for lev in range(1, log + 1):
        s, h = 1 << lev, 1 << (lev - 1)
        right = [t[..., s - 1::s] for t in fields]
        left = [t[..., h - 1::s] for t in fields]
        for dst, val in zip(right, comb(left, right)):
            dst.copy_(val)


def _down_last(fields, comb, log, prev, skip):
    """Down-sweep levels log .. 1 over the last axis, in place. A level's
    first target (m = 0) takes `prev`, the final cell before the row, as
    its left cell, except in the rows where `skip` is set (the array's
    first: there m starts at 1)."""
    for lev in range(log, 0, -1):
        s, h = 1 << lev, 1 << (lev - 1)
        right = [t[..., h - 1::s] for t in fields]
        k = right[0].shape[-1]
        left = [torch.cat([p[..., None], t], -1)[..., 0::s][..., :k]
                for p, t in zip(prev, fields)]
        m0 = torch.zeros(k, dtype=torch.bool)
        m0[0] = True
        keep = skip[..., None] & m0
        for dst, val in zip(right, comb(left, right)):
            dst.copy_(torch.where(keep, dst, val))


def _split_scan(cells, comb, cells_log, lane_log, warp_log):
    """associative_scan's tree as kernel S splits it: tiles of
    2^(cells_log + lane_log + warp_log) cells; in a tile, levels
    1 .. cells_log on each thread's 2^cells_log cells, the next lane_log
    on the lanes' last cells (the shuffles), the rest on the warps' last
    cells (warp 0); the full tiles' totals scanned by the same scheme;
    then the down-sweep, warp level, lanes, threads, each level's first
    target taking the last cell of the tile, warp or thread before."""
    C, L, W = 1 << cells_log, 1 << lane_log, 1 << warp_log
    T = C * L * W
    n = cells[0].numel()
    tiles, full = -(-n // T), n // T
    rows = [torch.cat([c, torch.zeros(tiles * T - n, dtype=c.dtype)])
            .view(tiles, W * L, C) for c in cells]
    lanes = [r[..., C - 1].view(tiles, W, L) for r in rows]
    warps = [x[..., L - 1] for x in lanes]
    _up_last(rows, comb, cells_log)
    _up_last(lanes, comb, lane_log)
    _up_last(warps, comb, warp_log)
    first = torch.arange(tiles) == 0
    prev = [torch.zeros(tiles, dtype=c.dtype) for c in cells]
    if tiles > 1:
        totals = [w[:full, W - 1].clone() for w in warps]
        if full > 1:
            totals = _split_scan(totals, comb, cells_log, lane_log, warp_log)
        for w, p, t in zip(warps, prev, totals):
            w[:full, W - 1] = t
            p[1:] = t[:tiles - 1]
    _down_last(warps, comb, warp_log, prev, first)
    wprev = [torch.cat([p[:, None], w[:, :-1]], 1)
             for p, w in zip(prev, warps)]
    _down_last(lanes, comb, lane_log, wprev,
               first[:, None] & (torch.arange(W) == 0))
    last = [x.reshape(tiles, W * L) for x in lanes]
    tprev = [torch.cat([p[:, None], x[:, :-1]], 1)
             for p, x in zip(prev, last)]
    _down_last(rows, comb, cells_log, tprev,
               first[:, None] & (torch.arange(W * L) == 0))
    return [r.reshape(-1)[:n] for r in rows]


# (cells_log, lane_log, warp_log): the card's, and smaller ones whose
# totals take two levels (and three) at test sizes
SPLITS = {"card": (4, 5, 3), "c2l4w2": (1, 2, 1), "c8l2w4": (3, 1, 2)}
SPLIT_CASES = [("card", n) for n in (1, 2, 4095, 4096, 4097, 3 * 4096 + 5,
                                     263_520)]
SPLIT_CASES += [("c2l4w2", n) for n in (3, 15, 16, 17, 271, 272, 277, 1000,
                                        16 * 16 * 17 + 5)]
SPLIT_CASES += [("c8l2w4", n) for n in (63, 64, 65, 64 * 65 + 5, 20_000)]


@pytest.mark.parametrize("split,n", SPLIT_CASES,
                         ids=[f"{s}-{n}" for s, n in SPLIT_CASES])
def test_thread_warp_block_split_equals_level_order(split, n):
    rng = np.random.default_rng(n + len(split))
    r = torch.from_numpy(_reset(rng, n, "random"))
    v = rng.random(n) * 1e6 + rng.random(n) * 1e-3
    v[rng.random(n) < 0.05] = -0.0
    hi, lo = (torch.from_numpy(a) for a in _split(v))
    f64 = torch.from_numpy(np.round(rng.standard_normal(n), 1))
    f32 = f64.float()
    for form, cells in (("add", (f64, r)), ("add", (f32, r)),
                        ("max", (f64, r)), ("comp", (hi, lo, r)),
                        ("min2", (hi, lo, r))):
        comb = SS.COMBINES[form]
        want = SS.tree_scan(cells, comb)
        got = _split_scan(cells, comb, *SPLITS[split])
        for w, g in zip(want, got):
            _same(w.numpy(), g.numpy())
    # and against associative_scan itself, with its interleave's +0.0
    for fn, cells in (("segmented_cumsum", (f64, r)),
                      ("segmented_cumsum", (f32, r)),
                      ("segmented_cumsum_compensated", (hi, lo, r)),
                      ("segmented_cumextreme2", (hi, lo, r))):
        kw = {"take_max": True} if fn == "segmented_cumextreme2" else {}
        comb = SS.COMBINES["max2" if kw else "comp" if len(cells) == 3
                           else "add"]
        got = _split_scan(cells, comb, *SPLITS[split])[:len(cells) - 1]
        if n > 1:
            got = [SS.positive_zero(g) for g in got]
        want = getattr(JS, fn)(*(jnp.asarray(c.numpy()) for c in cells),
                               **kw)
        want = want if isinstance(want, tuple) else (want,)
        for w, g in zip(want, got):
            _same(np.asarray(w), g.numpy())


def test_wrapper_refuses_wrong_inputs():
    r = torch.zeros(4, dtype=torch.bool)
    with pytest.raises(TypeError):
        SS.segmented_scan("add", torch.zeros(4, dtype=torch.float32), r)
    with pytest.raises(TypeError):
        SS.segmented_scan("comp", torch.zeros(4, dtype=torch.float32), r)
    with pytest.raises(TypeError):
        SS.segmented_scan("add", torch.zeros(5, dtype=torch.float64), r)
    with pytest.raises(ValueError):
        SS.segmented_scan("mul", torch.zeros(4, dtype=torch.float64), r)


def test_cpu_scan_launches_no_kernel():
    before = SS.segmented_scan.launches
    TS.segmented_cumsum(torch.arange(10, dtype=torch.int64),
                        torch.zeros(10, dtype=torch.bool))
    assert SS.segmented_scan.launches == before

