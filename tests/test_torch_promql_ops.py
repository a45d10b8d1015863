"""The port's PromQL ops against the JAX package's, on the CPU.

Every op takes the same seeded inputs in both packages: values with NaN,
+-inf, +-0.0 and absent cells, windows holding 0, 1 and 2 samples and
more. Each range function runs in both of its contexts: `fused` (one
XLA program whose scalars are constants, as the fast path compiles it:
here a jit around eval_range_function with Python scalars) and generic
(eval_range_function called as the generic engine calls it: each window
function jitted alone, its scalars arguments). Exact, bit for bit, on
every present slot, at windows of up to 15 cells and past 32: XLA:CPU
adds a window's cells in order from 0 up to 32 cells, and past 32 its
tree reduction rewriter sums chunks of 32 cells and then the chunk sums
(the port's `_window_sum`). From 16 to 32 cells LLVM vectorizes and
reassociates some of the linear fit's and stdvar's window sums on the
host, in an order the port does not copy: there deriv, predict_linear and
the variance are held to the forward-error bound of their sums (ROADMAP
C2), and every other function exactly.

histogram_quantile runs in float32 (the fast path) and float64 (the
generic engine's vectors under jax_enable_x64), with a non-monotone
bucket, q < 0, q > 1, the +Inf bucket and le[0] <= 0. The unblocked
aggregation runs every op in both branches: the scatter branch exact
(segment_sum's row order through G's plain version), the matmul branch
within 2 gamma_n sum|x|.
"""

import types

import jax
import numpy as np
import pytest
import torch

from greptimedb_tpu.ops import promql as JK
from greptimedb_tpu.ops import window as JW
from greptimedb_tpu_torch.ops import promql as TK
from greptimedb_tpu_torch.ops import window as TW

U = 2.0 ** -24
FNS = [("rate", ()), ("increase", ()), ("delta", ()), ("idelta", ()),
       ("irate", ()), ("sum_over_time", ()), ("count_over_time", ()),
       ("avg_over_time", ()), ("min_over_time", ()), ("max_over_time", ()),
       ("last_over_time", ()), ("first_over_time", ()),
       ("present_over_time", ()), ("absent_over_time", ()),
       ("stddev_over_time", ()), ("stdvar_over_time", ()),
       ("quantile_over_time", (0.9,)), ("quantile_over_time", (0.25,)),
       ("quantile_over_time", (-0.5,)), ("quantile_over_time", (1.5,)),
       ("mad_over_time", ()), ("changes", ()), ("resets", ()),
       ("deriv", ()), ("predict_linear", (600.0,)),
       ("holt_winters", (0.5, 0.5)), ("holt_winters", (0.3, 0.7))]
# (series, cells, cells a window, step in cells)
SHAPES = [(32, 41, 1, 1), (32, 41, 4, 2), (32, 60, 15, 3), (24, 80, 33, 5),
          (12, 200, 140, 20)]
REORDERED = range(16, 33)   # window lengths whose sums LLVM reassociates
WINDOW_SUMS = ("stddev_over_time", "stdvar_over_time", "deriv",
               "predict_linear")


def _data(seed, s, t):
    """(vals, has, tsg): the second half of the series holds specials."""
    rng = np.random.default_rng(seed)
    vals = np.cumsum(rng.uniform(-3, 5, (s, t)), axis=1).astype(np.float32)
    r = rng.random((s, t))
    r[: s // 2] = 1.0
    vals[r < 0.05] = np.nan
    vals[(r > 0.05) & (r < 0.08)] = np.inf
    vals[(r > 0.08) & (r < 0.1)] = -np.inf
    vals[(r > 0.1) & (r < 0.15)] = 0.0
    vals[(r > 0.15) & (r < 0.2)] = -0.0
    has = rng.random((s, t)) < 0.75
    # series without samples, with one, and with two adjacent ones
    has[:3] = False
    has[3, :] = False
    has[3, 5] = True
    has[4, :] = False
    has[4, 7:9] = True
    # sample times jitter inside their 15 s cells
    tsg = np.where(has, (np.arange(t) * 15_000)[None, :]
                   - rng.integers(0, 14_000, (s, t)), 0).astype(np.int32)
    return vals, has, tsg


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint64 if x.dtype == np.float64 else np.uint32)


def _same(want, got):
    """Equal bits, or NaN on both sides."""
    want, got = np.asarray(want), np.asarray(got)
    return (_bits(want) == _bits(got)) | (np.isnan(want) & np.isnan(got))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "generic"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"L{s[2]}")
def test_range_functions_match_jax(shape, fused):
    s, t, l_cells, step = shape
    vals, has, tsg = _data(s * t + l_cells, s, t)
    hi = np.arange(l_cells, t, step).astype(np.int32)
    lo = (hi - l_cells).astype(np.int32)
    t_end = (hi * 15_000).astype(np.int32)
    rt, tps = l_cells * 15_000, 1000.0
    spec = types.SimpleNamespace(tps=tps)
    jwin = JW.Windows(lo=lo, hi=hi, t_end=t_end, range_ticks=rt,
                      range_seconds=rt / 1000)
    twin = types.SimpleNamespace(
        lo=torch.from_numpy(lo), hi=torch.from_numpy(hi),
        t_end=torch.from_numpy(t_end), range_ticks=rt, l_cells=l_cells)
    tv, th, tt = map(torch.from_numpy, (vals, has, tsg))
    for name, args in FNS:
        if l_cells in REORDERED and name in WINDOW_SUMS:
            # held to their sums' forward-error bound below (ROADMAP C2)
            continue
        if fused:
            def prog(v, h, g, lo_, hi_, te_, name=name, args=args):
                w = types.SimpleNamespace(
                    lo=lo_, hi=hi_, t_end=te_, range_ticks=rt,
                    range_seconds=rt / 1000, num_cells_per_window=l_cells)
                return JK.eval_range_function(name, v, h, g, w, spec,
                                              args=args)

            want = jax.jit(prog)(vals, has, tsg, lo, hi, t_end)
        else:
            want = JK.eval_range_function(name, vals, has, tsg, jwin, spec,
                                          args=args)
        wv, wp = (np.asarray(x) for x in want)
        gv, gp = TK.eval_range_function(name, tv, th, tt, twin, tps,
                                        args=args, fused=fused, x64=True)
        gv, gp = gv.numpy(), gp.numpy()
        assert np.array_equal(wp, gp), (name, args)
        assert _same(wv, gv).all(), (name, args, wv[~_same(wv, gv)][:4],
                                     gv[~_same(wv, gv)][:4])


def _window_cells(vals, has, tsg, hi, t_end, l_cells, tps):
    """The gathered (S, J, L) window cells in float64: present values
    (absent ones 0) and t, seconds before the window end (float32, as both
    packages compute it)."""
    idx = hi[:, None] - np.arange(l_cells)[None, :]
    h = has[:, idx]
    x = np.where(h, vals[:, idx], 0).astype(np.float64)
    t = ((tsg[:, idx].astype(np.float32) - t_end[None, :, None].astype(
        np.float32)) / np.float32(tps)).astype(np.float64)
    return x, np.where(h, t, 0), h


def test_long_window_variance_within_reorder_bound():
    """stdvar over 20 and 32 cells: LLVM reassociates the window sums on
    the host; the port adds in cell order. |a - b| <= 2 (L - 1) u (sum x^2
    + 2 |mean| sum |x|) / n, the reorder gap of both passes."""
    for l_cells in (20, 32):
        s, t = 12, 80
        vals, has, tsg = _data(7, s, t)
        vals, has, tsg = vals[: s // 2], has[: s // 2], tsg[: s // 2]
        hi = np.arange(l_cells, t, 3).astype(np.int32)
        want = np.asarray(JW.window_stdvar(vals, has, tsg, hi,
                                           num_cells=l_cells)[0])
        got = TW.window_stdvar(*map(torch.from_numpy, (vals, has, tsg, hi)),
                               l_cells)[0].numpy()
        idx = hi[:, None] - np.arange(l_cells)[None, :]
        x = np.where(has[:, idx], vals[:, idx].astype(np.float64), 0)
        n = np.maximum(has[:, idx].sum(axis=2), 1)
        mean = x.sum(axis=2) / n
        bound = 2 * l_cells * U * ((x * x).sum(axis=2) + 2 * np.abs(mean)
                                   * np.abs(x).sum(axis=2)) / n
        assert np.all(np.abs(want - got) <= bound), l_cells


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "generic"])
@pytest.mark.parametrize("l_cells", [16, 20, 32])
def test_mid_window_linear_fit_within_reorder_bound(l_cells, fused):
    """deriv and predict_linear where LLVM reassociates the window sums:
    presence exact; where the exact fit is finite and its denominator
    n sum(t^2) - (sum t)^2 exceeds twice its error bound, the slope, the
    intercept and the prediction each lie within twice their forward-error
    bound of the exact value (each package within one bound), built from
    the sums' bound gamma_L sum|x| (any order, products rounded or fused);
    elsewhere the same bits."""
    s, t, h = 24, 90, 600.0
    vals, has, tsg = _data(11 + l_cells, s, t)
    finite = np.isfinite(vals)
    hi = np.arange(l_cells, t, 3).astype(np.int32)
    lo = (hi - l_cells).astype(np.int32)
    t_end = (hi * 15_000).astype(np.int32)
    rt, tps = l_cells * 15_000, 1000.0
    spec = types.SimpleNamespace(tps=tps)
    twin = types.SimpleNamespace(
        lo=torch.from_numpy(lo), hi=torch.from_numpy(hi),
        t_end=torch.from_numpy(t_end), range_ticks=rt, l_cells=l_cells)
    jwin = JW.Windows(lo=lo, hi=hi, t_end=t_end, range_ticks=rt,
                      range_seconds=rt / 1000)
    x, tt, hw = _window_cells(vals, has, tsg, hi, t_end, l_cells, tps)
    gam = (l_cells + 1) * U / (1 - (l_cells + 1) * U)
    n1 = np.maximum(hw.sum(axis=2), 1).astype(np.float64)
    st, sv = tt.sum(axis=2), x.sum(axis=2)
    stt, stv = (tt * tt).sum(axis=2), (tt * x).sum(axis=2)
    d_st, d_sv = gam * np.abs(tt).sum(axis=2), gam * np.abs(x).sum(axis=2)
    d_stt, d_stv = gam * stt, gam * np.abs(tt * x).sum(axis=2)
    with np.errstate(invalid="ignore"):
        num, den = n1 * stv - st * sv, n1 * stt - st * st
    slope = num / np.where(den == 0, 1, den)
    e_num = (n1 * d_stv + (np.abs(st) + d_st) * d_sv + np.abs(sv) * d_st
             + 2 * U * (n1 * np.abs(stv) + np.abs(st * sv)))
    e_den = (n1 * d_stt + (2 * np.abs(st) + d_st) * d_st
             + 2 * U * (n1 * stt + st * st))
    with np.errstate(divide="ignore", invalid="ignore"):
        b_slope = ((e_num + np.abs(slope) * e_den) / (np.abs(den) - e_den)
                   + 2 * U * np.abs(slope))
        icpt = (sv - slope * st) / n1
        b_icpt = ((b_slope * (np.abs(st) + d_st) + np.abs(slope) * d_st
                   + d_sv + 2 * U * (np.abs(sv) + np.abs(slope * st))) / n1
                  + 2 * U * np.abs(icpt))
    pred = icpt + slope * h
    b_pred = b_icpt + h * b_slope + 2 * U * (np.abs(icpt) + np.abs(slope * h))
    idx = hi[:, None] - np.arange(l_cells)[None, :]
    clean = (np.where(has[:, idx], finite[:, idx], True).all(axis=2)
             & (np.abs(den) > 2 * e_den))
    tv, th, tg = map(torch.from_numpy, (vals, has, tsg))
    checked = 0
    for name, args, exact, bound in (("deriv", (), slope, b_slope),
                                     ("predict_linear", (h,), pred, b_pred)):
        if fused:
            def prog(v, hh, g, lo_, hi_, te_, name=name, args=args):
                w = types.SimpleNamespace(
                    lo=lo_, hi=hi_, t_end=te_, range_ticks=rt,
                    range_seconds=rt / 1000, num_cells_per_window=l_cells)
                return JK.eval_range_function(name, v, hh, g, w, spec,
                                              args=args)

            want = jax.jit(prog)(vals, has, tsg, lo, hi, t_end)
        else:
            want = JK.eval_range_function(name, vals, has, tsg, jwin, spec,
                                          args=args)
        wv, wp = (np.asarray(a) for a in want)
        gv, gp = TK.eval_range_function(name, tv, th, tg, twin, tps,
                                        args=args, fused=fused, x64=True)
        gv, gp = gv.numpy(), gp.numpy()
        assert np.array_equal(wp, gp), name
        held = clean & wp
        for got in (wv, gv):
            assert np.all(np.abs(got[held] - exact[held])
                          <= bound[held]), name
        assert _same(wv, gv)[wp & ~clean].all(), name
        checked += int(held.sum())
    assert checked > 100       # the bound held most windows


@pytest.mark.parametrize("length", [1, 2, 3, 4, 7, 16])
def test_small_sort_lanes_is_the_stable_sort(length):
    """The transposition network sorts as jnp.sort does: NaN last, equal
    values (-0.0 and +0.0 among them) in their input order."""
    rng = np.random.default_rng(length)
    x = rng.choice(np.array([0.0, -0.0, 1.5, -2.0, np.nan, np.inf, -np.inf],
                            np.float32), (9, 5, length))
    want = np.asarray(JW._small_sort_lanes(x, length))
    got = TW._small_sort_lanes(torch.from_numpy(x), length).numpy()
    assert _same(want, got).all()
    srt = torch.sort(torch.from_numpy(x), dim=2, stable=True)[0].numpy()
    assert _same(want, srt).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("layout", ["neg_first", "plain", "zero_first"])
def test_histogram_quantile_matches_jax(dtype, layout):
    le = {"neg_first": [-1.0, 0.1, 0.5, 1.0, np.inf],
          "plain": [0.1, 0.5, 1.0, np.inf],
          "zero_first": [0.0, 2.0, np.inf]}[layout]
    le = np.asarray(le, dtype)
    rng = np.random.default_rng(len(le))
    nb = len(le)
    b = np.cumsum(rng.integers(0, 5, (6, 7, nb)), axis=-1).astype(dtype)
    b[0, 0, 1] = b[0, 0, 2] + 3      # a non-monotone bucket
    b[1] = 0.0                        # empty histograms
    b[2, 0] = -0.0
    b[3, 1, 1] = np.nan
    b[5, 2, -1] = b[5, 2, -2]         # everything below the last bound
    m = rng.random((6, 7, nb)) < 0.9
    m[4] = False
    for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0, -0.1, 1.5):
        qa = np.float32(q) if dtype == np.float32 else q
        wv, wp = (np.asarray(a) for a in JK.histogram_quantile(le, b, m, qa))
        gv, gp = TK.histogram_quantile(torch.from_numpy(le),
                                       torch.from_numpy(b),
                                       torch.from_numpy(m), q)
        assert np.array_equal(wp, gp.numpy()), q
        assert _same(wv, gv.numpy()).all(), (q, wv, gv)


def test_fma_f64_is_correctly_rounded():
    """The float64 fma emulation against exact rational arithmetic."""
    from fractions import Fraction

    rng = np.random.default_rng(3)
    a = rng.standard_normal(400) * 10.0 ** rng.integers(-5, 6, 400)
    b = rng.standard_normal(400) * 10.0 ** rng.integers(-5, 6, 400)
    c = -a * b * (1 + rng.standard_normal(400) * 1e-12)
    got = TW._fma_f64(*map(torch.from_numpy, (a, b, c))).numpy()
    for x, y, z, r in zip(a, b, c, got):
        exact = Fraction(x) * Fraction(y) + Fraction(z)
        assert r == float(exact), (x, y, z)


def _agg_inputs(dtype, s, specials):
    rng = np.random.default_rng(s + specials)
    vals = (rng.standard_normal((s, 6))
            * 10.0 ** rng.integers(-2, 3, (s, 6))).astype(dtype)
    if specials:
        r = rng.random((s, 6))
        vals[r < 0.03] = np.nan
        vals[(r > 0.03) & (r < 0.05)] = np.inf
        vals[(r > .05) & (r < .07)] = -np.inf
        vals[(r > .07) & (r < .12)] = 0.0
        vals[(r > .12) & (r < .17)] = -0.0
    pres = rng.random((s, 6)) < 0.8
    return vals, pres


OPS = ["sum", "avg", "count", "group", "min", "max", "stddev", "stdvar"]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("op", OPS)
def test_aggregate_scatter_branch_matches_jax(op, dtype):
    g = 7
    for specials in (False, True):
        vals, pres = _agg_inputs(dtype, 300, specials)
        gid = np.random.default_rng(1).integers(0, g - 1, 300).astype(
            np.int32)                     # group g - 1 stays empty
        assert not TK.uses_matmul(op, g, 300)
        wv, wp = (np.asarray(a) for a in JK.aggregate_across_series(
            vals, pres, gid, g, op))
        gv, gp = TK.aggregate_across_series(
            torch.from_numpy(vals), torch.from_numpy(pres),
            torch.from_numpy(gid), g, op)
        assert np.array_equal(wp, gp.numpy())
        assert _same(wv, gv.numpy()).all(), (op, specials)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("op", OPS)
def test_aggregate_matmul_branch_within_bound(op, dtype):
    """At 5000 series the linear ops are one (G, S) x (S, J) product in
    both packages, in different orders: |a - b| <= 2 gamma_n sum|x| over
    a group's members (n = S), and for stddev/stdvar that gap through
    both passes; counts, min and max exact."""
    g, s = 9, 5000
    vals, pres = _agg_inputs(dtype, s, False)
    gid = np.random.default_rng(2).integers(0, g, s).astype(np.int32)
    assert TK.uses_matmul(op, g, s) == (op not in ("min", "max"))
    wv, wp = (np.asarray(a) for a in JK.aggregate_across_series(
        vals, pres, gid, g, op))
    gv, gp = TK.aggregate_across_series(
        torch.from_numpy(vals), torch.from_numpy(pres),
        torch.from_numpy(gid), g, op)
    gv = gv.numpy()
    assert np.array_equal(wp, gp.numpy())
    if op in ("count", "group", "min", "max"):
        assert _same(wv, gv).all()
        return
    u = 2.0 ** -53 if dtype == np.float64 else U
    gamma = s * u / (1 - s * u)
    onehot = (gid[None, :] == np.arange(g)[:, None])
    x = np.where(pres, vals, 0).astype(np.float64)
    mag = onehot.astype(np.float64) @ np.abs(x)               # (G, J)
    cnt = np.maximum(onehot.astype(np.float64) @ pres, 1)
    if op == "sum":
        bound = 2 * gamma * mag
    elif op == "avg":
        bound = 2 * gamma * mag / cnt + 2 * u * np.abs(wv)
    else:
        mean = (onehot @ x) / cnt
        sq = onehot.astype(np.float64) @ (x * x)
        var_gap = 2 * gamma * (sq + 4 * np.abs(mean) * mag) / cnt
        bound = var_gap if op == "stdvar" else (
            var_gap / np.maximum(np.sqrt(np.maximum(wv, 0)), 1e-30)
            + 2 * u * np.abs(wv))
    assert np.all(np.abs(wv - gv) <= bound + 4 * u * np.abs(wv)), op


def test_aggregate_sum_keeps_segment_sum_zero_bits():
    """segment_sum starts from +0.0: a group of only -0.0 sums to +0.0,
    in both packages and through G's member order."""
    vals = np.array([[-0.0], [-0.0], [1.5], [-0.0]], np.float32)
    pres = np.ones((4, 1), bool)
    gid = np.array([0, 0, 1, 1], np.int32)
    want = np.asarray(JK.aggregate_across_series(vals, pres, gid, 2,
                                                 "sum")[0])
    got = TK.aggregate_across_series(*map(torch.from_numpy,
                                          (vals, pres, gid)), 2, "sum")[0]
    assert _same(want, got.numpy()).all()
    assert not np.signbit(want[0, 0])
