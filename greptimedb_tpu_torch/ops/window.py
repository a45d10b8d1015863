"""Window functions over (series x time) grids (the JAX package's
ops/window.py).

- prefix path: window aggregates as differences of per-series prefix sums
  (O(S*T) memory, no per-window gather): sum/count/avg, the extrapolated
  rate family, changes/resets, first/last/idelta/irate.
- gather path: (S, J, L) window tensors gathered L cells per output step:
  min/max, stddev/stdvar, quantile/mad, the linear fit (deriv,
  predict_linear) and Holt-Winters.

Window j covers grid cells [lo_j+1 .. hi_j] (samples with ts in
(t_end_j - range, t_end_j]), matching PromQL's half-open window. Every
function returns a (values, present) pair shaped (S, J).

Numeric contract with the JAX package (XLA:CPU):

- `_prefix` adds in XLA:CPU's order for a float cumsum: sequential from 0
  within blocks of 16 cells, the block totals scanned the same way, then
  added (`_xla_cumsum`), so prefix sums agree bit for bit on the CPU and
  on the card alike.
- `_take_cells` for T <= 128 is a one-hot *sum* in the JAX package, which
  turns a selected -0.0 into +0.0; the gather here adds +0.0 to float
  planes to keep those bits.
- reductions over a window's L cells (`_window_sum`, `_window_dot`):
  up to 32 cells they add sequentially from 0, a sum of products one fma
  per step, as LLVM contracts XLA:CPU's fused multiply-reduce
  (`_fma_f32`); past 32 cells XLA's tree reduction rewriter splits the
  axis into chunks of 32 (the padding split evenly before and after the
  cells), sums each chunk in order from 0 and reduces the chunk sums the
  same way, the products rounded before they are added. From 16 to 32
  cells LLVM vectorizes and reassociates some of these sums on the host,
  in an order the port does not copy (ROADMAP C2).
- a division by a compile-time constant of the JAX program (the grid's
  ticks per second, a rate's range in seconds) is a multiplication by the
  constant's float32 reciprocal there (XLA's algebraic simplifier rewrites
  x / C to x * (1 / C), constant folding included); `_div_const` does the
  same. The generic engine's calls take those scalars as arguments
  (`fused=False`), where the division stays (`_div_scalar`).
- the products XLA:CPU contracts into an fma are computed with one
  rounding (`_fma_f32`, `_fma_f64`); each function says which.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from greptimedb_tpu_torch.ops.grid import GridSpec

_CUMSUM_BLOCK = 16
_TREE = 32      # cells XLA:CPU reduces in one chunk


@dataclass
class Windows:
    """Host-built window description for a range evaluation (the generic
    engine's). Built so that every window boundary lands on a cell
    boundary: res divides step, range and (start - t0)."""

    lo: np.ndarray        # (J,) int32 cell index, window = cells (lo, hi]
    hi: np.ndarray        # (J,) int32
    t_end: np.ndarray     # (J,) int32 window end, device ticks from t0
    range_ticks: int      # window length in device ticks
    range_seconds: float

    @property
    def num_steps(self) -> int:
        return len(self.hi)

    @property
    def num_cells_per_window(self) -> int:
        return int(self.hi[0] - self.lo[0])


def plan_grid_and_windows(start_ms: int, end_ms: int, step_ms: int,
                          range_ms: int, *, max_cells: int = 4_000_000,
                          data_interval_ms: int | None = None
                          ) -> tuple[GridSpec, Windows]:
    """Choose a grid resolution and origin so windows align with cells:
    res = gcd(step, range[, data interval]), so windows cover whole cells.
    Past `max_cells` the resolution coarsens (boundaries then approximate
    on huge spans)."""
    step_ms = max(int(step_ms), 1)
    range_ms = max(int(range_ms), 1)
    res = int(np.gcd(step_ms, range_ms))
    if data_interval_ms and data_interval_ms > 0:
        res = int(np.gcd(res, int(data_interval_ms)))
    span = (end_ms - start_ms) + range_ms
    while span // res > max_cells:
        res *= 2
    t0 = start_ms - range_ms
    # cells are (t0 + (i-1) res, t0 + i res]; a sample at exactly end_ms
    # maps to cell span // res, so the grid needs span // res + 1 cells
    num_cells = span // res + 1
    spec = GridSpec.build(t0, res, num_cells)
    steps = np.arange(start_ms, end_ms + 1, step_ms, dtype=np.int64)
    hi = np.minimum((steps - t0) // res, num_cells - 1).astype(np.int32)
    w_cells = max(range_ms // res, 1)
    lo = np.maximum(hi - w_cells, 0).astype(np.int32)
    t_end = ((steps - t0) // spec.unit).astype(np.int32)
    return spec, Windows(lo=lo, hi=hi, t_end=t_end,
                         range_ticks=int(range_ms // spec.unit),
                         range_seconds=range_ms / 1000.0)


def _seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix along dim 1, added one cell at a time from 0."""
    out = torch.empty_like(x)
    acc = torch.zeros_like(x[:, 0])
    for i in range(x.shape[1]):
        acc = acc + x[:, i]
        out[:, i] = acc
    return out


def _xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Float cumsum along dim 1 with XLA:CPU's association: sequential
    within blocks of 16, block totals scanned recursively, then added."""
    s, t = x.shape
    if t <= _CUMSUM_BLOCK:
        return _seq_cumsum(x)
    nb = -(-t // _CUMSUM_BLOCK)
    pad = nb * _CUMSUM_BLOCK - t
    xp = torch.cat([x, x.new_zeros((s, pad))], dim=1)
    inner = _seq_cumsum(xp.reshape(s * nb, _CUMSUM_BLOCK)).reshape(
        s, nb, _CUMSUM_BLOCK)
    outer = _xla_cumsum(inner[:, :, -1].contiguous())
    excl = torch.cat([x.new_zeros((s, 1)), outer[:, :-1]], dim=1)
    return (inner + excl[:, :, None]).reshape(s, nb * _CUMSUM_BLOCK)[:, :t]


def _div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as XLA computes it for a constant c: x * float32(1 / c)."""
    one = torch.tensor(1.0, dtype=x.dtype)
    recip = (one / torch.tensor(c, dtype=x.dtype)).item()
    return x * torch.tensor(recip, dtype=x.dtype, device=x.device)


def _div_scalar(x: torch.Tensor, c: float, fused: bool) -> torch.Tensor:
    """x / c for a scalar c: a constant of the fused program (`fused`:
    x * float32(1 / c)) or an argument of a separately jitted call (a
    division by float32(c))."""
    if fused:
        return _div_const(x, c)
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def _f2i(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 as XLA converts: NaN to 0, out-of-range values
    saturate (torch's cast leaves them undefined)."""
    out = torch.nan_to_num(x, nan=0.0).clamp(-2147483648.0, 2147483520.0)
    return torch.where(x >= 2147483648.0, 2147483647, out.to(torch.int32))


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root in x's float dtype, as XLA:CPU's.
    CUDA's sqrt rounds correctly; torch's vectorized CPU kernel can be one
    ulp off in float32 and float64 (ROADMAP C6), so a CPU tensor takes
    numpy's root."""
    if x.is_cuda:
        return torch.sqrt(x)
    with np.errstate(invalid="ignore"):
        return torch.from_numpy(np.asarray(np.sqrt(x.numpy())))


def _seq_sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim, added sequentially from 0."""
    acc = torch.zeros_like(x[..., 0])
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _chunks(x: torch.Tensor) -> torch.Tensor:
    """(..., L) -> (..., ceil(L / 32), 32): the cells padded with +0.0 to
    whole chunks, the padding split evenly before and after (the lower
    half first), as XLA's tree reduction rewriter pads the axis."""
    n = x.shape[-1]
    pad = -(-n // _TREE) * _TREE - n
    x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
    return x.reshape(*x.shape[:-1], -1, _TREE)


def _window_sum(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float sum over the last dim: sequential from 0 up to 32
    cells, else chunks of 32 summed in order, then their sums the same
    way."""
    while x.shape[-1] > _TREE:
        x = _seq_sum_last(_chunks(x))
    return _seq_sum_last(x)


def _window_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b) over the last dim as XLA:CPU reduces it: one fma a step
    up to 32 cells, else the rounded products through `_window_sum`."""
    if a.shape[-1] > _TREE:
        return _window_sum(a * b)
    acc = torch.zeros_like(a[..., 0])
    for i in range(a.shape[-1]):
        acc = _fma(a[..., i], b[..., i], acc)
    return acc


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    """s, e with s = round(a + b) and s + e = a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _round_odd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b rounded to odd in float64: the nearest double toward the
    exact sum when it is not representable, picked so its last bit is
    1; a later rounding to fewer bits is then the single correct one."""
    s, err = _two_sum(a, b)
    even = (s.view(torch.int64) & 1) == 0
    return torch.where((err != 0) & even,
                       torch.nextafter(s, torch.where(
                           err > 0, float("inf"), float("-inf")).double()),
                       s)


def _fma_f32(a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor) -> torch.Tensor:
    """float32 fma(a, b, c) with one rounding, as LLVM contracts XLA:CPU's
    fused multiply-reduce. a * b is exact in float64; the float64 sum is
    rounded to odd, so the final rounding to float32 is the single
    correct one."""
    return _round_odd(a.double() * b.double(), c.double()).float()


def _fma_f64(a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor) -> torch.Tensor:
    """float64 fma(a, b, c) with one rounding (Boldo and Melquiond's
    emulation: an exact product by Veltkamp splitting, an exact add, the
    low parts rounded to odd, then one rounding). Finite operands whose
    product neither overflows nor underflows; anything else takes
    a * b + c, which the fma matches there."""
    def split(x):
        t = x * 134217729.0     # 2^27 + 1
        hi = t - (t - x)
        return hi, x - hi

    uh = a * b
    ah, al = split(a)
    bh, bl = split(b)
    ul = ((ah * bh - uh) + ah * bl + al * bh) + al * bl
    th, tl = _two_sum(c, uh)
    out = th + _round_odd(tl, ul)
    ok = torch.isfinite(out) & torch.isfinite(ul) & (uh.abs() > 2.0 ** -960)
    return torch.where(ok, out, uh + c)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fma(a, b, c) in the operands' float dtype (float32 or float64)."""
    if a.dtype == torch.float64:
        return _fma_f64(a, b, c)
    return _fma_f32(a, b, c)


# ----------------------------------------------------------------------
# prefix helpers (all (S, T) -> (S, T+1) or (S, T))
# ----------------------------------------------------------------------

def _scan_ints(x: torch.Tensor, op) -> torch.Tensor:
    """Inclusive scan of an integer (S, T) tensor along dim 1 with an
    associative op (max or add: exact in any order), as log2(T) whole-
    tensor passes (Hillis-Steele). torch's CUDA cummax/cumsum over a short
    innermost axis run a slow per-row scan kernel (10 ms at 2^20 x 11
    on an H100, PERF.md)."""
    d = 1
    while d < x.shape[1]:
        x = torch.cat([x[:, :d], op(x[:, d:], x[:, :-d])], dim=1)
        d *= 2
    return x


def _prefix(x: torch.Tensor) -> torch.Tensor:
    """P[:, i] = sum of cells < i; shape (S, T+1)."""
    if x.dtype.is_floating_point:
        c = _xla_cumsum(x)
    else:
        c = _scan_ints(x, torch.add)
    return torch.nn.functional.pad(c, (1, 0))


def _cell_iota(like: torch.Tensor) -> torch.Tensor:
    return torch.arange(like.shape[1], dtype=torch.int32,
                        device=like.device).expand(like.shape)


def _last_present_idx(has: torch.Tensor) -> torch.Tensor:
    """lastidx[:, i] = greatest cell j <= i with a sample, else -1."""
    return _scan_ints(torch.where(has, _cell_iota(has), -1), torch.maximum)


def _first_present_idx(has: torch.Tensor) -> torch.Tensor:
    """firstidx[:, i] = least cell j >= i with a sample, else T."""
    t = has.shape[1]
    rev = torch.flip(has, dims=(1,))
    lp = _scan_ints(torch.where(rev, _cell_iota(has), -1), torch.maximum)
    return torch.flip((t - 1) - lp, dims=(1,)).to(torch.int32)


def _prev_present_idx(lastidx: torch.Tensor) -> torch.Tensor:
    """prev[:, i] = greatest cell j < i with a sample, else -1."""
    return torch.nn.functional.pad(lastidx[:, :-1], (1, 0), value=-1)


def _gather_steps(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather an (S, T') array at per-step indices: (J,) idx -> (S, J);
    (S, J) idx -> (S, J). A step index past the grid clamps to its last
    cell, as jnp indexing clamps."""
    if idx.dim() == 1:
        return arr[:, idx.to(torch.int64).clamp(0, arr.shape[1] - 1)]
    return _take_cells(arr, idx)


_TAKE_CELLS_MAX_T = 128


def _take_cells(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take_along_axis(arr, idx, axis=1) for (S, T) arr and (S, J) idx.
    Up to T = 128 the JAX package sums a one-hot instead: every addend but
    the selected one is +0.0, so the sum is the selected value with -0.0
    turned to +0.0 — the gather plus +0.0 here."""
    out = torch.gather(arr, 1, idx.to(torch.int64))
    if arr.dtype.is_floating_point and arr.shape[1] <= _TAKE_CELLS_MAX_T:
        out = out + 0.0
    return out


# ----------------------------------------------------------------------
# prefix-path functions
# ----------------------------------------------------------------------

def window_count(has, lo, hi):
    c = _prefix(has.to(torch.int32))
    return _gather_steps(c, hi + 1) - _gather_steps(c, lo + 1)


def window_sum(vals, has, lo, hi):
    p = _prefix(torch.where(has, vals, 0.0))
    s = _gather_steps(p, hi + 1) - _gather_steps(p, lo + 1)
    return s, window_count(has, lo, hi) > 0


def window_avg(vals, has, lo, hi):
    s, _ = window_sum(vals, has, lo, hi)
    cnt = window_count(has, lo, hi)
    return s / cnt.clamp(min=1).to(s.dtype), cnt > 0


def window_last(vals, has, tsg, lo, hi):
    """Most recent sample in each window: (value, ts, present)."""
    li = _gather_steps(_last_present_idx(has), hi)
    present = li > lo[None, :]
    safe = li.clamp(min=0)
    return _take_cells(vals, safe), _take_cells(tsg, safe), present


def window_first(vals, has, tsg, lo, hi):
    fi = _gather_steps(_first_present_idx(has), lo + 1)
    present = fi <= hi[None, :]
    safe = fi.clamp(max=vals.shape[1] - 1)
    return _take_cells(vals, safe), _take_cells(tsg, safe), present


def _pair_indicator(vals, has):
    """(pair, prev_val) per cell over (previous sample, sample) pairs."""
    pl = _prev_present_idx(_last_present_idx(has))
    prev_val = _take_cells(vals, pl.clamp(min=0))
    return has & (pl >= 0), prev_val


def extrapolated_rate(vals, has, tsg, lo, hi, t_end, range_ticks, tps, *,
                      is_counter: bool, is_rate: bool, fused: bool = True,
                      x64: bool = False):
    """Prometheus rate/increase/delta with the extrapolation rules of
    functions.go. Returns (value, present) shaped (S, J).

    `fused`: range_ticks and tps are constants of one fused program (the
    fast path); else arguments of the separately jitted call the generic
    engine makes, where XLA keeps the divisions by tps and divides the
    rate by float32(range_ticks) / float32(tps) in either mode.

    `x64`: the JAX package's jax_enable_x64 mode. It changes the fused
    program only, where range_ticks and tps reach XLA as float64 constants
    with x64 and as float32 constants without. With x64, XLA rewrites
    (x / tps) / m into x / (tps * m) before it folds the constants, and
    the rate divisor is float32(range_ticks / tps); without x64 the
    divisions by tps turn into products by float32(1 / tps) first, so the
    mean spacing is ((t_last - t_first) * (1 / tps)) / m, and the divisor
    is float32(range_ticks) * float32(1 / tps), folded in float32. Both
    divisors then become a product by their float32 reciprocal."""
    dt = vals.dtype
    li = _gather_steps(_last_present_idx(has), hi)          # (S, J)
    fi = _gather_steps(_first_present_idx(has), lo + 1)     # (S, J)
    t_max = vals.shape[1] - 1
    li_s = li.clamp(min=0)
    fi_s = fi.clamp(max=t_max)
    valid = (li > lo[None, :]) & (fi <= hi[None, :]) & (fi < li)
    v_last = _take_cells(vals, li_s)
    v_first = _take_cells(vals, fi_s)
    t_last = _take_cells(tsg, li_s).to(dt)
    t_first = _take_cells(tsg, fi_s).to(dt)

    delta = v_last - v_first
    if is_counter:
        pair, prev_val = _pair_indicator(vals, has)
        drop = torch.where(pair & (vals < prev_val), prev_val, 0.0)
        d = _prefix(drop)
        corr = _gather_steps(d, hi + 1) - _take_cells(d, fi_s + 1)
        delta = delta + corr

    cnt = window_count(has, lo, hi).to(dt)
    t_end_f = t_end[None, :].to(dt)
    rt = torch.tensor(range_ticks, dtype=dt, device=vals.device)
    dur_start = _div_scalar(t_first - (t_end_f - rt), tps, fused)
    dur_end = _div_scalar(t_end_f - t_last, tps, fused)
    sampled = _div_scalar(t_last - t_first, tps, fused)
    if fused and not x64:
        avg_dur = sampled / (cnt - 1).clamp(min=1)
    else:
        # XLA rewrites (x / tps) / m into x / (tps * m) before it turns a
        # float64-born constant tps into a reciprocal, and always when
        # tps is an argument
        avg_dur = (t_last - t_first) / (
            torch.tensor(tps, dtype=dt, device=vals.device)
            * (cnt - 1).clamp(min=1))

    if is_counter:
        # avoid extrapolating a counter below zero
        dur_zero = torch.where(
            (delta > 0) & (v_first >= 0),
            sampled * (v_first / torch.where(delta == 0, 1.0, delta)),
            torch.tensor(float("inf"), dtype=dt, device=vals.device),
        )
        dur_start = torch.minimum(dur_start, dur_zero)

    thresh = avg_dur * torch.tensor(1.1, dtype=dt, device=vals.device)
    extr = sampled
    extr = extr + torch.where(dur_start < thresh, dur_start, avg_dur / 2)
    extr = extr + torch.where(dur_end < thresh, dur_end, avg_dur / 2)
    factor = extr / torch.where(sampled == 0, 1.0, sampled)
    out = delta * factor
    if is_rate:
        # the JAX program computes range_ticks / tps on traced scalars:
        # in float64 under jax_enable_x64, in float32 without
        if fused and x64:
            out = _div_const(out, range_ticks / tps)
        elif fused:
            one = torch.tensor(1.0, dtype=dt)
            out = _div_const(out, (torch.tensor(float(range_ticks), dtype=dt)
                                   * (one / torch.tensor(tps, dtype=dt))
                                   ).item())
        else:
            out = out / (torch.tensor(float(range_ticks), dtype=dt)
                         / torch.tensor(tps, dtype=dt)).to(vals.device)
    return torch.where(valid, out, 0.0), valid


def window_pair_count(vals, has, lo, hi, *, count_changes: bool):
    """changes() (value differs from the previous sample) or resets()
    (value drops) over each window; pairs have both samples inside the
    window. Returns (count as float, present)."""
    pair, prev_val = _pair_indicator(vals, has)
    if count_changes:
        ind = pair & (vals != prev_val)
    else:
        ind = pair & (vals < prev_val)
    p = _prefix(ind.to(torch.int32))
    fi = _gather_steps(_first_present_idx(has), lo + 1)
    fi_s = fi.clamp(max=vals.shape[1] - 1)
    in_w = fi <= hi[None, :]
    cnt = _gather_steps(p, hi + 1) - _take_cells(p, fi_s + 1)
    cnt = torch.where(in_w, cnt, 0)
    return cnt.to(vals.dtype), in_w


def instant_delta(vals, has, tsg, lo, hi, tps, *, is_rate: bool):
    """idelta (last two samples' difference) / irate (per second, with
    counter-reset handling)."""
    dt = vals.dtype
    lastidx = _last_present_idx(has)
    pl = _prev_present_idx(lastidx)
    li = _gather_steps(lastidx, hi)
    li_s = li.clamp(min=0)
    # previous present cell strictly before li
    pi = _take_cells(pl, li_s)
    pi_s = pi.clamp(min=0)
    valid = (li > lo[None, :]) & (pi > lo[None, :]) & (pi >= 0)
    v1 = _take_cells(vals, pi_s)
    v2 = _take_cells(vals, li_s)
    t1 = _take_cells(tsg, pi_s).to(dt)
    t2 = _take_cells(tsg, li_s).to(dt)
    if is_rate:
        dv = torch.where(v2 < v1, v2, v2 - v1)  # counter reset: raw value
        # JAX: dv / (max(t2 - t1, 1) / tps), which XLA:CPU rewrites to
        # (dv * tps) / max(t2 - t1, 1) for a constant tps
        out = (dv * torch.tensor(tps, dtype=dt, device=vals.device)
               ) / (t2 - t1).clamp(min=1)
    else:
        out = v2 - v1
    return torch.where(valid, out, 0.0), valid


# ----------------------------------------------------------------------
# gather-path functions
# ----------------------------------------------------------------------

def gather_windows(vals, has, tsg, hi, num_cells: int):
    """(S, J, L) window tensors: cell hi_j - k for k in [0, L), in reverse
    time order (k = 0 is the window end)."""
    k = torch.arange(num_cells, dtype=torch.int32, device=hi.device)
    idx = hi[:, None] - k[None, :]                     # (J, L)
    ok = idx >= 0
    idx_s = idx.clamp(min=0).to(torch.int64)
    return vals[:, idx_s], has[:, idx_s] & ok[None], tsg[:, idx_s]


def _fold_extreme(x: torch.Tensor, take_max: bool) -> torch.Tensor:
    """jnp.max/jnp.min over the last dim with XLA's bits (NaN propagates,
    -0.0 orders below +0.0; amax/amin keep either zero): the extreme is
    associative, so a pairwise fold gives the sequential reduce's bits."""
    from greptimedb_tpu_torch.parallel.kernels.ring_fold import extreme_plain

    fill = float("-inf" if take_max else "inf")
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.cat([x, torch.full_like(x[..., :1], fill)], dim=-1)
        x = extreme_plain(x[..., 0::2], x[..., 1::2], take_max)
    return x[..., 0]


def window_minmax(vals, has, tsg, hi, num_cells: int, op: str):
    g_vals, g_has, _ = gather_windows(vals, has, tsg, hi, num_cells)
    take_max = op != "min"
    fill = float("-inf" if take_max else "inf")
    out = _fold_extreme(torch.where(g_has, g_vals, fill), take_max)
    present = g_has.any(dim=2)
    return torch.where(present, out, 0.0), present


def window_stdvar(vals, has, tsg, hi, num_cells: int, *,
                  sample_var: bool = False):
    """Population stddev/stdvar over each window (Prometheus semantics).
    Returns (var, stddev, present)."""
    g_vals, g_has, _ = gather_windows(vals, has, tsg, hi, num_cells)
    dt = vals.dtype
    n = g_has.sum(dim=2).to(dt)
    n1 = n.clamp(min=1)
    mean = _window_sum(torch.where(g_has, g_vals, 0.0)) / n1
    dev = torch.where(g_has, g_vals - mean[:, :, None], 0.0)
    denom = (n - 1).clamp(min=1) if sample_var else n1
    var = _window_dot(dev, dev) / denom
    return var, sqrt_rn(var), n > 0


def _small_sort_lanes(x: torch.Tensor, length: int) -> torch.Tensor:
    """Ascending sort along the last dim by an odd-even transposition
    network (the JAX package's sort for windows of up to 16 cells): ~L^2/2
    elementwise exchanges on (S, J) planes. A pair swaps only when out of
    order, NaN last, so equal values (-0.0 and +0.0 too) keep their order,
    as in a stable sort. Pure selections: exact."""
    cols = [x[:, :, i] for i in range(length)]
    for p in range(length):
        for i in range(p % 2, length - 1, 2):
            a, b = cols[i], cols[i + 1]
            a_first = (a <= b) | torch.isnan(b)
            cols[i] = torch.where(a_first, a, b)
            cols[i + 1] = torch.where(a_first, b, a)
    return torch.stack(cols, dim=2)


def _take_lane(sorted_vals: torch.Tensor, idx: torch.Tensor,
               one_hot: bool) -> torch.Tensor:
    """sorted_vals[:, :, idx] per (S, J): a one-hot sum in the JAX package
    (-0.0 comes out +0.0: the gather plus +0.0 here) or take_along_axis."""
    out = torch.gather(sorted_vals, 2, idx.to(torch.int64)[..., None])[..., 0]
    return out + 0.0 if one_hot else out


def _quantile_of_sorted(sorted_vals, n, q, num_cells: int, *,
                        one_hot: bool, fused: bool):
    """The phi-quantile of each window's n ascending values (linear
    interpolation between the ranks around q * (n - 1)); n == 0 gives 0."""
    dt = sorted_vals.dtype
    rank = torch.tensor(q, dtype=dt, device=n.device) * (n - 1).clamp(
        min=0).to(dt)
    lo_i = _f2i(torch.floor(rank)).clamp(0, num_cells - 1)
    hi_i = _f2i(torch.ceil(rank)).clamp(0, num_cells - 1)
    v_lo = _take_lane(sorted_vals, lo_i, one_hot)
    v_hi = _take_lane(sorted_vals, hi_i, one_hot)
    frac = rank - torch.floor(rank)
    # one program contracts v_lo + (v_hi - v_lo) * frac into an fma;
    # separate jnp calls round the product
    if fused:
        out = _fma_f32(v_hi - v_lo, frac, v_lo)
    else:
        out = v_lo + (v_hi - v_lo) * frac
    return torch.where(n > 0, out, 0.0)


def window_quantile(vals, has, tsg, hi, num_cells: int, q):
    """phi-quantile with linear interpolation (Prometheus
    quantile_over_time). Windows of up to 16 cells sort by the
    transposition network, longer ones by a stable sort (the same order:
    NaN last, equal values in cell order); the rank's cells are taken as
    a one-hot sum up to _TAKE_CELLS_MAX_T cells. Returns (out, present);
    the interpolation's fma is XLA:CPU's contraction (both contexts)."""
    g_vals, g_has, _ = gather_windows(vals, has, tsg, hi, num_cells)
    masked = torch.where(g_has, g_vals, float("inf"))
    if num_cells <= 16:
        sorted_vals = _small_sort_lanes(masked, num_cells)
    else:
        sorted_vals = torch.sort(masked, dim=2, stable=True)[0]
    n = g_has.sum(dim=2)
    out = _quantile_of_sorted(sorted_vals, n, q, num_cells,
                              one_hot=num_cells <= _TAKE_CELLS_MAX_T,
                              fused=True)
    return out, n > 0


def window_mad(vals, has, tsg, hi, num_cells: int, *, fused: bool = True):
    """mad_over_time: the median of |x - median| over each window (the
    JAX package's eval_range_function branch: a stable sort and
    take_along_axis for the deviations). `fused`: one XLA program, which
    contracts the interpolation into an fma; the generic engine runs its
    steps as separate calls and rounds the product."""
    med, p = window_quantile(vals, has, tsg, hi, num_cells, 0.5)
    g_vals, g_has, _ = gather_windows(vals, has, tsg, hi, num_cells)
    dev = torch.where(g_has, (g_vals - med[:, :, None]).abs(), float("inf"))
    sorted_dev = torch.sort(dev, dim=2, stable=True)[0]
    n = g_has.sum(dim=2)
    out = _quantile_of_sorted(sorted_dev, n, 0.5, num_cells, one_hot=False,
                              fused=fused)
    return torch.where(p, out, 0.0), p


def window_linear_fit(vals, has, tsg, hi, t_end, num_cells: int, tps, *,
                      fused: bool = True):
    """Least-squares line over each window's samples; t is seconds
    relative to the window end. Returns (slope, intercept_at_end, n).

    XLA:CPU's program, read off its optimized HLO: window sums in
    `_window_sum`'s order, sum(t * v) through `_window_dot`, sum(t * t)
    rounds t * t first; n1 * a - st * b becomes fma(n1, a, -(st * b)) and the
    intercept fma(-slope, st, sv) / n1. t divides by tps (an argument of
    the generic engine's call) or multiplies by its reciprocal (a constant
    of the fused program)."""
    g_vals, g_has, g_ts = gather_windows(vals, has, tsg, hi, num_cells)
    dt = vals.dtype
    t = _div_scalar(g_ts.to(dt) - t_end[None, :, None].to(dt), tps, fused)
    n = _window_sum(g_has.to(dt))
    vz = torch.where(g_has, g_vals, 0.0)
    st = _window_sum(torch.where(g_has, t, 0.0))
    sv = _window_sum(vz)
    stt = _window_sum(torch.where(g_has, t * t, 0.0))
    stv = _window_dot(t, vz)
    n1 = n.clamp(min=1)
    denom = _fma_f32(n1, stt, -(st * st))
    slope = _fma_f32(n1, stv, -(st * sv)) / torch.where(denom == 0, 1.0,
                                                        denom)
    intercept = _fma_f32(-slope, st, sv) / n1
    return slope, intercept, n


def window_holt_winters(vals, has, tsg, hi, num_cells: int, sf, tf):
    """Double exponential smoothing (Prometheus holt_winters: s0 = x0,
    b0 = x1 - x0, then s = sf x + (1 - sf)(s + b), b = tf (s - s_prev) +
    (1 - tf) b), a loop over the window's cells in time order on (S, J)
    planes (the JAX package's lax.scan). 1 - sf and 1 - tf round in
    float32; XLA:CPU contracts the updates into fma(sf, x, (1 - sf)(s +
    b)) and fma(1 - tf, b, tf (s - s_prev)) in both contexts."""
    g_vals, g_has, _ = gather_windows(vals, has, tsg, hi, num_cells)
    dt = vals.dtype
    dev = vals.device
    sf = torch.tensor(sf, dtype=dt, device=dev)
    tf = torch.tensor(tf, dtype=dt, device=dev)
    csf, ctf = 1 - sf, 1 - tf
    shape = g_vals.shape[:2]
    s = torch.zeros(shape, dtype=dt, device=dev)
    b = torch.zeros_like(s)
    x_first = torch.zeros_like(s)
    cnt = torch.zeros(shape, dtype=torch.int32, device=dev)
    # ascending time: cell k = L-1 .. 0 of the window
    for k in range(num_cells - 1, -1, -1):
        x = g_vals[:, :, k]
        present = g_has[:, :, k]
        new_s2 = _fma_f32(sf.expand_as(x), x, csf * (s + b))
        new_b2 = _fma_f32(ctf.expand_as(b), b, tf * (new_s2 - s))
        s_out = torch.where(present, torch.where(cnt <= 1, x, new_s2), s)
        b_out = torch.where(present, torch.where(
            cnt == 0, 0.0, torch.where(cnt == 1, x - x_first, new_b2)), b)
        x_first = torch.where(present & (cnt == 0), x, x_first)
        cnt = cnt + present.to(torch.int32)
        s, b = s_out, b_out
    present = cnt >= 2
    return torch.where(present, s, 0.0), present


# ----------------------------------------------------------------------
# instant (lookback) selection
# ----------------------------------------------------------------------

def instant_lookback(vals, has, tsg, hi, t_end, lookback_ticks: int):
    """Per step, the most recent sample at or before t_end within the
    lookback delta — PromQL instant-vector selection."""
    li = _gather_steps(_last_present_idx(has), hi)
    safe = li.clamp(min=0)
    v = _take_cells(vals, safe)
    t = _take_cells(tsg, safe)
    # int32-safe freshness test: ts <= t_end by construction
    fresh = (t_end[None, :] - t) < lookback_ticks
    present = (li >= 0) & fresh
    return torch.where(present, v, 0.0), present
