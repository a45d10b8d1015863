"""Window functions over (series x time) grids (the JAX package's
ops/window.py, for the range functions the PromQL fast path ports).

- prefix path: window aggregates as differences of per-series prefix sums
  (O(S*T) memory, no per-window gather): sum/count/avg, the extrapolated
  rate family, changes/resets, first/last/idelta/irate.
- gather path: (S, J, L) window tensors gathered L cells per output step:
  min/max and stddev/stdvar.

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
- reductions over a window's L cells add sequentially from 0 (XLA:CPU's
  order for these small reductions); a sum of squares takes one fma per
  step, as LLVM contracts XLA:CPU's fused multiply-reduce (`_fma_f32`).
- a division by a compile-time constant of the JAX program (the grid's
  ticks per second, a rate's range in seconds) is a multiplication by the
  constant's float32 reciprocal there (XLA's algebraic simplifier rewrites
  x / C to x * (1 / C), constant folding included); `_div_const` does the
  same.
"""

from __future__ import annotations

import torch

_CUMSUM_BLOCK = 16


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


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root, as XLA:CPU's (torch's CPU
    kernel can be one ulp off): the float64 root rounds to the right
    float32."""
    return torch.sqrt(x.double()).to(x.dtype)


def _seq_sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim, added sequentially from 0."""
    acc = torch.zeros_like(x[..., 0])
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _fma_f32(a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor) -> torch.Tensor:
    """float32 fma(a, b, c) with one rounding, as LLVM contracts XLA:CPU's
    fused multiply-reduce. a * b is exact in float64; the float64 sum is
    rounded to odd (Knuth's two-sum gives its exact error), so the final
    rounding to float32 is the single correct one."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    s = torch.where((err != 0) & even,
                    torch.nextafter(s, torch.where(err > 0, float("inf"),
                                                   float("-inf")).double()),
                    s)
    return s.float()


def _seq_sum_sq_last(x: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the last dim: sequential from 0, each step one
    fma (XLA:CPU fuses the square into the reduction)."""
    acc = torch.zeros_like(x[..., 0])
    for i in range(x.shape[-1]):
        acc = _fma_f32(x[..., i], x[..., i], acc)
    return acc


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
    (S, J) idx -> (S, J)."""
    if idx.dim() == 1:
        return arr[:, idx.to(torch.int64)]
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
                      is_counter: bool, is_rate: bool):
    """Prometheus rate/increase/delta with the extrapolation rules of
    functions.go. Returns (value, present) shaped (S, J)."""
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
    dur_start = _div_const(t_first - (t_end_f - rt), tps)
    dur_end = _div_const(t_end_f - t_last, tps)
    sampled = _div_const(t_last - t_first, tps)
    avg_dur = sampled / (cnt - 1).clamp(min=1)

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
        # in float64 under jax_enable_x64 (as the JAX package's tests run
        # it), so the divisor is float32(range_ticks / tps). Without x64
        # XLA folds float32(range_ticks) * (1 / tps) instead, which can
        # move the divisor, and the rate, by one ulp (ROADMAP C).
        out = _div_const(out, range_ticks / tps)
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


def window_minmax(vals, has, tsg, hi, num_cells: int, op: str):
    g_vals, g_has, _ = gather_windows(vals, has, tsg, hi, num_cells)
    if op == "min":
        out = torch.where(g_has, g_vals, float("inf")).amin(dim=2)
    else:
        out = torch.where(g_has, g_vals, float("-inf")).amax(dim=2)
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
    mean = _seq_sum_last(torch.where(g_has, g_vals, 0.0)) / n1
    dev = torch.where(g_has, g_vals - mean[:, :, None], 0.0)
    denom = (n - 1).clamp(min=1) if sample_var else n1
    var = _seq_sum_sq_last(dev) / denom
    return var, sqrt_f32(var), n > 0


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
