"""SQL window functions over the host row source (the JAX package's
query/window_fns.py).

Semantics implemented (SQL default frames):
- no ORDER BY in the spec  -> whole-partition value broadcast
- ORDER BY present         -> RANGE UNBOUNDED PRECEDING..CURRENT ROW
  (running aggregate; peer rows — ties on the order keys — share the
  frame end, so they share the value)
- explicit frames: "... UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING"
  (whole partition), "RANGE ... UNBOUNDED PRECEDING AND CURRENT ROW"
  (peer-shared running), "ROWS ... UNBOUNDED PRECEDING AND CURRENT ROW"
  (strictly per-row running), "ROWS BETWEEN k PRECEDING AND CURRENT ROW"
  (sliding); anything else raises.

Ranking (row_number/rank/dense_rank) and offset (lag/lead,
first_value/last_value) functions follow the standard definitions.

Where the work runs, as in the JAX package: ranks, offsets, whole-
partition frames and anything below DEVICE_THRESHOLD rows stay host
numpy. From DEVICE_THRESHOLD rows the running aggregates run as
segmented scans (ops/segment.py, kernel S on a card) on the engine's
device: float64 and int64 scans with x64, two-float compensated scans
and int32 counts without it. ROWS k PRECEDING sum/count/avg with x64
runs over the shards of the process-wide mesh (parallel/mesh.configure),
every shard on the engine's device. The engine's `x64` flag and device
travel in a WindowCtx, which also records the path taken ("host",
"device" or "device_mesh": the JAX package's exec_path_window note).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np
import torch

from greptimedb_tpu_torch.errors import PlanError, UnsupportedError
from greptimedb_tpu_torch.query import stats
from greptimedb_tpu_torch.query.expr import Col, eval_const, eval_expr
from greptimedb_tpu_torch.query.readback import read_full
from greptimedb_tpu_torch.sql import ast as A


@dataclass
class WindowCtx:
    """What a query's window calls run with: the engine's device and x64
    mode; `path` is the last path a running or sliding frame took (None
    until one ran)."""

    device: torch.device
    x64: bool = False
    path: str | None = None


WINDOW_ONLY_FUNCS = {
    "row_number", "rank", "dense_rank", "ntile", "lag", "lead",
    "first_value", "last_value", "nth_value", "percent_rank",
    "cume_dist",
}
_AGG_OVER = {"sum", "count", "avg", "mean", "min", "max"}


def collect_window_calls(e: A.Expr, out: list | None = None) -> list:
    """All FuncCall nodes with an OVER clause, in depth-first order."""
    if out is None:
        out = []
    if isinstance(e, A.FuncCall):
        if e.over is not None:
            out.append(e)
        for a in e.args:
            collect_window_calls(a, out)
    elif isinstance(e, A.BinaryOp):
        collect_window_calls(e.left, out)
        collect_window_calls(e.right, out)
    elif isinstance(e, (A.UnaryOp, A.Cast)):
        collect_window_calls(e.operand, out)
    elif isinstance(e, A.Between):
        for x in (e.operand, e.low, e.high):
            collect_window_calls(x, out)
    elif isinstance(e, A.InList):
        collect_window_calls(e.operand, out)
        for x in e.items:
            collect_window_calls(x, out)
    elif isinstance(e, A.IsNull):
        collect_window_calls(e.operand, out)
    elif isinstance(e, A.Case):
        if e.operand:
            collect_window_calls(e.operand, out)
        for c, t in e.whens:
            collect_window_calls(c, out)
            collect_window_calls(t, out)
        if e.else_:
            collect_window_calls(e.else_, out)
    return out


def replace_window_calls(e: A.Expr, mapping: dict) -> A.Expr:
    """Structurally replace window FuncCalls (by identity) with Columns."""
    if id(e) in mapping:
        return A.Column(mapping[id(e)])
    if isinstance(e, A.FuncCall):
        return A.FuncCall(
            e.name, [replace_window_calls(a, mapping) for a in e.args],
            distinct=e.distinct, order_by=e.order_by,
        )
    if isinstance(e, A.BinaryOp):
        return A.BinaryOp(e.op, replace_window_calls(e.left, mapping),
                          replace_window_calls(e.right, mapping))
    if isinstance(e, A.UnaryOp):
        return A.UnaryOp(e.op, replace_window_calls(e.operand, mapping))
    if isinstance(e, A.Cast):
        return A.Cast(replace_window_calls(e.operand, mapping), e.to)
    if isinstance(e, A.Between):
        return A.Between(replace_window_calls(e.operand, mapping),
                         replace_window_calls(e.low, mapping),
                         replace_window_calls(e.high, mapping),
                         e.negated)
    if isinstance(e, A.InList):
        return A.InList(replace_window_calls(e.operand, mapping),
                        [replace_window_calls(x, mapping) for x in e.items],
                        e.negated)
    if isinstance(e, A.IsNull):
        return A.IsNull(replace_window_calls(e.operand, mapping),
                        e.negated)
    if isinstance(e, A.Case):
        return A.Case(
            replace_window_calls(e.operand, mapping) if e.operand else None,
            [(replace_window_calls(c, mapping),
              replace_window_calls(t, mapping)) for c, t in e.whens],
            replace_window_calls(e.else_, mapping) if e.else_ else None,
        )
    return e


def _frame_mode(spec: A.WindowSpec) -> tuple[str, int | None]:
    """-> (mode, k): 'running' (RANGE: peers share the frame end) |
    'running_rows' (ROWS: strictly per-row) | 'whole' |
    'rows_pre' (ROWS BETWEEN k PRECEDING AND CURRENT ROW, k in slot)."""
    if spec.frame is None:
        return ("running" if spec.order_by else "whole"), None
    text = spec.frame.upper()
    body = text.split("BETWEEN", 1)[-1].strip()
    if body == "UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING":
        return "whole", None
    if body == "UNBOUNDED PRECEDING AND CURRENT ROW":
        if not spec.order_by:
            return "whole", None
        return ("running_rows" if text.startswith("ROWS")
                else "running"), None
    m = re.fullmatch(r"(\d+)\s+PRECEDING\s+AND\s+CURRENT\s+ROW", body)
    if m and text.startswith("ROWS"):
        return "rows_pre", int(m.group(1))
    if "BETWEEN" not in text:
        # shorthand: 'ROWS k PRECEDING' == BETWEEN k PRECEDING AND
        # CURRENT ROW (SQL standard default frame end). Without BETWEEN
        # the split above kept the ROWS/RANGE keyword — strip it.
        short = re.sub(r"^(ROWS|RANGE)\s+", "", body)
        m = re.fullmatch(r"(\d+)\s+PRECEDING", short)
        if m and text.startswith("ROWS"):
            return "rows_pre", int(m.group(1))
        if short == "UNBOUNDED PRECEDING":
            if not spec.order_by:
                return "whole", None
            return ("running_rows" if text.startswith("ROWS")
                    else "running"), None
    raise UnsupportedError(f"window frame not supported: {spec.frame}")


def _key_codes(col: Col) -> np.ndarray:
    """Column -> dense int codes (nulls get their own code)."""
    vals = col.values
    if vals.dtype == object:
        vals = np.asarray([str(v) for v in vals], object)
    _, codes = np.unique(vals, return_inverse=True)
    if col.validity is not None:
        codes = np.where(col.valid_mask, codes, -1)
    return codes.astype(np.int64)


def eval_window(fc: A.FuncCall, src, ctx: WindowCtx) -> Col:
    """Evaluate one window call over the full row source; the running
    scans and the sharded frames run on ctx.device, and ctx.path records
    the path they took."""
    spec = fc.over
    n = src.num_rows
    if n == 0:
        return Col(np.zeros(0))
    mode, frame_k = _frame_mode(spec)

    # ---- partition ids + intra-partition order ------------------------
    part_keys = [_key_codes(eval_expr(p, src)) for p in spec.partition_by]
    if part_keys:
        stacked = np.stack(part_keys, axis=1)
        _, pid = np.unique(stacked, axis=0, return_inverse=True)
    else:
        pid = np.zeros(n, np.int64)

    order_cols = [eval_expr(o.expr, src) for o in spec.order_by]
    from greptimedb_tpu_torch.query.executor import _sort_indices

    # partition most-significant, then the ORDER BY keys with SQL null
    # placement; _sort_indices' lexsort is stable, so equal keys keep
    # row order (deterministic)
    order = _sort_indices(
        order_cols,
        [o.asc for o in spec.order_by],
        [o.nulls_first for o in spec.order_by],
        primary=pid,
    )
    # positions: order[i] = original row index of the i-th ordered row
    opid = pid[order]
    part_start = np.zeros(n, dtype=bool)
    part_start[0] = True
    part_start[1:] = opid[1:] != opid[:-1]

    # peer boundaries: a change in any order key OR its null-ness
    if order_cols:
        peer_start = part_start.copy()
        for col in order_cols:
            codes = np.where(col.valid_mask, _sortable(col), 0)[order]
            nulls = (~col.valid_mask)[order]
            peer_start[1:] |= (codes[1:] != codes[:-1]) | (
                nulls[1:] != nulls[:-1]
            )
    else:
        peer_start = part_start.copy()

    out_ordered, validity_ordered = _dispatch(
        fc, src, mode, order, part_start, peer_start, n, ctx,
        frame_k=frame_k,
    )
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    values = out_ordered[inv]
    validity = None if validity_ordered is None else validity_ordered[inv]
    return Col(values, validity)


def _sortable(col: Col) -> np.ndarray:
    """Order-preserving codes for peer detection. Integers stay int64
    (a float cast would merge distinct keys above 2^53)."""
    vals = col.values
    if vals.dtype == object:
        _, codes = np.unique(
            np.asarray([str(v) for v in vals], object), return_inverse=True
        )
        return codes.astype(np.int64)
    if vals.dtype == np.bool_ or vals.dtype.kind in "iu":
        return vals.astype(np.int64)
    return vals


def _partition_index(part_start: np.ndarray) -> np.ndarray:
    """ordered-position -> index within its partition (0-based)."""
    n = len(part_start)
    idx = np.arange(n)
    start_idx = np.maximum.accumulate(np.where(part_start, idx, 0))
    return idx - start_idx


def _dispatch(fc, src, mode, order, part_start, peer_start, n, ctx, *,
              frame_k: int | None = None):
    name = fc.name
    within = _partition_index(part_start)
    part_id = np.cumsum(part_start) - 1

    if name == "row_number":
        return within + 1, None
    if name in ("rank", "dense_rank", "percent_rank", "cume_dist"):
        peer_id = np.cumsum(peer_start) - 1
        # rank: 1 + number of rows before the peer group, per partition
        first_of_peer = np.where(peer_start)[0]
        rank_at_peer = within[first_of_peer] + 1
        rank = rank_at_peer[peer_id]
        if name == "rank":
            return rank, None
        if name == "dense_rank":
            # peer index minus the partition's first peer index, +1
            # (peer_id is nondecreasing, so a running max of the values
            # pinned at partition starts broadcasts each partition's
            # first peer id)
            part_first_peer = np.maximum.accumulate(
                np.where(part_start, peer_id, 0)
            )
            return peer_id - part_first_peer + 1, None
        part_sizes = np.bincount(part_id, minlength=int(part_id.max()) + 1)
        size = part_sizes[part_id].astype(np.float64)
        if name == "percent_rank":
            return np.where(size > 1, (rank - 1) / np.maximum(size - 1, 1),
                            0.0), None
        # cume_dist: peers count to the END of the peer group
        peer_id2 = np.cumsum(peer_start) - 1
        last_of_peer = np.zeros(int(peer_id2.max()) + 1, np.int64)
        np.maximum.at(last_of_peer, peer_id2, within)
        return (last_of_peer[peer_id2] + 1) / size, None

    if name == "ntile":
        if not fc.args:
            raise PlanError("ntile(k) needs an argument")
        k = int(eval_const(fc.args[0]))
        if k <= 0:
            raise PlanError("ntile(k): k must be positive")
        part_sizes = np.bincount(part_id, minlength=int(part_id.max()) + 1)
        size = part_sizes[part_id]
        return (within * k // np.maximum(size, 1)) + 1, None

    if name in ("lag", "lead"):
        col = eval_expr(fc.args[0], src)
        offset = 1
        default = None
        if len(fc.args) > 1:
            offset = int(eval_const(fc.args[1]))
        if len(fc.args) > 2:
            default = eval_const(fc.args[2])
        vals = col.values[order]
        valid = col.valid_mask[order]
        shift = offset if name == "lag" else -offset
        out = np.empty_like(vals)
        ok = np.zeros(n, dtype=bool)
        idx = np.arange(n)
        src_idx = idx - shift
        in_range = (src_idx >= 0) & (src_idx < n)
        same_part = np.zeros(n, dtype=bool)
        part_id_arr = part_id
        sel = in_range.copy()
        sel[in_range] = (
            part_id_arr[src_idx[in_range]] == part_id_arr[idx[in_range]]
        )
        out[sel] = vals[src_idx[sel]]
        ok[sel] = valid[src_idx[sel]]
        if default is not None:
            fillable = ~sel
            if vals.dtype == object:
                out[fillable] = str(default)
            else:
                out[fillable] = default
            ok[fillable] = True
        return out, ok

    if name in ("first_value", "last_value", "nth_value"):
        col = eval_expr(fc.args[0], src)
        vals = col.values[order]
        valid = col.valid_mask[order]
        first_pos = np.maximum.accumulate(
            np.where(part_start, np.arange(n), 0)
        )
        if mode == "rows_pre":
            # frame = [max(i - k, partition start), i]
            fs = np.maximum(np.arange(n) - frame_k, first_pos)
            if name == "first_value":
                return vals[fs], valid[fs]
            if name == "last_value":
                return vals, valid
            k2 = int(eval_const(fc.args[1])) - 1
            # membership BEFORE clamping: a frame with < N rows is NULL
            ok = (fs + k2) <= np.arange(n)
            pos = np.minimum(fs + k2, n - 1)
            return vals[pos], ok & valid[pos]
        if name == "first_value":
            return vals[first_pos], valid[first_pos]
        if name == "nth_value":
            k = int(eval_const(fc.args[1])) - 1
            pos = np.minimum(first_pos + k, n - 1)
            within_arr = _partition_index(part_start)
            if mode in ("running", "running_rows"):
                # NULL until the frame has reached the k-th row
                ok = within_arr >= k
            else:
                part_sizes = np.bincount(
                    part_id, minlength=int(part_id.max()) + 1
                )
                ok = part_sizes[part_id] > k
            return vals[pos], ok & valid[pos]
        if mode == "running_rows":
            # ROWS frame: the frame ends exactly at the current row
            return vals, valid
        # last_value: running frame -> end of the current PEER group
        # (ties on the order keys share the frame end); whole ->
        # partition last
        if mode == "running":
            peer_id = np.cumsum(peer_start) - 1
            last_of_peer = np.zeros(int(peer_id.max()) + 1, np.int64)
            np.maximum.at(last_of_peer, peer_id, np.arange(n))
            pos = last_of_peer[peer_id]
            return vals[pos], valid[pos]
        last_pos = _part_last(part_start, n)
        return vals[last_pos], valid[last_pos]

    if name in _AGG_OVER:
        if name == "count" and (
            not fc.args or isinstance(fc.args[0], A.Star)
        ):
            col = Col(np.ones(n, np.int64))
        else:
            col = eval_expr(fc.args[0], src)
        vals = col.values[order]
        valid = col.valid_mask[order]
        return _agg_over(name, vals, valid, mode, part_start, peer_start,
                         part_id, n, ctx, frame_k=frame_k)

    raise UnsupportedError(f"window function {name!r} not supported")


def _part_last(part_start: np.ndarray, n: int) -> np.ndarray:
    """ordered-position -> position of the LAST row of its partition."""
    ends = np.empty(n, np.int64)
    starts = np.where(part_start)[0]
    bounds = np.append(starts[1:], n) - 1
    ends[:] = np.repeat(bounds, np.diff(np.append(starts, n)))
    return ends


# rows at/above this run the running scans on the device (segmented
# associative scans, ops/segment.py); below it host numpy wins on
# dispatch latency
DEVICE_THRESHOLD = 262_144


def _split_two_float(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """f64 -> (hi, lo) f32 pair with hi + lo == x to f32-pair precision.
    Non-finite values keep hi and a zero low part (inf - inf is NaN)."""
    hi = x.astype(np.float32)
    with np.errstate(invalid="ignore"):
        lo = np.where(
            np.isfinite(hi), x - hi.astype(np.float64), 0.0
        ).astype(np.float32)
    return hi, lo


def _running_scans(numeric, cnt, valid, part_start, name, n,
                   ctx: WindowCtx):
    """(run_sum, run_cnt, run_minmax|None, path) — running aggregates
    within partitions, on ctx.device for large inputs.

    Without x64 the device path runs Neumaier-compensated / two-float f32
    segmented scans: sums carry a compensation slot, min/max compare
    (hi, lo) pairs, counts are exact int32 — results match the host f64
    path to ~1 ulp. With x64 it runs float64 and int64 scans."""
    want_mm = name in ("min", "max")
    use_device = n >= DEVICE_THRESHOLD
    x64 = ctx.x64 if use_device else False
    if use_device and not x64:
        # no-x64 guard: every input finite (inf would make the combine's
        # error term inf - inf = NaN; NaN inputs stay host because the
        # host path's global-cumsum NaN smear is the comparison
        # baseline) AND no possible f32 overflow of any running sum
        # (bounded by n * max|value|)
        max_abs = float(np.abs(numeric).max()) if n else 0.0
        use_device = (bool(np.isfinite(numeric).all())
                      and n * max_abs < 3.0e38)
    if use_device:
        from greptimedb_tpu_torch.ops import segment as S

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(ctx.device)

        masked = None
        if want_mm:
            masked = np.where(valid, numeric,
                              -np.inf if name == "max" else np.inf)
        with stats.timed("window_device_ms"):
            d_reset = up(part_start)
            if x64:
                run_sum = read_full(S.segmented_cumsum(up(numeric), d_reset))
                run_cnt = read_full(S.segmented_cumsum(
                    up(cnt.astype(np.int64)), d_reset))
                run_mm = None
                if want_mm:
                    run_mm = read_full(S.segmented_cumextreme(
                        up(masked), d_reset, take_max=name == "max"))
            else:
                v_hi, v_lo = _split_two_float(numeric)
                packed = read_full(S.segmented_cumsum_compensated_packed(
                    up(v_hi), up(v_lo), d_reset), np.float64)
                run_sum = packed[0] + packed[1]
                # row counts fit int32 exactly (n < 2^31)
                run_cnt = read_full(S.segmented_cumsum(
                    up(cnt.astype(np.int32)), d_reset)).astype(np.int64)
                run_mm = None
                if want_mm:
                    m_hi, m_lo = _split_two_float(masked)
                    h, low = S.segmented_cumextreme2(
                        up(m_hi), up(m_lo), d_reset, take_max=name == "max")
                    run_mm = (read_full(h, np.float64)
                              + read_full(low, np.float64))
        ctx.path = "device"
        stats.note("exec_path_window", "device")
        return run_sum, run_cnt, run_mm, "device"
    csum = np.cumsum(numeric)
    ccnt = np.cumsum(cnt)
    starts = np.where(part_start)[0]
    base_sum = np.repeat(
        np.append(0.0, csum[starts[1:] - 1]),
        np.diff(np.append(starts, n)),
    )
    base_cnt = np.repeat(
        np.append(0, ccnt[starts[1:] - 1]),
        np.diff(np.append(starts, n)),
    )
    run_mm = None
    if want_mm:
        masked = np.where(valid, numeric,
                          -np.inf if name == "max" else np.inf)
        op = np.maximum if name == "max" else np.minimum
        run_mm = np.empty(n)
        for s, e in zip(starts, np.append(starts[1:], n)):
            run_mm[s:e] = op.accumulate(masked[s:e])
    ctx.path = "host"
    stats.note("exec_path_window", "host")
    return csum - base_sum, ccnt - base_cnt, run_mm, "host"


def _agg_over(name, vals, valid, mode, part_start, peer_start, part_id, n,
              ctx: WindowCtx, *, frame_k: int | None = None):
    numeric = np.where(valid, vals.astype(np.float64, copy=False), 0.0) \
        if vals.dtype != object else None
    if numeric is None:
        raise PlanError(f"{name}() over string column")
    cnt = valid.astype(np.int64)
    if mode == "whole":
        nparts = int(part_id.max()) + 1
        if name in ("sum", "avg", "mean", "count"):
            s = np.bincount(part_id, weights=numeric, minlength=nparts)
            c = np.bincount(part_id, weights=cnt, minlength=nparts)
            if name == "count":
                return c[part_id].astype(np.int64), None
            out = s[part_id]
            if name in ("avg", "mean"):
                out = out / np.maximum(c[part_id], 1)
            return out, (c[part_id] > 0)
        red = np.full(nparts, -np.inf if name == "max" else np.inf)
        op = np.maximum if name == "max" else np.minimum
        masked = np.where(valid, numeric,
                          -np.inf if name == "max" else np.inf)
        getattr(op, "at")(red, part_id, masked)
        c = np.bincount(part_id, weights=cnt, minlength=nparts)
        return red[part_id], (c[part_id] > 0)
    if mode == "rows_pre":
        return _agg_rows_pre(name, numeric, cnt, valid, part_start, n,
                             frame_k, ctx)
    # running: cumulative within partition, then peers share the value at
    # the END of their peer group (SQL default RANGE frame)
    run_sum, run_cnt, run_mm, _path = _running_scans(
        numeric, cnt, valid, part_start, name, n, ctx
    )
    if name in ("min", "max"):
        run = run_mm
    elif name == "count":
        run = run_cnt
    elif name in ("avg", "mean"):
        run = run_sum / np.maximum(run_cnt, 1)
    else:
        run = run_sum
    if mode == "running_rows":
        # ROWS frame: strictly per-row, no peer sharing
        if name == "count":
            return run_cnt.astype(np.int64), None
        return run, (run_cnt > 0)
    # peers share the frame end: broadcast the value at each peer
    # group's last row back over the group
    peer_id = np.cumsum(peer_start) - 1
    npeers = int(peer_id.max()) + 1
    last_of_peer = np.zeros(npeers, np.int64)
    np.maximum.at(last_of_peer, peer_id, np.arange(n))
    run = run[last_of_peer[peer_id]]
    run_cnt_b = run_cnt[last_of_peer[peer_id]]
    if name == "count":
        return run.astype(np.int64), None
    return run, (run_cnt_b > 0)


_ROWS_PRE_MAX_HALO = 4096  # halo cells shipped per shard boundary


def _rows_pre_halo_program(x: torch.Tensor, cnt: torch.Tensor,
                           fs: torch.Tensor, ns: int, k: int):
    """The sliding-frame program over ns row shards: each shard prepends
    the previous shard's k-row tail (halo_prev_1d) so frames crossing the
    shard boundary stay local, then computes the frame sum/count by local
    f64 prefix-sum difference, its cumsum in XLA:CPU's order
    (ops/window._xla_cumsum). The halo is the only traffic between
    shards. Returns the (sum, count) shards in shard order."""
    from greptimedb_tpu_torch.ops.window import _xla_cumsum
    from greptimedb_tpu_torch.parallel.dist import halo_prev_1d

    n_loc = x.numel() // ns
    xs, cs, fss = (list(t.split(n_loc)) for t in (x, cnt, fs))
    hx = halo_prev_1d(xs, k, fill=0.0)
    hc = halo_prev_1d(cs, k, fill=0.0)
    end = torch.arange(n_loc, dtype=torch.int32, device=x.device) + k
    out_s, out_c = [], []
    for s in range(ns):
        cx = _xla_cumsum(hx[s][None, :])[0]
        cc = _xla_cumsum(hc[s][None, :])[0]
        # frame start in halo'd coords; the first shard's halo is
        # zero-filled and fs >= 0, so it never leaks into a frame
        rel = torch.minimum(torch.clamp(fss[s] - s * n_loc + k, min=0), end)
        prev = (rel - 1).long()
        w_sum = cx[end.long()] - torch.where(rel > 0, cx[prev], 0.0)
        w_cnt = cc[end.long()] - torch.where(rel > 0, cc[prev], 0.0)
        out_s.append(w_sum)
        out_c.append(w_cnt)
    return out_s, out_c


def _rows_pre_sharded(name, numeric, cnt, fs, n, k: int, ctx: WindowCtx):
    """Mesh path for ROWS k PRECEDING sum/count/avg, or None when the
    process-wide mesh / query shape doesn't qualify."""
    if name not in ("sum", "avg", "mean", "count"):
        return None
    if k < 1 or k > _ROWS_PRE_MAX_HALO or not ctx.x64:
        return None
    from greptimedb_tpu_torch.parallel.mesh import (
        global_mesh, global_mesh_opts, shard_count,
    )
    from greptimedb_tpu_torch.query import planner
    from greptimedb_tpu_torch.query.readback import read_gathered

    mesh = global_mesh()
    ns = shard_count(mesh)
    if ns <= 1:
        return None
    if n < DEVICE_THRESHOLD:
        # below the device-execution floor the host path wins regardless
        # of the operator's shard threshold
        return None
    if not np.isfinite(numeric).all():
        # non-finite values stay on the host baseline: its global-cumsum
        # NaN/inf smear is the established comparison semantics (same
        # guard as _running_scans' no-x64 path), while per-shard cumsums
        # would localize the smear to one shard
        return None
    n_pad = -(-n // ns) * ns
    if k > n_pad // ns:
        # a frame would reach past the previous shard, whose tail is the
        # only halo: the host path answers
        return None
    dec = planner.decide_mesh_execution(
        mesh, kind="window", rows=n, opts=global_mesh_opts(),
    )
    planner.record_mesh_decision(dec, "window")
    if not dec.shard:
        return None
    pad = n_pad - n
    x = np.pad(numeric, (0, pad))
    c = np.pad(cnt.astype(np.float64), (0, pad))
    # padded rows: empty frame (fs == own index -> w spans one 0 cell)
    fs_p = np.pad(fs, (0, pad), constant_values=0).astype(np.int32)
    if pad:
        fs_p[n:] = np.arange(n, n_pad, dtype=np.int32)

    def up(a):
        return torch.from_numpy(a).to(ctx.device)

    with stats.timed("window_device_ms"):
        w_sum, w_cnt = _rows_pre_halo_program(up(x), up(c), up(fs_p), ns, k)
        w_sum = read_gathered(w_sum)[:n]
        w_cnt = read_gathered(w_cnt)[:n]
    ctx.path = "device_mesh"
    stats.note("exec_path_window", "device_mesh")
    if name == "count":
        return w_cnt.astype(np.int64), None
    if name in ("avg", "mean"):
        return w_sum / np.maximum(w_cnt, 1), (w_cnt > 0)
    return w_sum, (w_cnt > 0)


def _agg_rows_pre(name, numeric, cnt, valid, part_start, n, k: int,
                  ctx: WindowCtx):
    """ROWS BETWEEN k PRECEDING AND CURRENT ROW: sliding frames via
    prefix-sum differences (sum/count/avg) or a windowed reduce
    (min/max); decomposable frames run row-sharded over the process-
    wide mesh (halo exchange covers frames crossing shard boundaries)."""
    start_idx = np.maximum.accumulate(
        np.where(part_start, np.arange(n), 0)
    )
    fs = np.maximum(np.arange(n) - k, start_idx)  # frame start
    sharded = _rows_pre_sharded(name, numeric, cnt, fs, n, k, ctx)
    if sharded is not None:
        return sharded
    if name in ("sum", "avg", "mean", "count"):
        csum = np.cumsum(numeric)
        ccnt = np.cumsum(cnt)
        # window = csum[i] - csum[fs-1] (fs==0 -> 0)
        prev = fs - 1
        base_s = np.where(prev >= 0, csum[np.maximum(prev, 0)], 0.0)
        base_c = np.where(prev >= 0, ccnt[np.maximum(prev, 0)], 0)
        w_sum = csum - base_s
        w_cnt = ccnt - base_c
        if name == "count":
            return w_cnt.astype(np.int64), None
        if name in ("avg", "mean"):
            return w_sum / np.maximum(w_cnt, 1), (w_cnt > 0)
        return w_sum, (w_cnt > 0)
    if name in ("min", "max"):
        ident = -np.inf if name == "max" else np.inf
        masked = np.where(valid, numeric, ident)
        # windowed reduce over k+1 trailing positions, partition-
        # clipped; processed in row chunks so peak memory is bounded at
        # chunk*(k+1) elements instead of n*(k+1)
        pad = np.concatenate([np.full(k, ident), masked])
        out = np.empty(n)
        chunk = max(1, (1 << 22) // (k + 1))
        offs = np.arange(-k, 1)[None, :]
        for s in range(0, n, chunk):
            e = min(s + chunk, n)
            win = np.lib.stride_tricks.sliding_window_view(
                pad[s:e + k], k + 1
            )
            rel = offs + np.arange(s, e)[:, None]
            w = np.where(rel >= fs[s:e, None], win, ident)
            out[s:e] = w.max(axis=1) if name == "max" else w.min(axis=1)
        # validity: any valid row inside the frame
        ccnt = np.cumsum(cnt)
        prev = fs - 1
        base_c = np.where(prev >= 0, ccnt[np.maximum(prev, 0)], 0)
        return out, (ccnt - base_c > 0)
    raise UnsupportedError(
        f"{name}() with a ROWS k PRECEDING frame is not supported"
    )
