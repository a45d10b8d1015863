"""Device-resident accumulable flow state (the JAX package's
flow/device_state.py on torch).

Per-group accumulators live as dense tensors on the flow's device, indexed
by group id. A delta batch folds into them through the grouped reduce G
(parallel/kernels/grouped_reduce.py, one row block over the state's
capacity): every float segment sum, every float and int32 segment min/max.
G adds each segment's rows in row order from 0 and folds extremes with
XLA's maximum/minimum bits, as XLA:CPU's scatter does in the JAX package's
one-program apply; the int32 counts take index_add_ (integer adds are
exact in any order). A tick finalizes every group in one pass and gathers
the dirty slice on the device before the readback.

Supported accumulators: count, sum, mean, min, max, var_pop/var_samp/
stddev_pop/stddev_samp (s, s2, n partials), first_value/last_value over
numeric fields. Flows using count_distinct or string-valued aggregates
stay on the host path (flow/manager.py).

The float slots are float32, or float64 in x64 mode (the JAX package's
jax_enable_x64; `Standalone(x64=...)`). Counts and presence live in exact
int32 slots, running float sums carry a Neumaier compensation slot, and
first/last winners order by timestamps split into two int32 halves
(hi = ts >> 20, lo = ts & 0xfffff; negative timestamps demote the flow to
the host path). Equal-timestamp ties resolve by arrival order within a
batch and by host accumulator semantics across batches.

Bit order against the JAX package's programs, read off XLA:CPU's optimized
HLO and object code in both modes: the apply's scatters take their updates
materialized (vk * vk is not contracted into the segment sum), the batch
mean is a true division, and the finalize's variance is one fma,
fnmadd(mean, mean, s2 / n1); sqrt is correctly rounded.

Group ids are interned on the host (a Dictionary per key column); state
tensors grow by power-of-two capacity, and expired groups compact by
gathering live rows into fresh tensors. A state tuple is never written in
place: apply and expiry build new tensors, so a snapshot taken for a tick
stays intact while later deltas fold in.
"""

from __future__ import annotations

import numpy as np
import torch

from greptimedb_tpu_torch.datatypes.batch import Dictionary
from greptimedb_tpu_torch.device import resolve_device
from greptimedb_tpu_torch.ops import window as W
from greptimedb_tpu_torch.parallel.kernels import grouped_reduce as gr
from greptimedb_tpu_torch.parallel.kernels.ring_fold import extreme_plain

# ops the device path accumulates; everything else -> host fallback
DEVICE_OPS = frozenset({
    "count", "sum", "mean", "min", "max",
    "var_pop", "var_samp", "stddev_pop", "stddev_samp",
    "first_value", "last_value",
})

_IMAX = np.int32(2**31 - 1)

# state slots per op: name -> ((kind, identity), ...); kind "f" is the
# state's float dtype, "i" is exact int32. The float after a sum is its
# Neumaier compensation term.
_SLOTS = {
    "count": (("i", 0),),
    "sum": (("f", 0.0), ("f", 0.0), ("i", 0)),          # s, comp, n
    "mean": (("f", 0.0), ("f", 0.0), ("i", 0)),         # s, comp, n
    "min": (("f", np.inf), ("i", 0)),
    "max": (("f", -np.inf), ("i", 0)),
    # k (per-group shift), s, comp, s2, comp2, n: sum(v-k) and
    # sum((v-k)^2) around a shift fixed at the group's first batch
    "var_pop": (("f", 0.0), ("f", 0.0), ("f", 0.0), ("f", 0.0),
                ("f", 0.0), ("i", 0)),
    "var_samp": (("f", 0.0), ("f", 0.0), ("f", 0.0), ("f", 0.0),
                 ("f", 0.0), ("i", 0)),
    "stddev_pop": (("f", 0.0), ("f", 0.0), ("f", 0.0), ("f", 0.0),
                   ("f", 0.0), ("i", 0)),
    "stddev_samp": (("f", 0.0), ("f", 0.0), ("f", 0.0), ("f", 0.0),
                    ("f", 0.0), ("i", 0)),
    # v, ts_hi, ts_lo; sentinel hi=IMAX (first) / -1 (last) means "empty"
    "first_value": (("f", 0.0), ("i", _IMAX), ("i", _IMAX)),
    "last_value": (("f", 0.0), ("i", -1), ("i", -1)),
}

_VAR_OPS = ("var_pop", "var_samp", "stddev_pop", "stddev_samp")


def plan_supports_device(plan) -> bool:
    return all(a.op in DEVICE_OPS for a in plan.aggs)


def _ts_split(ts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Epoch-ms -> exact (hi, lo) int32 pair; requires ts >= 0."""
    ts64 = ts.astype(np.int64)
    return ((ts64 >> 20).astype(np.int32),
            (ts64 & 0xFFFFF).astype(np.int32))


def _kahan_fold(s, c, d):
    """Neumaier-compensated s += d: absorbs additions the raw float sum
    would round away, whichever of s and d is larger."""
    t = s + d
    c = c + torch.where(s.abs() >= d.abs(), (s - t) + d, (d - t) + s)
    return t, c


def _apply(state: tuple, gid: torch.Tensor, ts_hi: torch.Tensor,
           ts_lo: torch.Tensor, vals: torch.Tensor, has: torch.Tensor,
           all_valid: list[bool], *, ops: tuple, g: int) -> tuple:
    """Fold one delta batch into the state tensors; returns a new tuple.

    state: (g,) tensors, one per slot of each agg; gid: (N,) int32;
    ts_hi/ts_lo: (N,) int32 split timestamps; vals/has: (len(ops), N)
    values and validity; all_valid[j]: has[j] is all True (its count is
    shared)."""
    out = list(state)
    si = 0
    dev = gid.device
    n = gid.numel()
    gidl = gid.long()
    members = gr.group_members(gid, torch.ones(n, dtype=torch.bool,
                                               device=dev), 1, g)
    counts: dict = {}

    def _nsum(j):
        key = "all" if all_valid[j] else j
        if key not in counts:
            counts[key] = torch.zeros(g, dtype=torch.int32,
                                      device=dev).index_add_(
                0, gidl, has[j].to(torch.int32))
        return counts[key]

    def _vsum(v, ok):
        return gr.grouped_block_reduce(torch.where(ok, v, 0.0), members,
                                       "sum")[0]

    def _ext(x, form):
        return gr.grouped_block_reduce(x, members, form)

    for j, op in enumerate(ops):
        v = vals[j]
        ok = has[j]
        if op == "count":
            out[si] = out[si] + _nsum(j)
            si += 1
        elif op in ("sum", "mean"):
            out[si], out[si + 1] = _kahan_fold(out[si], out[si + 1],
                                               _vsum(v, ok))
            out[si + 2] = out[si + 2] + _nsum(j)
            si += 3
        elif op in ("min", "max"):
            take_max = op == "max"
            fill = -torch.inf if take_max else torch.inf
            d = _ext(torch.where(ok, v, fill), op)
            out[si] = extreme_plain(out[si], d, take_max)
            out[si + 1] = out[si + 1] + _nsum(j)
            si += 2
        elif op in _VAR_OPS:
            bn = _nsum(j)
            n_old = out[si + 5]
            # pin the shift to the group's first batch mean
            bmean = _vsum(v, ok) / torch.clamp(bn, min=1).to(v.dtype)
            k = torch.where((n_old == 0) & (bn > 0), bmean, out[si])
            vk = v - k[gidl]
            out[si] = k
            out[si + 1], out[si + 2] = _kahan_fold(
                out[si + 1], out[si + 2], _vsum(vk, ok))
            out[si + 3], out[si + 4] = _kahan_fold(
                out[si + 3], out[si + 4], _vsum(vk * vk, ok))
            out[si + 5] = n_old + bn
            si += 6
        elif op in ("first_value", "last_value"):
            last = op == "last_value"
            fill = -1 if last else int(_IMAX)
            form = "max" if last else "min"
            # batch winner by (ts_hi, ts_lo, arrival) lexicographically,
            # one exact int32 segment reduction per component
            bh = _ext(torch.where(ok, ts_hi, fill), form)
            c1 = ok & (ts_hi == bh[gidl])
            bl = _ext(torch.where(c1, ts_lo, fill), form)
            c2 = c1 & (ts_lo == bl[gidl])
            iota = torch.arange(n, dtype=torch.int32, device=dev)
            widx = _ext(torch.where(c2, iota, fill), form)
            hit = c2 & (iota == widx[gidl])
            bv = _vsum(v, hit)
            has_cand = bh != fill
            shi, slo = out[si + 1], out[si + 2]
            # cross-batch compare with host semantics: a later batch
            # replaces at equal ts for last_value, keeps the earlier
            # arrival for first_value
            if last:
                take = has_cand & ((bh > shi) | ((bh == shi) & (bl >= slo)))
            else:
                take = has_cand & ((bh < shi) | ((bh == shi) & (bl < slo)))
            out[si] = torch.where(take, bv, out[si])
            out[si + 1] = torch.where(take, bh, shi)
            out[si + 2] = torch.where(take, bl, slo)
            si += 3
        else:  # pragma: no cover - guarded by plan_supports_device
            raise ValueError(op)
    return tuple(out)


def _finalize(state: tuple, ops: tuple, fdt: torch.dtype):
    """All-group finalize: per agg (values, presence) over the capacity.
    Counts stay int32."""
    outs = []
    pres = []
    si = 0
    for op in ops:
        if op == "count":
            n = state[si]
            outs.append(n)
            pres.append(torch.ones_like(n, dtype=torch.bool))
            si += 1
        elif op in ("sum", "mean"):
            s = state[si] + state[si + 1]
            n = state[si + 2]
            ok = n > 0
            val = s / torch.clamp(n, min=1).to(fdt) if op == "mean" else s
            outs.append(torch.where(ok, val, 0.0))
            pres.append(ok)
            si += 3
        elif op in ("min", "max"):
            m, n = state[si], state[si + 1]
            ok = n > 0
            outs.append(torch.where(ok, m, 0.0))
            pres.append(ok)
            si += 2
        elif op in _VAR_OPS:
            s = state[si + 1] + state[si + 2]      # sum(v - k)
            s2 = state[si + 3] + state[si + 4]     # sum((v - k)^2)
            n = state[si + 5].to(fdt)
            ddof = 1.0 if op.endswith("_samp") else 0.0
            ok = n > ddof
            n1 = torch.clamp(n, min=1.0)
            mean = s / n1                          # shift-invariant
            # XLA:CPU contracts s2 / n1 - mean * mean into one fnmadd
            var = W._fma(-mean, mean, s2 / n1)
            var = extreme_plain(var, torch.zeros_like(var), True)
            var = var * (n1 / torch.clamp(n1 - ddof, min=1.0))
            if op.startswith("stddev"):
                var = W.sqrt_rn(var)
            outs.append(torch.where(ok, var, 0.0))
            pres.append(ok)
            si += 6
        elif op in ("first_value", "last_value"):
            v, hi = state[si], state[si + 1]
            ok = hi != (-1 if op == "last_value" else int(_IMAX))
            outs.append(torch.where(ok, v, 0.0))
            pres.append(ok)
            si += 3
        else:  # pragma: no cover
            raise ValueError(op)
    return outs, pres


_NEVER_EXPIRES = float("inf")


class DeviceFlowState:
    """Dense per-gid accumulators on `device` + host-side key interning.
    Float slots are float64 with `x64`, else float32."""

    def __init__(self, plan, time_key_idx: int | None = None, *,
                 device=None, x64: bool = False):
        self.ops = tuple(a.op for a in plan.aggs)
        self.time_key_idx = time_key_idx
        self.device = resolve_device(device)
        self.x64 = bool(x64)
        self.fdt = torch.float64 if self.x64 else torch.float32
        self._key_index: dict[tuple, int] = {}
        self._key_rows: list[tuple] = []
        self._col_dicts = None            # per-key-column Dictionary
        # packed column codes -> gid (the fast lookup of intern_keys)
        self._code_keys = np.zeros(0, np.int64)
        self._code_gids = np.zeros(0, np.int32)
        self._code_kinds = None
        self._tk_vals: list[float] = []   # time-key per gid (inf: never)
        self._tk_min = _NEVER_EXPIRES
        self.capacity = 0
        self.state: tuple = ()
        self.dirty = np.zeros(0, bool)

    # ---- group interning ----------------------------------------------
    def _append_key(self, kt: tuple) -> int:
        gid = len(self._key_rows)
        self._key_index[kt] = gid
        self._key_rows.append(kt)
        tk = self.time_key_idx
        v = _NEVER_EXPIRES
        if tk is not None and isinstance(kt[tk], (int, float)):
            v = float(kt[tk])
        self._tk_vals.append(v)
        if v < self._tk_min:
            self._tk_min = v
        return gid

    def intern_keys(self, key_cols: list[np.ndarray], n: int) -> np.ndarray:
        """Map n rows of key columns to dense gids (keyless: all gid 0).

        Per-column codes come from an incremental Dictionary of each
        value's injective string form (stable across batches), then the
        batch's distinct code rows, in ascending order, map to gids: a
        group seen before by its codes, else by its key tuple, else a new
        gid. Gids come out as the JAX package assigns them."""
        if not key_cols:
            if not self._key_rows:
                self._append_key(())
            return np.zeros(n, np.int32)
        if self._col_dicts is None:
            self._col_dicts = [Dictionary() for _ in key_cols]
        codes, kinds = [], []
        for d, c in zip(self._col_dicts, key_cols):
            cc, kind = _fast_codes(d, c)
            if cc is None:
                cc = d.intern_array(_key_strings(c)).astype(np.int64)
            codes.append(cc)
            kinds.append(kind)
        # the code lookup holds while every column keeps one kind
        # (integers or strings): a code then names one key value
        if self._code_kinds is None:
            self._code_kinds = tuple(kinds)
        fast = (len(key_cols) <= 2 and None not in kinds
                and tuple(kinds) == self._code_kinds)
        key = codes[0]
        for d, c2 in zip(self._col_dicts[1:], codes[1:]):
            key = key * len(d) + c2
        _, first_rows, inv = np.unique(
            key, return_index=True, return_inverse=True
        )
        inv = np.ravel(inv)
        if fast:
            # codes of integer and all-string columns map 1-1 to key
            # values, so a code pair seen before names its gid
            packed = codes[0][first_rows]
            if len(codes) == 2:
                packed = (packed << 32) | codes[1][first_rows]
            if len(self._code_keys):
                pos = np.minimum(np.searchsorted(self._code_keys, packed),
                                 len(self._code_keys) - 1)
                hit = self._code_keys[pos] == packed
                gids = np.where(hit, self._code_gids[pos], 0).astype(
                    np.int32)
            else:
                hit = np.zeros(len(packed), bool)
                gids = np.zeros(len(packed), np.int32)
            miss = np.nonzero(~hit)[0]
            for i in miss:
                gids[i] = self._gid_of(key_cols, first_rows[i])
            if len(miss):
                # packed is ascending, so its misses insert in order
                at = np.searchsorted(self._code_keys, packed[miss])
                self._code_keys = np.insert(self._code_keys, at,
                                            packed[miss])
                self._code_gids = np.insert(self._code_gids, at, gids[miss])
            return gids[inv]
        gids = np.empty(len(first_rows), np.int32)
        for i, row in enumerate(first_rows):
            gids[i] = self._gid_of(key_cols, row)
        return gids[inv]

    def _gid_of(self, key_cols, row) -> int:
        kt = tuple(_scalar(col[row]) for col in key_cols)
        gid = self._key_index.get(kt)
        if gid is None:
            gid = self._append_key(kt)
        return gid

    @property
    def num_groups(self) -> int:
        return len(self._key_rows)

    def key_rows(self) -> list[tuple]:
        return self._key_rows

    def nbytes(self) -> int:
        """Bytes of the state tensors on the device."""
        return sum(s.numel() * s.element_size() for s in self.state)

    # ---- capacity ------------------------------------------------------
    def _slot_specs(self):
        out = []
        for op in self.ops:
            out.extend(_SLOTS[op])
        return out

    def _identity_array(self, kind, ident, cap: int) -> torch.Tensor:
        dt = self.fdt if kind == "f" else torch.int32
        return torch.full((cap,), ident, dtype=dt, device=self.device)

    def _ensure_capacity(self, g: int):
        if g <= self.capacity and self.state:
            return
        cap = max(self.capacity or 1024, 1024)
        while cap < g:
            cap *= 2
        new = []
        for i, (kind, ident) in enumerate(self._slot_specs()):
            arr = self._identity_array(kind, ident, cap)
            if self.state:
                arr[: self.capacity] = self.state[i]
            new.append(arr)
        self.state = tuple(new)
        nd = np.zeros(cap, bool)
        nd[: len(self.dirty)] = self.dirty
        self.dirty = nd
        self.capacity = cap

    # ---- delta application --------------------------------------------
    def apply(self, gids: np.ndarray, ts: np.ndarray,
              agg_args: list[tuple[np.ndarray | None, np.ndarray | None]]):
        """Fold this batch into the state: three uploads, then G and
        elementwise launches on the state's device."""
        n = len(gids)
        if n == 0:
            return
        if len(ts) and int(ts.min()) < 0:
            # the int32 ts split assumes epoch >= 0; manager falls back
            raise ValueError("negative timestamps: host path required")
        self._ensure_capacity(self.num_groups)
        hi, lo = _ts_split(ts)
        # values cast to the state's dtype on the host, as jnp.asarray
        # casts a float64 array without x64
        vals = np.zeros((len(agg_args), n),
                        np.float64 if self.x64 else np.float32)
        has = np.ones((len(agg_args), n), bool)
        all_valid = []
        for j, (arr, validity) in enumerate(agg_args):
            if arr is not None:
                vals[j] = np.asarray(arr, np.float64)
                if validity is not None:
                    has[j] = np.asarray(validity, bool)
            all_valid.append(bool(has[j].all()))
        dev = self.device
        # the apply does not wait for its launches (the next apply's data
        # dependency orders them), so its timing is the dispatch's
        # (dispatch_only) and the registry claims no achieved rate
        from greptimedb_tpu_torch.telemetry import device_trace

        idx = torch.from_numpy(np.stack(
            [gids.astype(np.int32), hi, lo])).to(dev)
        d_vals = torch.from_numpy(vals).to(dev)
        d_has = torch.from_numpy(has).to(dev)
        upload = sum(t.numel() * t.element_size()
                     for t in (idx, d_vals, d_has))
        with device_trace.device_call(
                "flow_apply", key=("flow_apply", self.ops, self.capacity),
                rows=n, device=dev) as dcall:
            dcall.transfer(upload, "upload")
            self.state = dcall.run(
                _apply, self.state, idx[0], idx[1], idx[2], d_vals, d_has,
                all_valid, ops=self.ops, g=self.capacity)
            dcall.executed(dispatch_only=True)
        self.dirty[np.unique(gids)] = True

    # ---- finalize ------------------------------------------------------
    def snapshot_dirty(self):
        """Under the flow lock: snapshot (state tuple, dirty gids) and
        clear the dirty bits. Returns None when clean."""
        g = self.num_groups
        if g == 0 or not self.dirty[:g].any():
            return None
        dirty = np.nonzero(self.dirty[:g])[0]
        self.dirty[:g] = False
        return (self.state, self.capacity, dirty)

    def finalize_snapshot(self, snap):
        """Outside the lock: finalize every group of the snapshot's state,
        gather the dirty slice on the device and read it back (one copy of
        the float results, one of the counts, one of the presence).
        Returns (dirty_gids, {agg_idx: (float64 values, present)})."""
        from greptimedb_tpu_torch.telemetry import device_trace

        state, cap, dirty = snap
        with device_trace.device_call(
                "flow_finalize", key=("flow_finalize", self.ops, cap),
                groups=int(len(dirty)), device=self.device) as dcall:
            outs, pres = dcall.run(_finalize, state, self.ops, self.fdt)
            dcall.executed()
            if dcall.first:
                # every state slot read once, the outputs written once
                dcall.declare(sum(t.numel() for t in state),
                              sum(t.numel() * t.element_size()
                                  for t in (*state, *outs, *pres)))
            didx = torch.from_numpy(dirty.astype(np.int64)).to(self.device)
            floats = [j for j, o in enumerate(outs)
                      if o.dtype != torch.int32]
            ints = [j for j, o in enumerate(outs) if o.dtype == torch.int32]
            host = {}
            nbytes = 0
            for group in (floats, ints):
                if group:
                    block = torch.stack([outs[j].index_select(0, didx)
                                         for j in group]).cpu().numpy()
                    nbytes += block.nbytes
                    for r, j in enumerate(group):
                        host[j] = block[r].astype(np.float64)
            present = torch.stack([p.index_select(0, didx)
                                   for p in pres]).cpu().numpy()
            dcall.transfer(nbytes + present.nbytes)
        return dirty, {j: (host[j], present[j])
                       for j in range(len(self.ops))}

    # ---- demotion ------------------------------------------------------
    def export_host_accs(self):
        """Read back every group as host-accumulator tuples (the
        manager._accumulate format), so a flow can demote to the host
        path without losing accumulated state."""
        g = self.num_groups
        if g == 0 or not self.state:
            return [], np.zeros(0, bool)
        hs = [s.cpu().numpy() for s in self.state]
        rows = []
        for gid in range(g):
            accs = []
            si = 0
            for op in self.ops:
                if op == "count":
                    accs.append(int(hs[si][gid]))
                    si += 1
                elif op == "sum":
                    n = int(hs[si + 2][gid])
                    s = float(hs[si][gid]) + float(hs[si + 1][gid])
                    accs.append(s if n else None)
                    si += 3
                elif op == "mean":
                    n = int(hs[si + 2][gid])
                    s = float(hs[si][gid]) + float(hs[si + 1][gid])
                    accs.append((s, n) if n else None)
                    si += 3
                elif op in ("min", "max"):
                    n = int(hs[si + 1][gid])
                    accs.append(float(hs[si][gid]) if n else None)
                    si += 2
                elif op in _VAR_OPS:
                    n = int(hs[si + 5][gid])
                    k = float(hs[si][gid])
                    sk = float(hs[si + 1][gid]) + float(hs[si + 2][gid])
                    s2k = float(hs[si + 3][gid]) + float(hs[si + 4][gid])
                    # unshift to the host (raw s, s2) acc form in float64
                    s = sk + n * k
                    s2 = s2k + 2 * k * sk + n * k * k
                    accs.append((s, s2, n) if n else None)
                    si += 6
                else:  # first_value / last_value
                    hi = int(hs[si + 1][gid])
                    lo = int(hs[si + 2][gid])
                    empty = hi == (-1 if op == "last_value" else int(_IMAX))
                    accs.append(
                        None if empty
                        else (float(hs[si][gid]), (hi << 20) | lo)
                    )
                    si += 3
            rows.append(accs)
        return rows, self.dirty[:g].copy()

    # ---- expiry --------------------------------------------------------
    def expire_older_than(self, horizon: float) -> bool:
        """EXPIRE AFTER: drop groups whose time key is older than horizon.
        O(1) when nothing can expire. Groups still dirty survive one more
        tick so their final state reaches the sink first."""
        if self._tk_min >= horizon or not self.num_groups:
            return False
        g = self.num_groups
        tk = np.asarray(self._tk_vals, np.float64)
        self.expire((tk >= horizon) | self.dirty[:g])
        return True

    def expire(self, keep_mask: np.ndarray):
        """Compact to the surviving groups (keep_mask over gids)."""
        g = self.num_groups
        keep = np.nonzero(keep_mask[:g])[0]
        if len(keep) == g:
            return
        rows = [self._key_rows[i] for i in keep]
        old_dirty = (self.dirty[keep] if len(self.dirty)
                     else np.zeros(0, bool))
        self._key_rows = rows
        self._key_index = {k: i for i, k in enumerate(rows)}
        # gids moved: the code lookup refills from the key index
        self._code_keys = np.zeros(0, np.int64)
        self._code_gids = np.zeros(0, np.int32)
        self._tk_vals = [self._tk_vals[i] for i in keep]
        self._tk_min = min(self._tk_vals, default=_NEVER_EXPIRES)
        if not self.state:
            return
        idx = torch.from_numpy(keep.astype(np.int64)).to(self.device)
        cap = 1024
        while cap < len(rows):
            cap *= 2
        new = []
        for (kind, ident), s in zip(self._slot_specs(), self.state):
            arr = self._identity_array(kind, ident, cap)
            arr[: len(rows)] = s.index_select(0, idx)
            new.append(arr)
        self.state = tuple(new)
        nd = np.zeros(cap, bool)
        nd[: len(rows)] = old_dirty
        self.dirty = nd
        self.capacity = cap


def _scalar(v):
    return v.item() if isinstance(v, np.generic) else v


def _key_strings(c) -> np.ndarray:
    """Injective string form of a key column for interning. Numeric
    arrays stringify directly (homogeneous, so str() is injective);
    object arrays tag non-string values so NULL and the literal string
    "None" (etc.) stay distinct groups, matching the host path."""
    arr = np.asarray(c, object) if not isinstance(c, np.ndarray) else c
    if arr.dtype != object:
        return arr.astype(str)
    return np.asarray(
        [v if type(v) is str else f"\x00{type(v).__name__}:{v}"
         for v in arr],
        object,
    )


def _fast_codes(d: Dictionary, c):
    """(codes, kind): the Dictionary codes `d.intern_array(_key_strings(c))`
    gives, without stringifying every row, for a column of integers (an
    integer array, kind "i", or an object array of ints, kind "o") or of
    strings (kind "s"); (None, None) for any other column."""
    arr = np.asarray(c, object) if not isinstance(c, np.ndarray) else c
    if arr.dtype.kind in "iu":
        uniq, first, inv = np.unique(arr, return_index=True,
                                     return_inverse=True)
        order = np.argsort(first, kind="stable")
        rank = np.empty(len(order), np.int64)
        rank[order] = np.arange(len(order))
        strs = uniq[order].astype(str).tolist()
        codes = np.fromiter((d.intern(s) for s in strs), np.int64,
                            len(strs))
        return codes[rank[np.ravel(inv)]], "i"
    if arr.dtype.kind not in "OU":
        return None, None
    vals = arr.tolist()
    # distinct values in first-occurrence order (Arrow's dictionary order)
    seen = dict.fromkeys(vals)
    if all(type(v) is str for v in seen):
        kind, form = "s", str
    elif all(type(v) is int for v in seen):
        kind, form = "o", "\x00int:{}".format
    else:
        return None, None
    for v in seen:
        seen[v] = d.intern(form(v))
    return np.fromiter(map(seen.__getitem__, vals), np.int64,
                       len(vals)), kind
