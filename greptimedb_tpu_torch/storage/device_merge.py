"""Device merge of sorted runs: the compaction merge on the card.

Compaction concatenates N runs and must re-sort, dedup by (sid, ts)
keeping the highest sequence, optionally back-fill last_non_null fields,
and optionally drop delete tombstones — exactly ``region.dedup_rows``.
The device computes only the permutation, the keep mask and (for
last_non_null) per-field fill indices. Two variants:

- classic: those index arrays are read back and the host gathers the
  original arrays through them;
- fused: the indices stay on the card, composed into per-output-row
  source indices; every value column is packed into uint32 bit planes and
  gathered by K1 (parallel/kernels/merge_gather), and only the gathered
  planes and the 4-byte kept-row count are read back.

Values never change representation, so both variants are bit-identical
to the host merge by construction — asserted anyway under ``verify``.

Row counts pad to power-of-two buckets (padding sorts strictly after
every real key), as in the JAX package, so the shapes K1 sees are the
JAX kernel's shapes.
"""

from __future__ import annotations

import numpy as np
import torch

from greptimedb_tpu_torch.device import kernels_enabled, resolve_device
from greptimedb_tpu_torch.errors import CompactionError
from greptimedb_tpu_torch.parallel.kernels import merge_gather as mg
from greptimedb_tpu_torch.query import readback
from greptimedb_tpu_torch.storage.memtable import OP_DELETE, ColumnarRows
from greptimedb_tpu_torch.telemetry import device_trace

# below this the upload + launch overhead beats the host sort
DEFAULT_DEVICE_MIN_ROWS = 262144
# fused merge-gather row floor (the JAX package's pallas_min_rows)
DEFAULT_KERNEL_MIN_ROWS = 262144
_MIN_PAD = 1024


def _pad_to_bucket(n: int) -> int:
    p = _MIN_PAD
    while p < n:
        p <<= 1
    return p


def _lexsort(keys: list[torch.Tensor]) -> torch.Tensor:
    """Stable lexicographic sort permutation, least significant key first
    (jnp.lexsort's convention), as a chain of stable sorts. Every key is
    int64 or int32 here: torch does not sort uint32/uint64 reliably, so
    unsigned halves are widened to int64 before they get here."""
    perm = torch.sort(keys[0], stable=True).indices
    for k in keys[1:]:
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def _merge_program(up: dict, n_real: int, valids: dict, *,
                   drop_deletes: bool, fused: bool = False):
    """The merge program over bucket-padded device uploads.

    classic -> (order int64, keep bool, fills {name: int64}) in sorted
    position space; fused -> (n_keep int32 scalar tensor, src_keep int32,
    src_fills {name: int32}), source indices in ORIGINAL row space with
    the kept rows compacted to the front."""
    sid, ts, op = up["sid"], up["ts"], up["op"]
    n = sid.shape[0]
    dev = sid.device
    # the 64-bit sequence rides as two non-negative int64 halves whose
    # lexicographic order equals the uint64 order; ts is a plain int64
    order = _lexsort([up["seq_lo"], up["seq_hi"], ts, sid])
    s_sid = sid[order]
    s_ts = ts[order]
    s_op = op[order]
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    change = torch.ones(n, dtype=torch.bool, device=dev)
    change[1:] = (s_sid[1:] != s_sid[:-1]) | (s_ts[1:] != s_ts[:-1])
    last_of_run = torch.ones(n, dtype=torch.bool, device=dev)
    last_of_run[:-1] = change[1:]
    keep = last_of_run & (idx < n_real)
    if drop_deletes:
        keep = keep & (s_op != OP_DELETE)
    fills = {}
    if valids:
        # last-valid-index forward fill, segmented at run starts: a global
        # running max of "index if valid else -1" either lands inside the
        # current run (>= its start) or the run has no valid value yet and
        # the row keeps itself
        neg = torch.full_like(idx, -1)
        run_start = torch.cummax(torch.where(change, idx, neg), 0).values
        for name, v in valids.items():
            m = torch.cummax(torch.where(v[order], idx, neg), 0).values
            fills[name] = torch.where(m >= run_start, m, idx)
    if not fused:
        return order, keep, fills
    # fused: compact the kept rows' ORIGINAL indices to the front. ck - 1
    # ranks each kept sorted position among the keeps; every dropped row
    # targets slot n. index_put_ with those duplicate targets is
    # non-deterministic only in slot n, which is sliced off (as in JAX).
    ck = torch.cumsum(keep, 0, dtype=torch.int32)
    n_keep = ck[-1]
    tgt = torch.where(keep, ck.to(torch.int64) - 1,
                      torch.full_like(idx, n))
    order_i = order.to(torch.int32)

    def compact(vals: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        out[tgt] = vals
        return out[:n]

    src_keep = compact(order_i)
    src_fills = {name: compact(order_i[f]) for name, f in fills.items()}
    return n_keep, src_keep, src_fills


def _prep_uploads(rows: ColumnarRows, *, backfill: bool, device):
    """Bucket-padded sort-key uploads shared by both variants:
    (device upload dict, device valids dict, pad)."""
    n = len(rows)
    pad = _pad_to_bucket(n)
    seq = np.asarray(rows.seq, np.uint64)

    def padded(a: np.ndarray, fill) -> torch.Tensor:
        if pad != n:
            a = np.concatenate([a, np.full(pad - n, fill, a.dtype)])
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    # padding sorts strictly after every real key: real sids are small
    # dense region-local ids, never int32 max
    up = {
        "sid": padded(np.asarray(rows.sid, np.int32), np.int32(2**31 - 1)),
        "ts": padded(np.asarray(rows.ts, np.int64), np.int64(2**63 - 1)),
        "seq_hi": padded((seq >> np.uint64(32)).astype(np.int64),
                         np.int64(2**32 - 1)),
        "seq_lo": padded((seq & np.uint64(0xFFFFFFFF)).astype(np.int64),
                         np.int64(2**32 - 1)),
        "op": padded(np.asarray(rows.op, np.uint8), np.uint8(0)),
    }
    valids = {}
    if backfill and rows.field_valid is not None:
        valids = {
            name: padded(np.asarray(v, bool), False)
            for name, v in rows.field_valid.items()
        }
    return up, valids, pad


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _device_merge_indices(rows: ColumnarRows, *, backfill: bool,
                          drop_deletes: bool, device):
    """Classic variant: (keep_row_indices, fill_src) in ORIGINAL row index
    space, read back for a host gather."""
    n = len(rows)
    up, valids, pad = _prep_uploads(rows, backfill=backfill, device=device)
    upload = _nbytes([*up.values(), *valids.values()])
    key = (pad, tuple(sorted(valids)), drop_deletes)
    with device_trace.device_call("compact_merge", key=key, rows=n,
                                  device=device) as d:
        d.transfer(upload, "upload")
        order_d, keep_d, fills_d = d.run(
            _merge_program, up, n, valids, drop_deletes=drop_deletes)
        d.executed()
        if d.first:
            # the sort keys read once, the order/keep/fill arrays
            # written once; a compare per row and key
            d.declare(pad * 5, upload + _nbytes(
                [order_d, keep_d, *fills_d.values()]))
        order = readback.read_full(order_d, np.int64)
        keep = readback.read_full(keep_d)
        fills = {name: readback.read_full(f, np.int64)
                 for name, f in fills_d.items()}
        d.transfer(order.nbytes + keep.nbytes
                   + sum(f.nbytes for f in fills.values()))
    keep_idx = order[keep]
    fill_src = None
    if fills:
        fill_src = {name: order[f][keep] for name, f in fills.items()}
    return keep_idx, fill_src


def _fused_supported(rows: ColumnarRows) -> bool:
    """Every column needs a fixed-width uint32 plane form; object/string
    fields take the classic path."""
    cols = [rows.sid, rows.ts, rows.seq, rows.op]
    cols.extend(rows.fields.values())
    if rows.field_valid is not None:
        cols.extend(rows.field_valid.values())
    return all(mg.packable(np.asarray(c).dtype) for c in cols)


def _fused_wanted(n: int, device, kernels: str, kernel_min_rows: int) -> bool:
    """Planner gate for the fused variant: the kernels mode plus the row
    floor (the JAX package's decide_kernel("merge"))."""
    return (kernels_enabled(kernels, device)
            and n >= max(int(kernel_min_rows), 1))


def _gather_group(cols, src_dev: torch.Tensor, *, pad: int, n: int,
                  n_keep: int, n_out: int):
    """Pack one source-index group's columns into a single uint32 plane
    matrix, gather it through the device-resident indices with K1, read
    back only the gathered planes, and unpack per column."""
    mats, metas = [], []
    for tag, col in cols:
        col = np.asarray(col)
        planes = mg.pack_planes(col)
        metas.append((tag, col.dtype, planes.shape[0]))
        mats.append(planes)
    big = np.concatenate(mats, axis=0)
    if pad != n:
        big = np.concatenate(
            [big, np.zeros((big.shape[0], pad - n), np.uint32)], axis=1
        )
    p_total = big.shape[0]
    with device_trace.device_call(
            "compact_gather", key=(p_total, pad, n_out), rows=n,
            device=src_dev.device) as d:
        d.transfer(big.nbytes, "upload")
        planes_d = torch.from_numpy(big.view(np.int32)).to(src_dev.device)
        out_d = d.run(mg.gather_planes, planes_d, src_dev[:n_out])
        d.executed()
        if d.first:
            # K1: each gathered plane read and written once, the index
            # read once; no arithmetic
            d.declare(0, 4 * n_out * (2 * p_total + 1))
        out = readback.read_full(out_d)
        d.transfer(out.nbytes)
    res, off = {}, 0
    for tag, dt, p_i in metas:
        res[tag] = mg.unpack_planes(out[off:off + p_i], dt, n_keep)
        off += p_i
    return res


def _device_merge_fused(rows: ColumnarRows, *, backfill: bool,
                        drop_deletes: bool, device) -> ColumnarRows:
    """Two-phase fused merge: the merge program keeps the composed source
    indices on the card and reads back only the kept-row count; then
    every value column is gathered through them by K1."""
    n = len(rows)
    up, valids, pad = _prep_uploads(rows, backfill=backfill, device=device)
    upload = _nbytes([*up.values(), *valids.values()])
    key = (pad, tuple(sorted(valids)), drop_deletes, "fused")
    with device_trace.device_call("compact_merge", key=key, rows=n,
                                  device=device) as d:
        d.transfer(upload, "upload")
        n_keep_d, src_keep_d, src_fills_d = d.run(
            _merge_program, up, n, valids, drop_deletes=drop_deletes,
            fused=True)
        d.executed()
        if d.first:
            # the sort keys read once, the source indices written once
            d.declare(pad * 5, upload + _nbytes(
                [src_keep_d, *src_fills_d.values()]))
        n_keep = int(readback.read_full(n_keep_d))
        d.transfer(4)
    has_valid = rows.field_valid is not None
    if n_keep == 0:
        return ColumnarRows(
            sid=rows.sid[:0], ts=rows.ts[:0], seq=rows.seq[:0],
            op=rows.op[:0],
            fields={name: v[:0] for name, v in rows.fields.items()},
            field_valid=(
                {name: v[:0] for name, v in rows.field_valid.items()}
                if has_valid else None
            ),
        )
    n_out = _pad_to_bucket(n_keep)
    keep_cols = [
        (("k", "sid"), rows.sid), (("k", "ts"), rows.ts),
        (("k", "seq"), rows.seq), (("k", "op"), rows.op),
    ]
    fill_groups = {}
    for name, vals in rows.fields.items():
        v = rows.field_valid.get(name) if has_valid else None
        if name in src_fills_d:
            grp = fill_groups.setdefault(name, [])
            grp.append((("f", name), vals))
            if v is not None:
                grp.append((("v", name), v))
        else:
            keep_cols.append((("f", name), vals))
            if v is not None:
                keep_cols.append((("v", name), v))
    got = _gather_group(keep_cols, src_keep_d, pad=pad, n=n,
                        n_keep=n_keep, n_out=n_out)
    for name, grp in fill_groups.items():
        got.update(_gather_group(grp, src_fills_d[name], pad=pad, n=n,
                                 n_keep=n_keep, n_out=n_out))
    fields = {name: got[("f", name)] for name in rows.fields}
    out_valids = None
    if has_valid:
        out_valids = {name: got[("v", name)]
                      for name in rows.field_valid if ("v", name) in got}
    return ColumnarRows(
        sid=got[("k", "sid")], ts=got[("k", "ts")],
        seq=got[("k", "seq")], op=got[("k", "op")],
        fields=fields,
        field_valid=out_valids if out_valids else None,
    )


def host_merge(rows: ColumnarRows, *, merge_mode: str,
               drop_deletes: bool) -> ColumnarRows:
    """The host reference merge (region.dedup_rows)."""
    from greptimedb_tpu_torch.storage.region import dedup_rows

    return dedup_rows(rows, merge_mode=merge_mode,
                      drop_deletes=drop_deletes)


def merge_rows(
    rows: ColumnarRows,
    *,
    merge_mode: str = "last_row",
    drop_deletes: bool = False,
    device_min_rows: int = DEFAULT_DEVICE_MIN_ROWS,
    verify: bool = False,
    device=None,
    kernels: str = "auto",
    kernel_min_rows: int = DEFAULT_KERNEL_MIN_ROWS,
) -> tuple[ColumnarRows, str]:
    """Sort + dedup + merge-mode-fold concatenated runs.

    Returns (merged rows, path): path is "fused" (merge program + K1),
    "device" (classic merge program, host gather) or "host".
    device_min_rows <= 0 disables the device path. `kernels`
    ("auto"|"on"|"off") and `kernel_min_rows` gate the fused variant.
    With ``verify`` the device output is asserted bit-identical to the
    host merge (CompactionError on divergence)."""
    dev = resolve_device(device)
    n = len(rows)
    if device_min_rows <= 0 or n < device_min_rows:
        return host_merge(rows, merge_mode=merge_mode,
                          drop_deletes=drop_deletes), "host"
    backfill = merge_mode == "last_non_null" and rows.field_valid is not None
    if _fused_supported(rows) and _fused_wanted(n, dev, kernels,
                                                kernel_min_rows):
        out = _device_merge_fused(rows, backfill=backfill,
                                  drop_deletes=drop_deletes, device=dev)
        path = "fused"
    else:
        keep_idx, fill_src = _device_merge_indices(
            rows, backfill=backfill, drop_deletes=drop_deletes, device=dev,
        )
        fields = {}
        valids = {} if rows.field_valid is not None else None
        for name, vals in rows.fields.items():
            src = keep_idx if fill_src is None else fill_src.get(name,
                                                                 keep_idx)
            fields[name] = vals[src]
            if valids is not None:
                v = rows.field_valid.get(name)
                if v is not None:
                    valids[name] = v[src]
        out = ColumnarRows(
            sid=rows.sid[keep_idx], ts=rows.ts[keep_idx],
            seq=rows.seq[keep_idx], op=rows.op[keep_idx],
            fields=fields,
            field_valid=valids if valids else None,
        )
        path = "device"
    if verify:
        _assert_identical(
            out,
            host_merge(rows, merge_mode=merge_mode,
                       drop_deletes=drop_deletes),
        )
    return out, path


def _assert_identical(dev: ColumnarRows, host: ColumnarRows) -> None:
    def bad(what: str):
        raise CompactionError(
            f"device merge diverged from host path: {what}"
        )

    if len(dev) != len(host):
        bad(f"row count {len(dev)} != {len(host)}")
    for name in ("sid", "ts", "seq", "op"):
        if not np.array_equal(getattr(dev, name), getattr(host, name)):
            bad(f"column {name}")
    if set(dev.fields) != set(host.fields):
        bad("field set")
    for name in dev.fields:
        d, h = dev.fields[name], host.fields[name]
        # bit-identical, not value-equal: NaNs compare by bit pattern
        if d.dtype != h.dtype or not np.array_equal(
            d.view(np.uint8) if d.dtype.kind == "f" else d,
            h.view(np.uint8) if h.dtype.kind == "f" else h,
        ):
            bad(f"field {name}")
    dv = dev.field_valid or {}
    hv = host.field_valid or {}
    if set(dv) != set(hv):
        bad("validity set")
    for name in dv:
        if not np.array_equal(dv[name], hv[name]):
            bad(f"validity {name}")
