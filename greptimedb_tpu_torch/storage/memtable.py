"""Sid-resolved columnar rows and the time-partitioned memtable (the JAX
package's storage/memtable.py).

ColumnarRows is what a write appends, what compaction merges and what a
scan returns. The Memtable keeps appended runs as columnar numpy chunks
keyed by time window, already in (sid, ts, seq, op, fields...) form: no
transformation between a frozen memtable and a device feed or an SST
flush. One writer per region, so appends are lock-light.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from greptimedb_tpu_torch import concurrency

OP_PUT = 0
OP_DELETE = 1


@dataclass
class ColumnarRows:
    """One append's worth of rows, already sid-resolved."""

    sid: np.ndarray                 # int32
    ts: np.ndarray                  # int64 ms
    seq: np.ndarray                 # uint64 sequence numbers
    op: np.ndarray                  # uint8 OP_*
    fields: dict[str, np.ndarray]   # name -> float/int arrays
    field_valid: dict[str, np.ndarray] | None = None  # name -> bool

    def __len__(self):
        return len(self.sid)


@dataclass
class _Partition:
    chunks: list[ColumnarRows] = field(default_factory=list)
    rows: int = 0
    ts_min: int = 2**63 - 1
    ts_max: int = -(2**63)


class Memtable:
    def __init__(self, field_names: list[str], *,
                 window_ms: int | None = None):
        self.field_names = list(field_names)
        self.window_ms = window_ms
        self._parts: dict[int, _Partition] = {}
        self._lock = concurrency.Lock()
        self.rows = 0
        self.bytes = 0

    def append(self, rows: ColumnarRows) -> None:
        if len(rows) == 0:
            return
        with self._lock:
            if self.window_ms:
                wins = rows.ts // self.window_ms
                lo, hi = int(wins.min()), int(wins.max())
                if lo == hi:
                    self._append_part(lo, rows)
                    return
                for w in np.unique(wins):
                    self._append_part(int(w), _slice_rows(rows, wins == w))
            else:
                self._append_part(0, rows)

    def _append_part(self, win: int, rows: ColumnarRows):
        part = self._parts.setdefault(win, _Partition())
        part.chunks.append(rows)
        part.rows += len(rows)
        part.ts_min = min(part.ts_min, int(rows.ts.min()))
        part.ts_max = max(part.ts_max, int(rows.ts.max()))
        self.rows += len(rows)
        self.bytes += sum(
            a.nbytes for a in (rows.sid, rows.ts, rows.seq, rows.op)
        ) + sum(a.nbytes for a in rows.fields.values())

    @property
    def is_empty(self) -> bool:
        return self.rows == 0

    def partitions(self) -> dict[int, list[ColumnarRows]]:
        """Window -> its appended runs, in append order."""
        with self._lock:
            return {w: list(p.chunks) for w, p in self._parts.items()}

    def chunks(self) -> list[ColumnarRows]:
        with self._lock:
            return [c for p in self._parts.values() for c in p.chunks]

    def scan(self, ts_min: int | None = None, ts_max: int | None = None,
             field_names: list[str] | None = None) -> ColumnarRows | None:
        """Concatenate chunks overlapping [ts_min, ts_max], row-filtered to
        the range. The rows are NOT globally sorted (the merge layer
        orders and dedups them by sequence)."""
        names = field_names if field_names is not None else self.field_names
        with self._lock:
            picks: list[ColumnarRows] = []
            for part in self._parts.values():
                if ts_min is not None and part.ts_max < ts_min:
                    continue
                if ts_max is not None and part.ts_min > ts_max:
                    continue
                picks.extend(part.chunks)
        if not picks:
            return None
        out = _concat_rows(picks, names)
        if ts_min is not None or ts_max is not None:
            lo = ts_min if ts_min is not None else -(2**63)
            hi = ts_max if ts_max is not None else 2**63 - 1
            sel = (out.ts >= lo) & (out.ts <= hi)
            if not sel.all():
                out = _slice_rows(out, sel)
        return out


def _slice_rows(rows: ColumnarRows, sel: np.ndarray) -> ColumnarRows:
    return ColumnarRows(
        sid=rows.sid[sel], ts=rows.ts[sel], seq=rows.seq[sel], op=rows.op[sel],
        fields={k: v[sel] for k, v in rows.fields.items()},
        field_valid=(
            None if rows.field_valid is None
            else {k: v[sel] for k, v in rows.field_valid.items()}
        ),
    )


def _concat_rows(chunks: list[ColumnarRows], names: list[str]) -> ColumnarRows:
    def cat(getter):
        return np.concatenate([getter(c) for c in chunks])

    fields = {}
    valids = {}
    any_valid = any(c.field_valid is not None for c in chunks)
    # a chunk may lack a field: fill it with invalid zeros
    any_missing = any(name not in c.fields for c in chunks for name in names)
    any_valid = any_valid or any_missing
    for name in names:
        have = [c for c in chunks if name in c.fields]
        dt = have[0].fields[name].dtype if have else np.dtype(np.float64)
        fields[name] = np.concatenate([
            c.fields[name] if name in c.fields else np.zeros(len(c), dt)
            for c in chunks
        ])
        if any_valid:
            valids[name] = np.concatenate([
                (c.field_valid[name]
                 if c.field_valid is not None and name in c.field_valid
                 else np.full(len(c), name in c.fields, bool))
                for c in chunks
            ])
    return ColumnarRows(
        sid=cat(lambda c: c.sid), ts=cat(lambda c: c.ts),
        seq=cat(lambda c: c.seq), op=cat(lambda c: c.op),
        fields=fields, field_valid=valids if any_valid else None,
    )
