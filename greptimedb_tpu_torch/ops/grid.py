"""Dense (series x time) grids from (sid, ts, value) rows (the JAX
package's ops/grid.py).

Cell convention: cell i holds samples with ts in (t0 + (i-1)*res,
t0 + i*res] — half-open on the left so that PromQL's (start, end] window
semantics align with cell boundaries whenever `res` divides the query
step and range. Timestamps on the device are int32 offsets from t0 in
`unit` ticks (unit chosen so the grid span fits in int32).

When a cell receives several samples, the one with the greatest row index
wins; scans yield rows in (series, ts) order, so that is the latest
sample.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class GridSpec:
    """Host-side description of a device grid."""

    t0: int          # absolute origin timestamp (exclusive lower bound), ms
    res: int         # cell resolution, ms
    num_cells: int   # T
    unit: int        # device ts tick in ms (1 unless the span overflows int32)
    tps: float       # device ts ticks per second (1000/unit)

    @staticmethod
    def build(t0: int, res: int, num_cells: int) -> "GridSpec":
        span = res * num_cells
        unit = 1
        while span // unit >= 2**31 - 1:
            unit *= 2
        return GridSpec(t0=t0, res=res, num_cells=num_cells, unit=unit,
                        tps=1000.0 / unit)

    def cell_of(self, ts: np.ndarray | int):
        """Cell index for absolute ts: ceil((ts - t0) / res), so a sample at
        exactly a cell boundary belongs to the cell ending there."""
        return -((-(np.asarray(ts) - self.t0)) // self.res)

    def device_ts(self, ts: np.ndarray) -> np.ndarray:
        return ((np.asarray(ts) - self.t0) // self.unit).astype(np.int32)


def gridify(sid: torch.Tensor, cell: torch.Tensor, tsrel: torch.Tensor,
            values: torch.Tensor, mask: torch.Tensor, num_series: int,
            num_cells: int):
    """Scatter rows to a dense grid. Returns (vals, has, tsg): vals (S, T)
    of values' dtype, has (S, T) bool, tsg (S, T) int32 (0 where empty).

    The winner of each (sid, cell) is the greatest row index among its
    valid rows (jax.ops.segment_max's); an int32 scatter_reduce("amax") is
    exact in any order, so the card's atomics give the same winners."""
    n = sid.shape[0]
    in_range = (mask & (cell >= 0) & (cell < num_cells) & (sid >= 0)
                & (sid < num_series))
    nseg = num_series * num_cells
    flat = torch.where(in_range,
                       sid.to(torch.int64) * num_cells + cell.to(torch.int64),
                       nseg)
    idx = torch.arange(n, dtype=torch.int32, device=sid.device)
    winner = torch.full((nseg + 1,), -1, dtype=torch.int32,
                        device=sid.device)
    winner.scatter_reduce_(0, flat, torch.where(in_range, idx, -1),
                           reduce="amax", include_self=True)
    winner = winner[:-1]
    has = winner >= 0
    safe = winner.clamp(min=0).to(torch.int64)
    shape = (num_series, num_cells)
    vals = torch.where(has, values[safe], torch.zeros((), dtype=values.dtype,
                                                      device=values.device))
    tsg = torch.where(has, tsrel[safe], 0).to(torch.int32)
    return vals.reshape(shape), has.reshape(shape), tsg.reshape(shape)
