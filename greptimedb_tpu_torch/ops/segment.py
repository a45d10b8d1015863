"""Segmented scans: the running frames of SQL window functions (the JAX
package's ops/segment.py:211-292).

`reset[i]` marks the first row of a segment (a partition). Each function
is the JAX package's jax.lax.associative_scan with the same combine, run
in associative_scan's combine tree by kernel S
(parallel/kernels/segmented_scan.py): on a CUDA tensor the hand kernel, on
a CPU tensor its plain version. Every result is bit for bit the JAX
package's.
"""

from __future__ import annotations

import torch

from greptimedb_tpu_torch.parallel.kernels.segmented_scan import (
    segmented_scan,
)


def segmented_cumsum(values: torch.Tensor,
                     reset: torch.Tensor) -> torch.Tensor:
    """Per-segment running sum of int32, int64 or float64 values."""
    return segmented_scan("add", values, reset)


def segmented_cumextreme(values: torch.Tensor, reset: torch.Tensor, *,
                         take_max: bool) -> torch.Tensor:
    """Per-segment running max (or min) of float64 values, as XLA's
    maximum/minimum (NaN propagates, -0.0 below +0.0)."""
    return segmented_scan("max" if take_max else "min", values, reset)


def segmented_cumsum_compensated_packed(v_hi: torch.Tensor,
                                        v_lo: torch.Tensor,
                                        reset: torch.Tensor) -> torch.Tensor:
    """(2, N) stacked (sum, comp) of segmented_cumsum_compensated: one
    buffer, one readback."""
    return segmented_scan("comp", v_hi, reset, v_lo)


def segmented_cumsum_compensated(v_hi: torch.Tensor, v_lo: torch.Tensor,
                                 reset: torch.Tensor):
    """Neumaier-compensated per-segment running sum over two-float f32
    input (v_hi + v_lo ~= the f64 value): each element enters with its
    split low part as the initial compensation; the combine two-sums the
    high parts and accumulates the rounding residue, so sum + comp
    recovers the f64 running sum to ~1 ulp. Returns (sum, comp) f32."""
    s, c = segmented_cumsum_compensated_packed(v_hi, v_lo, reset)
    return s, c


def segmented_cumextreme2(v_hi: torch.Tensor, v_lo: torch.Tensor,
                          reset: torch.Tensor, *, take_max: bool):
    """Per-segment running extreme over two-float (hi, lo) pairs,
    compared lexicographically (ties to the left). Returns the winning
    (hi, lo) arrays."""
    h, lo = segmented_scan("max2" if take_max else "min2", v_hi, reset,
                           v_lo)
    return h, lo
