"""Device -> host readback: the only places the port syncs with the card.

Every device result the host consumes crosses here, so the bytes moved
are counted in one place (`readback_bytes`: "full" for whole buffers,
"delta" for the step slices of `since` polls). A delta poll narrows the
buffer along its steps axis on the card and makes it contiguous there
before the copy, so only the delta's bytes cross PCIe. A sharded result
is gathered onto its first shard's device and read back once.
"""

from __future__ import annotations

import numpy as np
import torch

from greptimedb_tpu_torch.parallel.dist import gather_blocks

readback_bytes = {"full": 0, "delta": 0}


def _copy(t: torch.Tensor, mode: str, dtype=None) -> np.ndarray:
    out = t.detach().cpu().numpy()
    readback_bytes[mode] += out.nbytes
    if dtype is not None:
        out = out.astype(dtype, copy=False)
    return out


def read_full(t: torch.Tensor, dtype=None) -> np.ndarray:
    """Whole tensor to a host numpy array (optionally cast on the host)."""
    return _copy(t, "full", dtype)


def read_delta(t: torch.Tensor, lo: int, *, axis: int = -1) -> np.ndarray:
    """Only `t[..., lo:]` along `axis` to the host. The narrowed view is
    strided, so it is made contiguous on the card first: the copy moves
    exactly the delta's bytes. `lo <= 0` is `read_full`."""
    if lo <= 0:
        return read_full(t)
    return _copy(t.narrow(axis, lo, t.shape[axis] - lo).contiguous(),
                 "delta")


def read_gathered(parts: list, dim: int = 0, stop: int | None = None, *,
                  lo: int = 0, axis: int = -1) -> np.ndarray:
    """Per-shard parts of one result, concatenated along `dim` in shard
    order on the first shard's device, cut to [:stop] along `dim` there,
    and read back once; with `lo > 0` each part is first narrowed to
    [lo:] along `axis` (a `since` delta: the steps axis, not `dim`) on
    its own device, so neither the gather nor the copy moves the steps
    the client has."""
    if lo > 0:
        parts = [p.narrow(axis, lo, p.shape[axis] - lo) for p in parts]
    t = parts[0] if len(parts) == 1 else gather_blocks(parts, dim=dim)
    if stop is not None:
        t = t.narrow(dim, 0, stop)
    if lo > 0:
        return _copy(t.contiguous(), "delta")
    return read_full(t)
