"""Device -> host readback: the only places the port syncs with the card.

Every device result the host consumes crosses here, so the bytes moved
are counted in one place (`readback_bytes`). A sharded result is gathered
onto its first shard's device and read back once. The step-sliced delta
read arrives with the `since` cursor, which the port does not have yet.
"""

from __future__ import annotations

import numpy as np
import torch

from greptimedb_tpu_torch.parallel.dist import gather_blocks

readback_bytes = {"full": 0}


def read_full(t: torch.Tensor, dtype=None) -> np.ndarray:
    """Whole tensor to a host numpy array (optionally cast on the host)."""
    out = t.detach().cpu().numpy()
    readback_bytes["full"] += out.nbytes
    if dtype is not None:
        out = out.astype(dtype, copy=False)
    return out


def read_gathered(parts: list, dim: int = 0, stop: int | None = None
                  ) -> np.ndarray:
    """Per-shard parts of one result, concatenated along `dim` in shard
    order on the first shard's device, cut to [:stop] along `dim` there,
    and read back once."""
    t = parts[0] if len(parts) == 1 else gather_blocks(parts, dim=dim)
    if stop is not None:
        t = t.narrow(dim, 0, stop)
    return read_full(t)
