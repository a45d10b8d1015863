"""Tag matching over a SeriesRegistry (the host half of the JAX package's
index/tag_index.py).

`match_sids` evaluates a scan's tag matchers — (tag, op, value) with op
in eq/ne/in/nin/re/nre — once per distinct dictionary value and
broadcasts the verdicts through the per-sid code columns
(SeriesRegistry.match_mask). The JAX package's secondary index (posting
lists, its `[index]` knobs and metrics) and its device plane are not
ported; the registry's full-plane compare is the oracle both packages
share. `matcher_key` is the canonical memo key of a matcher set.
"""

from __future__ import annotations

import numpy as np


def matcher_key(matchers) -> tuple:
    """Canonical hashable key for a matcher set: compiled regexes fold to
    their pattern string, list values to sorted tuples. Order-sensitive
    (matcher sets arrive in plan order, which is stable per statement)."""
    out = []
    for name, op, value in matchers:
        if op in ("re", "nre"):
            v = getattr(value, "pattern", value)
        elif isinstance(value, (list, tuple, set, frozenset)):
            v = tuple(sorted(str(x) for x in value))
        else:
            v = value
        out.append((name, op, v))
    return tuple(out)


def match_sids(registry, matchers) -> np.ndarray:
    """Ascending int32 sids of the series satisfying every matcher."""
    if not matchers:
        return np.arange(registry.num_series, dtype=np.int32)
    return np.flatnonzero(registry.match_mask(matchers)).astype(np.int32)
