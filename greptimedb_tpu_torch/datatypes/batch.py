"""Tag dictionaries: string -> dense int32 code, one per tag column, and
the row-axis shape buckets of the device GROUP BY (`bucket_size`,
`pad_to`, copied from the JAX package's datatypes/batch.py).

The device never sees strings: tag values are interned here at ingest and
group-by and series identification run over the codes. Codes are handed
out in order of first occurrence within a batch, as the JAX package's
Arrow dictionary encode does, so the same writes give the same codes (and
therefore the same series ids) in both packages.
"""

from __future__ import annotations

import numpy as np


def _encode_first_occurrence(values: np.ndarray):
    """(distinct values in first-occurrence order, per-row index into
    them). np.unique sorts; the ranks of each distinct value's first row
    restore first-occurrence order."""
    uniq, first, inv = np.unique(values, return_index=True,
                                 return_inverse=True)
    perm = np.argsort(first, kind="stable")
    rank = np.empty(len(perm), np.int64)
    rank[perm] = np.arange(len(perm))
    return uniq[perm], rank[np.ravel(inv)]


class Dictionary:
    """Incremental string -> int32 code dictionary."""

    def __init__(self, values: list[str] | None = None):
        self._values: list[str] = list(values or [])
        self._codes: dict[str, int] = {v: i for i, v in
                                       enumerate(self._values)}

    def __len__(self) -> int:
        return len(self._values)

    def intern(self, value: str) -> int:
        code = self._codes.get(value)
        if code is None:
            code = len(self._values)
            self._codes[value] = code
            self._values.append(value)
        return code

    def intern_array(self, values: np.ndarray) -> np.ndarray:
        """Vectorized interning: dictionary work only on the distinct
        values of the batch, then one take to expand."""
        values = np.asarray(values)
        if len(values) == 0:
            return np.zeros(0, np.int32)
        uniq, inv = _encode_first_occurrence(values)
        uniq_codes = np.empty(len(uniq), dtype=np.int32)
        for i, v in enumerate(uniq):
            uniq_codes[i] = self.intern(str(v))
        return uniq_codes[inv]

    def decode(self, code: int) -> str:
        return self._values[code]

    @property
    def values(self) -> list[str]:
        return self._values


def bucket_size(n: int, *, minimum: int = 1024) -> int:
    """Round ``n`` up to a power-of-two shape bucket (at least
    ``minimum``)."""
    if n <= 0:
        return minimum
    b = minimum
    while b < n:
        b *= 2
    return b


def pad_to(values: np.ndarray, n: int, fill=0) -> np.ndarray:
    """Pad a 1-D array up to length ``n`` with ``fill``."""
    if len(values) == n:
        return values
    if len(values) > n:
        raise ValueError(f"cannot pad {len(values)} values to {n}")
    out = np.full(n, fill, dtype=values.dtype)
    out[: len(values)] = values
    return out
