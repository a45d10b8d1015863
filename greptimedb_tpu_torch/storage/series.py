"""Per-region series registry: tag-value tuples -> dense int32 series ids.

Sids are what runs store and what the device grids are indexed by; tag
strings live only here (copy of the JAX package's SeriesRegistry with its
matcher algebra, without persistence).
"""

from __future__ import annotations

import threading

import numpy as np

from greptimedb_tpu_torch.datatypes.batch import Dictionary


def missing_tag_ok(op: str, value) -> bool:
    """Constant matcher verdict for a tag name absent from the schema —
    a missing tag behaves as the empty string on every series."""
    if op == "eq":
        return value == ""
    if op == "ne":
        return value != ""
    if op == "in":
        return "" in value
    if op == "nin":
        return "" not in value
    if op == "re":
        return bool(value.fullmatch(""))
    if op == "nre":
        return not value.fullmatch("")
    raise ValueError(op)


def ok_codes_for(vals: np.ndarray, op: str, value) -> np.ndarray:
    """Per-distinct-value matcher verdicts over one tag dictionary:
    (len(vals),) bool. All predicate string/regex work happens here —
    O(distinct values) — and is broadcast through the int32 code
    columns by match_mask."""
    if op == "eq":
        ok_codes = vals == value
    elif op == "ne":
        ok_codes = vals != value
    elif op == "in":
        ok_codes = np.isin(vals.astype(str), list(value))
    elif op == "nin":
        ok_codes = ~np.isin(vals.astype(str), list(value))
    elif op == "re":
        # dtype=bool: an EMPTY comprehension defaults to float64
        ok_codes = np.asarray(
            [bool(value.fullmatch(str(v))) for v in vals], dtype=bool)
    elif op == "nre":
        ok_codes = np.asarray(
            [not value.fullmatch(str(v)) for v in vals], dtype=bool)
    else:
        raise ValueError(op)
    return np.asarray(ok_codes, dtype=bool)


class SeriesRegistry:
    def __init__(self, tag_names: list[str]):
        self.tag_names = list(tag_names)
        self.dicts = [Dictionary() for _ in tag_names]
        self._series: dict[tuple, int] = {}
        self._rows: list[tuple] = []
        self._lock = threading.Lock()
        self._codes_cache: np.ndarray | None = None
        # bumped on every mutation that can change which series exist
        self._version = 0

    @property
    def version(self) -> int:
        return self._version

    def __len__(self) -> int:
        return len(self._rows)

    @property
    def num_series(self) -> int:
        return len(self._rows)

    def intern_rows(self, tag_columns: list[np.ndarray],
                    n: int | None = None) -> np.ndarray:
        """Map N rows of tag values to sids, creating new series on demand.
        tag_columns are aligned with tag_names. For tagless tables pass `n`
        explicitly (every row maps to series 0)."""
        sids, _ = self.intern_rows_delta(tag_columns, n)
        return sids

    def intern_rows_delta(
        self, tag_columns: list[np.ndarray], n: int | None = None,
    ) -> tuple[np.ndarray, list[tuple[int, list[str]]]]:
        """intern_rows that also reports the series this batch created as
        (sid, decoded tag values) in sid order: what the WAL records so
        replay rebuilds the registry without re-interning strings."""
        assert len(tag_columns) == len(self.tag_names)
        if tag_columns:
            n = len(tag_columns[0])
        elif n is None:
            n = 0
        with self._lock:
            if not tag_columns:
                new: list[tuple[int, list[str]]] = []
                if not self._rows:
                    self._series[()] = 0
                    self._rows.append(())
                    new.append((0, []))
                    self._version += 1
                return np.zeros(n, dtype=np.int32), new
            codes = [d.intern_array(c) for d, c in zip(self.dicts, tag_columns)]
            # dict work only on distinct tag combinations: rows fold into
            # one int64 key when the code space fits (radix = dict sizes)
            radices = [len(d) + 1 for d in self.dicts]
            space = 1
            for r in radices:
                space *= r
            if space < 2**62:
                key = codes[0].astype(np.int64)
                for c, r in zip(codes[1:], radices[1:]):
                    key = key * r + c
                _, first, inv = np.unique(
                    key, return_index=True, return_inverse=True
                )
            else:
                _, first, inv = np.unique(
                    np.stack(codes, axis=1), axis=0,
                    return_index=True, return_inverse=True,
                )
            uniq_sids = np.empty(len(first), dtype=np.int32)
            new = []
            for i, row_idx in enumerate(first):
                key_t = tuple(int(c[row_idx]) for c in codes)
                sid = self._series.get(key_t)
                if sid is None:
                    sid = len(self._rows)
                    self._series[key_t] = sid
                    self._rows.append(key_t)
                    new.append((sid, [d.decode(c)
                                      for d, c in zip(self.dicts, key_t)]))
                uniq_sids[i] = sid
            if new:
                self._version += 1
            return uniq_sids[np.ravel(inv)], new

    def ensure_series(self, sid: int, tag_values: list[str]) -> None:
        """Idempotently (re)create one series at a known sid: the WAL
        replay of an intern delta. Sids arrive in creation order, so a gap
        means a corrupt log."""
        with self._lock:
            if sid < len(self._rows):
                return
            if sid != len(self._rows):
                raise ValueError(
                    f"series id gap in replay: have {len(self._rows)}, "
                    f"got {sid}")
            vals = list(tag_values) + [""] * (len(self.dicts)
                                              - len(tag_values))
            key = tuple(d.intern(v) for d, v in zip(self.dicts, vals))
            self._series[key] = sid
            self._rows.append(key)
            self._version += 1

    def tag_codes(self, tag_name: str) -> np.ndarray:
        """Per-sid code of one tag column: (num_series,) int32."""
        i = self.tag_names.index(tag_name)
        if not self._rows or not self.tag_names:
            return np.zeros(len(self._rows), dtype=np.int32)
        return self.codes_matrix()[:, i]

    def codes_matrix(self) -> np.ndarray:
        """(num_series, num_tags) int32 per-sid tag codes, cached."""
        with self._lock:
            n = len(self._rows)
            k = len(self.tag_names)
            c = self._codes_cache
            if c is not None and c.shape == (n, k):
                return c
            if n == 0 or k == 0:
                c = np.zeros((n, k), dtype=np.int32)
            else:
                c = np.asarray(self._rows, dtype=np.int32).reshape(n, k)
            self._codes_cache = c
            return c

    def tag_values(self, tag_name: str) -> np.ndarray:
        """Per-sid decoded value of one tag column: (num_series,) object."""
        i = self.tag_names.index(tag_name)
        d = self.dicts[i]
        return np.asarray([d.decode(r[i]) for r in self._rows], dtype=object)

    def match_mask(self, matchers: list[tuple[str, str, object]]
                   ) -> np.ndarray:
        """(num_series,) bool mask of series satisfying all matchers.

        Predicates are evaluated once per distinct dictionary value
        (regexes included), then broadcast through the int32 code columns
        — O(distinct values) string work instead of O(series)."""
        n = len(self._rows)
        keep = np.ones(n, dtype=bool)
        codes = self.codes_matrix()
        for name, op, value in matchers:
            if name not in self.tag_names:
                if not missing_tag_ok(op, value):
                    keep[:] = False
                continue
            i = self.tag_names.index(name)
            vals = np.asarray(list(self.dicts[i].values), dtype=object)
            keep &= ok_codes_for(vals, op, value)[codes[:, i]]
        return keep

    def series_tags(self, sid: int) -> dict[str, str]:
        row = self._rows[sid]
        return {
            name: d.decode(code)
            for name, d, code in zip(self.tag_names, self.dicts, row)
        }

    # ---- persistence --------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "tag_names": list(self.tag_names),
                "dicts": [list(d.values) for d in self.dicts],
                "rows": [[int(c) for c in r] for r in self._rows],
            }

    @staticmethod
    def restore(obj: dict) -> "SeriesRegistry":
        reg = SeriesRegistry(obj["tag_names"])
        reg.dicts = [Dictionary(vals) for vals in obj["dicts"]]
        reg._rows = [tuple(r) for r in obj["rows"]]
        reg._series = {r: i for i, r in enumerate(reg._rows)}
        reg._version = len(reg._rows)
        return reg
