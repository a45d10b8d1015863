#!/usr/bin/env python3
"""Time the port's fulltext host work against the JAX package's per-row
loops, on the host, over chip_smoke.py phase 18c's access log.

    python3 fulltext_compare.py [--batches 4] [--seed 0]

The log is chip_smoke.log_batch's: `--batches` flushes of 270,000 lines
made from `--seed` as phase 18c makes them (4 is the phase's 1,080,000
lines). Two pieces of work, each in turns: per row, port, port, per row.

- matches: each of phase 18c's queries (chip_smoke.LOG_QUERIES) over the
  whole message column, as its CPU reference evaluates them without
  sidecars. "per row" is the JAX package's evaluation, written out here
  over the port's parse tree (a row's lowered text, its set of words,
  the tree evaluated on them); "port" is `fulltext.eval_matches`.
- sidecar: the term -> row-group map of each flush at the default
  row-group size. "per row" is the JAX package's loop (every row's
  words, a set of groups per term, sorted); "port" is
  `sst._build_fulltext_sidecar`, whose blob must hold the same JSON.

Both legs' answers must be equal. Prints one JSON line per piece (each
leg's seconds) and, last, the host's CPU count and the card's name and
power limit where `nvidia-smi` answers. Needs no card and imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import zlib

import numpy as np

import chip_smoke as cs
from greptimedb_tpu_torch.query import fulltext as ft
from greptimedb_tpu_torch.storage import sst
from greptimedb_tpu_torch.storage.memtable import ColumnarRows
from greptimedb_tpu_torch.storage.puffin import PuffinReader

ROW_GROUP_ROWS = 256 * 1024     # write_sst's default


def row_eval(node, words, text) -> bool:
    """The JAX package's per-row evaluation of one parse-tree node."""
    if isinstance(node, ft._Term):
        return node.term in words
    if isinstance(node, ft._Phrase):
        return node.phrase in text
    if isinstance(node, ft._Not):
        return not row_eval(node.inner, words, text)
    parts = (row_eval(n, words, text) for n in node.nodes)
    return all(parts) if node.op == "and" else any(parts)


def per_row_matches(values, query) -> np.ndarray:
    node = ft._parse_query(query)
    out = np.zeros(len(values), dtype=bool)
    for i, v in enumerate(values):
        text = str(v).lower()
        out[i] = row_eval(node, set(ft._WORD_RE.findall(text)), text)
    return out


def per_row_doc(values) -> bytes:
    """The JAX package's term -> row-group map of one flush, as JSON."""
    term_groups: dict[str, set] = {}
    for i in range(len(values)):
        g = i // ROW_GROUP_ROWS
        for t in ft._WORD_RE.findall(str(values[i]).lower()):
            term_groups.setdefault(t, set()).add(g)
    return json.dumps({t: sorted(gs) for t, gs in term_groups.items()}
                      ).encode()


def port_doc(values) -> bytes:
    n = len(values)
    rows = ColumnarRows(sid=np.zeros(n, np.int32),
                        ts=np.arange(n, dtype=np.int64),
                        seq=np.arange(n, dtype=np.uint64),
                        op=np.zeros(n, np.uint8), fields={"message": values})
    reader = PuffinReader(sst._build_fulltext_sidecar(rows, ["message"],
                                                      ROW_GROUP_ROWS))
    blob = reader.find(sst.FULLTEXT_BLOB, column="message")
    return zlib.decompress(reader.read(blob))


def turns(per_row, port) -> dict:
    """per row, port, port, per row: each leg's seconds; the answers of
    every turn must be equal."""
    secs = {"per_row": [], "port": []}
    want = None
    for leg, fn in (("per_row", per_row), ("port", port), ("port", port),
                    ("per_row", per_row)):
        t = time.perf_counter()
        got = fn()
        secs[leg].append(time.perf_counter() - t)
        if want is None:
            want = got
        elif not all(np.array_equal(a, b) if isinstance(a, np.ndarray)
                     else a == b for a, b in zip(got, want)):
            raise AssertionError(f"{leg} answers differ")
    return secs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=cs.LOG_SSTS)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed + 18)
    batches = [cs.log_batch(rng, b)[2]["message"]
               for b in range(args.batches)]
    msg = np.concatenate(batches)
    for name, (query, _) in cs.LOG_QUERIES.items():
        secs = turns(lambda q=query: [per_row_matches(msg, q)],
                     lambda q=query: [ft.eval_matches(msg, q)])
        print(json.dumps({"piece": "matches", "query": name,
                          "rows": len(msg), "seconds": secs}), flush=True)
    secs = turns(lambda: [per_row_doc(b) for b in batches],
                 lambda: [port_doc(b) for b in batches])
    print(json.dumps({"piece": "sidecar", "flushes": len(batches),
                      "rows": len(msg), "seconds": secs}), flush=True)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        smi = None
    print(json.dumps({"host_cpus": os.cpu_count(), "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
