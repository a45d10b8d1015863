"""Slow-query logging.

Capability counterpart of the reference's StatementStatistics slow-query
support (GreptimeDB's src/cmd/src/standalone.rs:570 wiring + the
[logging.slow_query] config section): statements slower than the
threshold are logged and kept in a bounded ring surfaced through
`information_schema.slow_queries`.
"""

from __future__ import annotations

import logging
import random

import time
from collections import deque

from greptimedb_tpu_torch import concurrency

logger = logging.getLogger("greptimedb_tpu_torch.slow_query")


class SlowQueryLog:
    def __init__(self, *, enable: bool = True, threshold_s: float = 5.0,
                 sample_ratio: float = 1.0, capacity: int = 256):
        self.enable = enable
        self.threshold_s = float(threshold_s)
        self.sample_ratio = min(1.0, max(0.0, float(sample_ratio)))
        self._ring: deque = deque(maxlen=max(1, capacity))
        self._lock = concurrency.Lock()
        self.total_recorded = 0

    def maybe_record(self, sql: str, elapsed_s: float, *, db: str = "",
                     channel: str = "", trace_id: str | None = None,
                     fingerprint: str = ""):
        """Record one slow statement. `elapsed_s` MUST come from the
        monotonic clock (time.monotonic()/perf_counter deltas, never
        time.time() arithmetic — gtlint GT011); ts_ms below is an
        epoch-ms display timestamp only. `trace_id` links the entry to
        its trace in /v1/traces + information_schema.traces;
        `fingerprint` (the batch's first statement) joins it to its
        aggregate `information_schema.statement_statistics` row."""
        if not self.enable or elapsed_s < self.threshold_s:
            return
        if self.sample_ratio < 1.0 and random.random() > self.sample_ratio:
            return
        entry = {
            "ts_ms": int(time.time() * 1000),
            "cost_ms": round(elapsed_s * 1000.0, 3),
            "threshold_ms": round(self.threshold_s * 1000.0, 3),
            "query": sql[:4096],
            "schema": db,
            "channel": channel,
            "trace_id": trace_id or "",
            "fingerprint": fingerprint or "",
        }
        with self._lock:
            self._ring.append(entry)
            self.total_recorded += 1
        logger.warning(
            "slow query (%.1f ms > %.0f ms) [%s] trace=%s: %s",
            entry["cost_ms"], entry["threshold_ms"], db,
            entry["trace_id"] or "-", entry["query"],
        )

    def entries(self) -> list[dict]:
        with self._lock:
            return list(self._ring)
