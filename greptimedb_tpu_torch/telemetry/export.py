"""Metrics self-export: periodically import the node's own metrics into
the TSDB (or push them to a remote-write endpoint).

Capability counterpart of the reference's ExportMetricsTask
(GreptimeDB's src/servers/src/export_metrics.rs:81-191): every
`interval_s` the global registry is scraped in-process and written
through the same per-metric table path Prometheus remote write uses, so
`select * from greptime_http_requests_total` works on the node itself.
"""

from __future__ import annotations

import re
import threading

import time

from greptimedb_tpu_torch.telemetry.metrics import global_registry

from greptimedb_tpu_torch import concurrency

_LINE = re.compile(
    r"^(?P<name>[A-Za-z_:][A-Za-z0-9_:]*)"
    # quote-aware label block: a '}' inside a quoted label value (e.g.
    # path="a}b") must not terminate the block early
    r'(?:\{(?P<labels>(?:[^"}]|"(?:[^"\\]|\\.)*")*)\})?\s+(?P<value>[^\s]+)$'
)
_LABEL = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="((?:[^"\\]|\\.)*)"')


def scrape_registry(now_ms: int | None = None,
                    extra_labels: dict | None = None) -> list:
    """Render the global registry and parse it into remote-write-shaped
    series: [(labels-with-__name__, [(value, ts_ms)])]. `extra_labels`
    (e.g. {"node": ..., "role": ...}) stamp every series WITHOUT
    overriding a label the metric already carries — two roles exporting
    into one greptime_metrics database must never collide into one
    series."""
    now_ms = now_ms if now_ms is not None else int(time.time() * 1000)
    series = []
    for line in global_registry.render().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _LINE.match(line)
        if m is None:
            continue
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        labels = {"__name__": m.group("name")}
        if m.group("labels"):
            for lk, lv in _LABEL.findall(m.group("labels")):
                labels[lk] = lv.replace('\\"', '"').replace("\\\\", "\\")
        if extra_labels:
            for lk, lv in extra_labels.items():
                if lv:
                    labels.setdefault(lk, str(lv))
        series.append((labels, [(value, now_ms)]))
    return series


class ExportMetricsTask:
    """Background self-import loop. `instance` is a Standalone (or any
    object with the catalog/_notify_flows surface apply_series needs)."""

    def __init__(self, instance, *, db: str = "greptime_metrics",
                 interval_s: float = 30.0, node: str | None = None,
                 role: str | None = None):
        self.instance = instance
        self.db = db
        self.interval_s = max(1.0, float(interval_s))
        # node/role identity labels stamped on every re-ingested
        # series. None = resolve from the instance AT TICK TIME (the
        # dialable address may bind after this task is constructed).
        self.node = node
        self.role = role
        self._stop = concurrency.Event()
        self._thread: threading.Thread | None = None
        self.runs = 0
        self.samples_written = 0
        self.failures = 0
        self._last_error: str | None = None

    def _identity_labels(self) -> dict:
        node = self.node
        if node is None:
            node = getattr(self.instance, "node_addr", "") or ""
        role = self.role
        if role is None:
            role = getattr(self.instance, "node_role", "") or ""
        return {"node": node, "role": role}

    def start(self):
        self.instance.catalog.create_database(self.db, if_not_exists=True)
        # one immediate tick BEFORE the interval loop: the first
        # samples land at startup, not a full interval_s later (an
        # operator querying greptime_metrics right after boot sees
        # data; the loop thread then keeps the cadence). A failing
        # first tick must not abort startup — it counts like a loop
        # failure and the loop retries.
        self._safe_tick()
        self._thread = concurrency.Thread(
            target=self._loop, daemon=True, name="export-metrics"
        )
        self._thread.start()
        return self

    def tick(self):
        """One scrape+import cycle (also called by the loop). Duration
        lands on the greptime_export_metrics_duration_seconds histogram
        so a slow scrape/import (large registry, slow storage) is
        visible before it starts eating the interval."""
        import time as _time

        from greptimedb_tpu_torch.servers.prom_store import apply_series

        t0 = _time.perf_counter()
        try:
            series = scrape_registry(
                extra_labels=self._identity_labels()
            )
            if series:
                self.samples_written += apply_series(
                    self.instance, series, db=self.db
                )
            self.runs += 1
        finally:
            global_registry.histogram(
                "greptime_export_metrics_duration_seconds",
                "wall time of one metrics self-export tick",
            ).observe(_time.perf_counter() - t0)

    def _safe_tick(self):
        import logging

        try:
            self.tick()
        except Exception as e:  # export must never take the node down,
            # but persistent failures need a trace: log each distinct
            # error once and count every failure in the registry
            self.failures += 1
            global_registry.counter(
                "greptime_export_metrics_failures_total",
                "metrics self-export tick failures",
            ).inc()
            msg = f"{type(e).__name__}: {e}"
            if msg != self._last_error:
                self._last_error = msg
                logging.getLogger("greptimedb_tpu_torch.export").warning(
                    "metrics self-export failing: %s", msg
                )

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            self._safe_tick()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
