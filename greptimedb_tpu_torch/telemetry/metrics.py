"""Prometheus-style in-process metrics.

Capability counterpart of the reference's per-crate Prometheus registries
(GreptimeDB's src/*/src/metrics.rs + the /metrics endpoint,
src/servers/src/metrics_handler.rs): counters, gauges, histograms with
labels, rendered in the text exposition format.
"""

from __future__ import annotations

import time

from greptimedb_tpu_torch import concurrency


class MetricRegistrationError(TypeError):
    """A metric name was re-registered as a different type or with a
    different label set. The registry is get-or-create by name, so the
    second registration used to silently return the FIRST metric — and
    the caller's `.labels(...)` then raised (or mislabelled) far from
    the actual bug. Raised at registration time instead, naming both
    schemas."""


class _Metric:
    def __init__(self, name: str, help_: str, label_names: tuple[str, ...]):
        self.name = name
        self.help = help_
        self.label_names = label_names
        self._children: dict[tuple, object] = {}
        self._lock = concurrency.Lock()

    def labels(self, *values: str):
        key = tuple(str(v) for v in values)
        if len(key) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected {len(self.label_names)} labels"
            )
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._new_child()
                self._children[key] = child
            return child

    def _snapshot(self) -> list[tuple[tuple, object]]:
        with self._lock:
            return list(self._children.items())

    def _default(self):
        return self.labels()


def _fmt_labels(names, values) -> str:
    if not names:
        return ""
    inner = ",".join(
        f'{n}="{v}"' for n, v in zip(names, values)
    )
    return "{" + inner + "}"


class _CounterChild:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = concurrency.Lock()

    def inc(self, amount: float = 1.0):
        with self._lock:
            self.value += amount


class Counter(_Metric):
    def _new_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0):
        self._default().inc(amount)

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} counter"]
        for key, c in self._snapshot():
            out.append(
                f"{self.name}{_fmt_labels(self.label_names, key)} {c.value}"
            )
        return out


class _GaugeChild:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = concurrency.Lock()

    def set(self, v: float):
        with self._lock:
            self.value = float(v)

    def inc(self, amount: float = 1.0):
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0):
        self.inc(-amount)


class Gauge(_Metric):
    def _new_child(self):
        return _GaugeChild()

    def set(self, v: float):
        self._default().set(v)

    def inc(self, amount: float = 1.0):
        self._default().inc(amount)

    def dec(self, amount: float = 1.0):
        self._default().dec(amount)

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} gauge"]
        for key, c in self._snapshot():
            out.append(
                f"{self.name}{_fmt_labels(self.label_names, key)} {c.value}"
            )
        return out


_DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    5.0, 10.0,
)


class _HistogramChild:
    __slots__ = ("buckets", "counts", "total", "count", "_lock")

    def __init__(self, buckets):
        self.buckets = buckets
        self.counts = [0] * len(buckets)
        self.total = 0.0
        self.count = 0
        self._lock = concurrency.Lock()

    def observe(self, v: float):
        with self._lock:
            self.total += v
            self.count += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self.counts[i] += 1

    def time(self):
        return _Timer(self)


class _Timer:
    def __init__(self, child):
        self.child = child

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.child.observe(time.perf_counter() - self.t0)


class Histogram(_Metric):
    def __init__(self, name, help_, label_names=(), buckets=_DEFAULT_BUCKETS):
        super().__init__(name, help_, label_names)
        self.buckets = tuple(buckets)

    def _new_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, v: float):
        self._default().observe(v)

    def time(self):
        return self._default().time()

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        for key, c in self._snapshot():
            # read counts/total/count under the child lock: a scrape
            # racing observe() must never see a half-applied observation
            # (low buckets bumped, high buckets not yet — a non-monotone
            # cumulative family — or sum/count disagreeing with +Inf)
            with c._lock:
                counts = list(c.counts)
                total = c.total
                count = c.count
            # observe() increments every bucket with v <= bound, so counts
            # are already cumulative as the exposition format requires
            for b, n in zip(self.buckets, counts):
                lab = _fmt_labels(
                    self.label_names + ("le",), key + (repr(float(b)),)
                )
                out.append(f"{self.name}_bucket{lab} {n}")
            lab = _fmt_labels(self.label_names + ("le",), key + ("+Inf",))
            out.append(f"{self.name}_bucket{lab} {count}")
            out.append(
                f"{self.name}_sum{_fmt_labels(self.label_names, key)} "
                f"{total}"
            )
            out.append(
                f"{self.name}_count{_fmt_labels(self.label_names, key)} "
                f"{count}"
            )
        return out


def observe_bucket(buckets: list, bounds: tuple, v: float):
    """Non-cumulative bucket observe for registry-local histograms
    (stmt_stats latency/queue, device-program execute): one increment
    per observation, with a trailing OVERFLOW slot past the last bound
    so slow outliers still count toward the percentiles. `buckets`
    must be len(bounds) + 1."""
    for i, b in enumerate(bounds):
        if v <= b:
            buckets[i] += 1
            return
    buckets[-1] += 1


def bucket_quantile(buckets: list, bounds: tuple, q: float) -> float:
    """Linear-interpolated quantile over observe_bucket counts; the
    overflow slot reports at the last bound (a floor — the registries
    do not track the true maximum)."""
    total = sum(buckets)
    if total == 0:
        return 0.0
    target = q * total
    cum = 0
    prev = 0.0
    for i, b in enumerate(bounds):
        n = buckets[i]
        if n and cum + n >= target:
            return prev + (b - prev) * ((target - cum) / n)
        cum += n
        prev = b
    return bounds[-1]


def set_child_value(child, value: float):
    """Pull-model publisher helper: overwrite a counter/gauge child's
    value under its lock (scrape-time publishers — stmt_stats, the
    device-program profiler — refresh exported families from their
    registries instead of incrementing on the hot path)."""
    with child._lock:
        child.value = float(value)


class MetricsRegistry:
    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = concurrency.Lock()
        # scrape-time callbacks (run at the START of render, outside the
        # registry lock): pull-model publishers — the memory accountant
        # refreshes its per-pool gauges here so /metrics always shows
        # current pool state without a background thread
        self._collectors: list = []

    def counter(self, name, help_="", labels=()) -> Counter:
        return self._get(name, Counter, tuple(labels),
                         lambda: Counter(name, help_, tuple(labels)))

    def gauge(self, name, help_="", labels=()) -> Gauge:
        return self._get(name, Gauge, tuple(labels),
                         lambda: Gauge(name, help_, tuple(labels)))

    def histogram(self, name, help_="", labels=(),
                  buckets=_DEFAULT_BUCKETS) -> Histogram:
        return self._get(
            name, Histogram, tuple(labels),
            lambda: Histogram(name, help_, tuple(labels), buckets)
        )

    def _get(self, name, cls, label_names, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
                return m
        # conflict checks OUTSIDE the lock (pure reads of immutable
        # registration-time attributes)
        if type(m) is not cls:
            raise MetricRegistrationError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, re-registered as {cls.__name__}"
            )
        if m.label_names != label_names:
            raise MetricRegistrationError(
                f"metric {name!r} already registered with labels "
                f"{m.label_names!r}, re-registered with {label_names!r}"
                " — use MetricsRegistry.get(name) for lookups"
            )
        return m

    def get(self, name) -> _Metric:
        """Look up an existing metric WITHOUT declaring its schema
        (bench/test readers that only consume values). KeyError when
        the metric has not been registered by its owning module yet."""
        with self._lock:
            m = self._metrics.get(name)
        if m is None:
            raise KeyError(f"metric {name!r} is not registered")
        return m

    def register_collector(self, fn) -> None:
        """Add a scrape-time callback invoked before every render()."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def render(self) -> str:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            except Exception as e:  # noqa: BLE001 - a broken publisher
                # must never take /metrics down with it
                import logging

                logging.getLogger("greptimedb_tpu_torch.metrics").debug(
                    "metrics collector failed: %s", e
                )
        with self._lock:
            metrics = list(self._metrics.values())
        lines = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


global_registry = MetricsRegistry()
