from greptimedb_tpu_torch.telemetry.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    global_registry,
)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "global_registry"]
