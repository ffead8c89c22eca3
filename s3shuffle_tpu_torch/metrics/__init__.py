"""The port's metrics subsystem (the JAX package's ``metrics`` package):
the typed registry, off unless ``S3SHUFFLE_METRICS`` is set or
:func:`enable` is called, and the per-shuffle stats reports
(:mod:`.stats`)."""

from s3shuffle_tpu_torch.metrics.registry import (
    DEFAULT_BYTES_BUCKETS,
    DEFAULT_TIME_BUCKETS,
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    disable,
    enable,
    enabled,
    exponential_buckets,
    render_prometheus,
)
from s3shuffle_tpu_torch.metrics.stats import (
    COLLECTOR,
    ShuffleStats,
    ShuffleStatsCollector,
    TaskStats,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "REGISTRY",
    "DEFAULT_BYTES_BUCKETS",
    "DEFAULT_TIME_BUCKETS",
    "disable",
    "enable",
    "enabled",
    "exponential_buckets",
    "render_prometheus",
    "COLLECTOR",
    "ShuffleStats",
    "ShuffleStatsCollector",
    "TaskStats",
]
