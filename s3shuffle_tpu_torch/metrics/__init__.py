"""The port's metrics registry (the JAX package's ``metrics`` package
without its per-shuffle stats reports): typed instruments, off unless
``S3SHUFFLE_METRICS`` is set or :func:`enable` is called."""

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
]
