"""Trace-plane declarations (the JAX package's ``trace`` package): the
span-name table :data:`~s3shuffle_tpu_torch.trace.names.KNOWN_SPANS`. The
runtime tracer is :mod:`s3shuffle_tpu_torch.utils.trace`."""

from s3shuffle_tpu_torch.trace.names import KNOWN_SPANS

__all__ = ["KNOWN_SPANS"]
