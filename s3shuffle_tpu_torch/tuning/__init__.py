"""Online autotuner (the JAX package's ``tuning/``): closed-loop knob
controllers over the live metrics registry.

- :mod:`~s3shuffle_tpu_torch.tuning.controller`: the shared hill-climb core
  (ladder clamps, bounded steps, hysteresis, cooldown) that the prefetcher's
  thread predictor binds too;
- :mod:`~s3shuffle_tpu_torch.tuning.tuners`: the read-side
  :class:`ScanTuner` and the write-side :class:`CommitTuner`, built by the
  dispatcher when ``autotune`` is on;
- :mod:`~s3shuffle_tpu_torch.tuning.profile`: their warm-start profile.
"""

from s3shuffle_tpu_torch.tuning.controller import (
    DEFAULT_RING_SIZE,
    Controller,
    geometric_ladder,
)
from s3shuffle_tpu_torch.tuning.tuners import CommitTuner, ScanTuner, tuner_state

__all__ = [
    "Controller",
    "CommitTuner",
    "DEFAULT_RING_SIZE",
    "ScanTuner",
    "geometric_ladder",
    "tuner_state",
]
