"""Closed-loop knob control (the JAX package's ``tuning/``): so far only the
:class:`~s3shuffle_tpu_torch.tuning.controller.Controller` core that the
prefetcher's thread predictor binds."""
