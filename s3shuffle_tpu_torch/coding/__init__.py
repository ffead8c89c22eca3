"""The coded shuffle plane: GF(2^8) parity sidecars (``parity.py``, written
beside each data object) and loss reconstruction on read (``degraded.py``),
on the batched parity encode kernel K4 (``gf.py``, ``gf_cuda.py``)."""

#: the package's exports, each loaded from its module on first use (an
#: eager import here would close an import cycle through ``skew`` and ``read.prefetch``)
_LAZY = {
    "ParityAccumulator": "s3shuffle_tpu_torch.coding.parity",
    "ParityGeometry": "s3shuffle_tpu_torch.coding.parity",
    "accumulator_from_config": "s3shuffle_tpu_torch.coding.parity",
    "parity_blocks_for": "s3shuffle_tpu_torch.coding.parity",
    "DegradedReader": "s3shuffle_tpu_torch.coding.degraded",
    "SpeculativeFetcher": "s3shuffle_tpu_torch.coding.degraded",
}

__all__ = [
    "ParityAccumulator",
    "ParityGeometry",
    "accumulator_from_config",
    "parity_blocks_for",
    "DegradedReader",
    "SpeculativeFetcher",
]


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(module), name)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
