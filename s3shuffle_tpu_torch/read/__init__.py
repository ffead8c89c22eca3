"""Reduce side of the port: ranged block reads, checksum validation and
batched device decode."""

#: the package's exports, each loaded from its module on first use (an
#: eager import here would close an import cycle through ``coding.degraded`` and ``skew``)
_LAZY = {
    "BlockStream": "s3shuffle_tpu_torch.read.block_stream",
    "BlockIterator": "s3shuffle_tpu_torch.read.block_iterator",
    "BufferedPrefetchIterator": "s3shuffle_tpu_torch.read.prefetch",
    "ThreadPredictor": "s3shuffle_tpu_torch.read.prefetch",
    "ChecksumError": "s3shuffle_tpu_torch.read.checksum_stream",
    "ChecksumValidationStream": "s3shuffle_tpu_torch.read.checksum_stream",
    "ShuffleReader": "s3shuffle_tpu_torch.read.reader",
    "ShuffleReadMetrics": "s3shuffle_tpu_torch.read.reader",
    "CoalescedScanIterator": "s3shuffle_tpu_torch.read.scan_plan",
    "ScanSegment": "s3shuffle_tpu_torch.read.scan_plan",
    "SlicedBlockStream": "s3shuffle_tpu_torch.read.scan_plan",
    "build_scan_iterator": "s3shuffle_tpu_torch.read.scan_plan",
    "plan_scan": "s3shuffle_tpu_torch.read.scan_plan",
}

__all__ = [
    "BlockStream",
    "BlockIterator",
    "BufferedPrefetchIterator",
    "ThreadPredictor",
    "ChecksumError",
    "ChecksumValidationStream",
    "ShuffleReader",
    "ShuffleReadMetrics",
    "CoalescedScanIterator",
    "ScanSegment",
    "SlicedBlockStream",
    "build_scan_iterator",
    "plan_scan",
]


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(module), name)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
