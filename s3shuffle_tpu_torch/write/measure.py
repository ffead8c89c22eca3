"""Write-side observability stream (the JAX package's ``write/measure.py``).

Parity: ``S3MeasureOutputStream`` (S3MeasureOutputStream.scala:8-65) — an
OutputStream decorator that times every write/flush/close and, on close, logs
"Statistics: ... Writing <block> <bytes> took <t> ms (<bw> MiB/s)". This is
the only write-side observability the reference has; keep the behavior.
"""

from __future__ import annotations

import io
import logging
import time
from typing import BinaryIO

from s3shuffle_tpu_torch.metrics import registry as _metrics

logger = logging.getLogger("s3shuffle_tpu_torch.write")

_H_UPLOAD = _metrics.REGISTRY.histogram(
    "write_upload_seconds",
    "Cumulative sink write/flush/close time per measured output object",
)
_C_UPLOAD_BYTES = _metrics.REGISTRY.counter(
    "write_upload_bytes_total", "Bytes pushed through measured output streams"
)


class MeasuredOutputStream(io.RawIOBase):
    def __init__(self, sink: BinaryIO, label: str):
        self._sink = sink
        self._label = label
        self.bytes_written = 0
        self.time_ns = 0

    def writable(self) -> bool:
        return True

    def write(self, b) -> int:
        t0 = time.perf_counter_ns()
        n = self._sink.write(b)
        self.time_ns += time.perf_counter_ns() - t0
        written = n if n is not None else len(b)
        self.bytes_written += written
        return written

    def flush(self) -> None:
        # RawIOBase.close() re-enters flush() after the sink is closed.
        if getattr(self._sink, "closed", False):
            return
        t0 = time.perf_counter_ns()
        self._sink.flush()
        self.time_ns += time.perf_counter_ns() - t0

    def close(self) -> None:
        if self.closed:
            return
        t0 = time.perf_counter_ns()
        self._sink.close()
        self.time_ns += time.perf_counter_ns() - t0
        ms = self.time_ns / 1e6
        mib_s = (self.bytes_written / (1024 * 1024)) / (self.time_ns / 1e9) if self.time_ns else 0.0
        logger.info(
            "Statistics: Writing %s %d bytes took %.1f ms (%.1f MiB/s)",
            self._label,
            self.bytes_written,
            ms,
            mib_s,
        )
        if _metrics.enabled():
            _H_UPLOAD.observe(self.time_ns / 1e9)
            _C_UPLOAD_BYTES.inc(self.bytes_written)
        super().close()
