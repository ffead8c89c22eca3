"""Write-side transfer plane: pipelined commit uploads (the JAX package's
``write/pipelined_upload.py``).

``ShuffleMapWriter._commit`` is a strict drain → serialize → upload → index
sequence: every byte of the map output flows through the shared data-object
stream on the committing thread, so spill-file reads and codec work stall
behind each store PUT and vice versa. This module overlaps them: the commit
thread *enqueues* bounded chunks and a background uploader thread writes them
to the store, so commit wall-time approaches ``max(serialize, upload)``
instead of their sum (the reference delegates the equivalent knob to
Hadoop S3A fast-upload buffering, reference README.md:146-178).

Everything the commit protocol relies on is preserved:

- the single-data-object layout — one sink, chunks written in FIFO order, so
  monotone partition order and byte offsets are untouched;
- the byte-count sanity check — ``bytes_written`` counts accepted bytes, and
  ``close()`` blocks until the uploader has written ALL of them (or re-raises
  its failure), so ``commit_all_partitions`` still compares a fully-flushed
  stream position;
- index-written-last — the index write happens after ``close()`` returns,
  i.e. strictly after the final data byte reached the store.

Memory is bounded by ``upload_queue_bytes``: the producer blocks when the
queue is full (backpressure), so a slow store cannot balloon the commit's
footprint. With the metrics registry on, each blocked wait is observed in
``write_upload_queue_wait_seconds`` (the commit tuner's backpressure
signal), ``write_upload_queue_bytes`` holds the queued bytes of every
stream in the process, and each chunk's store write is timed in
``write_upload_chunk_seconds``.
"""

from __future__ import annotations

import io
import logging
import threading
import time
from collections import deque
from typing import BinaryIO

from s3shuffle_tpu_torch.metrics import registry as _metrics
from s3shuffle_tpu_torch.utils import trace

logger = logging.getLogger("s3shuffle_tpu_torch.write")

MiB = 1024 * 1024

_H_QUEUE_WAIT = _metrics.REGISTRY.histogram(
    "write_upload_queue_wait_seconds",
    "Producer backpressure: time commit serialization spent blocked on a "
    "full upload queue",
)
_G_QUEUE_DEPTH = _metrics.REGISTRY.gauge(
    "write_upload_queue_bytes",
    "Bytes currently queued between commit serialization and the uploaders "
    "(summed across concurrent map tasks)",
)
_H_CHUNK_UPLOAD = _metrics.REGISTRY.histogram(
    "write_upload_chunk_seconds",
    "Background uploader per-chunk store write latency",
)


class PipelinedUploadStream(io.RawIOBase):
    """Bounded-queue write stream: ``write()`` enqueues, a background thread
    uploads. Failures on the uploader thread surface on the next ``write``/
    ``close`` call of the producer (never silently)."""

    def __init__(
        self,
        sink: BinaryIO,
        queue_bytes: int,
        chunk_bytes: int | None = None,
        label: str = "",
    ):
        self._sink = sink
        self._label = label
        self._queue_limit = max(1, int(queue_bytes))
        # Chunks big enough to amortize per-write store overhead, small
        # enough that the queue holds several (pipelining needs >= 2 slots).
        self._chunk_bytes = int(chunk_bytes or max(64 * 1024, min(self._queue_limit // 4, 8 * MiB)))
        self._buf = bytearray()
        # bytes or (zero-copy, immutable-source) memoryview chunks
        self._queue: deque = deque()
        self._queued_bytes = 0
        self._cond = threading.Condition()
        self._eof = False
        self._error: BaseException | None = None
        self.bytes_written = 0  # bytes ACCEPTED (enqueued or buffered)
        self._thread = threading.Thread(
            target=self._drain, daemon=True, name=f"s3shuffle-upload-{label or id(self)}"
        )
        self._thread.start()

    # ------------------------------------------------------------------
    # Producer side (the committing thread)
    # ------------------------------------------------------------------
    def writable(self) -> bool:
        return True

    def write(self, b) -> int:
        n = b.nbytes if isinstance(b, memoryview) else len(b)
        if n == 0:
            return 0
        if self._error is not None:  # surface uploader failure promptly
            raise self._error
        # Chunks are COPIED off mutable caller buffers (they may be reused or
        # released after write() returns — spill-copy chunks, BytesIO
        # getbuffer views) and sliced directly from them, so one huge write
        # (a whole finalized partition) stages at most chunk_bytes at a time
        # and feels the queue backpressure per chunk — never a monolithic
        # copy or PUT. IMMUTABLE bytes inputs (the async codec pipeline hands
        # whole encoded batches as bytes) enqueue as zero-copy memoryview
        # slices instead: the source can't change under the uploader, so the
        # copy of every uploaded byte disappears.
        mv = memoryview(b)
        if mv.itemsize != 1:
            mv = mv.cast("B")
        immutable = isinstance(b, bytes)
        self.bytes_written += n
        off = 0
        if self._buf:  # top up the pending partial chunk first
            take = min(n, self._chunk_bytes - len(self._buf))
            self._buf += mv[:take]
            off = take
            if len(self._buf) >= self._chunk_bytes:
                self._enqueue(bytes(self._buf))
                self._buf.clear()
        while n - off >= self._chunk_bytes:
            chunk = mv[off : off + self._chunk_bytes]
            self._enqueue(chunk if immutable else bytes(chunk))
            off += self._chunk_bytes
        if off < n:
            self._buf += mv[off:]
        return n

    def _enqueue(self, chunk: bytes) -> None:
        t0 = time.perf_counter_ns()
        waited = False
        with self._cond:
            while (
                self._error is None
                and self._queued_bytes > 0
                and self._queued_bytes + len(chunk) > self._queue_limit
            ):
                waited = True
                self._cond.wait(timeout=5.0)
            if self._error is not None:
                raise self._error
            self._queue.append(chunk)
            self._queued_bytes += len(chunk)
            if _metrics.enabled():
                # a delta, not set(): concurrent map tasks share the gauge
                _G_QUEUE_DEPTH.inc(len(chunk))
            self._cond.notify_all()
        if waited and _metrics.enabled():
            _H_QUEUE_WAIT.observe((time.perf_counter_ns() - t0) / 1e9)

    def flush(self) -> None:
        # RawIOBase.close() re-enters flush(); nothing to force here — the
        # durability point is close(), same as the serial buffered path.
        pass

    def close(self) -> None:
        if self.closed:
            return
        try:
            error: BaseException | None = None
            try:
                if self._buf:
                    self._enqueue(bytes(self._buf))
                    self._buf.clear()
            except BaseException as e:  # uploader already failed
                error = e
            with self._cond:
                self._eof = True
                self._cond.notify_all()
            self._thread.join()
            if error is None and self._error is not None:
                error = self._error
            try:
                self._sink.close()
            except Exception:
                if error is None:
                    raise
                # the uploader's failure is the root cause — prefer it
            if error is not None:
                raise error
        finally:
            super().close()

    # ------------------------------------------------------------------
    # Uploader side (background thread)
    # ------------------------------------------------------------------
    def _drain(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._eof and self._error is None:
                    self._cond.wait(timeout=5.0)
                if self._error is not None or (self._eof and not self._queue):
                    return
                chunk = self._queue.popleft()
            try:
                t0 = time.perf_counter_ns()
                with trace.span("write.upload_chunk", label=self._label, bytes=len(chunk)):
                    self._sink.write(chunk)
                if _metrics.enabled():
                    _H_CHUNK_UPLOAD.observe((time.perf_counter_ns() - t0) / 1e9)
            except BaseException as e:
                with self._cond:
                    self._error = e
                    self._queue.clear()
                    if _metrics.enabled():
                        _G_QUEUE_DEPTH.dec(self._queued_bytes)
                    self._queued_bytes = 0
                    self._cond.notify_all()
                logger.error("Pipelined upload of %s failed: %s", self._label, e)
                return
            with self._cond:
                self._queued_bytes -= len(chunk)
                if _metrics.enabled():
                    _G_QUEUE_DEPTH.dec(len(chunk))
                self._cond.notify_all()
