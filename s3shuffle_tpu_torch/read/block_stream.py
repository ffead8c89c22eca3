"""Ranged input stream over a sub-range of a map task's data object.

Counterpart of the JAX package's ``read/block_stream.py`` (parity with the
reference's ``S3ShuffleBlockStream``):

- serves ``[start_offset, end_offset)`` of the data object with positioned
  ``read_fully`` calls (no shared cursor), through the cursor (:meth:`read`,
  :meth:`skip`) or cursor-free (:meth:`pread`, which the chunked fetcher
  issues concurrently);
- opens the object lazily on the first read; a zero-length range never
  opens it;
- closes the underlying reader once the range is exhausted;
- a ``FileNotFoundError`` (the object is lost) with a ``recovery``
  (:class:`~s3shuffle_tpu_torch.coding.degraded.DegradedReader`) rebuilds
  the whole range from parity once and serves every later read from it;
- a retriable read failure (connection reset, timeout, 5xx-shaped; see
  ``storage/retrying.is_retriable``) gets one more chance with a fresh
  ``open_block`` reader when ``storage_retries > 0``: the retry layer below
  has already re-driven the read with backoff, so a failure that reaches
  this layer usually means the long-lived handle is poisoned;
- other I/O errors, a failed reopen, ``storage_retries = 0`` and a loss
  that cannot be rebuilt are logged and surface as EOF — the checksum
  layer then reports the short partition as a ``ChecksumError``.
"""

from __future__ import annotations

import io
import logging
import threading
from typing import Optional

from s3shuffle_tpu_torch.block_ids import BlockId, ShuffleDataBlockId
from s3shuffle_tpu_torch.storage.backend import RangedReader
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
from s3shuffle_tpu_torch.storage.retrying import is_retriable

logger = logging.getLogger("s3shuffle_tpu_torch.read")


class BlockStream(io.RawIOBase):
    def __init__(self, dispatcher: Dispatcher, block: BlockId, data_block: ShuffleDataBlockId,
                 start_offset: int, end_offset: int, recovery=None):
        # ``block``: anything with a ``.name`` (a block id, or the planner's
        # ScanSegment when the stream serves a coalesced range)
        if end_offset < start_offset:
            raise ValueError(f"Invalid range [{start_offset}, {end_offset})")
        self.dispatcher = dispatcher
        self.block = block
        self.data_block = data_block
        self.start_offset = start_offset
        self.end_offset = end_offset
        self.max_bytes = end_offset - start_offset
        self._recovery = recovery
        self._recovered: Optional[bytes] = None  # [start_offset, end_offset) rebuilt
        self._pos = start_offset
        self._reader: Optional[RangedReader] = None
        # readers swapped out by _recover_reader_locked: sibling preads may
        # still be in flight on them, so they close with the stream
        self._stale_readers: list = []
        self._reader_closed = False
        self._failed = False
        # orders the cursor path against concurrent pread siblings
        self._lock = threading.Lock()

    def readable(self) -> bool:
        return True

    @property
    def position(self) -> int:
        """Absolute cursor position inside the data object."""
        return self._pos

    def available(self) -> int:
        return self.end_offset - self._pos

    def _ensure_open(self) -> Optional[RangedReader]:
        if self._reader is None and not self._reader_closed:
            self._reader = self.dispatcher.open_block(self.data_block)
        return self._reader

    def _recover_reader_locked(self, error: OSError,
                               failed: Optional[RangedReader]) -> Optional[RangedReader]:
        """One fresh ``open_block`` after a retriable read failure (caller
        holds ``self._lock``; ``failed`` is the reader the failed read
        used). A reader a sibling pread already swapped in is returned as
        it is. None when recovery is off (``storage_retries = 0``), the
        error is terminal, the stream already failed or closed its reader,
        or the reopen fails; the caller then surfaces EOF."""
        if getattr(self.dispatcher.config, "storage_retries", 0) <= 0:
            return None
        if not is_retriable(error) or self._failed or self._reader_closed:
            return None
        if self._reader is not None and self._reader is not failed:
            return self._reader  # a sibling pread already recovered
        try:
            fresh = self.dispatcher.open_block(self.data_block)
        except OSError:
            return None
        logger.warning("Reopened %s after retriable read failure: %s", self.block.name, error)
        if self._reader is not None:
            self._stale_readers.append(self._reader)
        self._reader = fresh
        return fresh

    def _reconstruct_locked(self, position: int, length: int) -> Optional[bytes]:
        """The coded plane's loss path (caller holds ``self._lock``): rebuild
        the whole range from parity once and serve ``[position, position +
        length)`` from it. None when there is no recovery, the object
        carries no parity or the survivors are insufficient."""
        if self._recovery is None:
            return None
        if self._recovered is None:
            data = self._recovery.reconstruct(
                self.data_block, self.start_offset, self.end_offset, reason="loss"
            )
            if data is None:
                return None
            self._recovered = data
        lo = position - self.start_offset
        return self._recovered[lo : lo + length]

    def pread(self, position: int, length: int) -> bytes:
        """Positioned read inside the range with no cursor movement. An I/O
        error only marks the stream failed (sibling reads may still be in
        flight on the same handle); every later read sees EOF."""
        length = min(length, self.end_offset - position)
        if length <= 0:
            return b""
        with self._lock:
            if self._recovered is not None:
                lo = position - self.start_offset
                return self._recovered[lo : lo + length]
            if self._failed:
                return b""
            try:
                reader = self._ensure_open()
            except OSError as e:
                if isinstance(e, FileNotFoundError):
                    rebuilt = self._reconstruct_locked(position, length)
                    if rebuilt is not None:
                        return rebuilt
                logger.error(
                    "Error opening %s for range [%d,%d): %s",
                    self.block.name, position, position + length, e,
                )
                self._failed = True
                self._close_reader()
                return b""
            if reader is None:
                return b""
        try:
            return reader.read_fully(position, length)
        except OSError as e:
            with self._lock:
                fresh = self._recover_reader_locked(e, reader)
            if fresh is not None:
                try:
                    return fresh.read_fully(position, length)
                except OSError as e2:
                    e = e2
            if isinstance(e, FileNotFoundError):
                with self._lock:
                    rebuilt = self._reconstruct_locked(position, length)
                if rebuilt is not None:
                    return rebuilt
            logger.error(
                "Error reading %s range [%d,%d): %s",
                self.block.name, position, position + length, e,
            )
            with self._lock:
                self._failed = True
            return b""

    def read(self, size: int = -1) -> bytes:
        with self._lock:
            remaining = self.end_offset - self._pos
            if remaining <= 0 or self._failed:
                self._close_reader()
                return b""
            n = remaining if size is None or size < 0 else min(size, remaining)
            if self._recovered is not None:
                lo = self._pos - self.start_offset
                data = self._recovered[lo : lo + n]
            else:
                data = None
                reader = None
                try:
                    reader = self._ensure_open()
                    if reader is None:
                        return b""
                    data = reader.read_fully(self._pos, n)
                except OSError as e:
                    fresh = self._recover_reader_locked(e, reader)
                    if fresh is not None:
                        try:
                            data = fresh.read_fully(self._pos, n)
                        except OSError as e2:
                            e = e2
                    if data is None and isinstance(e, FileNotFoundError):
                        data = self._reconstruct_locked(self._pos, n)
                    if data is None:
                        logger.error(
                            "Error reading %s range [%d,%d): %s",
                            self.block.name, self._pos, self.end_offset, e,
                        )
                        self._close_reader()
                        return b""
            self._pos += len(data)
            if self._pos >= self.end_offset or not data:
                self._close_reader()
            return data

    def skip(self, n: int) -> int:
        with self._lock:
            n = max(0, min(n, self.end_offset - self._pos))
            self._pos += n
            if self._pos >= self.end_offset:
                self._close_reader()
            return n

    def _close_reader(self) -> None:
        for stale in self._stale_readers:
            try:
                stale.close()
            except OSError:
                pass
        self._stale_readers = []
        if self._reader is not None:
            try:
                self._reader.close()
            except OSError:
                pass
            self._reader = None
        self._reader_closed = True

    def close(self) -> None:
        if not self.closed:
            with self._lock:
                self._close_reader()
        super().close()
