"""Ranged input stream over a sub-range of a map task's data object.

Counterpart of the JAX package's ``read/block_stream.py`` (parity with the
reference's ``S3ShuffleBlockStream``):

- serves ``[start_offset, end_offset)`` of the data object with positioned
  ``read_fully`` calls (no shared cursor);
- opens the object lazily on the first read; a zero-length range never
  opens it;
- closes the underlying reader once the range is exhausted;
- a ``FileNotFoundError`` (the object is lost) with a ``recovery``
  (:class:`~s3shuffle_tpu_torch.coding.degraded.DegradedReader`) rebuilds
  the whole range from parity once and serves the cursor from it;
- other I/O errors, and a loss that cannot be rebuilt, are logged and
  surface as EOF — the checksum layer then reports the short partition as
  a ``ChecksumError``.
"""

from __future__ import annotations

import io
import logging
from typing import Optional

from s3shuffle_tpu_torch.block_ids import BlockId, ShuffleDataBlockId
from s3shuffle_tpu_torch.storage.backend import RangedReader
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher

logger = logging.getLogger("s3shuffle_tpu_torch.read")


class BlockStream(io.RawIOBase):
    def __init__(self, dispatcher: Dispatcher, block: BlockId, data_block: ShuffleDataBlockId,
                 start_offset: int, end_offset: int, recovery=None):
        if end_offset < start_offset:
            raise ValueError(f"Invalid range [{start_offset}, {end_offset})")
        self.dispatcher = dispatcher
        self.block = block
        self.data_block = data_block
        self.start_offset = start_offset
        self.end_offset = end_offset
        self._recovery = recovery
        self._recovered: Optional[bytes] = None  # [start_offset, end_offset) rebuilt
        self._pos = start_offset
        self._reader: Optional[RangedReader] = None
        self._done = False

    def readable(self) -> bool:
        return True

    def read(self, size: int = -1) -> bytes:
        remaining = self.end_offset - self._pos
        if remaining <= 0 or self._done:
            self._close_reader()
            return b""
        n = remaining if size is None or size < 0 else min(size, remaining)
        if self._recovered is not None:
            return self._serve_recovered(n)
        try:
            if self._reader is None:
                self._reader = self.dispatcher.open_block(self.data_block)
            data = self._reader.read_fully(self._pos, n)
        except OSError as e:
            if isinstance(e, FileNotFoundError) and self._reconstruct():
                return self._serve_recovered(n)
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

    def _reconstruct(self) -> bool:
        """The coded plane's loss path: rebuild the whole range from parity
        once. False when there is no recovery, the object carries no parity
        or the survivors are insufficient."""
        if self._recovery is None:
            return False
        data = self._recovery.reconstruct(
            self.data_block, self.start_offset, self.end_offset, reason="loss"
        )
        if data is None:
            return False
        self._recovered = data
        if self._reader is not None:  # the object vanished under an open reader
            self._reader.close()
            self._reader = None
        return True

    def _serve_recovered(self, n: int) -> bytes:
        lo = self._pos - self.start_offset
        data = self._recovered[lo : lo + n]
        self._pos += len(data)
        if self._pos >= self.end_offset or not data:
            self._close_reader()
        return data

    def _close_reader(self) -> None:
        self._done = True
        if self._reader is not None:
            self._reader.close()
            self._reader = None

    def close(self) -> None:
        if not self.closed:
            self._close_reader()
        super().close()
