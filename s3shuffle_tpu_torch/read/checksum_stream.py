"""Streaming checksum validation (the JAX package's ``read/checksum_stream.py``,
parity with the reference's ``S3ChecksumValidationStream``).

Wraps the stored-byte stream of a block read and walks its reduce ids; at
every partition boundary the computed checksum is compared with the map's
stored value and a mismatch raises :class:`ChecksumError` naming the block.
A single ``read`` never crosses a partition boundary; zero-length
partitions validate immediately.

**Deferred (certificate-driven) validation** (:meth:`defer_validation`):
the codec layer certifies served chunks in order instead of the stream
hashing them — ``certify(length, stored_crc=...)`` folds a frame's stored
CRC (computed fused in the device decode launch) into the running value
with ``crc_combine``; ``certify(length)`` hashes the retained bytes. The
value equals streaming validation's byte for byte, and a certificate that
straddles a partition boundary degrades to hashing the retained bytes.
"""

from __future__ import annotations

import io
from collections import deque
from typing import BinaryIO, Optional

import numpy as np

from s3shuffle_tpu_torch.block_ids import BlockId
from s3shuffle_tpu_torch.utils.checksums import create_checksum


class ChecksumError(IOError):
    """Parity: SparkException("Invalid checksum detected...")."""


class ChecksumValidationStream(io.RawIOBase):
    def __init__(self, block: BlockId, source: BinaryIO, offsets: np.ndarray,
                 checksums: np.ndarray, start_reduce_id: int, end_reduce_id: int,
                 algorithm: str):
        self._block = block
        self._source = source
        self._offsets = offsets
        self._checksums = checksums
        self._reduce_id = start_reduce_id
        self._end_reduce_id = end_reduce_id
        self._algorithm = algorithm
        self._checksum = create_checksum(algorithm)
        self._pos_in_partition = 0
        self._deferred = False
        self._retained: deque = deque()  # served-but-uncertified chunks
        self._retained_bytes = 0
        self._cert_reduce_id = start_reduce_id
        self._cert_pos = 0
        self._cert_crc = 0
        self._cert_failed = False
        self._skip_empty_and_validate()

    def readable(self) -> bool:
        return True

    # --- deferred (certificate-driven) validation ---
    @property
    def fused_poly(self) -> Optional[int]:
        """The reflected CRC polynomial of this stream's algorithm, or None
        when it has no combinable CRC form (ADLER32)."""
        from s3shuffle_tpu_torch.ops.checksum import POLY_CRC32, POLY_CRC32C

        return {"CRC32": POLY_CRC32, "CRC32C": POLY_CRC32C}.get(self._algorithm)

    def defer_validation(self) -> bool:
        """Switch to certificate-driven validation; legal only before any
        byte was served. Returns False (streaming validation stays) when the
        algorithm has no combinable CRC form."""
        if self.fused_poly is None:
            return False
        if self._pos_in_partition or self._retained:
            return False
        self._deferred = True
        self._cert_reduce_id = self._reduce_id
        self._cert_pos = 0
        self._cert_crc = 0
        return True

    def certify(self, length: int, stored_crc: Optional[int] = None) -> None:
        """Certify the next ``length`` served bytes, in order (see the
        module docstring)."""
        if not self._deferred:
            raise RuntimeError("certify() on a non-deferred checksum stream")
        if self._cert_failed:
            return  # the stream is dead: its ChecksumError is propagating
        from s3shuffle_tpu_torch.ops.checksum import crc_combine, host_crc

        poly = self.fused_poly
        while length > 0 and self._cert_reduce_id < self._end_reduce_id:
            plen_rem = self._cert_partition_len() - self._cert_pos
            if stored_crc is not None and length <= plen_rem:
                self._cert_crc = crc_combine(self._cert_crc, stored_crc, length, poly)
                self._drop_retained(length)
                self._cert_pos += length
                length = 0
            else:
                stored_crc = None
                take = min(length, max(1, plen_rem))
                data = self._take_retained(take)
                if not data:
                    break  # certificate exceeds served bytes: corrupt stream
                self._cert_crc = crc_combine(
                    self._cert_crc, host_crc(data, poly), len(data), poly
                )
                self._cert_pos += len(data)
                length -= len(data)
            if self._cert_pos >= self._cert_partition_len():
                self._validate_cert()
                self._cert_reduce_id += 1
                self._cert_pos = 0
                self._cert_crc = 0
                self._skip_empty_cert()

    def resolve_pending(self) -> None:
        """Hash every served-but-uncertified byte now (before a decode error
        propagates, so corruption raises the same ChecksumError it does
        under streaming validation)."""
        if self._deferred and self._retained_bytes:
            self.certify(self._retained_bytes)

    def _cert_partition_len(self) -> int:
        return int(self._offsets[self._cert_reduce_id + 1] - self._offsets[self._cert_reduce_id])

    def _skip_empty_cert(self) -> None:
        while (
            self._cert_reduce_id < self._end_reduce_id
            and self._cert_partition_len() == 0
        ):
            self._validate_cert()
            self._cert_reduce_id += 1
            self._cert_pos = 0
            self._cert_crc = 0

    def _validate_cert(self) -> None:
        try:
            self._raise_on_mismatch(self._cert_reduce_id, self._cert_crc & 0xFFFFFFFF)
        except ChecksumError:
            self._cert_failed = True
            raise

    def _take_retained(self, n: int) -> bytes:
        parts = []
        need = n
        while need > 0 and self._retained:
            chunk = self._retained.popleft()
            if len(chunk) > need:
                self._retained.appendleft(chunk[need:])
                chunk = chunk[:need]
            parts.append(chunk)
            need -= len(chunk)
        self._retained_bytes -= n - need
        return parts[0] if len(parts) == 1 else b"".join(parts)

    def _drop_retained(self, n: int) -> None:
        need = n
        while need > 0 and self._retained:
            chunk = self._retained.popleft()
            if len(chunk) > need:
                self._retained.appendleft(chunk[need:])
                need = 0
            else:
                need -= len(chunk)
        self._retained_bytes -= n - need

    # --- streaming validation ---
    def _partition_len(self) -> int:
        return int(self._offsets[self._reduce_id + 1] - self._offsets[self._reduce_id])

    def _skip_empty_and_validate(self) -> None:
        while self._reduce_id < self._end_reduce_id and self._partition_len() == 0:
            if not self._deferred:
                self._validate_current()
            self._reduce_id += 1
            self._pos_in_partition = 0

    def _raise_on_mismatch(self, reduce_id: int, actual: int) -> None:
        expected = int(self._checksums[reduce_id]) & 0xFFFFFFFF
        if actual != expected:
            raise ChecksumError(
                f"Invalid checksum detected for {self._block.name} reduce partition "
                f"{reduce_id} ({self._algorithm}): "
                f"expected {expected:#010x}, computed {actual:#010x}"
            )

    def _validate_current(self) -> None:
        self._raise_on_mismatch(self._reduce_id, self._checksum.value)
        self._checksum.reset()

    def read(self, size: int = -1) -> bytes:
        if self._reduce_id >= self._end_reduce_id:
            return b""
        remaining = self._partition_len() - self._pos_in_partition
        if size is None or size < 0:
            size = remaining
        n = min(size, remaining)  # never past the partition boundary
        data = self._source.read(n) if n > 0 else b""
        if data:
            if self._deferred:
                self._retained.append(data)
                self._retained_bytes += len(data)
            else:
                self._checksum.update(data)
            self._pos_in_partition += len(data)
        if self._pos_in_partition >= self._partition_len():
            if not self._deferred:
                self._validate_current()
            self._reduce_id += 1
            self._pos_in_partition = 0
            self._skip_empty_and_validate()
        elif not data:
            raise ChecksumError(
                f"Premature EOF in {self._block.name} reduce partition "
                f"{self._reduce_id}: got {self._pos_in_partition} of {self._partition_len()} bytes"
            )
        return data

    def close(self) -> None:
        if not self.closed:
            self._source.close()
        super().close()
