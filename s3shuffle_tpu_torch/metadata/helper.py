"""Index and checksum sidecar objects (the JAX package's
``metadata/helper.py``, parity with the reference's ``S3ShuffleHelper``):

- the index object stores the *cumulative* partition offsets
  ``[0, a, a+b, ...]`` (one more entry than partitions) as big-endian int64
  (Java ``DataOutputStream`` format);
- the checksum object stores one uint32-in-int64 per reduce partition, also
  big-endian int64, named ``...checksum.<ALGORITHM>``;
- writing the index is the commit point of a map output (data first, then
  checksums, then the index): no index ⇒ invisible output;
- blob reads validate ``length % 8 == 0``.

This slice writes and reads the per-map sidecars only (no fat index, no
composite groups, no read caches).
"""

from __future__ import annotations

import numpy as np

from s3shuffle_tpu_torch.block_ids import (
    BlockId,
    ShuffleChecksumBlockId,
    ShuffleIndexBlockId,
)
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher


class ShuffleHelper:
    def __init__(self, dispatcher: Dispatcher):
        self.dispatcher = dispatcher

    # --- write side ---
    def write_partition_lengths(self, shuffle_id: int, map_id: int, lengths) -> None:
        """Per-partition byte counts → cumulative offsets ``[0, l0, l0+l1, ...]``."""
        offsets = np.zeros(len(lengths) + 1, dtype=np.int64)
        np.cumsum(np.asarray(lengths, dtype=np.int64), out=offsets[1:])
        self.write_array_as_block(ShuffleIndexBlockId(shuffle_id, map_id), offsets)

    def write_checksums(self, shuffle_id: int, map_id: int, checksums) -> None:
        block = ShuffleChecksumBlockId(
            shuffle_id, map_id, algorithm=self.dispatcher.config.checksum_algorithm
        )
        self.write_array_as_block(block, np.asarray(checksums, dtype=np.int64))

    def write_array_as_block(self, block: BlockId, array) -> None:
        """Store an int64 array as big-endian bytes."""
        data = np.ascontiguousarray(array, dtype=">i8").tobytes()
        stream = self.dispatcher.create_block(block)
        try:
            stream.write(data)
        finally:
            stream.close()

    # --- read side ---
    def get_partition_lengths(self, shuffle_id: int, map_id: int) -> np.ndarray:
        """Cumulative offsets of one map output; FileNotFoundError when the
        output is uncommitted."""
        return self.read_block_as_array(ShuffleIndexBlockId(shuffle_id, map_id))

    def get_checksums(self, shuffle_id: int, map_id: int) -> np.ndarray:
        return self.read_block_as_array(
            ShuffleChecksumBlockId(
                shuffle_id, map_id, algorithm=self.dispatcher.config.checksum_algorithm
            )
        )

    def read_block_as_array(self, block: BlockId) -> np.ndarray:
        data = self.dispatcher.backend.read_all(self.dispatcher.get_path(block))
        if len(data) % 8 != 0:
            raise ValueError(
                f"Metadata block {block.name} has invalid length {len(data)} (not /8)"
            )
        return np.frombuffer(data, dtype=">i8").astype(np.int64)
