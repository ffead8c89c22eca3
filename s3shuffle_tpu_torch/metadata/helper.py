"""Index and checksum sidecar objects (the JAX package's
``metadata/helper.py``, parity with the reference's ``S3ShuffleHelper``):

- the index object stores the *cumulative* partition offsets
  ``[0, a, a+b, ...]`` (one more entry than partitions) as big-endian int64
  (Java ``DataOutputStream`` format); the coded plane appends a 4-word
  stripe-geometry trailer, and the JAX package's skew plane a 4-word skew
  trailer before it (:func:`split_index_trailers` peels both);
- the checksum object stores one uint32-in-int64 per reduce partition, also
  big-endian int64, named ``...checksum.<ALGORITHM>``;
- writing the index is the commit point of a map output (data first, then
  parity, then checksums, then the index): no index ⇒ invisible output;
- blob reads validate ``length % 8 == 0``.

The port writes and reads the per-map sidecars only (no fat index, no
composite groups, no read caches).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from s3shuffle_tpu_torch.block_ids import (
    BlockId,
    ShuffleChecksumBlockId,
    ShuffleIndexBlockId,
)
from s3shuffle_tpu_torch.coding.parity import (
    GEOMETRY_MAGIC,
    TRAILER_WORDS,
    ParityGeometry,
    geometry_trailer_words,
)
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher

#: magic word of the JAX package's skew trailer (``s3shuffle_tpu/skew.py``):
#: ``[SKEW_MAGIC, flags, split_bytes, reserved]`` after the offsets and
#: before the geometry trailer
SKEW_MAGIC = 0x53335348534B4557  # "S3SHSKEW"
SKEW_TRAILER_WORDS = 4
#: skew flags bit 0: the partitions carry map-side-combined partial rows
FLAG_COMBINED = 1


@dataclasses.dataclass(frozen=True)
class SkewTrailer:
    """The skew plane's commit-time coordinates of one map output, as its
    index records them. The port reads them so the offsets are right, and
    its reader refuses a raw read of combined partials; it writes none."""

    combined: bool = False
    split_bytes: int = 0


def split_index_trailers(
    words: np.ndarray,
) -> Tuple[np.ndarray, Optional[ParityGeometry], Optional[SkewTrailer]]:
    """Split a raw index-blob int64 array into ``(offsets, geometry|None,
    skew|None)``. On the wire the order is ``offsets + [skew trailer] +
    [geometry trailer]``: the geometry trailer (when present) is the final
    four words, so it is peeled first, then the skew trailer, and the
    geometry's ``payload_len`` is the true final cumulative offset. Both
    magics lie at values no cumulative byte offset reaches (~6.0e18), so a
    blob without trailers passes through untouched."""
    geom_words = None
    if len(words) >= TRAILER_WORDS + 2 and int(words[-TRAILER_WORDS]) == GEOMETRY_MAGIC:
        geom_words = words[-TRAILER_WORDS:]
        words = words[:-TRAILER_WORDS]
    skew = None
    if len(words) >= SKEW_TRAILER_WORDS + 2 and int(words[-SKEW_TRAILER_WORDS]) == SKEW_MAGIC:
        skew = SkewTrailer(combined=bool(int(words[-3]) & FLAG_COMBINED),
                           split_bytes=int(words[-2]))
        words = words[:-SKEW_TRAILER_WORDS]
    geometry = None
    if geom_words is not None:
        geometry = ParityGeometry(
            segments=int(geom_words[1]),
            stripe_k=int(geom_words[2]),
            chunk_bytes=int(geom_words[3]),
            payload_len=int(words[-1]),
        )
    return words, geometry, skew


class ShuffleHelper:
    def __init__(self, dispatcher: Dispatcher):
        self.dispatcher = dispatcher

    # --- write side ---
    def write_partition_lengths(self, shuffle_id: int, map_id: int, lengths,
                                parity: Optional[ParityGeometry] = None) -> None:
        """Per-partition byte counts → cumulative offsets ``[0, l0, l0+l1, ...]``;
        ``parity`` appends the stripe-geometry trailer (None keeps the
        reference's wire format)."""
        offsets = np.zeros(len(lengths) + 1, dtype=np.int64)
        np.cumsum(np.asarray(lengths, dtype=np.int64), out=offsets[1:])
        if parity is not None:
            offsets = np.concatenate([offsets, geometry_trailer_words(parity)])
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
    def read_index(
        self, shuffle_id: int, map_id: int,
    ) -> Tuple[np.ndarray, Optional[ParityGeometry], Optional[SkewTrailer]]:
        """``(cumulative offsets, stripe geometry | None, skew trailer |
        None)`` of one map output, from one read of its index;
        FileNotFoundError when the output is uncommitted."""
        words = self.read_block_as_array(ShuffleIndexBlockId(shuffle_id, map_id))
        return split_index_trailers(words)

    def get_index(self, shuffle_id: int, map_id: int) -> Tuple[np.ndarray, Optional[ParityGeometry]]:
        """``(cumulative offsets, stripe geometry | None)`` of one map output."""
        offsets, geometry, _skew = self.read_index(shuffle_id, map_id)
        return offsets, geometry

    def get_partition_lengths(self, shuffle_id: int, map_id: int) -> np.ndarray:
        """Cumulative offsets of one map output, trailers removed;
        FileNotFoundError when the output is uncommitted."""
        return self.get_index(shuffle_id, map_id)[0]

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
