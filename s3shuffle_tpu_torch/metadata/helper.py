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
- blob reads validate ``length % 8 == 0``;
- both sidecars are read through process-wide caches gated by
  ``cache_partition_lengths`` / ``cache_checksums`` (S3ShuffleHelper.scala:
  67-92), with per-key locks so each object is fetched once; a
  :class:`ScanIndexMemo` scopes the same deduplication to one reduce scan
  whatever the knobs say.

The port writes and reads the per-map sidecars only: composite groups (fat
indexes) are not read yet, and a map committed only into one raises a
``FileNotFoundError`` that says so.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from s3shuffle_tpu_torch.block_ids import (
    BlockId,
    ShuffleChecksumBlockId,
    ShuffleDataBlockId,
    ShuffleIndexBlockId,
)
from s3shuffle_tpu_torch.coding.parity import (
    GEOMETRY_MAGIC,
    TRAILER_WORDS,
    ParityGeometry,
    geometry_trailer_words,
)
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
from s3shuffle_tpu_torch.utils.concurrent_map import ConcurrentObjectMap

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


@dataclasses.dataclass(frozen=True)
class MapLocation:
    """Where one map output's bytes live: the data object and the absolute
    cumulative partition offsets inside it, so consumers slice
    ``[offsets[start], offsets[end])``. ``parity`` is the data object's
    stripe geometry when the coded plane wrote parity sidecars (None:
    uncoded); ``combined`` is the skew trailer's flag for map-side-combined
    partial rows. The JAX package's composite members (checksums from the
    fat index) and split stripes (``split_bytes``) are not read yet."""

    data_block: BlockId
    offsets: np.ndarray
    parity: Optional[ParityGeometry] = None
    combined: bool = False


class ShuffleHelper:
    def __init__(self, dispatcher: Dispatcher):
        self.dispatcher = dispatcher
        # keyed by the full object path (the app id included); cleared on
        # reinitialize
        self._length_cache: ConcurrentObjectMap[str, np.ndarray] = ConcurrentObjectMap()
        self._checksum_cache: ConcurrentObjectMap[str, np.ndarray] = ConcurrentObjectMap()
        dispatcher.on_reinitialize(self.clear_caches)

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

    # --- read side (read-through caches, S3ShuffleHelper.scala:67-92) ---
    def resolve_map_location(self, shuffle_id: int, map_id: int) -> MapLocation:
        """One map output's data object and absolute offsets, from its
        index object. FileNotFoundError when the map has no index: it is
        uncommitted, or the JAX package committed it into a composite
        group, which this package does not read yet."""
        offsets, geometry, skew = self.read_index(shuffle_id, map_id)
        return MapLocation(
            data_block=ShuffleDataBlockId(shuffle_id, map_id),
            offsets=offsets,
            parity=geometry,
            combined=skew is not None and skew.combined,
        )

    def read_index(
        self, shuffle_id: int, map_id: int,
    ) -> Tuple[np.ndarray, Optional[ParityGeometry], Optional[SkewTrailer]]:
        """``(cumulative offsets, stripe geometry | None, skew trailer |
        None)`` of one map output. The cache keeps the raw words (trailers
        included), so cached and fresh reads parse alike."""
        block = ShuffleIndexBlockId(shuffle_id, map_id)
        try:
            if self.dispatcher.config.cache_partition_lengths:
                words = self._length_cache.get_or_else_put(
                    self.dispatcher.get_path(block),
                    lambda _k: self.read_block_as_array(block),
                )
            else:
                words = self.read_block_as_array(block)
        except FileNotFoundError as e:
            raise FileNotFoundError(
                f"map output {shuffle_id}/{map_id} has no index object "
                f"{block.name}: it is uncommitted, or it was committed into a "
                "composite group (.cindex), which this package does not read yet"
            ) from e
        return split_index_trailers(words)

    def get_index(self, shuffle_id: int, map_id: int) -> Tuple[np.ndarray, Optional[ParityGeometry]]:
        """``(cumulative offsets, stripe geometry | None)`` of one map output."""
        offsets, geometry, _skew = self.read_index(shuffle_id, map_id)
        return offsets, geometry

    def get_partition_lengths(self, shuffle_id: int, map_id: int) -> np.ndarray:
        """Cumulative offsets of one map output, trailers removed;
        FileNotFoundError when the output is uncommitted."""
        return self.resolve_map_location(shuffle_id, map_id).offsets

    def get_checksums(self, shuffle_id: int, map_id: int) -> np.ndarray:
        block = ShuffleChecksumBlockId(
            shuffle_id, map_id, algorithm=self.dispatcher.config.checksum_algorithm
        )
        if self.dispatcher.config.cache_checksums:
            return self._checksum_cache.get_or_else_put(
                self.dispatcher.get_path(block), lambda _k: self.read_block_as_array(block)
            )
        return self.read_block_as_array(block)

    def read_block_as_array(self, block: BlockId) -> np.ndarray:
        data = self.dispatcher.backend.read_all(self.dispatcher.get_path(block))
        if len(data) % 8 != 0:
            raise ValueError(
                f"Metadata block {block.name} has invalid length {len(data)} (not /8)"
            )
        return np.frombuffer(data, dtype=">i8").astype(np.int64)

    def purge_cached_data_for_shuffle(self, shuffle_id: int) -> None:
        needle = f"shuffle_{shuffle_id}_"
        for cache in (self._length_cache, self._checksum_cache):
            cache.remove(lambda k: k.rsplit("/", 1)[-1].startswith(needle))

    def clear_caches(self) -> None:
        self._length_cache.clear()
        self._checksum_cache.clear()


class ScanIndexMemo:
    """Per-scan read-through memo over a :class:`ShuffleHelper`.

    One reduce scan touches a map's index (and checksum) object once per
    member block: range resolution in the planner or the block iterator,
    then the reader's checksum wiring. Each metadata object is fetched at
    most once per memo whatever the cache knobs say (they keep long-lived
    processes from pinning stale metadata across scans, not re-fetches
    within one), and a new scan builds a new memo. Failures are memoized
    too: the same exception re-raises. Duck-types the helper's read side.
    """

    def __init__(self, helper: ShuffleHelper):
        self.helper = helper
        self.dispatcher = helper.dispatcher
        self._locations: ConcurrentObjectMap[tuple, object] = ConcurrentObjectMap()
        self._checksums: ConcurrentObjectMap[tuple, object] = ConcurrentObjectMap()

    @staticmethod
    def _capture(compute):
        try:
            return compute()
        except (OSError, ValueError) as e:  # FileNotFoundError, corrupt blob
            return _MemoizedFailure(e)

    @staticmethod
    def _unwrap(entry):
        if isinstance(entry, _MemoizedFailure):
            raise entry.exc
        return entry

    def resolve_map_location(self, shuffle_id: int, map_id: int) -> MapLocation:
        return self._unwrap(
            self._locations.get_or_else_put(
                (shuffle_id, map_id),
                lambda _k: self._capture(
                    lambda: self.helper.resolve_map_location(shuffle_id, map_id)
                ),
            )
        )

    def get_partition_lengths(self, shuffle_id: int, map_id: int) -> np.ndarray:
        return self.resolve_map_location(shuffle_id, map_id).offsets

    def get_checksums(self, shuffle_id: int, map_id: int) -> np.ndarray:
        return self._unwrap(
            self._checksums.get_or_else_put(
                (shuffle_id, map_id),
                lambda _k: self._capture(
                    lambda: self.helper.get_checksums(shuffle_id, map_id)
                ),
            )
        )


class _MemoizedFailure:
    """Marker wrapper so a ConcurrentObjectMap can memoize an exception."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc
