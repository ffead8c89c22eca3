"""Index and checksum sidecar objects (the JAX package's
``metadata/helper.py``, parity with the reference's ``S3ShuffleHelper``):

- the index object stores the *cumulative* partition offsets
  ``[0, a, a+b, ...]`` (one more entry than partitions) as big-endian int64
  (Java ``DataOutputStream`` format); the coded plane appends a 4-word
  stripe-geometry trailer, and the skew plane a 4-word skew trailer before
  it (``skew.split_index_trailers`` peels both);
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

The composite layout (write/composite_commit.py) keeps many map outputs in
one composite data object whose fat index (metadata/fat_index.py) holds
every member's offsets and checksums. The helper writes and reads fat
indexes (always cached: they are immutable and serve many maps) and keeps
composite hints, ``(shuffle, map) -> (group, base)``, fed by tracker
registrations or by one listing pass over the shuffle's ``*.cindex``
objects. A hint wins over any per-map index. The store is consulted for
composite membership only when composites can exist here (a composite or
compaction knob is on, a hint arrived for the shuffle, or a discovery
already ran), so the composite-off op sequence is the per-map one.
"""

from __future__ import annotations

import dataclasses
import logging
import struct
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from s3shuffle_tpu_torch.block_ids import (
    BlockId,
    ShuffleChecksumBlockId,
    ShuffleCompositeDataBlockId,
    ShuffleDataBlockId,
    ShuffleFatIndexBlockId,
    ShuffleIndexBlockId,
)
from s3shuffle_tpu_torch.coding.parity import ParityGeometry, geometry_trailer_words
from s3shuffle_tpu_torch.metadata.fat_index import FatIndex
from s3shuffle_tpu_torch.skew import SkewInfo, skew_trailer_words, split_index_trailers
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
from s3shuffle_tpu_torch.utils.concurrent_map import ConcurrentObjectMap

logger = logging.getLogger("s3shuffle_tpu_torch.metadata")

#: wire-schema binding (wire/schema.py): this module owns the per-map index
#: blob (cumulative offsets and the optional trailers) and the checksum
#: sidecar; WIRE01 holds the claim against the registry
_WIRE_STRUCTS = ("per_map_index", "checksum_sidecar")

@dataclasses.dataclass(frozen=True)
class MapLocation:
    """Where one map output's bytes live: the data object (a per-map
    singleton or a composite) and the absolute cumulative partition offsets
    inside it (a composite member's base already added), so consumers slice
    ``[offsets[start], offsets[end])`` whichever layout wrote the bytes.
    ``checksums`` comes from the fat index for a composite member (None for
    a singleton, whose checksum object is fetched apart). ``parity`` is the
    data object's stripe geometry when the coded plane wrote parity
    sidecars (None: uncoded). ``split_bytes`` and ``combined`` are the skew
    plane's commit-time coordinates (the skew trailer, or the fat index v3):
    the stripe the scan planner fans hot partitions out at (0 = unsplit)
    and the flag for map-side-combined partial rows."""

    data_block: BlockId
    offsets: np.ndarray
    checksums: Optional[np.ndarray] = None
    parity: Optional[ParityGeometry] = None
    split_bytes: int = 0
    combined: bool = False


class ShuffleHelper:
    def __init__(self, dispatcher: Dispatcher):
        self.dispatcher = dispatcher
        # keyed by the full object path (the app id included); cleared on
        # reinitialize
        self._length_cache: ConcurrentObjectMap[str, np.ndarray] = ConcurrentObjectMap()
        self._checksum_cache: ConcurrentObjectMap[str, np.ndarray] = ConcurrentObjectMap()
        self._fat_cache: ConcurrentObjectMap[str, FatIndex] = ConcurrentObjectMap()
        self._hints_lock = threading.Lock()
        self._composite_hints: Dict[Tuple[int, int], Tuple[int, int]] = {}
        self._listed_shuffles: set = set()
        # serializes listing discovery, so concurrent resolvers block until
        # the one listing pass has populated the hints (a racer must never
        # memoize a miss)
        self._discovery_lock = threading.Lock()
        dispatcher.on_reinitialize(self.clear_caches)

    # --- write side ---
    def write_partition_lengths(self, shuffle_id: int, map_id: int, lengths,
                                parity: Optional[ParityGeometry] = None,
                                skew: Optional[SkewInfo] = None) -> None:
        """Per-partition byte counts → cumulative offsets ``[0, l0, l0+l1, ...]``;
        an active ``skew`` appends the skew trailer, then ``parity`` the
        stripe-geometry trailer (the geometry stays the blob's final words).
        Both None, as at their planes' off switches, keep the reference's
        wire format."""
        offsets = np.zeros(len(lengths) + 1, dtype=np.int64)
        np.cumsum(np.asarray(lengths, dtype=np.int64), out=offsets[1:])
        if skew is not None and skew.active:
            offsets = np.concatenate([offsets, skew_trailer_words(skew)])
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
        self._write_blob(block, np.ascontiguousarray(array, dtype=">i8").tobytes())

    def write_fat_index(self, fat: FatIndex) -> None:
        """Store one composite group's fat index: the commit point of every
        member of the group (data object first, this last)."""
        self._write_blob(ShuffleFatIndexBlockId(fat.shuffle_id, fat.group_id), fat.to_bytes())

    def _write_blob(self, block: BlockId, data: bytes) -> None:
        stream = self.dispatcher.create_block(block)
        try:
            stream.write(data)
        finally:
            stream.close()

    # --- composite membership ---
    def note_composite_location(self, shuffle_id: int, map_id: int, group_id: int,
                                base_offset: int) -> None:
        """Record that one map output lives in a composite group (from a
        tracker registration or listing discovery); consulted before any
        per-map index fetch."""
        with self._hints_lock:
            self._composite_hints[(int(shuffle_id), int(map_id))] = (
                int(group_id), int(base_offset),
            )

    def composite_hint(self, shuffle_id: int, map_id: int):
        with self._hints_lock:
            return self._composite_hints.get((int(shuffle_id), int(map_id)))

    def read_fat_index(self, shuffle_id: int, group_id: int) -> FatIndex:
        """One composite group's fat index, fetched at most once per helper
        whatever the cache knobs say (one fat index serves many maps)."""
        path = self.dispatcher.get_path(ShuffleFatIndexBlockId(shuffle_id, group_id))
        return self._fat_cache.get_or_else_put(
            path, lambda _k: FatIndex.from_bytes(self.dispatcher.backend.read_all(path))
        )

    def _discover_composites(self, shuffle_id: int, refresh: bool = False) -> bool:
        """Listing-mode discovery: one listing pass finds the shuffle's fat
        indexes, and reading each (cached) gives every member's ``(group,
        base)``. Runs at most once per shuffle unless ``refresh`` (a map may
        have sealed into a composite after the first pass; the callers
        bound that to one re-list per unresolved map). Returns True when a
        listing ran."""
        with self._discovery_lock:
            with self._hints_lock:
                if shuffle_id in self._listed_shuffles and not refresh:
                    return False
            for group_id in self.dispatcher.list_composite_groups(shuffle_id):
                try:
                    fat = self.read_fat_index(shuffle_id, group_id)
                except (OSError, ValueError) as e:
                    logger.warning("fat index for shuffle %d group %d unreadable: %s",
                                   shuffle_id, group_id, e)
                    continue
                with self._hints_lock:
                    for m in fat.members.values():
                        self._composite_hints.setdefault(
                            (shuffle_id, m.map_id), (group_id, m.base_offset)
                        )
            with self._hints_lock:
                self._listed_shuffles.add(shuffle_id)
        return True

    def _discovery_allowed(self, shuffle_id: int) -> bool:
        """The store is consulted for composite membership only when
        composites can exist: a composite or compaction knob is on, a
        tracker hint arrived for this shuffle, or a discovery already ran."""
        cfg = self.dispatcher.config
        if cfg.composite_commit_maps > 1 or cfg.compact_below_bytes > 0:
            return True
        with self._hints_lock:
            if shuffle_id in self._listed_shuffles:
                return True
            return any(k[0] == shuffle_id for k in self._composite_hints)

    def _discovered_hint(self, shuffle_id: int, map_id: int, missing: FileNotFoundError):
        """The hint of a map whose per-map object is missing, by discovery
        (one listing, and one re-list when the first pass ran earlier);
        raises ``missing`` when the map is committed nowhere."""
        if not self._discovery_allowed(shuffle_id):
            raise missing
        listed = self._discover_composites(shuffle_id)
        hint = self.composite_hint(shuffle_id, map_id)
        if hint is None and not listed:
            self._discover_composites(shuffle_id, refresh=True)
            hint = self.composite_hint(shuffle_id, map_id)
        if hint is None:
            raise missing
        return hint

    def _composite_location(self, shuffle_id: int, map_id: int, hint) -> MapLocation:
        group_id, _base = hint
        fat = self.read_fat_index(shuffle_id, group_id)
        member = fat.member(map_id)
        return MapLocation(
            data_block=ShuffleCompositeDataBlockId(shuffle_id, group_id),
            offsets=member.base_offset + member.offsets,
            checksums=member.checksums,
            parity=fat.parity,
            split_bytes=fat.split_bytes,
            combined=member.combined,
        )

    def _composite_checksums(self, shuffle_id: int, map_id: int, hint) -> np.ndarray:
        member = self.read_fat_index(shuffle_id, hint[0]).member(map_id)
        if member.checksums is None:
            raise FileNotFoundError(
                f"composite group {hint[0]} carries no checksums for "
                f"shuffle {shuffle_id} map {map_id}"
            )
        return member.checksums

    # --- read side (read-through caches, S3ShuffleHelper.scala:67-92) ---
    def resolve_map_location(self, shuffle_id: int, map_id: int) -> MapLocation:
        """One map output's data object and absolute offsets, for either
        layout: a composite hint first, then the per-map index, then
        composite discovery where it is allowed. FileNotFoundError when the
        map is committed nowhere."""
        hint = self.composite_hint(shuffle_id, map_id)
        if hint is None:
            try:
                offsets, geometry, skew = self.read_index(shuffle_id, map_id)
                return MapLocation(
                    data_block=ShuffleDataBlockId(shuffle_id, map_id),
                    offsets=offsets,
                    parity=geometry,
                    split_bytes=0 if skew is None else skew.split_bytes,
                    combined=skew is not None and skew.combined,
                )
            except FileNotFoundError as e:
                hint = self._discovered_hint(shuffle_id, map_id, e)
        return self._composite_location(shuffle_id, map_id, hint)

    def read_index(
        self, shuffle_id: int, map_id: int,
    ) -> Tuple[np.ndarray, Optional[ParityGeometry], Optional[SkewInfo]]:
        """``(cumulative offsets, stripe geometry | None, skew trailer |
        None)`` of one per-map index object. The cache keeps the raw words
        (trailers included), so cached and fresh reads parse alike."""
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
                f"{block.name}: it is uncommitted, or it lives in a composite "
                "group this helper has no hint for (the store is searched for "
                "composite groups only when composite_commit_maps > 1 or "
                "compact_below_bytes > 0, or after a hint for the shuffle)"
            ) from e
        return split_index_trailers(words)

    def get_index(self, shuffle_id: int, map_id: int) -> Tuple[np.ndarray, Optional[ParityGeometry]]:
        """``(cumulative offsets, stripe geometry | None)`` of one map output,
        whichever layout holds it."""
        location = self.resolve_map_location(shuffle_id, map_id)
        return location.offsets, location.parity

    def get_partition_lengths(self, shuffle_id: int, map_id: int) -> np.ndarray:
        """Absolute cumulative offsets of one map output, trailers removed;
        FileNotFoundError when the output is uncommitted."""
        return self.resolve_map_location(shuffle_id, map_id).offsets

    def get_checksums(self, shuffle_id: int, map_id: int) -> np.ndarray:
        hint = self.composite_hint(shuffle_id, map_id)
        if hint is not None:
            return self._composite_checksums(shuffle_id, map_id, hint)
        block = ShuffleChecksumBlockId(
            shuffle_id, map_id, algorithm=self.dispatcher.config.checksum_algorithm
        )
        try:
            if self.dispatcher.config.cache_checksums:
                return self._checksum_cache.get_or_else_put(
                    self.dispatcher.get_path(block), lambda _k: self.read_block_as_array(block)
                )
            return self.read_block_as_array(block)
        except FileNotFoundError as e:
            hint = self._discovered_hint(shuffle_id, map_id, e)
        return self._composite_checksums(shuffle_id, map_id, hint)

    def read_block_as_array(self, block: BlockId) -> np.ndarray:
        data = self.dispatcher.backend.read_all(self.dispatcher.get_path(block))
        if len(data) % 8 != 0:
            raise ValueError(
                f"Metadata block {block.name} has invalid length {len(data)} (not /8)"
            )
        return np.frombuffer(data, dtype=">i8").astype(np.int64)

    def purge_cached_data_for_shuffle(self, shuffle_id: int) -> None:
        needle = f"shuffle_{shuffle_id}_"
        for cache in (self._length_cache, self._checksum_cache, self._fat_cache):
            cache.remove(lambda k: k.rsplit("/", 1)[-1].startswith(needle))
        with self._hints_lock:
            self._composite_hints = {
                k: v for k, v in self._composite_hints.items() if k[0] != shuffle_id
            }
            self._listed_shuffles.discard(shuffle_id)

    def clear_caches(self) -> None:
        self._length_cache.clear()
        self._checksum_cache.clear()
        self._fat_cache.clear()
        with self._hints_lock:
            self._composite_hints = {}
            self._listed_shuffles = set()


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


def pack_longs_be(values) -> bytes:
    """Big-endian int64 packing (DataOutputStream wire format)."""
    return struct.pack(f">{len(values)}q", *values)


def unpack_longs_be(data: bytes) -> list:
    if len(data) % 8 != 0:
        raise ValueError(f"blob length {len(data)} not a multiple of 8")
    return list(struct.unpack(f">{len(data) // 8}q", data))
