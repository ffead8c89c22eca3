"""Block identifiers.

Parity: the reference reuses Spark's ``BlockId`` hierarchy — map output is one
``ShuffleDataBlockId(shuffleId, mapId, NOOP_REDUCE_ID)`` data object plus an
index object and optional checksum object (S3ShuffleMapOutputWriter.scala:43-49,
S3ShuffleHelper.scala:44-59); reads address ``ShuffleBlockId`` /
``ShuffleBlockBatchId`` sub-ranges (S3ShuffleBlockIterator.scala:36-43).
Names follow the JAX package's ``shuffle_<shuffle>_<map>_<reduce>``
convention byte for byte, so either package finds the other's objects.
The ids of the per-map data plane and its parity sidecars are here;
composite, snapshot and tombstone ids come with the parts of the port that
write them.
"""

from __future__ import annotations

import dataclasses
import re

NOOP_REDUCE_ID = 0


@dataclasses.dataclass(frozen=True)
class BlockId:
    @property
    def name(self) -> str:
        raise NotImplementedError

    def __str__(self) -> str:
        return self.name


@dataclasses.dataclass(frozen=True)
class ShuffleBlockId(BlockId):
    """One reduce partition of one map task's output."""

    shuffle_id: int
    map_id: int
    reduce_id: int

    @property
    def name(self) -> str:
        return f"shuffle_{self.shuffle_id}_{self.map_id}_{self.reduce_id}"


@dataclasses.dataclass(frozen=True)
class ShuffleBlockBatchId(BlockId):
    """A contiguous range of reduce partitions [start_reduce_id,
    end_reduce_id) of one map task — produced by batch-fetch merging
    (S3ShuffleReader.scala:177-180)."""

    shuffle_id: int
    map_id: int
    start_reduce_id: int
    end_reduce_id: int

    @property
    def name(self) -> str:
        return (
            f"shuffle_{self.shuffle_id}_{self.map_id}_"
            f"{self.start_reduce_id}_{self.end_reduce_id}"
        )


@dataclasses.dataclass(frozen=True)
class ShuffleDataBlockId(BlockId):
    """The single data object holding ALL reduce partitions of one map task."""

    shuffle_id: int
    map_id: int
    reduce_id: int = NOOP_REDUCE_ID

    @property
    def name(self) -> str:
        return f"shuffle_{self.shuffle_id}_{self.map_id}_{self.reduce_id}.data"


@dataclasses.dataclass(frozen=True)
class ShuffleIndexBlockId(BlockId):
    """Cumulative-offset index sidecar; its existence is the commit point
    (S3ShuffleBlockIterator.scala:46-53)."""

    shuffle_id: int
    map_id: int
    reduce_id: int = NOOP_REDUCE_ID

    @property
    def name(self) -> str:
        return f"shuffle_{self.shuffle_id}_{self.map_id}_{self.reduce_id}.index"


@dataclasses.dataclass(frozen=True)
class ShuffleChecksumBlockId(BlockId):
    shuffle_id: int
    map_id: int
    reduce_id: int = NOOP_REDUCE_ID
    algorithm: str = "ADLER32"

    @property
    def name(self) -> str:
        return (
            f"shuffle_{self.shuffle_id}_{self.map_id}_{self.reduce_id}"
            f".checksum.{self.algorithm}"
        )


@dataclasses.dataclass(frozen=True)
class ShuffleParityBlockId(BlockId):
    """Parity sidecar ``seg`` of a per-map data object (coding/parity.py).
    It shares the data object's ``map_id``, so prefix sharding puts parity
    beside its data; the index commits it."""

    shuffle_id: int
    map_id: int
    seg: int

    @property
    def name(self) -> str:
        return f"shuffle_{self.shuffle_id}_{self.map_id}_par{self.seg}.parity"


_INDEX_RE = re.compile(r"^shuffle_(\d+)_(\d+)_(\d+)\.index$")


def parse_index_name(name: str) -> ShuffleIndexBlockId | None:
    """An index object's name (or path) back to its id, None for any other
    object: listing-mode enumeration keeps the ``*.index`` objects
    (S3ShuffleDispatcher.scala:146-172)."""
    m = _INDEX_RE.match(name.rsplit("/", 1)[-1])
    if m is None:
        return None
    return ShuffleIndexBlockId(int(m.group(1)), int(m.group(2)), int(m.group(3)))
