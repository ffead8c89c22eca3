"""Block identifiers.

Parity: the reference reuses Spark's ``BlockId`` hierarchy — map output is one
``ShuffleDataBlockId(shuffleId, mapId, NOOP_REDUCE_ID)`` data object plus an
index object and optional checksum object (S3ShuffleMapOutputWriter.scala:43-49,
S3ShuffleHelper.scala:44-59); reads address ``ShuffleBlockId`` /
``ShuffleBlockBatchId`` sub-ranges (S3ShuffleBlockIterator.scala:36-43).
Names follow the JAX package's ``shuffle_<shuffle>_<map>_<reduce>``
convention byte for byte, so either package finds the other's objects.
The ids of the per-map data plane, its parity sidecars, the composite
commit plane (composite data, fat index, composite parity) and the
generation tombstones are here, with the name parsers the listing mode and
the lifecycle sweeps use, and the control plane's map-output snapshot id.
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
class ShuffleSnapshotBlockId(BlockId):
    """The epoch-stamped map-output snapshot object of one shuffle
    (metadata/snapshot.py). It is per shuffle, not per map: ``map_id`` is
    pinned to 0 for prefix sharding only. The ``.snapmeta`` suffix keeps it
    out of index listing (:func:`parse_index_name`) and the orphan sweep
    (:func:`parse_shuffle_object_name`), while it lives under the shuffle's
    prefix so ``remove_shuffle`` reclaims it."""

    shuffle_id: int
    epoch: int
    map_id: int = 0

    @property
    def name(self) -> str:
        return f"shuffle_{self.shuffle_id}_snapshot_{self.epoch}.snapmeta"


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


@dataclasses.dataclass(frozen=True)
class ShuffleCompositeDataBlockId(BlockId):
    """One composite data object holding many map outputs back to back
    (write/composite_commit.py). ``group_id`` is the first member's
    attempt-unique map id, so names never collide across workers or
    attempts; the ``comp`` infix keeps the object invisible to the per-map
    parsers."""

    shuffle_id: int
    group_id: int

    @property
    def map_id(self) -> int:  # prefix sharding key (Dispatcher.get_path)
        return self.group_id

    @property
    def name(self) -> str:
        return f"shuffle_{self.shuffle_id}_comp_{self.group_id}.data"


@dataclasses.dataclass(frozen=True)
class ShuffleFatIndexBlockId(BlockId):
    """The fat index of one composite group (metadata/fat_index.py): its
    existence is the commit point of every member of the group."""

    shuffle_id: int
    group_id: int

    @property
    def map_id(self) -> int:
        return self.group_id

    @property
    def name(self) -> str:
        return f"shuffle_{self.shuffle_id}_comp_{self.group_id}.cindex"


@dataclasses.dataclass(frozen=True)
class ShuffleCompositeParityBlockId(BlockId):
    """Parity sidecar ``seg`` of a composite data object, committed by the
    group's fat index."""

    shuffle_id: int
    group_id: int
    seg: int

    @property
    def map_id(self) -> int:
        return self.group_id

    @property
    def name(self) -> str:
        return f"shuffle_{self.shuffle_id}_comp_{self.group_id}_par{self.seg}.parity"


@dataclasses.dataclass(frozen=True)
class ShuffleTombstoneBlockId(BlockId):
    """Generation tombstone: a small JSON object naming store objects
    superseded at one generation stamp (the compactor's singletons). They
    stay readable for in-flight scans until
    ``Dispatcher.sweep_expired_generations`` deletes them after
    ``tombstone_ttl_s``. Lives under the shuffle prefix, so
    ``remove_shuffle`` reclaims it."""

    shuffle_id: int
    generation: int

    @property
    def map_id(self) -> int:
        return self.generation

    @property
    def name(self) -> str:
        return f"shuffle_{self.shuffle_id}_gen_{self.generation}.tomb"


#: wire-schema binding (wire/schema.py): object names are wire surface
#: (listing enumeration, the lifecycle sweeps and the protocol witness parse
#: them back); WIRE01 holds the grammars below against the registry
_WIRE_STRUCTS = ("object_names",)

_INDEX_RE = re.compile(r"^shuffle_(\d+)_(\d+)_(\d+)\.index$")
_ANY_RE = re.compile(
    r"^shuffle_(\d+)_(\d+)_(?:(\d+)\.(?:data|index|checksum\..+)|par\d+\.parity)$"
)
_COMPOSITE_RE = re.compile(
    r"^shuffle_(\d+)_comp_(\d+)(?:\.(data|cindex)|_par\d+\.(parity))$"
)
_TOMBSTONE_RE = re.compile(r"^shuffle_(\d+)_gen_(\d+)\.tomb$")


def parse_shuffle_object_name(name: str):
    """Any per-map shuffle object's name (data, index, checksum, parity)
    back to ``(shuffle_id, map_id)``, None for any other object: the orphan
    sweep classifies every listed object by its attempt-unique map id."""
    m = _ANY_RE.match(name.rsplit("/", 1)[-1])
    if m is None:
        return None
    return int(m.group(1)), int(m.group(2))


def parse_composite_name(name: str):
    """A composite data, fat-index or parity object's name back to
    ``(shuffle_id, group_id, kind)`` with kind ``"data"``, ``"cindex"`` or
    ``"parity"``; None for anything else."""
    m = _COMPOSITE_RE.match(name.rsplit("/", 1)[-1])
    if m is None:
        return None
    return int(m.group(1)), int(m.group(2)), m.group(3) or m.group(4)


def parse_tombstone_name(name: str):
    """A generation tombstone's name back to ``(shuffle_id, generation)``,
    or None."""
    m = _TOMBSTONE_RE.match(name.rsplit("/", 1)[-1])
    if m is None:
        return None
    return int(m.group(1)), int(m.group(2))


def parse_index_name(name: str) -> ShuffleIndexBlockId | None:
    """An index object's name (or path) back to its id, None for any other
    object: listing-mode enumeration keeps the ``*.index`` objects
    (S3ShuffleDispatcher.scala:146-172)."""
    m = _INDEX_RE.match(name.rsplit("/", 1)[-1])
    if m is None:
        return None
    return ShuffleIndexBlockId(int(m.group(1)), int(m.group(2)), int(m.group(3)))


def shuffle_id_of(block: BlockId) -> int:
    return block.shuffle_id  # type: ignore[attr-defined]
