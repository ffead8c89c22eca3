"""Post-hoc composite compaction of small-map shuffles (the JAX package's
``write/compactor.py``).

A shuffle written with composite commits off leaves a small data, index
and checksum object per map; every reduce scan pays a GET per object and
every listing crawls them. The compactor rewrites committed singleton
outputs into composite data objects and fat indexes after the map stage:

1. candidates are committed singleton outputs whose data object is
   smaller than ``compact_below_bytes`` (registered winners only, when a
   tracker is given), minus maps already in a composite;
2. chunks of candidates stream into fresh composite objects, the same
   layout the live aggregator writes, each fat index written last;
3. the tracker is re-pointed in one batched registration per group, and
   the helper hinted, so new scans resolve the composite;
4. the superseded per-map objects (data, index, checksum, parity) are
   generation-stamped (``Dispatcher.stamp_generation``), never deleted
   inline: an in-flight scan may still read them. The TTL sweep
   (``sweep_expired_generations``) reclaims them after ``tombstone_ttl_s``.

Crash safety: the fat index is each group's commit point and the re-point
follows it, so a crash leaves the old layout live, or both; composite hints
win at resolution, and the old objects stay readable until the TTL. A
re-run selects nothing already compacted, so it never rebuilds a live
group in place. The compacted composite carries no parity of its own.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional

import numpy as np

from s3shuffle_tpu_torch.block_ids import (
    ShuffleChecksumBlockId,
    ShuffleCompositeDataBlockId,
    ShuffleDataBlockId,
    ShuffleFatIndexBlockId,
    ShuffleIndexBlockId,
    ShuffleParityBlockId,
)
from s3shuffle_tpu_torch.metadata.fat_index import FatIndex, FatIndexMember
from s3shuffle_tpu_torch.metadata.helper import ShuffleHelper
from s3shuffle_tpu_torch.skew import split_index_trailers
from s3shuffle_tpu_torch.metadata.map_output import STORE_LOCATION, MapStatus
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher

logger = logging.getLogger("s3shuffle_tpu_torch.write")


@dataclasses.dataclass
class CompactionReport:
    shuffle_id: int
    groups: int = 0
    maps: int = 0
    bytes: int = 0
    tombstoned: int = 0
    generations: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Candidate:
    map_id: int
    size: int
    offsets: np.ndarray
    checksums: Optional[np.ndarray]
    parity_segments: int = 0
    #: the singleton's index flagged map-side-combined partial rows
    combined: bool = False


def compact_shuffle(
    dispatcher: Dispatcher,
    helper: ShuffleHelper,
    shuffle_id: int,
    tracker=None,
    below_bytes: Optional[int] = None,
    maps_per_group: Optional[int] = None,
) -> CompactionReport:
    """Rewrite this shuffle's small committed singleton outputs into
    composite groups (see the module docstring). ``below_bytes`` defaults
    to ``compact_below_bytes`` (0: nothing to do), ``maps_per_group`` to
    ``composite_commit_maps`` when that is above 1, else 64; a group also
    stops short of ``composite_flush_bytes``."""
    cfg = dispatcher.config
    threshold = cfg.compact_below_bytes if below_bytes is None else int(below_bytes)
    report = CompactionReport(shuffle_id)
    if threshold <= 0:
        return report
    cap_maps = maps_per_group or (
        cfg.composite_commit_maps if cfg.composite_commit_maps > 1 else 64
    )

    # the tracker's own registrations are the map_id -> map_index truth, and
    # they restrict compaction to registered winners (a dead attempt's
    # singleton is the orphan sweep's)
    known_index = None
    deduped = getattr(tracker, "deduped_statuses", None)
    if deduped is not None:
        try:
            known_index = {status.map_id: map_index for map_index, status in deduped(shuffle_id)}
        except Exception as e:
            logger.warning("compactor could not read tracker state for shuffle %d: %s",
                           shuffle_id, e)

    # re-run safety: a map already in a composite is never selected again
    # (its tombstoned singletons stay listed until the TTL sweep), or the
    # pass would rebuild a live group id with other members in place
    singles, groups = dispatcher.list_committed_outputs(shuffle_id)
    already_composite = set()
    for group_id in groups:
        path = dispatcher.get_path(ShuffleFatIndexBlockId(shuffle_id, group_id))
        try:
            fat = FatIndex.from_bytes(dispatcher.backend.read_all(path))
        except Exception as e:
            logger.warning("compactor cannot read fat index %s (%s); skipping "
                           "compaction of shuffle %d", path, e, shuffle_id)
            return report
        already_composite.update(fat.members)

    candidates: List[_Candidate] = []
    for idx in singles:
        if idx.map_id in already_composite:
            continue  # a superseded singleton awaiting its TTL sweep
        if known_index is not None and idx.map_id not in known_index:
            continue  # not a registered winner
        data_path = dispatcher.get_path(ShuffleDataBlockId(shuffle_id, idx.map_id))
        try:
            size = dispatcher.backend.status(data_path).size
        except OSError:
            continue  # an index-only (empty) output: nothing to compact
        if size >= threshold:
            continue
        try:
            offsets, geometry, skew = split_index_trailers(
                helper.read_block_as_array(ShuffleIndexBlockId(shuffle_id, idx.map_id))
            )
            checksums: Optional[np.ndarray] = None
            if cfg.checksum_enabled:
                checksums = helper.read_block_as_array(
                    ShuffleChecksumBlockId(shuffle_id, idx.map_id,
                                           algorithm=cfg.checksum_algorithm)
                )
        except (OSError, ValueError) as e:
            logger.warning("compactor skipping map %d of shuffle %d: %s",
                           idx.map_id, shuffle_id, e)
            continue
        candidates.append(_Candidate(
            idx.map_id, int(size), offsets, checksums,
            parity_segments=geometry.segments if geometry else 0,
            combined=skew is not None and skew.combined,
        ))
    if len(candidates) < 2:
        return report

    stride = cfg.map_id_attempt_stride
    chunk: List[_Candidate] = []
    chunk_bytes = 0
    chunks: List[List[_Candidate]] = []
    for cand in candidates:
        if chunk and (len(chunk) >= cap_maps
                      or chunk_bytes + cand.size > cfg.composite_flush_bytes):
            chunks.append(chunk)
            chunk, chunk_bytes = [], 0
        chunk.append(cand)
        chunk_bytes += cand.size
    if len(chunk) >= 2:
        chunks.append(chunk)

    for members in chunks:
        if len(members) < 2:
            continue
        group_id = members[0].map_id
        data_block = ShuffleCompositeDataBlockId(shuffle_id, group_id)
        fat_members: List[FatIndexMember] = []
        statuses: List[MapStatus] = []
        base = 0
        sink = dispatcher.create_block(data_block)
        try:
            for m in members:
                payload = dispatcher.backend.read_all(
                    dispatcher.get_path(ShuffleDataBlockId(shuffle_id, m.map_id))
                )
                if len(payload) != int(m.offsets[-1]):
                    raise IOError(f"map {m.map_id} data is {len(payload)} bytes, index "
                                  f"says {int(m.offsets[-1])}")
                sink.write(payload)
                if known_index is not None:
                    map_index = known_index[m.map_id]
                else:
                    map_index = m.map_id // stride if stride else m.map_id
                fat_members.append(FatIndexMember(
                    map_id=m.map_id, map_index=map_index, base_offset=base,
                    offsets=m.offsets, checksums=m.checksums, combined=m.combined,
                ))
                statuses.append(MapStatus(
                    map_id=m.map_id, location=STORE_LOCATION,
                    sizes=np.diff(m.offsets).astype(np.int64), map_index=map_index,
                    composite_group=group_id, base_offset=base,
                ))
                base += len(payload)
        except Exception as e:
            try:
                sink.close()
            finally:
                try:
                    dispatcher.backend.delete(dispatcher.get_path(data_block))
                except OSError:
                    pass
            logger.warning("compaction of group %d (shuffle %d) aborted: %s; the old "
                           "layout stays live", group_id, shuffle_id, e)
            continue
        sink.close()
        # the fat index last: the group's commit point
        helper.write_fat_index(
            FatIndex(shuffle_id, group_id, len(fat_members[0].offsets) - 1, fat_members)
        )
        if tracker is not None:
            tracker.register_map_outputs(shuffle_id, statuses)
        old_paths: List[str] = []
        for s, m in zip(statuses, members):
            helper.note_composite_location(shuffle_id, s.map_id, s.composite_group,
                                           s.base_offset)
            old_paths.append(dispatcher.get_path(ShuffleDataBlockId(shuffle_id, s.map_id)))
            old_paths.append(dispatcher.get_path(ShuffleIndexBlockId(shuffle_id, s.map_id)))
            if cfg.checksum_enabled:
                old_paths.append(dispatcher.get_path(ShuffleChecksumBlockId(
                    shuffle_id, s.map_id, algorithm=cfg.checksum_algorithm)))
            # the singleton's parity covers the superseded object: it rides
            # the same generation
            for i in range(m.parity_segments):
                old_paths.append(dispatcher.get_path(ShuffleParityBlockId(shuffle_id, s.map_id, i)))
        report.generations.append(dispatcher.stamp_generation(shuffle_id, old_paths))
        report.tombstoned += len(old_paths)
        report.groups += 1
        report.maps += len(members)
        report.bytes += base
    if report.groups:
        logger.info(
            "Compacted shuffle %d: %d singleton outputs -> %d composite group(s), "
            "%d bytes; %d objects tombstoned",
            shuffle_id, report.maps, report.groups, report.bytes, report.tombstoned,
        )
    return report
