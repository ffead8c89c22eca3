"""Sharded map-output tracker (the JAX package's ``metadata/shard.py``).

One :class:`~s3shuffle_tpu_torch.metadata.map_output.MapOutputTracker`
serializes every registration and lookup on one lock; at fleet scale that
lock, and the one socket loop in front of it, is the coordinator's hotspot.
This tracker hashes the shuffle/map keyspace across N shards instead, each
a plain :class:`MapOutputTracker` with its own lock, so registrations of
different map tasks contend only when they land on the same shard.

Routing hashes the logical ``map_index``, never the attempt-strided
``map_id``: every attempt of one logical map lands on one shard, where the
latest-attempt dedupe keeps working. Range lookups fan out over the shards
and merge; a global re-dedupe keeps the merged answer equal to one flat
tracker's even if the routing changed between releases.

The per-shuffle epoch lives here, not per shard: a counter raised by every
registration, which stamps the map-output snapshots
(:mod:`s3shuffle_tpu_torch.metadata.snapshot`).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from s3shuffle_tpu_torch.metadata.map_output import (
    MapOutputTracker,
    MapStatus,
    composite_locations_of,
    dedupe_latest_attempt,
    sizes_for_ranges,
)

#: Knuth's multiplicative constant: spreads sequential map indices across
#: the shards instead of striding them onto one
_HASH_MULT = 2654435761


def shard_of(shuffle_id: int, map_index: int, num_shards: int) -> int:
    """Deterministic shard of (shuffle, logical map index)."""
    return ((shuffle_id * 1000003 + map_index) * _HASH_MULT) % (1 << 32) % num_shards


class ShardedMapOutputTracker:
    """A :class:`MapOutputTracker` partitioned across ``num_shards`` shards,
    with the stats surface the metadata service dispatches to, so it serves
    a :class:`~s3shuffle_tpu_torch.metadata.service.MetadataServer` as is."""

    def __init__(self, num_shards: int = 4):
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        self.num_shards = int(num_shards)
        self._shards = [MapOutputTracker() for _ in range(self.num_shards)]
        # shuffle-level state (partition counts, epochs) is small and rarely
        # written: one lock for it never contends with map registrations
        self._meta_lock = threading.Lock()
        self._num_partitions: Dict[int, int] = {}
        self._epochs: Dict[int, int] = {}

    # -- routing -------------------------------------------------------
    def shard_index(self, shuffle_id: int, map_index: int) -> int:
        return shard_of(shuffle_id, map_index, self.num_shards)

    def _shard(self, shuffle_id: int, map_index: int) -> MapOutputTracker:
        return self._shards[self.shard_index(shuffle_id, map_index)]

    # -- registration --------------------------------------------------
    def register_shuffle(self, shuffle_id: int, num_partitions: int) -> None:
        with self._meta_lock:
            self._num_partitions[shuffle_id] = num_partitions
            self._epochs.setdefault(shuffle_id, 0)
        for shard in self._shards:
            shard.register_shuffle(shuffle_id, num_partitions)

    def register_map_output(self, shuffle_id: int, status: MapStatus) -> None:
        self._shard(shuffle_id, status.map_index).register_map_output(shuffle_id, status)
        with self._meta_lock:
            if shuffle_id not in self._num_partitions:
                return  # a racing unregister; the shard raised if never known
            self._epochs[shuffle_id] = self._epochs.get(shuffle_id, 0) + 1

    def register_map_outputs(self, shuffle_id: int, statuses: List[MapStatus]) -> None:
        """Batch registration: grouped by shard, one lock acquisition per
        shard touched (the server's half of the batched RPC)."""
        by_shard: Dict[int, List[MapStatus]] = {}
        for status in statuses:
            by_shard.setdefault(
                self.shard_index(shuffle_id, status.map_index), []
            ).append(status)
        for idx, group in by_shard.items():
            self._shards[idx].register_map_outputs(shuffle_id, group)
        with self._meta_lock:
            if shuffle_id in self._num_partitions:
                self._epochs[shuffle_id] = self._epochs.get(shuffle_id, 0) + len(statuses)

    # -- lookups -------------------------------------------------------
    def contains(self, shuffle_id: int) -> bool:
        with self._meta_lock:
            return shuffle_id in self._num_partitions

    def num_partitions(self, shuffle_id: int) -> int:
        with self._meta_lock:
            return self._num_partitions[shuffle_id]

    def epoch(self, shuffle_id: int) -> int:
        with self._meta_lock:
            if shuffle_id not in self._num_partitions:
                raise KeyError(f"Shuffle {shuffle_id} not registered")
            return self._epochs.get(shuffle_id, 0)

    def deduped_statuses(self, shuffle_id: int) -> List[Tuple[int, MapStatus]]:
        """``[(map_index, status), ...]`` merged over the shards, in sorted
        logical order. Each shard already kept one attempt per index; the
        global re-dedupe changes nothing unless the routing drifted."""
        merged: List[Tuple[int, MapStatus]] = []
        for shard in self._shards:
            merged.extend(shard.deduped_statuses(shuffle_id))
        return dedupe_latest_attempt(
            [status for _idx, status in merged],
            logical_of=lambda s: s.map_index,
            map_id_of=lambda s: s.map_id,
        )

    def get_map_sizes_by_range(
        self,
        shuffle_id: int,
        start_map_index: int,
        end_map_index: Optional[int],
        start_partition: int,
        end_partition: int,
    ) -> List[Tuple[int, List[Tuple[int, int]]]]:
        return self.get_map_sizes_by_ranges(
            shuffle_id, start_map_index, end_map_index,
            [(start_partition, end_partition)],
        )[0]

    def get_map_sizes_by_ranges(
        self,
        shuffle_id: int,
        start_map_index: int,
        end_map_index: Optional[int],
        partition_ranges: List[Tuple[int, int]],
    ) -> List[List[Tuple[int, List[Tuple[int, int]]]]]:
        return sizes_for_ranges(
            self.deduped_statuses(shuffle_id),
            start_map_index, end_map_index, list(partition_ranges),
        )

    def registered_map_ids(self, shuffle_id: int) -> List[int]:
        ids: List[int] = []
        for shard in self._shards:
            ids.extend(shard.registered_map_ids(shuffle_id))
        return sorted(ids)

    def composite_locations(self, shuffle_id: int) -> List[Tuple[int, int, int]]:
        """Composite ``(map_id, group, base_offset)`` rows merged over the
        shards: the flat tracker's answer."""
        return composite_locations_of(self.deduped_statuses(shuffle_id))

    def shuffle_ids(self) -> List[int]:
        with self._meta_lock:
            return sorted(self._num_partitions)

    # -- lifecycle -----------------------------------------------------
    def unregister_shuffle(self, shuffle_id: int) -> None:
        with self._meta_lock:
            self._num_partitions.pop(shuffle_id, None)
            self._epochs.pop(shuffle_id, None)
        for shard in self._shards:
            shard.unregister_shuffle(shuffle_id)
        # a coordinator's tracker aggregates the whole fleet's ShuffleStats:
        # a long-lived session drops the aggregate with the registration
        # (read the report before unregistering)
        from s3shuffle_tpu_torch.metrics.stats import COLLECTOR

        COLLECTOR.drop(shuffle_id)

    # -- per-shuffle stats aggregation (metrics/stats.py) --------------
    def report_task_stats(self, entries: List[dict]) -> None:
        from s3shuffle_tpu_torch.metrics.stats import COLLECTOR

        for entry in entries:
            COLLECTOR.merge(entry)

    def get_shuffle_stats(self, shuffle_id: int) -> Optional[dict]:
        from s3shuffle_tpu_torch.metrics.stats import COLLECTOR

        report = COLLECTOR.report(int(shuffle_id))
        return None if report is None else report.to_dict()
