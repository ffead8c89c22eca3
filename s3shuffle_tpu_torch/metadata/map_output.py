"""Map-output tracking — the control plane (the JAX package's
``metadata/map_output.py``): the in-process tracker, which the sharded
tracker (``shard.py``) partitions and the metadata service
(``service.py``) serves.

Parity: the reference's control plane is Spark RPC: map tasks return a
``MapStatus`` whose location ``S3ShuffleWriter`` rewrites to
``FALLBACK_BLOCK_MANAGER_ID`` (S3ShuffleWriter.scala:7-21) — the trick that
makes shuffle output executor-independent — and reducers enumerate blocks
via ``MapOutputTracker.getMapSizesByExecutorId`` (S3ShuffleReader.scala:169-176).
Here the tracker is a process-local registry. ``STORE_LOCATION`` is the
analog of FALLBACK_BLOCK_MANAGER_ID: every committed map output lives in
the object store, never on a worker.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Protocol, Tuple

import numpy as np

# Analog of FallbackStorage.FALLBACK_BLOCK_MANAGER_ID: shuffle output is
# addressed to the store, not to any worker.
STORE_LOCATION = "object-store"


@dataclasses.dataclass
class MapStatus:
    """Spark 3 keeps the *logical* map index (partition position) and the
    *attempt-unique* mapId as separate fields; range queries filter on
    ``map_index``, never ``map_id``."""

    map_id: int
    location: str
    sizes: np.ndarray  # per reduce partition, stored (compressed) bytes
    map_index: int = -1  # logical map partition index; defaults to map_id
    #: composite layout coordinates (write/composite_commit.py): the group
    #: whose composite data object and fat index hold this output, and its
    #: byte base inside that object; -1 = the one-object-per-map layout.
    #: Readers seed the helper's hints from them, so composite members
    #: resolve without any per-map index fetch.
    composite_group: int = -1
    base_offset: int = 0
    #: parity sidecar count of the data object holding this output
    #: (0 = uncoded); the stripe geometry readers rebuild with rides the
    #: index sidecar
    parity_segments: int = 0

    def __post_init__(self) -> None:
        if self.map_index < 0:
            self.map_index = self.map_id


def dedupe_latest_attempt(items, logical_of, map_id_of):
    """One winner per LOGICAL map index: keep the item with the largest
    attempt-unique map_id, returned in sorted logical order."""
    by_logical: Dict[int, object] = {}
    for item in items:
        lg = logical_of(item)
        prev = by_logical.get(lg)
        if prev is None or map_id_of(item) > map_id_of(prev):
            by_logical[lg] = item
    return [(lg, by_logical[lg]) for lg in sorted(by_logical)]


class MapOutputTrackerLike(Protocol):
    """The tracker contract the manager, the reader and the compactor
    depend on: the in-process :class:`MapOutputTracker`, the sharded
    tracker, the remote and batched clients of the metadata service and the
    snapshot-backed facade all satisfy it."""

    def register_shuffle(self, shuffle_id: int, num_partitions: int) -> None: ...

    def register_map_output(self, shuffle_id: int, status: MapStatus) -> None: ...

    def register_map_outputs(self, shuffle_id: int, statuses: List[MapStatus]) -> None: ...

    def get_map_sizes_by_range(
        self,
        shuffle_id: int,
        start_map_index: int,
        end_map_index: Optional[int],
        start_partition: int,
        end_partition: int,
    ) -> List[Tuple[int, List[Tuple[int, int]]]]: ...

    def get_map_sizes_by_ranges(
        self,
        shuffle_id: int,
        start_map_index: int,
        end_map_index: Optional[int],
        partition_ranges: List[Tuple[int, int]],
    ) -> List[List[Tuple[int, List[Tuple[int, int]]]]]: ...

    def contains(self, shuffle_id: int) -> bool: ...

    def num_partitions(self, shuffle_id: int) -> int: ...

    def unregister_shuffle(self, shuffle_id: int) -> None: ...

    def registered_map_ids(self, shuffle_id: int) -> List[int]: ...

    def composite_locations(self, shuffle_id: int) -> List[Tuple[int, int, int]]: ...

    def shuffle_ids(self) -> List[int]: ...


def sizes_for_ranges(
    deduped: List[Tuple[int, MapStatus]],
    start_map_index: int,
    end_map_index: Optional[int],
    partition_ranges: List[Tuple[int, int]],
) -> List[List[Tuple[int, List[Tuple[int, int]]]]]:
    """Answer a batch of partition-range queries from one deduped
    ``[(map_index, status), ...]`` list — one result list per requested
    ``(start_partition, end_partition)`` range, each
    ``[(map_id, [(reduce_id, size), ...]), ...]``."""
    selected = [
        status
        for map_index, status in deduped
        if map_index >= start_map_index
        and (end_map_index is None or map_index < end_map_index)
    ]
    return [
        [
            (
                status.map_id,
                [(rid, int(status.sizes[rid])) for rid in range(sp, ep)],
            )
            for status in selected
        ]
        for sp, ep in partition_ranges
    ]


def composite_locations_of(
    deduped: List[Tuple[int, MapStatus]]
) -> List[Tuple[int, int, int]]:
    """``[(map_id, group, base_offset), ...]`` of the composite members in a
    deduped status list."""
    return [
        (status.map_id, status.composite_group, status.base_offset)
        for _idx, status in deduped
        if status.composite_group >= 0
    ]


class MapOutputTracker:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._shuffles: Dict[int, Dict[int, MapStatus]] = {}
        self._num_partitions: Dict[int, int] = {}
        self._epochs: Dict[int, int] = {}

    def register_shuffle(self, shuffle_id: int, num_partitions: int) -> None:
        with self._lock:
            self._shuffles.setdefault(shuffle_id, {})
            self._num_partitions[shuffle_id] = num_partitions
            self._epochs.setdefault(shuffle_id, 0)

    def register_map_output(self, shuffle_id: int, status: MapStatus) -> None:
        with self._lock:
            if shuffle_id not in self._shuffles:
                raise KeyError(f"Shuffle {shuffle_id} not registered")
            self._shuffles[shuffle_id][status.map_id] = status
            self._epochs[shuffle_id] = self._epochs.get(shuffle_id, 0) + 1

    def register_map_outputs(self, shuffle_id: int, statuses: List[MapStatus]) -> None:
        """Batch registration under one lock: a composite group's members
        (or a compaction's re-point) become visible together."""
        with self._lock:
            if shuffle_id not in self._shuffles:
                raise KeyError(f"Shuffle {shuffle_id} not registered")
            table = self._shuffles[shuffle_id]
            for status in statuses:
                table[status.map_id] = status
            self._epochs[shuffle_id] = self._epochs.get(shuffle_id, 0) + len(statuses)

    def epoch(self, shuffle_id: int) -> int:
        """Monotonic registration counter of one shuffle."""
        with self._lock:
            if shuffle_id not in self._shuffles:
                raise KeyError(f"Shuffle {shuffle_id} not registered")
            return self._epochs.get(shuffle_id, 0)

    def contains(self, shuffle_id: int) -> bool:
        with self._lock:
            return shuffle_id in self._shuffles

    def num_partitions(self, shuffle_id: int) -> int:
        with self._lock:
            return self._num_partitions[shuffle_id]

    def deduped_statuses(self, shuffle_id: int) -> List[Tuple[int, MapStatus]]:
        """One winner per logical map index, ``[(map_index, status), ...]``
        in sorted logical order."""
        with self._lock:
            if shuffle_id not in self._shuffles:
                raise KeyError(f"Shuffle {shuffle_id} not registered")
            statuses = list(self._shuffles[shuffle_id].values())
        return dedupe_latest_attempt(
            statuses,
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
        """[(map_id, [(reduce_id, size), ...]), ...] for the requested map and
        partition ranges. The range filters on the LOGICAL ``map_index``;
        the returned ``map_id`` names the store objects."""
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
        """Batch form of :meth:`get_map_sizes_by_range`: one result list per
        requested ``(start_partition, end_partition)`` range, from one pass
        over the shuffle's deduped statuses."""
        return sizes_for_ranges(
            self.deduped_statuses(shuffle_id),
            start_map_index, end_map_index, list(partition_ranges),
        )

    def registered_map_ids(self, shuffle_id: int) -> List[int]:
        """The attempt-unique map ids of every registered (committed) map
        output: the winners the orphan sweep keeps."""
        with self._lock:
            if shuffle_id not in self._shuffles:
                raise KeyError(f"Shuffle {shuffle_id} not registered")
            return sorted(self._shuffles[shuffle_id])

    def composite_locations(self, shuffle_id: int) -> List[Tuple[int, int, int]]:
        """``[(map_id, composite_group, base_offset), ...]`` of every winning
        map output that lives in a composite data object: what a reduce scan
        seeds the helper's composite hints with. Empty for a shuffle in the
        one-object-per-map layout."""
        return composite_locations_of(self.deduped_statuses(shuffle_id))

    def unregister_shuffle(self, shuffle_id: int) -> None:
        with self._lock:
            self._shuffles.pop(shuffle_id, None)
            self._num_partitions.pop(shuffle_id, None)
            self._epochs.pop(shuffle_id, None)

    def shuffle_ids(self) -> List[int]:
        with self._lock:
            return list(self._shuffles.keys())

    # -- per-shuffle stats aggregation (metrics/stats.py) --------------
    def report_task_stats(self, entries: List[dict]) -> None:
        """Fold task-stats entries (TaskStats dicts, each with its own
        shuffle_id) into the process collector."""
        from s3shuffle_tpu_torch.metrics.stats import COLLECTOR

        for entry in entries:
            COLLECTOR.merge(entry)

    def get_shuffle_stats(self, shuffle_id: int) -> Optional[dict]:
        """The aggregated ShuffleStats report as a dict (None when nothing
        was recorded, e.g. with the registry off)."""
        from s3shuffle_tpu_torch.metrics.stats import COLLECTOR

        report = COLLECTOR.report(int(shuffle_id))
        return None if report is None else report.to_dict()
