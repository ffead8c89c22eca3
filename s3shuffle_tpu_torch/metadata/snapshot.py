"""Epoch-stamped map-output snapshots (the JAX package's
``metadata/snapshot.py``): lookups with no tracker round-trip.

Spark broadcasts serialized ``MapStatus`` arrays so reducers do not ask the
driver per lookup. Once a map stage closes its output table is immutable,
and coordinating per lookup is pure overhead. Here:

- :class:`MapOutputSnapshot` is an immutable, epoch-stamped copy of one
  shuffle's deduped map-output table, serialized as big-endian int64 words
  (the index sidecar's idiom, snapshot wire v3), so it travels as a plain
  store object (``ShuffleSnapshotBlockId``);
- :func:`build_snapshot` takes one from any tracker with
  ``deduped_statuses`` / ``num_partitions`` / ``epoch`` (plain or sharded),
  and :func:`publish_snapshot` writes it through a dispatcher when
  ``metadata_snapshots`` is on;
- :class:`SnapshotBackedTracker` is the worker's tracker facade: an
  attached snapshot answers lookups with no round-trip
  (``meta_lookup_source_total{source="snapshot"}``); everything else goes
  to the wrapped tracker (``source="rpc"``).

**The epoch contract.** A snapshot answers exactly the tracker state at its
epoch. The driver publishes one only at a barrier it owns (the map stage
complete) and advertises ``(path, epoch)``; a worker serves a shuffle's
lookups from a snapshot only while its attached epoch is the advertised
one, and any registration routed through the facade drops the attachment.
Workers never invent epochs: with no advertisement every lookup is a live
RPC.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from s3shuffle_tpu_torch.metadata.map_output import (
    STORE_LOCATION,
    MapStatus,
    composite_locations_of,
    sizes_for_ranges,
)
from s3shuffle_tpu_torch.metrics import registry as _metrics

logger = logging.getLogger("s3shuffle_tpu_torch.metadata.snapshot")

_C_LOOKUP_SOURCE = _metrics.REGISTRY.counter(
    "meta_lookup_source_total",
    "Map-output lookups by answer source: a local epoch-stamped snapshot "
    "(zero tracker round-trips) vs a live tracker RPC",
    labelnames=("source",),
)
_G_SNAPSHOT_AGE = _metrics.REGISTRY.gauge(
    "meta_snapshot_age_seconds",
    "Age of the snapshot that served the most recent lookup (now minus its "
    "publish stamp)",
)

#: wire-schema binding (wire/schema.py); WIRE01 holds the constants below
#: against the registry
_WIRE_STRUCTS = ("snapshot",)

#: wire magic ("S3SHSNAP" as an int64) + format version, first two words.
#: v2 added two per-row words (composite_group, base_offset) so snapshots
#: carry the composite-commit coordinates; v3 adds one more
#: (parity_segments) for the coded shuffle plane. v1/v2 blobs still parse
#: (rows default to the one-object-per-map, uncoded layout).
_MAGIC = 0x5333485348534E41
_VERSION = 3
_ROW_META_V1 = 2  # [map_id, map_index]
_ROW_META_V2 = 4  # [map_id, map_index, composite_group, base_offset]
_ROW_META_V3 = 5  # v2 + [parity_segments]


class MapOutputSnapshot:
    """Immutable map-output table of one shuffle at one epoch.

    ``entries`` is the deduped ``[(map_index, status), ...]`` list in sorted
    logical order — the same shape every tracker range query starts from, so
    snapshot answers are byte-identical to live answers at the same epoch.
    """

    def __init__(
        self,
        shuffle_id: int,
        epoch: int,
        num_partitions: int,
        entries: List[Tuple[int, MapStatus]],
        published_unix: Optional[float] = None,
    ):
        self.shuffle_id = int(shuffle_id)
        self.epoch = int(epoch)
        self._num_partitions = int(num_partitions)
        self.entries = list(entries)
        self.published_unix = (
            time.time() if published_unix is None else float(published_unix)
        )

    # -- lookup surface (the tracker-shaped subset) --------------------
    def num_partitions(self) -> int:
        return self._num_partitions

    def registered_map_ids(self) -> List[int]:
        return sorted(status.map_id for _idx, status in self.entries)

    def composite_locations(self) -> List[tuple]:
        return composite_locations_of(self.entries)

    def get_map_sizes_by_ranges(
        self,
        start_map_index: int,
        end_map_index: Optional[int],
        partition_ranges: List[Tuple[int, int]],
    ) -> List[List[Tuple[int, List[Tuple[int, int]]]]]:
        return sizes_for_ranges(
            self.entries, start_map_index, end_map_index, list(partition_ranges)
        )

    def get_map_sizes_by_range(
        self,
        start_map_index: int,
        end_map_index: Optional[int],
        start_partition: int,
        end_partition: int,
    ) -> List[Tuple[int, List[Tuple[int, int]]]]:
        return self.get_map_sizes_by_ranges(
            start_map_index, end_map_index, [(start_partition, end_partition)]
        )[0]

    # -- wire format ---------------------------------------------------
    def to_bytes(self) -> bytes:
        """Serialize as big-endian int64 words (the index sidecar idiom):
        header ``[magic, version, shuffle_id, epoch, num_partitions,
        published_unix_micros, n_entries]`` then one row per entry
        ``[map_id, map_index, composite_group, base_offset,
        parity_segments, sizes[0..P)]``."""
        p = self._num_partitions
        meta = _ROW_META_V3
        header = np.array(
            [
                _MAGIC, _VERSION, self.shuffle_id, self.epoch, p,
                int(self.published_unix * 1e6), len(self.entries),
            ],
            dtype=np.int64,
        )
        rows = np.zeros((len(self.entries), meta + p), dtype=np.int64)
        for i, (map_index, status) in enumerate(self.entries):
            rows[i, 0] = status.map_id
            rows[i, 1] = map_index
            rows[i, 2] = status.composite_group
            rows[i, 3] = status.base_offset
            rows[i, 4] = status.parity_segments
            sizes = np.asarray(status.sizes, dtype=np.int64)
            if len(sizes) < p:
                raise ValueError(
                    f"MapStatus for map {status.map_id} has {len(sizes)} "
                    f"sizes, shuffle has {p} partitions"
                )
            rows[i, meta:] = sizes[:p]
        return (
            np.ascontiguousarray(header, dtype=">i8").tobytes()
            + np.ascontiguousarray(rows, dtype=">i8").tobytes()
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "MapOutputSnapshot":
        if len(data) % 8 != 0 or len(data) < 7 * 8:
            raise ValueError(f"snapshot blob has invalid length {len(data)}")
        words = np.frombuffer(data, dtype=">i8").astype(np.int64)
        magic, version, shuffle_id, epoch, p, published_us, n = (
            int(w) for w in words[:7]
        )
        if magic != _MAGIC:
            raise ValueError("snapshot blob has wrong magic")
        if version == 1:
            meta = _ROW_META_V1  # pre-composite rows
        elif version == 2:
            meta = _ROW_META_V2  # pre-coding rows
        elif version == _VERSION:
            meta = _ROW_META_V3
        else:
            raise ValueError(f"snapshot format version {version} != {_VERSION}")
        expect = 7 + n * (meta + p)
        if len(words) != expect:
            raise ValueError(
                f"snapshot blob has {len(words)} words, expected {expect}"
            )
        rows = words[7:].reshape(n, meta + p) if n else words[7:].reshape(0, meta + p)
        entries = [
            (
                int(rows[i, 1]),
                MapStatus(
                    map_id=int(rows[i, 0]),
                    location=STORE_LOCATION,
                    sizes=np.array(rows[i, meta:], dtype=np.int64),
                    map_index=int(rows[i, 1]),
                    composite_group=int(rows[i, 2]) if meta >= 4 else -1,
                    base_offset=int(rows[i, 3]) if meta >= 4 else 0,
                    parity_segments=int(rows[i, 4]) if meta >= 5 else 0,
                ),
            )
            for i in range(n)
        ]
        return cls(shuffle_id, epoch, p, entries, published_unix=published_us / 1e6)


def build_snapshot(tracker, shuffle_id: int) -> MapOutputSnapshot:
    """Freeze one shuffle's current tracker state into a snapshot. Works
    over any tracker exposing ``deduped_statuses`` / ``num_partitions`` /
    ``epoch`` (the in-process plain and sharded trackers)."""
    # read the epoch BEFORE the table: a registration racing this build can
    # only make the stamped epoch conservative (older), never claim state
    # the entries don't contain
    epoch = tracker.epoch(shuffle_id)
    entries = tracker.deduped_statuses(shuffle_id)
    return MapOutputSnapshot(
        shuffle_id, epoch, tracker.num_partitions(shuffle_id), entries
    )


def publish_snapshot(tracker, dispatcher, shuffle_id: int) -> Optional[int]:
    """Freeze the coordinator-side tracker's table for one SEALED shuffle
    and write it through ``dispatcher`` as its ``ShuffleSnapshotBlockId``
    object, the snapshot workers pull once instead of asking the tracker
    per scan (the JAX package's ``cluster.publish_snapshot``, which takes
    the config and looks its dispatcher up with ``Dispatcher.get``, as the
    port's ``cluster.publish_snapshot`` does over this function; here the
    caller passes the dispatcher). Returns the stamped epoch,
    the value to advertise to reduce tasks, or None when
    ``dispatcher.config.metadata_snapshots`` is off or publication failed
    (lookups then stay live RPCs)."""
    if not dispatcher.config.metadata_snapshots:
        return None
    from s3shuffle_tpu_torch.block_ids import ShuffleSnapshotBlockId

    try:
        snap = build_snapshot(tracker, shuffle_id)
        path = dispatcher.get_path(ShuffleSnapshotBlockId(shuffle_id, snap.epoch))
        with dispatcher.backend.create(path) as sink:
            sink.write(snap.to_bytes())
        logger.info(
            "published map-output snapshot for shuffle %d at epoch %d (%d entries)",
            shuffle_id, snap.epoch, len(snap.entries),
        )
        return snap.epoch
    except Exception:
        logger.warning(
            "snapshot publication for shuffle %d failed; reduce scans fall back to "
            "live tracker RPCs", shuffle_id, exc_info=True,
        )
        return None


def _count(source: str) -> None:
    if _metrics.enabled():
        _C_LOOKUP_SOURCE.labels(source=source).inc()


class SnapshotBackedTracker:
    """Tracker facade: snapshot-served lookups, RPC fallthrough.

    Wraps any :class:`MapOutputTrackerLike` (typically the worker's
    :class:`~s3shuffle_tpu_torch.metadata.service.RemoteMapOutputTracker`). Per
    shuffle, an attached snapshot serves every enumeration lookup locally;
    shuffles without one behave exactly as before. Thread-safe: attachment
    map under one small lock, snapshots themselves immutable.
    """

    #: attachment bound: a long-lived worker cycling through shuffles keeps
    #: at most this many sealed tables resident (oldest-attached evicted —
    #: an evicted shuffle's lookups just fall back to live RPCs)
    MAX_ATTACHED = 64

    def __init__(self, inner, loader: Optional[Callable[[int, int], Optional[bytes]]] = None):
        self._inner = inner
        #: optional ``loader(shuffle_id, epoch) -> bytes|None`` — the storage
        #: plane pull (one GET); failures fall through to RPC
        self._loader = loader
        self._lock = threading.Lock()
        self._snapshots: Dict[int, MapOutputSnapshot] = {}

    # -- attachment ----------------------------------------------------
    def attach(self, snapshot: MapOutputSnapshot) -> None:
        with self._lock:
            self._snapshots.pop(snapshot.shuffle_id, None)
            while len(self._snapshots) >= self.MAX_ATTACHED:
                self._snapshots.pop(next(iter(self._snapshots)))
            self._snapshots[snapshot.shuffle_id] = snapshot

    def detach(self, shuffle_id: int) -> None:
        with self._lock:
            self._snapshots.pop(shuffle_id, None)

    def attached_epoch(self, shuffle_id: int) -> Optional[int]:
        snap = self._get(shuffle_id)
        return None if snap is None else snap.epoch

    def ensure(self, shuffle_id: int, epoch: int) -> bool:
        """Make a snapshot at exactly ``epoch`` available for ``shuffle_id``
        (the driver's advertisement). Already attached at that epoch → True;
        else pull through the loader (one storage GET) and attach. False ⇒
        lookups for this shuffle stay on the RPC path.

        An attachment at a DIFFERENT epoch is dropped up front: the table is
        stale by the contract, and it must not keep serving while (or after)
        the pull of the right epoch fails."""
        snap = self._get(shuffle_id)
        if snap is not None:
            if snap.epoch == int(epoch):
                return True
            self.detach(shuffle_id)
        if self._loader is None:
            return False
        data = self._loader(shuffle_id, int(epoch))
        if data is None:
            return False
        snap = MapOutputSnapshot.from_bytes(data)
        if snap.shuffle_id != shuffle_id or snap.epoch != int(epoch):
            return False
        self.attach(snap)
        return True

    def _get(self, shuffle_id: int) -> Optional[MapOutputSnapshot]:
        with self._lock:
            return self._snapshots.get(shuffle_id)

    def _serve(self, shuffle_id: int) -> Optional[MapOutputSnapshot]:
        snap = self._get(shuffle_id)
        if snap is None:
            _count("rpc")
            return None
        _count("snapshot")
        if _metrics.enabled():
            _G_SNAPSHOT_AGE.set(max(0.0, time.time() - snap.published_unix))
        return snap

    # -- lookups (snapshot-first) --------------------------------------
    def get_map_sizes_by_range(
        self, shuffle_id, start_map_index, end_map_index,
        start_partition, end_partition,
    ):
        snap = self._serve(shuffle_id)
        if snap is not None:
            return snap.get_map_sizes_by_range(
                start_map_index, end_map_index, start_partition, end_partition
            )
        return self._inner.get_map_sizes_by_range(
            shuffle_id, start_map_index, end_map_index,
            start_partition, end_partition,
        )

    def get_map_sizes_by_ranges(
        self, shuffle_id, start_map_index, end_map_index, partition_ranges
    ):
        snap = self._serve(shuffle_id)
        if snap is not None:
            return snap.get_map_sizes_by_ranges(
                start_map_index, end_map_index, partition_ranges
            )
        return self._inner.get_map_sizes_by_ranges(
            shuffle_id, start_map_index, end_map_index, partition_ranges
        )

    def num_partitions(self, shuffle_id: int) -> int:
        snap = self._serve(shuffle_id)
        if snap is not None:
            return snap.num_partitions()
        return self._inner.num_partitions(shuffle_id)

    def contains(self, shuffle_id: int) -> bool:
        snap = self._get(shuffle_id)
        if snap is not None:
            _count("snapshot")
            return True
        _count("rpc")
        return self._inner.contains(shuffle_id)

    def registered_map_ids(self, shuffle_id: int) -> List[int]:
        snap = self._serve(shuffle_id)
        if snap is not None:
            return snap.registered_map_ids()
        return self._inner.registered_map_ids(shuffle_id)

    def composite_locations(self, shuffle_id: int) -> List[tuple]:
        snap = self._serve(shuffle_id)
        if snap is not None:
            return snap.composite_locations()
        return self._inner.composite_locations(shuffle_id)

    # -- mutations (invalidate, then delegate) -------------------------
    def register_shuffle(self, shuffle_id: int, num_partitions: int) -> None:
        snap = self._get(shuffle_id)
        if snap is not None and snap.num_partitions() == int(num_partitions):
            # idempotent re-registration of a sealed shuffle (every reduce
            # task re-registers its dependency): the snapshot already proves
            # the coordinator knows this shuffle — no round-trip needed
            return
        self._inner.register_shuffle(shuffle_id, num_partitions)

    def register_map_output(self, shuffle_id: int, status) -> None:
        # a post-seal registration would make the attached snapshot stale:
        # drop it so subsequent lookups re-ask (the staleness contract)
        self.detach(shuffle_id)
        self._inner.register_map_output(shuffle_id, status)

    def register_map_outputs(self, shuffle_id: int, statuses) -> None:
        self.detach(shuffle_id)
        self._inner.register_map_outputs(shuffle_id, statuses)

    def unregister_shuffle(self, shuffle_id: int) -> None:
        self.detach(shuffle_id)
        self._inner.unregister_shuffle(shuffle_id)

    def shuffle_ids(self) -> List[int]:
        return self._inner.shuffle_ids()

    # -- passthrough (stats / misc) ------------------------------------
    def __getattr__(self, name: str):
        # anything not snapshot-aware (report_task_stats, queue ops, close,
        # ping, ...) rides the wrapped tracker unchanged
        return getattr(self._inner, name)
