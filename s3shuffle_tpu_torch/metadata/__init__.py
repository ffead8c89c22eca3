"""Shuffle metadata of the port: the index and checksum sidecars (the
helper), the map-output trackers (in-process, sharded, remote, batched and
snapshot-backed) and the metadata service."""

from s3shuffle_tpu_torch.metadata.helper import ShuffleHelper
from s3shuffle_tpu_torch.metadata.shard import ShardedMapOutputTracker
from s3shuffle_tpu_torch.metadata.snapshot import (
    MapOutputSnapshot,
    SnapshotBackedTracker,
    build_snapshot,
)

__all__ = [
    "ShuffleHelper",
    "ShardedMapOutputTracker",
    "MapOutputSnapshot",
    "SnapshotBackedTracker",
    "build_snapshot",
]
