"""Top-level shuffle manager (the JAX package's ``manager.py``).

Parity: ``S3ShuffleManager`` (sort/S3ShuffleManager.scala:38-201):

- ``register_shuffle`` chooses among the three handle kinds like Spark's
  SortShuffleManager (:52-71): bypass-merge when the dependency has no
  map-side combine and at most ``bypass_merge_threshold`` partitions;
  serialized ("unsafe") when the serializer is relocatable, there is no
  aggregator and the partition count fits; base sort otherwise. Serialized
  handles with a columnar serializer take :class:`SerializedSortMapWriter`
  (one buffer + a partition-id radix sort at spill); bypass-merge and base
  handles take the buffer-per-partition :class:`ShuffleMapWriter`;
- ``get_writer`` vends a map-task writer whose committed MapStatus always
  points at the object store (S3ShuffleWriter.scala:7-21);
- ``get_reader`` returns the record reader (:73-111), over the manager's
  tracker or one the caller passes;
- ``unregister_shuffle`` purges the dispatcher's FileStatus cache and the
  helper's metadata caches of the shuffle and deletes its objects when
  ``cleanup`` is on (:148-168); ``stop`` unregisters every shuffle and
  removes the app's root (:171-186).

One codec, the one the config names (``codec="tpu"`` by default: the
:class:`~s3shuffle_tpu_torch.codec.cuda.CudaCodec`), serves every writer
and reader of the manager, on ``device`` (the CUDA device unless
``device="cpu"``; no CUDA device raises, whatever the codec): the TLZ
encode launches run kernels K2 and K1, the decode launches K3, the coded
plane K4.

At ``composite_commit_maps > 1`` the manager owns one
:class:`~s3shuffle_tpu_torch.write.composite_commit.CompositeCommitAggregator`:
map outputs go into composite groups, and a group's members are registered
together, with their composite coordinates, when it seals. ``get_reader``
is the commit barrier: it seals the shuffle's open group and waits out
seals in flight on other threads, and it raises if a group of the shuffle
failed to seal after its members' tasks had returned (their outputs are
lost). ``unregister_shuffle`` drops the open group unsealed.

With ``autotune`` on, the manager hands its codec to both of the
dispatcher's tuners, which retune its windows live
(``encode_inflight_batches`` by the commit tuner; ``decode_batch_frames``
and ``decode_inflight_batches`` by the scan tuner), and ``stop`` writes the
tuners' warm-start profile when ``autotune_profile_path`` is set.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, Optional

import numpy as np

from s3shuffle_tpu_torch.codec import codec_from_config
from s3shuffle_tpu_torch.config import ShuffleConfig
from s3shuffle_tpu_torch.dependency import ShuffleDependency
from s3shuffle_tpu_torch.device import resolve_device
from s3shuffle_tpu_torch.metadata.helper import ShuffleHelper
from s3shuffle_tpu_torch.metadata.map_output import (
    STORE_LOCATION,
    MapOutputTracker,
    MapOutputTrackerLike,
    MapStatus,
)
from s3shuffle_tpu_torch.parallel import dispatch as _mesh_dispatch
from s3shuffle_tpu_torch.read.reader import ShuffleReader
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
from s3shuffle_tpu_torch.version import BUILD_INFO
from s3shuffle_tpu_torch.write.composite_commit import CompositeCommitAggregator
from s3shuffle_tpu_torch.write.map_output_writer import MapOutputWriter
from s3shuffle_tpu_torch.write.serialized_writer import SerializedSortMapWriter
from s3shuffle_tpu_torch.write.spill_writer import ShuffleMapWriter

logger = logging.getLogger("s3shuffle_tpu_torch.manager")

# Spark's spark.shuffle.sort.bypassMergeThreshold default
DEFAULT_BYPASS_MERGE_THRESHOLD = 200
# SortShuffleManager.MAX_SHUFFLE_OUTPUT_PARTITIONS_FOR_SERIALIZED_MODE
MAX_PARTITIONS_FOR_SERIALIZED = 1 << 24


class ShuffleHandle:
    kind = "base"

    def __init__(self, shuffle_id: int, dependency: ShuffleDependency):
        self.shuffle_id = shuffle_id
        self.dependency = dependency


class BypassMergeShuffleHandle(ShuffleHandle):
    kind = "bypass-merge"


class SerializedShuffleHandle(ShuffleHandle):
    kind = "serialized"


class BaseShuffleHandle(ShuffleHandle):
    kind = "base"


class ShuffleManager:
    def __init__(
        self,
        config: Optional[ShuffleConfig] = None,
        dispatcher: Optional[Dispatcher] = None,
        bypass_merge_threshold: int = DEFAULT_BYPASS_MERGE_THRESHOLD,
        tracker: Optional[MapOutputTrackerLike] = None,
        device=None,
    ):
        logger.info("%s", BUILD_INFO)
        # the process's dispatcher for this config (Dispatcher.get)
        self.dispatcher = dispatcher or Dispatcher.get(config)
        self.helper = ShuffleHelper(self.dispatcher)
        # the tracker may be a metadata service's client (RemoteMapOutputTracker,
        # AsyncTrackerClient) or a snapshot-backed facade: the same interface
        self.tracker = tracker or MapOutputTracker()
        self.bypass_merge_threshold = bypass_merge_threshold
        self._registered: Dict[int, ShuffleHandle] = {}
        self._lock = threading.Lock()
        self.device = resolve_device(device)
        self.codec = codec_from_config(self.dispatcher.config, self.device)
        # the multi-GPU plane: arm the batch dispatcher at the configured
        # width; 0 or 1 (the default) keeps the single-device op pattern
        _mesh_dispatch.configure(self.dispatcher.config.mesh_devices)
        # autotune: the tuners retune the codec's windows, which its streams
        # read live at every batch; no tuner exists with autotune off
        if self.dispatcher.commit_tuner is not None:
            self.dispatcher.commit_tuner.bind_codec(self.codec)
        if self.dispatcher.scan_tuner is not None:
            self.dispatcher.scan_tuner.bind_codec(self.codec)
        # the composite commit plane: one aggregator of this manager's map
        # commits, registering each sealed group in one batched call
        self.composite: Optional[CompositeCommitAggregator] = None
        self._failed_composite: Dict[int, Exception] = {}
        if self.dispatcher.config.composite_commit_maps > 1:
            self.composite = CompositeCommitAggregator(
                self.dispatcher, self.helper,
                on_group_commit=self._register_group,
                on_group_abort=self._abort_group,
                device=self.device,
            )
        # the protocol witness (utils/protowitness.py), last: with
        # S3SHUFFLE_PROTOCOL_WITNESS set it wraps this manager's backend
        # (above the retry and instrumented layers) and tracker to check the
        # commit order and the seal barrier as they run; None when unset
        from s3shuffle_tpu_torch.utils import protowitness

        self.protocol_witness = protowitness.maybe_install(self)

    @property
    def config(self) -> ShuffleConfig:
        return self.dispatcher.config

    def register_shuffle(self, shuffle_id: int, dependency: ShuffleDependency) -> ShuffleHandle:
        """Handle choice parity with SortShuffleManager (scala :52-71)."""
        dep = dependency
        if not dep.map_side_combine and dep.num_partitions <= self.bypass_merge_threshold:
            handle: ShuffleHandle = BypassMergeShuffleHandle(shuffle_id, dep)
        elif (
            dep.serializer.relocatable
            and dep.aggregator is None
            and dep.num_partitions < MAX_PARTITIONS_FOR_SERIALIZED
        ):
            handle = SerializedShuffleHandle(shuffle_id, dep)
        else:
            handle = BaseShuffleHandle(shuffle_id, dep)
        with self._lock:
            self._registered[shuffle_id] = handle
        self.tracker.register_shuffle(shuffle_id, dep.num_partitions)
        logger.info("Registered shuffle %d with %s handle", shuffle_id, handle.kind)
        return handle

    def handle(self, shuffle_id: int) -> ShuffleHandle:
        """The handle a registered shuffle was given."""
        with self._lock:
            return self._registered[shuffle_id]

    def get_writer(self, handle: ShuffleHandle, map_id: int, map_index: Optional[int] = None):
        """``map_id`` names the store objects; ``map_index`` is the logical
        map partition index range reads filter on (defaults to map_id)."""
        output_writer = MapOutputWriter(
            self.dispatcher, self.helper, handle.shuffle_id, map_id,
            handle.dependency.num_partitions, codec=self.codec, device=self.device,
            map_index=map_index, aggregator=self.composite,
        )
        cls = ShuffleMapWriter
        if handle.kind == "serialized" and handle.dependency.serializer.supports_batches:
            cls = SerializedSortMapWriter
        return cls(
            handle=handle,
            map_id=map_id,
            output_writer=output_writer,
            codec=self.codec,
            on_commit=self._commit_map_output,
            map_index=map_index,
        )

    def _commit_map_output(self, shuffle_id: int, map_id: int, lengths: np.ndarray,
                           map_index: int, message) -> None:
        # MapStatus location rebranding (S3ShuffleWriter.scala:10-18): the
        # output's address is the store, never a worker
        if message.deferred:
            # a composite member: its group's seal registers it
            # (_register_group), the fat index being the commit point
            return
        self.tracker.register_map_output(
            shuffle_id,
            MapStatus(
                map_id=map_id, location=STORE_LOCATION, sizes=lengths,
                map_index=map_index, parity_segments=message.parity_segments,
            ),
        )

    def _register_group(self, shuffle_id: int, members) -> None:
        """A sealed composite group: one batched registration of every
        member with its coordinates, and the helper's hints, so this
        process's reads resolve the members without per-map lookups."""
        self.tracker.register_map_outputs(
            shuffle_id,
            [
                MapStatus(
                    map_id=m.map_id, location=STORE_LOCATION, sizes=m.lengths,
                    map_index=m.map_index, composite_group=m.group_id,
                    base_offset=m.base_offset, parity_segments=m.parity_segments,
                )
                for m in members
            ],
        )
        for m in members:
            self.helper.note_composite_location(shuffle_id, m.map_id, m.group_id, m.base_offset)

    def _abort_group(self, shuffle_id: int, members, error: Exception) -> None:
        """A composite group failed to seal after its members' tasks had
        returned (registration waits for the seal): the shuffle is poisoned,
        so the next read barrier raises instead of serving output without
        those maps."""
        with self._lock:
            self._failed_composite[shuffle_id] = error
        logger.error(
            "composite group seal failed for shuffle %d: %d committed map "
            "output(s) lost (%s); reads of this shuffle will now fail",
            shuffle_id, len(members), error,
        )

    def get_reader(
        self,
        handle: ShuffleHandle,
        start_partition: int,
        end_partition: int,
        start_map_index: int = 0,
        end_map_index: Optional[int] = None,
        tracker: Optional[MapOutputTrackerLike] = None,
    ) -> ShuffleReader:
        """Parity: getReader / getReaderForRange (scala :73-111). With the
        composite plane on, first the commit barrier (see the module
        docstring). ``tracker`` stands in for the manager's tracker in this
        one reader: a worker passes its snapshot-backed tracker, so a sealed
        shuffle's scan looks its blocks up with no tracker RPC."""
        if self.composite is not None:
            self.composite.flush_shuffle(handle.shuffle_id)
            with self._lock:
                exc = self._failed_composite.get(handle.shuffle_id)
            if exc is not None:
                raise RuntimeError(
                    f"shuffle {handle.shuffle_id} lost composite-committed "
                    "map outputs to a failed group seal; re-run the map stage"
                ) from exc
        return ShuffleReader(
            self.dispatcher, self.helper,
            tracker if tracker is not None else self.tracker, handle.dependency,
            start_partition, end_partition, start_map_index, end_map_index,
            codec=self.codec, device=self.device,
        )

    def purge_caches(self, shuffle_id: int) -> None:
        """Parity: purgeCaches (scala :148-153): the dispatcher's cached
        FileStatus entries and the helper's cached index and checksum
        arrays of the shuffle."""
        self.dispatcher.close_cached_blocks(shuffle_id)
        self.helper.purge_cached_data_for_shuffle(shuffle_id)

    def unregister_shuffle(self, shuffle_id: int) -> None:
        """Parity: unregisterShuffle (scala :156-168)."""
        with self._lock:
            self._registered.pop(shuffle_id, None)
        if self.composite is not None:
            # an open group's members can never be read now: drop it unsealed
            self.composite.abort_shuffle(shuffle_id)
            with self._lock:
                self._failed_composite.pop(shuffle_id, None)
        self.tracker.unregister_shuffle(shuffle_id)
        self.purge_caches(shuffle_id)
        if self.config.cleanup:
            self.dispatcher.remove_shuffle(shuffle_id)

    def stop(self) -> None:
        """Parity: stop (scala :171-186)."""
        with self._lock:
            remaining = list(self._registered)
        for shuffle_id in remaining:
            self.unregister_shuffle(shuffle_id)
        # the learned rung tables, for the next process's warm start
        self.dispatcher.save_tuner_profile()
        if self.config.cleanup:
            self.dispatcher.remove_root()
