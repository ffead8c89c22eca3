"""Composite map commits: write-side PUT coalescing (the JAX package's
``write/composite_commit.py``).

The per-map layout PUTs one data, one index and (with checksums) one
checksum object per map task, so a swarm of tiny maps pays the store's
per-request cost, not its bandwidth. This module composes many map
outputs into

- ONE composite data object (members appended back to back in commit
  order, streamed through the measured, pipelined-upload sink a per-map
  commit uses), and
- ONE fat index (metadata/fat_index.py) holding every member's
  ``(map_id, base_offset)``, cumulative partition offsets and checksums.

The fat index is the commit point of the whole group: data object first
(then its parity sidecars when the coded plane is on, encoded over the
group's stored bytes with kernel K4 as the members are appended), fat
index last, each sidecar PUT re-driven whole through ``retry_call``. A
crash before the fat index lands leaves an uncommitted composite no reader
can see, which the orphan sweep reclaims. The fat index is written as v3
when a skew prong engaged: a member shipped map-side-combined partials
(its flag), or a member partition crossed ``split_threshold_bytes`` (the
stripe in the header, :meth:`CompositeCommitAggregator._split_bytes_for`).

Groups seal at three thresholds: member count (``composite_commit_maps``),
data bytes (``composite_flush_bytes``) and age (``composite_flush_ms``,
checked on every aggregator touch: a commit or a barrier flush).
``composite_commit_maps`` 0 or 1 turns the plane off, and the writer keeps
the one-object-per-map layout op for op.

Registration is group-granular: members become visible to the tracker only
when their group seals (``on_group_commit``). A group that fails to seal
calls ``on_group_abort``, so a half-written group is never half visible.
A barrier flush (:meth:`CompositeCommitAggregator.flush_shuffle`) waits out
every seal of the shuffle that another thread has in flight, so a reader
built after it sees every member committed before it.
"""

from __future__ import annotations

import dataclasses
import io
import logging
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from s3shuffle_tpu_torch.block_ids import ShuffleCompositeDataBlockId
from s3shuffle_tpu_torch.coding.parity import (
    accumulator_from_config,
    delete_parity_objects,
    put_parity_objects,
)
from s3shuffle_tpu_torch.metadata.fat_index import FatIndex, FatIndexMember
from s3shuffle_tpu_torch.metadata.helper import ShuffleHelper
from s3shuffle_tpu_torch.metrics import registry as _metrics
from s3shuffle_tpu_torch.skew import C_PARTITION_SPLITS
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
from s3shuffle_tpu_torch.storage.retrying import retry_call
from s3shuffle_tpu_torch.write.measure import MeasuredOutputStream
from s3shuffle_tpu_torch.write.pipelined_upload import PipelinedUploadStream

logger = logging.getLogger("s3shuffle_tpu_torch.write")


@dataclasses.dataclass
class CompositeMember:
    """One map output committed into a composite group."""

    shuffle_id: int
    map_id: int
    map_index: int
    group_id: int
    base_offset: int
    lengths: np.ndarray
    checksums: Optional[np.ndarray]
    total_bytes: int
    #: parity sidecars of the composite object this member landed in,
    #: assigned at the group's seal (0 until then, and when uncoded)
    parity_segments: int = 0
    #: the member's partitions carry map-side-combined partial rows
    combined: bool = False

    def offsets(self) -> np.ndarray:
        """Member-relative cumulative offsets (the fat-index row)."""
        out = np.zeros(len(self.lengths) + 1, dtype=np.int64)
        np.cumsum(np.asarray(self.lengths, dtype=np.int64), out=out[1:])
        return out


class _OpenGroup:
    def __init__(self, shuffle_id: int, group_id: int, num_partitions: int):
        self.shuffle_id = shuffle_id
        self.group_id = group_id
        self.num_partitions = num_partitions
        self.data_block = ShuffleCompositeDataBlockId(shuffle_id, group_id)
        self.members: List[CompositeMember] = []
        self.bytes = 0
        self.opened_monotonic = time.monotonic()
        self.sink = None  # created on the first non-empty append
        #: the coded plane's streaming tee over the composite payload
        #: (created with the sink when parity_segments > 0)
        self.parity = None
        self.parity_blocks: List = []  # parity ids PUT (teardown deletes)
        #: serializes appends to THIS group's one sequential stream
        self.lock = threading.Lock()
        #: set under ``lock`` when the group leaves the open registry for
        #: sealing or teardown; never unset. An appender that loses the
        #: race opens a fresh group instead of writing into a sealed stream.
        self.detached = False


class CompositeCommitAggregator:
    """Composes map commits into composite groups and seals them at the
    count, byte, age and barrier thresholds.

    Thread-safe: task threads may commit at once. The registry lock only
    guards the shuffle → open group table; appends serialize on the
    group's own lock (they target one sequential store object), so commits
    of different shuffles never wait for each other's store I/O. Sealing and
    the callbacks run outside every lock, on a group detached first.
    ``device`` is where the group parity is encoded (K4 on the CUDA
    device)."""

    def __init__(
        self,
        dispatcher: Dispatcher,
        helper: ShuffleHelper,
        on_group_commit: Optional[Callable[[int, List[CompositeMember]], None]] = None,
        on_group_abort: Optional[Callable[[int, List[CompositeMember], Exception], None]] = None,
        device=None,
    ):
        self.dispatcher = dispatcher
        self.helper = helper
        self.on_group_commit = on_group_commit
        self.on_group_abort = on_group_abort
        self.device = device
        cfg = dispatcher.config
        self.max_members = int(cfg.composite_commit_maps)
        self.flush_bytes = int(cfg.composite_flush_bytes)
        self.flush_ms = float(cfg.composite_flush_ms)
        self._lock = threading.Lock()
        self._groups: Dict[int, _OpenGroup] = {}
        # In-flight seals per shuffle: between a group's detach and the end
        # of its registration callback the group is in no registry while its
        # members are not yet visible. A barrier flush waits for the count
        # to drain, so a reader built next cannot scan past those members.
        self._seal_cv = threading.Condition()
        self._sealing: Dict[int, int] = {}

    @property
    def enabled(self) -> bool:
        return self.max_members > 1

    # --- in-flight seal accounting (the group-visibility barrier) ---
    def _note_seal_begin(self, shuffle_id: int) -> None:
        """Called atomically with the detach or pop that claims a group, so
        no barrier flush can slip between the claim and the count."""
        with self._seal_cv:
            self._sealing[shuffle_id] = self._sealing.get(shuffle_id, 0) + 1

    def _note_seal_end(self, shuffle_id: int) -> None:
        with self._seal_cv:
            left = self._sealing.get(shuffle_id, 1) - 1
            if left <= 0:
                self._sealing.pop(shuffle_id, None)
            else:
                self._sealing[shuffle_id] = left
            self._seal_cv.notify_all()

    def _await_seals(self, shuffle_id: Optional[int]) -> None:
        """Block until no seal of ``shuffle_id`` (None: of any shuffle) is in
        flight: every group claimed before has then registered its members
        or failed them through ``on_group_abort``."""

        def pending() -> bool:
            if shuffle_id is None:
                return bool(self._sealing)
            return self._sealing.get(shuffle_id, 0) > 0

        with self._seal_cv:
            while pending():
                # a seal's end always notifies; the timeout only backs up a
                # missed notify
                self._seal_cv.wait(timeout=2.0)

    # --- appends ---
    def _make_sink(self, group: _OpenGroup):
        cfg = self.dispatcher.config
        measured = MeasuredOutputStream(
            self.dispatcher.create_block(group.data_block), group.data_block.name
        )
        if cfg.upload_queue_bytes > 0:
            return PipelinedUploadStream(measured, cfg.upload_queue_bytes,
                                         label=group.data_block.name)
        return measured

    def _append_under_group_lock(self, group: _OpenGroup, payload, total_bytes: int) -> None:
        if total_bytes <= 0:
            return
        if group.sink is None:
            group.sink = self._make_sink(group)
            # the composite object is the unit of loss: one parity tee per
            # object, encoded as the appends flow, emitted at the seal
            group.parity = accumulator_from_config(self.dispatcher.config, self.device)
        buffer_size = self.dispatcher.config.buffer_size
        copied = 0
        while True:
            chunk = payload.read(buffer_size)
            if not chunk:
                break
            group.sink.write(chunk)
            if group.parity is not None:
                group.parity.update(chunk)
            copied += len(chunk)
        if copied != total_bytes:
            raise IOError(
                f"composite append for shuffle {group.shuffle_id} delivered "
                f"{copied} of {total_bytes} payload bytes"
            )
        group.bytes += total_bytes

    def commit_map(
        self,
        shuffle_id: int,
        map_id: int,
        map_index: int,
        num_partitions: int,
        lengths: np.ndarray,
        checksums: Optional[np.ndarray],
        payload,
        total_bytes: int,
        combined: bool = False,
    ):
        """Append one map task's fully drained payload to the shuffle's open
        group (opening one as needed) and return its ``(group_id,
        base_offset)``; ``combined`` flags map-side-combined partials. A
        failure mid-copy aborts the whole group loudly rather than leave a
        torn composite. Seals the group when the count or byte threshold is
        reached."""
        seal_now = False
        failure = None
        while True:
            with self._lock:
                group = self._groups.get(shuffle_id)
                # ``detached`` never goes back to False, so this unlocked
                # read can only be stale-False; the re-check below catches it
                if group is None or group.detached:
                    group = _OpenGroup(shuffle_id, int(map_id), int(num_partitions))
                    self._groups[shuffle_id] = group
            with group.lock:
                if group.detached:
                    continue  # lost a race with a seal: open a fresh group
                if group.num_partitions != int(num_partitions):
                    raise ValueError(
                        f"composite group for shuffle {shuffle_id} has "
                        f"{group.num_partitions} partitions, map {map_id} has "
                        f"{num_partitions}"
                    )
                base = group.bytes
                try:
                    self._append_under_group_lock(group, payload, int(total_bytes))
                except Exception as e:
                    # detach the torn group; its teardown and the abort
                    # callback run outside the locks, inside the barrier
                    group.detached = True
                    self._note_seal_begin(shuffle_id)
                    doomed = list(group.members)
                    group.members = []
                    failure = (group, doomed, e)
                    break
                member = CompositeMember(
                    shuffle_id=int(shuffle_id),
                    map_id=int(map_id),
                    map_index=int(map_index),
                    group_id=group.group_id,
                    base_offset=base,
                    lengths=np.asarray(lengths, dtype=np.int64),
                    checksums=None if checksums is None else np.asarray(checksums, dtype=np.int64),
                    total_bytes=int(total_bytes),
                    combined=bool(combined),
                )
                group.members.append(member)
                if len(group.members) >= self.max_members or group.bytes >= self.flush_bytes:
                    group.detached = True
                    self._note_seal_begin(shuffle_id)  # atomic with the detach
                    seal_now = True
            break
        self._discard_from_registry(shuffle_id, group)
        if failure is not None:
            failed_group, doomed, exc = failure
            try:
                self._drop_failed_group(failed_group)
                # the earlier members' bytes went with the dropped object
                if doomed and self.on_group_abort is not None:
                    self.on_group_abort(shuffle_id, doomed, exc)
            finally:
                self._note_seal_end(shuffle_id)
            raise exc
        if seal_now:
            try:
                self._finish(group)
            finally:
                self._note_seal_end(shuffle_id)
        # age-based sealing rides every touch; a stale group's seal failure
        # has failed its own members already and must not fail this commit
        try:
            self.maybe_flush_stale()
        except Exception:
            logger.exception("age-based composite flush failed")
        return member.group_id, member.base_offset

    def _discard_from_registry(self, shuffle_id: int, group: _OpenGroup) -> None:
        """Remove a DETACHED group from the registry (no-op while it is open
        or once a fresh group replaced it)."""
        if not group.detached:
            return
        with self._lock:
            if self._groups.get(shuffle_id) is group:
                self._groups.pop(shuffle_id)

    def _detach(self, group: _OpenGroup) -> bool:
        """Claim a group for sealing or teardown once any in-flight append
        ends, opening its seal window (a True return must be paired with
        ``_note_seal_end``). False: another thread claimed it."""
        with group.lock:
            if group.detached:
                return False
            group.detached = True
            self._note_seal_begin(group.shuffle_id)
            return True

    def _drop_failed_group(self, group: _OpenGroup) -> None:
        """Best-effort teardown of a torn group's store objects, outside
        every lock (the group is detached already)."""
        if group.sink is not None:
            try:
                group.sink.close()
            except Exception:
                logger.debug("close of failed composite sink %s failed",
                              group.data_block.name, exc_info=True)
        try:
            self.dispatcher.backend.delete(self.dispatcher.get_path(group.data_block))
        except Exception:
            logger.debug("delete of failed composite %s failed", group.data_block.name,
                         exc_info=True)
        delete_parity_objects(self.dispatcher, group.parity_blocks)

    # --- sealing ---
    def _split_bytes_for(self, group: _OpenGroup) -> int:
        """The seal-time half of the hot-partition split: the members'
        partition sizes are measured, so a group holding a partition past
        ``split_threshold_bytes`` records the threshold as its stripe in the
        fat index v3 header. 0 (v2, unless a member is combined) when the
        knob is off or nothing crossed."""
        threshold = self.dispatcher.config.split_threshold_bytes
        if threshold <= 0:
            return 0
        crossed = sum(int((m.lengths > threshold).sum()) for m in group.members)
        if not crossed:
            return 0
        if _metrics.enabled():
            C_PARTITION_SPLITS.inc(crossed)
        return int(threshold)

    def _finish(self, group: _OpenGroup) -> None:
        """Seal one detached group: the final data flush, the parity
        sidecars, then the fat index (the commit point), then the
        registration callback."""
        try:
            if group.sink is not None:
                if group.sink.bytes_written != group.bytes:
                    raise IOError(
                        f"composite stream position {group.sink.bytes_written} "
                        f"does not match appended bytes {group.bytes}"
                    )
                group.sink.close()  # the final flush; a pipelined close blocks
            geometry = None
            if group.parity is not None and group.bytes > 0:
                payloads = group.parity.finish()
                geometry = group.parity.geometry
                group.parity_blocks = put_parity_objects(
                    self.dispatcher, group.data_block, geometry, payloads
                )
                for m in group.members:
                    m.parity_segments = geometry.segments
            fat = FatIndex(
                group.shuffle_id,
                group.group_id,
                group.num_partitions,
                [
                    FatIndexMember(
                        map_id=m.map_id,
                        map_index=m.map_index,
                        base_offset=m.base_offset,
                        offsets=m.offsets(),
                        checksums=m.checksums,
                        combined=m.combined,
                    )
                    for m in group.members
                ],
                parity=geometry,
                split_bytes=self._split_bytes_for(group),
            )
            # a small PUT an overwrite makes idempotent, re-driven whole; it
            # stays the group's last write
            retry_call(
                lambda: self.helper.write_fat_index(fat),
                self.dispatcher.retry_policy,
                op="commit_fat_index",
                scheme=self.dispatcher.backend.scheme,
            )
        except Exception as e:
            self._drop_failed_group(group)
            if self.on_group_abort is not None:
                self.on_group_abort(group.shuffle_id, list(group.members), e)
            raise
        logger.info("Sealed composite group %s: %d map outputs, %d bytes",
                    group.data_block.name, len(group.members), group.bytes)
        if self.on_group_commit is not None:
            self.on_group_commit(group.shuffle_id, list(group.members))

    def pending_members(self, shuffle_id: int) -> List[CompositeMember]:
        """Members sitting in the (unsealed) open group of one shuffle."""
        with self._lock:
            group = self._groups.get(shuffle_id)
            return list(group.members) if group is not None else []

    def _finish_each(self, groups: List[_OpenGroup]) -> int:
        """Seal several detached groups, each one attempted whatever another
        one's seal did (a failed seal has failed its own members through
        ``on_group_abort``); the first failure is raised after all were
        attempted. Returns the number sealed."""
        sealed = 0
        first_exc: Optional[Exception] = None
        for group in groups:
            if not self._detach(group):
                continue  # a commit's seal claimed it first
            try:
                self._finish(group)
                sealed += 1
            except Exception as e:
                if first_exc is None:
                    first_exc = e
            finally:
                self._note_seal_end(group.shuffle_id)
        if first_exc is not None:
            raise first_exc
        return sealed

    def flush_shuffle(self, shuffle_id: int) -> None:
        """Commit-barrier flush: seal this shuffle's open group now, then
        wait out any seal another thread has in flight. When this returns,
        every member committed before it is registered (or loudly failed)."""
        with self._lock:
            group = self._groups.pop(shuffle_id, None)
            # the seal window opens under the registry lock, atomically with
            # the pop: _detach below may wait on a slow in-flight append, and
            # a sibling barrier in that gap must see a seal in flight
            if group is not None:
                self._note_seal_begin(shuffle_id)
        try:
            if group is not None:
                self._finish_each([group])
        finally:
            if group is not None:
                self._note_seal_end(shuffle_id)
            self._await_seals(shuffle_id)

    def flush_all(self) -> int:
        """Seal every open group (a barrier of all shuffles, or shutdown).
        Returns the number sealed."""
        with self._lock:
            groups = list(self._groups.values())
            self._groups = {}
            for g in groups:  # the pop → detach gap: see flush_shuffle
                self._note_seal_begin(g.shuffle_id)
        try:
            return self._finish_each(groups)
        finally:
            for g in groups:
                self._note_seal_end(g.shuffle_id)
            self._await_seals(None)

    def drain(self) -> int:
        """Seal every open group on the way out (a departing worker)."""
        return self.flush_all()

    def abort_shuffle(self, shuffle_id: int) -> None:
        """Drop this shuffle's open group without sealing it (shuffle
        teardown: its members will never be read)."""
        with self._lock:
            group = self._groups.pop(shuffle_id, None)
            if group is not None:  # the pop → detach gap: see flush_shuffle
                self._note_seal_begin(shuffle_id)
        try:
            if group is not None and self._detach(group):
                try:
                    self._drop_failed_group(group)
                finally:
                    self._note_seal_end(shuffle_id)
        finally:
            if group is not None:
                self._note_seal_end(shuffle_id)

    def maybe_flush_stale(self, now: Optional[float] = None) -> int:
        """Age-based sealing, checked on every aggregator touch (no
        background thread). Returns the groups sealed."""
        if self.flush_ms <= 0:
            return 0
        now = time.monotonic() if now is None else now
        doomed: List[_OpenGroup] = []
        with self._lock:
            for sid, group in list(self._groups.items()):
                if (now - group.opened_monotonic) * 1000.0 >= self.flush_ms:
                    doomed.append(self._groups.pop(sid))
                    self._note_seal_begin(sid)  # the pop → detach gap
        try:
            return self._finish_each(doomed)
        finally:
            for g in doomed:
                self._note_seal_end(g.shuffle_id)

    def close(self) -> None:
        self.flush_all()


class SpooledCommitPayload(io.RawIOBase):
    """The composite-mode map commit's sink: the partitions' stored bytes
    land here (in memory up to ``composite_spool_bytes``, in a local temp
    file beyond), and the fully drained payload is handed to the aggregator
    at commit. It has the ``bytes_written`` and flush-all ``close()``
    surface ``MapOutputWriter`` expects of its stream."""

    def __init__(self, spool_bytes: int):
        self._file = tempfile.SpooledTemporaryFile(
            max_size=max(1, int(spool_bytes)), prefix="s3shuffle-composite-"
        )
        self.bytes_written = 0

    def writable(self) -> bool:
        return True

    def write(self, b) -> int:
        n = b.nbytes if isinstance(b, memoryview) else len(b)
        if n:
            self._file.write(b)
            self.bytes_written += n
        return n

    def open_for_read(self):
        """Rewind and expose the drained payload for the aggregator's copy."""
        self._file.seek(0)
        return self._file

    def close(self) -> None:
        if not self.closed:
            self._file.close()
        super().close()
