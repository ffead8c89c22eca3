"""The shuffle worker agent: the fleet's executor (the JAX package's
``worker.py``).

The reference's executors are Spark JVMs that share nothing with the
driver but the object store and its RPC endpoint (SURVEY.md §3.2/§3.3). A
:class:`WorkerAgent` is that executor here. Started on any host with
``python -m s3shuffle_tpu_torch.worker --coordinator HOST:PORT``, it pulls
tasks from the coordinator's task queue (``metadata/service.py``), runs them
against the shared store on its device (the CUDA device unless
``--device cpu``: map tasks launch K2 and K1, reduce tasks K3, coded writes
K4) and reports completion. A task is a JSON descriptor of a registered
kind (``"map"``, ``"reduce"``): the control plane carries no code, and
records move through the store (the driver writes input objects, reducers
write output objects).

A shuffle dependency travels as a JSON descriptor (a hash or range
partitioner, range bounds in base64, the sort flag and the serializer's
registry name); :func:`dep_from_descriptor` rebuilds it on the worker.
Descriptors, input and output objects are byte for byte the JAX
package's, so a port worker serves a JAX driver and the other way round.
"""

from __future__ import annotations

import argparse
import base64
import dataclasses
import io
import logging
import os
import socket
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

from s3shuffle_tpu_torch.config import ShuffleConfig
from s3shuffle_tpu_torch.dependency import (
    HashPartitioner,
    RangePartitioner,
    ShuffleDependency,
    natural_key,
)
from s3shuffle_tpu_torch.metadata.map_output import STORE_LOCATION
from s3shuffle_tpu_torch.metadata.service import RemoteMapOutputTracker
from s3shuffle_tpu_torch.utils import trace

logger = logging.getLogger("s3shuffle_tpu_torch.worker")


# --- JSON dependency descriptors ---------------------------------------------

def dep_to_descriptor(dep: ShuffleDependency) -> dict:
    p = dep.partitioner
    if isinstance(p, RangePartitioner):
        part = {
            "kind": "range",
            "bounds_b64": [base64.b64encode(b).decode("ascii") for b in p.bounds],
        }
    elif isinstance(p, HashPartitioner):
        part = {"kind": "hash", "num_partitions": p.num_partitions}
    else:
        raise ValueError(f"partitioner {type(p).__name__} has no JSON descriptor")
    from s3shuffle_tpu_torch.serializer import DEFAULT_BATCH_RECORDS, ColumnarKVSerializer

    desc = {
        "partitioner": part,
        "sort": dep.key_ordering is not None,
        # the serializer's registry name (serializer.get_serializer)
        "serializer": dep.serializer.name,
    }
    if isinstance(dep.serializer, ColumnarKVSerializer):
        # a driver that pinned the frame wire keeps it on its workers, whose
        # own configs would otherwise decide it
        if dep.serializer.column_frames is not None:
            desc["serializer_column_frames"] = bool(dep.serializer.column_frames)
        if dep.serializer.batch_records != DEFAULT_BATCH_RECORDS:
            desc["serializer_batch_records"] = int(dep.serializer.batch_records)
    return desc


def dep_from_descriptor(shuffle_id: int, desc: dict) -> ShuffleDependency:
    part_desc = desc["partitioner"]
    if part_desc["kind"] == "range":
        partitioner = RangePartitioner([base64.b64decode(b) for b in part_desc["bounds_b64"]])
    elif part_desc["kind"] == "hash":
        partitioner = HashPartitioner(int(part_desc["num_partitions"]))
    else:
        raise ValueError(f"unknown partitioner kind {part_desc['kind']!r}")
    from s3shuffle_tpu_torch.serializer import ColumnarKVSerializer, get_serializer

    serializer = get_serializer(desc.get("serializer", "columnar"))
    if isinstance(serializer, ColumnarKVSerializer):
        if "serializer_column_frames" in desc:
            serializer.column_frames = bool(desc["serializer_column_frames"])
        if "serializer_batch_records" in desc:
            serializer.batch_records = int(desc["serializer_batch_records"])
    return ShuffleDependency(
        shuffle_id=shuffle_id,
        partitioner=partitioner,
        serializer=serializer,
        key_ordering=natural_key if desc.get("sort") else None,
    )


# --- input and output objects: raw column frames, no codec (scratch objects
# of the driver and the reducers, not shuffle data) ---------------------------

def write_input_object(backend, path: str, batch) -> None:
    from s3shuffle_tpu_torch.batch import write_frame

    with backend.create(path) as sink:
        write_frame(sink, batch)


def read_input_batches(backend, path: str):
    from s3shuffle_tpu_torch.batch import read_frames

    return list(read_frames(io.BytesIO(backend.read_all(path))))


# --- the agent ---------------------------------------------------------------

def _with_sealed_parity(map_output, parity_segments: int):
    """A deferred registration payload with the parity count its group's
    seal decided (word 7 of the format-4 payload); unchanged when parity is
    off or there is no payload."""
    if map_output is None or parity_segments <= 0:
        return map_output
    return list(map_output[:7]) + [int(parity_segments)]


class StaleAttemptError(RuntimeError):
    """This attempt's lease was reaped (its worker presumed dead) and
    another attempt owns the task: give up quietly and touch nothing
    shared."""


class MapOutputLostError(RuntimeError):
    """A reduce scan failed on a committed map output that is gone or
    unreadable, even after one retry on the live tracker (Spark's
    FetchFailed). The message carries
    :data:`s3shuffle_tpu_torch.recovery.MAP_OUTPUT_LOST_MARKER`, so the
    driver hands the failure to its recovery instead of failing the
    stage."""


class WorkerAgent:
    #: attempt-unique map output ids, ``logical * STRIDE + (attempt - 1)``
    #: (Spark 3's mapTaskAttemptId): every attempt writes objects of its own
    #: names, so a zombie attempt never overwrites the winner's bytes, and
    #: only the attempt the commit fence authorizes registers
    ATTEMPT_STRIDE = 1000

    def __init__(
        self,
        coordinator: Tuple[str, int],
        config: Optional[ShuffleConfig] = None,
        worker_id: Optional[str] = None,
        device=None,
    ):
        from s3shuffle_tpu_torch.manager import ShuffleManager
        from s3shuffle_tpu_torch.metadata.snapshot import SnapshotBackedTracker

        self.client = RemoteMapOutputTracker(coordinator)
        self.config = config or ShuffleConfig.from_env()
        if self.config.map_id_attempt_stride != self.ATTEMPT_STRIDE:
            # the read plane's listing mode filters and dedupes on it
            self.config = dataclasses.replace(
                self.config, map_id_attempt_stride=self.ATTEMPT_STRIDE
            )
        self.worker_id = worker_id or f"{socket.gethostname()}-{os.getpid()}"
        # the flight ring records task and drain boundaries whether tracing
        # is on or not; flight_dir decides where postmortem dumps go
        trace.configure_flight(
            dir=self.config.flight_dir,
            ring=self.config.flight_ring_events,
            worker_id=self.worker_id,
        )
        # once a reduce task names a sealed shuffle's snapshot (read once
        # through the store), its lookups are served here with no RPC;
        # other shuffles ask self.client
        self.meta = SnapshotBackedTracker(self.client, loader=self._load_snapshot)
        self.manager = ShuffleManager(config=self.config, tracker=self.meta, device=device)
        self.tasks_run = 0
        # composite commits: a map whose output joined an open group reports
        # only when the group seals (the fat index is the commit point and
        # the report carries the registration). Reports wait here:
        # (sid, mid) -> (stage_id, task, result, map_output, stats), stats
        # being that task's own slice of the stats outbox
        self._pending_composite: dict = {}
        # (sid, mid) -> parity count of a group that sealed during its
        # member's own commit: that member reports on the normal path
        self._sealed_members: dict = {}
        if self.manager.composite is not None:
            self.manager.composite.on_group_commit = self._on_group_sealed
            self.manager.composite.on_group_abort = self._on_group_aborted
        self._stopped = False
        self._wake = threading.Event()  # ends a heartbeat's sleep
        #: set by the SIGTERM handler or a drain reply: the poll loop drains
        #: at the next task boundary, never mid-task
        self._drain_requested = False
        # a worker often starts before its coordinator listens: retry the
        # connect with backoff; a wire-format mismatch raises at once
        deadline = time.monotonic() + float(
            os.environ.get("S3SHUFFLE_WORKER_CONNECT_TIMEOUT_S", "60")
        )
        delay = 0.2
        while True:
            try:
                self.client.check_format()
                break
            except OSError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(delay)
                delay = min(delay * 2, 2.0)
        # join the fleet now, not at the first poll; an older coordinator
        # without the membership table still serves tasks
        try:
            self.client.register_worker(self.worker_id)
        except Exception as e:
            logger.debug("worker %s: membership registration skipped: %s", self.worker_id, e)

    # -- task kinds --------------------------------------------------------
    def _commit_allowed(self, stage_id: str, task: dict) -> bool:
        """The commit fence (``TaskQueue.can_commit``): only the lease holder
        commits. A refusal gives False; a transport error propagates and
        fails the task (an unreachable coordinator then stops this worker's
        heartbeats, and its lease is reaped)."""
        return bool(self.client.can_commit(stage_id, task["task_id"], self.worker_id))

    def _run_map(self, task: dict, stage_id: str):
        shuffle_id = int(task["shuffle_id"])
        dep = dep_from_descriptor(shuffle_id, task["dep"])
        handle = self.manager.register_shuffle(shuffle_id, dep)
        batches = read_input_batches(self.manager.dispatcher.backend, task["input_path"])
        # a recovery stage's _attempt_base lifts a recompute above every
        # attempt of the original stage, so the tracker's latest attempt
        # (the largest map id) is the fresh output
        attempt = int(task.get("_attempt", 1)) + int(task.get("_attempt_base", 0))
        logical_index = int(task["map_id"])
        map_id = logical_index * self.ATTEMPT_STRIDE + (attempt - 1)
        # range reads filter on the logical index, never the strided id
        writer = self.manager.get_writer(handle, map_id, map_index=logical_index)
        # registration rides the complete_task report and is accepted with
        # it, so an attempt reaped after the fence still cannot register
        captured: dict = {}

        def capture(sid, mid, lengths, midx, message=None):
            payload = [sid, mid, STORE_LOCATION, np.asarray(lengths).tolist(), midx]
            deferred = message is not None and message.deferred
            if deferred:
                # composite coordinates; the group's parity count is known
                # only at its seal (_on_group_sealed appends it)
                payload += [int(message.composite_group), int(message.base_offset)]
            elif message is not None and message.parity_segments > 0:
                payload += [-1, 0, int(message.parity_segments)]
            captured.update(map_output=payload, deferred=deferred)

        writer.on_commit = capture
        try:
            for b in batches:
                writer.write(b)
            if not self._commit_allowed(stage_id, task):
                # this attempt's objects are its own: aborting deletes
                # nothing of the winner's
                writer.stop(success=False)
                raise StaleAttemptError(f"commit refused for task {task['task_id']}")
            writer.stop(success=True)
        except StaleAttemptError:
            raise
        except BaseException:
            writer.stop(success=False)
            raise
        return {
            "records": int(sum(b.n for b in batches)),
            "_map_output": captured.get("map_output"),
            "_composite_deferred": bool(captured.get("deferred")),
        }

    def _load_snapshot(self, shuffle_id: int, epoch: int):
        """A published snapshot's bytes: one GET of the driver's object
        first, the ``get_snapshot`` RPC second; None unless one of them has
        exactly the advertised epoch (lookups then stay on live RPCs)."""
        from s3shuffle_tpu_torch.block_ids import ShuffleSnapshotBlockId

        dispatcher = self.manager.dispatcher
        path = dispatcher.get_path(ShuffleSnapshotBlockId(shuffle_id, epoch))
        try:
            return dispatcher.backend.read_all(path)
        except (OSError, ValueError) as e:
            logger.warning(
                "worker %s: snapshot object for shuffle %d epoch %d unreadable "
                "(%s); falling back to RPC", self.worker_id, shuffle_id, epoch, e,
            )
        try:
            got_epoch, data = self.client.get_snapshot(shuffle_id)
        except Exception as e:
            logger.warning(
                "worker %s: snapshot RPC for shuffle %d failed: %s",
                self.worker_id, shuffle_id, e,
            )
            return None
        return data if got_epoch == epoch else None

    def _run_reduce(self, task: dict, stage_id: str):
        shuffle_id = int(task["shuffle_id"])
        # read your writes: this worker's open groups seal (and their
        # members report) before a scan
        self._drain_composite(force=True)
        dep = dep_from_descriptor(shuffle_id, task["dep"])
        snap = task.get("snapshot")
        if snap:
            if not self.meta.ensure(shuffle_id, int(snap["epoch"])):
                logger.warning(
                    "worker %s: no snapshot at epoch %s for shuffle %d; the "
                    "reduce scan asks the live tracker",
                    self.worker_id, snap.get("epoch"), shuffle_id,
                )
        else:
            # no snapshot named: live RPCs; an earlier stage's attachment
            # must not answer for a state the driver did not vouch for
            self.meta.detach(shuffle_id)
        handle = self.manager.register_shuffle(shuffle_id, dep)
        rid = int(task["reduce_id"])
        batches = self._read_reduce_batches(handle, shuffle_id, rid)
        from s3shuffle_tpu_torch.batch import RecordBatch, write_frame

        merged = RecordBatch.concat(batches)
        if not self._commit_allowed(stage_id, task):
            raise StaleAttemptError(f"commit refused for task {task['task_id']}")
        # attempt-suffixed output: the driver reads the path the accepted
        # attempt's result names, never a zombie's
        out_path = f"{task['output_path']}.a{int(task.get('_attempt', 1))}"
        with self.manager.dispatcher.backend.create(out_path) as sink:
            write_frame(sink, merged)
        return {"records": int(merged.n), "path": out_path}

    def _read_reduce_batches(self, handle, shuffle_id: int, rid: int):
        """The reduce scan. A dead producer's committed objects stay in the
        store, and partial losses heal through degraded reads; what reaches
        here is a committed output gone beyond the parity's reach. One retry
        runs on the live tracker with every cache purged (the driver may
        have recomputed an attempt the snapshot cannot see); a second
        failure raises :class:`MapOutputLostError` for the driver's
        recovery."""
        from s3shuffle_tpu_torch.read.checksum_stream import ChecksumError

        try:
            return self.manager.get_reader(handle, rid, rid + 1).read_result_batches()
        except (ChecksumError, FileNotFoundError) as e:
            logger.warning(
                "worker %s: reduce %d of shuffle %d hit a lost or unreadable map "
                "output (%s); retrying once on the live tracker",
                self.worker_id, rid, shuffle_id, e,
            )
            self.meta.detach(shuffle_id)
            self.manager.purge_caches(shuffle_id)
            self.manager.dispatcher.clear_status_cache()
            try:
                return self.manager.get_reader(handle, rid, rid + 1).read_result_batches()
            except (ChecksumError, FileNotFoundError) as e2:
                from s3shuffle_tpu_torch.recovery import MAP_OUTPUT_LOST_MARKER

                raise MapOutputLostError(
                    f"{MAP_OUTPUT_LOST_MARKER}(shuffle={shuffle_id}): "
                    f"{type(e2).__name__}: {e2}"
                ) from e2

    KINDS = {"map": _run_map, "reduce": _run_reduce}

    # -- lifecycle ---------------------------------------------------------
    def request_drain(self) -> None:
        """Ask for a drain at the next task boundary (the SIGTERM handler:
        it only sets a flag, so a running task completes and reports)."""
        self._drain_requested = True

    def _stop_heartbeat(self) -> None:
        self._stopped = True
        self._wake.set()

    def drain(self) -> float:
        """The drain: seal every open composite group (which writes parity
        and sends the deferred reports), push the stats outbox and the
        spans, dump the flight ring, then deregister with the drain's wall.
        A worker that leaves this way holds no lease, so nothing is
        requeued and no record is lost. Returns the drain's seconds."""
        t0 = time.monotonic()
        trace.flight_record("worker.drain", "B", worker=self.worker_id)
        with trace.span("worker.drain", worker=self.worker_id):
            agg = self.manager.composite
            if agg is not None:
                try:
                    sealed = agg.drain()
                    if sealed:
                        logger.info(
                            "worker %s drain sealed %d open composite group(s)",
                            self.worker_id, sealed,
                        )
                except Exception:
                    # a failed seal already failed its members' tasks
                    # (on_group_abort); the drain still finishes
                    logger.exception("worker %s: drain-path composite seal failed", self.worker_id)
            self._push_task_stats()
        self._push_trace_spans()
        drain_s = time.monotonic() - t0
        trace.flight_record("worker.drain", "E", seconds=drain_s)
        trace.flight_dump("drain")
        # no heartbeat may land after the membership records the leave
        self._stop_heartbeat()
        try:
            self.client.deregister_worker(self.worker_id, drain_s)
        except Exception:
            logger.warning(
                "worker %s: deregistration failed (membership will expire the "
                "lease instead)", self.worker_id, exc_info=True,
            )
        logger.info("worker %s drained in %.3fs after %d tasks",
                    self.worker_id, drain_s, self.tasks_run)
        return drain_s

    def close(self) -> None:
        """Seal open groups, stop the heartbeat and close the coordinator
        connection (an agent run in a thread must be closed)."""
        self._drain_composite(force=True)
        self._stop_heartbeat()
        self.client.close()

    # -- composite groups --------------------------------------------------
    def _on_group_sealed(self, shuffle_id: int, members) -> None:
        """Report every member whose report waited for this seal; a member
        with none queued is the task committing right now, which reports on
        the normal path."""
        for m in members:
            key = (shuffle_id, m.map_id)
            entry = self._pending_composite.pop(key, None)
            if entry is None:
                self._sealed_members[key] = int(getattr(m, "parity_segments", 0))
                continue
            stage_id, task, result, map_output, stats = entry
            map_output = _with_sealed_parity(map_output, int(getattr(m, "parity_segments", 0)))
            self._report_completion(stage_id, task, result, map_output, "map", stats=stats)

    def _on_group_aborted(self, shuffle_id: int, members, error: Exception) -> None:
        """A group that failed to seal loses every member: fail their
        waiting reports so the driver runs the tasks again."""
        for m in members:
            key = (shuffle_id, m.map_id)
            entry = self._pending_composite.pop(key, None)
            self._sealed_members.pop(key, None)
            if entry is None:
                continue
            stage_id, task, _result, _map_output, _stats = entry
            logger.error("composite group seal failed; failing deferred task %s: %s",
                         task.get("task_id"), error)
            try:
                self.client.fail_task(
                    stage_id, task["task_id"],
                    f"composite group seal failed: {type(error).__name__}: {error}",
                    self.worker_id,
                )
            except Exception:
                logger.warning("worker %s: could not fail deferred task %s",
                               self.worker_id, task.get("task_id"), exc_info=True)

    def _drain_composite(self, force: bool = False) -> None:
        """Seal groups past their age (every poll), or every open group (an
        empty queue, a reduce about to read, shutdown: the commit barrier).
        A failed seal never stops the poll loop."""
        agg = self.manager.composite
        if agg is None:
            return
        try:
            if force:
                agg.flush_all()
            else:
                agg.maybe_flush_stale()
        except Exception:
            logger.exception("worker %s: composite flush failed", self.worker_id)

    def _report_completion(self, stage_id, task, result, map_output, kind, stats=None) -> None:
        """One completion report, and the cleanup of a refused attempt.
        ``stats`` is the task's own outbox slice when its report waited for
        a seal: pushing exactly it keeps stats per task when several
        members report in one seal."""
        try:
            accepted = self.client.complete_task(
                stage_id, task["task_id"], result, self.worker_id, map_output
            )
        except Exception:
            logger.exception("worker %s: completion report for %s failed",
                             self.worker_id, task.get("task_id"))
            return
        if accepted is False:
            logger.warning("worker %s: stale attempt for task %s ignored by coordinator",
                           self.worker_id, task.get("task_id"))
            self._delete_refused_attempt_objects(kind, map_output, result)
        if stats is None:
            self._push_task_stats(discard=accepted is False)
        elif stats and accepted is not False:
            try:
                self.client.report_task_stats(stats)
            except Exception:
                logger.warning("worker %s: could not push deferred task stats",
                               self.worker_id, exc_info=True)

    # -- the loop ----------------------------------------------------------
    def run_once(self) -> str:
        """Poll for one task. Returns what was done: run, wait, stop or drain."""
        if self._drain_requested:
            # no further poll: the coordinator may already be gone
            self.drain()
            return "drain"
        resp = self.client.take_task(self.worker_id)
        action = resp.get("action")
        if action == "drain":
            self.drain()
            return "drain"
        if action != "run":
            # an empty queue is the commit barrier of open groups
            self._drain_composite(force=True)
            return action
        stage_id, task = resp["stage_id"], resp["task"]
        kind = task.get("kind")
        try:
            fn = self.KINDS[kind]
        except KeyError:
            self.client.fail_task(stage_id, task.get("task_id"), f"unknown kind {kind!r}",
                                  self.worker_id)
            return "run"
        map_output = None
        result = None
        stale = False
        status = "ok"
        trace.flight_record("worker.task", "B", task_id=task.get("task_id"), kind=kind,
                            stage=stage_id)
        try:
            # the driver's trace context: this task's spans, and every store
            # op and RPC under them, join the driver's tree
            with trace.context(task.get("trace")):
                with trace.span("worker.task", task_id=str(task.get("task_id")),
                                kind=str(kind), worker=self.worker_id):
                    result = fn(self, task, stage_id)
                map_output = result.pop("_map_output", None) if isinstance(result, dict) else None
                deferred = (result.pop("_composite_deferred", False)
                            if isinstance(result, dict) else False)
                if deferred:
                    key = (int(map_output[0]), int(map_output[1]))
                    if key in self._sealed_members:
                        # the group sealed during this commit: report now
                        map_output = _with_sealed_parity(map_output,
                                                         self._sealed_members.pop(key))
                    else:
                        # the outbox holds only this task's entries now
                        from s3shuffle_tpu_torch.metrics import registry as metrics_registry
                        from s3shuffle_tpu_torch.metrics.stats import COLLECTOR

                        stats = COLLECTOR.drain_outbox() if metrics_registry.enabled() else []
                        self._pending_composite[key] = (stage_id, task, result, map_output,
                                                        stats)
                        self.tasks_run += 1
                        self._drain_composite()
                        self._finish_task_trace(task, "deferred")
                        return "run"
                accepted = self.client.complete_task(
                    stage_id, task["task_id"], result, self.worker_id, map_output
                )
        except StaleAttemptError as e:
            logger.warning("worker %s: %s — attempt abandoned", self.worker_id, e)
            accepted = True  # nothing to report: the lease moved on
            stale = True  # and its stats are the retry's to report
            status = "stale"
        except Exception as e:
            logger.exception("task %s failed", task.get("task_id"))
            status = "failed"
            accepted = self.client.fail_task(
                stage_id, task["task_id"], f"{type(e).__name__}: {e}", self.worker_id
            )
        if accepted is False:
            # reaped while running (presumed dead): the report was refused.
            # Refused attempts never register, so delete their objects now
            logger.warning("worker %s: stale attempt for task %s ignored by coordinator",
                           self.worker_id, task.get("task_id"))
            self._delete_refused_attempt_objects(kind, map_output, result)
        self._push_task_stats(discard=stale or accepted is False)
        self.tasks_run += 1
        self._drain_composite()
        self._finish_task_trace(task, status)
        self._push_fleet_sample()
        return "run"

    def _finish_task_trace(self, task: dict, status: str) -> None:
        """The flight ring's end record, a postmortem dump when the task
        failed, then the span shard to the coordinator."""
        trace.flight_record("worker.task", "E", task_id=task.get("task_id"), status=status)
        if status == "failed":
            trace.flight_note_error()
            trace.flight_dump("task_failure")
        self._push_trace_spans()

    def _push_trace_spans(self) -> None:
        """Send this worker's finished spans to the coordinator's trace
        store; a refused or failed shard is dropped (tracing never holds
        back or fails the data plane)."""
        if not trace.enabled():
            return
        spans = trace.drain_spans()
        if not spans:
            return
        try:
            self.client.report_trace_spans(spans)
        except Exception:
            logger.warning("worker %s: could not push trace spans", self.worker_id,
                           exc_info=True)

    def _push_fleet_sample(self) -> None:
        """Send the registry's compact snapshot and the per-object GET peaks
        to the coordinator's fleet table (registry on only)."""
        from s3shuffle_tpu_torch.metrics import registry as metrics_registry

        if not metrics_registry.enabled():
            return
        from s3shuffle_tpu_torch.skew import OBJECT_GETS

        try:
            self.client.report_fleet_sample(
                self.worker_id, metrics_registry.REGISTRY.snapshot(compact=True),
                OBJECT_GETS.peaks(),
            )
        except Exception:
            logger.warning("worker %s: could not push fleet sample", self.worker_id,
                           exc_info=True)

    def _push_task_stats(self, discard: bool = False) -> None:
        """Send this process's ShuffleStats outbox to the coordinator, or
        drop it (``discard``: a refused attempt, whose retry reports the
        same task). Never fails a report."""
        from s3shuffle_tpu_torch.metrics import registry as metrics_registry
        from s3shuffle_tpu_torch.metrics.stats import COLLECTOR

        if not metrics_registry.enabled():
            return
        entries = COLLECTOR.drain_outbox()
        if not entries or discard:
            return
        try:
            self.client.report_task_stats(entries)
        except Exception:
            logger.warning("worker %s: could not push task stats", self.worker_id,
                           exc_info=True)

    def _delete_refused_attempt_objects(self, kind, map_output, result) -> None:
        """Delete a refused attempt's objects (their names are its own; the
        winner's differ). What slips through is swept with the shuffle's
        prefix."""
        from s3shuffle_tpu_torch.block_ids import (
            ShuffleChecksumBlockId,
            ShuffleDataBlockId,
            ShuffleIndexBlockId,
            ShuffleParityBlockId,
        )

        dispatcher = self.manager.dispatcher
        try:
            if kind == "map" and map_output:
                sid, mid = int(map_output[0]), int(map_output[1])
                if len(map_output) > 5 and int(map_output[5]) >= 0:
                    # a composite member: its bytes are in an object the
                    # winners share; it never registers and is reclaimed
                    # with the shuffle
                    logger.info("refused attempt map %d is composite group %d member; "
                                "bytes reclaimed at shuffle teardown", mid, int(map_output[5]))
                    return
                blocks = [
                    ShuffleDataBlockId(sid, mid),
                    ShuffleIndexBlockId(sid, mid),
                    ShuffleChecksumBlockId(sid, mid,
                                           algorithm=dispatcher.config.checksum_algorithm),
                ]
                # the parity sidecars land before the index: the count the
                # commit recorded (word 7), else the config's
                parity_n = (int(map_output[7]) if len(map_output) > 7
                            else dispatcher.config.parity_segments)
                blocks.extend(ShuffleParityBlockId(sid, mid, seg) for seg in range(parity_n))
                for block in blocks:
                    dispatcher.backend.delete(dispatcher.get_path(block))
            elif kind == "reduce" and isinstance(result, dict) and result.get("path"):
                dispatcher.backend.delete(result["path"])
        except Exception:
            logger.warning("worker %s: could not delete refused-attempt objects",
                           self.worker_id, exc_info=True)

    def _start_heartbeat(self, interval_s: float) -> threading.Thread:
        """A daemon thread that beats on a connection of its own while a
        long task runs on the main one: the coordinator reaps only workers
        that went silent."""

        def beat():
            hb_client = RemoteMapOutputTracker(self.client.address)
            try:
                while not self._stopped:
                    try:
                        hb_client.heartbeat(self.worker_id)
                    except Exception as e:
                        # take_task beats too: a missed beat is recoverable
                        logger.debug("worker %s heartbeat skipped: %s", self.worker_id, e)
                    self._wake.wait(interval_s)
            finally:
                hb_client.close()

        t = threading.Thread(target=beat, daemon=True, name="worker-heartbeat")
        t.start()
        return t

    def run_forever(self, poll_interval: float = 0.05, heartbeat_s: float = 5.0) -> int:
        logger.info("worker %s polling coordinator %s", self.worker_id, self.client.address)
        self._stopped = False
        self._wake.clear()
        heartbeat = self._start_heartbeat(heartbeat_s)
        try:
            while True:
                action = self.run_once()
                if action == "stop":
                    logger.info("worker %s stopping after %d tasks", self.worker_id,
                                self.tasks_run)
                    # a fleet shutdown: record the leave (run_once sealed
                    # the barrier), the heartbeat stopped first
                    self._stop_heartbeat()
                    try:
                        self.client.deregister_worker(self.worker_id)
                    except Exception:
                        logger.debug("worker %s: stop-path deregistration skipped",
                                     self.worker_id, exc_info=True)
                    return self.tasks_run
                if action == "drain":
                    logger.info("worker %s drained and leaving after %d tasks",
                                self.worker_id, self.tasks_run)
                    return self.tasks_run
                if action == "wait":
                    time.sleep(poll_interval)
        finally:
            self._stop_heartbeat()
            heartbeat.join(timeout=30.0)


class MetricsServer:
    """The worker's Prometheus endpoint (the reference's executor pods are
    scraped through pod annotations, SURVEY.md §5.5): tasks run, every
    ``utils.trace`` counter as ``s3shuffle_<name>`` and the typed registry,
    labelled with the worker id; the text equals the JAX worker's for the
    same counters and registry."""

    def __init__(self, agent: WorkerAgent, host: str = "0.0.0.0", port: int = 8000):
        import http.server

        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path.rstrip("/") not in ("", "/metrics", "/healthz"):
                    self.send_response(404)
                    self.end_headers()
                    return
                body = outer.render().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        class Server(http.server.ThreadingHTTPServer):
            daemon_threads = True
            allow_reuse_address = True

        self.agent = agent
        self._server = Server((host, port), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True,
                                        name="worker-metrics")

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> "MetricsServer":
        self._thread.start()
        logger.info("metrics endpoint on :%d/metrics", self.port)
        return self

    def render(self) -> str:
        from s3shuffle_tpu_torch.metrics import registry as metrics_registry

        # exposition-format label escaping: \\, \" and newline
        wid = (str(self.agent.worker_id).replace("\\", "\\\\").replace('"', '\\"')
               .replace("\n", "\\n"))
        # counter names that sanitize alike ("io.read", "io/read", or the
        # tasks counter itself) merge into one series: Prometheus refuses a
        # scrape with a duplicate
        merged: dict = {"s3shuffle_tasks_run_total": self.agent.tasks_run}
        for name, value in sorted(trace.counters().items()):
            metric = "s3shuffle_" + "".join(c if c.isalnum() else "_" for c in name.lower())
            merged[metric] = merged.get(metric, 0) + value
        # the registry renders its own (histograms with _bucket/_sum/_count)
        registry_names = {"s3shuffle_" + m.name for m in metrics_registry.REGISTRY.metrics()}
        lines = []
        for metric, value in merged.items():
            if metric in registry_names:
                continue
            lines.append(f"# TYPE {metric} counter")
            lines.append(f'{metric}{{worker="{wid}"}} {value}')
        body = "\n".join(lines) + "\n"
        body += metrics_registry.render_prometheus(
            metrics_registry.REGISTRY, extra_labels={"worker": wid}
        )
        return body

    def stop(self) -> None:
        if self._thread.is_alive():
            # shutdown() waits for serve_forever: never on an unstarted server
            self._server.shutdown()
        self._server.server_close()


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description="s3shuffle_tpu_torch worker agent")
    ap.add_argument("--coordinator", required=True, help="metadata service HOST:PORT")
    ap.add_argument("--worker-id", default=None)
    ap.add_argument("--poll-interval", type=float, default=0.05)
    ap.add_argument("--metrics-port", type=int, default=8000,
                    help="Prometheus /metrics port (0 disables; matches the deploy "
                         "templates' scrape annotations)")
    ap.add_argument("--device", default=None,
                    help="torch device of the worker's kernels (default: the CUDA "
                         "device; 'cpu' runs their plain versions)")
    args = ap.parse_args(argv)
    host, port = args.coordinator.rsplit(":", 1)
    agent = WorkerAgent((host, int(port)), worker_id=args.worker_id, device=args.device)
    if agent.config.drain_on_sigterm:
        import signal

        # a preemption notice drains at the next task boundary; SIGKILL
        # still leaves recovery to the lease reap
        signal.signal(signal.SIGTERM, lambda _signum, _frame: agent.request_drain())
    metrics = None
    if args.metrics_port:
        try:
            metrics = MetricsServer(agent, port=args.metrics_port).start()
        except OSError as e:
            logger.warning("metrics endpoint disabled: %s", e)
    try:
        agent.run_forever(args.poll_interval)
        # a worker that exits cleanly vouches for its own commit protocol:
        # every witness S3SHUFFLE_PROTOCOL_WITNESS installed must be clean,
        # or the exit code says so
        from s3shuffle_tpu_torch.utils import protowitness

        for witness in protowitness.drain_installed():
            witness.assert_clean()
    finally:
        if metrics is not None:
            metrics.stop()
        agent.client.close()
        _report_launches(agent.worker_id)
    return 0


def _report_launches(worker_id: str) -> None:
    """With ``S3SHUFFLE_LAUNCHES_DIR`` set, write this process's kernel
    launches (``ops._build.LAUNCHES``) to ``<dir>/<worker_id>.json`` as the
    worker leaves, so a driver that started the workers can sum them."""
    out_dir = os.environ.get("S3SHUFFLE_LAUNCHES_DIR")
    if not out_dir:
        return
    import json

    from s3shuffle_tpu_torch.ops import _build

    with open(os.path.join(out_dir, f"{worker_id}.json"), "w") as f:
        json.dump({"worker_id": worker_id, "launches": dict(_build.LAUNCHES)}, f)


if __name__ == "__main__":
    raise SystemExit(main())
