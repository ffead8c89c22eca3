"""Multi-process shuffles: the local cluster and the fleet's driver (the JAX
package's ``cluster.py``).

The reference runs inside Spark executors, separate JVMs that share
nothing but the object store and the driver's RPC endpoint (SURVEY.md
§3.2, §3.3). :class:`LocalCluster` builds that shape on one host: the
coordinator process hosts the :class:`~s3shuffle_tpu_torch.metadata.service.
MetadataServer`; map and reduce tasks run in worker processes (fresh
interpreters, started with ``spawn``: the parent may already hold a CUDA
context) that reach the coordinator over TCP and the data through the
store. Each stage's pool is gone before the next stage starts, so every run
shows the reference's executor independence (its FALLBACK_BLOCK_MANAGER_ID
rebranding, S3ShuffleWriter.scala:7-21): the map workers are dead when the
reducers read.

:class:`DistributedDriver` drives a fleet of
:class:`~s3shuffle_tpu_torch.worker.WorkerAgent` processes on any host that
reaches its address and the store: it stages input objects, queues map and
reduce tasks, reaps silent workers, recovers lost map outputs (recompute or
reconstruct, ``recovery.py``), compacts small outputs between the barriers
and publishes each sealed shuffle's snapshot. The driver launches no
kernel: it stages raw frames and compacts raw bytes, and its workers do
every device step on their own devices.
"""

from __future__ import annotations

import dataclasses
import logging
import multiprocessing as mp
import pickle
import time
from typing import Any, Iterable, List, Optional, Sequence, Tuple

from s3shuffle_tpu_torch.config import ShuffleConfig
from s3shuffle_tpu_torch.dependency import ShuffleDependency
from s3shuffle_tpu_torch.metadata.service import MetadataServer, stage_id_for
from s3shuffle_tpu_torch.metadata import snapshot as _snapshot
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
from s3shuffle_tpu_torch.utils import trace

logger = logging.getLogger("s3shuffle_tpu_torch.cluster")


def publish_snapshot(tracker, config: ShuffleConfig, shuffle_id: int):
    """Freeze the coordinator-side tracker's map-output table for one
    sealed shuffle and publish it through ``Dispatcher.get(config)`` (the
    JAX package's ``cluster.publish_snapshot``; the work is
    ``metadata.snapshot.publish_snapshot``). Returns the stamped epoch, or
    None when snapshots are off or publication failed."""
    return _snapshot.publish_snapshot(tracker, Dispatcher.get(config), shuffle_id)

# One manager and one coordinator connection per pool process, built by the
# pool's initializer
_WORKER_MANAGER = None
# the process's snapshot-backed tracker, built on first use: a reduce task
# that names a sealed shuffle's snapshot epoch looks up with no RPC, and the
# snapshot is read once per process
_WORKER_META = None


def _init_worker(cfg_dict: dict, tracker_addr: Tuple[str, int], device=None) -> None:
    global _WORKER_MANAGER, _WORKER_META
    from s3shuffle_tpu_torch.manager import ShuffleManager
    from s3shuffle_tpu_torch.metadata.async_client import AsyncTrackerClient

    Dispatcher.reset()  # a fresh process never keeps another config's
    cfg = ShuffleConfig(**cfg_dict)
    # registrations buffer and go in one RPC per commit; lookups spread
    # over the coordinator's shard endpoints
    tracker = AsyncTrackerClient.from_config(tuple(tracker_addr), cfg)
    _WORKER_MANAGER = ShuffleManager(config=cfg, tracker=tracker, device=device)
    _WORKER_META = None


def _worker_meta():
    """The process's snapshot-backed tracker (built on first use)."""
    global _WORKER_META
    if _WORKER_META is None:
        from s3shuffle_tpu_torch.block_ids import ShuffleSnapshotBlockId
        from s3shuffle_tpu_torch.metadata.snapshot import SnapshotBackedTracker

        manager = _WORKER_MANAGER

        def load(shuffle_id: int, epoch: int):
            path = manager.dispatcher.get_path(ShuffleSnapshotBlockId(shuffle_id, epoch))
            try:
                return manager.dispatcher.backend.read_all(path)
            except (OSError, ValueError) as e:
                logger.warning("snapshot object %s unreadable: %s", path, e)
                return None

        _WORKER_META = SnapshotBackedTracker(manager.tracker, loader=load)
    return _WORKER_META


def _run_map_task(args: Tuple[int, bytes, int, bytes]) -> int:
    shuffle_id, dep_bytes, map_id, records_bytes = args
    manager = _WORKER_MANAGER
    assert manager is not None, "worker pool missing _init_worker initializer"
    dep: ShuffleDependency = pickle.loads(dep_bytes)
    handle = manager.register_shuffle(shuffle_id, dep)
    writer = manager.get_writer(handle, map_id)
    try:
        writer.write(pickle.loads(records_bytes))
        writer.stop(success=True)
    except BaseException:
        writer.stop(success=False)
        raise
    # the commit barrier: the pool dies after the stage, so an open
    # composite group seals before the task returns, and the buffered
    # registrations reach the coordinator (a failed flush fails the task)
    if manager.composite is not None:
        manager.composite.flush_shuffle(shuffle_id)
    manager.tracker.flush()
    return map_id


def _run_reduce_task(args: Tuple[int, bytes, int, object]) -> bytes:
    shuffle_id, dep_bytes, reduce_id, snap_epoch = args
    manager = _WORKER_MANAGER
    assert manager is not None, "worker pool missing _init_worker initializer"
    dep: ShuffleDependency = pickle.loads(dep_bytes)
    tracker = None
    if snap_epoch is not None:
        meta = _worker_meta()
        if meta.ensure(shuffle_id, int(snap_epoch)):
            tracker = meta
    handle = manager.register_shuffle(shuffle_id, dep)
    reader = manager.get_reader(handle, reduce_id, reduce_id + 1, tracker=tracker)
    return pickle.dumps(list(reader.read()), protocol=pickle.HIGHEST_PROTOCOL)


class LocalCluster:
    """A coordinator and a worker pool per stage. The coordinator owns the
    metadata service and the store's cleanup; workers live for one stage
    (the decommission story is structural, SURVEY.md §5.3). ``device`` is
    every worker's (the CUDA device unless ``"cpu"``)."""

    def __init__(self, config: ShuffleConfig, num_workers: int = 2, device=None):
        self.config = config
        self.num_workers = max(1, num_workers)
        self.device = None if device is None else str(device)
        self.server = MetadataServer.from_config(config).start()
        self._cfg_dict = dataclasses.asdict(config)
        self._ctx = mp.get_context("spawn")
        self._next_shuffle_id = 0

    def run_shuffle(
        self,
        input_partitions: Sequence[Iterable[Tuple[Any, Any]]],
        dependency_factory,
    ) -> List[List[Tuple[Any, Any]]]:
        """One whole shuffle on stage-scoped pools.
        ``dependency_factory(shuffle_id)`` returns a picklable dependency
        (module-level key functions, no lambdas)."""
        shuffle_id = self._next_shuffle_id
        self._next_shuffle_id += 1
        dep = dependency_factory(shuffle_id)
        dep_bytes = pickle.dumps(dep, protocol=pickle.HIGHEST_PROTOCOL)
        # registered here first, so no reducer meets an empty tracker
        self.server.tracker.register_shuffle(shuffle_id, dep.num_partitions)
        map_args = [
            (shuffle_id, dep_bytes, map_id,
             pickle.dumps(list(records), protocol=pickle.HIGHEST_PROTOCOL))
            for map_id, records in enumerate(input_partitions)
        ]
        init = (_init_worker, (self._cfg_dict, self.server.address, self.device))
        with self._ctx.Pool(self.num_workers, *init) as pool:
            done = pool.map(_run_map_task, map_args)
        logger.info("map stage done: %d tasks (workers now dead)", len(done))
        # the map stage is the epoch barrier: reducers read the sealed
        # shuffle's table from its snapshot
        snap_epoch = publish_snapshot(self.server.tracker, self.config, shuffle_id)
        # a fresh pool reads: only the store and the service connect stages
        reduce_args = [(shuffle_id, dep_bytes, rid, snap_epoch)
                       for rid in range(dep.num_partitions)]
        with self._ctx.Pool(self.num_workers, *init) as pool:
            blobs = pool.map(_run_reduce_task, reduce_args)
        return [pickle.loads(b) for b in blobs]

    def cleanup_shuffle(self, shuffle_id: int) -> None:
        self.server.tracker.unregister_shuffle(shuffle_id)
        Dispatcher.get(self.config).remove_shuffle(shuffle_id)

    def shutdown(self, remove_root: bool = True) -> None:
        self.server.stop()
        if remove_root and self.config.cleanup:
            Dispatcher.get(self.config).remove_root()


class DistributedDriver:
    """The driver of a :class:`~s3shuffle_tpu_torch.worker.WorkerAgent`
    fleet: it hosts the metadata service and the task queue; agents on this
    host or any other that reaches ``coordinator_address`` and the store
    pull the tasks. Records move only through the store; the control plane
    carries JSON descriptors."""

    #: the worker-silence lease: the fleet reap requeues the tasks of a
    #: worker that sent no heartbeat for this long (an agent beats every
    #: ~5 s, so a long task on a live worker is never reaped). The instance
    #: takes ``ShuffleConfig.worker_lease_s``; tests may tighten it
    task_lease_s = 30.0

    def __init__(self, config: ShuffleConfig, host: str = "127.0.0.1", port: int = 0):
        from s3shuffle_tpu_torch.metadata.helper import ShuffleHelper

        self.config = config
        self.server = MetadataServer.from_config(config, host=host, port=port).start()
        self.dispatcher = Dispatcher.get(config)
        self.helper = ShuffleHelper(self.dispatcher)
        # the driver's flight ring records the job's phases; "driver" names
        # its dumps apart from the agents'
        trace.configure_flight(dir=config.flight_dir, ring=config.flight_ring_events,
                               worker_id="driver")
        self._next_shuffle_id = 0
        self.task_lease_s = float(config.worker_lease_s)
        # per shuffle: its descriptor and staged inputs (to recompute a lost
        # map), the recovery round (attempt-unique recompute ids) and each
        # map's recovery count (a bound on loss loops)
        self._job_state: dict = {}
        self._recovering = False

    @property
    def coordinator_address(self) -> Tuple[str, int]:
        return self.server.address

    def _scratch(self, shuffle_id: int, name: str) -> str:
        return f"{self.config.root_dir}_stage/{self.config.app_id}/{shuffle_id}/{name}"

    def _reap_fleet(self) -> None:
        """One fleet beat: requeue the tasks of silent leases in every live
        stage, then expire silent memberships and handle each newly dead
        worker (requeues across stages, lost-output recovery). Runs during
        stage waits and between stages."""
        self.server.task_queue.reap_expired_all(self.task_lease_s)
        for worker_id in self.server.membership.expire_silent(self.task_lease_s):
            self._on_worker_lost(worker_id)

    def _wait_stage(self, stage_id: str, poll: float = 0.02, on_failed=None) -> dict:
        last_reap = time.monotonic()
        while True:
            status = self.server.task_queue.stage_status(stage_id)
            if status["failed"]:
                # the recovery hook may requeue the failed tasks; what it
                # cannot handle fails the stage
                if on_failed is None or not on_failed(dict(status["failed"])):
                    raise RuntimeError(f"stage {stage_id} failed: {status['failed']}")
                continue
            if not status["pending"] and not status["running"]:
                return status["done"]
            now = time.monotonic()
            if now - last_reap > min(5.0, self.task_lease_s / 4):
                last_reap = now
                self._reap_fleet()
            time.sleep(poll)

    # -- the elastic fleet -------------------------------------------------
    def drain_workers(self, worker_ids=None) -> List[str]:
        """Ask ``worker_ids`` (default: every live worker) to drain: each
        stops taking tasks at its next poll, seals its open groups, sends
        its deferred reports and stats and deregisters. Returns the ids
        flagged."""
        membership = self.server.membership
        targets = list(worker_ids) if worker_ids is not None else membership.live_workers()
        return [w for w in targets if membership.request_drain(w)]

    def _on_worker_lost(self, worker_id: str) -> None:
        """Once per expired membership: requeue the dead worker's running
        tasks in every stage (the commit fence refuses its attempts), then
        probe the maps it committed for objects that died with it."""
        requeued = self.server.task_queue.requeue_lost_all(worker_id)
        if requeued:
            logger.warning("worker %s expired; requeued %d in-flight task(s)",
                           worker_id, requeued)
        by_shuffle: dict = {}
        for stage_id, task_id in self.server.task_queue.tasks_done_by(worker_id):
            if not stage_id.startswith("shuffle") or "-map" not in stage_id:
                continue
            try:
                sid = int(stage_id[len("shuffle"):].split("-", 1)[0])
            except ValueError:
                continue
            by_shuffle.setdefault(sid, set()).add(int(task_id))
        for sid, map_indices in by_shuffle.items():
            self._recover_shuffle_losses(sid, map_indices=map_indices)

    def _recover_shuffle_losses(self, shuffle_id: int, map_indices=None) -> bool:
        """Probe for lost committed map outputs and recover them. A map the
        planner reconstructs needs nothing here (reduce scans heal through
        degraded reads); a map it recomputes runs again from its staged
        input in a recovery stage, with attempt ids above every earlier
        attempt, so the tracker's latest attempt is the fresh one. True if
        any loss was found."""
        state = self._job_state.get(shuffle_id)
        if state is None or self._recovering:
            return False
        from s3shuffle_tpu_torch.metadata.service import TaskQueue
        from s3shuffle_tpu_torch.recovery import RecoveryPlanner, probe_lost_maps

        try:
            losses = probe_lost_maps(self.dispatcher, self.server.tracker, shuffle_id,
                                     map_indices=map_indices)
        except KeyError:
            return False  # the shuffle is unregistered already
        if not losses:
            return False
        planner = RecoveryPlanner(stripe_k=self.config.parity_stripe_k)
        try:
            stats = self.server.tracker.get_shuffle_stats(shuffle_id)
        except Exception as e:
            logger.debug("no shuffle stats for recovery costing: %s", e)
            stats = None
        budget = state["recovery_attempts"]
        recompute = []
        for lost in losses:
            if budget.get(lost.map_index, 0) >= TaskQueue.MAX_ATTEMPTS:
                continue  # out of budget: the reduce failure will say so
            if planner.decide(lost, stats) == "recompute":
                budget[lost.map_index] = budget.get(lost.map_index, 0) + 1
                recompute.append(lost)
        if not recompute:
            return True
        state["recovery_round"] += 1
        rec_round = state["recovery_round"]
        rec_stage = stage_id_for(shuffle_id, f"maprec{rec_round}")
        logger.warning("recomputing %d lost map output(s) of shuffle %d (round %d): %s",
                       len(recompute), shuffle_id, rec_round,
                       [lost.map_index for lost in recompute])
        self.server.task_queue.submit_stage(
            rec_stage,
            [
                {
                    "task_id": lost.map_index, "kind": "map",
                    "shuffle_id": shuffle_id, "map_id": lost.map_index,
                    "dep": state["desc"],
                    "input_path": state["input_paths"][lost.map_index],
                    # above every original attempt and every earlier
                    # recompute of this map; scaled by the map's own
                    # recovery count (at most MAX_ATTEMPTS²), never the
                    # shared round, so it stays below ATTEMPT_STRIDE
                    "_attempt_base": TaskQueue.MAX_ATTEMPTS * budget[lost.map_index],
                }
                for lost in recompute
            ],
        )
        self._recovering = True
        try:
            self._wait_stage(rec_stage)
        finally:
            self._recovering = False
            self.server.task_queue.drop_stage(rec_stage)
        # re-seal at the new epoch: fresh scans see the recomputed attempts
        # with no RPC; running reduce attempts retry on the live tracker
        publish_snapshot(self.server.tracker, self.config, shuffle_id)
        return True

    def _handle_reduce_failures(self, shuffle_id: int, reduce_stage: str, failed: dict) -> bool:
        """The reduce wait's recovery hook: failures that carry the
        MapOutputLost marker re-probe the shuffle, plan recovery and requeue
        their reduce tasks (within the shared attempt budget). Any other
        failure stays fatal, and so does a clean probe when no recovery round
        ever ran: the retry would fail the same way."""
        from s3shuffle_tpu_torch.recovery import MAP_OUTPUT_LOST_MARKER

        if not all(MAP_OUTPUT_LOST_MARKER in str(e) for e in failed.values()):
            return False
        recovered = self._recover_shuffle_losses(shuffle_id)
        state = self._job_state.get(shuffle_id)
        if not recovered and not (state and state["recovery_round"] > 0):
            return False
        # a clean probe after a recovery round: the task failed while the
        # recompute was landing, and retries
        return all(
            self.server.task_queue.retry_failed(reduce_stage, task_id, reason="map_output_lost")
            for task_id in failed
        )

    def run_sort_shuffle(self, input_batches, num_partitions: int, serializer=None):
        """A range-partitioned sort over the connected workers (TeraSort's
        shape): stages the input in the store, runs the map and reduce
        stages and returns the sorted output RecordBatches, one per
        partition. ``serializer`` (default: the columnar one) must have a
        registry name, so workers rebuild it from the JSON descriptor."""
        from s3shuffle_tpu_torch.dependency import RangePartitioner, natural_key, range_bounds
        from s3shuffle_tpu_torch.serializer import ColumnarKVSerializer
        from s3shuffle_tpu_torch.worker import dep_to_descriptor, write_input_object

        shuffle_id = self._next_shuffle_id
        self._next_shuffle_id += 1
        # the job's root span: every driver phase is its direct child
        with trace.span("driver.job", shuffle_id=shuffle_id, partitions=num_partitions):
            with trace.span("driver.stage_inputs", shuffle_id=shuffle_id):
                sample: List[bytes] = []
                for b in input_batches:
                    ko = b.koffsets
                    step = max(1, b.n // 64)
                    sample.extend(b.keys[ko[i]:ko[i + 1]].tobytes() for i in range(0, b.n, step))
                dep = ShuffleDependency(
                    shuffle_id=shuffle_id,
                    partitioner=RangePartitioner(range_bounds(sample, num_partitions)),
                    serializer=serializer if serializer is not None else ColumnarKVSerializer(),
                    key_ordering=natural_key,
                )
                desc = dep_to_descriptor(dep)
                self.server.tracker.register_shuffle(shuffle_id, dep.num_partitions)
                input_paths = []
                for map_id, batch in enumerate(input_batches):
                    path = self._scratch(shuffle_id, f"input_{map_id}")
                    write_input_object(self.dispatcher.backend, path, batch)
                    input_paths.append(path)
            # what a recompute of any map needs, kept for the job's life
            self._job_state[shuffle_id] = {
                "desc": desc, "input_paths": list(input_paths),
                "recovery_round": 0, "recovery_attempts": {},
            }
            map_stage = stage_id_for(shuffle_id, "map")
            reduce_stage = stage_id_for(shuffle_id, "reduce")
            try:
                return self._run_sort_stages(shuffle_id, dep, desc, input_paths, map_stage,
                                             reduce_stage)
            finally:
                # on every exit: the fleet reap walks all stages, so a
                # leaked stage's tasks would run again in later jobs
                self.server.task_queue.drop_stage(map_stage)
                self.server.task_queue.drop_stage(reduce_stage)
                self._job_state.pop(shuffle_id, None)

    def _run_sort_stages(self, shuffle_id, dep, desc, input_paths, map_stage, reduce_stage):
        from s3shuffle_tpu_torch.batch import RecordBatch
        from s3shuffle_tpu_torch.worker import read_input_batches

        with trace.span("driver.map_stage", shuffle_id=shuffle_id):
            # the tasks' causal parent is this span: workers adopt the
            # descriptor's context across the process boundary
            ctx = trace.current_context()
            self.server.task_queue.submit_stage(
                map_stage,
                [
                    {"task_id": m, "kind": "map", "shuffle_id": shuffle_id,
                     "map_id": m, "dep": desc, "input_path": p,
                     **({"trace": ctx} if ctx else {})}
                    for m, p in enumerate(input_paths)
                ],
            )
            self._wait_stage(map_stage)
            # the stage's barrier, inside its span so the driver's phases
            # tile the job: a worker that died right after its last map is
            # found here, not deep into the reduce wait
            self._reap_fleet()
            # the winners are final: reclaim the objects of attempts that
            # died mid-write (never registered) now
            try:
                self.dispatcher.sweep_orphan_attempts(
                    shuffle_id, self.server.tracker.registered_map_ids(shuffle_id)
                )
            except Exception:
                logger.warning("orphan sweep failed for shuffle %d", shuffle_id, exc_info=True)
        # small outputs become composites before the snapshot, so reduce
        # scans resolve the compacted layout; the old layout stays live if
        # compaction fails
        if self.config.compact_below_bytes > 0:
            from s3shuffle_tpu_torch.write.compactor import compact_shuffle

            with trace.span("driver.compact", shuffle_id=shuffle_id):
                try:
                    compact_shuffle(self.dispatcher, self.helper, shuffle_id,
                                    tracker=self.server.tracker)
                except Exception:
                    logger.warning("compaction failed for shuffle %d", shuffle_id,
                                   exc_info=True)
        # seal the shuffle: reduce tasks name the snapshot's epoch and look
        # up with no RPC
        with trace.span("driver.publish_snapshot", shuffle_id=shuffle_id):
            snap_epoch = publish_snapshot(self.server.tracker, self.config, shuffle_id)
        out_paths = [self._scratch(shuffle_id, f"output_{r}") for r in range(dep.num_partitions)]
        with trace.span("driver.reduce_stage", shuffle_id=shuffle_id):
            ctx = trace.current_context()
            self.server.task_queue.submit_stage(
                reduce_stage,
                [
                    {"task_id": r, "kind": "reduce", "shuffle_id": shuffle_id,
                     "reduce_id": r, "dep": desc, "output_path": p,
                     **({"snapshot": {"epoch": snap_epoch}} if snap_epoch is not None else {}),
                     **({"trace": ctx} if ctx else {})}
                    for r, p in enumerate(out_paths)
                ],
            )
            done = self._wait_stage(
                reduce_stage,
                on_failed=lambda failed: self._handle_reduce_failures(shuffle_id, reduce_stage,
                                                                      failed),
            )
        with trace.span("driver.collect", shuffle_id=shuffle_id):
            out = []
            for r, base in enumerate(out_paths):
                # the accepted attempt's result names its object
                result = done.get(r) or done.get(str(r)) or {}
                batches = read_input_batches(self.dispatcher.backend, result.get("path", base))
                out.append(batches[0] if batches else RecordBatch.empty())
        return out

    # -- the fleet's trace and telemetry -----------------------------------
    def dump_trace(self, path: Optional[str] = None) -> Optional[str]:
        """One merged Chrome trace: the driver's spans and every span shard
        the workers sent, with flow events on the cross-process edges.
        ``path`` defaults to ``trace.enable``'s. Returns the path written,
        or None when tracing is off or there is no path."""
        if not trace.enabled():
            return None
        target = path or trace.trace_path()
        if target is None:
            return None
        try:
            worker_spans = self.server.trace_store.drain()
        except Exception:
            logger.warning("worker trace-shard drain failed", exc_info=True)
            worker_spans = []
        doc = trace.assemble([trace.drain_spans(), worker_spans], counters=trace.counters())
        return trace.write_trace_doc(target, doc)

    def fleet_view(self) -> dict:
        """The coordinator's merged fleet telemetry: each worker's snapshot
        age and hot-object GET peaks, the merged registry (this process's
        own folded in, so the driver's staging I/O is priced) and the
        ``$/shuffle`` digest of the configured rate card."""
        from s3shuffle_tpu_torch.costs import cost_digest, parse_rate_card
        from s3shuffle_tpu_torch.metadata.service import merge_registry_snapshots
        from s3shuffle_tpu_torch.metrics import registry as metrics_registry

        view = self.server.fleet.view()
        if metrics_registry.enabled():
            view["metrics"] = merge_registry_snapshots(
                [view["metrics"], metrics_registry.REGISTRY.snapshot(compact=True)]
            )
        view["cost"] = cost_digest(view["metrics"], parse_rate_card(self.config.cost_rate_card),
                                   shuffles=max(1, self._next_shuffle_id))
        return view

    def dump_fleet(self, path: str) -> str:
        """Write the fleet view as the JSON document ``trace_report
        --fleet`` renders, and mirror the cost digest into
        ``cost_dollars_total``."""
        from s3shuffle_tpu_torch.costs import record_cost_metrics

        view = self.fleet_view()
        record_cost_metrics(view["cost"])
        doc = {
            "fleet_workers": view["workers"],
            "object_gets_peaks": view["object_gets_peaks"],
            "metrics": view["metrics"],
            "cost": view["cost"],
        }
        return trace.write_trace_doc(path, doc)

    def shutdown(self, remove_root: bool = True) -> None:
        self.server.task_queue.stop_workers()
        self.server.stop()
        if remove_root and self.config.cleanup:
            self.dispatcher.remove_root()
            self.dispatcher.backend.delete_prefix(f"{self.config.root_dir}_stage")
