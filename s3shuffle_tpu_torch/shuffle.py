"""High-level shuffle API (the JAX package's ``shuffle.py``).

The reference is driven by Spark jobs (``foldByKey``/``sortByKey``/... over a
SparkContext — S3ShuffleManagerTest.scala:176-205); :class:`ShuffleContext`
is the framework-native equivalent: it owns a manager, runs map tasks and
reduce tasks on a pool of ``num_workers`` threads (the analog of
``local[N]``), and exposes the classic shuffle operations. Its manager's
codec runs on ``device`` — the CUDA device unless ``device="cpu"``; with no
CUDA device it raises. :meth:`ShuffleContext.mesh_shuffle` rides the
multi-GPU plane (``parallel/``) when ``mesh_devices`` arms it.

Each job's stages are spans on the calling thread, timed into the
manager's codec's ``timings`` (``utils.trace.stage``): ``driver.sample``
(``sort_by_key``'s key sampling and range bounds, ``sample_s``),
``driver.map_stage`` and ``driver.reduce_stage`` (``map_stage_s``,
``reduce_stage_s``, wall seconds) and ``driver.cleanup``
(``cleanup_s``); each task is a ``worker.task`` span of ``kind`` map or
reduce on its pool thread (``map_task_s`` / ``map_tasks``,
``reduce_task_s`` / ``reduce_tasks``).
"""

from __future__ import annotations

import itertools
import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, List, Optional, Sequence, Tuple

from s3shuffle_tpu_torch.aggregator import (
    Aggregator,
    GroupingAggregator,
    fold_by_key_aggregator,
)
from s3shuffle_tpu_torch.batch import RecordBatch
from s3shuffle_tpu_torch.config import ShuffleConfig
from s3shuffle_tpu_torch.dependency import (
    HashPartitioner,
    Partitioner,
    RangePartitioner,
    ShuffleDependency,
    natural_key,
    range_bounds,
)
from s3shuffle_tpu_torch.manager import ShuffleManager
from s3shuffle_tpu_torch.serializer import Serializer
from s3shuffle_tpu_torch.utils import trace

logger = logging.getLogger("s3shuffle_tpu_torch.shuffle")


class ShuffleContext:
    def __init__(
        self,
        config: Optional[ShuffleConfig] = None,
        manager: Optional[ShuffleManager] = None,
        num_workers: int = 2,
        device=None,
    ):
        self.manager = manager or ShuffleManager(config, device=device)
        self.num_workers = max(1, num_workers)
        self._next_shuffle_id = itertools.count()

    # ------------------------------------------------------------------
    def run_shuffle(
        self,
        input_partitions: Sequence[Iterable[Tuple[Any, Any]]],
        num_output_partitions: Optional[int] = None,
        partitioner: Optional[Partitioner] = None,
        aggregator: Optional[Aggregator] = None,
        key_ordering: Optional[Callable[[Any], Any]] = None,
        map_side_combine: bool = False,
        serializer: Optional[Serializer] = None,
        cleanup: bool = True,
        materialize: str = "records",
    ) -> List[Any]:
        """Full shuffle: map tasks write, reduce tasks read. Returns the
        materialized output partitions — lists of (k, v) tuples, or lists of
        RecordBatches when ``materialize="batches"`` (fully-columnar path)."""
        if partitioner is None:
            if num_output_partitions is None:
                raise ValueError("need num_output_partitions or partitioner")
            partitioner = HashPartitioner(num_output_partitions)
        shuffle_id = next(self._next_shuffle_id)
        dep_kwargs = dict(
            shuffle_id=shuffle_id,
            partitioner=partitioner,
            aggregator=aggregator,
            key_ordering=key_ordering,
            map_side_combine=map_side_combine,
        )
        if serializer is not None:
            dep_kwargs["serializer"] = serializer
        dep = ShuffleDependency(**dep_kwargs)
        handle = self.manager.register_shuffle(shuffle_id, dep)
        sink = self.manager.codec

        def map_task(task: Tuple[int, Iterable[Tuple[Any, Any]]]) -> None:
            map_id, records = task
            with trace.stage("worker.task", sink, "map_task_s", count="map_tasks",
                             kind="map", shuffle_id=shuffle_id, map_id=map_id):
                writer = self.manager.get_writer(handle, map_id)
                try:
                    writer.write(records)
                    writer.stop(success=True)
                except BaseException:
                    writer.stop(success=False)
                    raise

        def reduce_task(reduce_id: int):
            with trace.stage("worker.task", sink, "reduce_task_s", count="reduce_tasks",
                             kind="reduce", shuffle_id=shuffle_id, reduce_id=reduce_id):
                reader = self.manager.get_reader(handle, reduce_id, reduce_id + 1)
                if materialize == "batches":
                    return reader.read_result_batches()
                return list(reader.read())

        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            with trace.stage("driver.map_stage", sink, "map_stage_s", shuffle_id=shuffle_id):
                list(pool.map(map_task, enumerate(input_partitions)))
            # the pool's shutdown joins its threads: inside the stage, so the
            # job's stage spans leave no stretch of it uncovered
            with trace.stage("driver.reduce_stage", sink, "reduce_stage_s",
                             shuffle_id=shuffle_id):
                outputs = list(pool.map(reduce_task, range(partitioner.num_partitions)))
                pool.shutdown()
        finally:
            pool.shutdown()
        if cleanup:
            with trace.stage("driver.cleanup", sink, "cleanup_s", shuffle_id=shuffle_id):
                self.manager.unregister_shuffle(shuffle_id)
        return outputs

    # ------------------------------------------------------------------
    # The operations the reference's test suite exercises
    # (S3ShuffleManagerTest.scala:44-174).
    # ------------------------------------------------------------------
    def fold_by_key(
        self,
        input_partitions: Sequence[Iterable[Tuple[Any, Any]]],
        zero: Any,
        fn: Callable[[Any, Any], Any],
        num_partitions: int,
        map_side_combine: bool = True,
    ) -> List[Tuple[Any, Any]]:
        agg = fold_by_key_aggregator(zero, fn)
        out = self.run_shuffle(
            input_partitions,
            num_partitions,
            aggregator=agg,
            map_side_combine=map_side_combine,
        )
        return [kv for part in out for kv in part]

    def combine_by_key(
        self,
        input_partitions: Sequence[Iterable[Tuple[Any, Any]]],
        create_combiner: Callable[[Any], Any],
        merge_value: Callable[[Any, Any], Any],
        merge_combiners: Callable[[Any, Any], Any],
        num_partitions: int,
        map_side_combine: bool = True,
    ) -> List[Tuple[Any, Any]]:
        agg = Aggregator(create_combiner, merge_value, merge_combiners)
        out = self.run_shuffle(
            input_partitions,
            num_partitions,
            aggregator=agg,
            map_side_combine=map_side_combine,
        )
        return [kv for part in out for kv in part]

    def group_by_key(
        self,
        input_partitions: Sequence[Iterable[Tuple[Any, Any]]],
        num_partitions: int,
    ) -> List[Tuple[Any, List[Any]]]:
        """No map-side combine — the dependency shape of the reference's
        runWithSparkConf_noMapSideCombine test (:56-73). Uses the grouping
        fast path (dict.get + list.append per record instead of a Python
        merge call + list copy — see GroupingAggregator)."""
        agg = GroupingAggregator()
        out = self.run_shuffle(
            input_partitions, num_partitions, aggregator=agg, map_side_combine=False
        )
        return [kv for part in out for kv in part]

    def sort_by_key(
        self,
        input_partitions: Sequence[Iterable[Tuple[Any, Any]]],
        num_partitions: int,
        key_func: Optional[Callable[[Any], Any]] = None,
        serializer: Optional[Serializer] = None,
        materialize: str = "records",
        cleanup: bool = True,
    ) -> List[Any]:
        """Range-partitioned, key-ordered shuffle — the terasort shape
        (S3ShuffleManagerTest.scala:146-174). Output partition i holds keys
        ≤ partition i+1's keys; each partition is internally sorted."""
        key = key_func or natural_key
        sample: List[Any] = []
        materialized: List[Any] = []
        with trace.stage("driver.sample", self.manager.codec, "sample_s"):
            for part in input_partitions:
                if isinstance(part, RecordBatch):
                    # Columnar input: sample every step-th key without
                    # expanding the batch into per-record tuples.
                    materialized.append(part)
                    ko = part.koffsets
                    step = max(1, part.n // 64)
                    sample.extend(
                        key(part.keys[ko[i] : ko[i + 1]].tobytes())
                        for i in range(0, part.n, step)
                    )
                    continue
                p = list(part)
                materialized.append(p)
                sample.extend(key(k) for k, _v in p[:: max(1, len(p) // 64)])
            # bounds hold mapped keys; the partitioner maps raw keys with the
            # same key_func before bisecting.
            bounds = range_bounds(sample, num_partitions)
            part_fn = RangePartitioner(bounds, key_func=key)
        return self.run_shuffle(
            materialized,
            partitioner=part_fn,
            key_ordering=key,
            serializer=serializer,
            materialize=materialize,
            cleanup=cleanup,
        )

    # ------------------------------------------------------------------
    def mesh_shuffle(
        self,
        input_batches: Sequence[Any],
        num_output_partitions: Optional[int] = None,
        partitioner: Optional[Partitioner] = None,
        cleanup: bool = True,
    ) -> Tuple[List[List[Tuple[bytes, bytes]]], bool]:
        """Columnar shuffle that rides the multi-GPU plane when it is armed.

        ``input_batches`` is one RecordBatch per map task. With
        ``mesh_devices >= 2``, at least two local devices of the manager's
        device type and uniform key/value widths, rows route to their owner
        lanes (``parallel/ici_shuffle.py``; the map batches go to the lanes
        round-robin) and each lane commits its partitions through the write
        plane. Ragged widths or a disarmed plane (``mesh_devices`` 0/1, the
        default, or one device) take the store path: one writer per input
        batch, op for op what :meth:`run_shuffle`'s map tasks issue.

        Returns ``(partitions, used_mesh)``: the materialized output
        partitions as lists of ``(key, value)`` tuples, and which path
        committed them."""
        from s3shuffle_tpu_torch.parallel import dispatch

        if partitioner is None:
            if num_output_partitions is None:
                raise ValueError("need num_output_partitions or partitioner")
            partitioner = HashPartitioner(num_output_partitions)
        shuffle_id = next(self._next_shuffle_id)

        width = 0
        requested = dispatch.requested_devices()
        if requested >= 2:
            devices = dispatch.local_devices(self.manager.device.type)
            width = min(requested, len(devices))

        handle = None
        used_mesh = False
        if width >= 2:
            widths = _uniform_widths(input_batches)
            if widths is None:
                logger.warning(
                    "mesh route declined (ragged key/value widths); falling back to host path"
                )
            else:
                from s3shuffle_tpu_torch.parallel.ici_shuffle import mesh_shuffle_or_fallback
                from s3shuffle_tpu_torch.parallel.mesh import make_mesh

                mesh = make_mesh({"data": width}, devices=devices[:width])
                # one lane per device: round-robin the map batches onto lanes
                lanes = [
                    RecordBatch.concat(
                        [b for i, b in enumerate(input_batches) if i % width == d]
                        or [RecordBatch.empty()]
                    )
                    for d in range(width)
                ]
                handle, _per_dev, used_mesh = mesh_shuffle_or_fallback(
                    mesh, lanes, self.manager, partitioner, widths[0], widths[1],
                    shuffle_id=shuffle_id,
                )

        if handle is None:
            dep = ShuffleDependency(shuffle_id=shuffle_id, partitioner=partitioner)
            handle = self.manager.register_shuffle(shuffle_id, dep)
            for map_id, batch in enumerate(input_batches):
                writer = self.manager.get_writer(handle, map_id)
                try:
                    writer.write(batch)
                    writer.stop(success=True)
                except BaseException:
                    writer.stop(success=False)
                    raise

        outputs: List[List[Tuple[bytes, bytes]]] = []
        for p in range(partitioner.num_partitions):
            reader = self.manager.get_reader(handle, p, p + 1)
            outputs.append(list(reader.read()))
        if cleanup:
            self.manager.unregister_shuffle(shuffle_id)
        return outputs, used_mesh

    # ------------------------------------------------------------------
    def stop(self) -> None:
        self.manager.stop()

    def __enter__(self) -> "ShuffleContext":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()



def _uniform_widths(batches: Sequence[Any]) -> Optional[Tuple[int, int]]:
    """(key_bytes, value_bytes) when every record across ``batches`` shares
    one fixed key width and one fixed value width (the mesh route's
    static-shape contract), else None."""
    kw = vw = None
    for b in batches:
        if b.n == 0:
            continue
        if not (b.klens == b.klens[0]).all() or not (b.vlens == b.vlens[0]).all():
            return None
        if kw is None:
            kw, vw = int(b.klens[0]), int(b.vlens[0])
        elif (int(b.klens[0]), int(b.vlens[0])) != (kw, vw):
            return None
    if kw is None:
        return None
    return kw, vw
