"""High-level shuffle API (the JAX package's ``shuffle.py``).

The reference is driven by Spark jobs (``foldByKey``/``sortByKey``/... over a
SparkContext — S3ShuffleManagerTest.scala:176-205); :class:`ShuffleContext`
is the framework-native equivalent: it owns a manager, runs map tasks and
reduce tasks on a pool of ``num_workers`` threads (the analog of
``local[N]``), and exposes the classic shuffle operations. Its manager's
codec runs on ``device`` — the CUDA device unless ``device="cpu"``; with no
CUDA device it raises. The multi-GPU ``mesh_shuffle`` is not ported yet.
"""

from __future__ import annotations

import itertools
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

        def map_task(task: Tuple[int, Iterable[Tuple[Any, Any]]]) -> None:
            map_id, records = task
            writer = self.manager.get_writer(handle, map_id)
            try:
                writer.write(records)
                writer.stop(success=True)
            except BaseException:
                writer.stop(success=False)
                raise

        def reduce_task(reduce_id: int):
            reader = self.manager.get_reader(handle, reduce_id, reduce_id + 1)
            if materialize == "batches":
                return reader.read_result_batches()
            return list(reader.read())

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            list(pool.map(map_task, enumerate(input_partitions)))
            outputs = list(pool.map(reduce_task, range(partitioner.num_partitions)))
        if cleanup:
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
        for part in input_partitions:
            if isinstance(part, RecordBatch):
                # Columnar input: sample every step-th key without expanding
                # the batch into per-record tuples.
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
        # bounds hold mapped keys; the partitioner maps raw keys with the same
        # key_func before bisecting.
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
    def stop(self) -> None:
        self.manager.stop()

    def __enter__(self) -> "ShuffleContext":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

