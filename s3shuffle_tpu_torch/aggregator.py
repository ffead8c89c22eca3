"""Reduce-side (and map-side) aggregation with bounded memory (a copy of
the JAX package's ``aggregator.py``).

Parity: the reference hands records to Spark's ``Aggregator``, whose
ExternalAppendOnlyMap spills hash-sorted runs to disk when the tracked
memory estimate exceeds its budget and merges them at iteration time
(combineValuesByKey / combineCombinersByKey — S3ShuffleReader.scala:124-138).
Same design here: an in-memory dict of combiners with a byte estimate;
over budget, the dict is written out as one run sorted by key hash; the
result iterator heap-merges all runs plus the resident dict, grouping by
hash and resolving hash collisions by exact key equality within each
(small) group.
"""

from __future__ import annotations

import heapq
import itertools
import os
import functools
import pickle
import sys
import tempfile
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

from s3shuffle_tpu_torch.sorter import estimate_record_bytes
from s3shuffle_tpu_torch.utils import gc_paused


class Aggregator:
    #: True when the combine is expressible as per-column vectorized
    #: reductions: the read plane and the map-side combine then run the
    #: columnar ColumnarReducer instead of this per-record dict machinery
    #: (colagg.ColumnarAggregator sets it)
    supports_columnar = False

    def __init__(
        self,
        create_combiner: Callable[[Any], Any],
        merge_value: Callable[[Any, Any], Any],
        merge_combiners: Callable[[Any, Any], Any],
        spill_bytes: int = 256 * 1024 * 1024,
        spill_dir: Optional[str] = None,
    ):
        self.create_combiner = create_combiner
        self.merge_value = merge_value
        self.merge_combiners = merge_combiners
        self.spill_bytes = max(1, spill_bytes)
        self.spill_dir = spill_dir
        #: diagnostic: spill-file count across all combines served by this
        #: aggregator (an aggregator may serve several reduce tasks)
        self.spill_count = 0

    def combine_values_by_key(
        self,
        records: Iterable[Tuple[Any, Any]],
        spill_bytes: Optional[int] = None,
    ) -> Iterator[Tuple[Any, Any]]:
        """Used when the map side did NOT pre-combine.

        LAZY: returns a generator — no input is consumed, no combining runs,
        and no spill files are created (or cleaned) until the result is
        iterated."""
        return self._combine(records, self.create_combiner, self.merge_value, spill_bytes)

    def combine_combiners_by_key(
        self,
        records: Iterable[Tuple[Any, Any]],
        spill_bytes: Optional[int] = None,
    ) -> Iterator[Tuple[Any, Any]]:
        """Used when map-side combine already produced combiners.

        LAZY: returns a generator — see :meth:`combine_values_by_key`."""
        return self._combine(
            records, lambda c: c, self.merge_combiners, spill_bytes
        )

    # ------------------------------------------------------------------

    def _combine(
        self,
        records: Iterable[Tuple[Any, Any]],
        create: Callable[[Any], Any],
        merge: Callable[[Any, Any], Any],
        spill_bytes: Optional[int],
    ) -> Iterator[Tuple[Any, Any]]:
        budget = self.spill_bytes if spill_bytes is None else max(1, spill_bytes)
        combiners: Dict[Any, Any] = {}
        estimate = 0
        spills: List[str] = []
        merge_tick = 0
        try:
            # cyclic-GC pause for the bulk build: the generational collector
            # re-traverses every tracked container per collection
            # (refcounting still frees promptly)
            with gc_paused:
                for k, v in records:
                    if k in combiners:
                        merge_tick += 1
                        if merge_tick & 63:
                            combiners[k] = merge(combiners[k], v)
                            continue
                        # Sampled growth accounting (1-in-64 merges, scaled
                        # up — the codebase's amortize-the-budget-check
                        # pattern, cf. spill_writer's check_every):
                        # replace-style combiners (sum/count) show ~zero
                        # shallow growth and never spill on input volume;
                        # container combiners additionally retain the merged
                        # value, so its shallow size is charged too. Deeply
                        # nested growth is under-counted — like Spark's
                        # SizeEstimator sampling, the bound is approximate.
                        old = combiners[k]
                        before = sys.getsizeof(old)
                        new = merge(old, v)
                        combiners[k] = new
                        growth = max(0, sys.getsizeof(new) - before)
                        if isinstance(new, (list, tuple, set, dict)):
                            growth += sys.getsizeof(v)
                        estimate += growth * 64
                    else:
                        combiners[k] = create(v)
                        estimate += estimate_record_bytes((k, combiners[k]))
                    if estimate >= budget:
                        spills.append(self._spill(combiners))
                        self.spill_count += 1
                        combiners = {}
                        estimate = 0
                        gc_paused.tick()
            if not spills:
                yield from combiners.items()
                return
            yield from self._merge_runs(spills, combiners)
        finally:
            for path in spills:
                try:
                    os.remove(path)
                except OSError:
                    pass

    def _merge_runs(self, spills: List[str], combiners: Dict[Any, Any]):
        """Merge hash-sorted spill runs with the resident combiners — shared
        by the generic and grouping combine paths."""
        runs = [self._iter_spill(p) for p in spills]
        resident = sorted(
            ((hash(k), k, c) for k, c in combiners.items()),
            key=lambda row: row[0],
        )
        runs.append(iter(resident))
        merged = heapq.merge(*runs, key=lambda row: row[0])
        for _h, group in itertools.groupby(merged, key=lambda row: row[0]):
            # combiners sharing a hash: resolve true key equality within
            # the (tiny) group — hash collisions stay correct
            bucket: Dict[Any, Any] = {}
            for _hh, k, c in group:
                bucket[k] = (
                    self.merge_combiners(bucket[k], c) if k in bucket else c
                )
            yield from bucket.items()

    def _spill(self, combiners: Dict[Any, Any]) -> str:
        rows = sorted(
            ((hash(k), k, c) for k, c in combiners.items()), key=lambda row: row[0]
        )
        fd, path = tempfile.mkstemp(prefix="s3shuffle-agg-spill-", dir=self.spill_dir)
        with os.fdopen(fd, "wb") as f:
            # chunked dumps: one pickle per 4096 rows, not per row — spill
            # cycles at scale were dominated by per-row dump/load calls
            for i in range(0, len(rows), 4096):
                pickle.dump(rows[i : i + 4096], f, protocol=pickle.HIGHEST_PROTOCOL)
        return path

    @staticmethod
    def _iter_spill(path: str) -> Iterator[Tuple[int, Any, Any]]:
        with open(path, "rb") as f:
            while True:
                try:
                    yield from pickle.load(f)
                except EOFError:
                    return


def _singleton_list(v: Any) -> list:
    return [v]


def fold_by_key_aggregator(zero: Any, fn: Callable[[Any, Any], Any]) -> Aggregator:
    # functools.partial, NOT a closure lambda: the aggregator stays picklable
    # whenever the caller's ``fn``/``zero`` are.
    return Aggregator(
        create_combiner=functools.partial(fn, zero),
        merge_value=fn,
        merge_combiners=fn,
    )


class GroupingAggregator(Aggregator):
    """Group-by-key specialization: combiners are plain value lists.

    The generic :meth:`Aggregator._combine` pays, per record, a dict lookup +
    a Python ``merge`` call + (for the naive ``acc + [v]`` combiner) a full
    list copy + sampled ``sys.getsizeof`` accounting. This fast path is ``dict.get`` +
    ``list.append`` with the same 1-in-64 sampled byte budget, and reuses the
    base class's hash-sorted spill-run merge unchanged (list combiners
    concatenate). Semantics identical: per-key value lists, insertion-stable
    within one combine, spills beyond the byte budget."""

    def __init__(self, spill_bytes: int = 256 * 1024 * 1024,
                 spill_dir: Optional[str] = None):
        super().__init__(
            create_combiner=_singleton_list,  # module-level: must pickle
            merge_value=_append_value,
            merge_combiners=_concat_lists,
            spill_bytes=spill_bytes,
            spill_dir=spill_dir,
        )

    def combine_values_by_key(
        self,
        records: Iterable[Tuple[Any, Any]],
        spill_bytes: Optional[int] = None,
    ) -> Iterator[Tuple[Any, Any]]:
        """LAZY, like the base class: nothing runs until iteration."""
        return self._combine_grouping(records, spill_bytes)

    def _combine_grouping(self, records, spill_bytes):
        budget = self.spill_bytes if spill_bytes is None else max(1, spill_bytes)
        combiners: Dict[Any, list] = {}
        estimate = 0
        spills: List[str] = []
        tick = 0
        new_tick = 0
        # running per-new-key cost, sampled 1-in-32: measuring every new key
        # (7 getsizeof calls for tuple records) is costly when most keys are
        # unique
        new_cost = 160
        get = combiners.get
        try:
            with gc_paused:  # see _combine
                for k, v in records:
                    lst = get(k)
                    if lst is None:
                        combiners[k] = [v]
                        new_tick += 1
                        if not new_tick & 31:
                            new_cost = (
                                new_cost + estimate_record_bytes((k, v)) + 64
                            ) >> 1
                        estimate += new_cost
                    else:
                        lst.append(v)
                        tick += 1
                        if not tick & 63:  # sampled growth, scaled up
                            estimate += (sys.getsizeof(v) + 8) * 64
                    if estimate >= budget:
                        spills.append(self._spill(combiners))
                        self.spill_count += 1
                        combiners = {}
                        get = combiners.get
                        estimate = 0
                        gc_paused.tick()
            if not spills:
                yield from combiners.items()
                return
            # merge_combiners is list-extend, so the base merge tail applies
            yield from self._merge_runs(spills, combiners)
        finally:
            for path in spills:
                try:
                    os.remove(path)
                except OSError:
                    pass


def _append_value(acc: list, v: Any) -> list:
    acc.append(v)
    return acc


def _concat_lists(a: list, b: list) -> list:
    a.extend(b)
    return a
