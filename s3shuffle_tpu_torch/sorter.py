"""External sorter: key-ordered output with bounded memory (a copy of the
JAX package's ``sorter.py``).

Parity: the reference defers key ordering to Spark's ``ExternalSorter``
(S3ShuffleReader.scala:141-149) — in-memory sort with spill-to-disk runs
merged at iteration time, spilling on a tracked *byte* budget, not a record
count. Same design here: accumulate records, estimate their in-memory
footprint, spill sorted runs to local temp files when the byte budget is
exceeded, then ``heapq.merge`` the runs. A record-count cap remains as a
secondary bound for workloads of many tiny records.
"""

from __future__ import annotations

import heapq
import os
import pickle
import sys
import tempfile
from typing import Any, Callable, Iterable, Iterator, List, Optional, Tuple


def estimate_record_bytes(kv: Tuple[Any, Any]) -> int:
    """Approximate in-memory footprint of one (key, value) record.

    ``sys.getsizeof`` of the tuple and both elements, descending one level
    into list/tuple containers (the common generic-record shapes). Like
    Spark's SizeEstimator this is an estimate, not an exact bound — deeply
    nested values are under-counted, which only makes spills later, never
    incorrect.
    """
    total = sys.getsizeof(kv)
    for obj in kv:
        total += sys.getsizeof(obj)
        if isinstance(obj, (tuple, list)):
            for item in obj:
                total += sys.getsizeof(item)
    return total


class ExternalSorter:
    def __init__(
        self,
        key_func: Optional[Callable[[Any], Any]] = None,
        spill_bytes: int = 256 * 1024 * 1024,
        spill_threshold: int = 1_000_000,
        spill_dir: Optional[str] = None,
    ):
        self._key = key_func or (lambda k: k)
        self._spill_bytes = max(1, spill_bytes)
        self._spill_threshold = max(1, spill_threshold)
        self._spill_dir = spill_dir
        self._records: List[Tuple[Any, Any]] = []
        self._bytes = 0
        self._tick = 0
        self._spills: List[str] = []
        self.spill_count = 0

    #: estimate 1-in-N records and scale once the resident run is large —
    #: the per-record getsizeof walk would dominate on many-tiny-record
    #: sorts (cf. aggregator.py's 1-in-64 merge sampling). Small runs estimate every record so a
    #: handful of huge values still trips the budget promptly.
    _SAMPLE = 16
    _EXACT_BELOW = 64

    def insert_all(self, records: Iterable[Tuple[Any, Any]]) -> None:
        from s3shuffle_tpu_torch.utils import gc_paused

        # the sampling tick is INSTANCE state: callers feed records in many
        # small insert_all calls (one per shuffle batch), and
        # a per-call counter would never reach the sampling stride again
        # after the exact-estimation window, freezing the byte accounting
        with gc_paused:  # bulk acyclic build — cf. aggregator._combine
            for kv in records:
                self._records.append(kv)
                self._tick += 1
                if len(self._records) <= self._EXACT_BELOW:
                    self._bytes += estimate_record_bytes(kv)
                elif self._tick & (self._SAMPLE - 1) == 0:
                    self._bytes += estimate_record_bytes(kv) * self._SAMPLE
                if (
                    self._bytes >= self._spill_bytes
                    or len(self._records) >= self._spill_threshold
                ):
                    self._spill()

    def insert_batch(self, batch) -> None:
        """Insert a columnar RecordBatch's records in one pass: the byte
        estimate comes from the batch's own ``nbytes`` (plus a flat per-tuple
        object overhead) instead of the per-record ``getsizeof`` sampling
        walk, since the batch's size is already known exactly."""
        from s3shuffle_tpu_torch.utils import gc_paused

        n = batch.n
        if n == 0:
            return
        with gc_paused:  # bulk acyclic build — cf. insert_all
            self._records.extend(batch.iter_records())
        # ~3 PyObject headers + tuple slots per record beyond the raw bytes
        self._bytes += batch.nbytes + 120 * n
        self._tick += n
        if (
            self._bytes >= self._spill_bytes
            or len(self._records) >= self._spill_threshold
        ):
            self._spill()

    @property
    def memory_bytes(self) -> int:
        """Estimated bytes currently held in memory (pre-spill)."""
        return self._bytes

    def _spill(self) -> None:
        self._records.sort(key=lambda kv: self._key(kv[0]))
        fd, path = tempfile.mkstemp(prefix="s3shuffle-spill-", dir=self._spill_dir)
        with os.fdopen(fd, "wb") as f:
            # chunked dumps, like the aggregator's spill plane: per-row
            # dump/load calls dominated spill cycles at scale
            for i in range(0, len(self._records), 4096):
                pickle.dump(
                    self._records[i : i + 4096], f,
                    protocol=pickle.HIGHEST_PROTOCOL,
                )
        self._spills.append(path)
        self.spill_count += 1
        self._records = []
        self._bytes = 0

    def _iter_spill(self, path: str) -> Iterator[Tuple[Any, Any]]:
        with open(path, "rb") as f:
            while True:
                try:
                    yield from pickle.load(f)
                except EOFError:
                    return

    def sorted_iterator(self) -> Iterator[Tuple[Any, Any]]:
        self._records.sort(key=lambda kv: self._key(kv[0]))
        try:
            if not self._spills:
                yield from self._records
                return
            runs = [self._iter_spill(p) for p in self._spills]
            runs.append(iter(self._records))
            yield from heapq.merge(*runs, key=lambda kv: self._key(kv[0]))
        finally:
            self.cleanup()

    def cleanup(self) -> None:
        for path in self._spills:
            try:
                os.remove(path)
            except OSError:
                pass
        self._spills = []
