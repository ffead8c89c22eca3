"""Per-shuffle statistics reports (the JAX package's ``metrics/stats.py``):
the machine-readable successor of the reference's per-task stats log lines.

The write plane reports at **map commit**
(:meth:`ShuffleStatsCollector.record_map`), the read plane at **reduce
completion** (:meth:`ShuffleStatsCollector.record_reduce`), and the
per-shuffle aggregate, a :class:`ShuffleStats` dataclass, serializes to
JSON with the process metric-registry snapshot attached
(``tools/trace_report.py`` renders it).

Every recorded task entry also lands in a bounded **outbox**, which a
worker drains after each task and pushes to the coordinator's tracker
(:meth:`~s3shuffle_tpu_torch.metadata.map_output.MapOutputTracker.report_task_stats`
folds entries in with :meth:`ShuffleStatsCollector.merge`). The port has
no worker yet, so nothing drains it in-process; the deque bound keeps it
small.

Everything is gated on :func:`registry.enabled`: with metrics off,
recording is a no-op and no state accumulates.

Set ``S3SHUFFLE_STATS=<path>`` to turn the registry on and write every
shuffle's report there as JSON at process exit (``{"shuffles": [...]}``).
"""

from __future__ import annotations

import atexit
import dataclasses
import json
import os
import threading
from collections import deque
from typing import Dict, List, Optional

from s3shuffle_tpu_torch.metrics import registry


@dataclasses.dataclass
class TaskStats:
    """One map or reduce task's contribution, recorded at commit/completion."""

    kind: str  # "map" | "reduce"
    shuffle_id: int
    task_id: int  # map_id, or the reduce start partition
    bytes: int = 0
    records: int = 0
    seconds: float = 0.0  # map: commit wall; reduce: prefetch wall
    spills: int = 0
    wait_seconds: float = 0.0  # reduce only: consumer wait
    threads: int = 0  # reduce only: max prefetch threads observed
    #: collector token that first aggregated this entry — lets a coordinator
    #: sharing the process with its workers skip re-merging entries it
    #: already counted at record time
    origin: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TaskStats":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


@dataclasses.dataclass
class ShuffleStats:
    """Aggregate over one shuffle's recorded tasks (dataclass → JSON)."""

    shuffle_id: int
    map_tasks: int = 0
    reduce_tasks: int = 0
    bytes_written: int = 0
    bytes_read: int = 0
    records_written: int = 0
    records_read: int = 0
    write_seconds: float = 0.0
    spills: int = 0
    read_wait_seconds: float = 0.0
    read_prefetch_seconds: float = 0.0
    max_prefetch_threads: int = 0
    #: process metric-registry snapshot (histograms/gauges/counters) attached
    #: at report time — the latency distributions behind the scalar totals
    metrics: Dict = dataclasses.field(default_factory=dict)

    def add(self, ts: TaskStats) -> None:
        if ts.kind == "map":
            self.map_tasks += 1
            self.bytes_written += ts.bytes
            self.records_written += ts.records
            self.write_seconds += ts.seconds
            self.spills += ts.spills
        else:
            self.reduce_tasks += 1
            self.bytes_read += ts.bytes
            self.records_read += ts.records
            self.read_prefetch_seconds += ts.seconds
            self.read_wait_seconds += ts.wait_seconds
            self.max_prefetch_threads = max(self.max_prefetch_threads, ts.threads)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, **kwargs) -> str:
        return json.dumps(self.to_dict(), **kwargs)

    @classmethod
    def from_dict(cls, d: dict) -> "ShuffleStats":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    @classmethod
    def from_json(cls, s: str) -> "ShuffleStats":
        return cls.from_dict(json.loads(s))


class ShuffleStatsCollector:
    """Thread-safe per-shuffle aggregation + the worker push outbox."""

    #: outbox bound: entries awaiting a worker push; local-mode runs never
    #: drain it, so it must not grow with job length
    OUTBOX_MAX = 1024
    #: per-shuffle aggregate bound: a long-lived session cycling through
    #: shuffles keeps at most this many recent aggregates (insertion-order
    #: eviction). Coordinators additionally drop eagerly at
    #: unregister_shuffle; this is the backstop for everything else.
    SHUFFLES_MAX = 512

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._per_shuffle: Dict[int, ShuffleStats] = {}
        self._outbox: deque = deque(maxlen=self.OUTBOX_MAX)
        self._token = f"{os.getpid()}-{id(self):x}"

    def _agg_locked(self, shuffle_id: int) -> ShuffleStats:
        """Under the lock: get-or-create one shuffle's aggregate, evicting
        the OLDEST aggregates past SHUFFLES_MAX (dict preserves insertion
        order) so session memory stays bounded across unbounded shuffles."""
        agg = self._per_shuffle.get(shuffle_id)
        if agg is None:
            while len(self._per_shuffle) >= self.SHUFFLES_MAX:
                self._per_shuffle.pop(next(iter(self._per_shuffle)))
            agg = self._per_shuffle[shuffle_id] = ShuffleStats(shuffle_id)
        return agg

    # -- recording (data-plane hooks) ----------------------------------
    def record(self, ts: TaskStats) -> None:
        if not registry.enabled():
            return
        ts.origin = self._token
        with self._lock:
            self._agg_locked(ts.shuffle_id).add(ts)
            self._outbox.append(ts.to_dict())

    def record_map(
        self,
        shuffle_id: int,
        map_id: int,
        bytes: int,
        records: int,
        seconds: float,
        spills: int = 0,
    ) -> None:
        self.record(TaskStats("map", shuffle_id, map_id, bytes, records, seconds, spills))

    def record_reduce(
        self,
        shuffle_id: int,
        partition: int,
        bytes: int,
        records: int,
        prefetch_seconds: float,
        wait_seconds: float,
        threads: int = 0,
    ) -> None:
        self.record(
            TaskStats(
                "reduce", shuffle_id, partition, bytes, records,
                prefetch_seconds, wait_seconds=wait_seconds, threads=threads,
            )
        )

    # -- remote aggregation (metadata service) -------------------------
    def merge(self, entry: dict) -> None:
        """Fold a remotely-reported task entry into the aggregate WITHOUT
        re-enqueueing it (the coordinator must not bounce entries back).
        Entries this collector itself recorded are skipped — a coordinator
        whose workers share its process already counted them."""
        if not registry.enabled():
            return
        ts = TaskStats.from_dict(entry)
        if ts.origin == self._token:
            return
        with self._lock:
            self._agg_locked(ts.shuffle_id).add(ts)

    def drain_outbox(self) -> List[dict]:
        with self._lock:
            out = list(self._outbox)
            self._outbox.clear()
        return out

    # -- reports -------------------------------------------------------
    def report(
        self, shuffle_id: int, include_metrics: bool = True
    ) -> Optional[ShuffleStats]:
        """The shuffle's aggregate (copy), with the current registry snapshot
        attached. None if nothing was recorded for it."""
        with self._lock:
            agg = self._per_shuffle.get(shuffle_id)
            if agg is None:
                return None
            out = dataclasses.replace(agg)
        if include_metrics:
            out.metrics = registry.REGISTRY.snapshot(compact=True)
        return out

    def reports(self, include_metrics: bool = True) -> List[ShuffleStats]:
        with self._lock:
            ids = sorted(self._per_shuffle)
        return [r for sid in ids if (r := self.report(sid, include_metrics))]

    def shuffle_ids(self) -> List[int]:
        with self._lock:
            return sorted(self._per_shuffle)

    def dump(self, path: str) -> None:
        """Write ``{"shuffles": [report, ...]}`` as JSON."""
        reports = self.reports()
        with open(path, "w") as f:
            json.dump({"shuffles": [r.to_dict() for r in reports]}, f)

    def drop(self, shuffle_id: int) -> None:
        """Forget one shuffle's aggregate — wired into tracker
        ``unregister_shuffle`` so long-lived sessions don't accumulate stats
        for shuffles that no longer exist. The outbox is left alone: entries
        already drained to a coordinator stay counted there, and un-drained
        local entries age out via the deque bound."""
        with self._lock:
            self._per_shuffle.pop(shuffle_id, None)

    def reset(self) -> None:
        with self._lock:
            self._per_shuffle.clear()
            self._outbox.clear()


#: process-default collector — data-plane hooks and trackers all use this
COLLECTOR = ShuffleStatsCollector()


def _maybe_dump_from_env() -> None:
    path = os.environ.get("S3SHUFFLE_STATS")
    if not path:
        return
    registry.enable()

    def _dump() -> None:
        try:
            if COLLECTOR.shuffle_ids():
                COLLECTOR.dump(path)
        except OSError:
            pass

    atexit.register(_dump)


_maybe_dump_from_env()
