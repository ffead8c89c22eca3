"""Skew mitigation plane: the wire bits and hot-object signals its three
prongs share (the JAX package's ``skew.py``).

A few fat partitions absorb most bytes under key skew, and hot reducers
serialize on single fat objects. Each prong has its own knob and is off by
default (0 keeps the request pattern and the objects op for op):

- **map-side combine sidecars** (``combine_threshold_bytes``): partitions
  whose routed bytes cross the threshold have their chunks pre-reduced with
  the columnar combine inside the map task, so hot partitions ship partial
  aggregates (``write/spill_writer.py``). The map output is flagged
  (:data:`FLAG_COMBINED` in the skew trailer or the fat-index member row),
  and a read without an aggregator refuses it;
- **hot-partition splitting** (``split_threshold_bytes``): partition sizes
  are measured at commit; when one crosses the threshold the writer records
  a stripe granularity (this trailer, or the fat-index v3 header) and the
  scan planner fans the partition's range out as independent sub-range
  GETs (``read/scan_plan.py``);
- **coded read fan-out** (``hot_read_fanout``): when a data object already
  has that many GETs in flight in this process (tracked here), an eligible
  read reconstructs from its parity sidecars instead
  (``coding/degraded.py``).

This module owns the skew trailer of per-map ``.index`` objects (absent when
no prong engaged), the index trailer parser, the per-object in-flight GET
tracker and the plane's three counters.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from s3shuffle_tpu_torch.coding.parity import GEOMETRY_MAGIC, TRAILER_WORDS, ParityGeometry
from s3shuffle_tpu_torch.metrics import registry as _metrics

#: wire-schema binding (wire/schema.py); WIRE01 holds the constants below
#: against the registry
_WIRE_STRUCTS = ("index_skew_trailer",)

#: magic word of the skew trailer appended to a per-map ``.index`` when a
#: prong engaged at commit: ``[SKEW_MAGIC, flags, split_bytes, reserved]``
#: after the cumulative offsets and before the parity geometry trailer,
#: which stays the blob's final words
SKEW_MAGIC = 0x53335348534B4557  # "S3SHSKEW"
#: trailer width in int64 words
SKEW_TRAILER_WORDS = 4
#: flags bit 0: the map output's partitions carry map-side-combined partial
#: rows, which a read must merge through the dependency's aggregator
FLAG_COMBINED = 1

C_MAP_COMBINE_ROWS = _metrics.REGISTRY.counter(
    "shuffle_map_combine_rows_total",
    "Rows eliminated by the map-side combine sidecar (input rows minus the "
    "pre-reduced partial rows actually shipped)",
)
C_PARTITION_SPLITS = _metrics.REGISTRY.counter(
    "shuffle_partition_splits_total",
    "Partitions whose size crossed split_threshold_bytes at commit — their "
    "split fan-out is recorded in the index sidecar for read-side striping",
)
C_HOT_FANOUT_READS = _metrics.REGISTRY.counter(
    "shuffle_hot_fanout_reads_total",
    "Reads served from parity-equivalent sources because the primary data "
    "object's live GET concurrency crossed hot_read_fanout",
)


@dataclasses.dataclass(frozen=True)
class SkewInfo:
    """The skew plane's commit-time coordinates of one map output: whether
    its partitions carry map-side-combined partials, and the stripe
    granularity (bytes) the scan planner fans hot partitions out at (0 = no
    partition crossed the split threshold)."""

    combined: bool = False
    split_bytes: int = 0

    @property
    def active(self) -> bool:
        return self.combined or self.split_bytes > 0


def skew_trailer_words(skew: SkewInfo) -> np.ndarray:
    """The 4-word trailer appended to a per-map index when a prong engaged:
    ``[SKEW_MAGIC, flags, split_bytes, reserved]``."""
    flags = FLAG_COMBINED if skew.combined else 0
    return np.array([SKEW_MAGIC, flags, int(skew.split_bytes), 0], dtype=np.int64)


def split_index_trailers(
    words: np.ndarray,
) -> Tuple[np.ndarray, Optional[ParityGeometry], Optional[SkewInfo]]:
    """Split a raw index-blob int64 array into ``(offsets, geometry|None,
    skew|None)``. On the wire the order is ``offsets + [skew trailer] +
    [geometry trailer]``: the geometry trailer (when present) is the final
    four words, so it is peeled first, then the skew trailer, and the
    geometry's ``payload_len`` is the true final cumulative offset. Both
    magics lie at values no cumulative byte offset reaches (~6.0e18), so a
    blob without trailers passes through untouched."""
    geom_words = None
    if len(words) >= TRAILER_WORDS + 2 and int(words[-TRAILER_WORDS]) == GEOMETRY_MAGIC:
        geom_words = words[-TRAILER_WORDS:]
        words = words[:-TRAILER_WORDS]
    skew = None
    if len(words) >= SKEW_TRAILER_WORDS + 2 and int(words[-SKEW_TRAILER_WORDS]) == SKEW_MAGIC:
        skew = SkewInfo(combined=bool(int(words[-3]) & FLAG_COMBINED),
                        split_bytes=int(words[-2]))
        words = words[:-SKEW_TRAILER_WORDS]
    geometry = None
    if geom_words is not None:
        geometry = ParityGeometry(
            segments=int(geom_words[1]),
            stripe_k=int(geom_words[2]),
            chunk_bytes=int(geom_words[3]),
            payload_len=int(words[-1]),
        )
    return words, geometry, skew


# --- per-object GET concurrency: the hot fan-out's trigger ---

#: bound of the peak table: hot detection needs only the live counts, and
#: the peaks must not grow with every object ever read
_PEAKS_MAX = 4096


class ObjectGetTracker:
    """Live in-flight GET count per data object, fed by the prefetcher
    around every primary store GET (``read/prefetch.py``). The coded read
    fan-out reads :meth:`inflight` to decide when a hot object's next read
    goes to its parity sidecars; :meth:`peak` reports each object's highest
    GET concurrency. Process-local: the hot spot it targets (many reduce
    tasks of one process on one fat object) is visible here."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._inflight: Dict[str, int] = {}
        self._peak: Dict[str, int] = {}

    def start(self, name: str) -> None:
        with self._lock:
            live = self._inflight.get(name, 0) + 1
            self._inflight[name] = live
            if live > self._peak.get(name, 0):
                if len(self._peak) >= _PEAKS_MAX and name not in self._peak:
                    self._peak.pop(next(iter(self._peak)))
                self._peak[name] = live

    def finish(self, name: str) -> None:
        with self._lock:
            live = self._inflight.get(name, 0) - 1
            if live <= 0:
                self._inflight.pop(name, None)
            else:
                self._inflight[name] = live

    def inflight(self, name: str) -> int:
        with self._lock:
            return self._inflight.get(name, 0)

    def peak(self, name: str) -> int:
        with self._lock:
            return self._peak.get(name, 0)

    def peaks(self) -> Dict[str, int]:
        """A copy of every recorded per-object peak."""
        with self._lock:
            return dict(self._peak)

    def reset_peaks(self) -> None:
        with self._lock:
            self._peak = {}


#: the process-wide tracker (one read plane per process)
OBJECT_GETS = ObjectGetTracker()


def tracked_get(name: Optional[str], fn):
    """Run ``fn`` (a primary store GET) with the object's in-flight count
    held. Only real GETs are counted, never reads already diverted to
    parity: counting those would feed the trigger and move every read of
    the object onto the parity path. Issues no store operation itself."""
    if name is None:
        return fn()
    OBJECT_GETS.start(name)
    try:
        return fn()
    finally:
        OBJECT_GETS.finish(name)
