"""Recompute or reconstruct: recovery of committed map outputs lost with
their worker (the JAX package's ``recovery.py``).

When a worker dies, the lease machinery (``metadata/service.py``) requeues
its running tasks. A map it had already COMMITTED may have lost its
objects with it (fallback or local storage, a decommissioned node's disk).
There are two ways back, of very different cost ("Leveraging Coding
Techniques for Speeding up Distributed Computing", PAPERS.md):

- **reconstruct**: leave the tracker alone; the coded plane's degraded
  reads (``coding/degraded.py``) rebuild the lost bytes from the parity
  sidecars as reduce scans need them, with kernel K4 on the card. It costs
  about ``lost_bytes`` of extra GETs and no re-execution, and it is only
  possible when the parity covers a whole object (``m >= k``) and the
  index, which carries the geometry trailer, survived;
- **recompute**: run the map task again from its staged input (the driver
  keeps the inputs for the job's life) and register the new attempt. It
  costs one map task and is always possible.

:class:`RecoveryPlanner` decides per lost map from the evidence the fleet
reported (the coordinator's aggregated ShuffleStats: bytes and seconds
seen), and recomputes whenever the parity cannot determine the loss.
Decisions count in ``recovery_decisions_total{choice}`` while the metrics
registry is on. This module launches no kernel.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional

from s3shuffle_tpu_torch.metrics import registry as _metrics

logger = logging.getLogger("s3shuffle_tpu_torch.recovery")

_C_DECISIONS = _metrics.REGISTRY.counter(
    "recovery_decisions_total",
    "Lost-map recovery decisions taken by the driver, by chosen strategy",
    labelnames=("choice",),
)

#: the prefix of every task failure that is a lost map output, so the driver
#: tells a recoverable fetch failure from a task's own fault (Spark's
#: FetchFailed against ExceptionFailure); ``worker.MapOutputLostError``
#: carries it
MAP_OUTPUT_LOST_MARKER = "MapOutputLost"


@dataclasses.dataclass
class LostMap:
    """One committed map output whose store objects are (partly) gone."""

    shuffle_id: int
    map_id: int  # the attempt-unique id it was registered under
    map_index: int  # the logical map (the task to recompute)
    lost_bytes: int
    parity_segments: int  # sidecars still present (0 = none or uncoded)
    composite_group: int  # -1 = a singleton layout
    index_present: bool  # the geometry lives in the index or fat index


def decision_evidence(stats: Optional[dict]) -> dict:
    """The rates a decision needs, from one coordinator-side ShuffleStats
    report (``get_shuffle_stats``); a missing or zero field gives 0.0,
    which the planner reads as no evidence."""
    stats = stats or {}

    def rate(byte_key: str, sec_key: str) -> float:
        b, s = float(stats.get(byte_key) or 0.0), float(stats.get(sec_key) or 0.0)
        return b / s if b > 0 and s > 0 else 0.0

    map_tasks = float(stats.get("map_tasks") or 0.0)
    write_s = float(stats.get("write_seconds") or 0.0)
    return {
        # the reduce side's fill rate: what the parity GETs will run at
        "read_bytes_per_s": rate("bytes_read", "read_prefetch_seconds"),
        # the map side's commit rate: what a recompute pays
        "write_bytes_per_s": rate("bytes_written", "write_seconds"),
        # the mean map task's wall, the least a recompute costs
        "map_task_wall_s": write_s / map_tasks if map_tasks > 0 else 0.0,
    }


class RecoveryPlanner:
    """Recompute or reconstruct, by structure first and cost second.

    Reconstruction is possible only when the surviving parity covers a
    whole object (``m >= k``) and the index survived; otherwise the answer
    is recompute whatever the cost. Where both are possible the planner
    compares

    - ``reconstruct ~ RECONSTRUCT_OVERHEAD * lost_bytes / read_bytes_per_s``
      (per-group ranged GETs on reduce tasks' critical paths and a GF
      decode), with
    - ``recompute ~ max(map_task_wall_s, lost_bytes / write_bytes_per_s) +
      lost_bytes / read_bytes_per_s`` (run the map again and read its
      staged input again, at the read rate).

    With no evidence it reconstructs: no re-execution, no task attempt
    spent.
    """

    #: degraded reads move the bytes of a plain read in per-group round
    #: trips with a GF decode: a conservative 2×
    RECONSTRUCT_OVERHEAD = 2.0

    def __init__(self, stripe_k: int = 1):
        self.stripe_k = max(1, int(stripe_k))

    def decide(self, lost: LostMap, stats: Optional[dict] = None) -> str:
        """``"reconstruct"`` or ``"recompute"`` for one lost map."""
        choice = self._decide(lost, stats)
        if _metrics.enabled():
            _C_DECISIONS.labels(choice=choice).inc()
        logger.warning(
            "recovery decision for shuffle %d map %d (map_index %d, %d bytes "
            "lost, m=%d/k=%d): %s",
            lost.shuffle_id, lost.map_id, lost.map_index, lost.lost_bytes,
            lost.parity_segments, self.stripe_k, choice,
        )
        return choice

    def _decide(self, lost: LostMap, stats: Optional[dict]) -> str:
        if lost.parity_segments < self.stripe_k or lost.parity_segments <= 0:
            return "recompute"
        if not lost.index_present:
            return "recompute"  # the geometry trailer went with the index
        ev = decision_evidence(stats)
        read_rate = ev["read_bytes_per_s"]
        if read_rate <= 0.0:
            return "reconstruct"
        reconstruct_cost = self.RECONSTRUCT_OVERHEAD * lost.lost_bytes / read_rate
        write_rate = ev["write_bytes_per_s"]
        recompute_cost = ev["map_task_wall_s"]
        if write_rate > 0.0:
            recompute_cost = max(recompute_cost, lost.lost_bytes / write_rate)
        recompute_cost += lost.lost_bytes / read_rate
        return "reconstruct" if reconstruct_cost <= recompute_cost else "recompute"


def probe_lost_maps(dispatcher, tracker, shuffle_id: int, map_indices=None) -> List[LostMap]:
    """The committed map outputs of a shuffle whose objects are gone.

    ``tracker`` is the coordinator's own tracker (the driver holds it);
    ``map_indices`` narrows the probe to a dead worker's maps, else every
    registered map is probed. The FileStatus cache is cleared first, so a
    cached status cannot hide a loss. A store error on a probe reads as
    "present": the probe feeds recomputes, which spend task attempts.
    """
    from s3shuffle_tpu_torch.block_ids import (
        ShuffleCompositeDataBlockId,
        ShuffleCompositeParityBlockId,
        ShuffleDataBlockId,
        ShuffleFatIndexBlockId,
        ShuffleIndexBlockId,
        ShuffleParityBlockId,
    )

    def _exists(block) -> bool:
        try:
            return bool(dispatcher.backend.exists(dispatcher.get_path(block)))
        except OSError:
            return True

    dispatcher.clear_status_cache()
    wanted = None if map_indices is None else {int(m) for m in map_indices}
    lost: List[LostMap] = []
    for map_index, status in tracker.deduped_statuses(shuffle_id):
        if wanted is not None and map_index not in wanted:
            continue
        if status.composite_group >= 0:
            data_block = ShuffleCompositeDataBlockId(shuffle_id, status.composite_group)
            index_block = ShuffleFatIndexBlockId(shuffle_id, status.composite_group)
        else:
            data_block = ShuffleDataBlockId(shuffle_id, status.map_id)
            index_block = ShuffleIndexBlockId(shuffle_id, status.map_id)
        data_ok = _exists(data_block)
        index_ok = _exists(index_block)
        # either half gone is a loss: a scan needs the offsets and geometry
        # as much as the bytes
        if data_ok and index_ok:
            continue
        # the sidecars may have gone with the data: count those that remain,
        # so the planner's gate sends an underdetermined loss to recompute
        committed_m = int(getattr(status, "parity_segments", 0))
        surviving_m = 0
        for seg in range(committed_m):
            if status.composite_group >= 0:
                par_block = ShuffleCompositeParityBlockId(
                    shuffle_id, status.composite_group, seg
                )
            else:
                par_block = ShuffleParityBlockId(shuffle_id, status.map_id, seg)
            if _exists(par_block):
                surviving_m += 1
        lost.append(
            LostMap(
                shuffle_id=shuffle_id,
                map_id=int(status.map_id),
                map_index=int(map_index),
                lost_bytes=int(sum(int(n) for n in status.sizes)),
                parity_segments=surviving_m,
                composite_group=int(status.composite_group),
                index_present=index_ok,
            )
        )
    return lost
