"""Read- and write-side knob tuners over the live metrics registry (the
JAX package's ``tuning/tuners.py``).

The :class:`~s3shuffle_tpu_torch.storage.dispatcher.Dispatcher` builds both
when ``autotune`` is on; with it off no tuner exists and every consult site
reads the static config value, so the store sees the static request pattern
op for op.

- :class:`ScanTuner` (read side): ``fetch_parallelism``,
  ``fetch_chunk_size``, ``coalesce_gap_bytes``, the decode windows
  (``decode_batch_frames``, ``decode_inflight_batches``), the skew plane's
  ``hot_read_fanout`` and the prefetch budget (``max_buffer_size_task``,
  tuned down only). Consulted when a scan is planned
  (:func:`~s3shuffle_tpu_torch.read.scan_plan.build_scan_iterator`, the
  reader's prefetcher); fed one cost sample per completed scan.
- :class:`CommitTuner` (write side): ``upload_queue_bytes``, the composite
  seal thresholds, ``encode_inflight_batches``, ``columnar_batch_rows`` and
  the skew plane's ``combine_threshold_bytes`` / ``split_threshold_bytes``.
  Consulted at sink creation, chunking, seal checks and commits; fed one
  cost sample per map commit or group seal.

**Cost.** A sample is the unit's wall seconds per MiB. With the registry on
it is scaled by the coalesce waste share (``read_coalesce_waste_bytes_total``
over ``storage_read_bytes_total``) and the prefetch wait share
(``read_prefetch_wait_seconds``) on the read side, and by the upload-queue
backpressure share (``write_upload_queue_wait_seconds``) on the write side.
Registry reads go through the lock-light snapshot API.

**Decisions.** One knob is active at a time (round-robin coordinate
descent); each knob's :class:`~s3shuffle_tpu_torch.tuning.controller.Controller`
has the clamps as its ladder ends, one rung per decision, hysteresis and the
``autotune_interval_s`` cooldown. The static value is always a rung and the
start point. A knob whose static value switches its plane off
(``fetch_parallelism <= 1``, ``coalesce_gap_bytes == 0``,
``upload_queue_bytes == 0``, ``composite_commit_maps <= 1``,
``encode_inflight_batches <= 1``, the skew knobs at 0) is never put on a
ladder: the tuner retunes within a plane and never overrules an off switch.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

from s3shuffle_tpu_torch.metrics import registry as _metrics
from s3shuffle_tpu_torch.metrics.registry import (
    HistogramSnapshot,
    read_counter_total,
    read_histogram,
)

from s3shuffle_tpu_torch.tuning.controller import Controller, geometric_ladder

__all__ = ["ScanTuner", "CommitTuner", "tuner_state"]

MiB = 1024 * 1024

_H_CONTROLLER = _metrics.REGISTRY.histogram(
    "tune_controller_seconds",
    "Controller decision + registry signal-read work per tuner observation "
    "(the closed loop's own overhead)",
)


def _ladder_with(lo: int, hi: int, static: int, dense_head: bool = False) -> List[int]:
    """Clamp-to-clamp geometric ladder with the static value guaranteed a
    rung. A static value outside the clamps EXTENDS the ladder geometrically
    to reach it (the operator's configuration is always reachable and the
    start point; steps stay bounded)."""
    static = max(1, int(static))
    lo2, hi2 = min(lo, static), max(hi, static)
    rungs = set(geometric_ladder(lo2, hi2))
    if dense_head:
        # small-integer knobs (parallelism, windows): +1 steps through 4 so
        # the climb near the bottom is fine-grained like the predictor's
        rungs |= set(range(lo2, min(hi2, 4) + 1))
    rungs.add(static)
    return sorted(rungs)


class _SignalDelta:
    """Interval reader over registry instruments: each ``read()`` returns the
    deltas accumulated since the previous call (first call = since zero).
    Callers serialize reads (the owning tuner's lock)."""

    def __init__(self, histograms: Tuple[str, ...], counters: Tuple[str, ...]):
        self._hist_names = histograms
        self._counter_names = counters
        self._prev_hist: Dict[str, HistogramSnapshot] = {}
        self._prev_counter: Dict[str, float] = {}

    def read(self) -> Tuple[Dict[str, HistogramSnapshot], Dict[str, float]]:
        hists: Dict[str, HistogramSnapshot] = {}
        counters: Dict[str, float] = {}
        for name in self._hist_names:
            snap = read_histogram(name)
            prev = self._prev_hist.get(name)
            hists[name] = snap.delta(prev) if prev is not None else snap
            self._prev_hist[name] = snap
        for name in self._counter_names:
            value = read_counter_total(name)
            counters[name] = max(0.0, value - self._prev_counter.get(name, 0.0))
            self._prev_counter[name] = value
        return hists, counters


class _TunedKnob:
    """One knob's controller + the config field it overrides."""

    def __init__(self, field: str, controller: Controller, apply=None):
        self.field = field
        self.controller = controller
        #: optional side-effect hook run (outside the lock) whenever the rung
        #: changed — the CommitTuner retargets bound codec objects here
        self.apply = apply


class _BaseTuner:
    """Round-robin coordinate descent over a list of :class:`_TunedKnob`."""

    #: samples per decision ring — scans/commits are expensive workload
    #: units, so rings are much shorter than the prefetch predictor's 20
    RING_SIZE = 2
    HYSTERESIS = 0.05

    def __init__(self, cfg, knobs: List[_TunedKnob]):
        self._lock = threading.Lock()
        self._knobs = knobs
        self._active = 0

    def _controller(self, ladder, initial, knob_name, cfg) -> Controller:
        return Controller(
            ladder=ladder,
            initial=initial,
            ring_size=self.RING_SIZE,
            hysteresis=self.HYSTERESIS,
            cooldown_s=float(getattr(cfg, "autotune_interval_s", 0.0)),
            knob=knob_name,
        )

    # ------------------------------------------------------------------
    def value(self, field: str, static: int) -> int:
        """Current rung for ``field`` (``static`` when the knob is untuned)."""
        with self._lock:
            for knob in self._knobs:
                if knob.field == field:
                    return knob.controller.current
        return static

    def overrides(self) -> Dict[str, int]:
        with self._lock:
            return {k.field: k.controller.current for k in self._knobs}

    # ------------------------------------------------------------------
    def export_profile(self) -> Dict[str, Dict]:
        """Warm-start snapshot: per-knob controller state (see
        :meth:`Controller.export_state`)."""
        with self._lock:
            return {k.field: k.controller.export_state() for k in self._knobs}

    def restore_profile(self, profile: Dict[str, Dict]) -> None:
        """Adopt a saved profile; knobs absent from it (or no longer tuned
        under the current config) are untouched. Apply hooks run for knobs
        whose rung moved, so bound side effects (codec windows) see the
        restored value."""
        applies = []
        with self._lock:
            for knob in self._knobs:
                state = profile.get(knob.field)
                if not isinstance(state, dict):
                    continue
                before = knob.controller.current
                knob.controller.restore_state(state)
                if knob.controller.current != before and knob.apply is not None:
                    applies.append((knob.apply, knob.controller.current))
        for apply, value in applies:
            apply(value)

    def _observe_cost(self, cost: float) -> None:
        """Feed one cost sample to the ACTIVE knob's controller; rotate the
        active knob whenever its controller completes a decision."""
        if not self._knobs:
            return
        with self._lock:
            knob = self._knobs[self._active]
            before_decisions = knob.controller.decisions
            before_value = knob.controller.current
            after_value = knob.controller.add_measurement_and_predict(cost)
            if knob.controller.decisions != before_decisions:
                self._active = (self._active + 1) % len(self._knobs)
            changed = after_value != before_value
            apply = knob.apply
        if changed and apply is not None:
            apply(after_value)


# ---------------------------------------------------------------------------
# Read side
# ---------------------------------------------------------------------------


class ScanTuner(_BaseTuner):
    """Per-scan controller plane for the reduce-side transfer knobs."""

    #: per-knob clamps (the ladder ends).
    #: max_buffer_size_task's hi is ADDITIONALLY capped at the operator's
    #: static value: it is a memory budget, and the tuner only tunes down.
    CLAMPS = {
        "fetch_parallelism": (1, 16),
        "fetch_chunk_size": (1 * MiB, 32 * MiB),
        "coalesce_gap_bytes": (64 * 1024, 4 * MiB),
        "max_buffer_size_task": (16 * MiB, 256 * MiB),
        "decode_batch_frames": (4, 128),
        "decode_inflight_batches": (1, 8),
        "hot_read_fanout": (2, 64),
    }

    def __init__(self, cfg):
        self._codecs: List[object] = []
        knobs: List[_TunedKnob] = []

        def add(field: str, static: int, dense_head: bool = False, apply=None) -> None:
            lo, hi = self.CLAMPS[field]
            knobs.append(_TunedKnob(
                field,
                self._controller(
                    _ladder_with(lo, hi, static, dense_head), static, field, cfg
                ),
                apply=apply,
            ))

        if cfg.fetch_parallelism > 1:  # <= 1 = chunked fetch disabled
            add("fetch_parallelism", cfg.fetch_parallelism, dense_head=True)
            add("fetch_chunk_size", cfg.fetch_chunk_size)
        if cfg.coalesce_gap_bytes > 0:  # 0 = scan planner disabled
            add("coalesce_gap_bytes", cfg.coalesce_gap_bytes)
        # read-side decode pipeline (CodecInputStream reads both attributes
        # LIVE per batch, so apply hooks retarget bound codecs mid-stream);
        # plane-off statics (<= 1) are never overruled
        if getattr(cfg, "decode_batch_frames", 0) > 1:
            add(
                "decode_batch_frames", cfg.decode_batch_frames,
                apply=self._apply_decode_batch_frames,
            )
        if getattr(cfg, "decode_inflight_batches", 0) > 1:
            add(
                "decode_inflight_batches", cfg.decode_inflight_batches,
                dense_head=True, apply=self._apply_decode_window,
            )
        # skew plane: the hot-object diversion trigger (concurrency count at
        # which reads fan out to parity sources) rides the tuned scan cfg
        # like every other read knob; 0 = prong off, never overruled
        if getattr(cfg, "hot_read_fanout", 0) > 0:
            add("hot_read_fanout", cfg.hot_read_fanout, dense_head=True)
        # max_buffer_size_task is a MEMORY CAP, not a request-shape knob: the
        # operator's static value is the ceiling (N concurrent reduce tasks
        # each provisioned at the configured budget must never see the tuner
        # multiply that demand). The tuner may only tune DOWN from it.
        lo, _hi = self.CLAMPS["max_buffer_size_task"]
        budget = max(1, int(cfg.max_buffer_size_task))
        knobs.append(_TunedKnob(
            "max_buffer_size_task",
            self._controller(
                _ladder_with(min(lo, budget), budget, budget),
                budget, "max_buffer_size_task", cfg,
            ),
        ))
        super().__init__(cfg, knobs)
        self._signals = _SignalDelta(
            histograms=("read_prefetch_wait_seconds",),
            counters=(
                "read_coalesce_waste_bytes_total",
                "storage_read_bytes_total",
            ),
        )

    # ------------------------------------------------------------------
    def bind_codec(self, codec) -> None:
        """Register a codec whose ``decode_batch_frames`` /
        ``decode_inflight_batches`` attributes this tuner retunes.
        CodecInputStream reads both live at every batch boundary, so a
        retune applies mid-stream to every open read."""
        if codec is None:
            return
        current: Dict[str, int] = {}
        with self._lock:
            if codec not in self._codecs:
                self._codecs.append(codec)
            for knob in self._knobs:
                if knob.field in ("decode_batch_frames", "decode_inflight_batches"):
                    current[knob.field] = knob.controller.current
        for field, value in current.items():
            setattr(codec, field, value)

    def _apply_decode_batch_frames(self, value: int) -> None:
        with self._lock:
            codecs = list(self._codecs)
        for codec in codecs:
            codec.decode_batch_frames = value

    def _apply_decode_window(self, value: int) -> None:
        with self._lock:
            codecs = list(self._codecs)
        for codec in codecs:
            codec.decode_inflight_batches = value

    # ------------------------------------------------------------------
    def tuned(self, cfg):
        """The scan-plan-time consult: ``cfg`` with the read-side knobs
        replaced by their current rungs. Pure read — consulting twice in one
        scan (reader then planner) yields identical values."""
        overrides = self.overrides()
        if not overrides:
            return cfg
        return dataclasses.replace(cfg, **overrides)

    def observe_scan(self, wall_s: float, nbytes: int) -> None:
        """One completed scan = one cost sample for the active knob."""
        t0 = time.perf_counter_ns()
        # seconds per MiB moved — normalized per actual byte (no floor) so
        # small workload units still rank rungs by per-byte throughput
        cost = wall_s * MiB / max(1, nbytes)
        if _metrics.enabled():
            with self._lock:
                hists, counters = self._signals.read()
            read_bytes = counters.get("storage_read_bytes_total", 0.0)
            waste = counters.get("read_coalesce_waste_bytes_total", 0.0)
            if read_bytes > 0:
                # over-merging penalty: gap bytes fetched-and-discarded make
                # a rung look worse even when a fast store hides them in wall
                cost *= 1.0 + min(1.0, waste / read_bytes)
            wait = hists["read_prefetch_wait_seconds"]
            if wall_s > 0 and wait.sum > 0:
                # consumer-visible starvation share — the predictor's classic
                # control signal, folded in so budget/parallelism rungs that
                # starve the consumer lose even at equal wall
                cost *= 1.0 + min(1.0, wait.sum / max(wall_s, 1e-9))
        self._observe_cost(cost)
        if _metrics.enabled():
            _H_CONTROLLER.observe((time.perf_counter_ns() - t0) / 1e9)


# ---------------------------------------------------------------------------
# Write side
# ---------------------------------------------------------------------------


class CommitTuner(_BaseTuner):
    """Per-commit controller plane for the write-side transfer knobs."""

    CLAMPS = {
        "upload_queue_bytes": (4 * MiB, 128 * MiB),
        "composite_commit_maps": (2, 128),
        "composite_flush_bytes": (4 * MiB, 256 * MiB),
        "encode_inflight_batches": (1, 8),
        "columnar_batch_rows": (8192, 1 << 18),
        "combine_threshold_bytes": (64 * 1024, 16 * MiB),
        "split_threshold_bytes": (1 * MiB, 64 * MiB),
    }

    def __init__(self, cfg):
        self._codecs: List[object] = []
        knobs: List[_TunedKnob] = []

        def add(field: str, static: int, dense_head: bool = False, apply=None) -> None:
            lo, hi = self.CLAMPS[field]
            knobs.append(_TunedKnob(
                field,
                self._controller(
                    _ladder_with(lo, hi, static, dense_head), static, field, cfg
                ),
                apply=apply,
            ))

        if cfg.upload_queue_bytes > 0:  # 0 = pipelined upload disabled
            add("upload_queue_bytes", cfg.upload_queue_bytes)
        if cfg.composite_commit_maps > 1:  # <= 1 = composite plane disabled
            add("composite_commit_maps", cfg.composite_commit_maps, dense_head=True)
            add("composite_flush_bytes", cfg.composite_flush_bytes)
        if cfg.encode_inflight_batches > 1:  # <= 1 = synchronous encode
            add(
                "encode_inflight_batches", cfg.encode_inflight_batches,
                dense_head=True, apply=self._apply_encode_window,
            )
        if cfg.columnar and cfg.columnar_batch_rows > 1:  # 0 = legacy plane
            add("columnar_batch_rows", cfg.columnar_batch_rows)
        # skew plane write-side knobs (0 = prong off, never overruled): the
        # combine sidecar's engage point and the hot-partition split stripe
        if getattr(cfg, "combine_threshold_bytes", 0) > 0:
            add("combine_threshold_bytes", cfg.combine_threshold_bytes)
        if getattr(cfg, "split_threshold_bytes", 0) > 0:
            add("split_threshold_bytes", cfg.split_threshold_bytes)
        super().__init__(cfg, knobs)
        self._signals = _SignalDelta(
            histograms=("write_upload_queue_wait_seconds",),
            counters=(),
        )

    # ------------------------------------------------------------------
    def bind_codec(self, codec) -> None:
        """Register a codec whose ``encode_inflight_batches`` window this
        tuner retunes (only meaningful for codecs that carry the attribute —
        the async-batch TLZ path). CodecOutputStream reads the attribute live
        at every batch submission, so a retune applies mid-stream."""
        if not hasattr(codec, "encode_inflight_batches"):
            return
        current: Optional[int] = None
        with self._lock:
            if codec not in self._codecs:
                self._codecs.append(codec)
            for knob in self._knobs:
                if knob.field == "encode_inflight_batches":
                    current = knob.controller.current
        if current is not None:
            codec.encode_inflight_batches = current

    def _apply_encode_window(self, value: int) -> None:
        with self._lock:
            codecs = list(self._codecs)
        for codec in codecs:
            codec.encode_inflight_batches = value

    # ------------------------------------------------------------------
    def upload_queue_bytes(self, static: int) -> int:
        """Sink-creation consult (map writer / composite group sink)."""
        if static <= 0:  # plane disabled by the operator: never re-enable
            return static
        return self.value("upload_queue_bytes", static)

    def columnar_batch_rows(self, static: int) -> int:
        """Write-path chunk-rows consult (map writers' ``_chunk_rows``)."""
        if static <= 1:  # degenerate static: never overrule
            return static
        return self.value("columnar_batch_rows", static)

    def combine_threshold_bytes(self, static: int) -> int:
        """Combine-sidecar engage-point consult (skew plane, map write)."""
        if static <= 0:  # prong disabled by the operator: never re-enable
            return static
        return self.value("combine_threshold_bytes", static)

    def split_threshold_bytes(self, static: int) -> int:
        """Hot-partition split-stripe consult (skew plane, commit/seal)."""
        if static <= 0:  # prong disabled by the operator: never re-enable
            return static
        return self.value("split_threshold_bytes", static)

    def seal_thresholds(self, static_members: int, static_bytes: int) -> Tuple[int, int]:
        """Composite seal-point consult: (member-count cap, byte cap)."""
        if static_members <= 1:
            return static_members, static_bytes
        return (
            self.value("composite_commit_maps", static_members),
            self.value("composite_flush_bytes", static_bytes),
        )

    def observe_commit(self, wall_s: float, nbytes: int) -> None:
        """One map commit / group seal = one cost sample."""
        t0 = time.perf_counter_ns()
        # seconds per MiB committed (per-byte normalization, no floor: a
        # 2-map and a 64-map group seal rank by per-byte cost, not seal wall)
        cost = wall_s * MiB / max(1, nbytes)
        if _metrics.enabled():
            with self._lock:
                hists, _counters = self._signals.read()
            backpressure = hists["write_upload_queue_wait_seconds"]
            if wall_s > 0 and backpressure.sum > 0:
                # producer stalls on a full upload queue: rungs that choke
                # the pipeline lose even when the store hides it in wall
                cost *= 1.0 + min(1.0, backpressure.sum / max(wall_s, 1e-9))
        self._observe_cost(cost)
        if _metrics.enabled():
            _H_CONTROLLER.observe((time.perf_counter_ns() - t0) / 1e9)


def tuner_state(tuner: Optional[_BaseTuner]) -> Dict[str, int]:
    """Debug/bench helper: the tuner's current rung per knob ({} when off)."""
    return {} if tuner is None else tuner.overrides()
