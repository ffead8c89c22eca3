"""Degraded reads: loss reconstruction, straggler speculation and the hot
fan-out (the JAX package's ``coding/degraded.py``). Three triggers, one
reconstruction engine:

- **loss** (``reason="loss"``): when a data-object GET dies with
  ``FileNotFoundError`` (the object is lost, not slow),
  :class:`~s3shuffle_tpu_torch.read.block_stream.BlockStream` asks
  :meth:`DegradedReader.reconstruct` for the missing byte range before it
  falls back to the logged EOF that the checksum layer reports as a
  ``ChecksumError``. Reconstruction is unconditional: if the survivors
  suffice the read completes with the same bytes (validated by the
  unchanged per-block checksums); if not, the behaviour is that of an
  uncoded shuffle;
- **straggler** (``reason="straggler"``): a prefill that outlives its size
  class's fill quantile (``speculative_read_quantile`` of the metrics
  registry's ``read_prefetch_fill_per_mib_seconds``, scaled by the
  prefill's own MiB) is raced against a reconstruction by
  :class:`SpeculativeFetcher`, and whichever finishes first serves it. The
  histograms fill only while the registry is on, and a threshold needs
  :data:`MIN_FILL_SAMPLES` samples, so with the registry off nothing races;
- **hot fan-out** (``reason="hot_fanout"``, the skew plane): a read of a
  data object that already has ``hot_read_fanout`` GETs in flight in this
  process is served from its parity sidecars instead.

Per stripe group: read the group's parity slices (ranged GETs against the
parity sidecars, one span per sidecar for the whole range), solve
parity-only when that determines the group, otherwise fill in with sibling
data chunks from the data object while it is still readable. Sources that
fail shrink the survivor set; too few survivors return None.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Dict, Optional, Tuple

import numpy as np

from s3shuffle_tpu_torch.coding import gf
from s3shuffle_tpu_torch.coding.parity import (
    HEADER_BYTES,
    ParityGeometry,
    parity_blocks_for,
    parse_parity_header,
)
from s3shuffle_tpu_torch.device import on_device
from s3shuffle_tpu_torch.metrics import registry as _metrics
from s3shuffle_tpu_torch.read.prefetch import fill_norm_mib, fill_size_class
from s3shuffle_tpu_torch.skew import C_HOT_FANOUT_READS, OBJECT_GETS
from s3shuffle_tpu_torch.utils.growpool import GrowReapExecutor

logger = logging.getLogger("s3shuffle_tpu_torch.coding")

_C_SPECULATIVE = _metrics.REGISTRY.counter(
    "shuffle_parity_speculative_reads_total",
    "Prefills whose latency crossed the speculation threshold and raced a "
    "parity reconstruction",
)

#: samples a size class needs before its speculation threshold is trusted:
#: below this the quantile is noise
MIN_FILL_SAMPLES = 8

# The speculation pool: the grow/reap lifecycle of utils/growpool.py, but a
# pool apart from the chunked-fetch one. A raced primary blocks on its store
# GET; parked on the chunked-fetch pool it could starve the sub-reads it
# fans out itself (both waiting on pool slots: a deadlock).
_POOL = GrowReapExecutor("s3shuffle-torch-speculate")
_inflight_lock = threading.Lock()
_inflight = 0


def _submit_speculative(width: int, fn, *args):
    """Submit sized to the aggregate demand: the pool widens to the largest
    width asked for, so asking for max(own width, primaries in flight) keeps
    concurrent scans' primaries from queueing behind one scan's width (each
    prefetch thread ran its own GET at once before the race existed)."""
    global _inflight
    with _inflight_lock:
        _inflight += 1
        want = max(width, _inflight)

    def tracked():
        global _inflight
        try:
            return fn(*args)
        finally:
            with _inflight_lock:
                _inflight -= 1

    return _POOL.submit(want, tracked)


class DegradedReader:
    """Per-reader reconstruction engine over the registered geometries.

    Geometry is registered from the index each block read fetches anyway,
    keyed by the data object. An empty reader is inert: ``has`` is False
    everywhere and every reconstruct returns None. ``device`` is where the
    survivors' parity contribution is encoded (K4 on the CUDA device);
    ``reconstructions`` counts the byte ranges served from parity.
    :meth:`reconstruct` may run on a prefetch thread: it selects
    ``device`` on that thread and synchronises it before the bytes are
    handed over."""

    def __init__(self, dispatcher, device=None):
        self.dispatcher = dispatcher
        self.device = device
        self.reconstructions = 0
        self._lock = threading.Lock()
        self._geoms: Dict[str, tuple] = {}  # data object name -> (data_block, geometry)

    def register(self, data_block, geometry: Optional[ParityGeometry]) -> None:
        if geometry is None or geometry.segments <= 0:
            return
        with self._lock:
            self._geoms[data_block.name] = (data_block, geometry)

    def note(self, helper, shuffle_id: int, map_id: int) -> None:
        """Register one map output's geometry through the helper (or the
        scan's memo, where the location is already resolved)."""
        try:
            loc = helper.resolve_map_location(shuffle_id, map_id)
        except (OSError, ValueError):
            return
        self.register(loc.data_block, loc.parity)

    def has(self, data_block) -> bool:
        name = getattr(data_block, "name", None)
        if name is None:
            return False
        with self._lock:
            return name in self._geoms

    def speculation_viable(self, data_block) -> bool:
        """Can a reconstruction of this object's whole range succeed from
        parity alone? A raced prefill covers the whole stream range, so
        every stripe group it touches must be solvable parity-only: the
        parity count must cover the group's real chunks (m >= k for full
        groups; a short tail-only object needs only its real chunks). A race
        that cannot be won would add latency and store ops (sibling reads
        hit the very object that is slow), so such objects keep the plain
        prefill. Loss reconstruction is not gated."""
        name = getattr(data_block, "name", None)
        if name is None:
            return False
        with self._lock:
            entry = self._geoms.get(name)
        if entry is None:
            return False
        geom = entry[1]
        return geom.segments >= min(geom.stripe_k, max(1, geom.n_chunks))

    def geometry_of(self, data_block) -> Optional[ParityGeometry]:
        name = getattr(data_block, "name", None)
        if name is None:
            return None
        with self._lock:
            entry = self._geoms.get(name)
        return None if entry is None else entry[1]

    def __bool__(self) -> bool:
        with self._lock:
            return bool(self._geoms)

    def reconstruct(self, data_block, start: int, end: int, reason: str = "loss") -> Optional[bytes]:
        """Rebuild the byte range ``[start, end)`` of ``data_block`` from
        parity (+ surviving sibling chunks). None when the object carries no
        parity or the survivors are insufficient: the caller then falls back
        to the uncoded behaviour."""
        with self._lock:
            entry = self._geoms.get(getattr(data_block, "name", ""))
        if entry is None:
            return None
        block, geom = entry
        end = min(end, geom.payload_len)
        if end <= start:
            return b""
        try:
            with on_device(self.device):
                out = self._reconstruct_range(block, geom, start, end)
        except (OSError, ValueError):  # a store or wire fault: best effort
            logger.warning(
                "parity reconstruction of %s [%d,%d) failed", block.name, start, end,
                exc_info=True,
            )
            return None
        if out is not None:
            with self._lock:
                self.reconstructions += 1
            logger.warning(
                "reconstructed %s [%d,%d) from parity (%s)", block.name, start, end, reason
            )
        return out

    def _reconstruct_range(self, block, geom: ParityGeometry, start: int, end: int) -> Optional[bytes]:
        c0 = start // geom.chunk_bytes
        c1 = (end - 1) // geom.chunk_bytes
        coefs = gf.parity_coefficients(geom.segments, geom.stripe_k)
        parity_readers = _ParityHandles(self.dispatcher, block, geom)
        parity_readers.prefetch_span(c0 // geom.stripe_k, c1 // geom.stripe_k)
        data_reader = _DataHandle(self.dispatcher, block, geom)
        try:
            chunks: Dict[int, np.ndarray] = {}
            for group in range(c0 // geom.stripe_k, c1 // geom.stripe_k + 1):
                member_lo = group * geom.stripe_k
                member_hi = min(member_lo + geom.stripe_k, geom.n_chunks)
                want = [c - member_lo for c in range(max(c0, member_lo), min(c1 + 1, member_hi))]
                if not want:
                    continue
                plen = geom.group_parity_len(group)
                parity_present = parity_readers.read_group(group, plen)
                # the encoder zero-pads a short final group to k chunks:
                # those phantom positions are known zero survivors, so a tail
                # group needs only as many parity slices as it has real chunks
                known: Dict[int, np.ndarray] = {
                    j: np.zeros(plen, dtype=np.uint8)
                    for j in range(member_hi - member_lo, geom.stripe_k)
                }
                # parity (+ phantoms) first; sibling data chunks only when
                # that cannot determine the group
                recovered = gf.recover_group(
                    geom.stripe_k, coefs, dict(known), parity_present, want, self.device
                )
                if recovered is None:
                    known.update(data_reader.read_chunks(
                        group, [j for j in range(member_hi - member_lo) if j not in want], plen,
                    ))
                    recovered = gf.recover_group(
                        geom.stripe_k, coefs, known, parity_present, want, self.device
                    )
                if recovered is None:
                    logger.warning(
                        "cannot reconstruct %s stripe group %d: %d parity + %d "
                        "sibling survivors for %d missing chunk(s)",
                        block.name, group, len(parity_present),
                        data_reader.last_count, len(want),
                    )
                    return None
                for pos, data in recovered.items():
                    chunks[member_lo + pos] = data
            parts = []
            for c in range(c0, c1 + 1):
                lo, hi = geom.chunk_span(c)
                chunk = chunks[c][: hi - lo]
                parts.append(bytes(chunk[max(start, lo) - lo : min(end, hi) - lo]))
            return b"".join(parts)
        finally:
            parity_readers.close()
            data_reader.close()


class _ParityHandles:
    """Lazy ranged readers over one data object's parity sidecars, with the
    self-describing header cross-checked on first open."""

    def __init__(self, dispatcher, data_block, geom: ParityGeometry):
        self.dispatcher = dispatcher
        self.geom = geom
        self.blocks = parity_blocks_for(data_block, geom.segments)
        self._readers: Dict[int, object] = {}
        self._dead: set = set()
        self._span_bounds: Optional[Tuple[int, int]] = None
        self._spans: Dict[int, bytes] = {}
        self._span_failed: set = set()

    def prefetch_span(self, g_lo: int, g_hi: int) -> None:
        """Arm one contiguous ranged GET per parity object covering every
        group of the reconstruction [g_lo, g_hi]: the touched slices are
        adjacent in the sidecar, so one round trip serves them all."""
        lo = self.geom.parity_chunk_offset(g_lo)
        hi = self.geom.parity_chunk_offset(g_hi) + self.geom.group_parity_len(g_hi)
        if hi > lo:
            self._span_bounds = (lo, hi)

    def _from_span(self, seg: int, offset: int, plen: int) -> Optional[bytes]:
        if self._span_bounds is None or seg in self._span_failed:
            return None
        lo, hi = self._span_bounds
        if offset < lo or offset + plen > hi:
            return None
        span = self._spans.get(seg)
        if span is None:
            reader = self._reader(seg)
            if reader is None:
                return None
            try:
                span = reader.read_fully(lo, hi - lo)
            except OSError as e:
                logger.warning(
                    "parity span read %s [%d,%d) failed: %s — degrading to "
                    "per-group reads", self.blocks[seg].name, lo, hi, e,
                )
                self._span_failed.add(seg)
                return None
            if len(span) != hi - lo:
                self._span_failed.add(seg)
                return None
            self._spans[seg] = span
        o = offset - lo
        return span[o : o + plen]

    def _reader(self, seg: int):
        if seg in self._dead:
            return None
        reader = self._readers.get(seg)
        if reader is None:
            try:
                reader = self.dispatcher.backend.open_ranged(
                    self.dispatcher.get_path(self.blocks[seg])
                )
                header = parse_parity_header(reader.read_fully(0, HEADER_BYTES))
                if header != self.geom:
                    raise ValueError(
                        f"parity object {self.blocks[seg].name} geometry "
                        f"{header} != recorded {self.geom}"
                    )
            except (OSError, ValueError) as e:
                logger.warning("parity segment %s unavailable: %s", self.blocks[seg].name, e)
                if reader is not None:
                    reader.close()
                self._dead.add(seg)
                return None
            self._readers[seg] = reader
        return reader

    def read_group(self, group: int, plen: int) -> Dict[int, np.ndarray]:
        out: Dict[int, np.ndarray] = {}
        offset = self.geom.parity_chunk_offset(group)
        for seg in range(self.geom.segments):
            data = self._from_span(seg, offset, plen)
            if data is None:
                reader = self._reader(seg)
                if reader is None:
                    continue
                try:
                    data = reader.read_fully(offset, plen)
                except OSError as e:
                    logger.warning(
                        "parity read %s group %d failed: %s", self.blocks[seg].name, group, e
                    )
                    continue
            if len(data) == plen:
                out[seg] = np.frombuffer(data, dtype=np.uint8)
        return out

    def close(self) -> None:
        for reader in self._readers.values():
            try:
                reader.close()
            except OSError:
                pass
        self._readers = {}


class _DataHandle:
    """Lazy ranged reader over the data object itself, the source of
    sibling chunks for a partial-range reconstruction; every failure just
    shrinks the survivor set (the object may be lost entirely)."""

    def __init__(self, dispatcher, data_block, geom: ParityGeometry):
        self.dispatcher = dispatcher
        self.block = data_block
        self.geom = geom
        self._reader = None
        self._dead = False
        self.last_count = 0

    def read_chunks(self, group: int, positions, plen: int) -> Dict[int, np.ndarray]:
        out: Dict[int, np.ndarray] = {}
        self.last_count = 0
        if self._dead:
            return out
        if self._reader is None:
            try:
                self._reader = self.dispatcher.backend.open_ranged(
                    self.dispatcher.get_path(self.block)
                )
            except OSError as e:
                logger.warning(
                    "data object %s unavailable for sibling reads: %s", self.block.name, e
                )
                self._dead = True
                return out
        base = group * self.geom.stripe_k
        for j in positions:
            lo, hi = self.geom.chunk_span(base + j)
            if hi <= lo:
                continue
            try:
                data = self._reader.read_fully(lo, hi - lo)
            except OSError:
                continue
            if len(data) != hi - lo:
                continue
            chunk = np.zeros(plen, dtype=np.uint8)
            chunk[: len(data)] = np.frombuffer(data, dtype=np.uint8)
            out[j] = chunk
        self.last_count = len(out)
        return out

    def close(self) -> None:
        if self._reader is not None:
            try:
                self._reader.close()
            except OSError:
                pass
            self._reader = None


# --- straggler speculation and the hot fan-out ---

class SpeculativeFetcher:
    """Races slow prefills against parity reconstruction, and diverts reads
    of hot objects to parity.

    Built by ``read/scan_plan.build_scan_iterator`` once per scan, when
    ``speculative_read_quantile > 0`` or ``hot_read_fanout > 0``. A prefill
    is eligible when its data object carries parity that can rebuild its
    whole range (:meth:`DegradedReader.speculation_viable`) and the
    requested budget covers the whole range (the buffer is then complete,
    so the abandoned primary can never corrupt a later cursor read).

    The threshold is size-aware twice: the quantile is taken from the
    ``read_prefetch_fill_per_mib_seconds`` series of the prefill's size
    class and scaled by the prefill's own size in MiB (floored at 1). Each
    class's threshold is resolved once per scan, and only once the class
    holds :data:`MIN_FILL_SAMPLES` samples; with the registry off there are
    none, and nothing races. The threshold clock starts when the GET starts
    on the speculation pool, not when it is queued.

    ``hot_fanout`` arms the skew plane's third prong: when the data object
    already has that many real GETs in flight (``skew.OBJECT_GETS``), the
    read skips the GET and reconstructs from the parity sidecars."""

    def __init__(self, recovery: DegradedReader, quantile: float, width: int = 4,
                 hot_fanout: int = 0):
        self.recovery = recovery
        self.quantile = float(quantile)
        self.width = max(1, int(width))
        self.hot_fanout = max(0, int(hot_fanout))
        #: size class -> resolved per-MiB quantile (None: never race it)
        self._thresholds: Dict[str, Optional[float]] = {}

    def eligible(self, stream, bsize: int) -> bool:
        data_block = getattr(stream, "data_block", None)
        if data_block is None or bsize < getattr(stream, "max_bytes", 1 << 62):
            return False
        return self.recovery.speculation_viable(data_block)

    def threshold_s(self, bsize: int = 0) -> Optional[float]:
        """The race's threshold for a prefill of ``bsize`` bytes: its size
        class's per-MiB fill quantile, scaled by its own size; None when
        the class has too few samples or the registry is off."""
        cls = fill_size_class(int(bsize))
        if cls not in self._thresholds:
            per_mib = None
            if 0.0 < self.quantile < 1.0 and _metrics.enabled():
                hist = _metrics.REGISTRY.histogram(
                    "read_prefetch_fill_per_mib_seconds", labelnames=("size_class",),
                )
                snap = hist.labels(size_class=cls).read()
                if snap.count >= MIN_FILL_SAMPLES:
                    value = snap.percentile(self.quantile)
                    if value > 0.0:
                        per_mib = value
            self._thresholds[cls] = per_mib
        per_mib = self._thresholds[cls]
        if per_mib is None:
            return None
        return per_mib * fill_norm_mib(int(bsize))

    def prefill(self, stream, bsize: int, primary):
        """Run ``primary`` (the plain prefill) with a reconstruction race
        armed at the threshold; just ``primary()`` when there is no
        threshold. Returns ``(buffer, speculation_won, primary_exec_s)``:
        the caller must not observe a fill speculation won (threshold +
        reconstruction would ratchet the quantile up during a straggler
        episode), and a raced fill the primary won observes
        ``primary_exec_s``, the GET's own execution time."""
        if self.hot_fanout > 0:
            hot = self._hot_fanout_prefill(stream)
            if hot is not None:
                return hot, True, None
        threshold = self.threshold_s(bsize)
        if threshold is None:
            return primary(), False, None
        started = threading.Event()
        exec_s = [None]

        def timed_primary():
            started.set()
            t0 = time.perf_counter_ns()
            try:
                return primary()
            finally:
                exec_s[0] = (time.perf_counter_ns() - t0) / 1e9

        future = _submit_speculative(self.width, timed_primary)
        # queueing on the pool is not store latency: the clock starts when
        # the GET does, or a saturated pool would read as a straggler storm
        while not started.wait(timeout=threshold):
            if future.done():
                return future.result(), False, exec_s[0]
        try:
            return future.result(timeout=threshold), False, exec_s[0]
        except FutureTimeoutError:
            pass
        if _metrics.enabled():
            _C_SPECULATIVE.inc()
        data = self.recovery.reconstruct(
            stream.data_block, stream.start_offset, stream.end_offset, reason="straggler",
        )
        if data is not None:
            # the primary is abandoned: its late buffer is dropped and the
            # stream is never cursor-read (bsize covers max_bytes); the
            # stream's reader closes when the abandoned GET ends, so the
            # consumer never waits out the straggler it dodged
            abandon = getattr(stream, "abandon_close_to", None)
            if abandon is not None:
                abandon(future)
            return data, True, exec_s[0]
        return future.result(), False, exec_s[0]

    def _hot_fanout_prefill(self, stream) -> Optional[bytes]:
        """The coded read fan-out: when the stream's data object already has
        ``hot_fanout`` GETs in flight, serve the range from its parity
        sidecars. None takes the normal path (the object is not hot, the
        range is under one parity chunk, or the reconstruction fell short).
        A diverted read never enters the object's in-flight count."""
        name = getattr(getattr(stream, "data_block", None), "name", None)
        if name is None or OBJECT_GETS.inflight(name) < self.hot_fanout:
            return None
        geom = self.recovery.geometry_of(stream.data_block)
        if geom is None or stream.end_offset - stream.start_offset < geom.chunk_bytes:
            # parity I/O is chunk-granular: diverting a sub-chunk read would
            # move more parity bytes than the primary would have
            return None
        data = self.recovery.reconstruct(
            stream.data_block, stream.start_offset, stream.end_offset, reason="hot_fanout",
        )
        if data is not None and _metrics.enabled():
            C_HOT_FANOUT_READS.inc()
        return data
