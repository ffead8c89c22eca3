"""Bounded-memory adaptive prefetcher, the read side's concurrency engine
(the JAX package's ``read/prefetch.py``; parity with the reference's
``S3BufferedPrefetchIterator``, S3BufferedPrefetchIterator.scala:16-213,
and ``S3BufferedInputStreamAdaptor``):

- background threads pull ``(block, stream)`` pairs and prefill each
  stream's buffer: the store GET runs on the prefetch thread, never on the
  consumer. These threads do store I/O only; every decode stays on the
  consumer thread;
- memory budget: per-stream buffer = ``min(max_buffer_size,
  stream.max_bytes)`` and the sum of in-flight buffers stays within
  ``max_buffer_size``; producers wait when over budget (:122-135), a stream's
  close releases its share (:96-100). A block larger than the budget is
  clamped to it and its remainder streams synchronously on the consumer;
- completed streams go on a LIFO stack (:30, 146, 209), so block order
  within a scan varies from run to run;
- :class:`ThreadPredictor` (:32-69): a hill climb over the thread count
  1..max_threads driven by the consumer's wait latency (the skew plane's
  split fan-out seeds it with the scan's part count);
- threads spawn when the target grows (:78-94) and retire by position when
  it shrinks (:112-115);
- a prefetch failure reaches the consumer, raised by its next ``next()``;
- :meth:`BufferedPrefetchIterator.close` ends a scan early: every prefetch
  thread exits and every budget byte comes back. Each blocking wait has a
  timeout backstop;
- every primary GET runs inside ``skew.tracked_get``, so the hot fan-out
  sees each data object's live GET count;
- a ``speculation`` fetcher (``coding/degraded.SpeculativeFetcher``) may
  race an eligible prefill against a parity reconstruction;
- with the metrics registry on, each fill is observed in
  ``read_prefetch_fill_seconds``, by size class and per MiB: the evidence
  the speculation threshold is taken from. A fill speculation won is never
  observed, and a raced fill the primary won observes the GET's own
  execution time;
- the parts of a split block (``read/scan_plan.SplitGroup``) share one
  budget claim: the first part reserves the whole block, its siblings
  piggyback, and the last part's close releases it.

Not ported yet: the wait histogram and thread gauges, the trace spans and
the race witness.
"""

from __future__ import annotations

import io
import logging
import threading
import time
from typing import Iterator, List, Optional, Tuple

from s3shuffle_tpu_torch.metrics import registry as _metrics
from s3shuffle_tpu_torch.read.block_stream import BlockStream
from s3shuffle_tpu_torch.skew import tracked_get
from s3shuffle_tpu_torch.tuning.controller import Controller
from s3shuffle_tpu_torch.utils.io import read_fully as _read_up_to

logger = logging.getLogger("s3shuffle_tpu_torch.read")

RING_SIZE = 20
#: how long :meth:`BufferedPrefetchIterator.close` waits for its threads
CLOSE_JOIN_S = 30.0

_H_FILL = _metrics.REGISTRY.histogram(
    "read_prefetch_fill_seconds",
    "Background prefill latency per block (the actual store GET)",
)
_H_FILL_CLASS = _metrics.REGISTRY.histogram(
    "read_prefetch_fill_class_seconds",
    "Background prefill latency per block, bucketed by requested size "
    "class — the size-aware speculation threshold's evidence (a healthy "
    "64 MiB coalesced segment must be judged against 64 MiB peers, not a "
    "quantile dominated by 100 KiB fills)",
    labelnames=("size_class",),
)
_H_FILL_PER_MIB = _metrics.REGISTRY.histogram(
    "read_prefetch_fill_per_mib_seconds",
    "Background prefill latency per requested MiB (floored at 1 MiB so "
    "fixed round-trip cost never divides into noise), per size class — "
    "the seconds-per-byte speculation threshold's evidence: within a "
    "class, a 2 MiB and a 7 MiB fill normalize to the same scale, so a "
    "healthy fill at the class's large end stops reading as a straggler",
    labelnames=("size_class",),
)

#: size-class edges of the fill histograms: coarse, so each class gathers
#: the samples its quantile needs (``MIN_FILL_SAMPLES`` before a threshold)
_SIZE_CLASS_EDGES = ((1 << 20, "le1m"), (8 << 20, "le8m"), (64 << 20, "le64m"))


def fill_size_class(nbytes: int) -> str:
    """The size-class label of one prefill's requested byte budget."""
    for edge, label in _SIZE_CLASS_EDGES:
        if nbytes <= edge:
            return label
    return "gt64m"


def fill_norm_mib(nbytes: int) -> float:
    """The per-MiB divisor of one prefill: its size in MiB, floored at 1.0
    (below a MiB the round trip dominates, so a sub-MiB fill keeps
    absolute seconds)."""
    return max(float(max(nbytes, 1)) / (1 << 20), 1.0)


class ThreadPredictor(Controller):
    """Latency-driven hill climb over the prefetch thread count: the shared
    Controller with hysteresis and cooldown off, a 20-sample ring, ties
    resolving to fewer threads."""

    def __init__(self, max_threads: int, initial: int = 1):
        max_threads = max(1, max_threads)
        super().__init__(
            ladder=range(1, max_threads + 1),
            initial=min(max(1, initial), max_threads),
            ring_size=RING_SIZE,
        )
        self.max_threads = max_threads


class PrefetchedBlockStream(io.RawIOBase):
    """A block stream whose first ``len(buffer)`` bytes were prefetched on a
    background thread; the remainder (blocks larger than the per-stream
    buffer) streams through synchronously. ``close`` is idempotent (a double
    close logs a warning, adaptor :49-58) and releases budget via
    ``on_close``."""

    def __init__(self, block, stream: BlockStream, buffer: bytes, on_close):
        self.block = block
        self._stream = stream
        self._buffer = buffer
        self._pos = 0
        self._on_close = on_close
        self._closed_once = False
        self.buffer_size = len(buffer)

    def readable(self) -> bool:
        return True

    def buffer_view(self) -> memoryview:
        """Zero-copy view of the prefilled buffer (the planner slices member
        blocks out of a fetched segment through it)."""
        return memoryview(self._buffer)

    def read(self, size: int = -1) -> bytes:
        if size is None or size < 0:
            return self.readall()
        if self._pos < len(self._buffer):
            end = min(self._pos + size, len(self._buffer))
            out = self._buffer[self._pos : end]
            self._pos = end
            return out
        return self._stream.read(size)

    def readall(self) -> bytes:
        chunks = []
        while True:
            chunk = self.read(1 << 20)
            if not chunk:
                return b"".join(chunks)
            chunks.append(chunk)

    def close(self) -> None:
        if self._closed_once:
            if not self.closed:
                logger.warning("Double close of prefetched stream for %s", self.block)
            return
        self._closed_once = True
        self._stream.close()
        self._buffer = b""
        if self._on_close is not None:
            self._on_close(self.buffer_size)
        super().close()


class BufferedPrefetchIterator:
    def __init__(
        self,
        source: Iterator[Tuple[object, BlockStream]],
        max_buffer_size: int,
        max_threads: int = 10,
        fetcher=None,
        speculation=None,
        initial_threads: int = 1,
    ):
        self._source = source
        self._max_buffer_size = max(1, max_buffer_size)
        # optional ChunkedRangeFetcher: prefills larger than its chunk size
        # split into concurrent sub-reads; None = plain serial prefill
        self._fetcher = fetcher
        # optional SpeculativeFetcher: eligible prefills race the store GET
        # against a parity reconstruction; None = the plain path
        self._speculation = speculation
        # the predictor's first rung (clamped to max_threads): 1, the
        # reference's cold start, unless the scan holds split parts
        self._predictor = ThreadPredictor(max_threads, initial=initial_threads)
        self._lock = threading.Condition()
        # pulling a source item can do store I/O (index GETs in the block
        # iterator): its own lock, so it never blocks completions
        self._source_lock = threading.Lock()
        self._completed: List[PrefetchedBlockStream] = []  # LIFO stack
        self._buffers_in_flight = 0
        self._active_fetches = 0
        self._source_exhausted = False
        self._closed = False
        self._error: Optional[BaseException] = None
        self._desired_threads = self._predictor.current
        self._thread_seq = 0
        self._threads: List[threading.Thread] = []
        # stats (printStatistics parity, :155-186)
        self._stat_bytes = 0
        self._stat_blocks = 0
        self._stat_prefetch_ns = 0
        self._stat_wait_ns = 0
        self._max_observed_threads = 1
        self._stats_printed = False
        # the waits' timeouts only insure against a lost notify; one that
        # fires with its condition unmet is logged, at most once an interval
        self._backstop_warn_interval_s = 30.0
        self._last_backstop_warn = -float("inf")
        self._configure_threads()

    def _warn_backstop(self, which: str, detail: str) -> None:
        """Caller holds ``self._lock`` and saw a timed-out wait whose
        condition is still unmet."""
        now = time.monotonic()
        if now - self._last_backstop_warn < self._backstop_warn_interval_s:
            return
        self._last_backstop_warn = now
        logger.warning(
            "prefetch %s wait woke on its backstop timeout, not a notify: %s; "
            "buffers_in_flight=%d/%d active_fetches=%d completed=%d threads=%d "
            "source_exhausted=%s",
            which, detail, self._buffers_in_flight, self._max_buffer_size,
            self._active_fetches, len(self._completed), len(self._threads),
            self._source_exhausted,
        )

    # --- producer side ---
    def _configure_threads(self) -> None:
        with self._lock:
            if self._closed:
                return
            while len(self._threads) < self._desired_threads:
                tid = self._thread_seq
                self._thread_seq += 1
                t = threading.Thread(
                    target=self._prefetch_loop, args=(tid,), daemon=True,
                    name=f"prefetch-{tid}",
                )
                self._threads.append(t)
                self._max_observed_threads = max(self._max_observed_threads, len(self._threads))
                t.start()
            # threads past the desired count retire themselves in _prefetch_loop

    def _prefetch_loop(self, thread_id: int) -> None:
        me = threading.current_thread()
        while True:
            with self._lock:
                # retire by position, not id (ids only grow, so an id test
                # would stop every thread respawned after a scale-down)
                try:
                    position = self._threads.index(me)
                except ValueError:
                    position = 0
                if (
                    position >= self._desired_threads
                    or self._source_exhausted
                    or self._closed
                    or self._error is not None
                ):
                    if me in self._threads:
                        self._threads.remove(me)
                    self._lock.notify_all()
                    return
            with self._source_lock:
                if self._source_exhausted or self._closed:
                    continue
                try:
                    item = next(self._source)
                except StopIteration:
                    with self._lock:
                        self._source_exhausted = True
                    continue
                except BaseException as e:  # surfaces on the consumer
                    with self._lock:
                        self._error = e
                        self._source_exhausted = True
                    continue
            block, stream = item
            bsize = min(self._max_buffer_size, max(1, stream.max_bytes))
            # a split block's parts share ONE budget claim: the first part
            # here reserves the whole block, siblings piggyback, and the last
            # close releases it. A block funded whole keeps the consumer's
            # reassembly deadlock-free: once one part holds budget, every
            # sibling is funded and completes
            group = getattr(stream, "budget_group", None)
            with self._lock:
                self._active_fetches += 1
                if group is not None:
                    need = min(self._max_buffer_size, group.total)
                    # siblings may race here: each waits until the group is
                    # funded (by whoever claims first) or the budget fits;
                    # the claim is re-checked under this lock, so exactly one
                    # part adds the reservation
                    self._await_budget_locked(need, satisfied=lambda: group.reserved)
                else:
                    # budget wait (:122-135): in-flight buffers within the budget
                    self._await_budget_locked(bsize)
                abandoned = self._closed
                if abandoned:
                    self._active_fetches -= 1
                    self._lock.notify_all()
                elif group is None:
                    self._buffers_in_flight += bsize
                elif not group.reserved:
                    group.reserved = True
                    group.reserved_bytes = need
                    self._buffers_in_flight += need
                    self._lock.notify_all()  # wake siblings parked on the group
            if abandoned:
                stream.close()
                continue
            release = (
                self._release_group_budget(group) if group is not None
                else self._release_budget(bsize)
            )
            try:
                t0 = time.perf_counter_ns()
                # the store GET (chunk-parallel past the fetcher's chunk
                # size), inside the per-object in-flight count the hot
                # fan-out reads
                obj = getattr(getattr(stream, "data_block", None), "name", None)
                if self._fetcher is not None:
                    fetcher = self._fetcher
                    primary = lambda s=stream, n=bsize, o=obj: tracked_get(  # noqa: E731
                        o, lambda: fetcher.prefill(s, n))
                else:
                    primary = lambda s=stream, n=bsize, o=obj: tracked_get(  # noqa: E731
                        o, lambda: _read_up_to(s, n))
                speculation_won = False
                primary_exec_s = None
                if self._speculation is not None and self._speculation.eligible(stream, bsize):
                    buffer, speculation_won, primary_exec_s = self._speculation.prefill(
                        stream, bsize, primary)
                else:
                    buffer = primary()
                dt = time.perf_counter_ns() - t0
                # the speculation threshold's evidence: a fill speculation
                # won (threshold + reconstruction) is left out, and a raced
                # fill the primary won observes the GET's own execution time
                # (pool queue excluded); either would ratchet the quantile
                # up during a straggler episode
                if _metrics.enabled() and not speculation_won:
                    fill_s = primary_exec_s if primary_exec_s is not None else dt / 1e9
                    _H_FILL.observe(fill_s)
                    cls = fill_size_class(bsize)
                    _H_FILL_CLASS.labels(size_class=cls).observe(fill_s)
                    _H_FILL_PER_MIB.labels(size_class=cls).observe(fill_s / fill_norm_mib(bsize))
                prefetched = PrefetchedBlockStream(block, stream, buffer, release)
                with self._lock:
                    self._stat_prefetch_ns += dt
                    self._stat_bytes += len(buffer)
                    self._stat_blocks += 1
                    self._active_fetches -= 1
                    discard = self._closed
                    if not discard:
                        self._completed.append(prefetched)  # LIFO push
                    self._lock.notify_all()
                if discard:
                    prefetched.close()
            except BaseException as e:
                with self._lock:
                    self._error = e
                    self._active_fetches -= 1
                    self._lock.notify_all()
                release(0)  # this stream's share (a group counts it closed)
                stream.close()

    def _await_budget_locked(self, need: int, satisfied=None) -> None:
        """Caller holds ``self._lock``: block until ``need`` budget bytes
        fit, an error is set, the scan is closed or ``satisfied()`` turns
        true (a sibling split part claimed the group's reservation; the
        caller then piggybacks). Every transition that can unblock this
        wait notifies (a release, a group claim, an error, a close); the
        timeout is a backstop."""

        def blocked() -> bool:
            return (
                (satisfied is None or not satisfied())
                and self._buffers_in_flight + need > self._max_buffer_size
                and self._error is None
                and not self._closed
            )

        while blocked():
            notified = self._lock.wait(timeout=5.0)
            if not notified and blocked():
                self._warn_backstop("budget", f"producer needs {need} budget bytes")

    def _release_budget(self, reserved: int):
        def on_close(_buffer_size: int) -> None:
            with self._lock:
                self._buffers_in_flight -= reserved
                self._lock.notify_all()

        return on_close

    def _release_group_budget(self, group):
        """A split part's release: the group's one reservation comes back
        when its last part closes."""

        def on_close(_buffer_size: int) -> None:
            with self._lock:
                group.closed += 1
                if group.closed == group.count and group.reserved:
                    self._buffers_in_flight -= group.reserved_bytes
                    self._lock.notify_all()

        return on_close

    # --- the shared budget surface (non-blocking reservations) ---
    @property
    def budget(self) -> "BufferedPrefetchIterator":
        return self

    def try_reserve(self, nbytes: int) -> bool:
        """Reserve ``nbytes`` of the task budget if available right now."""
        with self._lock:
            if self._buffers_in_flight + nbytes > self._max_buffer_size:
                return False
            self._buffers_in_flight += nbytes
            return True

    def release_reserved(self, nbytes: int) -> None:
        with self._lock:
            self._buffers_in_flight -= nbytes
            self._lock.notify_all()

    # --- consumer side ---
    def __iter__(self) -> "BufferedPrefetchIterator":
        return self

    def __next__(self) -> PrefetchedBlockStream:
        t0 = time.perf_counter_ns()
        with self._lock:
            while not self._completed:
                if self._error is not None:
                    raise self._error
                if self._closed:
                    raise StopIteration
                if self._drained_locked():
                    self._print_statistics()
                    raise StopIteration
                # completions, errors, exhaustion and retirements all notify;
                # the timeout is a backstop against a lost wakeup
                notified = self._lock.wait(timeout=2.0)
                if (
                    not notified
                    and not self._completed
                    and self._error is None
                    and not self._drained_locked()
                ):
                    self._warn_backstop("consumer", "no completed block arrived")
            item = self._completed.pop()  # LIFO pop (:146, 209)
            wait_ns = time.perf_counter_ns() - t0
            self._stat_wait_ns += wait_ns
            self._desired_threads = self._predictor.add_measurement_and_predict(wait_ns)
        self._configure_threads()
        return item

    def _drained_locked(self) -> bool:
        return self._source_exhausted and self._active_fetches == 0 and not self._threads_alive()

    def _threads_alive(self) -> bool:
        self._threads = [t for t in self._threads if t.is_alive()]
        return bool(self._threads)

    def close(self) -> None:
        """End the scan early: stop pulling blocks, close every completed
        stream the consumer never took (their budget comes back), let each
        thread close what it was fetching, and join the threads (each
        within :data:`CLOSE_JOIN_S`). Idempotent; a drained scan has nothing
        left to do."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            pending, self._completed = self._completed, []
            threads = list(self._threads)
            self._lock.notify_all()
        for item in pending:
            item.close()
        deadline = time.monotonic() + CLOSE_JOIN_S
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))

    def _print_statistics(self) -> None:
        if self._stats_printed or self._stat_blocks == 0:
            self._stats_printed = True
            return
        self._stats_printed = True
        total_ns = max(1, self._stat_prefetch_ns)
        mib = self._stat_bytes / (1024 * 1024)
        logger.info(
            "Statistics: %d bytes read in %d blocks (avg %.0f B), waiting %.1f ms, "
            "prefetching %.1f ms (%.1f MiB/s, %.0f%% waiting), threads=%d",
            self._stat_bytes, self._stat_blocks, self._stat_bytes / self._stat_blocks,
            self._stat_wait_ns / 1e6, self._stat_prefetch_ns / 1e6,
            mib / (total_ns / 1e9),
            100.0 * self._stat_wait_ns / max(1, self._stat_wait_ns + self._stat_prefetch_ns),
            self._max_observed_threads,
        )

    @property
    def stats(self) -> dict:
        return {
            "bytes": self._stat_bytes,
            "blocks": self._stat_blocks,
            "wait_ns": self._stat_wait_ns,
            "prefetch_ns": self._stat_prefetch_ns,
            "threads": self._max_observed_threads,
        }
