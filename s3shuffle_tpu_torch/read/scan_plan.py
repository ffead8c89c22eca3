"""Reduce-side coalesced scan planner: fewer, bigger GETs (the JAX package's
``read/scan_plan.py``).

The reference issues one ranged GET per block (``S3ShuffleBlockStream``),
which on an object store makes request count, not bandwidth, the reduce
side's cost. This module:

1. **plans**: takes the scan's whole block list, resolves every block's
   byte range from the map indexes (bulk-prefetched, see below), drops
   zero-length ranges before any open, groups ranges by data object and
   merges adjacent or nearby ones into segments under
   ``coalesce_gap_bytes`` (gap bytes are fetched and discarded) and
   ``coalesce_max_bytes`` (clamped to ``max_buffer_size_task``, so a merged
   segment completes in one prefill). ``coalesce_gap_bytes=0`` keeps the
   per-block path and its request pattern exactly;
2. **fetches**: each segment is one ranged GET through the
   :class:`~s3shuffle_tpu_torch.read.prefetch.BufferedPrefetchIterator`
   budget and threads (chunk-parallel past ``fetch_chunk_size``);
3. **slices**: the fetched segment is cut into per-block streams through
   zero-copy memoryviews, the bytes the per-block path would deliver. A
   segment GET that fails mid-flight leaves every later member a logged-EOF
   prefix, which checksum validation reports, and the budget comes back
   when the last member closes;
4. **splits** (the skew plane): a block whose map recorded a split stripe
   (``MapLocation.split_bytes``, from the skew trailer or the fat index v3)
   and that fits the budget whole fans out as independent sub-range
   segments, one GET each (:class:`SplitPart`, at most
   :data:`MAX_SPLIT_PARTS`), funded by one budget claim
   (:class:`SplitGroup`) and reassembled in part order
   (:class:`SplitBlockStream`): the same bytes as the unsplit read.

The bulk index prefetch fans the distinct maps' index GETs out on a
scan-scoped pool before streaming starts; a per-scan
:class:`~s3shuffle_tpu_torch.metadata.helper.ScanIndexMemo` keeps every
index object at one fetch per scan.

:func:`build_scan_iterator` also builds the scan's
:class:`~s3shuffle_tpu_torch.coding.degraded.SpeculativeFetcher` when
``speculative_read_quantile > 0`` or ``hot_read_fanout > 0`` (the JAX
default 0.99 builds it; with the metrics registry off it never races).

With the metrics registry on, the planner counts merged segments
(``read_coalesced_segments_total``), the GETs they saved
(``read_gets_saved_total``) and the gap bytes fetched and discarded
(``read_coalesce_waste_bytes_total``), and times the bulk index prefetch
(``read_index_prefetch_seconds``). With ``autotune`` on,
:func:`build_scan_iterator` takes the read knobs from the dispatcher's
:class:`~s3shuffle_tpu_torch.tuning.ScanTuner` (one consult per scan, see
:func:`tuned_scan_config`) and feeds it the scan's (wall, bytes) at clean
exhaustion.

The bulk index prefetch runs in a ``read.index_prefetch`` trace span.
"""

from __future__ import annotations

import dataclasses
import io
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, List, Optional, Sequence

from s3shuffle_tpu_torch.coding.degraded import DegradedReader, SpeculativeFetcher
from s3shuffle_tpu_torch.metadata.helper import ScanIndexMemo
from s3shuffle_tpu_torch.metrics import registry as _metrics
from s3shuffle_tpu_torch.read.block_iterator import (
    BlockIterator,
    ReadableBlockId,
    missing_index_raises,
    resolve_block_range,
)
from s3shuffle_tpu_torch.read.block_stream import BlockStream
from s3shuffle_tpu_torch.read.chunked_fetch import wait_result
from s3shuffle_tpu_torch.read.prefetch import BufferedPrefetchIterator, PrefetchedBlockStream
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
from s3shuffle_tpu_torch.utils import racewitness, trace

logger = logging.getLogger("s3shuffle_tpu_torch.read")

_C_SEGMENTS = _metrics.REGISTRY.counter(
    "read_coalesced_segments_total",
    "Merged multi-block segments fetched as one ranged GET",
)
_C_GETS_SAVED = _metrics.REGISTRY.counter(
    "read_gets_saved_total",
    "Ranged GETs the scan planner avoided (member blocks merged minus "
    "segments issued)",
)
_C_WASTE = _metrics.REGISTRY.counter(
    "read_coalesce_waste_bytes_total",
    "Gap bytes fetched and discarded by coalesced segments (the over-read "
    "price of merging across coalesce_gap_bytes)",
)
_H_INDEX_PREFETCH = _metrics.REGISTRY.histogram(
    "read_index_prefetch_seconds",
    "Wall time of the planner's bulk map-index prefetch fan-out, per scan",
)

#: per-block bytes callback: ``on_block(block_id, intended_bytes)``
OnBlock = Optional[Callable[[object, int], None]]


@dataclasses.dataclass(frozen=True)
class BlockRange:
    """One readable block resolved to its byte range in the data object.
    ``split`` is the skew plane's stripe for this range (0 = never split):
    a longer range fans out as :class:`SplitPart` segments. ``part`` marks
    a range that is one such sub-range."""

    block: ReadableBlockId
    start: int
    end: int
    split: int = 0
    part: Optional["SplitPart"] = None

    @property
    def length(self) -> int:
        return self.end - self.start


#: cap of one block's split fan-out: past the prefetch pool's width more
#: parts only add requests, and a tiny recorded stripe must not turn one
#: fat partition into thousands of GETs
MAX_SPLIT_PARTS = 32


class SplitGroup:
    """The shared state of one split block's parts, and the prefetcher's
    budget group: the first part at the budget wait reserves the whole
    block in one claim (``reserved``, ``reserved_bytes``), later parts
    piggyback, and the last part's close releases it (``closed``). Funding
    the block whole keeps the consumer's reassembly deadlock-free: once a
    part holds budget every sibling is funded, so the consumer never waits
    on a part that waits on budget the consumer holds (the planner splits
    only blocks that fit the budget whole). The three fields change only
    under the prefetcher's lock."""

    __slots__ = ("block", "start", "end", "count", "reserved", "reserved_bytes", "closed")

    def __init__(self, block, start: int, end: int, count: int):
        self.block = block
        self.start = start
        self.end = end
        self.count = count
        self.reserved = False
        self.reserved_bytes = 0
        self.closed = 0
        # race witness (no-op unless installed): the claim, piggyback and
        # release run entirely under the prefetcher's lock
        racewitness.watch_shared(self, ("reserved", "reserved_bytes", "closed"))

    @property
    def total(self) -> int:
        return self.end - self.start


class SplitPart:
    """One sub-range of a split block, planned as a segment of its own so
    its GET runs on its own prefetch thread; the consumer reassembles the
    parts in index order."""

    __slots__ = ("group", "index", "start", "end")

    def __init__(self, group: SplitGroup, index: int, start: int, end: int):
        self.group = group
        self.index = index
        self.start = start
        self.end = end

    @property
    def length(self) -> int:
        return self.end - self.start

    @property
    def name(self) -> str:
        return f"{self.group.block.name}[part {self.index + 1}/{self.group.count}]"

    def __repr__(self) -> str:
        return f"SplitPart({self.name}, [{self.start}:{self.end}))"


class ScanSegment:
    """A run of :class:`BlockRange` members on one data object, fetched as a
    single ranged GET over ``[start, end)``."""

    __slots__ = ("data_block", "start", "end", "members")

    def __init__(self, data_block, start: int, end: int, members: List[BlockRange]):
        self.data_block = data_block
        self.start = start
        self.end = end
        self.members = members

    @property
    def length(self) -> int:
        return self.end - self.start

    @property
    def waste_bytes(self) -> int:
        """Gap bytes inside the segment that belong to no member."""
        return self.length - sum(m.length for m in self.members)

    @property
    def name(self) -> str:
        """Log label (the planner's analog of ``BlockId.name``)."""
        return f"scan_{self.data_block.name}[{self.start}:{self.end})"

    def __repr__(self) -> str:
        return f"ScanSegment({self.name}, members={len(self.members)})"


# --- planning ---

def _bulk_prefetch_indices(memo: ScanIndexMemo, keys: Sequence[tuple], width: int) -> None:
    """Fan index fetches out on a scan-scoped pool sized to the scan's
    concurrency (not the shared ranged-GET pool, whose width is the data
    GET cap). Failures are memoized by the memo and raised at resolution
    time, so they keep their meaning in one place."""

    def fetch_one(shuffle_id: int, map_id: int) -> None:
        try:
            memo.get_partition_lengths(shuffle_id, map_id)
        except (OSError, ValueError) as e:
            logger.debug(
                "index prefetch for shuffle %d map %d deferred error: %s",
                shuffle_id, map_id, e,
            )

    t0 = time.perf_counter_ns()
    with trace.span("read.index_prefetch", maps=len(keys)):
        with ThreadPoolExecutor(
            max_workers=min(len(keys), max(1, width)),
            thread_name_prefix="s3shuffle-torch-index-prefetch",
        ) as pool:
            futures = [pool.submit(fetch_one, sid, mid) for sid, mid in keys]
            for fut in futures:
                wait_result(fut, "an index prefetch")
    if _metrics.enabled():
        _H_INDEX_PREFETCH.observe((time.perf_counter_ns() - t0) / 1e9)


def plan_scan(
    dispatcher: Dispatcher,
    memo: ScanIndexMemo,
    blocks: Sequence[ReadableBlockId],
    gap_bytes: int,
    max_bytes: int,
    prefetch_width: int = 1,
    recovery=None,
    split_budget: int = 0,
) -> List[ScanSegment]:
    """Resolve, filter, group and merge the scan's block list. Zero-length
    ranges are dropped here, before any open (listing mode names every
    partition in range); a missing index is skipped in pure listing mode
    and raises otherwise, as in
    :func:`~s3shuffle_tpu_torch.read.block_iterator.resolve_block_range`.
    ``recovery`` (the scan's DegradedReader) is fed each data object's
    stripe geometry. ``split_budget`` (the prefetch budget; 0 = never
    split) bounds the blocks the skew plane fans out: a range longer than
    its map's recorded stripe that fits the budget whole becomes
    :class:`SplitPart` segments, never merged with neighbours."""
    must_raise = missing_index_raises(dispatcher.config)
    keys: List[tuple] = []
    seen = set()
    for block in blocks:
        key = (block.shuffle_id, block.map_id)
        if key not in seen:
            seen.add(key)
            keys.append(key)
    if len(keys) > 1:
        _bulk_prefetch_indices(memo, keys, prefetch_width)

    # resolve ranges, grouped per data object in first-appearance order
    groups: dict = {}
    for block in blocks:
        span = resolve_block_range(memo, block, must_raise)
        if span is None:
            continue
        data_block, lo, hi = span
        if recovery is not None:
            # the memoized geometry: no extra store op
            recovery.note(memo, block.shuffle_id, block.map_id)
        split = 0
        if split_budget > 0:
            # the recorded stripe, from the memoized location (no store op);
            # a block past the budget keeps the unsplit prefill and its
            # synchronous remainder, as an oversized segment does
            try:
                loc = memo.resolve_map_location(block.shuffle_id, block.map_id)
            except (OSError, ValueError):
                loc = None
            if (
                loc is not None
                and loc.split_bytes > 0
                and loc.split_bytes < hi - lo <= split_budget
            ):
                split = max(int(loc.split_bytes), -(-(hi - lo) // MAX_SPLIT_PARTS))
        groups.setdefault(data_block, []).append(BlockRange(block, lo, hi, split=split))

    segments: List[ScanSegment] = []
    for data_block, ranges in groups.items():
        ranges.sort(key=lambda r: r.start)
        current: List[BlockRange] = []
        seg_start = seg_end = 0
        for r in ranges:
            if r.split and r.length > r.split:
                # a hot partition's fan-out: one solo segment per sub-range
                # (merging them again would undo the parallelism)
                if current:
                    segments.append(ScanSegment(data_block, seg_start, seg_end, current))
                    current = []
                n_parts = -(-r.length // r.split)
                grp = SplitGroup(r.block, r.start, r.end, n_parts)
                for i in range(n_parts):
                    plo = r.start + i * r.split
                    phi = min(plo + r.split, r.end)
                    part = SplitPart(grp, i, plo, phi)
                    segments.append(ScanSegment(
                        data_block, plo, phi, [BlockRange(r.block, plo, phi, part=part)]
                    ))
                continue
            if current and (
                r.start - seg_end <= gap_bytes
                and max(seg_end, r.end) - seg_start <= max_bytes
            ):
                current.append(r)
                seg_end = max(seg_end, r.end)
                continue
            if current:
                segments.append(ScanSegment(data_block, seg_start, seg_end, current))
            current = [r]
            seg_start, seg_end = r.start, r.end
        if current:
            segments.append(ScanSegment(data_block, seg_start, seg_end, current))
    return segments


# --- slicing ---

class SlicedBlockStream(io.RawIOBase):
    """One member block's bytes, sliced zero-copy out of a fetched segment
    buffer; the :class:`PrefetchedBlockStream` surface the reader consumes.
    ``close`` drops the view and tells the segment, whose last member close
    releases the prefetch budget. A segment GET that went short leaves this
    slice shorter than ``max_bytes``: reads serve the surviving prefix, then
    EOF, which checksum validation reports."""

    def __init__(self, block, view: memoryview, expected_bytes: int, on_close):
        self.block = block
        self.max_bytes = expected_bytes
        self._view = view
        self._pos = 0
        self._on_close = on_close
        self._closed_once = False

    def readable(self) -> bool:
        return True

    def read(self, size: int = -1) -> bytes:
        if self._pos >= len(self._view):
            return b""
        if size is None or size < 0:
            size = len(self._view) - self._pos
        end = min(self._pos + size, len(self._view))
        out = bytes(self._view[self._pos : end])
        self._pos = end
        return out

    def readall(self) -> bytes:
        out = bytes(self._view[self._pos :])
        self._pos = len(self._view)
        return out

    def close(self) -> None:
        if self._closed_once:
            if not self.closed:
                logger.warning("Double close of sliced stream for %s", self.block)
            return
        self._closed_once = True
        self._view = memoryview(b"")
        if self._on_close is not None:
            self._on_close()
        super().close()


class SplitBlockStream(io.RawIOBase):
    """One logical block reassembled from its split parts' prefills, served
    in part order: the bytes of the unsplit stream (the parts tile the
    block's range). A part that went short (a failed GET) leaves the
    surviving prefix, then EOF, which checksum validation reports; never a
    later part's bytes at the wrong offset. ``close`` closes every part;
    the last one releases the block's budget claim."""

    def __init__(self, group: SplitGroup, parts: List):
        self.block = group.block
        self.max_bytes = group.total
        self._parts = parts  # prefetched part streams, in index order
        self._idx = 0
        self._served_in_part = 0
        self._failed = False
        self._closed_once = False

    def readable(self) -> bool:
        return True

    def read(self, size: int = -1) -> bytes:
        if size is None or size < 0:
            return self.readall()
        while not self._failed and self._idx < len(self._parts):
            part = self._parts[self._idx]
            expected = part.block.length  # the SplitPart's sub-range
            remaining = expected - self._served_in_part
            if remaining <= 0:
                self._idx += 1
                self._served_in_part = 0
                continue
            chunk = part.read(min(size, remaining))
            if not chunk:
                self._failed = True
                logger.warning(
                    "Split part %s went short (%d of %d bytes); block %s "
                    "degrades to a logged-EOF prefix",
                    part.block.name, self._served_in_part, expected, self.block,
                )
                return b""
            self._served_in_part += len(chunk)
            return chunk
        return b""

    def readall(self) -> bytes:
        chunks = []
        while True:
            chunk = self.read(1 << 20)
            if not chunk:
                return b"".join(chunks)
            chunks.append(chunk)

    def close(self) -> None:
        if self._closed_once:
            return
        self._closed_once = True
        for part in self._parts:
            part.close()
        self._parts = []
        super().close()


class CoalescedScanIterator:
    """Consumer-facing iterator of per-block streams, driven by a
    :class:`BufferedPrefetchIterator` over planned segments. Single-member
    segments ride the per-block path (lazy open, synchronous remainder past
    the budget). Multi-member segments fit one prefill by construction and
    are sliced into :class:`SlicedBlockStream` members on the consumer
    thread. Split parts arrive as independent prefills in completion order
    and are reassembled into one :class:`SplitBlockStream` once every
    sibling landed; other blocks keep flowing meanwhile. A scan holding
    split parts starts the prefetcher at one thread per part (capped at
    ``max_threads``) instead of the cold start's one."""

    def __init__(
        self,
        dispatcher: Dispatcher,
        segments: Sequence[ScanSegment],
        max_buffer_size: int,
        max_threads: int,
        fetcher=None,
        on_block: OnBlock = None,
        recovery=None,
        speculation=None,
    ):
        def segment_streams():
            for seg in segments:
                if len(seg.members) == 1:
                    m = seg.members[0]
                    if m.part is not None:
                        part = m.part
                        # the logical block counts once, at its full length
                        if on_block is not None and part.index == 0:
                            on_block(part.group.block, part.group.total)
                        stream = BlockStream(
                            dispatcher, part, seg.data_block, m.start, m.end,
                            recovery=recovery,
                        )
                        # the prefetcher's budget-group protocol
                        stream.budget_group = part.group
                        yield part, stream
                        continue
                    if on_block is not None:
                        on_block(m.block, m.length)
                    yield m.block, BlockStream(
                        dispatcher, m.block, seg.data_block, m.start, m.end,
                        recovery=recovery,
                    )
                else:
                    if on_block is not None:
                        for m in seg.members:
                            on_block(m.block, m.length)
                    yield seg, BlockStream(
                        dispatcher, seg, seg.data_block, seg.start, seg.end,
                        recovery=recovery,
                    )

        n_parts = sum(
            1 for seg in segments if len(seg.members) == 1 and seg.members[0].part is not None
        )
        self._inner = BufferedPrefetchIterator(
            segment_streams(),
            max_buffer_size=max_buffer_size,
            max_threads=max_threads,
            fetcher=fetcher,
            speculation=speculation,
            initial_threads=min(max_threads, n_parts) if n_parts else 1,
        )
        self._pending: List[SlicedBlockStream] = []
        self._split_parts: dict = {}  # SplitGroup -> {index: prefetched part}

    def __iter__(self) -> "CoalescedScanIterator":
        return self

    def __next__(self):
        while not self._pending:
            item = self._inner.__next__()  # StopIteration and errors propagate
            if isinstance(item.block, ScanSegment):
                self._slice_segment(item)
            elif isinstance(item.block, SplitPart):
                assembled = self._note_part(item)
                if assembled is not None:
                    return assembled
            else:
                return item
        return self._pending.pop(0)

    def _note_part(self, item: PrefetchedBlockStream):
        """Hold one split part's prefill; once the block's parts are all
        here, the reassembled stream (parts complete LIFO, so only the
        index orders them)."""
        part: SplitPart = item.block
        grp = part.group
        parts = self._split_parts.setdefault(grp, {})
        parts[part.index] = item
        if len(parts) < grp.count:
            return None
        del self._split_parts[grp]
        return SplitBlockStream(grp, [parts[i] for i in range(grp.count)])

    def _slice_segment(self, item: PrefetchedBlockStream) -> None:
        seg: ScanSegment = item.block
        view = item.buffer_view()
        fetched = len(view)
        if fetched < seg.length:
            # the BlockStream logged the failed read; this names the members
            logger.warning(
                "Coalesced segment %s fetched %d of %d bytes; %d member "
                "block(s) degrade to logged-EOF prefixes",
                seg.name, fetched, seg.length, len(seg.members),
            )
        if _metrics.enabled():
            _C_SEGMENTS.inc()
            _C_GETS_SAVED.inc(len(seg.members) - 1)
            if fetched == seg.length:
                _C_WASTE.inc(seg.waste_bytes)
        remaining = [len(seg.members)]
        lock = threading.Lock()

        def on_member_close() -> None:
            with lock:
                remaining[0] -= 1
                last = remaining[0] == 0
            if last:
                item.close()  # releases the prefetch budget

        for m in seg.members:
            lo = min(m.start - seg.start, fetched)
            hi = min(m.end - seg.start, fetched)
            self._pending.append(SlicedBlockStream(m.block, view[lo:hi], m.length, on_member_close))

    def close(self) -> None:
        """End the scan early: the members and split parts not handed out
        are closed (the last of each returns its budget), then the
        prefetcher closes."""
        pending, self._pending = self._pending, []
        held, self._split_parts = self._split_parts, {}
        for stream in pending:
            stream.close()
        for parts in held.values():
            for stream in parts.values():
                stream.close()
        self._inner.close()

    @property
    def stats(self) -> dict:
        return self._inner.stats

    @property
    def budget(self) -> BufferedPrefetchIterator:
        """The scan's memory budget (the inner prefetcher)."""
        return self._inner.budget


# --- entry point ---

def tuned_scan_config(dispatcher: Dispatcher, cfg):
    """The scan-plan-time autotuner consult: ``cfg`` with the read knobs
    replaced by the :class:`~s3shuffle_tpu_torch.tuning.ScanTuner`'s current
    rungs; ``cfg`` itself when autotune is off (the dispatcher then has no
    tuner). A caller that builds its own
    :class:`~s3shuffle_tpu_torch.read.chunked_fetch.ChunkedRangeFetcher`
    consults first and passes ``tuner_consulted=True`` to
    :func:`build_scan_iterator`, so the fetcher and the planner see the same
    rungs (one consult per scan)."""
    tuner = dispatcher.scan_tuner
    if tuner is None or not cfg.autotune:
        return cfg
    return tuner.tuned(cfg)


class _ObservedScanIterator:
    """Pass-through over a scan's stream iterator that feeds the scan tuner
    one (wall, bytes) sample, at clean exhaustion only: a scan that fails or
    is closed early feeds nothing."""

    def __init__(self, inner, tuner):
        self._inner = inner
        self._tuner = tuner
        self._t0 = time.perf_counter()
        self._reported = False

    def __iter__(self) -> "_ObservedScanIterator":
        return self

    def __next__(self):
        try:
            return next(self._inner)
        except StopIteration:
            if not self._reported:
                self._reported = True
                wall = time.perf_counter() - self._t0
                self._tuner.observe_scan(wall, self._inner.stats.get("bytes", 0))
            raise

    def close(self) -> None:
        self._inner.close()

    @property
    def stats(self) -> dict:
        return self._inner.stats

    @property
    def budget(self):
        return self._inner.budget


def build_scan_iterator(
    dispatcher: Dispatcher,
    memo: ScanIndexMemo,
    blocks: Sequence[ReadableBlockId],
    cfg,
    fetcher=None,
    on_block: OnBlock = None,
    tuner_consulted: bool = False,
    recovery=None,
) -> Iterator:
    """The reduce scan's prefetching block-stream iterator. With
    ``coalesce_gap_bytes > 0``: plan, then a :class:`CoalescedScanIterator`.
    With ``coalesce_gap_bytes = 0``: the per-block path, request for request
    the reference's (the :class:`BlockIterator` resolves lazily inside the
    prefetch threads; no bulk index prefetch). Both yield per-block streams
    and expose ``stats``, ``budget`` and ``close``. ``recovery`` is the
    scan's :class:`~s3shuffle_tpu_torch.coding.degraded.DegradedReader`,
    built once per scan by the caller on its device (None: one built here,
    on the CUDA device, as the JAX scan builds its own); it stays inert for
    an uncoded scan.
    The scan's :class:`~s3shuffle_tpu_torch.coding.degraded.SpeculativeFetcher`
    carries both read-side coded behaviours: the straggler race (quantile >
    0, and only with the metrics registry on) and the hot fan-out
    (``hot_read_fanout > 0``); either knob builds it, and each gates itself.

    With ``autotune`` on, the scan tuner is consulted here, unless the
    caller consulted already (:func:`tuned_scan_config`) and passes
    ``tuner_consulted=True``; either way the returned iterator reports the
    scan's (wall, bytes) to the tuner at clean exhaustion."""
    tuner = dispatcher.scan_tuner
    if tuner is not None and cfg.autotune:
        if not tuner_consulted:
            cfg = tuner.tuned(cfg)
    else:
        tuner = None
    if recovery is None:
        recovery = DegradedReader(dispatcher)
    speculation = None
    if cfg.speculative_read_quantile > 0 or cfg.hot_read_fanout > 0:
        speculation = SpeculativeFetcher(
            recovery,
            cfg.speculative_read_quantile,
            width=max(1, cfg.max_concurrency_task),
            hot_fanout=cfg.hot_read_fanout,
        )
    if cfg.coalesce_gap_bytes > 0:
        segments = plan_scan(
            dispatcher,
            memo,
            blocks,
            gap_bytes=cfg.coalesce_gap_bytes,
            # a multi-block segment must complete in one prefill
            max_bytes=min(cfg.coalesce_max_bytes, cfg.max_buffer_size_task),
            # the fan-out is a start-up barrier: size it to the scan's
            # concurrency, not just the chunk-transfer width
            prefetch_width=max(1, cfg.fetch_parallelism, cfg.max_concurrency_task),
            recovery=recovery,
            # recorded hot-partition stripes fan out within the budget
            split_budget=cfg.max_buffer_size_task,
        )
        it = CoalescedScanIterator(
            dispatcher,
            segments,
            max_buffer_size=cfg.max_buffer_size_task,
            max_threads=cfg.max_concurrency_task,
            fetcher=fetcher,
            on_block=on_block,
            recovery=recovery,
            speculation=speculation,
        )
        return it if tuner is None else _ObservedScanIterator(it, tuner)

    def nonempty_streams():
        for block, stream in BlockIterator(dispatcher, memo, blocks, recovery=recovery):
            if on_block is not None:
                on_block(block, stream.max_bytes)
            yield block, stream

    it = BufferedPrefetchIterator(
        nonempty_streams(),
        max_buffer_size=cfg.max_buffer_size_task,
        max_threads=cfg.max_concurrency_task,
        fetcher=fetcher,
        speculation=speculation,
    )
    return it if tuner is None else _ObservedScanIterator(it, tuner)
