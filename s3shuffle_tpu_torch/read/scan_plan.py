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
   when the last member closes.

The bulk index prefetch fans the distinct maps' index GETs out on a
scan-scoped pool before streaming starts; a per-scan
:class:`~s3shuffle_tpu_torch.metadata.helper.ScanIndexMemo` keeps every
index object at one fetch per scan.

Not ported yet: the skew plane's split fan-out of hot partitions (a map
with recorded hot stripes reads the same bytes unsplit), the scan tuner and
its observed iterator, the speculation race, and the metrics and spans.
"""

from __future__ import annotations

import dataclasses
import io
import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, List, Optional, Sequence

from s3shuffle_tpu_torch.metadata.helper import ScanIndexMemo
from s3shuffle_tpu_torch.read.block_iterator import (
    BlockIterator,
    ReadableBlockId,
    resolve_block_range,
)
from s3shuffle_tpu_torch.read.block_stream import BlockStream
from s3shuffle_tpu_torch.read.chunked_fetch import wait_result
from s3shuffle_tpu_torch.read.prefetch import BufferedPrefetchIterator, PrefetchedBlockStream
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher

logger = logging.getLogger("s3shuffle_tpu_torch.read")

#: per-block bytes callback: ``on_block(block_id, intended_bytes)``
OnBlock = Optional[Callable[[object, int], None]]


@dataclasses.dataclass(frozen=True)
class BlockRange:
    """One readable block resolved to its byte range in the data object."""

    block: ReadableBlockId
    start: int
    end: int

    @property
    def length(self) -> int:
        return self.end - self.start


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

    with ThreadPoolExecutor(
        max_workers=min(len(keys), max(1, width)),
        thread_name_prefix="s3shuffle-torch-index-prefetch",
    ) as pool:
        futures = [pool.submit(fetch_one, sid, mid) for sid, mid in keys]
        for fut in futures:
            wait_result(fut, "an index prefetch")


def plan_scan(
    dispatcher: Dispatcher,
    memo: ScanIndexMemo,
    blocks: Sequence[ReadableBlockId],
    gap_bytes: int,
    max_bytes: int,
    prefetch_width: int = 1,
    recovery=None,
) -> List[ScanSegment]:
    """Resolve, filter, group and merge the scan's block list. Zero-length
    ranges are dropped here, before any open; a missing index raises as in
    :func:`~s3shuffle_tpu_torch.read.block_iterator.resolve_block_range`.
    ``recovery`` (the scan's DegradedReader) is fed each data object's
    stripe geometry."""
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
        span = resolve_block_range(memo, block)
        if span is None:
            continue
        data_block, lo, hi = span
        if recovery is not None:
            # the memoized geometry: no extra store op
            recovery.note(memo, block.shuffle_id, block.map_id)
        groups.setdefault(data_block, []).append(BlockRange(block, lo, hi))

    segments: List[ScanSegment] = []
    for data_block, ranges in groups.items():
        ranges.sort(key=lambda r: r.start)
        current: List[BlockRange] = []
        seg_start = seg_end = 0
        for r in ranges:
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


class CoalescedScanIterator:
    """Consumer-facing iterator of per-block streams, driven by a
    :class:`BufferedPrefetchIterator` over planned segments. Single-member
    segments ride the per-block path (lazy open, synchronous remainder past
    the budget). Multi-member segments fit one prefill by construction and
    are sliced into :class:`SlicedBlockStream` members on the consumer
    thread."""

    def __init__(
        self,
        dispatcher: Dispatcher,
        segments: Sequence[ScanSegment],
        max_buffer_size: int,
        max_threads: int,
        fetcher=None,
        on_block: OnBlock = None,
        recovery=None,
    ):
        def segment_streams():
            for seg in segments:
                if len(seg.members) == 1:
                    m = seg.members[0]
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

        self._inner = BufferedPrefetchIterator(
            segment_streams(),
            max_buffer_size=max_buffer_size,
            max_threads=max_threads,
            fetcher=fetcher,
        )
        self._pending: List[SlicedBlockStream] = []

    def __iter__(self) -> "CoalescedScanIterator":
        return self

    def __next__(self):
        while not self._pending:
            item = self._inner.__next__()  # StopIteration and errors propagate
            if isinstance(item.block, ScanSegment):
                self._slice_segment(item)
            else:
                return item
        return self._pending.pop(0)

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
        """End the scan early: the members not handed out are closed (the
        last one returns its segment's budget), then the prefetcher closes."""
        pending, self._pending = self._pending, []
        for stream in pending:
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

def build_scan_iterator(
    dispatcher: Dispatcher,
    memo: ScanIndexMemo,
    blocks: Sequence[ReadableBlockId],
    cfg,
    recovery,
    fetcher=None,
    on_block: OnBlock = None,
) -> Iterator:
    """The reduce scan's prefetching block-stream iterator. With
    ``coalesce_gap_bytes > 0``: plan, then a :class:`CoalescedScanIterator`.
    With ``coalesce_gap_bytes = 0``: the per-block path, request for request
    the reference's (the :class:`BlockIterator` resolves lazily inside the
    prefetch threads; no bulk index prefetch). Both yield per-block streams
    and expose ``stats``, ``budget`` and ``close``. ``recovery`` is the
    scan's :class:`~s3shuffle_tpu_torch.coding.degraded.DegradedReader`,
    built once per scan by the caller; it stays inert for an uncoded scan."""
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
        )
        return CoalescedScanIterator(
            dispatcher,
            segments,
            max_buffer_size=cfg.max_buffer_size_task,
            max_threads=cfg.max_concurrency_task,
            fetcher=fetcher,
            on_block=on_block,
            recovery=recovery,
        )

    def nonempty_streams():
        for block, stream in BlockIterator(dispatcher, memo, blocks, recovery=recovery):
            if on_block is not None:
                on_block(block, stream.max_bytes)
            yield block, stream

    return BufferedPrefetchIterator(
        nonempty_streams(),
        max_buffer_size=cfg.max_buffer_size_task,
        max_threads=cfg.max_concurrency_task,
        fetcher=fetcher,
    )
