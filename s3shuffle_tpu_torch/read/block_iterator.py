"""Maps reduce-side block ids to ranged block streams (the JAX package's
``read/block_iterator.py``, metadata mode; parity with the reference's
``S3ShuffleBlockIterator``, S3ShuffleBlockIterator.scala:10-57): for each
``ShuffleBlockId`` / ``ShuffleBlockBatchId``, look up the map output's
cumulative offsets and build a :class:`BlockStream` over the block's range.

The map-output tracker promised every block, so a missing index raises
(the reference's consistency canary, :46-53). Zero-length blocks are
dropped before a stream is built, and ``helper`` may be a per-scan
:class:`~s3shuffle_tpu_torch.metadata.helper.ScanIndexMemo`, so one scan
never fetches an index object twice. Listing mode (no tracker) is not
ported yet.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Tuple, Union

from s3shuffle_tpu_torch.block_ids import ShuffleBlockBatchId, ShuffleBlockId
from s3shuffle_tpu_torch.read.block_stream import BlockStream
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher

ReadableBlockId = Union[ShuffleBlockId, ShuffleBlockBatchId]


def reduce_span(block: ReadableBlockId) -> Tuple[int, int]:
    """The ``[start, end)`` reduce-id range a readable block covers."""
    if isinstance(block, ShuffleBlockBatchId):
        return block.start_reduce_id, block.end_reduce_id
    return block.reduce_id, block.reduce_id + 1


def resolve_block_range(helper, block: ReadableBlockId) -> Optional[Tuple[object, int, int]]:
    """Resolve one block to ``(data_block, lo, hi)``: the data object that
    holds its bytes and the absolute byte range inside it. Shared by the
    per-block path (:class:`BlockIterator`) and the coalescing planner
    (``read/scan_plan.py``) so the two cannot drift. None for a zero-length
    range; a missing index raises FileNotFoundError, a reduce range past the
    index's bounds IndexError."""
    start, end = reduce_span(block)
    location = helper.resolve_map_location(block.shuffle_id, block.map_id)
    offsets = location.offsets
    if end >= len(offsets):
        raise IndexError(
            f"Block {block.name} reduce range [{start},{end}) out of bounds "
            f"for index with {len(offsets) - 1} partitions"
        )
    lo, hi = int(offsets[start]), int(offsets[end])
    if hi - lo == 0:
        return None
    return location.data_block, lo, hi


class BlockIterator:
    def __init__(self, dispatcher: Dispatcher, helper, blocks: Iterable[ReadableBlockId],
                 recovery=None):
        # helper: a ShuffleHelper or a per-scan ScanIndexMemo; recovery: the
        # scan's DegradedReader
        self.dispatcher = dispatcher
        self.helper = helper
        self._blocks = iter(blocks)
        self._recovery = recovery

    def __iter__(self) -> Iterator[Tuple[ReadableBlockId, BlockStream]]:
        for block in self._blocks:
            span = resolve_block_range(self.helper, block)
            if span is None:
                continue
            data_block, lo, hi = span
            if self._recovery is not None:
                # the resolved (memoized) geometry, so a lost object rebuilds
                self._recovery.note(self.helper, block.shuffle_id, block.map_id)
            yield block, BlockStream(
                self.dispatcher, block, data_block, lo, hi, recovery=self._recovery,
            )
