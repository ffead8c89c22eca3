"""Maps reduce-side block ids to ranged block streams (the JAX package's
``read/block_iterator.py``; parity with the reference's
``S3ShuffleBlockIterator``, S3ShuffleBlockIterator.scala:10-57): for each
``ShuffleBlockId`` / ``ShuffleBlockBatchId``, look up the map output's
cumulative offsets and build a :class:`BlockStream` over the block's range.

A missing index means an uncommitted or partial map output. In pure listing
mode it is skipped with a warning; when ``use_block_manager`` or
``always_create_index`` promised the block it raises, the reference's
consistency canary (:46-53). Zero-length blocks are dropped before a
stream is built, and ``helper`` may be a per-scan
:class:`~s3shuffle_tpu_torch.metadata.helper.ScanIndexMemo`, so one scan
never fetches an index object twice.
"""

from __future__ import annotations

import logging
from typing import Iterable, Iterator, Optional, Tuple, Union

from s3shuffle_tpu_torch.block_ids import ShuffleBlockBatchId, ShuffleBlockId
from s3shuffle_tpu_torch.read.block_stream import BlockStream
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher

logger = logging.getLogger("s3shuffle_tpu_torch.read")

ReadableBlockId = Union[ShuffleBlockId, ShuffleBlockBatchId]


def reduce_span(block: ReadableBlockId) -> Tuple[int, int]:
    """The ``[start, end)`` reduce-id range a readable block covers."""
    if isinstance(block, ShuffleBlockBatchId):
        return block.start_reduce_id, block.end_reduce_id
    return block.reduce_id, block.reduce_id + 1


def must_raise(config) -> bool:
    """Whether a missing index is an error: the tracker or
    ``always_create_index`` promised every map's index."""
    return config.use_block_manager or config.always_create_index


def resolve_block_range(helper, block: ReadableBlockId,
                        raise_missing: bool) -> Optional[Tuple[object, int, int]]:
    """Resolve one block to ``(data_block, lo, hi)``: the data object that
    holds its bytes and the absolute byte range inside it. Shared by the
    per-block path (:class:`BlockIterator`) and the coalescing planner
    (``read/scan_plan.py``) so the two cannot drift. None for a zero-length
    range, and for a missing index unless ``raise_missing`` (see
    :func:`must_raise`), when it raises FileNotFoundError; a reduce range
    past the index's bounds raises IndexError."""
    start, end = reduce_span(block)
    try:
        location = helper.resolve_map_location(block.shuffle_id, block.map_id)
    except FileNotFoundError:
        if raise_missing:
            raise
        logger.warning("Skipping block %s: missing index (listing mode)", block.name)
        return None
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
        raise_missing = must_raise(self.dispatcher.config)
        for block in self._blocks:
            span = resolve_block_range(self.helper, block, raise_missing)
            if span is None:
                continue
            data_block, lo, hi = span
            if self._recovery is not None:
                # the resolved (memoized) geometry, so a lost object rebuilds
                self._recovery.note(self.helper, block.shuffle_id, block.map_id)
            yield block, BlockStream(
                self.dispatcher, block, data_block, lo, hi, recovery=self._recovery,
            )
