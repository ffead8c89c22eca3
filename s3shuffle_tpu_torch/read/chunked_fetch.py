"""Read-side transfer plane: chunked concurrent ranged GETs (the JAX
package's ``read/chunked_fetch.py``).

The prefetcher hides store latency across blocks, one prefetch thread per
in-flight block, but each prefill is one serial GET. Prefills larger than
``fetch_chunk_size`` split into concurrent positioned
:meth:`~s3shuffle_tpu_torch.read.block_stream.BlockStream.pread` sub-reads
on a process-wide pool and are reassembled in order, so the prefetch
budget, checksum validation and the codec see the bytes the serial path
would. These threads do store I/O only. The JAX package's metrics and
trace spans are not ported yet.
"""

from __future__ import annotations

import logging
import threading
from typing import List, Optional, Tuple

from s3shuffle_tpu_torch.read.block_stream import BlockStream
from s3shuffle_tpu_torch.utils.growpool import GrowReapExecutor
from s3shuffle_tpu_torch.utils.io import read_fully as _read_up_to

logger = logging.getLogger("s3shuffle_tpu_torch.read")

#: the process-wide ranged-GET pool, sized to the widest current caller
_POOL = GrowReapExecutor("s3shuffle-torch-fetch")
#: backstop of every wait below: a sub-read that outlives it is logged and
#: waited for again (a slow GET, not a lost one, since each sub-read ends)
BACKSTOP_S = 30.0


def wait_result(fut, what: str):
    """``fut.result()``, logging each :data:`BACKSTOP_S` it keeps waiting."""
    while True:
        try:
            return fut.result(timeout=BACKSTOP_S)
        except TimeoutError:
            logger.warning("still waiting for %s after %.0f s", what, BACKSTOP_S)


class ChunkedRangeFetcher:
    """Splits one large prefill into concurrent positioned sub-reads.

    Contract (the serial path's):

    - the returned buffer equals ``read_up_to(stream, n)`` byte for byte;
    - short only at EOF or after a logged I/O error: the prefix up to the
      first short sub-range is returned, later sub-ranges are discarded;
    - the stream cursor advances by exactly the returned length, so the
      synchronous remainder (blocks larger than the prefetch budget) picks
      up where the prefill stopped.
    """

    def __init__(self, chunk_size: int, parallelism: int, max_inflight: Optional[int] = None):
        self.chunk_size = max(1, int(chunk_size))
        self.parallelism = max(1, int(parallelism))
        # bound this fetcher's queued sub-reads so one huge prefill cannot
        # take the shared pool's whole queue
        self._inflight = threading.BoundedSemaphore(max_inflight or self.parallelism * 2)

    @classmethod
    def from_config(cls, cfg) -> Optional["ChunkedRangeFetcher"]:
        """None when the config disables chunking (``fetch_parallelism <=
        1``): the prefetcher then keeps the plain serial prefill."""
        if cfg.fetch_parallelism <= 1:
            return None
        return cls(cfg.fetch_chunk_size, cfg.fetch_parallelism)

    def prefill(self, stream, n: int) -> bytes:
        """Up to ``n`` bytes from ``stream``'s cursor, chunk-parallel when
        the request is big enough and the stream takes positioned reads."""
        if not isinstance(stream, BlockStream) or n <= self.chunk_size:
            return _read_up_to(stream, n)
        n = min(n, stream.available())
        if n <= self.chunk_size:
            return _read_up_to(stream, n)
        start = stream.position
        ranges: List[Tuple[int, int]] = []
        off = 0
        while off < n:
            ln = min(self.chunk_size, n - off)
            ranges.append((start + off, ln))
            off += ln
        futures = []
        try:
            for pos, ln in ranges:
                while not self._inflight.acquire(timeout=BACKSTOP_S):
                    logger.warning("chunked prefill of %s waits for a sub-read slot",
                                   stream.block.name)
                try:
                    futures.append(_POOL.submit(self.parallelism, self._fetch_one, stream, pos, ln))
                except BaseException:
                    self._inflight.release()  # _fetch_one never ran
                    raise
        finally:
            parts: List[bytes] = []
            short = False
            for (_pos, ln), fut in zip(ranges, futures):
                # drained even after a short part
                data = wait_result(fut, f"a sub-read of {stream.block.name}")
                if short:
                    continue
                parts.append(data)
                if len(data) < ln:
                    # EOF or a logged I/O error: the serial path would stop
                    # here too, so keep the prefix
                    short = True
        buffer = b"".join(parts)
        stream.skip(len(buffer))
        return buffer

    def _fetch_one(self, stream: BlockStream, pos: int, length: int) -> bytes:
        try:
            return stream.pread(pos, length)
        finally:
            self._inflight.release()
