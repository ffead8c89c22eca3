"""Grow-on-demand, idle-reaped shared thread pool (the JAX package's
``utils/growpool.py``), the lifecycle of the process-wide ranged-GET pool
(``read/chunked_fetch.py``):

- the pool is sized to the largest width callers are currently asking for
  (callers with different configs share one pool, as they share one
  backend);
- growing swaps in a wider pool at once;
- shrinking is idle-reaped: when every submit for ``reap_idle_s`` wanted
  less than the pool's width, the pool swaps down to the requested width
  and the superseded pool drains its queued work and retires its threads;
- submission happens under the swap lock, so a concurrent swap never shuts
  the pool down between lookup and submit.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional


class GrowReapExecutor:
    """One process-wide pool with the grow/reap lifecycle above."""

    def __init__(self, thread_name_prefix: str, reap_idle_s: float = 30.0):
        self.thread_name_prefix = thread_name_prefix
        self.reap_idle_s = float(reap_idle_s)
        self._lock = threading.Lock()
        self.pool: Optional[ThreadPoolExecutor] = None
        self.width = 0
        self.wide_use = 0.0  # monotonic stamp of the last full-width submit

    def submit(self, width: int, fn, *args):
        width = max(1, width)
        with self._lock:
            now = time.monotonic()
            shrink = (
                self.pool is not None
                and width < self.width
                and now - self.wide_use >= self.reap_idle_s
            )
            if self.pool is None or width > self.width or shrink:
                old = self.pool
                self.pool = ThreadPoolExecutor(
                    max_workers=width, thread_name_prefix=self.thread_name_prefix
                )
                self.width = width
                if old is not None:
                    old.shutdown(wait=False)
            if width >= self.width:
                self.wide_use = now
            return self.pool.submit(fn, *args)
