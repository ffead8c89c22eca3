"""Host utilities of the port (copies of the JAX package's
``utils/__init__.py`` helpers the record layer needs)."""

from __future__ import annotations

import gc
import threading
import time


class _GcPause:
    """Reentrant, thread-safe pause of the CYCLIC garbage collector for bulk
    container-building phases (aggregator combine, sorter insert). The
    generational collector re-traverses every tracked container per
    collection; building millions of acyclic lists/tuples triggers
    collections constantly. Refcounting still frees everything promptly —
    only cycle detection pauses. The pause nests across task threads
    (process-global flag, depth-counted); the outermost exit restores the
    collector iff this helper disabled it."""

    #: while overlapping tasks keep the pause held continuously, run a
    #: bounded manual collection this often so cycle garbage cannot grow
    #: without limit
    COLLECT_EVERY_S = 30.0

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._depth = 0
        self._we_disabled = False
        self._last_collect = time.monotonic()

    def __enter__(self) -> "_GcPause":
        with self._lock:
            if self._depth == 0:
                self._we_disabled = gc.isenabled()
                if self._we_disabled:
                    gc.disable()
                    self._last_collect = time.monotonic()
            self._depth += 1
        return self

    def __exit__(self, *exc) -> None:
        collect = False
        with self._lock:
            self._depth -= 1
            if self._depth == 0 and self._we_disabled:
                gc.enable()
            elif (
                self._depth > 0
                and self._we_disabled
                and time.monotonic() - self._last_collect > self.COLLECT_EVERY_S
            ):
                self._last_collect = time.monotonic()
                collect = True
        if collect:  # outside the lock: collection can take a while
            gc.collect(1)

    def tick(self) -> None:
        """Bounded collection opportunity for long single-threaded pause
        holders: the timed valve in ``__exit__`` only fires on nested exits,
        so loops call this at coarse checkpoints (spill boundaries)."""
        collect = False
        with self._lock:
            if (
                self._depth > 0
                and self._we_disabled
                and time.monotonic() - self._last_collect > self.COLLECT_EVERY_S
            ):
                self._last_collect = time.monotonic()
                collect = True
        if collect:
            gc.collect(1)


#: module-level instance: ``with gc_paused: ...``
gc_paused = _GcPause()


def parse_size(s: str) -> int:
    """Parse a byte size with an optional k/m/g suffix ("100m", "1g", "4096")."""
    s = str(s).strip().lower()
    for suffix, mult in (("g", 1 << 30), ("m", 1 << 20), ("k", 1 << 10)):
        if s.endswith(suffix):
            return int(float(s[:-1]) * mult)
    return int(s)
