"""Per-key-locked concurrent cache (the JAX package's
``utils/concurrent_map.py``, parity with the reference's
``ConcurrentObjectMap``): ``get_or_else_put`` computes each value once per
key without serialising unrelated keys, and filtered bulk removal with an
optional action per evicted value."""

from __future__ import annotations

import threading
from typing import Callable, Dict, Generic, Iterable, Optional, TypeVar

K = TypeVar("K")
V = TypeVar("V")


class ConcurrentObjectMap(Generic[K, V]):
    def __init__(self) -> None:
        self._values: Dict[K, V] = {}
        self._key_locks: Dict[K, threading.Lock] = {}
        self._global_lock = threading.Lock()

    def _lock_for(self, key: K) -> threading.Lock:
        with self._global_lock:
            lock = self._key_locks.get(key)
            if lock is None:
                lock = threading.Lock()
                self._key_locks[key] = lock
            return lock

    def get(self, key: K) -> Optional[V]:
        return self._values.get(key)

    def put(self, key: K, value: V) -> None:
        with self._lock_for(key):
            self._values[key] = value

    def get_or_else_put(self, key: K, compute: Callable[[K], V]) -> V:
        # fast path without the key lock: dict reads are atomic under the GIL
        value = self._values.get(key)
        if value is not None:
            return value
        with self._lock_for(key):
            value = self._values.get(key)
            if value is None:
                value = compute(key)
                self._values[key] = value
            return value

    def remove(
        self,
        predicate: Callable[[K], bool],
        action: Optional[Callable[[V], None]] = None,
    ) -> int:
        """Remove every entry whose key matches, running ``action`` on each
        removed value (e.g. closing a cached stream); returns the count."""
        removed = 0
        for key in [k for k in list(self._values.keys()) if predicate(k)]:
            with self._lock_for(key):
                value = self._values.pop(key, None)
            with self._global_lock:
                self._key_locks.pop(key, None)
            if value is not None:
                removed += 1
                if action is not None:
                    action(value)
        return removed

    def clear(self, action: Optional[Callable[[V], None]] = None) -> None:
        self.remove(lambda _k: True, action)

    def keys(self) -> Iterable[K]:
        return list(self._values.keys())

    def __len__(self) -> int:
        return len(self._values)

    def __contains__(self, key: K) -> bool:
        return key in self._values
