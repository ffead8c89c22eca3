"""Resilient storage plane: classified retries with backoff under deadlines
(the JAX package's ``storage/retrying.py``).

The reference leaves transient store failures (S3 503s, SlowDown,
connection resets) to the Hadoop S3A client's own retry policy
(``fs.s3a.retry.*``). This module is its counterpart: without it one
transient GET fails a reduce task with a ``ChecksumError`` and one
transient PUT fails a map task.

- :func:`is_retriable` classifies an exception. Retriable: connection
  resets and aborts, timeouts, HTTP-5xx-shaped ``OSError`` messages (503,
  SlowDown, InternalError) and the fault injector's ``injected transient``
  marker. Terminal, never retried: ``FileNotFoundError`` (a semantic miss),
  auth and permission failures, and ``ChecksumError`` (a retry cannot fix
  corrupt bytes).
- :class:`RetryPolicy` and :func:`retry_call`: exponential backoff with
  full jitter (``uniform(0, min(cap, base * 2**attempt))``) under a per-op
  wall-clock deadline. ``storage_retries = 0`` turns all of it off.
- :class:`RetryingBackend` wraps any
  :class:`~s3shuffle_tpu_torch.storage.backend.StorageBackend`;
  :func:`~s3shuffle_tpu_torch.storage.backend.get_backend` stacks it over
  every scheme. Its ranged readers re-drive a failed ``read_fully`` on a
  fresh ``open_ranged`` handle, since a poisoned connection does not heal.

Metrics (while the registry is on): ``storage_retries_total{op,scheme}``,
``storage_retry_backoff_seconds`` and
``storage_deadline_exceeded_total{op,scheme}``.
"""

from __future__ import annotations

import errno
import logging
import random
import re as _re
import threading
import time
from dataclasses import dataclass
from typing import BinaryIO, Callable, List, Optional

from s3shuffle_tpu_torch.metrics import registry as _reg
from s3shuffle_tpu_torch.storage.backend import FileStatus, RangedReader, StorageBackend

logger = logging.getLogger("s3shuffle_tpu_torch.storage.retry")

_C_RETRIES = _reg.REGISTRY.counter(
    "storage_retries_total",
    "Store operations re-driven after a retriable failure",
    labelnames=("op", "scheme"),
)
_H_BACKOFF = _reg.REGISTRY.histogram(
    "storage_retry_backoff_seconds",
    "Backoff sleeps between retry attempts (full jitter)",
)
_C_DEADLINE = _reg.REGISTRY.counter(
    "storage_deadline_exceeded_total",
    "Store operations abandoned because the per-op deadline expired",
    labelnames=("op", "scheme"),
)

#: errno values that mean the store, or the path to it, hiccuped
RETRIABLE_ERRNOS = frozenset(
    getattr(errno, name)
    for name in (
        "ECONNRESET",
        "ECONNABORTED",
        "ECONNREFUSED",
        "EPIPE",
        "ETIMEDOUT",
        "EHOSTUNREACH",
        "ENETUNREACH",
        "ENETRESET",
        "EAGAIN",
    )
    if hasattr(errno, name)
)

#: lower-cased message fragments of a 5xx- or throttle-shaped OSError (the
#: fsspec drivers stringify the service error) and the fault injector's
#: transient marker. Named phrases only: bare status codes are matched by
#: the delimited regexes below, because object paths embed map ids
#: ("shuffle_3_503_0.data").
TRANSIENT_MARKERS = (
    "injected transient",
    "slowdown",
    "slow down",
    "service unavailable",
    "serviceunavailable",
    "internalerror",
    "internal error",
    "bad gateway",
    "gateway timeout",
    "requesttimeout",
    "request timeout",
    "too many requests",
    "connection reset",
    "connection aborted",
    "broken pipe",
    "timed out",
)

#: auth-shaped fragments: a retry cannot mint credentials
TERMINAL_MARKERS = (
    "access denied",
    "accessdenied",
    "forbidden",
    "unauthorized",
    "invalidaccesskey",
    "signaturedoesnotmatch",
    "credential",
)

#: a status code counts only when delimited like a service error ("HTTP 503
#: ...", "(503)", "error: 503"), never inside a path or an id
_TRANSIENT_CODE_RE = _re.compile(r"(?:^|[\s(])(?:50[0234]|429)(?:$|[)\s:,.])")
_TERMINAL_CODE_RE = _re.compile(r"(?:^|[\s(])40[13](?:$|[)\s:,.])")


def is_retriable(exc: BaseException) -> bool:
    """True: transient, re-drive the op. False: terminal, surface it."""
    if isinstance(
        exc,
        (
            FileNotFoundError,
            PermissionError,
            IsADirectoryError,
            NotADirectoryError,
            FileExistsError,
        ),
    ):
        return False
    # ChecksumError subclasses IOError but means corrupt bytes, not weather
    from s3shuffle_tpu_torch.read.checksum_stream import ChecksumError

    if isinstance(exc, ChecksumError):
        return False
    if isinstance(exc, (ConnectionError, TimeoutError)):
        return True
    if isinstance(exc, OSError):
        if exc.errno in RETRIABLE_ERRNOS:
            return True
        msg = str(exc).lower()
        if any(marker in msg for marker in TERMINAL_MARKERS) or _TERMINAL_CODE_RE.search(msg):
            return False
        return any(marker in msg for marker in TRANSIENT_MARKERS) or bool(
            _TRANSIENT_CODE_RE.search(msg)
        )
    return False


@dataclass(frozen=True)
class RetryPolicy:
    """``retries`` re-drives after the first attempt, backoff base
    ``base_ms`` with full jitter capped at ``max_backoff_s``, all under a
    ``deadline_s`` wall-clock budget per op (0 = unbounded)."""

    retries: int = 3
    base_ms: float = 50.0
    deadline_s: float = 30.0
    max_backoff_s: float = 5.0

    @classmethod
    def from_config(cls, config) -> Optional["RetryPolicy"]:
        """None when ``storage_retries`` is 0: no retry layer is stacked and
        every path fails fast."""
        retries = int(getattr(config, "storage_retries", 0) or 0)
        if retries <= 0:
            return None
        return cls(
            retries=retries,
            base_ms=float(getattr(config, "storage_retry_base_ms", 50.0)),
            deadline_s=float(getattr(config, "storage_op_deadline_s", 30.0)),
        )

    def backoff_s(self, attempt: int, rng: random.Random) -> float:
        """Full jitter: uniform over [0, min(cap, base * 2**attempt))."""
        ceiling = min(self.max_backoff_s, (self.base_ms / 1000.0) * (2.0 ** attempt))
        return rng.uniform(0.0, ceiling)


_process_rng = random.Random()


def retry_call(
    fn: Callable,
    policy: Optional[RetryPolicy],
    *,
    op: str = "call",
    scheme: str = "",
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
    rng: Optional[random.Random] = None,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
) -> object:
    """Run ``fn``, re-driving retriable failures per ``policy``.

    ``policy=None`` (or ``retries <= 0``) is a plain call.
    ``on_retry(attempt, exc)`` runs before each backoff sleep (the reader
    wrapper swaps in a fresh handle there)."""
    if policy is None or policy.retries <= 0:
        return fn()
    rng = rng or _process_rng
    deadline = clock() + policy.deadline_s if policy.deadline_s > 0 else None
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as exc:
            if not is_retriable(exc) or attempt >= policy.retries:
                raise
            delay = policy.backoff_s(attempt, rng)
            if deadline is not None and clock() + delay > deadline:
                if _reg.enabled():
                    _C_DEADLINE.labels(op=op, scheme=scheme).inc()
                logger.warning(
                    "storage op %s (%s) exceeded its %.1fs deadline after %d attempts: %s",
                    op, scheme, policy.deadline_s, attempt + 1, exc,
                )
                raise
            if _reg.enabled():
                _C_RETRIES.labels(op=op, scheme=scheme).inc()
                _H_BACKOFF.observe(delay)
            logger.debug(
                "retrying storage op %s after %s (attempt %d/%d, backoff %.0f ms)",
                op, exc, attempt + 1, policy.retries, delay * 1e3,
            )
            if on_retry is not None:
                try:
                    on_retry(attempt, exc)
                except Exception as reopen_exc:
                    if not is_retriable(reopen_exc):
                        raise
                    # a transient reopen failure burns this attempt
            sleep(delay)
            attempt += 1


class _RetryingReader(RangedReader):
    """Re-drives a failed ``read_fully`` on a fresh reader handle.

    The failed handle is not closed at once: sibling positioned reads
    (chunked-fetch sub-ranges) may still be in flight on it, and closing it
    under them could recycle the descriptor. Stale handles close with the
    reader."""

    def __init__(self, backend: "RetryingBackend", path: str,
                 size_hint: Optional[int], inner: RangedReader):
        self._backend = backend
        self._path = path
        self._hint = size_hint
        self._inner = inner
        self._stale: List[RangedReader] = []
        self._lock = threading.Lock()

    @property
    def size(self) -> int:
        return self._inner.size

    def _reopen(self, failed: RangedReader) -> None:
        """Swap in a fresh handle unless a sibling retry already did. The
        open runs outside the lock; only the swap is locked, and a fresh
        handle that lost the race joins the stale list."""
        with self._lock:
            if self._inner is not failed:
                return
        fresh = self._backend.inner.open_ranged(self._path, self._hint)
        with self._lock:
            if self._inner is failed:
                self._stale.append(failed)
                self._inner = fresh
            else:
                self._stale.append(fresh)

    def read_fully(self, position: int, length: int) -> bytes:
        state: dict = {}

        def attempt() -> bytes:
            # remember the handle this attempt used, so on_retry reopens
            # exactly the failed one
            reader = self._inner
            state["reader"] = reader
            return reader.read_fully(position, length)

        return retry_call(
            attempt,
            self._backend.policy,
            op="read",
            scheme=self._backend.scheme,
            sleep=self._backend._sleep,
            clock=self._backend._clock,
            rng=self._backend._rng,
            on_retry=lambda _attempt, _exc: self._reopen(state["reader"]),
        )

    def close(self) -> None:
        with self._lock:
            for stale in self._stale:
                try:
                    stale.close()
                except OSError:
                    pass
            self._stale = []
            self._inner.close()


class RetryingBackend(StorageBackend):
    """Classified-retry wrapper of any :class:`StorageBackend`.

    Write streams returned by :meth:`create` are not retried mid-stream (a
    partly written object cannot be re-driven here); the write plane
    re-drives its small commit objects whole instead
    (``MapOutputWriter.commit_all_partitions``, ``put_parity_objects``)."""

    _OWN_ATTRS = frozenset(
        {"inner", "policy", "scheme", "supports_rename", "_sleep", "_clock", "_rng"}
    )

    def __init__(
        self,
        inner: StorageBackend,
        policy: RetryPolicy,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
        rng: Optional[random.Random] = None,
    ):
        object.__setattr__(self, "inner", inner)
        object.__setattr__(self, "policy", policy)
        object.__setattr__(self, "scheme", inner.scheme)
        object.__setattr__(self, "supports_rename", inner.supports_rename)
        object.__setattr__(self, "_sleep", sleep)
        object.__setattr__(self, "_clock", clock)
        object.__setattr__(self, "_rng", rng or _process_rng)

    # Unknown attributes delegate both ways, so a backend's test hooks
    # (``MemoryBackend.open_interceptor``) work through the stack. Names the
    # wrapper's class defines are set on the wrapper: a test that replaces
    # ``backend.create`` replaces the outermost behaviour.
    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __setattr__(self, name, value):
        if name in self._OWN_ATTRS or hasattr(type(self), name):
            object.__setattr__(self, name, value)
        else:
            setattr(self.inner, name, value)

    def _retry(self, op: str, fn: Callable):
        return retry_call(
            fn, self.policy, op=op, scheme=self.scheme,
            sleep=self._sleep, clock=self._clock, rng=self._rng,
        )

    def create(self, path: str) -> BinaryIO:
        return self._retry("create", lambda: self.inner.create(path))

    def open_ranged(self, path: str, size_hint: int | None = None) -> RangedReader:
        reader = self._retry("open", lambda: self.inner.open_ranged(path, size_hint))
        return _RetryingReader(self, path, size_hint, reader)

    def status(self, path: str) -> FileStatus:
        return self._retry("status", lambda: self.inner.status(path))

    def list_prefix(self, prefix: str) -> List[FileStatus]:
        return self._retry("list", lambda: self.inner.list_prefix(prefix))

    def delete(self, path: str) -> None:
        self._retry("delete", lambda: self.inner.delete(path))

    def delete_prefix(self, prefix: str) -> None:
        self._retry("delete", lambda: self.inner.delete_prefix(prefix))

    def rename(self, src: str, dst: str) -> bool:
        return self._retry("rename", lambda: self.inner.rename(src, dst))
