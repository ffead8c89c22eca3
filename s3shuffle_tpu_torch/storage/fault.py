"""Fault-injection storage wrapper (the JAX package's ``storage/fault.py``).

The reference has no fault injection (SURVEY.md §5.3); its fault tolerance
is architectural (shuffle data lives in the store, read errors surface as
logged EOF, per-prefix delete errors are swallowed). :class:`FlakyBackend`
makes those claims testable: it wraps any :class:`StorageBackend` and
injects failures per operation kind, selected by path substring and call
count, or seeded by probability, optionally transient (fail the first N
matching calls, then heal: S3 503s, connection resets).

A tool of tests and soaks; nothing on the shuffle's path imports it.
"""

from __future__ import annotations

import errno as _errno
import io
import random
import threading
from typing import BinaryIO, Callable, Dict, List, Optional

from s3shuffle_tpu_torch.storage.backend import FileStatus, RangedReader, StorageBackend

#: Operation kinds that can be made to fail.
OPS = ("create", "open", "read", "write", "status", "list", "delete", "rename")


# ---------------------------------------------------------------------------
# Preset transient exception factories — shaped so the resilient storage
# plane (storage/retrying.is_retriable) classifies them RETRIABLE, unlike
# FaultRule's default generic ``OSError("injected fault: ...")`` which stays
# terminal-shaped (existing fail-fast tests keep their semantics).
# ---------------------------------------------------------------------------


def transient_connection_reset(path: str) -> Exception:
    """The S3 connection-reset shape (client-side TCP RST mid-transfer)."""
    return ConnectionResetError(
        _errno.ECONNRESET, f"injected transient connection reset: {path}"
    )


def transient_timeout(path: str) -> Exception:
    """A timeout-shaped OSError (socket read timeout against the store)."""
    return OSError(_errno.ETIMEDOUT, f"injected transient timed out: {path}")


def transient_http_503(path: str) -> Exception:
    """The throttle shape fsspec drivers surface for S3 503 SlowDown."""
    return OSError(f"injected transient: HTTP 503 Service Unavailable (SlowDown): {path}")


#: name → factory, for parametrized tests / soak configs
TRANSIENT_FACTORIES: Dict[str, Callable[[str], Exception]] = {
    "reset": transient_connection_reset,
    "timeout": transient_timeout,
    "503": transient_http_503,
}


class FaultRule:
    """Fail operations of ``op`` whose path contains ``match``.

    Two firing modes:

    - **deterministic** (default): ``skip`` matching calls pass through
      before failures start; after ``times`` failures the rule is exhausted
      (None = fail forever).
    - **seeded probabilistic** (``prob`` set): each matching call (after
      ``skip``) fails with probability ``prob``, drawn from a private
      ``random.Random(rng_seed)`` — deterministic S3-weather modelling for
      the fault-soak test and benches; ``times`` still caps total failures.

    ``exc`` is the exception factory; see the ``transient_*`` presets above
    for retriable-shaped failures.
    """

    def __init__(
        self,
        op: str,
        match: str = "",
        times: Optional[int] = 1,
        skip: int = 0,
        exc: Callable[[str], Exception] = lambda path: OSError(f"injected fault: {path}"),
        prob: Optional[float] = None,
        rng_seed: Optional[int] = None,
    ):
        if op not in OPS:
            raise ValueError(f"unknown op {op!r}; one of {OPS}")
        if prob is not None and not (0.0 <= prob <= 1.0):
            raise ValueError(f"prob must be in [0, 1], got {prob}")
        self.op = op
        self.match = match
        self.times = times
        self.skip = skip
        self.exc = exc
        self.prob = prob
        self._rng = random.Random(rng_seed) if prob is not None else None
        self.hits = 0  # calls that matched (after skip) and raised
        self._seen = 0
        self._lock = threading.Lock()

    def maybe_raise(self, op: str, path: str) -> None:
        if op != self.op or self.match not in path:
            return
        with self._lock:
            self._seen += 1
            if self._seen <= self.skip:
                return
            if self.times is not None and self.hits >= self.times:
                return
            if self.prob is not None:
                # one draw per matching call keeps the sequence a pure
                # function of (rng_seed, call order) — reruns are exact
                if self._rng.random() >= self.prob:
                    return
            self.hits += 1
            raise self.exc(path)


class LatencyRule:
    """Delay operations of ``op`` whose path contains ``match`` by
    ``delay_s`` seconds per call — models a high-RTT object store (S3
    cross-region GETs) so the ADAPTIVE behaviors (prefetch hill-climb)
    can be exercised, not just failure paths. ``times`` bounds how many
    calls are delayed (None = every matching call)."""

    def __init__(
        self,
        op: str,
        match: str = "",
        delay_s: float = 0.01,
        times: Optional[int] = None,
    ):
        if op not in OPS:
            raise ValueError(f"unknown op {op!r}; one of {OPS}")
        self.op = op
        self.match = match
        self.delay_s = delay_s
        self.times = times
        self.hits = 0
        self._lock = threading.Lock()

    def maybe_delay(self, op: str, path: str) -> None:
        if op != self.op or self.match not in path:
            return
        with self._lock:
            if self.times is not None and self.hits >= self.times:
                return
            self.hits += 1
        import time

        time.sleep(self.delay_s)


class BandwidthRule:
    """Throttle operations of ``op`` whose path contains ``match`` to
    ``mib_s`` per CALL — the delay scales with the call's byte count, so it
    models a bandwidth-limited store CONNECTION: each concurrent ranged GET
    gets its own sleep and they overlap, exactly like parallel S3
    connections each capped at per-stream throughput (the reason multipart
    download and the skew plane's hot-partition split fan-out pay off).
    Calls that carry no byte count (create/open/status/...) pass free."""

    def __init__(self, op: str, match: str = "", mib_s: float = 64.0):
        if op not in OPS:
            raise ValueError(f"unknown op {op!r}; one of {OPS}")
        if mib_s <= 0:
            raise ValueError("mib_s must be > 0")
        self.op = op
        self.match = match
        self.mib_s = float(mib_s)
        self.hits = 0
        self.bytes = 0
        self._lock = threading.Lock()

    #: FlakyBackend dispatch marker: this rule wants the call's byte count
    per_byte = True

    def maybe_delay(self, op: str, path: str, nbytes: int = 0) -> None:
        if op != self.op or self.match not in path or nbytes <= 0:
            return
        with self._lock:
            self.hits += 1
            self.bytes += nbytes
        import time

        time.sleep(nbytes / (self.mib_s * 1024 * 1024))


class _FlakyReader(RangedReader):
    def __init__(self, inner: RangedReader, path: str, check: Callable[[str, str], None]):
        self._inner = inner
        self._path = path
        self._check = check

    @property
    def size(self) -> int:
        return self._inner.size

    def read_fully(self, position: int, length: int) -> bytes:
        self._check("read", self._path, nbytes=length)
        return self._inner.read_fully(position, length)

    def close(self) -> None:
        self._inner.close()


class _FlakyWriteStream(io.RawIOBase):
    def __init__(self, inner: BinaryIO, path: str, check: Callable[[str, str], None]):
        super().__init__()
        self._inner = inner
        self._path = path
        self._check = check

    def writable(self) -> bool:
        return True

    def write(self, b) -> int:
        self._check(
            "write", self._path,
            nbytes=b.nbytes if isinstance(b, memoryview) else len(b),
        )
        return self._inner.write(b)

    def flush(self) -> None:
        if not self._inner.closed:
            self._inner.flush()

    def close(self) -> None:
        if not self.closed:
            self._inner.close()
        super().close()


class FlakyBackend(StorageBackend):
    """Wraps ``inner``, raising per :class:`FaultRule` before delegating."""

    def __init__(
        self,
        inner: StorageBackend,
        rules: Optional[List[FaultRule]] = None,
        latency: Optional[List[LatencyRule]] = None,
    ):
        self.inner = inner
        self.rules: List[FaultRule] = list(rules or [])
        self.latency: List[LatencyRule] = list(latency or [])
        self.calls: Dict[str, int] = {op: 0 for op in OPS}
        self.scheme = inner.scheme
        self.supports_rename = inner.supports_rename

    def add_rule(self, rule: FaultRule) -> FaultRule:
        self.rules.append(rule)
        return rule

    def add_latency(self, rule: LatencyRule) -> LatencyRule:
        self.latency.append(rule)
        return rule

    def _check(self, op: str, path: str, nbytes: int = 0) -> None:
        self.calls[op] = self.calls.get(op, 0) + 1
        for rule in self.rules:
            rule.maybe_raise(op, path)
        for lat in self.latency:
            if getattr(lat, "per_byte", False):
                lat.maybe_delay(op, path, nbytes)
            else:
                lat.maybe_delay(op, path)

    # ------------------------------------------------------------------
    def create(self, path: str) -> BinaryIO:
        self._check("create", path)
        return _FlakyWriteStream(self.inner.create(path), path, self._check)  # type: ignore[return-value]

    def open_ranged(self, path: str, size_hint: int | None = None) -> RangedReader:
        self._check("open", path)
        return _FlakyReader(self.inner.open_ranged(path, size_hint), path, self._check)

    def status(self, path: str) -> FileStatus:
        self._check("status", path)
        return self.inner.status(path)

    def list_prefix(self, prefix: str) -> List[FileStatus]:
        self._check("list", prefix)
        return self.inner.list_prefix(prefix)

    def delete(self, path: str) -> None:
        self._check("delete", path)
        self.inner.delete(path)

    def delete_prefix(self, prefix: str) -> None:
        self._check("delete", prefix)
        self.inner.delete_prefix(prefix)

    def rename(self, src: str, dst: str) -> bool:
        self._check("rename", src)
        return self.inner.rename(src, dst)
