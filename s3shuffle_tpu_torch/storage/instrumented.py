"""Metrics-instrumented storage decorator (the JAX package's
``storage/instrumented.py``).

Wraps any :class:`~s3shuffle_tpu_torch.storage.backend.StorageBackend`, and
the readers and write streams it hands out, and records per backend scheme:

- ``storage_op_seconds{scheme,op}``: the latency of every store operation
  (create, open, read, write, write_close, status, list, delete, rename);
- ``storage_read_bytes_total{scheme}`` / ``storage_write_bytes_total{scheme}``;
- ``storage_errors_total{scheme,op}``: operations that raised (a
  ``FileNotFoundError`` from a status or open is a miss, not a failure).

Each operation, and each ranged read, also runs inside a ``storage.op``
trace span (``op``, and ``bytes`` for a read): the GET and PUT leaves of a
trace. :func:`~s3shuffle_tpu_torch.storage.backend.get_backend` stacks it
over the retry layer while the metrics registry or tracing is on, so every
read- and write-plane caller is measured, and one healed operation counts
once. It passes every call through unchanged: the store sees the same
requests with either on or off. Unknown attributes delegate to the wrapped
backend both ways, so test hooks (``MemoryBackend.open_interceptor``) keep
working through it.
"""

from __future__ import annotations

import io
import time
from typing import BinaryIO, List

from s3shuffle_tpu_torch.metrics import registry as _reg
from s3shuffle_tpu_torch.storage.backend import FileStatus, RangedReader, StorageBackend
from s3shuffle_tpu_torch.utils import trace as _trace

_OP_SECONDS = _reg.REGISTRY.histogram(
    "storage_op_seconds",
    "Object-store operation latency",
    labelnames=("scheme", "op"),
)
_OP_ERRORS = _reg.REGISTRY.counter(
    "storage_errors_total",
    "Object-store operations that raised",
    labelnames=("scheme", "op"),
)
_READ_BYTES = _reg.REGISTRY.counter(
    "storage_read_bytes_total", "Bytes read from the store", labelnames=("scheme",)
)
_WRITE_BYTES = _reg.REGISTRY.counter(
    "storage_write_bytes_total", "Bytes written to the store", labelnames=("scheme",)
)


class _InstrumentedReader(RangedReader):
    def __init__(self, inner: RangedReader, scheme: str):
        self._inner = inner
        self._scheme = scheme

    @property
    def size(self) -> int:
        return self._inner.size

    def read_fully(self, position: int, length: int) -> bytes:
        # the ranged GET: the "GET wait" leaf of a trace
        with _trace.span("storage.op", op="read", bytes=length):
            if not _reg.enabled():
                return self._inner.read_fully(position, length)
            t0 = time.perf_counter_ns()
            try:
                data = self._inner.read_fully(position, length)
            except Exception:
                _OP_ERRORS.labels(scheme=self._scheme, op="read").inc()
                raise
            _OP_SECONDS.labels(scheme=self._scheme, op="read").observe(
                (time.perf_counter_ns() - t0) / 1e9
            )
            _READ_BYTES.labels(scheme=self._scheme).inc(len(data))
            return data

    def close(self) -> None:
        self._inner.close()


class _InstrumentedWriteStream(io.RawIOBase):
    """Times the underlying stream's write/close calls. The write plane
    buffers above this (io.BufferedWriter), so per-call overhead lands once
    per buffer flush, not per record."""

    def __init__(self, inner: BinaryIO, scheme: str):
        super().__init__()
        self._inner = inner
        self._scheme = scheme

    def writable(self) -> bool:
        return True

    def write(self, b) -> int:
        if not _reg.enabled():
            return self._inner.write(b)
        t0 = time.perf_counter_ns()
        try:
            n = self._inner.write(b)
        except Exception:
            _OP_ERRORS.labels(scheme=self._scheme, op="write").inc()
            raise
        _OP_SECONDS.labels(scheme=self._scheme, op="write").observe(
            (time.perf_counter_ns() - t0) / 1e9
        )
        written = n if n is not None else (b.nbytes if isinstance(b, memoryview) else len(b))
        _WRITE_BYTES.labels(scheme=self._scheme).inc(written)
        return written

    def flush(self) -> None:
        if not getattr(self._inner, "closed", False):
            self._inner.flush()

    def close(self) -> None:
        if self.closed:
            return
        # close is where buffered object stores actually commit the upload —
        # time it as its own op so slow finalizes are visible
        if _reg.enabled():
            t0 = time.perf_counter_ns()
            try:
                self._inner.close()
            except Exception:
                _OP_ERRORS.labels(scheme=self._scheme, op="write_close").inc()
                raise
            _OP_SECONDS.labels(scheme=self._scheme, op="write_close").observe(
                (time.perf_counter_ns() - t0) / 1e9
            )
        else:
            self._inner.close()
        super().close()


class InstrumentedBackend(StorageBackend):
    #: attributes that live on the wrapper itself; everything else delegates
    #: to the wrapped backend in BOTH directions, so backend-specific test
    #: hooks (``MemoryBackend.open_interceptor``) set through the wrapper
    #: actually land where the inner backend reads them
    _OWN_ATTRS = frozenset({"inner", "scheme", "supports_rename"})

    def __init__(self, inner: StorageBackend):
        object.__setattr__(self, "inner", inner)
        object.__setattr__(self, "scheme", inner.scheme)
        object.__setattr__(self, "supports_rename", inner.supports_rename)

    def __getattr__(self, name):
        # backend-specific extras (e.g. MemoryBackend._store, test hooks)
        return getattr(self.inner, name)

    def __setattr__(self, name, value):
        # names defined on the wrapper class (the StorageBackend methods)
        # set on the WRAPPER: a monkeypatched ``backend.create`` must
        # replace the outermost behavior, not recurse through delegation
        if name in self._OWN_ATTRS or hasattr(type(self), name):
            object.__setattr__(self, name, value)
        else:
            setattr(self.inner, name, value)

    def _timed(self, op: str, fn, *args):
        with _trace.span("storage.op", op=op):
            if not _reg.enabled():
                return fn(*args)
            t0 = time.perf_counter_ns()
            try:
                out = fn(*args)
            except FileNotFoundError:
                raise  # a miss (exists() probes), not a store failure
            except Exception:
                _OP_ERRORS.labels(scheme=self.scheme, op=op).inc()
                raise
            _OP_SECONDS.labels(scheme=self.scheme, op=op).observe(
                (time.perf_counter_ns() - t0) / 1e9
            )
            return out

    # ------------------------------------------------------------------
    def create(self, path: str) -> BinaryIO:
        stream = self._timed("create", self.inner.create, path)
        return _InstrumentedWriteStream(stream, self.scheme)  # type: ignore[return-value]

    def open_ranged(self, path: str, size_hint: int | None = None) -> RangedReader:
        reader = self._timed("open", self.inner.open_ranged, path, size_hint)
        return _InstrumentedReader(reader, self.scheme)

    def status(self, path: str) -> FileStatus:
        return self._timed("status", self.inner.status, path)

    def list_prefix(self, prefix: str) -> List[FileStatus]:
        return self._timed("list", self.inner.list_prefix, prefix)

    def delete(self, path: str) -> None:
        self._timed("delete", self.inner.delete, path)

    def delete_prefix(self, prefix: str) -> None:
        self._timed("delete", self.inner.delete_prefix, prefix)

    def rename(self, src: str, dst: str) -> bool:
        return self._timed("rename", self.inner.rename, src, dst)
