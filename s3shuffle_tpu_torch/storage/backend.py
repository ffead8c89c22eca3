"""Object-store backend seam (the JAX package's ``storage/backend.py``):
streaming creates, positioned ranged reads with no shared cursor, status,
recursive prefix listing, deletes of objects and of prefixes, and a rename
where the backend has one.
:func:`get_backend` serves ``file://`` and ``memory://`` itself and every
other scheme through fsspec (``storage/fsspec_backend.py``), and stacks
the retry layer (``storage/retrying.py``) over each when it is given a
policy, and the metrics layer (``storage/instrumented.py``) over that while
the metrics registry or tracing is on."""

from __future__ import annotations

import abc
import io
import threading
from dataclasses import dataclass
from typing import BinaryIO, Callable, Dict, List


@dataclass(frozen=True)
class FileStatus:
    """Size metadata of one object."""

    path: str
    size: int


class RangedReader(abc.ABC):
    """Positioned-read handle: thread-safe ``read_fully(pos, length)``."""

    @property
    @abc.abstractmethod
    def size(self) -> int: ...

    @abc.abstractmethod
    def read_fully(self, position: int, length: int) -> bytes:
        """Read exactly ``length`` bytes at ``position`` (short only at EOF)."""

    @abc.abstractmethod
    def close(self) -> None: ...

    def __enter__(self) -> "RangedReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class StorageBackend(abc.ABC):
    scheme: str = "abstract"
    supports_rename: bool = False

    @abc.abstractmethod
    def create(self, path: str) -> BinaryIO:
        """Open a streaming write handle, creating parent prefixes."""

    @abc.abstractmethod
    def open_ranged(self, path: str, size_hint: int | None = None) -> RangedReader:
        """``size_hint``: the object's size when the caller knows it (the
        dispatcher's FileStatus cache), so a backend need not ask the store."""

    @abc.abstractmethod
    def status(self, path: str) -> FileStatus:
        """Raises FileNotFoundError if absent."""

    @abc.abstractmethod
    def list_prefix(self, prefix: str) -> List[FileStatus]:
        """Every object under ``prefix``, recursively (none if absent)."""

    @abc.abstractmethod
    def delete(self, path: str) -> None: ...

    @abc.abstractmethod
    def delete_prefix(self, prefix: str) -> None:
        """Delete every object under ``prefix`` (missing prefixes are fine)."""

    def rename(self, src: str, dst: str) -> bool:
        """Atomic move where the backend supports it (the reference's
        single-spill fast path renames local spill files into place,
        S3SingleSpillShuffleMapOutputWriter.scala:31-52)."""
        return False

    def exists(self, path: str) -> bool:
        try:
            self.status(path)
            return True
        except FileNotFoundError:
            return False

    def read_all(self, path: str) -> bytes:
        with self.open_ranged(path) as r:
            return r.read_fully(0, r.size)


# --- memory:// ---

class _MemoryWriteStream(io.RawIOBase):
    """Buffers the object; it appears in the store at ``close``."""

    def __init__(self, store: Dict[str, bytes], key: str, lock: threading.Lock):
        self._buf = io.BytesIO()
        self._store = store
        self._key = key
        self._lock = lock

    def writable(self) -> bool:
        return True

    def write(self, b) -> int:
        return self._buf.write(b)

    def close(self) -> None:
        if not self.closed:
            with self._lock:
                self._store[self._key] = self._buf.getvalue()
        super().close()


class _MemoryRangedReader(RangedReader):
    def __init__(self, data: bytes):
        self._data = data

    @property
    def size(self) -> int:
        return len(self._data)

    def read_fully(self, position: int, length: int) -> bytes:
        return self._data[position : position + length]

    def close(self) -> None:
        pass


class MemoryBackend(StorageBackend):
    """``memory://``: a dict of objects, for tests."""

    scheme = "memory"
    supports_rename = True

    def __init__(self) -> None:
        self._store: Dict[str, bytes] = {}
        self._lock = threading.Lock()
        # test hook: called with the path before every open
        self.open_interceptor: Callable[[str], None] | None = None

    @staticmethod
    def _key(path: str) -> str:
        return path.split("://", 1)[-1].lstrip("/")

    def create(self, path: str) -> BinaryIO:
        return _MemoryWriteStream(self._store, self._key(path), self._lock)  # type: ignore[return-value]

    def open_ranged(self, path: str, size_hint: int | None = None) -> RangedReader:
        if self.open_interceptor is not None:
            self.open_interceptor(path)
        key = self._key(path)
        with self._lock:
            if key not in self._store:
                raise FileNotFoundError(path)
            return _MemoryRangedReader(self._store[key])

    def status(self, path: str) -> FileStatus:
        key = self._key(path)
        with self._lock:
            if key not in self._store:
                raise FileNotFoundError(path)
            return FileStatus(path, len(self._store[key]))

    def list_prefix(self, prefix: str) -> List[FileStatus]:
        key = self._key(prefix).rstrip("/")
        with self._lock:
            return [
                FileStatus("memory:///" + k, len(v))
                for k, v in self._store.items()
                if k == key or k.startswith(key + "/")
            ]

    def delete(self, path: str) -> None:
        with self._lock:
            self._store.pop(self._key(path), None)

    def delete_prefix(self, prefix: str) -> None:
        key = self._key(prefix).rstrip("/")
        with self._lock:
            for k in [k for k in self._store if k == key or k.startswith(key + "/")]:
                del self._store[k]

    def rename(self, src: str, dst: str) -> bool:
        with self._lock:
            data = self._store.pop(self._key(src), None)
            if data is None:
                return False
            self._store[self._key(dst)] = data
            return True


#: one MemoryBackend per ``memory://`` root, so every component of a
#: process that names the root sees the same objects
_memory_backends: Dict[str, MemoryBackend] = {}
_registry_lock = threading.Lock()


def get_backend(root_dir: str, storage_options: Dict | None = None,
                retry_policy=None) -> StorageBackend:
    """Pick a backend from the root URI scheme (the reference's
    ``FileSystem.get(rootDir URI, hadoopConf)``,
    S3ShuffleDispatcher.scala:72-76): ``file://``, ``memory://`` (one
    shared store per root), and any other scheme through fsspec, to whose
    driver ``storage_options`` go (credentials, endpoint_url). With a
    ``retry_policy`` (a :class:`~s3shuffle_tpu_torch.storage.retrying.RetryPolicy`,
    which the dispatcher builds from ``storage_retries``,
    ``storage_retry_base_ms`` and ``storage_op_deadline_s``) the backend is
    wrapped in a :class:`~s3shuffle_tpu_torch.storage.retrying.RetryingBackend`,
    the S3A ``fs.s3a.retry.*`` analog, so every scheme absorbs transient
    store failures. While the metrics registry or tracing is on, an
    :class:`~s3shuffle_tpu_torch.storage.instrumented.InstrumentedBackend`
    sits on top (one healed operation counts once)."""
    scheme = root_dir.split("://", 1)[0] if "://" in root_dir else "file"
    if scheme == "file":
        from s3shuffle_tpu_torch.storage.local import LocalBackend

        return _wrap(LocalBackend(), retry_policy)
    if scheme == "memory":
        with _registry_lock:
            backend = _memory_backends.get(root_dir)
            if backend is None:
                backend = _memory_backends[root_dir] = MemoryBackend()
        return _wrap(backend, retry_policy)
    from s3shuffle_tpu_torch.storage.fsspec_backend import FsspecBackend

    return _wrap(FsspecBackend(scheme, **(storage_options or {})), retry_policy)


def _wrap(backend: StorageBackend, retry_policy) -> StorageBackend:
    if retry_policy is not None and retry_policy.retries > 0:
        from s3shuffle_tpu_torch.storage.retrying import RetryingBackend

        backend = RetryingBackend(backend, retry_policy)
    return _maybe_instrument(backend)


def _maybe_instrument(backend: StorageBackend) -> StorageBackend:
    from s3shuffle_tpu_torch.metrics import registry as _metrics_registry
    from s3shuffle_tpu_torch.utils import trace as _trace

    # tracing wants the wrapper too: the storage.op spans live on it
    if not _metrics_registry.enabled() and not _trace.enabled():
        return backend
    from s3shuffle_tpu_torch.storage.instrumented import InstrumentedBackend

    return InstrumentedBackend(backend)
