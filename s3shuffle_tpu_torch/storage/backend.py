"""Object-store backend seam (the JAX package's ``storage/backend.py``,
without its retry and instrumentation wrappers and its fsspec backend):
streaming creates, positioned ranged reads with no shared cursor, status,
recursive prefix listing, deletes of objects and of prefixes, and a rename
where the backend has one. The port registers ``file://`` and
``memory://``; other schemes raise."""

from __future__ import annotations

import abc
import io
import threading
from dataclasses import dataclass
from typing import BinaryIO, Dict, List


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
    def open_ranged(self, path: str) -> RangedReader: ...

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

    @staticmethod
    def _key(path: str) -> str:
        return path.split("://", 1)[-1].lstrip("/")

    def create(self, path: str) -> BinaryIO:
        return _MemoryWriteStream(self._store, self._key(path), self._lock)  # type: ignore[return-value]

    def open_ranged(self, path: str) -> RangedReader:
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


def get_backend(root_dir: str, storage_options: Dict | None = None) -> StorageBackend:
    """Pick a backend from the root URI scheme (the reference's
    ``FileSystem.get(rootDir URI, hadoopConf)``,
    S3ShuffleDispatcher.scala:72-76). ``storage_options`` are for an
    object-store driver; ``file://`` and ``memory://`` take none."""
    scheme = root_dir.split("://", 1)[0] if "://" in root_dir else "file"
    if scheme == "file":
        from s3shuffle_tpu_torch.storage.local import LocalBackend

        return LocalBackend()
    if scheme == "memory":
        with _registry_lock:
            backend = _memory_backends.get(root_dir)
            if backend is None:
                backend = _memory_backends[root_dir] = MemoryBackend()
        return backend
    raise ValueError(f"storage scheme {scheme!r} is not supported by this package yet")
