"""Object-store backend seam (the JAX package's ``storage/backend.py``,
trimmed to what the port calls): streaming creates, positioned ranged
reads with no shared cursor, deletes of objects and of prefixes, and a
rename where the backend has one. The port registers the ``file://``
backend; other schemes raise."""

from __future__ import annotations

import abc
from typing import BinaryIO


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
    def delete(self, path: str) -> None: ...

    @abc.abstractmethod
    def delete_prefix(self, prefix: str) -> None:
        """Delete every object under ``prefix`` (missing prefixes are fine)."""

    def rename(self, src: str, dst: str) -> bool:
        """Atomic move where the backend supports it (the reference's
        single-spill fast path renames local spill files into place,
        S3SingleSpillShuffleMapOutputWriter.scala:31-52)."""
        return False

    def read_all(self, path: str) -> bytes:
        with self.open_ranged(path) as r:
            return r.read_fully(0, r.size)


def get_backend(root_dir: str) -> StorageBackend:
    """Pick a backend from the root URI scheme."""
    scheme = root_dir.split("://", 1)[0] if "://" in root_dir else "file"
    if scheme == "file":
        from s3shuffle_tpu_torch.storage.local import LocalBackend

        return LocalBackend()
    raise ValueError(f"storage scheme {scheme!r} is not supported by this package yet")
