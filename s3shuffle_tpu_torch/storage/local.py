"""Local-filesystem backend (``file://``), copied from the JAX package:
positioned reads map to ``os.pread``, so readers share no cursor."""

from __future__ import annotations

import os
import shutil
from typing import BinaryIO, List

from s3shuffle_tpu_torch.storage.backend import FileStatus, RangedReader, StorageBackend


def _strip(path: str) -> str:
    if path.startswith("file://"):
        path = path[len("file://") :]
    return path or "/"


class _LocalRangedReader(RangedReader):
    def __init__(self, path: str):
        self._fd = os.open(path, os.O_RDONLY)
        self._size = os.fstat(self._fd).st_size
        self._closed = False

    @property
    def size(self) -> int:
        return self._size

    def read_fully(self, position: int, length: int) -> bytes:
        chunks = []
        remaining = length
        pos = position
        while remaining > 0:
            chunk = os.pread(self._fd, remaining, pos)
            if not chunk:
                break
            chunks.append(chunk)
            pos += len(chunk)
            remaining -= len(chunk)
        return b"".join(chunks)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            os.close(self._fd)


class LocalBackend(StorageBackend):
    scheme = "file"
    supports_rename = True

    def create(self, path: str) -> BinaryIO:
        p = _strip(path)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        return open(p, "wb")

    def open_ranged(self, path: str) -> RangedReader:
        return _LocalRangedReader(_strip(path))

    def status(self, path: str) -> FileStatus:
        return FileStatus(path, os.stat(_strip(path)).st_size)  # raises FileNotFoundError

    def list_prefix(self, prefix: str) -> List[FileStatus]:
        root = _strip(prefix)
        if os.path.isfile(root):
            return [FileStatus(prefix, os.path.getsize(root))]
        out: List[FileStatus] = []
        for dirpath, _dirnames, filenames in os.walk(root):
            for fn in filenames:
                full = os.path.join(dirpath, fn)
                try:
                    out.append(FileStatus("file://" + full, os.path.getsize(full)))
                except OSError:
                    pass  # raced with a delete
        return out

    def rename(self, src: str, dst: str) -> bool:
        s, d = _strip(src), _strip(dst)
        if not os.path.exists(s):
            return False
        os.makedirs(os.path.dirname(d), exist_ok=True)
        os.replace(s, d)
        return True

    def delete(self, path: str) -> None:
        try:
            os.remove(_strip(path))
        except FileNotFoundError:
            pass

    def delete_prefix(self, prefix: str) -> None:
        root = _strip(prefix)
        if os.path.isfile(root):
            os.remove(root)
        elif os.path.isdir(root):
            shutil.rmtree(root, ignore_errors=True)
