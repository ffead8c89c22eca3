"""Object-store backend through fsspec (``s3://``, ``gs://``, ...), the JAX
package's ``storage/fsspec_backend.py``.

It stands in for the reference's Hadoop S3A and Stocator drivers
(README.md:126-137): auth, multipart sizing and connection pooling are the
fsspec driver's own configuration, as the reference leaves them to the
Hadoop FS configuration (README.md:146-178). Reads are ranged
``cat_file`` GETs; a listing is one ``find(detail=True)`` per prefix.
"""

from __future__ import annotations

from typing import BinaryIO, List

from s3shuffle_tpu_torch.storage.backend import FileStatus, RangedReader, StorageBackend


class _FsspecRangedReader(RangedReader):
    def __init__(self, fs, path: str, size: int):
        self._fs = fs
        self._path = path
        self._size = size

    @property
    def size(self) -> int:
        return self._size

    def read_fully(self, position: int, length: int) -> bytes:
        end = min(position + length, self._size)
        if end <= position:
            return b""
        return self._fs.cat_file(self._path, start=position, end=end)

    def close(self) -> None:
        pass


class FsspecBackend(StorageBackend):
    supports_rename = False

    def __init__(self, scheme: str, **storage_options):
        import fsspec

        self.scheme = scheme
        try:
            self._fs = fsspec.filesystem(scheme, **storage_options)
        except (ImportError, ValueError) as e:  # the scheme's driver is not installed
            raise RuntimeError(
                f"No fsspec driver for scheme '{scheme}'. Install the driver "
                f"(e.g. s3fs/gcsfs) or use file:// / memory:// roots."
            ) from e

    @staticmethod
    def _key(path: str) -> str:
        return path.split("://", 1)[-1]

    def create(self, path: str) -> BinaryIO:
        return self._fs.open(self._key(path), "wb")

    def open_ranged(self, path: str, size_hint: int | None = None) -> RangedReader:
        key = self._key(path)
        size = size_hint if size_hint is not None else self._fs.info(key)["size"]
        return _FsspecRangedReader(self._fs, key, size)

    def status(self, path: str) -> FileStatus:
        info = self._fs.info(self._key(path))  # raises FileNotFoundError
        return FileStatus(path, info.get("size") or 0)

    def list_prefix(self, prefix: str) -> List[FileStatus]:
        key = self._key(prefix).rstrip("/")
        try:
            # detail=True returns each size in the one LIST call
            found = self._fs.find(key, detail=True)
        except FileNotFoundError:
            return []
        return [
            FileStatus(f"{self.scheme}://{p}", info.get("size") or 0)
            for p, info in found.items()
        ]

    def delete(self, path: str) -> None:
        try:
            self._fs.rm_file(self._key(path))
        except FileNotFoundError:
            pass

    def delete_prefix(self, prefix: str) -> None:
        key = self._key(prefix).rstrip("/")
        try:
            self._fs.rm(key, recursive=True)
        except FileNotFoundError:
            pass
