"""Object storage of the port: the backend seam (``file://``, ``memory://``
and fsspec for every other scheme), the retry layer stacked over it, the
fault injector of tests and soaks, and the dispatcher's prefix-sharded
object layout with its FileStatus cache."""

from s3shuffle_tpu_torch.storage.backend import (
    FileStatus,
    RangedReader,
    StorageBackend,
    get_backend,
)
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher

__all__ = ["FileStatus", "RangedReader", "StorageBackend", "get_backend", "Dispatcher"]
