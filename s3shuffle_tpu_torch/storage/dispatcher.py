"""Storage dispatcher: config + object layout + backend handle.

The object layout is the JAX package's (``storage/dispatcher.py``, parity
with the reference's ``S3ShuffleDispatcher``), byte for byte:
``{root}{mapId % folderPrefixes}/{appId}/{shuffleId}/{name}`` — prefix
sharding spreads a shuffle's objects over ``folder_prefixes`` top-level
prefixes so an object store's per-prefix request rate is not one limit.
"""

from __future__ import annotations

from s3shuffle_tpu_torch.block_ids import BlockId
from s3shuffle_tpu_torch.config import ShuffleConfig
from s3shuffle_tpu_torch.storage.backend import RangedReader, StorageBackend, get_backend


class Dispatcher:
    def __init__(self, config: ShuffleConfig):
        self.config = config
        self.backend: StorageBackend = get_backend(config.root_dir)
        self.app_id = config.app_id

    def get_path(self, block: BlockId) -> str:
        """``{root}{mapId % folderPrefixes}/{appId}/{shuffleId}/{name}``."""
        map_id = getattr(block, "map_id", 0)
        prefix = map_id % self.config.folder_prefixes
        shuffle_id = block.shuffle_id  # type: ignore[attr-defined]
        return f"{self.config.root_dir}{prefix}/{self.app_id}/{shuffle_id}/{block.name}"

    def create_block(self, block: BlockId):
        return self.backend.create(self.get_path(block))

    def open_block(self, block: BlockId) -> RangedReader:
        return self.backend.open_ranged(self.get_path(block))
