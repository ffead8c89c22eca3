"""Storage dispatcher: config + object layout + backend handle.

The object layout is the JAX package's (``storage/dispatcher.py``, parity
with the reference's ``S3ShuffleDispatcher``), byte for byte:
``{root}{mapId % folderPrefixes}/{appId}/{shuffleId}/{name}`` — prefix
sharding spreads a shuffle's objects over ``folder_prefixes`` top-level
prefixes so an object store's per-prefix request rate is not one limit.
Deletes fan out with one task per prefix (S3ShuffleDispatcher.scala:104-118,
174-183); an IO error is logged and swallowed per prefix.
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List

from s3shuffle_tpu_torch.block_ids import BlockId
from s3shuffle_tpu_torch.config import ShuffleConfig
from s3shuffle_tpu_torch.storage.backend import RangedReader, StorageBackend, get_backend

logger = logging.getLogger("s3shuffle_tpu_torch.dispatcher")


class Dispatcher:
    def __init__(self, config: ShuffleConfig):
        self.config = config
        self.backend: StorageBackend = get_backend(config.root_dir)
        self.app_id = config.app_id
        # run on reinitialize() so dependent caches (the metadata helper's)
        # never serve paths of the placeholder app id
        self._reinit_callbacks: List[Callable[[], None]] = []
        if config.supports_rename is None:
            self.supports_rename = self.backend.supports_rename
        else:
            self.supports_rename = config.supports_rename

    def reinitialize(self, app_id: str) -> None:
        """Executor components re-initialize with the real application id
        once it is known (S3ShuffleDataIO.scala:30-32 →
        S3ShuffleDispatcher.scala:30-34)."""
        self.app_id = app_id
        for cb in self._reinit_callbacks:
            cb()

    def on_reinitialize(self, callback: Callable[[], None]) -> None:
        self._reinit_callbacks.append(callback)

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

    def root_prefixes(self) -> List[str]:
        """All top-level prefixes."""
        return [f"{self.config.root_dir}{i}" for i in range(self.config.folder_prefixes)]

    def remove_shuffle(self, shuffle_id: int) -> None:
        """Delete one shuffle's objects, one task per prefix."""
        self._parallel_delete(
            [f"{p}/{self.app_id}/{shuffle_id}" for p in self.root_prefixes()]
        )

    def remove_root(self) -> None:
        """Delete everything under the shuffle root for this app."""
        self._parallel_delete([f"{p}/{self.app_id}" for p in self.root_prefixes()])

    def _parallel_delete(self, targets: List[str]) -> None:
        def delete_one(prefix: str) -> None:
            try:
                self.backend.delete_prefix(prefix)
            except Exception as e:
                logger.warning("delete of %s failed: %s", prefix, e)

        with ThreadPoolExecutor(max_workers=max(1, len(targets))) as pool:
            list(pool.map(delete_one, targets))
