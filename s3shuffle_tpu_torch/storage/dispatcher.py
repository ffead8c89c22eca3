"""Storage dispatcher: config + object layout + backend handle.

The object layout is the JAX package's (``storage/dispatcher.py``, parity
with the reference's ``S3ShuffleDispatcher``), byte for byte:

- normal: ``{root}{mapId % folderPrefixes}/{appId}/{shuffleId}/{name}`` —
  prefix sharding spreads a shuffle's objects over ``folder_prefixes``
  top-level prefixes so an object store's per-prefix request rate is not
  one limit (:142-143);
- fallback fetch (``use_fallback_fetch``):
  ``{root}{appId}/{shuffleId}/{hash(name)}/{name}``, where Spark's
  decommission fallback storage looks for blocks (:132-141), ``hash`` the
  JVM's non-negative ``String.hashCode``.

Listing-mode enumeration lists the shuffle's prefixes in parallel, one task
each (:146-172). Deletes fan out the same way (:104-118, 174-183); an IO
error is logged and swallowed per prefix.
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Tuple

from s3shuffle_tpu_torch.block_ids import BlockId, ShuffleIndexBlockId, parse_index_name
from s3shuffle_tpu_torch.config import ShuffleConfig
from s3shuffle_tpu_torch.storage.backend import RangedReader, StorageBackend, get_backend

logger = logging.getLogger("s3shuffle_tpu_torch.dispatcher")


class Dispatcher:
    def __init__(self, config: ShuffleConfig):
        self.config = config
        self.backend: StorageBackend = get_backend(config.root_dir, config.storage_options)
        self.app_id = config.app_id
        # run on reinitialize() so dependent caches (the metadata helper's)
        # never serve paths of the placeholder app id
        self._reinit_callbacks: List[Callable[[], None]] = []
        if config.supports_rename is None:
            self.supports_rename = self.backend.supports_rename
        else:
            self.supports_rename = config.supports_rename
        config.log_values()

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
        """A block id's object path, in the normal or the fallback-fetch
        layout (see the module docstring)."""
        name = block.name
        shuffle_id = block.shuffle_id  # type: ignore[attr-defined]
        if self.config.use_fallback_fetch:
            h = _jvm_non_negative_hash(name)
            return f"{self.config.root_dir}{self.app_id}/{shuffle_id}/{h}/{name}"
        prefix = getattr(block, "map_id", 0) % self.config.folder_prefixes
        return f"{self.config.root_dir}{prefix}/{self.app_id}/{shuffle_id}/{name}"

    def create_block(self, block: BlockId):
        return self.backend.create(self.get_path(block))

    def open_block(self, block: BlockId) -> RangedReader:
        return self.backend.open_ranged(self.get_path(block))

    def root_prefixes(self) -> List[str]:
        """All top-level prefixes: one per folder, or the app's one prefix
        in the fallback-fetch layout."""
        root = self.config.root_dir
        if self.config.use_fallback_fetch:
            return [f"{root}{self.app_id}"]
        return [f"{root}{i}" for i in range(self.config.folder_prefixes)]

    def _shuffle_prefixes(self, shuffle_id: int) -> List[str]:
        """The prefixes that hold one shuffle's objects."""
        if self.config.use_fallback_fetch:
            return [f"{self.config.root_dir}{self.app_id}/{shuffle_id}"]
        return [f"{p}/{self.app_id}/{shuffle_id}" for p in self.root_prefixes()]

    def list_shuffle_indices(self, shuffle_id: int) -> List[ShuffleIndexBlockId]:
        """The committed per-map outputs of a shuffle, by listing its
        ``*.index`` objects (S3ShuffleDispatcher.scala:146-172): the block
        enumeration of listing mode (``use_block_manager=False``)."""
        return self.list_committed_outputs(shuffle_id)[0]

    def list_committed_outputs(self, shuffle_id: int) -> Tuple[List[ShuffleIndexBlockId], List[int]]:
        """One parallel listing of the shuffle's prefixes: ``(per-map
        indices, composite group ids)``, each sorted. The group list stays
        empty: the port writes and reads no composite commit (``*.cindex``)
        yet."""

        def list_one(prefix: str) -> List[ShuffleIndexBlockId]:
            found = []
            for st in self.backend.list_prefix(prefix):
                parsed = parse_index_name(st.path)
                if parsed is not None and parsed.shuffle_id == shuffle_id:
                    found.append(parsed)
            return found

        prefixes = self._shuffle_prefixes(shuffle_id)
        singles: List[ShuffleIndexBlockId] = []
        with ThreadPoolExecutor(max_workers=max(1, len(prefixes))) as pool:
            for found in pool.map(list_one, prefixes):
                singles.extend(found)
        return sorted(set(singles), key=lambda b: (b.map_id, b.reduce_id)), []

    def remove_shuffle(self, shuffle_id: int) -> None:
        """Delete one shuffle's objects, one task per prefix."""
        self._parallel_delete(self._shuffle_prefixes(shuffle_id))

    def remove_root(self) -> None:
        """Delete everything under the shuffle root for this app."""
        if self.config.use_fallback_fetch:
            self._parallel_delete(self.root_prefixes())
        else:
            self._parallel_delete([f"{p}/{self.app_id}" for p in self.root_prefixes()])

    def _parallel_delete(self, targets: List[str]) -> None:
        def delete_one(prefix: str) -> None:
            try:
                self.backend.delete_prefix(prefix)
            except Exception as e:
                logger.warning("delete of %s failed: %s", prefix, e)

        with ThreadPoolExecutor(max_workers=max(1, len(targets))) as pool:
            list(pool.map(delete_one, targets))


def _jvm_non_negative_hash(s: str) -> int:
    """The JVM's ``String.hashCode`` (signed 32-bit) through Spark's
    ``JavaUtils.nonNegativeHash``: ``Integer.MIN_VALUE`` maps to 0, any
    other value to its absolute value; no modulo. It must match the
    reference's fallback layout bit for bit (S3ShuffleDispatcher.scala:139).
    Names are ASCII, so each character is one UTF-16 unit."""
    h = 0
    for ch in s:
        h = (31 * h + ord(ch)) & 0xFFFFFFFF
    if h >= 0x80000000:
        h -= 0x100000000
    if h == -0x80000000:
        return 0
    return abs(h)
