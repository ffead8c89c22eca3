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

Blocks open for positioned ranged reads with the object's size from a
FileStatus cache, so an open does not ask the store again (:190-209);
``close_cached_blocks`` drops one shuffle's entries (:211-228).
Listing-mode enumeration lists the shuffle's prefixes in parallel, one task
each (:146-172), and finds both the per-map ``*.index`` objects and the
composite groups' ``*.cindex`` fat indexes. Deletes fan out the same way
(:104-118, 174-183); an IO error is logged and swallowed per prefix.

The lifecycle sweeps of the JAX package reclaim what the commit protocol
leaves: the orphan sweep deletes a shuffle's objects whose attempt-unique
map id is no registered winner (composite groups are judged per group: no
fat index ⇒ uncommitted, all members dead ⇒ reclaimed whole), and the
generation sweep deletes what a tombstone names once its stamp is older
than ``tombstone_ttl_s``. Each sweep logs and goes on past a failed delete.

The backend is stacked with the retry layer (``storage/retrying.py``)
unless ``storage_retries`` is 0; ``retry_policy`` is then None and every
store op of the port makes one attempt. While the metrics registry or
tracing is on, the metrics layer (``storage/instrumented.py``) sits over
it.

One dispatcher serves a process, as the reference's per-JVM
``S3ShuffleDispatcher`` does (:240-255): :meth:`Dispatcher.get` builds it
from the first config it is given (``None`` reads ``ShuffleConfig.from_env``)
and hands it to every later caller with an equal config or none; an
explicit config that differs gets a private dispatcher of its own, kept
for the next equal config in a least-recently-used table of 16.
:meth:`Dispatcher.reset` forgets both (a fresh worker process, a test).

With ``autotune`` on the dispatcher carries the process's
:class:`~s3shuffle_tpu_torch.tuning.ScanTuner` and
:class:`~s3shuffle_tpu_torch.tuning.CommitTuner` (``scan_tuner``,
``commit_tuner``; both None when it is off, so every consult site reads the
static knob), warm-started from ``autotune_profile_path`` when one is set;
:meth:`Dispatcher.save_tuner_profile` writes the profile back.
"""

from __future__ import annotations

import itertools
import json
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple

from s3shuffle_tpu_torch.block_ids import (
    BlockId,
    ShuffleIndexBlockId,
    ShuffleTombstoneBlockId,
    parse_composite_name,
    parse_index_name,
    parse_shuffle_object_name,
    parse_tombstone_name,
)
from s3shuffle_tpu_torch.config import ShuffleConfig
from s3shuffle_tpu_torch.metrics import registry as _metrics
from s3shuffle_tpu_torch.storage.backend import (
    FileStatus,
    RangedReader,
    StorageBackend,
    get_backend,
)
from s3shuffle_tpu_torch.storage.retrying import RetryPolicy
from s3shuffle_tpu_torch.utils.concurrent_map import ConcurrentObjectMap

logger = logging.getLogger("s3shuffle_tpu_torch.dispatcher")

_C_SWEEP_DELETED = _metrics.REGISTRY.counter(
    "storage_sweep_deleted_total",
    "Objects reclaimed by lifecycle sweeps, by reason: dead-attempt "
    "orphans, expired generation tombstones (TTL), uncommitted composites",
    labelnames=("reason",),
)

#: process-local uniquifier mixed into generation stamps
_GEN_SEQ = itertools.count()


class Dispatcher:
    _instance: Optional["Dispatcher"] = None
    _instance_lock = threading.Lock()
    #: (config, dispatcher) of explicit configs unequal to the singleton's,
    #: least recently used first
    _private: List[Tuple[ShuffleConfig, "Dispatcher"]] = []
    PRIVATE_MAX = 16

    def __init__(self, config: ShuffleConfig):
        self.config = config
        # None at storage_retries = 0: no retry layer, every op fails fast
        self.retry_policy = RetryPolicy.from_config(config)
        self.backend: StorageBackend = get_backend(
            config.root_dir, config.storage_options, self.retry_policy
        )
        self.app_id = config.app_id
        self._status_cache: ConcurrentObjectMap[str, FileStatus] = ConcurrentObjectMap()
        # run on reinitialize() so dependent caches (the metadata helper's)
        # never serve paths of the placeholder app id
        self._reinit_callbacks: List[Callable[[], None]] = []
        if config.supports_rename is None:
            self.supports_rename = self.backend.supports_rename
        else:
            self.supports_rename = config.supports_rename
        # the online autotuner: both None when it is off, and every consult
        # site then reads the static config value
        self.scan_tuner = None
        self.commit_tuner = None
        if config.autotune:
            from s3shuffle_tpu_torch.tuning import CommitTuner, ScanTuner

            self.scan_tuner = ScanTuner(config)
            self.commit_tuner = CommitTuner(config)
            if config.autotune_profile_path:
                # warm start from an earlier process's rung tables (a
                # missing or torn profile is a cold start)
                from s3shuffle_tpu_torch.tuning import profile as _tune_profile

                _tune_profile.load_into(
                    config.autotune_profile_path, self.scan_tuner, self.commit_tuner
                )
        config.log_values()

    @classmethod
    def get(cls, config: Optional[ShuffleConfig] = None) -> "Dispatcher":
        """The process's dispatcher (see the module docstring)."""
        if cls._instance is None:
            with cls._instance_lock:
                if cls._instance is None:
                    cls._instance = Dispatcher(config or ShuffleConfig.from_env())
        if config is None or cls._instance.config == config:
            return cls._instance
        with cls._instance_lock:
            for i, (cfg, disp) in enumerate(cls._private):
                if cfg == config:
                    cls._private.append(cls._private.pop(i))
                    return disp
            disp = Dispatcher(config)
            cls._private.append((config, disp))
            if len(cls._private) > cls.PRIVATE_MAX:
                cls._private.pop(0)
            return disp

    @classmethod
    def reset(cls) -> None:
        with cls._instance_lock:
            cls._instance = None
            cls._private = []

    def reinitialize(self, app_id: str) -> None:
        """Executor components re-initialize with the real application id
        once it is known (S3ShuffleDataIO.scala:30-32 →
        S3ShuffleDispatcher.scala:30-34)."""
        self.app_id = app_id
        self._status_cache.clear()
        for cb in self._reinit_callbacks:
            cb()

    def on_reinitialize(self, callback: Callable[[], None]) -> None:
        self._reinit_callbacks.append(callback)

    def save_tuner_profile(self) -> None:
        """Write the tuners' rung tables to ``autotune_profile_path``; a
        no-op unless autotune and a path are set. Never raises (a failed
        write logs a WARNING)."""
        if not self.config.autotune_profile_path or (
            self.scan_tuner is None and self.commit_tuner is None
        ):
            return
        from s3shuffle_tpu_torch.tuning import profile as _tune_profile

        _tune_profile.save_profile(
            self.config.autotune_profile_path, self.scan_tuner, self.commit_tuner
        )

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
        """Open for positioned ranged reads, passing the cached size so the
        open does not ask the store for it again
        (S3ShuffleDispatcher.scala:190-198)."""
        path = self.get_path(block)
        status = self.get_file_status_cached(path)
        return self.backend.open_ranged(path, size_hint=status.size)

    def get_file_status_cached(self, path: str) -> FileStatus:
        return self._status_cache.get_or_else_put(path, self.backend.status)

    def close_cached_blocks(self, shuffle_id: int) -> None:
        """Drop one shuffle's entries of the FileStatus cache, of every
        block kind (S3ShuffleDispatcher.scala:211-228)."""
        needle = f"shuffle_{shuffle_id}_"
        self._status_cache.remove(lambda p: needle in p.rsplit("/", 1)[-1])

    def clear_status_cache(self) -> None:
        self._status_cache.clear()

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
        indices, composite group ids)``, each sorted — the committed
        singleton outputs (their ``*.index`` objects) and the sealed
        composite groups (their ``*.cindex`` fat indexes)."""

        def list_one(prefix: str):
            singles, groups = [], []
            for st in self.backend.list_prefix(prefix):
                parsed = parse_index_name(st.path)
                if parsed is not None and parsed.shuffle_id == shuffle_id:
                    singles.append(parsed)
                    continue
                comp = parse_composite_name(st.path)
                if comp is not None and comp[0] == shuffle_id and comp[2] == "cindex":
                    groups.append(comp[1])
            return singles, groups

        prefixes = (
            self.root_prefixes()
            if self.config.use_fallback_fetch
            else self._shuffle_prefixes(shuffle_id)
        )
        singles: List[ShuffleIndexBlockId] = []
        groups: List[int] = []
        with ThreadPoolExecutor(max_workers=max(1, len(prefixes))) as pool:
            for one_singles, one_groups in pool.map(list_one, prefixes):
                singles.extend(one_singles)
                groups.extend(one_groups)
        return (
            sorted(set(singles), key=lambda b: (b.map_id, b.reduce_id)),
            sorted(set(groups)),
        )

    def list_composite_groups(self, shuffle_id: int) -> List[int]:
        """Sealed composite group ids of one shuffle (fat-index listing)."""
        return self.list_committed_outputs(shuffle_id)[1]

    # --- lifecycle sweeps ---
    def _sweep_delete(self, path: str, reason: str, removed: List[str]) -> None:
        """One sweep deletion, counted by reason: a failure is logged and the
        sweep goes on."""
        try:
            self.backend.delete(path)
        except Exception as e:
            logger.warning("%s sweep delete of %s failed: %s", reason, path, e)
            return
        removed.append(path)
        if _metrics.enabled():
            _C_SWEEP_DELETED.labels(reason=reason).inc()

    def _sweep_composites(self, listed: Sequence[FileStatus], shuffle_id: int, winners,
                          removed: List[str]) -> None:
        """The composite half of the orphan sweep. A composite data object
        without a fat index is an uncommitted group: it is deleted with its
        parity sidecars. A sealed group whose members are all dead attempts
        is deleted whole; a group with a winning member is kept (its dead
        members' bytes wait for shuffle teardown, which is logged)."""
        from s3shuffle_tpu_torch.metadata.fat_index import FatIndex

        by_group: dict = {}
        for st in listed:
            comp = parse_composite_name(st.path)
            if comp is None or comp[0] != shuffle_id:
                continue
            entry = by_group.setdefault(comp[1], {"parity": []})
            if comp[2] == "parity":
                entry["parity"].append(st.path)
            else:
                entry[comp[2]] = st.path
        for group_id, paths in sorted(by_group.items()):
            cindex = paths.get("cindex")
            if cindex is None:
                for path in [paths.get("data")] + sorted(paths["parity"]):
                    if path is not None:
                        self._sweep_delete(path, "uncommitted-composite", removed)
                continue
            try:
                member_ids = set(FatIndex.from_bytes(self.backend.read_all(cindex)).members)
            except Exception as e:
                logger.warning("orphan sweep could not read fat index %s (%s); keeping group",
                               cindex, e)
                continue
            live = member_ids & winners
            if live:
                dead = member_ids - winners
                if dead:
                    logger.info(
                        "composite group %d of shuffle %d keeps %d dead-attempt member(s) "
                        "beside %d winner(s); bytes reclaimed at shuffle teardown",
                        group_id, shuffle_id, len(dead), len(live),
                    )
                continue
            doomed = [p for k, p in paths.items() if k != "parity"] + paths["parity"]
            for path in sorted(doomed):
                self._sweep_delete(path, "orphan", removed)

    def sweep_orphan_attempts(self, shuffle_id: int, winner_map_ids) -> List[str]:
        """Delete the shuffle's objects whose attempt-unique map id is not a
        registered winner: what a task that died before its commit point
        (or failed it) left behind. Composite groups are judged per group
        (:meth:`_sweep_composites`). Winners' objects have other names (the
        ids are attempt-unique), so the sweep never touches them. Returns
        the deleted paths."""
        winners = set(int(m) for m in winner_map_ids)

        def sweep_one(prefix: str) -> List[str]:
            removed: List[str] = []
            try:
                listed = self.backend.list_prefix(prefix)
            except Exception as e:
                logger.warning("orphan sweep list of %s failed: %s", prefix, e)
                return removed
            for st in listed:
                parsed = parse_shuffle_object_name(st.path)
                if parsed is None or parsed[0] != shuffle_id or parsed[1] in winners:
                    continue
                self._sweep_delete(st.path, "orphan", removed)
            self._sweep_composites(listed, shuffle_id, winners, removed)
            return removed

        prefixes = self._shuffle_prefixes(shuffle_id)
        removed: List[str] = []
        with ThreadPoolExecutor(max_workers=max(1, len(prefixes))) as pool:
            for chunk in pool.map(sweep_one, prefixes):
                removed.extend(chunk)
        if removed:
            logger.info("Orphan sweep for shuffle %d removed %d dead-attempt objects",
                        shuffle_id, len(removed))
        return removed

    def stamp_generation(self, shuffle_id: int, paths: Sequence[str]) -> int:
        """Tombstone superseded objects under a fresh generation stamp
        instead of deleting them: in-flight scans may still read them, so
        :meth:`sweep_expired_generations` reclaims them after
        ``tombstone_ttl_s``. Returns the generation."""
        generation = int(time.time() * 1e3) * 1000 + next(_GEN_SEQ) % 1000
        doc = {
            "generation": generation,
            "stamped_unix": time.time(),
            "paths": sorted(str(p) for p in paths),
        }
        stream = self.create_block(ShuffleTombstoneBlockId(shuffle_id, generation))
        try:
            stream.write(json.dumps(doc).encode("utf-8"))
        finally:
            stream.close()
        logger.info("Stamped generation %d for shuffle %d (%d superseded objects)",
                    generation, shuffle_id, len(doc["paths"]))
        return generation

    def sweep_expired_generations(self, shuffle_id: int, ttl_s: Optional[float] = None) -> List[str]:
        """Delete the objects this shuffle's tombstones name once a stamp is
        older than ``ttl_s`` (default ``tombstone_ttl_s``), then the
        tombstone itself — kept while any named object could not be
        deleted. Returns the deleted paths."""
        ttl = self.config.tombstone_ttl_s if ttl_s is None else float(ttl_s)
        now = time.time()
        removed: List[str] = []
        for prefix in self._shuffle_prefixes(shuffle_id):
            try:
                listed = self.backend.list_prefix(prefix)
            except Exception as e:
                logger.warning("generation sweep list of %s failed: %s", prefix, e)
                continue
            for st in listed:
                parsed = parse_tombstone_name(st.path)
                if parsed is None or parsed[0] != shuffle_id:
                    continue
                try:
                    doc = json.loads(self.backend.read_all(st.path).decode("utf-8"))
                    stamped = float(doc["stamped_unix"])
                    paths = [str(p) for p in doc["paths"]]
                except Exception as e:
                    logger.warning("generation sweep could not read tombstone %s: %s",
                                   st.path, e)
                    continue
                if now - stamped < ttl:
                    continue
                ok = True
                for path in paths:
                    before = len(removed)
                    self._sweep_delete(path, "generation", removed)
                    if len(removed) == before:
                        try:
                            self.backend.status(path)
                            ok = False  # still there: keep the tombstone
                        except OSError:
                            pass  # already gone
                if ok:
                    self._sweep_delete(st.path, "generation", removed)
        if removed:
            logger.info("Generation sweep for shuffle %d reclaimed %d objects",
                        shuffle_id, len(removed))
        return removed

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
