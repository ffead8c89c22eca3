"""Block enumeration and the reference's config surface of the port against
the JAX package, on the CPU, exactly:

- a listing-mode read (``use_block_manager=False``) equals the
  metadata-mode read and the JAX package's listing read, for shuffles
  written by either package, on ``file://`` and on ``memory://`` (each
  package keeps its own memory store; the writer's objects are copied into
  the reader's under the same keys);
- the fallback-fetch layout's paths equal the JAX ``Dispatcher.get_path``
  over a grid of block ids (names whose ``hashCode`` is negative among
  them), and the JVM hash equals Java's on known strings, one of them
  ``Integer.MIN_VALUE``; a shuffle written in that layout reads back in
  listing mode through both packages and is removed whole;
- ``always_create_index`` commits the same objects for an empty map, and a
  missing index is skipped or raises exactly where the JAX package skips
  or raises;
- ``map_id_attempt_stride`` keeps the latest committed attempt of each
  logical map and filters the map range on the logical index;
- ``from_dict``, ``from_env`` and ``log_values`` agree with the JAX
  ``ShuffleConfig`` on every shared key;
- the backends' ``status``, ``list_prefix`` and ``exists`` agree with the
  JAX package's.
"""

import logging
import os

import numpy as np
import pytest

from s3shuffle_tpu import config as jax_config_module
from s3shuffle_tpu.block_ids import ShuffleBlockId as JaxBlockId
from s3shuffle_tpu.block_ids import ShuffleChecksumBlockId as JaxChecksumBlockId
from s3shuffle_tpu.block_ids import ShuffleDataBlockId as JaxDataBlockId
from s3shuffle_tpu.block_ids import ShuffleIndexBlockId as JaxIndexBlockId
from s3shuffle_tpu.block_ids import ShuffleParityBlockId as JaxParityBlockId
from s3shuffle_tpu.config import ShuffleConfig as JaxConfig
from s3shuffle_tpu.dependency import HashPartitioner as JaxHashPartitioner
from s3shuffle_tpu.dependency import ShuffleDependency as JaxDependency
from s3shuffle_tpu.manager import ShuffleManager as JaxManager
from s3shuffle_tpu.metadata.helper import ShuffleHelper as JaxHelper
from s3shuffle_tpu.read.block_iterator import BlockIterator as JaxBlockIterator
from s3shuffle_tpu.read.scan_plan import plan_scan as jax_plan_scan
from s3shuffle_tpu.metadata.helper import ScanIndexMemo as JaxScanIndexMemo
from s3shuffle_tpu.storage import backend as jax_backend
from s3shuffle_tpu.storage.dispatcher import Dispatcher as JaxDispatcher
from s3shuffle_tpu.storage.dispatcher import _jvm_non_negative_hash as jax_jvm_hash
from s3shuffle_tpu.write.map_output_writer import MapOutputWriter as JaxMapOutputWriter
from s3shuffle_tpu_torch import ShuffleConfig, ShuffleManager, config as port_config_module
from s3shuffle_tpu_torch.block_ids import (
    ShuffleBlockId,
    ShuffleChecksumBlockId,
    ShuffleDataBlockId,
    ShuffleIndexBlockId,
    ShuffleParityBlockId,
    parse_index_name,
)
from s3shuffle_tpu_torch.dependency import HashPartitioner, ShuffleDependency
from s3shuffle_tpu_torch.metadata.helper import ScanIndexMemo, ShuffleHelper
from s3shuffle_tpu_torch.metadata.map_output import STORE_LOCATION, MapStatus
from s3shuffle_tpu_torch.read.block_iterator import BlockIterator
from s3shuffle_tpu_torch.read.scan_plan import plan_scan
from s3shuffle_tpu_torch.storage import backend as port_backend
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher, _jvm_non_negative_hash
from s3shuffle_tpu_torch.write.map_output_writer import MapOutputWriter
from torch_jax_native import jax_native_library  # noqa: F401  (loads the JAX oracle's native library)
from torch_port_dispatcher import port_dispatcher_reset  # noqa: F401  (resets the port's process dispatcher)

PARTS = 4
MAPS = 3
#: both packages on one host codec (enumeration does not depend on it)
BASE = {"codec": "zlib", "checksum_algorithm": "CRC32C", "cleanup": False}


def _records(map_id: int, n: int = 300):
    rng = np.random.default_rng(map_id)
    return [(int(k), bytes(v)) for k, v in zip(rng.integers(0, 1000, n),
                                                rng.integers(0, 256, (n, 12), dtype=np.uint8))]


def _root(tmp_path, scheme: str, tag: str) -> str:
    return f"file://{tmp_path / tag}" if scheme == "file" else f"memory://{tmp_path.name}-{tag}"


def _port_manager(root: str, **knobs):
    return ShuffleManager(ShuffleConfig(root_dir=root, **BASE, **knobs), device="cpu")


def _jax_manager(root: str, **knobs):
    JaxDispatcher.reset()
    return JaxManager(JaxConfig(root_dir=root, **BASE, **knobs))


def _write(mgr, jax: bool, map_ids, records_of=_records):
    dep_cls, part_cls = (JaxDependency, JaxHashPartitioner) if jax else (
        ShuffleDependency, HashPartitioner)
    handle = mgr.register_shuffle(0, dep_cls(shuffle_id=0, partitioner=part_cls(PARTS)))
    for map_id in map_ids:
        writer = mgr.get_writer(handle, map_id)
        writer.write(records_of(map_id))
        writer.stop(success=True)


def _share_memory_store(root: str, writer_is_jax: bool) -> None:
    """Copy the writer package's ``memory://`` objects into the other
    package's store for the same root (each package has its own registry)."""
    root = ShuffleConfig(root_dir=root).root_dir  # as the dispatchers name it
    src = (jax_backend if writer_is_jax else port_backend)._memory_backends[root]
    dst_module = port_backend if writer_is_jax else jax_backend
    dst = dst_module.get_backend(root)
    with src._lock, dst._lock:
        dst._store.clear()
        dst._store.update(src._store)


def _read(mgr, jax: bool, register=(), **range_kw):
    """Every record of the shuffle through a fresh manager, partition by
    partition, as a sorted list. ``register`` names the map ids whose
    outputs are registered with the tracker from their index objects
    (metadata mode)."""
    dep_cls, part_cls = (JaxDependency, JaxHashPartitioner) if jax else (
        ShuffleDependency, HashPartitioner)
    handle = mgr.register_shuffle(0, dep_cls(shuffle_id=0, partitioner=part_cls(PARTS)))
    if register:
        from s3shuffle_tpu.metadata.map_output import MapStatus as JaxMapStatus

        status = JaxMapStatus if jax else MapStatus
        for m in register:
            sizes = np.diff(np.asarray(mgr.helper.get_partition_lengths(0, m)))
            mgr.tracker.register_map_output(0, status(map_id=m, location=STORE_LOCATION,
                                                      sizes=sizes))
    out = []
    for p in range(PARTS):
        out.extend(mgr.get_reader(handle, p, p + 1, **range_kw).read())
    return sorted(out)


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("scheme", ["file", "memory"])
def test_listing_read_equals_the_metadata_read_and_the_jax_listing_read(tmp_path, writer,
                                                                        scheme):
    root = _root(tmp_path, scheme, "store")
    jax_writes = writer == "jax"
    wmgr = _jax_manager(root) if jax_writes else _port_manager(root)
    _write(wmgr, jax_writes, range(MAPS))
    if scheme == "memory":
        _share_memory_store(root, jax_writes)
    want = sorted(r for m in range(MAPS) for r in _records(m))
    metadata = _read(_port_manager(root), False, register=range(MAPS))
    listing = _read(_port_manager(root, use_block_manager=False), False)
    jax_listing = _read(_jax_manager(root, use_block_manager=False), True)
    assert metadata == listing == jax_listing == want
    # a map range, in both packages
    ranged = _read(_port_manager(root, use_block_manager=False), False,
                   start_map_index=1, end_map_index=MAPS)
    assert ranged == _read(_jax_manager(root, use_block_manager=False), True,
                           start_map_index=1, end_map_index=MAPS)
    assert ranged == sorted(r for m in range(1, MAPS) for r in _records(m))


def test_listing_finds_the_same_indices_as_jax(tmp_path):
    root = f"file://{tmp_path}"
    _write(_port_manager(root), False, [0, 2, 5, 11])
    port = Dispatcher(ShuffleConfig(root_dir=root)).list_shuffle_indices(0)
    JaxDispatcher.reset()
    jax = JaxDispatcher(JaxConfig(root_dir=root)).list_shuffle_indices(0)
    assert [b.name for b in port] == [b.name for b in jax] == [
        f"shuffle_0_{m}_0.index" for m in (0, 2, 5, 11)]
    assert Dispatcher(ShuffleConfig(root_dir=root)).list_shuffle_indices(1) == []
    for name in ("shuffle_3_4_0.index", "x/y/shuffle_3_4_0.index", "shuffle_3_4_0.data",
                 "shuffle_3_4_0.checksum.CRC32C", "shuffle_3_comp_1.cindex"):
        from s3shuffle_tpu.block_ids import parse_index_name as jax_parse

        mine, theirs = parse_index_name(name), jax_parse(name)
        assert (mine is None) == (theirs is None)
        if mine is not None:
            assert mine.name == theirs.name


# --- the fallback-fetch layout ---

#: Java's String.hashCode of each string through JavaUtils.nonNegativeHash
#: ("polygenelubricants".hashCode() is Integer.MIN_VALUE, which maps to 0)
JAVA_HASHES = {"": 0, "a": 97, "hello": 99162322, "polygenelubricants": 0}


@pytest.mark.parametrize("text", list(JAVA_HASHES))
def test_jvm_hash_equals_java_and_jax(text):
    assert _jvm_non_negative_hash(text) == jax_jvm_hash(text) == JAVA_HASHES[text]


class _NamedBlock:
    """A block id of any name: the grid's ``Integer.MIN_VALUE`` hash."""

    def __init__(self, shuffle_id, map_id, name):
        self.shuffle_id, self.map_id, self.name = shuffle_id, map_id, name


def _block_grid(jax: bool):
    ids = (JaxBlockId, JaxDataBlockId, JaxIndexBlockId, JaxChecksumBlockId, JaxParityBlockId) \
        if jax else (ShuffleBlockId, ShuffleDataBlockId, ShuffleIndexBlockId,
                     ShuffleChecksumBlockId, ShuffleParityBlockId)
    block, data, index, checksum, parity = ids
    out = []
    for s in (0, 7, 123):
        for m in (0, 1, 9, 10, 4321, 2**31 - 1):
            out += [block(s, m, m % 5), data(s, m), index(s, m),
                    checksum(s, m, 0, "CRC32C"), parity(s, m, 1)]
    return out + [_NamedBlock(3, 4, "polygenelubricants")]


@pytest.mark.parametrize("fallback", [False, True])
def test_paths_equal_jax_over_a_grid_of_block_ids(fallback):
    cfg = dict(root_dir="memory://enumeration-layout", app_id="app-1", folder_prefixes=7,
               use_fallback_fetch=fallback)
    JaxDispatcher.reset()
    jax = JaxDispatcher(JaxConfig(**cfg))
    port = Dispatcher(ShuffleConfig(**cfg))
    port_paths = [port.get_path(b) for b in _block_grid(False)]
    assert port_paths == [jax.get_path(b) for b in _block_grid(True)]
    if fallback:
        hashes = [int(p.rsplit("/", 2)[1]) for p in port_paths]
        names = [p.rsplit("/", 1)[1] for p in port_paths]
        assert hashes == [_jvm_non_negative_hash(n) for n in names]
        signed = [sum(ord(c) * 31 ** (len(n) - 1 - i) for i, c in enumerate(n)) & 0xFFFFFFFF
                  for n in names]
        assert any(h >= 1 << 31 for h in signed), "the grid holds no negative hashCode"
        assert port_paths[-1].endswith("/app-1/3/0/polygenelubricants")  # MIN_VALUE → 0
    assert port.root_prefixes() == jax.root_prefixes()
    assert port._shuffle_prefixes(7) == jax._shuffle_prefixes(7)


def test_a_fallback_layout_shuffle_reads_in_listing_mode_and_is_removed(tmp_path):
    root = f"file://{tmp_path}"
    knobs = dict(use_fallback_fetch=True, use_block_manager=False)
    _write(_port_manager(root, **knobs), False, range(MAPS))
    disp = Dispatcher(ShuffleConfig(root_dir=root, **knobs))
    for m in range(MAPS):
        for block in (ShuffleDataBlockId(0, m), ShuffleIndexBlockId(0, m)):
            h = _jvm_non_negative_hash(block.name)
            assert os.path.exists(f"{tmp_path}/app/0/{h}/{block.name}")
    want = sorted(r for m in range(MAPS) for r in _records(m))
    assert _read(_port_manager(root, **knobs), False) == want
    assert _read(_jax_manager(root, **knobs), True) == want
    disp.remove_shuffle(0)
    assert not any(files for _d, _s, files in os.walk(tmp_path))


@pytest.mark.parametrize("fallback", [False, True])
def test_listing_mode_lists_the_prefixes_jax_lists(tmp_path, fallback):
    """``list_committed_outputs`` of shuffle 3 asks the store for the same
    prefixes in both packages: every folder's shuffle prefix, or in the
    fallback-fetch layout the app's root prefix."""
    knobs = dict(root_dir=f"file://{tmp_path}", folder_prefixes=3,
                 use_fallback_fetch=fallback, use_block_manager=False)
    listed = []
    JaxDispatcher.reset()
    for disp in (JaxDispatcher(JaxConfig(**BASE, **knobs)),
                 Dispatcher(ShuffleConfig(**BASE, **knobs))):
        calls = []
        inner_list = disp.backend.list_prefix

        def list_prefix(prefix, _inner=inner_list, _calls=calls):
            _calls.append(prefix)
            return _inner(prefix)

        disp.backend.list_prefix = list_prefix
        assert disp.list_committed_outputs(3) == ([], [])
        listed.append(sorted(calls))
    assert listed[1] == listed[0]
    root = f"file://{tmp_path}/"
    assert listed[1] == ([f"{root}app"] if fallback
                         else [f"{root}{i}/app/3" for i in range(3)])


# --- always_create_index and the canary ---

def _objects(root) -> dict:
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            full = os.path.join(dirpath, fn)
            with open(full, "rb") as f:
                out[os.path.relpath(full, root)] = f.read()
    return out


@pytest.mark.parametrize("always", [False, True])
def test_an_empty_map_commits_what_jax_commits(tmp_path, always):
    trees = {}
    for tag, jax in (("port", False), ("jax", True)):
        root = f"file://{tmp_path / tag}"
        if jax:
            JaxDispatcher.reset()
            disp = JaxDispatcher(JaxConfig(root_dir=root, always_create_index=always, **BASE))
            writer = JaxMapOutputWriter(disp, JaxHelper(disp), 0, 0, PARTS)
        else:
            disp = Dispatcher(ShuffleConfig(root_dir=root, always_create_index=always, **BASE))
            writer = MapOutputWriter(disp, ShuffleHelper(disp), 0, 0, PARTS, device="cpu")
        for p in range(PARTS):
            writer.get_partition_writer(p).close()
        writer.commit_all_partitions()
        trees[tag] = _objects(tmp_path / tag)
    assert trees["port"] == trees["jax"]
    assert bool(trees["port"]) == always
    if always:
        assert any(name.endswith(".index") for name in trees["port"])


MODES = [(True, False), (False, False), (False, True), (True, True)]


@pytest.mark.parametrize("planner", [False, True], ids=["per-block", "planner"])
@pytest.mark.parametrize("mode", MODES, ids=["metadata", "listing", "listing-always",
                                             "metadata-always"])
def test_a_missing_index_raises_exactly_where_jax_raises(tmp_path, mode, planner):
    use_block_manager, always = mode
    root = f"file://{tmp_path}"
    knobs = dict(use_block_manager=use_block_manager, always_create_index=always)
    _write(_port_manager(root), False, [0, 1])
    port_disp = Dispatcher(ShuffleConfig(root_dir=root, **BASE, **knobs))
    port_disp.backend.delete(port_disp.get_path(ShuffleIndexBlockId(0, 1)))
    JaxDispatcher.reset()
    jax_disp = JaxDispatcher(JaxConfig(root_dir=root, **BASE, **knobs))
    outcomes = []
    for disp, helper, memo, iterator, plan, block in (
        (port_disp, ShuffleHelper(port_disp), ScanIndexMemo, BlockIterator, plan_scan,
         ShuffleBlockId),
        (jax_disp, JaxHelper(jax_disp), JaxScanIndexMemo, JaxBlockIterator, jax_plan_scan,
         JaxBlockId),
    ):
        blocks = [block(0, m, p) for m in (0, 1) for p in range(PARTS)]
        try:
            if planner:
                segs = plan(disp, memo(helper), blocks, gap_bytes=1 << 20, max_bytes=1 << 26)
                got = sorted(r.block.name for s in segs for r in s.members)
            else:
                got = []
                for b, stream in iterator(disp, helper, blocks):
                    got.append(b.name)
                    stream.close()
            outcomes.append(("ok", got))
        except FileNotFoundError:
            outcomes.append(("raised", None))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0] == ("raised" if use_block_manager or always else "ok")
    if outcomes[0][0] == "ok":
        assert outcomes[0][1] and all(name.startswith("shuffle_0_0_") for name in outcomes[0][1])


# --- attempt-unique map ids ---

STRIDE = 1000


def _attempt_records(map_id: int):
    return _records(map_id, n=100)


def test_attempt_stride_keeps_the_latest_attempt(tmp_path):
    root = f"file://{tmp_path}"
    # logical map 0: attempts 0 and 2 both committed; map 1: attempt 0;
    # map 2: attempts 1 and 0
    map_ids = [0, 2, STRIDE, 2 * STRIDE + 1, 2 * STRIDE]
    _write(_port_manager(root), False, map_ids, _attempt_records)
    knobs = dict(use_block_manager=False, map_id_attempt_stride=STRIDE)
    latest = [2, STRIDE, 2 * STRIDE + 1]
    got = _read(_port_manager(root, **knobs), False)
    assert got == _read(_jax_manager(root, **knobs), True)
    assert got == sorted(r for m in latest for r in _attempt_records(m))
    ranged = _read(_port_manager(root, **knobs), False, start_map_index=1, end_map_index=2)
    assert ranged == _read(_jax_manager(root, **knobs), True, start_map_index=1, end_map_index=2)
    assert ranged == sorted(_attempt_records(STRIDE))


# --- the config surface ---

def _shared_fields():
    import dataclasses

    port = {f.name for f in dataclasses.fields(ShuffleConfig)}
    jax = {f.name for f in dataclasses.fields(JaxConfig)}
    return sorted(port & jax)


def test_the_reference_key_table_is_the_jax_table_on_the_ports_fields():
    import dataclasses

    port_fields = {f.name for f in dataclasses.fields(ShuffleConfig)}
    jax_table = jax_config_module._REFERENCE_KEYS
    left_out = sorted(k for k, v in jax_table.items() if v not in port_fields)
    assert left_out == []  # every reference key names a field the port has
    assert port_config_module._REFERENCE_KEYS == {
        k: v for k, v in jax_table.items() if k not in left_out}
    # the port's own fields, absent from the JAX config, are none
    assert sorted(port_fields - {f.name for f in dataclasses.fields(JaxConfig)}) == []


REFERENCE_DICT = {
    "spark.shuffle.s3.rootDir": "file:///tmp/ref-root",
    "spark.shuffle.s3.bufferSize": "4m",
    "spark.shuffle.s3.maxBufferSizeTask": "64m",
    "spark.shuffle.s3.maxConcurrencyTask": "7",
    "spark.shuffle.s3.cachePartitionLengths": "false",
    "spark.shuffle.s3.cacheChecksums": "no",
    "spark.shuffle.s3.cleanup": "0",
    "spark.shuffle.s3.folderPrefixes": "3",
    "spark.shuffle.s3.alwaysCreateIndex": "true",
    "spark.shuffle.s3.useBlockManager": "false",
    "spark.shuffle.s3.forceBatchFetch": "on",
    "spark.shuffle.s3.useSparkShuffleFetch": "yes",
    "spark.shuffle.checksum.enabled": "1",
    "spark.shuffle.checksum.algorithm": "crc32c",
    "tpu_batch_blocks": "16",
    "encode_inflight_batches": "3",
    "decode_batch_frames": "8",
    "decode_inflight_batches": "0",
    "codec_block_size": "none",
    "supports_rename": "",
    "map_id_attempt_stride": "1k",
    "storage_options": '{"endpoint_url": "http://localhost:9000", "secret": "s3cr3t"}',
    "codec": "zlib",
}


def _same(port, jax, unless=()):
    for name in _shared_fields():
        if name not in unless:
            assert getattr(port, name) == getattr(jax, name), name


def test_from_dict_agrees_with_jax_on_every_shared_key():
    port = ShuffleConfig.from_dict(REFERENCE_DICT)
    jax = JaxConfig.from_dict(REFERENCE_DICT)
    _same(port, jax)
    assert (port.use_block_manager, port.use_fallback_fetch, port.always_create_index,
            port.codec_batch_blocks, port.map_id_attempt_stride) == (False, True, True, 16, 1024)
    for bad in ({"spark.shuffle.s3.noSuchKey": "1"}, {"tpu_host_fallback": "1"}):
        with pytest.raises(KeyError):
            ShuffleConfig.from_dict(bad)
    with pytest.raises(KeyError):
        JaxConfig.from_dict({"spark.shuffle.s3.noSuchKey": "1"})
    with pytest.raises(ValueError):
        ShuffleConfig.from_dict({"decode_batch_frames": "0"})
    with pytest.raises(ValueError):
        JaxConfig.from_dict({"decode_batch_frames": "0"})


def test_from_env_agrees_with_jax_on_every_shared_key():
    env = {"S3SHUFFLE_" + k.upper(): v for k, v in REFERENCE_DICT.items() if "." not in k}
    env.update({"S3SHUFFLE_ROOT_DIR": "file:///tmp/env-root", "S3SHUFFLE_FOLDER_PREFIXES": "5",
                "S3SHUFFLE_USE_BLOCK_MANAGER": "false", "S3SHUFFLE_CODEC_BATCH_BLOCKS": "32",
                "S3SHUFFLE_MAX_BUFFER_SIZE_TASK": "2g", "S3SHUFFLE_CHECKSUM_ALGORITHM": "crc32"})
    port, jax = ShuffleConfig.from_env(env), JaxConfig.from_env(env)
    _same(port, jax)
    assert port.codec_batch_blocks == 32  # the new name wins over tpu_batch_blocks
    assert port.max_buffer_size_task == 2 << 30 and port.folder_prefixes == 5
    # at the defaults every shared field agrees but the codec: the port's
    # default is the TLZ codec on the card, the JAX package's "auto"
    port, jax = ShuffleConfig.from_env({}), JaxConfig.from_env({})
    _same(port, jax, unless=("codec",))
    assert (port.codec, jax.codec) == ("tpu", "auto")


def test_log_values_agrees_with_jax_and_hides_storage_option_values(caplog):
    cfg = dict(storage_options={"endpoint_url": "http://localhost:9000", "secret": "s3cr3t"},
               codec="zlib")
    with caplog.at_level(logging.INFO):
        ShuffleConfig(**cfg).log_values()
    port_lines = [r.getMessage() for r in caplog.records
                  if r.name == "s3shuffle_tpu_torch.config"]
    caplog.clear()
    with caplog.at_level(logging.INFO):
        JaxConfig(**cfg).log_values()
    jax_lines = [r.getMessage() for r in caplog.records if r.name == "s3shuffle_tpu.config"]
    shared = set(_shared_fields())

    def by_field(lines):
        return {line.split("=", 1)[0].split()[-1]: line for line in lines
                if line.split("=", 1)[0].split()[-1] in shared}

    assert by_field(port_lines) == by_field(jax_lines)
    assert len(port_lines) == len(shared)
    assert not any("s3cr3t" in line or "localhost" in line for line in port_lines)
    assert "config: storage_options keys=['endpoint_url', 'secret']" in port_lines
    assert "s3cr3t" not in repr(ShuffleConfig(**cfg))


# --- the backends ---

@pytest.mark.parametrize("scheme", ["file", "memory"])
def test_status_listing_and_exists_agree_with_jax(tmp_path, scheme):
    results = []
    for tag, module in (("port-root", port_backend), ("jax-root", jax_backend)):
        root = (f"file://{tmp_path / tag}" if scheme == "file"
                else f"memory://{tmp_path.name}-{tag}")
        b = module.get_backend(root)
        for name, data in (("a/x.index", b"12"), ("a/b/y.data", b"12345"), ("c/z", b"")):
            with b.create(f"{root}/{name}") as f:
                f.write(data)

        def rel(path, _tag=tag):
            return path.rsplit(_tag, 1)[1].lstrip("/")

        results.append((
            sorted((rel(st.path), st.size) for st in b.list_prefix(f"{root}/a")),
            [(rel(st.path), st.size) for st in b.list_prefix(f"{root}/a/x.index")],
            b.list_prefix(f"{root}/nothing"),
            b.status(f"{root}/a/b/y.data").size,
            b.exists(f"{root}/c/z"),
            b.exists(f"{root}/c/missing"),
        ))
        with pytest.raises(FileNotFoundError):
            b.status(f"{root}/c/missing")
    assert results[0] == results[1]
    assert results[0][0] == [("a/b/y.data", 5), ("a/x.index", 2)]
    assert port_backend.get_backend("memory://shared") is port_backend.get_backend("memory://shared")
    # a scheme with no fsspec driver installed raises in both packages alike
    for module in (port_backend, jax_backend):
        with pytest.raises(RuntimeError, match="No fsspec driver for scheme 's3a'"):
            module.get_backend("s3a://bucket/root")
