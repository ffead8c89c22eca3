"""The composite commit plane of the port against the JAX package, on the
CPU, at a few KiB: fat indexes, composite groups and their seal thresholds,
the seal barrier, composite parity, the compactor and the lifecycle sweeps.

The JAX cases of ``tests/test_composite_commit.py`` and
``tests/test_coding_plane.py`` (the single-process ones) are held against
the port, and the two packages against each other: for one commit order on
one thread the composite data, ``.cindex`` and composite ``.parity``
objects are byte-equal; each package reads the other's composite shuffle
with hints from registration (metadata mode) and by listing; each rebuilds
the other's lost composite object from group parity. Maps are written as
stored bytes (``get_partition_writer``) unless a case says otherwise, so
the objects depend on no codec; a case with the TLZ codec holds the port's
checksum row, stitched from the fused encode CRCs, against the JAX
package's host hash of the same stored bytes. No test sleeps for seconds:
ages come from an injected clock, races from events.
"""

import io
import os
import random
import threading
import time

import numpy as np
import pytest

from s3shuffle_tpu.block_ids import ShuffleBlockId as JaxBlockId
from s3shuffle_tpu.block_ids import ShuffleCompositeDataBlockId as JaxCompositeDataBlockId
from s3shuffle_tpu.block_ids import ShuffleCompositeParityBlockId as JaxCompositeParityBlockId
from s3shuffle_tpu.block_ids import ShuffleFatIndexBlockId as JaxFatIndexBlockId
from s3shuffle_tpu.block_ids import ShuffleTombstoneBlockId as JaxTombstoneBlockId
from s3shuffle_tpu.block_ids import parse_composite_name as jax_parse_composite
from s3shuffle_tpu.block_ids import parse_shuffle_object_name as jax_parse_object
from s3shuffle_tpu.block_ids import parse_tombstone_name as jax_parse_tombstone
from s3shuffle_tpu.codec.framing import CodecOutputStream as JaxCodecOutputStream
from s3shuffle_tpu.codec.tpu import TpuCodec
from s3shuffle_tpu.coding.parity import ParityGeometry as JaxParityGeometry
from s3shuffle_tpu.config import ShuffleConfig as JaxConfig
from s3shuffle_tpu.metadata.fat_index import FatIndex as JaxFatIndex
from s3shuffle_tpu.metadata.fat_index import FatIndexMember as JaxFatIndexMember
from s3shuffle_tpu.metadata.helper import ScanIndexMemo as JaxMemo
from s3shuffle_tpu.metadata.helper import ShuffleHelper as JaxHelper
from s3shuffle_tpu.metadata.map_output import MapOutputTracker as JaxTracker
from s3shuffle_tpu.metadata.map_output import MapStatus as JaxMapStatus
from s3shuffle_tpu.read.chunked_fetch import ChunkedRangeFetcher as JaxFetcher
from s3shuffle_tpu.read.scan_plan import build_scan_iterator as jax_build_scan
from s3shuffle_tpu.storage.dispatcher import Dispatcher as JaxDispatcher
from s3shuffle_tpu.storage.fault import FaultRule as JaxFaultRule
from s3shuffle_tpu.storage.fault import FlakyBackend as JaxFlaky
from s3shuffle_tpu.storage.local import LocalBackend as JaxLocalBackend
from s3shuffle_tpu.write.compactor import compact_shuffle as jax_compact
from s3shuffle_tpu.write.composite_commit import CompositeCommitAggregator as JaxAggregator
from s3shuffle_tpu.write.map_output_writer import MapOutputWriter as JaxMapOutputWriter
from s3shuffle_tpu_torch import ShuffleConfig
from s3shuffle_tpu_torch.block_ids import (
    ShuffleCompositeDataBlockId,
    ShuffleCompositeParityBlockId,
    ShuffleDataBlockId,
    ShuffleFatIndexBlockId,
    ShuffleParityBlockId,
    ShuffleTombstoneBlockId,
    parse_composite_name,
    parse_index_name,
    parse_shuffle_object_name,
    parse_tombstone_name,
)
from s3shuffle_tpu_torch.coding.parity import ParityGeometry
from s3shuffle_tpu_torch.dependency import HashPartitioner, ShuffleDependency
from s3shuffle_tpu_torch.manager import ShuffleManager
from s3shuffle_tpu_torch.metadata.fat_index import FatIndex, FatIndexMember
from s3shuffle_tpu_torch.metadata.helper import ShuffleHelper
from s3shuffle_tpu_torch.metadata.map_output import STORE_LOCATION, MapOutputTracker, MapStatus
from s3shuffle_tpu_torch.read.reader import ShuffleReader
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
from s3shuffle_tpu_torch.storage.fault import FaultRule, FlakyBackend
from s3shuffle_tpu_torch.storage.local import LocalBackend
from s3shuffle_tpu_torch.write.compactor import compact_shuffle
from s3shuffle_tpu_torch.write.composite_commit import CompositeCommitAggregator
from s3shuffle_tpu_torch.write.map_output_writer import MapOutputWriter
from torch_jax_native import jax_native_library  # noqa: F401  (loads the JAX oracle's native library)
from torch_port_dispatcher import port_dispatcher_reset  # noqa: F401  (resets the port's process dispatcher)

#: a matrix of stored partition sizes: empty partitions, a map under one
#: parity chunk, a map over several
SIZES = [[200, 0, 77], [0, 10, 0], [64, 64, 64], [1, 2, 3], [500, 1, 0], [3000, 17, 900]]
CODED = {"k1m1": dict(parity_segments=1, parity_stripe_k=1, parity_chunk_bytes=512),
         "k2m2": dict(parity_segments=2, parity_stripe_k=2, parity_chunk_bytes=256)}


class _PortRecording(FlakyBackend):
    """The port's fault backend recording every (op, path) it sees."""

    def __init__(self, inner):
        super().__init__(inner)
        self.ops = []

    def _check(self, op, path, nbytes=0):
        self.ops.append((op, path))
        super()._check(op, path, nbytes=nbytes)


class _JaxRecording(JaxFlaky):
    def __init__(self, inner):
        super().__init__(inner)
        self.ops = []

    def _check(self, op, path, nbytes=0):
        self.ops.append((op, path))
        super()._check(op, path, nbytes=nbytes)


def _port_env(root, **knobs):
    # age seals off unless a case asks: group shapes must not follow the clock
    knobs.setdefault("composite_flush_ms", 0.0)
    cfg = ShuffleConfig(root_dir=f"file://{root}", **knobs)
    d = Dispatcher(cfg)
    return cfg, d, ShuffleHelper(d)


def _jax_env(root, **knobs):
    JaxDispatcher.reset()
    knobs.setdefault("composite_flush_ms", 0.0)
    cfg = JaxConfig(root_dir=f"file://{root}", speculative_read_quantile=0.0, **knobs)
    d = JaxDispatcher(cfg)
    return cfg, d, JaxHelper(d)


def _payload(seed, m, p, n):
    return random.Random(seed * 1000 + m * 31 + p).randbytes(n)


def _write_maps(jax, d, helper, agg, sid, sizes, seed=0, base_map=0):
    """``sizes[i][p]`` stored bytes per map, one thread, in map order;
    returns the commit messages."""
    messages = []
    for i, row in enumerate(sizes):
        m = base_map + i
        if jax:
            w = JaxMapOutputWriter(d, helper, sid, m, len(row), aggregator=agg)
        else:
            w = MapOutputWriter(d, helper, sid, m, len(row), codec=None, device="cpu",
                                aggregator=agg)
        for p, n in enumerate(row):
            pw = w.get_partition_writer(p)
            if n:
                pw.write(_payload(seed, m, p, n))
            pw.close()
        messages.append(w.commit_all_partitions())
    return messages


def _want(sizes, seed=0, base_map=0):
    return {(base_map + i, p): _payload(seed, base_map + i, p, n)
            for i, row in enumerate(sizes) for p, n in enumerate(row) if n}


def _port_read(d, helper, sid, sizes, base_map=0):
    """Every non-empty (map, partition) through the port's scan."""
    reader = ShuffleReader(d, helper, codec=None, device="cpu")
    got = {}
    for p in range(len(sizes[0])):
        for i, row in enumerate(sizes):
            if row[p]:
                m = base_map + i
                got[(m, p)] = reader.read_partition(sid, p, [m])
    return got, reader


def _jax_read(d, helper, cfg, sid, sizes, base_map=0):
    blocks = [JaxBlockId(sid, base_map + i, p) for i, row in enumerate(sizes)
              for p in range(len(row))]
    got = {}
    for s in jax_build_scan(d, JaxMemo(helper), blocks, cfg, fetcher=JaxFetcher.from_config(cfg)):
        data = s.readall()
        if data:
            got[(s.block.map_id, s.block.reduce_id)] = data
        s.close()
    return got


def _objects(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            with open(os.path.join(dirpath, fn), "rb") as f:
                out[os.path.relpath(os.path.join(dirpath, fn), root)] = f.read()
    return out


def _names(root):
    return sorted(os.path.basename(k) for k in _objects(root))


# --- fat index and names ---

_FAT_CASES = {
    "checksums": dict(checksums=True, parity=None, combined=False, split=0),
    "no-checksums": dict(checksums=False, parity=None, combined=False, split=0),
    "parity": dict(checksums=True, parity=(2, 2, 1024, 9), combined=False, split=0),
    "v3-combined-split": dict(checksums=True, parity=None, combined=True, split=4096),
}


@pytest.mark.parametrize("case", list(_FAT_CASES))
def test_fat_index_round_trip_and_bytes_equal_jax(case):
    c = _FAT_CASES[case]
    rows = [(10, 10, 0, [0, 5, 5, 9], [1, 2, 3]), (11, 11, 9, [0, 0, 4, 4], [4, 5, 6])]

    def build(fat_cls, member_cls, geom_cls):
        members = [member_cls(m, i, b, np.array(o, np.int64),
                              np.array(k, np.int64) if c["checksums"] else None,
                              combined=c["combined"] and m == 11)
                   for m, i, b, o, k in rows]
        geom = geom_cls(*c["parity"]) if c["parity"] else None
        return fat_cls(3, 10, 3, members, parity=geom, split_bytes=c["split"])

    mine = build(FatIndex, FatIndexMember, ParityGeometry)
    theirs = build(JaxFatIndex, JaxFatIndexMember, JaxParityGeometry)
    assert mine.to_bytes() == theirs.to_bytes()
    back = FatIndex.from_bytes(theirs.to_bytes())
    assert back.to_bytes() == mine.to_bytes()
    assert (back.shuffle_id, back.group_id, back.has_checksums) == (3, 10, c["checksums"])
    assert back.member(11).base_offset == 9 and list(back.member(11).offsets) == [0, 0, 4, 4]
    assert back.member(11).combined == c["combined"] and back.split_bytes == c["split"]
    if c["parity"]:
        assert back.parity == ParityGeometry(*c["parity"])
    with pytest.raises(FileNotFoundError):
        back.member(99)


@pytest.mark.parametrize("blob", [b"short", b"\x00" * 56, b"\x00" * 60])
def test_fat_index_rejects_what_jax_rejects(blob):
    with pytest.raises(ValueError):
        FatIndex.from_bytes(blob)
    with pytest.raises(ValueError):
        JaxFatIndex.from_bytes(blob)


_NAMES = [
    "shuffle_4_comp_9.data", "shuffle_4_comp_9.cindex", "shuffle_4_comp_9_par1.parity",
    "x/y/shuffle_4_comp_9.cindex", "shuffle_3_17_par0.parity", "shuffle_3_17_0.data",
    "shuffle_3_17_0.index", "shuffle_3_17_0.checksum.CRC32C", "shuffle_2_gen_123.tomb",
    "shuffle_2_snapshot_1.snapmeta", "shuffle_2_comp_x.data", "other.bin",
]


@pytest.mark.parametrize("name", _NAMES)
def test_name_parsers_equal_jax(name):
    assert parse_composite_name(name) == jax_parse_composite(name)
    assert parse_shuffle_object_name(name) == jax_parse_object(name)
    assert parse_tombstone_name(name) == jax_parse_tombstone(name)
    assert (parse_index_name(name) is None) == (not name.endswith(".index"))


@pytest.mark.parametrize("pair", [
    (ShuffleCompositeDataBlockId(4, 9), JaxCompositeDataBlockId(4, 9)),
    (ShuffleFatIndexBlockId(4, 9), JaxFatIndexBlockId(4, 9)),
    (ShuffleCompositeParityBlockId(4, 9, 1), JaxCompositeParityBlockId(4, 9, 1)),
    (ShuffleTombstoneBlockId(4, 123456), JaxTombstoneBlockId(4, 123456)),
], ids=["data", "cindex", "parity", "tomb"])
def test_composite_paths_equal_jax(tmp_path, pair):
    mine, theirs = pair
    assert mine.name == theirs.name and mine.map_id == theirs.map_id
    _c, d, _h = _port_env(tmp_path, folder_prefixes=7)
    _jc, jd, _jh = _jax_env(tmp_path, folder_prefixes=7)
    assert d.get_path(mine) == jd.get_path(theirs)


# --- the aggregator's seals ---

def test_group_seals_at_member_count_and_assigns_bases(tmp_path):
    cfg, d, helper = _port_env(tmp_path, composite_commit_maps=3)
    sealed = []
    agg = CompositeCommitAggregator(d, helper, device="cpu",
                                    on_group_commit=lambda sid, ms: sealed.append((sid, ms)))
    sizes = [[50, 60]] * 7
    messages = _write_maps(False, d, helper, agg, 0, sizes)
    assert [len(ms) for _sid, ms in sealed] == [3, 3]
    assert len(agg.pending_members(0)) == 1
    assert [m.group_id for m in sealed[0][1]] == [0, 0, 0]
    assert [m.base_offset for m in sealed[0][1]] == [0, 110, 220]
    assert [msg.composite_group for msg in messages] == [0, 0, 0, 3, 3, 3, 6]
    assert all(msg.deferred for msg in messages)
    agg.flush_all()
    assert len(sealed) == 3 and agg.pending_members(0) == []
    assert _port_read(d, helper, 0, sizes)[0] == _want(sizes)


def test_group_seals_at_byte_threshold_and_injected_age(tmp_path):
    cfg, d, helper = _port_env(tmp_path, composite_commit_maps=100, composite_flush_bytes=1000,
                               composite_flush_ms=60_000.0)
    sealed = []
    agg = CompositeCommitAggregator(d, helper, device="cpu",
                                    on_group_commit=lambda sid, ms: sealed.append(len(ms)))
    _write_maps(False, d, helper, agg, 0, [[600], [600]])  # 1200 >= 1000 at map 1
    assert sealed == [2]
    _write_maps(False, d, helper, agg, 0, [[10]], seed=9, base_map=2)
    assert agg.maybe_flush_stale(now=time.monotonic() + 1.0) == 0
    assert agg.maybe_flush_stale(now=time.monotonic() + 120.0) == 1
    assert sealed == [2, 1]


def test_group_ids_never_collide_across_attempt_unique_map_ids(tmp_path):
    cfg, d, helper = _port_env(tmp_path, composite_commit_maps=2)
    agg = CompositeCommitAggregator(d, helper, device="cpu")
    for m in (1000, 2000, 3000):
        w = MapOutputWriter(d, helper, 5, m, 1, codec=None, device="cpu", aggregator=agg)
        pw = w.get_partition_writer(0)
        pw.write(b"x" * 8)
        pw.close()
        w.commit_all_partitions()
    agg.flush_all()
    assert d.list_composite_groups(5) == [1000, 3000]


# --- the knob off, op for op ---

@pytest.mark.parametrize("knob", [0, 1])
def test_knob_off_reproduces_the_per_map_op_sequence(tmp_path, knob):
    """``composite_commit_maps`` 0 or 1: an aggregator changes no store op
    of the port's per-map writer (the parent's layout), and the sequence is
    the JAX package's op for op."""
    sizes = [[100, 0, 50], [0, 30, 60]]

    def port(tag, with_agg):
        _c, d, h = _port_env(tmp_path / tag, composite_commit_maps=knob)
        d.backend = rec = _PortRecording(LocalBackend())
        agg = CompositeCommitAggregator(d, h, device="cpu") if with_agg else None
        _write_maps(False, d, h, agg, 0, sizes)
        return [(op, p.rsplit("/", 1)[-1]) for op, p in rec.ops]

    _jc, jd, jh = _jax_env(tmp_path / "jax", composite_commit_maps=knob)
    jd.backend = jrec = _JaxRecording(JaxLocalBackend())
    _write_maps(True, jd, jh, JaxAggregator(jd, jh), 0, sizes)
    jax_ops = [(op, p.rsplit("/", 1)[-1]) for op, p in jrec.ops]
    legacy = port("legacy", False)
    assert port("knob", True) == legacy == jax_ops
    assert ("create", "shuffle_0_0_0.index") in legacy


# --- layout parity with the JAX package ---

@pytest.mark.parametrize("variant", ["adler32", "crc32c", "k1m1", "k2m2"])
def test_composite_objects_byte_equal_to_jax(tmp_path, variant):
    knobs = dict(composite_commit_maps=4, checksum_algorithm="CRC32C" if variant != "adler32"
                 else "ADLER32", **CODED.get(variant, {}))
    _c, d, h = _port_env(tmp_path / "port", **knobs)
    agg = CompositeCommitAggregator(d, h, device="cpu")
    _write_maps(False, d, h, agg, 0, SIZES)
    agg.flush_all()
    _jc, jd, jh = _jax_env(tmp_path / "jax", **knobs)
    jagg = JaxAggregator(jd, jh)
    _write_maps(True, jd, jh, jagg, 0, SIZES)
    jagg.flush_all()
    mine, theirs = _objects(tmp_path / "port"), _objects(tmp_path / "jax")
    assert sorted(mine) == sorted(theirs)
    for key in mine:
        assert mine[key] == theirs[key], key
    names = _names(tmp_path / "port")
    assert "shuffle_0_comp_0.cindex" in names and "shuffle_0_comp_4.cindex" in names
    assert not any(n.endswith(".index") or ".checksum." in n for n in names)
    if variant in CODED:
        assert "shuffle_0_comp_0_par0.parity" in names
        fat = h.read_fat_index(0, 0)
        assert fat.parity is not None and fat.parity.payload_len == sum(map(sum, SIZES[:4]))


@pytest.mark.parametrize("mode", ["metadata", "listing"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_composite_shuffle(tmp_path, writer, mode):
    """Metadata mode: hints from the writer's registration coordinates
    (the commit messages); listing mode: a fresh helper finds the groups by
    listing their fat indexes (the composite knob is on)."""
    knobs = dict(composite_commit_maps=3, checksum_algorithm="CRC32C")
    if writer == "port":
        _c, d, h = _port_env(tmp_path, **knobs)
        agg = CompositeCommitAggregator(d, h, device="cpu")
    else:
        _c, d, h = _jax_env(tmp_path, **knobs)
        agg = JaxAggregator(d, h)
    messages = _write_maps(writer == "jax", d, h, agg, 0, SIZES)
    agg.flush_all()
    coords = [(m, msg.composite_group, msg.base_offset) for m, msg in enumerate(messages)]
    assert [g for _m, g, _b in coords] == [0, 0, 0, 3, 3, 3]
    want = _want(SIZES)
    read_knobs = knobs if mode == "listing" else dict(checksum_algorithm="CRC32C")
    for reader in ("port", "jax"):
        env = _port_env if reader == "port" else _jax_env
        cfg, rd, rh = env(tmp_path, **read_knobs)
        if mode == "metadata":
            for m, g, b in coords:
                rh.note_composite_location(0, m, g, b)
        got = _port_read(rd, rh, 0, SIZES)[0] if reader == "port" else \
            _jax_read(rd, rh, cfg, 0, SIZES)
        assert got == want, reader
        assert [int(x) for x in rh.get_checksums(0, 5)] == \
            [int(x) for x in h.get_checksums(0, 5)]


def test_fresh_helper_with_the_plane_off_finds_no_composite(tmp_path):
    """Discovery is gated as in the JAX package: with both knobs off and no
    hint, a missing per-map index raises without listing the store."""
    _c, d, h = _port_env(tmp_path, composite_commit_maps=2)
    agg = CompositeCommitAggregator(d, h, device="cpu")
    _write_maps(False, d, h, agg, 0, [[10], [20]])
    agg.flush_all()
    _c, d2, h2 = _port_env(tmp_path)
    d2.backend = rec = _PortRecording(d2.backend)
    with pytest.raises(FileNotFoundError, match="composite"):
        h2.resolve_map_location(0, 0)
    ops = [op for op, _p in rec.ops]
    assert ops and "list" not in ops


def test_fused_checksum_row_equals_the_jax_host_hash(tmp_path):
    """The port's member checksums come from the CRCs fused into the TLZ
    encode (``get_encoding_partition_writer``); the JAX package hashes the
    same stored bytes on the host. The fat indexes are equal word for
    word."""
    bs, batch = 2048, 4
    knobs = dict(composite_commit_maps=3, checksum_algorithm="CRC32C",
                 codec_block_size=bs, codec_batch_blocks=batch)
    rows = [[bs * 3 + 17, 0, 900], [bs * 2, 5, bs + 1], [777, bs * 4, 3]]
    data = {(m, p): (np.random.default_rng(m * 7 + p).integers(0, 8, n, dtype=np.uint8)
                     .tobytes()) for m, row in enumerate(rows) for p, n in enumerate(row)}
    _c, d, h = _port_env(tmp_path / "port", **knobs)
    agg = CompositeCommitAggregator(d, h, device="cpu")
    for m, row in enumerate(rows):
        w = MapOutputWriter(d, h, 0, m, len(row), device="cpu", aggregator=agg)
        for p in range(len(row)):
            pw = w.get_encoding_partition_writer(p)
            pw.write(data[(m, p)])
            pw.close()
        w.commit_all_partitions()
    agg.flush_all()
    _jc, jd, jh = _jax_env(tmp_path / "jax", codec="tpu", **knobs)
    codec = TpuCodec(block_size=bs, batch_blocks=batch, use_device=True)
    jagg = JaxAggregator(jd, jh)
    for m, row in enumerate(rows):
        w = JaxMapOutputWriter(jd, jh, 0, m, len(row), aggregator=jagg)
        for p in range(len(row)):
            sink = io.BytesIO()
            stream = JaxCodecOutputStream(codec, sink, close_sink=False)
            stream.write(data[(m, p)])
            stream.close()
            pw = w.get_partition_writer(p)  # the host hash of the stored bytes
            pw.write(sink.getvalue())
            pw.close()
        w.commit_all_partitions()
    jagg.flush_all()
    mine, theirs = _objects(tmp_path / "port"), _objects(tmp_path / "jax")
    assert sorted(mine) == sorted(theirs)
    for key in mine:
        assert mine[key] == theirs[key], key
    assert h.read_fat_index(0, 0).has_checksums


# --- empty and aborted maps ---

@pytest.mark.parametrize("visible", [False, True], ids=["no-index", "always-create-index"])
def test_empty_map_claims_no_slot_and_no_store_ops(tmp_path, visible):
    _c, d, h = _port_env(tmp_path, composite_commit_maps=4, always_create_index=visible)
    d.backend = rec = _PortRecording(LocalBackend())
    agg = CompositeCommitAggregator(d, h, device="cpu")
    w = MapOutputWriter(d, h, 0, 0, 3, codec=None, device="cpu", aggregator=agg)
    for p in range(3):
        w.get_partition_writer(p).close()
    msg = w.commit_all_partitions()
    assert rec.ops == []
    assert msg.deferred == visible and len(agg.pending_members(0)) == int(visible)
    agg.flush_all()
    if visible:
        assert h.read_fat_index(0, 0).member(0).total_bytes == 0
        assert [op for op, _p in rec.ops if op == "create"] == ["create"]  # the .cindex


def test_aborted_composite_map_triggers_no_store_ops(tmp_path):
    _c, d, h = _port_env(tmp_path, composite_commit_maps=4)
    d.backend = rec = _PortRecording(LocalBackend())
    agg = CompositeCommitAggregator(d, h, device="cpu")
    w = MapOutputWriter(d, h, 0, 0, 2, codec=None, device="cpu", aggregator=agg)
    pw = w.get_partition_writer(0)
    pw.write(b"y" * 128)
    pw.close()
    w.abort(RuntimeError("boom"))
    assert rec.ops == [] and agg.pending_members(0) == []


# --- registration, failed seals, isolation ---

def _records(n, seed):
    rng = random.Random(seed)
    return [(rng.randbytes(8), rng.randbytes(16)) for _ in range(n)]


def test_registration_defers_to_the_group_seal_and_carries_coordinates(tmp_path):
    mgr = ShuffleManager(ShuffleConfig(root_dir=f"file://{tmp_path}", composite_commit_maps=3,
                                       composite_flush_ms=0.0, codec="none"), device="cpu")
    handle = mgr.register_shuffle(0, ShuffleDependency(0, HashPartitioner(2)))
    records = _records(300, 0)
    for m in range(2):
        w = mgr.get_writer(handle, m)
        w.write(records[m::2])
        w.stop(success=True)
    assert mgr.tracker.get_map_sizes_by_range(0, 0, None, 0, 2) == []
    w = mgr.get_writer(handle, 2)
    w.write([])
    reader = mgr.get_reader(handle, 0, 2)  # the barrier seals the open group
    assert sorted(m for m, _s in mgr.tracker.get_map_sizes_by_range(0, 0, None, 0, 2)) == [0, 1]
    assert [(m, g) for m, g, _b in mgr.tracker.composite_locations(0)] == [(0, 0), (1, 0)]
    assert mgr.tracker.epoch(0) == 2
    assert sorted(records) == sorted(reader.read())
    w.stop(success=True)
    mgr.stop()


def test_failed_seal_aborts_members_and_drops_the_composite(tmp_path):
    _c, d, h = _port_env(tmp_path, composite_commit_maps=8, storage_retries=0)
    aborted = []
    agg = CompositeCommitAggregator(
        d, h, device="cpu",
        on_group_abort=lambda sid, ms, e: aborted.append((sid, [m.map_id for m in ms])))
    _write_maps(False, d, h, agg, 0, [[100], [100]])
    d.backend = FlakyBackend(d.backend, rules=[FaultRule("create", match=".cindex", exc=IOError)])
    with pytest.raises(IOError):
        agg.flush_all()
    assert aborted == [(0, [0, 1])]
    assert d.list_composite_groups(0) == [] and _names(tmp_path) == []
    with pytest.raises(FileNotFoundError):
        h.resolve_map_location(0, 0)


def test_manager_poisons_reads_after_a_mid_stage_seal_failure(tmp_path):
    mgr = ShuffleManager(ShuffleConfig(root_dir=f"file://{tmp_path}", composite_commit_maps=2,
                                       composite_flush_ms=0.0, storage_retries=0, codec="none"),
                         device="cpu")
    handle = mgr.register_shuffle(0, ShuffleDependency(0, HashPartitioner(1)))
    w = mgr.get_writer(handle, 0)
    w.write([(b"k", b"v")])
    w.stop(success=True)
    mgr.dispatcher.backend = FlakyBackend(
        mgr.dispatcher.backend, rules=[FaultRule("create", match=".cindex", exc=IOError)])
    w2 = mgr.get_writer(handle, 1)
    w2.write([(b"k2", b"v2")])
    with pytest.raises(IOError):
        w2.stop(success=True)
    with pytest.raises(RuntimeError, match="lost composite-committed"):
        mgr.get_reader(handle, 0, 1)
    mgr.unregister_shuffle(0)
    assert 0 not in mgr._failed_composite


def test_flush_all_isolates_group_failures(tmp_path):
    _c, d, h = _port_env(tmp_path, composite_commit_maps=8, storage_retries=0)
    events = []
    agg = CompositeCommitAggregator(
        d, h, device="cpu",
        on_group_commit=lambda sid, ms: events.append(("commit", sid)),
        on_group_abort=lambda sid, ms, e: events.append(("abort", sid)))
    _write_maps(False, d, h, agg, 0, [[64]])
    _write_maps(False, d, h, agg, 1, [[64]])
    d.backend = FlakyBackend(d.backend,
                             rules=[FaultRule("create", match="shuffle_0_comp", exc=IOError)])
    with pytest.raises(IOError):
        agg.flush_all()
    assert sorted(events) == [("abort", 0), ("commit", 1)]
    assert d.list_composite_groups(1) == [0]
    assert h.resolve_map_location(1, 0).data_block == ShuffleCompositeDataBlockId(1, 0)


def test_unregister_drops_the_open_group_unsealed(tmp_path):
    mgr = ShuffleManager(ShuffleConfig(root_dir=f"file://{tmp_path}", composite_commit_maps=4,
                                       composite_flush_ms=0.0, codec="none", cleanup=False),
                         device="cpu")
    handle = mgr.register_shuffle(0, ShuffleDependency(0, HashPartitioner(2)))
    w = mgr.get_writer(handle, 0)
    w.write(_records(50, 1))
    w.stop(success=True)
    assert len(mgr.composite.pending_members(0)) == 1
    mgr.unregister_shuffle(0)
    assert mgr.composite.pending_members(0) == [] and _names(tmp_path) == []


# --- the seal barrier (the JAX record-loss races) ---

def test_flush_shuffle_waits_for_an_inflight_seal(tmp_path):
    _c, d, h = _port_env(tmp_path, composite_commit_maps=2)
    registered = []
    release = threading.Event()

    def slow_commit(sid, members):
        release.wait(timeout=5.0)
        registered.extend(members)

    agg = CompositeCommitAggregator(d, h, device="cpu", on_group_commit=slow_commit)
    sealer = threading.Thread(target=lambda: _write_maps(False, d, h, agg, 0, [[128], [128]]))
    sealer.start()
    deadline = time.monotonic() + 5.0
    while not agg._sealing and time.monotonic() < deadline:
        time.sleep(0.005)
    assert agg._sealing, "seal never started"
    flushed = threading.Event()
    flusher = threading.Thread(target=lambda: (agg.flush_shuffle(0), flushed.set()))
    flusher.start()
    time.sleep(0.05)
    assert not flushed.is_set() and not registered
    release.set()
    flusher.join(timeout=5.0)
    sealer.join(timeout=5.0)
    assert flushed.is_set() and len(registered) == 2


def test_flush_shuffle_covers_the_pop_to_detach_gap(tmp_path):
    _c, d, h = _port_env(tmp_path, composite_commit_maps=4)
    registered = []
    agg = CompositeCommitAggregator(d, h, device="cpu",
                                    on_group_commit=lambda sid, ms: registered.extend(ms))
    _write_maps(False, d, h, agg, 0, [[96]])
    group = agg._groups[0]
    group.lock.acquire()  # a slow in-flight append holds the group lock
    try:
        a = threading.Thread(target=lambda: agg.flush_shuffle(0))
        a.start()
        deadline = time.monotonic() + 5.0
        while 0 in agg._groups and time.monotonic() < deadline:
            time.sleep(0.005)
        assert 0 not in agg._groups, "flusher A never popped the group"
        b_done = threading.Event()
        b = threading.Thread(target=lambda: (agg.flush_shuffle(0), b_done.set()))
        b.start()
        time.sleep(0.05)
        assert not b_done.is_set() and not registered
    finally:
        group.lock.release()
    a.join(timeout=5.0)
    b.join(timeout=5.0)
    assert b_done.is_set() and len(registered) == 1


def test_get_reader_waits_for_a_seal_on_another_thread(tmp_path):
    """The manager's barrier: a task thread's commit trips the count seal
    while its registration is slow; ``get_reader`` on another thread must
    not return before the members are registered, and its reader sees
    every record."""
    mgr = ShuffleManager(ShuffleConfig(root_dir=f"file://{tmp_path}", composite_commit_maps=2,
                                       composite_flush_ms=0.0, codec="none"), device="cpu")
    handle = mgr.register_shuffle(0, ShuffleDependency(0, HashPartitioner(2)))
    release = threading.Event()
    register = mgr.composite.on_group_commit

    def slow_register(sid, members):
        release.wait(timeout=5.0)
        register(sid, members)

    mgr.composite.on_group_commit = slow_register
    records = _records(200, 3)
    w = mgr.get_writer(handle, 0)
    w.write(records[:100])
    w.stop(success=True)

    def second_map():
        w2 = mgr.get_writer(handle, 1)
        w2.write(records[100:])
        w2.stop(success=True)  # the count seal, blocked in registration

    sealer = threading.Thread(target=second_map)
    sealer.start()
    deadline = time.monotonic() + 5.0
    while not mgr.composite._sealing and time.monotonic() < deadline:
        time.sleep(0.005)
    assert mgr.composite._sealing, "seal never started"
    out = {}
    got = threading.Event()
    reader_thread = threading.Thread(
        target=lambda: (out.setdefault("r", mgr.get_reader(handle, 0, 2)), got.set()))
    reader_thread.start()
    time.sleep(0.05)
    assert not got.is_set()
    assert mgr.tracker.get_map_sizes_by_range(0, 0, None, 0, 2) == []
    release.set()
    reader_thread.join(timeout=5.0)
    sealer.join(timeout=5.0)
    assert got.is_set()
    assert sorted(out["r"].read()) == sorted(records)
    mgr.stop()


# --- composite parity: loss rebuilt across packages ---

@pytest.mark.parametrize("reader", ["port", "jax"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_composite_loss_rebuilt_from_the_others_group_parity(tmp_path, writer, reader):
    knobs = dict(composite_commit_maps=3, checksum_algorithm="CRC32C", **CODED["k2m2"])
    if writer == "port":
        _c, d, h = _port_env(tmp_path, **knobs)
        agg = CompositeCommitAggregator(d, h, device="cpu")
    else:
        _c, d, h = _jax_env(tmp_path, **knobs)
        agg = JaxAggregator(d, h)
    _write_maps(writer == "jax", d, h, agg, 0, SIZES)
    agg.flush_all()
    os.remove(d.get_path(ShuffleCompositeDataBlockId(0, 3)).replace("file://", ""))
    if reader == "port":
        _c, rd, rh = _port_env(tmp_path, **knobs)
        got, port_reader = _port_read(rd, rh, 0, SIZES)
        assert port_reader.reconstructions >= 1
    else:
        cfg, rd, rh = _jax_env(tmp_path, **knobs)
        got = _jax_read(rd, rh, cfg, 0, SIZES)
    assert got == _want(SIZES)


def test_composite_geometry_reaches_the_degraded_reader(tmp_path):
    knobs = dict(composite_commit_maps=3, **CODED["k1m1"])
    _c, d, h = _port_env(tmp_path, **knobs)
    agg = CompositeCommitAggregator(d, h, device="cpu")
    _write_maps(False, d, h, agg, 0, SIZES[:3])
    agg.flush_all()
    offsets, geometry = ShuffleHelper(d).get_index(0, 1)
    assert geometry == ParityGeometry(1, 1, 512, sum(map(sum, SIZES[:3])))
    assert int(offsets[0]) == sum(SIZES[0])


# --- compaction and the generation sweep ---

def _tracker_with(sizes, cls=MapOutputTracker, status=MapStatus, parity=0):
    tracker = cls()
    tracker.register_shuffle(0, len(sizes[0]))
    for m, row in enumerate(sizes):
        tracker.register_map_output(0, status(map_id=m, location=STORE_LOCATION,
                                              sizes=np.array(row, dtype=np.int64),
                                              parity_segments=parity))
    return tracker


def test_compactor_rewrites_tombstones_and_the_ttl_sweep_reclaims(tmp_path):
    sizes = [[100, 120], [90, 80], [70, 60], [50, 40]]
    cfg, d, h = _port_env(tmp_path / "port", compact_below_bytes=4096)
    _write_maps(False, d, h, None, 0, sizes)
    tracker = _tracker_with(sizes)
    report = compact_shuffle(d, h, 0, tracker=tracker)
    assert (report.groups, report.maps, report.tombstoned) == (1, 4, 12)
    assert [(m, g) for m, g, _b in tracker.composite_locations(0)] == [(0, 0), (1, 0), (2, 0),
                                                                       (3, 0)]
    assert d.backend.status(d.get_path(ShuffleDataBlockId(0, 0))).size > 0  # still live
    assert _port_read(d, h, 0, sizes)[0] == _want(sizes)
    # the JAX compactor on the JAX package's singletons writes the same group
    _jc, jd, jh = _jax_env(tmp_path / "jax", compact_below_bytes=4096)
    _write_maps(True, jd, jh, None, 0, sizes)
    jax_compact(jd, jh, 0, tracker=_tracker_with(sizes, JaxTracker, JaxMapStatus))
    mine, theirs = _objects(tmp_path / "port"), _objects(tmp_path / "jax")
    comp = [k for k in mine if "_comp_" in k]
    assert len(comp) == 2 and all(mine[k] == theirs[k] for k in comp)
    removed = d.sweep_expired_generations(0, ttl_s=0)
    assert len(removed) == 12 + 1
    assert sorted(_names(tmp_path / "port")) == ["shuffle_0_comp_0.cindex", "shuffle_0_comp_0.data"]
    _c, d2, fresh = _port_env(tmp_path / "port", compact_below_bytes=4096)
    assert _port_read(d2, fresh, 0, sizes)[0] == _want(sizes)
    assert d.sweep_expired_generations(0, ttl_s=0) == []


def test_ttl_keeps_young_generations(tmp_path):
    sizes = [[100], [90]]
    _c, d, h = _port_env(tmp_path, compact_below_bytes=4096, tombstone_ttl_s=3600.0)
    _write_maps(False, d, h, None, 0, sizes)
    assert compact_shuffle(d, h, 0).groups == 1
    assert d.sweep_expired_generations(0) == []
    assert len(d.sweep_expired_generations(0, ttl_s=0)) == 3 * 2 + 1


def test_compaction_rerun_is_a_no_op_and_never_mutates_live_composites(tmp_path):
    sizes = [[100, 120], [90, 80], [70, 60]]
    _c, d, h = _port_env(tmp_path, compact_below_bytes=4096)
    _write_maps(False, d, h, None, 0, sizes)
    assert compact_shuffle(d, h, 0).groups == 1
    comp_path = d.get_path(ShuffleCompositeDataBlockId(0, 0))
    before = d.backend.read_all(comp_path)
    second = compact_shuffle(d, h, 0, below_bytes=1 << 30)
    assert second.groups == 0 and second.tombstoned == 0
    assert d.backend.read_all(comp_path) == before
    assert _port_read(d, h, 0, sizes)[0] == _want(sizes)


@pytest.mark.parametrize("chunk_bytes", [2000, 4096])
def test_compactor_strips_the_geometry_trailer_of_coded_singletons(tmp_path, chunk_bytes):
    sizes = [[1000, 1000], [900, 1100], [1024, 976], [800, 1200]]
    _c, d, h = _port_env(tmp_path, parity_segments=1, parity_stripe_k=1,
                         parity_chunk_bytes=chunk_bytes, compact_below_bytes=1 << 20)
    _write_maps(False, d, h, None, 0, sizes)
    report = compact_shuffle(d, h, 0, tracker=_tracker_with(sizes, parity=1))
    assert (report.groups, report.maps, report.tombstoned) == (1, 4, 16)
    d.sweep_expired_generations(0, ttl_s=0)
    assert not [n for n in _names(tmp_path) if n.endswith(".parity")]
    _c, d2, fresh = _port_env(tmp_path, compact_below_bytes=1 << 20)
    assert _port_read(d2, fresh, 0, sizes)[0] == _want(sizes)


# --- the orphan sweep ---

def test_orphan_sweep_classifies_composites(tmp_path):
    _c, d, h = _port_env(tmp_path, composite_commit_maps=2)
    agg = CompositeCommitAggregator(d, h, device="cpu")
    _write_maps(False, d, h, agg, 0, [[10], [20]])
    _write_maps(False, d, h, agg, 0, [[30], [40]], seed=1, base_map=2)
    agg.flush_all()
    assert len(d.list_composite_groups(0)) == 2
    with d.backend.create(d.get_path(ShuffleCompositeDataBlockId(0, 999))) as s:
        s.write(b"torn")
    removed = d.sweep_orphan_attempts(0, winner_map_ids=[0, 1])
    assert sorted(p.rsplit("/", 1)[-1] for p in removed) == [
        "shuffle_0_comp_2.cindex", "shuffle_0_comp_2.data", "shuffle_0_comp_999.data"]
    assert h.resolve_map_location(0, 0).data_block == ShuffleCompositeDataBlockId(0, 0)


def test_orphan_sweep_keeps_mixed_groups(tmp_path):
    _c, d, h = _port_env(tmp_path, composite_commit_maps=2)
    agg = CompositeCommitAggregator(d, h, device="cpu")
    _write_maps(False, d, h, agg, 0, [[10], [20]])
    agg.flush_all()
    assert d.sweep_orphan_attempts(0, winner_map_ids=[0]) == []
    assert h.resolve_map_location(0, 0).data_block == ShuffleCompositeDataBlockId(0, 0)


def test_orphan_sweep_reclaims_dead_attempt_parity_and_uncommitted_composite_parity(tmp_path):
    _c, d, h = _port_env(tmp_path, composite_commit_maps=0, parity_segments=1,
                         parity_stripe_k=1, parity_chunk_bytes=1024)
    _write_maps(False, d, h, None, 0, [[1500, 700]], seed=3)
    for block in (ShuffleDataBlockId(0, 1000), ShuffleParityBlockId(0, 1000, 0),
                  ShuffleCompositeDataBlockId(0, 5), ShuffleCompositeParityBlockId(0, 5, 0)):
        with d.backend.create(d.get_path(block)) as s:
            s.write(b"x" * 64)
    removed = d.sweep_orphan_attempts(0, winner_map_ids=[0])
    assert {p.rsplit("/", 1)[-1] for p in removed} == {
        "shuffle_0_1000_0.data", "shuffle_0_1000_par0.parity",
        "shuffle_0_comp_5.data", "shuffle_0_comp_5_par0.parity"}
    d.backend.status(d.get_path(ShuffleParityBlockId(0, 0, 0)))


@pytest.mark.parametrize("package", ["port", "jax"])
def test_orphan_sweep_reclaims_what_a_failed_commit_left(tmp_path, package):
    """At ``storage_retries=0`` an index create fault fails map 1's commit
    after its checksum sidecar landed (the JAX abort leaves it, and so does
    the port's); the sweep with the registered winners removes exactly that
    sidecar and the aborted map's nothing else, in both packages."""
    jax = package == "jax"
    env = _jax_env if jax else _port_env
    _c, d, h = env(tmp_path, storage_retries=0, checksum_algorithm="CRC32C")
    _write_maps(jax, d, h, None, 0, [[100, 50]])
    flaky = (JaxFlaky if jax else FlakyBackend)
    rule = (JaxFaultRule if jax else FaultRule)("create", match="_1_0.index", exc=IOError)
    d.backend = flaky(d.backend, rules=[rule])
    cls = JaxMapOutputWriter if jax else MapOutputWriter
    kwargs = {} if jax else dict(codec=None, device="cpu")
    w = cls(d, h, 0, 1, 2, **kwargs)
    pw = w.get_partition_writer(0)
    pw.write(b"z" * 300)
    pw.close()
    w.get_partition_writer(1).close()
    with pytest.raises(IOError):
        w.commit_all_partitions()
    w.abort()
    assert "shuffle_0_1_0.checksum.CRC32C" in _names(tmp_path)
    removed = d.sweep_orphan_attempts(0, winner_map_ids=[0])
    assert [p.rsplit("/", 1)[-1] for p in removed] == ["shuffle_0_1_0.checksum.CRC32C"]
    assert _names(tmp_path) == ["shuffle_0_0_0.checksum.CRC32C", "shuffle_0_0_0.data",
                                "shuffle_0_0_0.index"]


# --- record shuffles through the entry points ---

REC_MAPS, REC_PARTS, REC_BS, REC_BATCH = 4, 3, 2048, 4


def _terasort_batches(cls, n=300, seed=11):
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (16, 90), dtype=np.uint8)
    out = []
    for _ in range(REC_MAPS):
        keys = rng.integers(0, 256, (n, 10), dtype=np.uint8).reshape(-1)
        vals = pool[rng.integers(0, 16, n)].reshape(-1)
        out.append(cls(np.full(n, 10, np.int32), np.full(n, 90, np.int32), keys, vals))
    return out


def _rows_of(batches):
    return sorted(bytes(b.keys[i * 10:(i + 1) * 10]) + bytes(b.values[i * 90:(i + 1) * 90])
                  for b in batches for i in range(b.n))


def _record_knobs(**extra):
    return dict(checksum_algorithm="CRC32C", codec_block_size=REC_BS,
                codec_batch_blocks=REC_BATCH, cleanup=False, composite_flush_ms=0.0, **extra)


def _read_records(root, jax, mode):
    """Every row of shuffle 0 through a fresh manager of either package:
    metadata mode registers each member with the coordinates its fat index
    holds (the composite knob on, so the reader seeds its hints), listing
    mode enumerates by listing."""
    from s3shuffle_tpu.batch import RecordBatch as JaxRecordBatch
    from s3shuffle_tpu.dependency import HashPartitioner as JaxHashPartitioner
    from s3shuffle_tpu.dependency import ShuffleDependency as JaxDependency
    from s3shuffle_tpu.manager import ShuffleManager as JaxManager
    from s3shuffle_tpu.serializer import ColumnarKVSerializer as JaxColumnarKV
    from s3shuffle_tpu_torch.batch import RecordBatch
    from s3shuffle_tpu_torch.serializer import ColumnarKVSerializer

    knobs = _record_knobs(composite_commit_maps=2, use_block_manager=mode == "metadata")
    if jax:
        JaxDispatcher.reset()
        mgr = JaxManager(JaxConfig(root_dir=f"file://{root}", codec="tpu", tpu_host_fallback=False,
                                   speculative_read_quantile=0.0, **knobs))
        dep = JaxDependency(0, JaxHashPartitioner(REC_PARTS), serializer=JaxColumnarKV())
        status, concat = JaxMapStatus, JaxRecordBatch.concat
    else:
        mgr = ShuffleManager(ShuffleConfig(root_dir=f"file://{root}", **knobs), device="cpu")
        dep = ShuffleDependency(0, HashPartitioner(REC_PARTS), serializer=ColumnarKVSerializer())
        status, concat = MapStatus, RecordBatch.concat
    handle = mgr.register_shuffle(0, dep)
    if mode == "metadata":
        for g in mgr.dispatcher.list_composite_groups(0):
            for m in mgr.helper.read_fat_index(0, g).members.values():
                mgr.tracker.register_map_output(0, status(
                    map_id=m.map_id, location=STORE_LOCATION, sizes=np.diff(m.offsets),
                    composite_group=g, base_offset=m.base_offset))
    batch = concat(list(mgr.get_reader(handle, 0, REC_PARTS).read_batches()))
    return sorted(k + v for k, v in batch.iter_records())


@pytest.mark.parametrize("mode", ["metadata", "listing"])
def test_a_port_composite_sort_is_read_by_both_packages(tmp_path, mode):
    """TeraSort rows through the port's ``ShuffleContext`` with composites
    on (two task threads: the commit order, and so the group layout, varies
    from run to run; rows are compared, never objects)."""
    from s3shuffle_tpu_torch import ShuffleContext
    from s3shuffle_tpu_torch.batch import RecordBatch
    from s3shuffle_tpu_torch.serializer import ColumnarKVSerializer

    inputs = _terasort_batches(RecordBatch)
    ctx = ShuffleContext(ShuffleConfig(root_dir=f"file://{tmp_path}",
                                       **_record_knobs(composite_commit_maps=2)),
                         num_workers=2, device="cpu")
    out = ctx.sort_by_key(inputs, REC_PARTS, serializer=ColumnarKVSerializer(),
                          materialize="batches", cleanup=False)
    want = _rows_of(inputs)
    assert sorted(k + v for part in out for b in part for k, v in b.iter_records()) == want
    names = _names(tmp_path)
    assert names and all("_comp_" in n for n in names)
    assert len([n for n in names if n.endswith(".cindex")]) == 2
    assert _read_records(tmp_path, False, mode) == want
    assert _read_records(tmp_path, True, mode) == want


@pytest.mark.parametrize("mode", ["metadata", "listing"])
def test_a_jax_composite_sort_is_read_by_the_port(tmp_path, mode):
    from s3shuffle_tpu.batch import RecordBatch as JaxRecordBatch
    from s3shuffle_tpu.manager import ShuffleManager as JaxManager
    from s3shuffle_tpu.serializer import ColumnarKVSerializer as JaxColumnarKV
    from s3shuffle_tpu.shuffle import ShuffleContext as JaxContext

    JaxDispatcher.reset()
    inputs = _terasort_batches(JaxRecordBatch)
    ctx = JaxContext(manager=JaxManager(JaxConfig(
        root_dir=f"file://{tmp_path}", codec="tpu", tpu_host_fallback=False,
        speculative_read_quantile=0.0, **_record_knobs(composite_commit_maps=2))),
        num_workers=1)
    ctx.sort_by_key(inputs, REC_PARTS, serializer=JaxColumnarKV(), cleanup=False)
    assert all("_comp_" in n for n in _names(tmp_path))
    assert _read_records(tmp_path, False, mode) == _rows_of(inputs)


# --- the knobs ---

_KNOBS = {"composite_commit_maps": "16", "composite_flush_bytes": "32m",
          "composite_flush_ms": "125.5", "composite_spool_bytes": "1m",
          "compact_below_bytes": "8m", "tombstone_ttl_s": "60"}


def test_composite_knobs_default_parse_and_log_as_jax(caplog):
    port, jax = ShuffleConfig(), JaxConfig()
    for name in _KNOBS:
        assert getattr(port, name) == getattr(jax, name), name
    from_dict = ShuffleConfig.from_dict(_KNOBS)
    from_env = ShuffleConfig.from_env({"S3SHUFFLE_" + k.upper(): v for k, v in _KNOBS.items()})
    want = JaxConfig.from_dict(_KNOBS)
    for name in _KNOBS:
        assert getattr(from_dict, name) == getattr(from_env, name) == getattr(want, name), name
    with caplog.at_level("INFO", logger="s3shuffle_tpu_torch.config"):
        from_dict.log_values()
    assert "config: composite_commit_maps=16" in caplog.text


@pytest.mark.parametrize("bad", [
    {"composite_commit_maps": -1}, {"compact_below_bytes": -1}, {"composite_flush_bytes": 0},
    {"composite_spool_bytes": 0}, {"composite_flush_ms": -1.0}, {"tombstone_ttl_s": -0.5},
])
def test_composite_knobs_are_validated_as_jax(bad):
    with pytest.raises(ValueError):
        ShuffleConfig(**bad)
    with pytest.raises(ValueError):
        JaxConfig(**bad)
