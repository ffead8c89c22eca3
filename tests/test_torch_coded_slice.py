"""The coded shuffle plane on the CPU, port against the JAX package, exactly
(bytes): three maps × four partitions of seeded bytes (an empty partition,
tails that are not a multiple of the stripe chunk), CRC32C, k = 2 data
chunks and m = 2 parity sidecars of 1 KiB chunks, written by the port
(``device="cpu"``) and by the JAX package (Pallas kernels in interpret
mode) on two ``file://`` roots. The data, index, checksum and parity
objects must be byte-equal; with every data object deleted, the port
reads both shuffles back from parity, and the JAX package's degraded read
rebuilds the port's. Too little parity ends in a ``ChecksumError`` naming
the block; ``parity_segments = 0`` writes the uncoded objects; ``abort``
removes the parity sidecars. The index-trailer repair (offsets never
include trailer words) is held against JAX-written indexes with a
geometry and a skew trailer."""

import io
import os

import numpy as np
import pytest

from s3shuffle_tpu.block_ids import ShuffleBlockId as JaxBlockId
from s3shuffle_tpu.block_ids import ShuffleDataBlockId as JaxDataBlockId
from s3shuffle_tpu.codec.framing import CodecInputStream as JaxCodecInputStream
from s3shuffle_tpu.codec.framing import CodecOutputStream as JaxCodecOutputStream
from s3shuffle_tpu.codec.tpu import FusedChecksumAccumulator as JaxFusedAccumulator
from s3shuffle_tpu.codec.tpu import TpuCodec
from s3shuffle_tpu.coding.degraded import DegradedReader as JaxDegradedReader
from s3shuffle_tpu.coding.parity import ParityGeometry as JaxParityGeometry
from s3shuffle_tpu.config import ShuffleConfig as JaxConfig
from s3shuffle_tpu.metadata.helper import ShuffleHelper as JaxHelper
from s3shuffle_tpu.ops.checksum import POLY_CRC32C as JAX_POLY_CRC32C
from s3shuffle_tpu.read.block_stream import BlockStream as JaxBlockStream
from s3shuffle_tpu.read.checksum_stream import (
    ChecksumValidationStream as JaxChecksumStream,
)
from s3shuffle_tpu.skew import SkewInfo as JaxSkewInfo
from s3shuffle_tpu.storage.dispatcher import Dispatcher as JaxDispatcher
from s3shuffle_tpu.write.map_output_writer import MapOutputWriter as JaxMapOutputWriter
from s3shuffle_tpu_torch import ShuffleConfig, ShuffleDataBlockId
from s3shuffle_tpu_torch.coding.parity import ParityGeometry, split_index_geometry
from s3shuffle_tpu_torch.metadata.helper import ShuffleHelper, split_index_trailers
from s3shuffle_tpu_torch.read.checksum_stream import ChecksumError
from s3shuffle_tpu_torch.read.reader import ShuffleReader
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
from s3shuffle_tpu_torch.write.map_output_writer import MapOutputWriter

BS = 2048
BATCH = 4
SHUFFLE = 3
MAPS = [0, 1, 2]
PARTS = 4
CODED = {"parity_segments": 2, "parity_stripe_k": 2, "parity_chunk_bytes": 1024}


@pytest.fixture
def force_pallas(monkeypatch):
    monkeypatch.setenv("S3SHUFFLE_TLZ_PALLAS", "1")


def _partition_bytes(map_id: int, pid: int) -> bytes:
    """TeraSort-shaped rows (random 10-byte keys, 90-byte values from a
    small pool); map 1's partition 2 is empty, map 2's partition 3 is
    incompressible noise."""
    rng = np.random.default_rng(1000 + 100 * map_id + pid)
    if (map_id, pid) == (1, 2):
        return b""
    if (map_id, pid) == (2, 3):
        return bytes(rng.integers(0, 256, BS * 2 + 5, dtype=np.uint8))
    size = [BS * 5 + 37, BS * 2, BS * 9 + 1000, 777][pid]
    pool = rng.integers(0, 256, (16, 90), dtype=np.uint8)
    n = size // 100 + 1
    keys = rng.integers(0, 256, (n, 10), dtype=np.uint8)
    rows = np.concatenate([keys, pool[rng.integers(0, 16, n)]], axis=1)
    return rows.tobytes()[:size]


def _want(p: int) -> bytes:
    return b"".join(_partition_bytes(m, p) for m in MAPS)


def _port_env(root: str, **coded):
    cfg = ShuffleConfig(root_dir=root, checksum_algorithm="CRC32C",
                        codec_block_size=BS, codec_batch_blocks=BATCH, **coded)
    disp = Dispatcher(cfg)
    return disp, ShuffleHelper(disp)


def _write_port(root: str, **coded):
    disp, helper = _port_env(root, **coded)
    msgs = []
    for m in MAPS:
        writer = MapOutputWriter(disp, helper, SHUFFLE, m, PARTS, device="cpu")
        for p in range(PARTS):
            pw = writer.get_encoding_partition_writer(p)
            pw.write(_partition_bytes(m, p))
            pw.close()
        msgs.append(writer.commit_all_partitions())
    return disp, helper, msgs


def _jax_env(root: str, **coded):
    cfg = JaxConfig(root_dir=root, checksum_algorithm="CRC32C", codec="tpu",
                    codec_block_size=BS, codec_batch_blocks=BATCH, **coded)
    disp = JaxDispatcher(cfg)
    return disp, JaxHelper(disp)


def _write_jax(root: str, **coded):
    disp, helper = _jax_env(root, **coded)
    codec = TpuCodec(block_size=BS, batch_blocks=BATCH, use_device=True)
    for m in MAPS:
        writer = JaxMapOutputWriter(disp, helper, SHUFFLE, m, PARTS)
        for p in range(PARTS):
            # the fused route of write/spill_writer.py, as the uncoded slice test
            sink = io.BytesIO()
            acc = JaxFusedAccumulator(JAX_POLY_CRC32C)
            stream = JaxCodecOutputStream(codec, sink, close_sink=False, checksum=acc)
            stream.write(_partition_bytes(m, p))
            stream.close()
            pw = writer.get_partition_writer(p, precomputed_checksum=acc.value)
            pw.write(sink.getvalue())
            pw.close()
        writer.commit_all_partitions()
    return codec


def _objects(root_path) -> dict:
    out = {}
    for dirpath, _dirs, files in os.walk(root_path):
        for fn in files:
            full = os.path.join(dirpath, fn)
            with open(full, "rb") as f:
                out[os.path.relpath(full, root_path)] = f.read()
    return out


def _delete_data_objects(root_path, map_ids) -> None:
    for dirpath, _dirs, files in os.walk(root_path):
        for fn in files:
            if any(fn == f"shuffle_{SHUFFLE}_{m}_0.data" for m in map_ids):
                os.remove(os.path.join(dirpath, fn))


def _jax_degraded_read(root: str, codec, m: int, p: int) -> bytes:
    disp, helper = _jax_env(root, **CODED)
    recovery = JaxDegradedReader(disp)
    recovery.note(helper, SHUFFLE, m)
    offsets = helper.get_partition_lengths(SHUFFLE, m)
    block = JaxBlockId(SHUFFLE, m, p)
    stream = JaxBlockStream(disp, block, JaxDataBlockId(SHUFFLE, m),
                            int(offsets[p]), int(offsets[p + 1]), recovery=recovery)
    stream = JaxChecksumStream(block, stream, offsets, helper.get_checksums(SHUFFLE, m),
                               p, p + 1, "CRC32C")
    with JaxCodecInputStream(codec, stream) as s:
        return s.read()


def test_coded_objects_byte_equal_and_loss_reconstructs_both_ways(force_pallas, tmp_path):
    port_root, jax_root = tmp_path / "port", tmp_path / "jax"
    _disp, port_helper, msgs = _write_port(f"file://{port_root}", **CODED)
    codec = _write_jax(f"file://{jax_root}", **CODED)

    port_objs, jax_objs = _objects(port_root), _objects(jax_root)
    assert sorted(port_objs) == sorted(jax_objs)
    names = {os.path.basename(k) for k in port_objs}
    assert {f"shuffle_{SHUFFLE}_{m}_par{s}.parity" for m in MAPS for s in range(2)} <= names
    for key in port_objs:
        assert port_objs[key] == jax_objs[key], key
    assert [msg.parity_segments for msg in msgs] == [2, 2, 2]

    # the index trailer comes back as geometry, never as offsets
    jax_disp, jax_helper = _jax_env(f"file://{jax_root}", **CODED)
    for m in MAPS:
        offsets, geometry = port_helper.get_index(SHUFFLE, m)
        ref = jax_helper.resolve_map_location(SHUFFLE, m)
        assert np.array_equal(offsets, ref.offsets) and len(offsets) == PARTS + 1
        assert geometry == ParityGeometry(2, 2, 1024, int(offsets[-1]))
        assert (ref.parity.segments, ref.parity.payload_len) == (2, int(offsets[-1]))

    intact = ShuffleReader(*_port_env(f"file://{port_root}", **CODED), device="cpu")
    for p in range(PARTS):
        assert intact.read_partition(SHUFFLE, p, MAPS) == _want(p)
    assert intact.reconstructions == 0

    _delete_data_objects(port_root, MAPS)
    _delete_data_objects(jax_root, MAPS)
    non_empty = sum(1 for m in MAPS for p in range(PARTS) if _partition_bytes(m, p))
    for root in (port_root, jax_root):
        reader = ShuffleReader(*_port_env(f"file://{root}", **CODED), device="cpu")
        for p in range(PARTS):
            assert reader.read_partition(SHUFFLE, p, MAPS) == _want(p)
        assert reader.reconstructions == non_empty
        assert reader.codec.frame_counts["read_fused"] > 0  # rebuilt bytes are certified by the decode CRC
    # the JAX package's degraded read rebuilds the port's shuffle
    for m in MAPS:
        for p in range(PARTS):
            assert _jax_degraded_read(f"file://{port_root}", codec, m, p) == _partition_bytes(m, p)


def test_loss_without_enough_parity_raises_checksum_error(force_pallas, tmp_path):
    coded = {"parity_segments": 1, "parity_stripe_k": 2, "parity_chunk_bytes": 1024}
    port_root, jax_root = tmp_path / "port", tmp_path / "jax"
    disp, helper, _ = _write_port(f"file://{port_root}", **coded)
    _write_jax(f"file://{jax_root}", **coded)
    assert _objects(port_root) == _objects(jax_root)
    _delete_data_objects(port_root, [0])
    _delete_data_objects(jax_root, [0])
    reader = ShuffleReader(disp, helper, device="cpu")
    with pytest.raises(ChecksumError, match=f"shuffle_{SHUFFLE}_0_0"):
        reader.read_partition(SHUFFLE, 0, MAPS)
    assert reader.reconstructions == 0
    # the JAX package cannot rebuild that range either: both fall back
    jax_disp, jax_helper = _jax_env(f"file://{jax_root}", **coded)
    recovery = JaxDegradedReader(jax_disp)
    recovery.note(jax_helper, SHUFFLE, 0)
    offsets = jax_helper.get_partition_lengths(SHUFFLE, 0)
    assert recovery.reconstruct(JaxDataBlockId(SHUFFLE, 0), int(offsets[0]), int(offsets[1]),
                                reason="loss") is None
    # the maps that were not lost still read
    assert reader.read_partition(SHUFFLE, 1, [1, 2]) == b"".join(
        _partition_bytes(m, 1) for m in [1, 2]
    )


def test_degraded_reader_ranges_equal_the_jax_package(tmp_path):
    """Direct reconstructions at k = 2, m = 1 while the data object still
    exists: a range inside one chunk of a full group takes the sibling
    chunk from the data object; a range over both chunks of a full group
    cannot be rebuilt from one parity slice, by either package."""
    from s3shuffle_tpu_torch.coding.degraded import DegradedReader

    coded = {"parity_segments": 1, "parity_stripe_k": 2, "parity_chunk_bytes": 1024}
    disp, helper, _ = _write_port(f"file://{tmp_path}", **coded)
    jax_disp, jax_helper = _jax_env(f"file://{tmp_path}", **coded)
    ours, ref = DegradedReader(disp, device="cpu"), JaxDegradedReader(jax_disp)
    block, jblock = ShuffleDataBlockId(SHUFFLE, 2), JaxDataBlockId(SHUFFLE, 2)
    assert not ours and not ours.has(block) and ours.reconstruct(block, 0, 10) is None
    ours.note(helper, SHUFFLE, 2)
    ours.note(helper, SHUFFLE, 99)  # uncommitted: nothing registered
    ref.note(jax_helper, SHUFFLE, 2)
    geom = ours.geometry_of(block)
    assert ours and ours.has(block) and geom is not None
    assert geom.payload_len == int(helper.get_partition_lengths(SHUFFLE, 2)[-1])
    with open(disp.get_path(block)[len("file://"):], "rb") as f:
        stored = f.read()
    ranges = [(10, 900), (1030, 2000), (2100, 3000),
              (geom.payload_len - 3, geom.payload_len + 50)]
    for start, end in ranges:
        got = ours.reconstruct(block, start, end)
        assert got == ref.reconstruct(jblock, start, end, reason="loss")
        assert got == stored[start:end]
    assert ours.reconstructions == len(ranges)
    # both chunks of a full group wanted, one parity slice: neither can
    for start, end in [(1000, 1100), (0, geom.payload_len)]:
        assert ours.reconstruct(block, start, end) is None
        assert ref.reconstruct(jblock, start, end, reason="loss") is None
    assert ours.reconstructions == len(ranges)
    assert ours.reconstruct(block, 7, 7) == b""


def test_parity_off_writes_the_uncoded_objects(force_pallas, tmp_path):
    port_root, jax_root = tmp_path / "port", tmp_path / "jax"
    _disp, _helper, msgs = _write_port(f"file://{port_root}")
    _write_jax(f"file://{jax_root}")
    port_objs = _objects(port_root)
    assert not [k for k in port_objs if k.endswith(".parity")]
    assert port_objs == _objects(jax_root)
    assert [msg.parity_segments for msg in msgs] == [0, 0, 0]
    # the index holds the PARTS + 1 offsets and no trailer
    index = next(v for k, v in port_objs.items() if k.endswith(f"shuffle_{SHUFFLE}_0_0.index"))
    assert len(index) == 8 * (PARTS + 1)


def test_empty_map_and_abort_leave_no_parity(tmp_path):
    disp, helper = _port_env(f"file://{tmp_path}", **CODED)
    empty = MapOutputWriter(disp, helper, SHUFFLE, 5, 2, device="cpu")
    assert empty.commit_all_partitions().parity_segments == 0
    assert _objects(tmp_path) == {}  # an empty map writes no parity, no object

    writer = MapOutputWriter(disp, helper, SHUFFLE, 6, 2, device="cpu")
    pw = writer.get_encoding_partition_writer(0)
    pw.write(_partition_bytes(0, 2))
    pw.close()

    def fail_index(*_args, **_kwargs):
        raise OSError("index PUT failed")

    helper.write_partition_lengths = fail_index
    with pytest.raises(OSError):
        writer.commit_all_partitions()
    assert [k for k in _objects(tmp_path) if k.endswith(".parity")]  # PUT before the index
    writer.abort()
    left = _objects(tmp_path)
    assert not [k for k in left if k.endswith(".parity") or k.endswith(".data")]


def test_get_partition_lengths_drops_a_jax_geometry_trailer(tmp_path):
    jax_disp, jax_helper = _jax_env(f"file://{tmp_path}")
    lengths = np.array([3000, 0, 5000], dtype=np.int64)
    jax_helper.write_partition_lengths(
        SHUFFLE, 0, lengths, parity=JaxParityGeometry(2, 2, 1024, 8000)
    )
    disp, helper = _port_env(f"file://{tmp_path}")
    assert helper.get_partition_lengths(SHUFFLE, 0).tolist() == [0, 3000, 3000, 8000]
    assert np.array_equal(helper.get_partition_lengths(SHUFFLE, 0),
                          jax_helper.get_partition_lengths(SHUFFLE, 0))
    offsets, geometry = helper.get_index(SHUFFLE, 0)
    assert geometry == ParityGeometry(2, 2, 1024, 8000)
    # the port's coded index is byte-equal to the JAX package's
    raw = disp.backend.read_all(disp.get_path(_index_id(0)))
    helper.write_partition_lengths(SHUFFLE, 0, lengths, parity=geometry)
    assert disp.backend.read_all(disp.get_path(_index_id(0))) == raw


def _index_id(map_id: int):
    from s3shuffle_tpu_torch.block_ids import ShuffleIndexBlockId

    return ShuffleIndexBlockId(SHUFFLE, map_id)


@pytest.mark.parametrize("with_parity", [False, True])
@pytest.mark.parametrize("skew", [JaxSkewInfo(combined=True, split_bytes=0),
                                  JaxSkewInfo(combined=False, split_bytes=4096)],
                         ids=["combined", "split"])
def test_get_partition_lengths_drops_a_jax_skew_trailer(tmp_path, skew, with_parity):
    jax_disp, jax_helper = _jax_env(f"file://{tmp_path}")
    lengths = np.array([700, 1200, 0, 5], dtype=np.int64)
    parity = JaxParityGeometry(1, 2, 512, 1905) if with_parity else None
    jax_helper.write_partition_lengths(SHUFFLE, 1, lengths, parity=parity, skew=skew)
    disp, helper = _port_env(f"file://{tmp_path}")
    ref = jax_helper.resolve_map_location(SHUFFLE, 1)
    got = helper.get_partition_lengths(SHUFFLE, 1)
    assert got.tolist() == [0, 700, 1900, 1900, 1905]
    assert np.array_equal(got, ref.offsets)
    words = helper.read_block_as_array(_index_id(1))
    offsets, geometry, trailer = split_index_trailers(words)
    assert np.array_equal(offsets, ref.offsets)
    assert (trailer.combined, trailer.split_bytes) == (ref.combined, ref.split_bytes)
    assert (geometry is None) == (not with_parity)
    if with_parity:
        assert geometry == ParityGeometry(1, 2, 512, 1905)
    geo_offsets, geo_only = split_index_geometry(words)
    assert np.array_equal(geo_offsets, offsets) and geo_only == geometry
