"""The whole slice on the CPU: three maps × four partitions of seeded bytes
(partial tail blocks, an empty partition, an incompressible partition)
written by the port (``device="cpu"``) and by the JAX package
(``MapOutputWriter`` + ``CodecOutputStream(TpuCodec(use_device=True))``
with the Pallas kernels in interpret mode + ``ShuffleHelper``) on two
``file://`` roots. The data, index and checksum objects must be byte-equal,
each package must read the other's objects back to the input bytes, and a
flipped byte in a data object must make the port's reader raise
``ChecksumError`` naming the block."""

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
from s3shuffle_tpu.config import ShuffleConfig as JaxConfig
from s3shuffle_tpu.metadata.helper import ShuffleHelper as JaxHelper
from s3shuffle_tpu.ops.checksum import POLY_CRC32C as JAX_POLY_CRC32C
from s3shuffle_tpu.read.block_stream import BlockStream as JaxBlockStream
from s3shuffle_tpu.read.checksum_stream import (
    ChecksumValidationStream as JaxChecksumStream,
)
from s3shuffle_tpu.storage.dispatcher import Dispatcher as JaxDispatcher
from s3shuffle_tpu.write.map_output_writer import MapOutputWriter as JaxMapOutputWriter
from s3shuffle_tpu_torch import ShuffleConfig, ShuffleDataBlockId
from s3shuffle_tpu_torch.codec.cuda import CudaCodec
from s3shuffle_tpu_torch.metadata.helper import ShuffleHelper
from s3shuffle_tpu_torch.read.checksum_stream import ChecksumError
from s3shuffle_tpu_torch.read.reader import ShuffleReader
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
from s3shuffle_tpu_torch.write.map_output_writer import MapOutputWriter

BS = 2048
BATCH = 4
SHUFFLE = 3
MAPS = [0, 1, 2]
PARTS = 4


@pytest.fixture
def force_pallas(monkeypatch):
    monkeypatch.setenv("S3SHUFFLE_TLZ_PALLAS", "1")


def _partition_bytes(map_id: int, pid: int) -> bytes:
    """TeraSort-shaped rows (random 10-byte keys, 90-byte values from a
    small pool); map 2's partition 3 is incompressible noise, map 1's
    partition 2 is empty."""
    rng = np.random.default_rng(100 * map_id + pid)
    if (map_id, pid) == (1, 2):
        return b""
    size = [BS * 5 + 37, BS * 2, BS * 9 + 1000, 777][pid]
    if (map_id, pid) == (2, 3):
        return bytes(rng.integers(0, 256, BS * 2 + 5, dtype=np.uint8))
    pool = rng.integers(0, 256, (16, 90), dtype=np.uint8)
    n = size // 100 + 1
    keys = rng.integers(0, 256, (n, 10), dtype=np.uint8)
    rows = np.concatenate([keys, pool[rng.integers(0, 16, n)]], axis=1)
    return rows.tobytes()[:size]


def _write_port(root: str, algorithm: str):
    cfg = ShuffleConfig(root_dir=root, checksum_algorithm=algorithm,
                        codec_block_size=BS, codec_batch_blocks=BATCH)
    disp = Dispatcher(cfg)
    helper = ShuffleHelper(disp)
    stats = []
    for m in MAPS:
        writer = MapOutputWriter(disp, helper, SHUFFLE, m, PARTS, device="cpu")
        for p in range(PARTS):
            pw = writer.get_encoding_partition_writer(p)
            pw.write(_partition_bytes(m, p))
            pw.close()
        writer.commit_all_partitions()
        counts = writer.codec.frame_counts
        stats.append((counts["written"], counts["written_fused"]))
    return disp, helper, stats


def _write_jax(root: str, algorithm: str):
    cfg = JaxConfig(root_dir=root, checksum_algorithm=algorithm, codec="tpu",
                    codec_block_size=BS, codec_batch_blocks=BATCH)
    disp = JaxDispatcher(cfg)
    helper = JaxHelper(disp)
    codec = TpuCodec(block_size=BS, batch_blocks=BATCH, use_device=True)
    for m in MAPS:
        writer = JaxMapOutputWriter(disp, helper, SHUFFLE, m, PARTS)
        for p in range(PARTS):
            # the fused route of write/spill_writer.py: frames land in a local
            # sink, the sidecar value is stitched from the fused CRCs
            sink = io.BytesIO()
            acc = JaxFusedAccumulator(JAX_POLY_CRC32C) if algorithm == "CRC32C" else None
            stream = JaxCodecOutputStream(codec, sink, close_sink=False, checksum=acc)
            stream.write(_partition_bytes(m, p))
            stream.close()
            pw = writer.get_partition_writer(
                p, precomputed_checksum=acc.value if acc is not None else None
            )
            pw.write(sink.getvalue())
            pw.close()
        writer.commit_all_partitions()
    return disp, helper, codec


def _objects(root_path: str) -> dict:
    out = {}
    for dirpath, _dirs, files in os.walk(root_path):
        for fn in files:
            full = os.path.join(dirpath, fn)
            with open(full, "rb") as f:
                out[os.path.relpath(full, root_path)] = f.read()
    return out


def _jax_read(disp, helper, codec, m: int, p: int) -> bytes:
    cfg = disp.config
    offsets = helper.get_partition_lengths(SHUFFLE, m)
    block = JaxBlockId(SHUFFLE, m, p)
    stream = JaxBlockStream(disp, block, JaxDataBlockId(SHUFFLE, m),
                            int(offsets[p]), int(offsets[p + 1]))
    stream = JaxChecksumStream(block, stream, offsets, helper.get_checksums(SHUFFLE, m),
                               p, p + 1, cfg.checksum_algorithm)
    with JaxCodecInputStream(codec, stream) as s:
        return s.read()


@pytest.mark.parametrize("algorithm", ["CRC32C", "ADLER32"])
def test_slice_objects_byte_equal_and_cross_readable(force_pallas, tmp_path, algorithm):
    port_root = tmp_path / "port"
    jax_root = tmp_path / "jax"
    port_disp, port_helper, stats = _write_port(f"file://{port_root}", algorithm)
    jax_disp, jax_helper, jax_codec = _write_jax(f"file://{jax_root}", algorithm)

    port_objs = _objects(str(port_root))
    jax_objs = _objects(str(jax_root))
    assert sorted(port_objs) == sorted(jax_objs)
    names = {os.path.basename(k) for k in port_objs}
    assert f"shuffle_{SHUFFLE}_0_0.checksum.{algorithm}" in names
    assert f"shuffle_{SHUFFLE}_0_0.index" in names
    for key in port_objs:
        assert port_objs[key] == jax_objs[key], key

    frames = sum(f for f, _ in stats)
    fused = sum(f for _, f in stats)
    assert frames > 0
    # every full block's frame is certified by the encode launch with CRC32C
    assert fused == (
        sum(len(_partition_bytes(m, p)) // BS for m in MAPS for p in range(PARTS))
        if algorithm == "CRC32C" else 0
    )

    # the port reads the JAX package's objects, the JAX package the port's
    port_on_jax = Dispatcher(ShuffleConfig(
        root_dir=f"file://{jax_root}", checksum_algorithm=algorithm,
        codec_block_size=BS, codec_batch_blocks=BATCH,
    ))
    port_reader = ShuffleReader(port_on_jax, ShuffleHelper(port_on_jax), device="cpu")
    for p in range(PARTS):
        want = b"".join(_partition_bytes(m, p) for m in MAPS)
        assert port_reader.read_partition(SHUFFLE, p, MAPS) == want
    jax_on_port = JaxDispatcher(JaxConfig(
        root_dir=f"file://{port_root}", checksum_algorithm=algorithm, codec="tpu",
        codec_block_size=BS, codec_batch_blocks=BATCH,
    ))
    jax_on_port_helper = JaxHelper(jax_on_port)
    for m in MAPS:
        for p in range(PARTS):
            got = _jax_read(jax_on_port, jax_on_port_helper, jax_codec, m, p)
            assert got == _partition_bytes(m, p)
    if algorithm == "CRC32C":
        # read side: every full TLZ frame is certified by the decode launch;
        # the incompressible partition's 2 full blocks are raw-escape frames
        # (certified on the write side by the fused raw-block CRC)
        assert port_reader.codec.frame_counts["read_fused"] == fused - 2


def test_slice_corruption_raises_checksum_error_naming_the_block(tmp_path):
    root = tmp_path / "port"
    disp, helper, _ = _write_port(f"file://{root}", "CRC32C")
    reader = ShuffleReader(disp, helper, device="cpu")
    assert reader.read_partition(SHUFFLE, 2, MAPS) == b"".join(
        _partition_bytes(m, 2) for m in MAPS
    )
    offsets = helper.get_partition_lengths(SHUFFLE, 0)
    path = disp.get_path(ShuffleDataBlockId(SHUFFLE, 0))[len("file://"):]
    with open(path, "r+b") as f:
        pos = int(offsets[2]) + (int(offsets[3]) - int(offsets[2])) * 2 // 3
        f.seek(pos)
        byte = f.read(1)
        f.seek(pos)
        f.write(bytes([byte[0] ^ 0x5A]))
    with pytest.raises(ChecksumError, match=f"shuffle_{SHUFFLE}_0_2"):
        reader.read_partition(SHUFFLE, 2, MAPS)
    # the other partitions of the map still validate
    assert reader.read_partition(SHUFFLE, 1, MAPS) == b"".join(
        _partition_bytes(m, 1) for m in MAPS
    )


def test_slice_missing_index_and_abort(tmp_path):
    cfg = ShuffleConfig(root_dir=f"file://{tmp_path}", checksum_algorithm="CRC32C",
                        codec_block_size=BS, codec_batch_blocks=BATCH)
    disp = Dispatcher(cfg)
    helper = ShuffleHelper(disp)
    writer = MapOutputWriter(disp, helper, SHUFFLE, 7, 2, device="cpu")
    pw = writer.get_encoding_partition_writer(1)
    pw.write(b"x" * 5000)
    pw.close()
    with pytest.raises(ValueError):
        writer.get_encoding_partition_writer(0)  # increasing order only
    writer.abort()
    assert _objects(str(tmp_path)) == {}
    reader = ShuffleReader(disp, helper, device="cpu")
    with pytest.raises(FileNotFoundError):
        reader.read_partition(SHUFFLE, 1, [7])
    empty = MapOutputWriter(disp, helper, SHUFFLE, 8, 2, device="cpu")
    msg = empty.commit_all_partitions()
    assert list(msg.partition_lengths) == [0, 0]
    assert _objects(str(tmp_path)) == {}  # an empty map commits no object


@pytest.mark.parametrize("n_blocks,tail", [(1, 0), (5, 0), (4, 300), (0, 1500)])
def test_codec_frames_and_fused_crcs_match_tpu_codec(force_pallas, n_blocks, tail):
    rng = np.random.default_rng(n_blocks * 10 + tail)
    pool = rng.integers(0, 256, (8, 90), dtype=np.uint8)
    rows = np.concatenate([
        rng.integers(0, 256, (400, 10), dtype=np.uint8), pool[rng.integers(0, 8, 400)]
    ], axis=1).tobytes()
    data = (rows * 4)[: n_blocks * BS + tail]
    port = CudaCodec(block_size=BS, batch_blocks=BATCH, device="cpu")
    ref = TpuCodec(block_size=BS, batch_blocks=BATCH, use_device=True)
    if n_blocks:
        blob = data[: n_blocks * BS]
        got = port.compress_framed_fused(blob, n_blocks, BS)
        want = ref.compress_framed_fused(blob, n_blocks, BS)
        assert got[0] == want[0]
        assert got[1] == [(int(c), int(n)) for c, n in want[1]]
    framed = port.compress_bytes(data)
    assert framed == ref.compress_bytes(data)
    assert port.decompress_bytes(framed) == data
    assert ref.decompress_bytes(framed) == data
