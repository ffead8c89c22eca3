"""The async codec windows of the port on the CPU, small and deterministic:
the encode window of ``CodecOutputStream`` (the process-wide encode thread)
and the budgeted decode window of ``CodecInputStream`` (the shared decode
pool), against their synchronous paths and the JAX package's streams.

- Encode: streams and map outputs at windows 2 and 3 are byte-equal to the
  same data at 1 and to the JAX ``CodecOutputStream`` at 2 (both packages
  on ``S3SHUFFLE_TLZ_PALLAS=1``, the JAX side on its numpy TLZ branch);
  ``pending_bytes`` counts in-flight batches while a stub codec's encode
  waits on an event; a failing batch re-raises on the next ``write`` or on
  ``close``, and ``abort`` then leaves no object.
- Decode: bytes and fused certificates equal the synchronous path's; a
  counting budget sees the window's reservations and gets every byte back
  after ``close``, an early exit and a failure; a denying budget shrinks
  the window; a submit failure releases its fresh reservation; a window
  shrunk mid-stream drains in order; a decode failure re-raises on the
  next read; the pool is shared and bounded.

They mirror ``tests/test_device_codec_pipeline.py:286-330`` and
``tests/test_device_decode_pipeline.py:415-603``. No test injects a fault
into concurrent block streams, asserts a timing, or asserts the order in
which blocks complete; every wait has a timeout.
"""

import io
import os
import random
import threading
import zlib

import numpy as np
import pytest

from s3shuffle_tpu.codec.framing import CodecOutputStream as JaxCodecOutputStream
from s3shuffle_tpu.codec.tpu import FusedChecksumAccumulator as JaxFusedAccumulator
from s3shuffle_tpu.codec.tpu import TpuCodec
from s3shuffle_tpu.ops import tlz as jax_tlz
from s3shuffle_tpu.ops.checksum import POLY_CRC32C as JAX_POLY_CRC32C
from s3shuffle_tpu_torch import ShuffleConfig, ShuffleContext
from s3shuffle_tpu_torch.batch import RecordBatch
from s3shuffle_tpu_torch.block_ids import ShuffleBlockId, ShuffleDataBlockId
from s3shuffle_tpu_torch.codec import framing, get_codec
from s3shuffle_tpu_torch.codec.cuda import CudaCodec, FusedChecksumAccumulator
from s3shuffle_tpu_torch.codec.framing import (
    CODEC_IDS,
    HEADER,
    CodecInputStream,
    CodecOutputStream,
    FrameCodec,
)
from s3shuffle_tpu_torch.metadata.helper import ShuffleHelper
from s3shuffle_tpu_torch.ops import tlz
from s3shuffle_tpu_torch.ops.checksum import POLY_CRC32C
from s3shuffle_tpu_torch.read import prefetch
from s3shuffle_tpu_torch.read.checksum_stream import ChecksumError
from s3shuffle_tpu_torch.read.reader import ShuffleReader
from s3shuffle_tpu_torch.serializer import ColumnarKVSerializer
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
from s3shuffle_tpu_torch.write.map_output_writer import MapOutputWriter

BS = 2048
BATCH = 4
PARTS = 3


@pytest.fixture(autouse=True)
def jax_numpy_branch(monkeypatch):
    """Both packages on the TLZ Pallas formulation; the JAX side's host
    encoder on its numpy branch (its C encoder picks other valid matches)."""
    monkeypatch.setenv("S3SHUFFLE_TLZ_PALLAS", "1")
    monkeypatch.setattr(jax_tlz, "_encode_block_native", lambda _data: None)


def _mixed_payload(rng: random.Random, n_bytes: int) -> bytes:
    out = bytearray()
    pool = [rng.randbytes(48) for _ in range(8)]
    while len(out) < n_bytes:
        out += pool[rng.randrange(8)] if rng.random() < 0.5 else rng.randbytes(64)
    return bytes(out[:n_bytes])


def _stream_bytes(seed: int) -> bytes:
    """Three full batches and a half of compressible bytes, one block of
    noise (the raw escape) and a short tail."""
    rng = random.Random(seed)
    return (_mixed_payload(rng, BS * BATCH * 3 + BS * 2) + rng.randbytes(BS)
            + _mixed_payload(rng, 700))


def _pieces(data: bytes, seed: int):
    """``data`` cut at uneven points, as serializers hand columns over."""
    rng = random.Random(seed)
    pos = 0
    while pos < len(data):
        n = rng.randrange(1, 3 * BS)
        yield data[pos:pos + n]
        pos += n


def _executor_tally(monkeypatch) -> dict:
    """The port's batch encodes and decodes, by the kind of thread that ran
    them (the encode thread, a decode-pool thread, or another)."""
    seen = {"encode": 0, "decode": 0, "other": 0}

    def tally(kind):
        name = threading.current_thread().name
        seen[kind if name.startswith(f"s3shuffle-torch-{kind}") else "other"] += 1

    encode, decode = CodecOutputStream._encode_batch, CodecInputStream._decode_frames

    def encode_batch(self, *args):
        tally("encode")
        return encode(self, *args)

    def decode_frames(self, frames):
        tally("decode")
        return decode(self, frames)

    monkeypatch.setattr(CodecOutputStream, "_encode_batch", encode_batch)
    monkeypatch.setattr(CodecInputStream, "_decode_frames", decode_frames)
    return seen


# --- the encode window ---

def _port_stream(window: int, data: bytes, seed: int):
    codec = CudaCodec(BS, BATCH, device="cpu", encode_inflight_batches=window)
    sink, acc = io.BytesIO(), FusedChecksumAccumulator(POLY_CRC32C)
    out = CodecOutputStream(codec, sink, close_sink=False, checksum=acc)
    for piece in _pieces(data, seed):
        out.write(piece)
    out.flush_block()  # a partition boundary mid-stream
    out.write(data[:BS * 2 + 11])
    out.close()
    return sink.getvalue(), acc.value, (out.frames, out.fused_frames)


def _jax_stream(window: int, data: bytes, seed: int):
    codec = TpuCodec(block_size=BS, batch_blocks=BATCH, use_device=True,
                     encode_inflight_batches=window)
    sink, acc = io.BytesIO(), JaxFusedAccumulator(JAX_POLY_CRC32C)
    out = JaxCodecOutputStream(codec, sink, close_sink=False, checksum=acc)
    for piece in _pieces(data, seed):
        out.write(piece)
    out.flush_block()
    out.write(data[:BS * 2 + 11])
    out.close()
    return sink.getvalue(), acc.value


@pytest.mark.parametrize("window", [2, 3])
def test_encode_window_stream_equals_the_synchronous_and_the_jax_stream(monkeypatch, window):
    data = _stream_bytes(1)
    sync = _port_stream(1, data, seed=2)
    threads = _executor_tally(monkeypatch)
    windowed = _port_stream(window, data, seed=2)
    assert windowed == sync
    assert threads["encode"] > 0 and threads["other"] == 0, threads
    jax_bytes, jax_crc = _jax_stream(2, data, seed=2)
    assert (windowed[0], windowed[1]) == (jax_bytes, jax_crc)
    assert CodecInputStream(CudaCodec(BS, BATCH, device="cpu"),
                            io.BytesIO(windowed[0])).read() == data + data[:BS * 2 + 11]


def _objects(root) -> dict:
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            full = os.path.join(dirpath, fn)
            with open(full, "rb") as f:
                out[os.path.relpath(full, root)] = f.read()
    return out


def _write_maps(root, window: int, algorithm: str, maps: int = 2):
    cfg = ShuffleConfig(root_dir=f"file://{root}", checksum_algorithm=algorithm,
                        codec_block_size=BS, codec_batch_blocks=BATCH,
                        encode_inflight_batches=window)
    disp = Dispatcher(cfg)
    helper = ShuffleHelper(disp)
    for m in range(maps):
        writer = MapOutputWriter(disp, helper, 0, m, PARTS, device="cpu")
        for p in range(PARTS):
            pw = writer.get_encoding_partition_writer(p)
            for piece in _pieces(_stream_bytes(10 * m + p), seed=p):
                pw.write(piece)
            pw.close()
        writer.commit_all_partitions()
    return disp, helper


@pytest.mark.parametrize("algorithm", ["CRC32C", "ADLER32"])
def test_map_outputs_are_byte_equal_across_encode_windows(tmp_path, algorithm):
    trees = {}
    for window in (1, 2, 3):
        _write_maps(tmp_path / f"w{window}", window, algorithm)
        trees[window] = _objects(tmp_path / f"w{window}")
    assert any(name.endswith(".data") for name in trees[1])
    assert trees[2] == trees[1] and trees[3] == trees[1]


class _GatedEncodeCodec(FrameCodec):
    """A batch codec whose encode waits on an event: the test decides when
    each batch finishes. Its frames are raw (codec id 0)."""

    name = "gated"
    batch_blocks = 2
    encode_inflight_batches = 3

    def __init__(self):
        super().__init__(BS)
        self.gate = threading.Event()
        self.calls = []

    def wants_async_encode(self):
        return True

    def compress_block(self, data):
        return data  # the raw escape

    def compress_framed(self, buf, n_blocks, block_size):
        assert self.gate.wait(timeout=30)
        self.calls.append(n_blocks)
        return b"".join(
            HEADER.pack(0, block_size, block_size) + bytes(buf[i * block_size:(i + 1) * block_size])
            for i in range(n_blocks)
        )


def test_pending_bytes_counts_in_flight_batches_and_the_order_holds():
    codec = _GatedEncodeCodec()
    sink = io.BytesIO()
    out = CodecOutputStream(codec, sink, close_sink=False)
    data = _mixed_payload(random.Random(4), BS * 4 + 100)
    out.write(data[:BS * 2])  # batch 1 in flight, waiting on the gate
    out.write(data[BS * 2:BS * 4])  # batch 2 in flight
    assert out.pending_bytes == BS * 4
    assert sink.getvalue() == b""  # nothing emitted while the gate is shut
    codec.gate.set()
    out.write(data[BS * 4:])
    out.close()
    assert out.pending_bytes == 0
    assert CodecInputStream(None, io.BytesIO(sink.getvalue())).read() == data
    assert out.frames == 5 and codec.calls == [2, 2]


class _FailingEncodeCodec(_GatedEncodeCodec):
    encode_inflight_batches = 2

    def compress_framed(self, buf, n_blocks, block_size):
        raise RuntimeError("device lost")


def test_a_failing_batch_reraises_on_close():
    codec = _FailingEncodeCodec()
    out = CodecOutputStream(codec, io.BytesIO(), close_sink=False)
    out.write(b"x" * BS * 2)  # submits the failing batch (window not full)
    with pytest.raises(RuntimeError, match="device lost"):
        out.close()
    assert out.pending_bytes == 0 and out.closed


def test_a_failing_batch_reraises_on_the_next_write():
    codec = _FailingEncodeCodec()
    out = CodecOutputStream(codec, io.BytesIO(), close_sink=False)
    with pytest.raises(RuntimeError, match="device lost"):
        for _ in range(4):  # the window fills: a write harvests the failure
            out.write(b"x" * BS * 2)
    assert out.pending_bytes < BS * 2  # the window was dropped


@pytest.mark.parametrize("where", ["write", "close"])
def test_a_failed_encode_leaves_no_object_after_abort(tmp_path, monkeypatch, where):
    """The second batch's encode fails on the encode thread after the first
    reached the data object; the failure reaches the producer and the
    writer's abort deletes the object."""
    real = tlz.encode_batch_device
    calls = []

    def failing(*args, **kwargs):
        calls.append(threading.current_thread().name)
        if len(calls) == 2:
            raise RuntimeError("device lost")
        return real(*args, **kwargs)

    monkeypatch.setattr(tlz, "encode_batch_device", failing)
    cfg = ShuffleConfig(root_dir=f"file://{tmp_path}", checksum_algorithm="CRC32C",
                        codec_block_size=BS, codec_batch_blocks=BATCH, encode_inflight_batches=2)
    disp = Dispatcher(cfg)
    writer = MapOutputWriter(disp, ShuffleHelper(disp), 0, 0, 1, device="cpu")
    pw = writer.get_encoding_partition_writer(0)
    data = _mixed_payload(random.Random(5), BS * BATCH * 4)
    with pytest.raises(RuntimeError, match="device lost"):
        if where == "write":
            for i in range(4):  # four batches: the window harvests inside write
                pw.write(data[i * BS * BATCH:(i + 1) * BS * BATCH])
        else:
            for i in range(2):  # two batches; the second's failure surfaces in close
                pw.write(data[i * BS * BATCH:(i + 1) * BS * BATCH])
            pw.close()
    assert all(name.startswith("s3shuffle-torch-encode") for name in calls), calls
    assert _objects(tmp_path), "the first batch never reached the data object"
    writer.abort(RuntimeError("device lost"))
    assert not _objects(tmp_path)


def test_the_encode_executor_is_one_shared_worker():
    ex = framing._get_encode_executor()
    assert ex is framing._get_encode_executor()
    assert ex._max_workers == 1


# --- the decode window ---

class _GatedDecodeCodec(FrameCodec):
    """A batch codec (zlib frames) whose decode waits on an event."""

    name = "gated"
    codec_id = CODEC_IDS["zlib"]
    decode_batch_frames = 2
    decode_inflight_batches = 3

    def __init__(self):
        super().__init__(BS)
        self.gate = threading.Event()
        self.calls = []

    def compress_block(self, data):
        return zlib.compress(data, 1)

    def decompress_block(self, data, ulen):
        assert self.gate.wait(timeout=30)
        return zlib.decompress(data)

    def decompress_blocks(self, blocks):
        self.calls.append(len(blocks))
        return [self.decompress_block(b, n) for b, n in blocks]


class _CountingBudget:
    def __init__(self, allow=True):
        self.allow = allow
        self.live = 0
        self.peak = 0
        self.denied = 0

    def try_reserve(self, n):
        if not self.allow:
            self.denied += 1
            return False
        self.live += n
        self.peak = max(self.peak, self.live)
        return True

    def release_reserved(self, n):
        assert self.allow, "nothing was reserved"
        self.live -= n


def test_decode_window_keeps_the_order_and_returns_the_budget():
    codec = _GatedDecodeCodec()
    data = _mixed_payload(random.Random(20), BS * 8 + 99)
    framed = codec.compress_bytes(data)
    budget = _CountingBudget()
    codec.gate.set()
    stream = CodecInputStream(codec, io.BytesIO(framed), budget=budget)
    assert stream.read() == data
    stream.close()
    assert budget.peak > 0 and budget.live == 0


def test_decode_window_returns_the_budget_after_an_early_exit():
    codec = _GatedDecodeCodec()
    data = _mixed_payload(random.Random(25), BS * 12)
    framed = codec.compress_bytes(data)
    budget = _CountingBudget()
    codec.gate.set()
    stream = CodecInputStream(codec, io.BytesIO(framed), budget=budget)
    assert stream.read(100) == data[:100]
    assert budget.live > 0  # runs beyond the first are reserved
    stream.close()
    assert budget.live == 0


def test_a_denying_budget_shrinks_the_window():
    codec = _GatedDecodeCodec()
    codec.gate.set()
    data = _mixed_payload(random.Random(21), BS * 8)
    framed = codec.compress_bytes(data)
    budget = _CountingBudget(allow=False)
    stream = CodecInputStream(codec, io.BytesIO(framed), budget=budget)
    assert stream.read() == data
    stream.close()
    assert budget.denied > 0
    # one run in flight at a time, each at most the run size
    assert max(codec.calls) <= codec.decode_batch_frames


class _FailingTail(io.RawIOBase):
    """Serves the first ``good`` bytes, then raises."""

    def __init__(self, data, good):
        self._data = data
        self._pos = 0
        self._good = good

    def readable(self):
        return True

    def read(self, n=-1):
        if self._pos >= self._good:
            raise OSError("source lost")
        n = min(n, self._good - self._pos)
        out = self._data[self._pos:self._pos + n]
        self._pos += len(out)
        return out


def test_a_submit_failure_releases_its_fresh_reservation():
    codec = _GatedDecodeCodec()
    codec.gate.set()
    data = _mixed_payload(random.Random(24), BS * 8)
    framed = codec.compress_bytes(data)
    cut = 0
    for _ in range(2):  # two whole frames, so the first run decodes
        cut += 9 + int(np.frombuffer(framed[cut + 5:cut + 9], "<u4")[0])
    budget = _CountingBudget()
    stream = CodecInputStream(codec, _FailingTail(framed, cut), budget=budget)
    with pytest.raises(OSError, match="source lost"):
        stream.read()
    stream.close()
    assert budget.live == 0


def test_a_decode_failure_reraises_on_the_next_read_and_returns_the_budget():
    class Failing(_GatedDecodeCodec):
        def decompress_blocks(self, blocks):
            raise RuntimeError("device lost mid-scan")

    data = _mixed_payload(random.Random(22), BS * 6)
    framed = _GatedDecodeCodec().compress_bytes(data)
    budget = _CountingBudget()
    stream = CodecInputStream(Failing(), io.BytesIO(framed), budget=budget)
    with pytest.raises(RuntimeError, match="device lost"):
        stream.read()
    stream.close()
    assert budget.live == 0


def test_a_window_shrunk_mid_stream_drains_in_order():
    codec = _GatedDecodeCodec()
    codec.gate.set()
    data = _mixed_payload(random.Random(23), BS * 10)
    framed = codec.compress_bytes(data)
    stream = CodecInputStream(codec, io.BytesIO(framed))
    head = stream.read(BS)
    assert stream._inflight  # the window is running
    codec.decode_inflight_batches = 0
    rest = stream.read()
    stream.close()
    assert head + rest == data


def test_the_decode_executor_is_shared_and_bounded():
    ex = framing._get_decode_executor()
    assert ex is framing._get_decode_executor()
    assert 1 <= ex._max_workers <= min(4, os.cpu_count() or 2)


def _open_partition(disp, helper, codec, m, p):
    reader = ShuffleReader(disp, helper, codec=codec)
    return reader.open_block(ShuffleBlockId(0, m, p))


@pytest.mark.parametrize("frames", [1, 2, 32])
def test_decode_window_bytes_and_certificates_equal_the_synchronous_path(tmp_path, monkeypatch,
                                                                       frames):
    disp, helper = _write_maps(tmp_path, 1, "CRC32C")
    results = {}
    threads = _executor_tally(monkeypatch)
    for window in (1, 2):
        codec = CudaCodec(BS, BATCH, device="cpu")
        codec.decode_batch_frames, codec.decode_inflight_batches = frames, window
        got = []
        for m in range(2):
            for p in range(PARTS):
                with _open_partition(disp, helper, codec, m, p) as stream:
                    got.append(stream.read())
        results[window] = (got, dict(codec.frame_counts))
    assert results[2] == results[1]
    assert results[1][1]["read_fused"] > 0
    assert [len(b) for b in results[1][0]] == [len(_stream_bytes(10 * m + p))
                                               for m in range(2) for p in range(PARTS)]
    assert threads["decode"] > 0


def test_a_corrupt_frame_raises_the_checksum_error_in_the_window(tmp_path):
    disp, helper = _write_maps(tmp_path, 1, "CRC32C", maps=1)
    path = disp.get_path(ShuffleDataBlockId(0, 0))[len("file://"):]
    with open(path, "r+b") as f:
        f.seek(BS)
        byte = f.read(1)
        f.seek(BS)
        f.write(bytes([byte[0] ^ 0x40]))
    codec = CudaCodec(BS, BATCH, device="cpu")
    codec.decode_batch_frames, codec.decode_inflight_batches = 2, 2
    with pytest.raises(ChecksumError, match="shuffle_0_0_0"):
        with _open_partition(disp, helper, codec, 0, 0) as stream:
            stream.read()


def test_native_runs_are_served_as_read_only_views():
    codec = get_codec("native", block_size=BS, decode_inflight_batches=2)
    data = _mixed_payload(random.Random(26), BS * 9 + 5)
    stream = CodecInputStream(codec, io.BytesIO(codec.compress_bytes(data)))
    view = stream.readview(BS * 3)
    assert isinstance(view, np.ndarray) and not view.flags.writeable
    assert bytes(view) == data[:len(view)]
    assert bytes(view) + stream.read() == data
    stream.close()


# --- the windows under a record read ---

class _BudgetTally:
    """Every reservation and release of the scan budgets, summed."""

    def __init__(self, monkeypatch):
        self.reserved = self.released = 0
        reserve = prefetch.BufferedPrefetchIterator.try_reserve
        release = prefetch.BufferedPrefetchIterator.release_reserved

        def try_reserve(it, n):
            ok = reserve(it, n)
            if ok:
                self.reserved += n
            return ok

        def release_reserved(it, n):
            self.released += n
            release(it, n)

        monkeypatch.setattr(prefetch.BufferedPrefetchIterator, "try_reserve", try_reserve)
        monkeypatch.setattr(prefetch.BufferedPrefetchIterator, "release_reserved",
                            release_reserved)


def _terasort(seed, n=400, maps=3):
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (16, 90), dtype=np.uint8)
    return [RecordBatch(np.full(n, 10, np.int32), np.full(n, 90, np.int32),
                        rng.integers(0, 256, (n, 10), dtype=np.uint8).reshape(-1),
                        pool[rng.integers(0, 16, n)].reshape(-1)) for _ in range(maps)]


def _sorted_context(root):
    cfg = ShuffleConfig(root_dir=f"file://{root}", checksum_algorithm="CRC32C",
                        codec_block_size=BS, codec_batch_blocks=BATCH, decode_batch_frames=2)
    ctx = ShuffleContext(cfg, num_workers=2, device="cpu")
    parts = _terasort(3)
    out = ctx.sort_by_key(parts, PARTS, serializer=ColumnarKVSerializer(), cleanup=False)
    return ctx, parts, out


def test_a_shuffle_context_at_its_defaults_runs_both_windows(tmp_path, monkeypatch):
    threads = _executor_tally(monkeypatch)
    tally = _BudgetTally(monkeypatch)
    ctx, parts, out = _sorted_context(tmp_path)
    assert threads["encode"] > 0 and threads["decode"] > 0 and threads["other"] == 0, threads
    assert tally.reserved > 0 and tally.released == tally.reserved
    rows = sorted(bytes(k) + bytes(v) for part in out for k, v in part)
    assert rows == sorted(k + v for b in parts for k, v in b.iter_records())
    ctx.stop()


def test_the_scan_budget_comes_back_after_an_early_exit_and_a_failure(tmp_path, monkeypatch):
    ctx, _parts, _out = _sorted_context(tmp_path)
    manager = ctx.manager
    handle = manager.handle(0)
    tally = _BudgetTally(monkeypatch)
    batches = manager.get_reader(handle, 0, PARTS).read_batches()
    next(batches)
    batches.close()  # the consumer stops after one batch
    assert tally.reserved > 0 and tally.released == tally.reserved
    # a flipped stored byte: the read fails with the block's checksum error
    path = manager.dispatcher.get_path(ShuffleDataBlockId(0, 1))[len("file://"):]
    with open(path, "r+b") as f:
        f.seek(100)
        byte = f.read(1)
        f.seek(100)
        f.write(bytes([byte[0] ^ 0x01]))
    with pytest.raises(ChecksumError):
        for _batch in manager.get_reader(handle, 0, PARTS).read_batches():
            pass
    assert tally.released == tally.reserved
    ctx.stop()
