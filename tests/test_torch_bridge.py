"""The port's codec bridge (``s3shuffle_tpu_torch/bridge.py``) against the
JAX package's (``s3shuffle_tpu/bridge.py``), on the CPU.

- Under ``native`` and ``zlib`` a port server and a JAX server answer every
  request (the four ops, an unknown op, a corrupt stream) with byte-equal
  responses.
- Under ``tpu`` the port's handler over ``CudaCodec(device="cpu")`` (the
  kernels' plain versions) answers what the JAX handler answers over
  ``TpuCodec(use_device=True)`` with its Pallas kernels in interpret mode
  (``S3SHUFFLE_TLZ_PALLAS=1``) and its numpy host encoder for short blocks.
  The JAX server's own ``get_codec("tpu")`` reroutes writes to SLZ frames
  on a host without a chip; the port has no such reroute, so the JAX
  handler is called directly. Blocks are 2048 bytes: the Pallas
  interpreter is slow.
- Either package's client talks to either package's server.
- The batch codec entry points the bridge uses (``CudaCodec.compress_blocks``
  / ``frame_blocks``, ``NativeLZCodec.crc32c_batch``) equal the JAX ones.
- The port counterparts of ``tests/test_bridge.py``'s cases: protocol
  violation, oversize block, request cap, concurrent clients, empty batch.
"""

import random
import socket
import struct
import threading
import zlib

import numpy as np
import pytest

from s3shuffle_tpu import bridge as jax_bridge
from s3shuffle_tpu.codec import get_codec as jax_get_codec
from s3shuffle_tpu.codec.native import NativeLZCodec as JaxNativeLZCodec
from s3shuffle_tpu.codec.tpu import TpuCodec
from s3shuffle_tpu.ops import tlz as jax_tlz
from s3shuffle_tpu_torch import bridge
from s3shuffle_tpu_torch.codec import get_codec
from s3shuffle_tpu_torch.codec.cuda import CudaCodec
from s3shuffle_tpu_torch.codec.framing import MAX_FRAME_ULEN
from s3shuffle_tpu_torch.codec.native import NativeLZCodec
from s3shuffle_tpu_torch.utils.checksums import crc32c
from torch_jax_native import jax_native_library  # noqa: F401  (loads the JAX oracle's native library)

BS = 2048
BATCH = 4
HOST_CODECS = ["native", "zlib"]


def _blocks(seed=0, n=5, size=30_000):
    rng = random.Random(seed)
    filler = rng.randbytes(512)
    return [(filler * (size // 512))[: rng.randrange(size // 2, size)] + rng.randbytes(64)
            for _ in range(n)]


def _terasort_blocks(seed, n_full, tail):
    """TeraSort-shaped rows (10-byte random keys, 90-byte values from a
    small pool) cut into ``n_full`` blocks of BS bytes and a tail."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (16, 90), dtype=np.uint8)
    n = (n_full * BS + tail) // 100 + 1
    rows = np.concatenate([rng.integers(0, 256, (n, 10), dtype=np.uint8),
                           pool[rng.integers(0, 16, n)]], axis=1).tobytes()
    return [rows[i * BS:(i + 1) * BS] for i in range(n_full)] + [rows[n_full * BS:][:tail]]


def _call(port, op, blocks):
    """One raw request; returns ``(status, blocks)`` of the reply."""
    with socket.create_connection(("127.0.0.1", port)) as sock:
        bridge._write_message(sock, op, blocks)
        return bridge._read_message(sock, 1 << 31)


@pytest.fixture(scope="module", params=HOST_CODECS)
def server_pair(request):
    port_srv = bridge.CodecBridgeServer(port=0, codec_name=request.param).start()
    jax_srv = jax_bridge.CodecBridgeServer(port=0, codec_name=request.param).start()
    yield request.param, port_srv, jax_srv
    port_srv.stop()
    jax_srv.stop()


def _requests():
    blocks = _blocks(seed=4)
    framed = zlib.compress(b"x")  # not a framed stream
    return [
        ("compress", bridge.OP_COMPRESS_FRAMED, blocks),
        ("compress-empty-block", bridge.OP_COMPRESS_FRAMED, [b""]),
        ("crc32c", bridge.OP_CRC32C_BATCH, blocks + [b""]),
        ("adler32", bridge.OP_ADLER32_BATCH, blocks + [b""]),
        ("corrupt-stream", bridge.OP_DECOMPRESS, [b"\xff" * 32]),
        ("two-streams", bridge.OP_DECOMPRESS, [framed, framed]),
        ("unknown-op", 9, [b"abc"]),
    ]


@pytest.mark.parametrize("case", _requests(), ids=lambda c: c[0])
def test_responses_equal_the_jax_servers(server_pair, case):
    _name, port_srv, jax_srv = server_pair
    _label, op, blocks = case
    got = _call(port_srv.port, op, blocks)
    assert got == _call(jax_srv.port, op, blocks)
    if op == bridge.OP_COMPRESS_FRAMED:
        # and the framed stream decompresses to the same bytes on both
        (framed,) = got[1]
        back = _call(port_srv.port, bridge.OP_DECOMPRESS, [framed])
        assert back == _call(jax_srv.port, bridge.OP_DECOMPRESS, [framed])
        assert back == (0, [b"".join(blocks)])


def test_clients_talk_to_either_server(server_pair):
    codec, port_srv, jax_srv = server_pair
    blocks = _blocks(seed=5, n=3, size=12_000)
    for client_cls, srv in ((bridge.CodecBridgeClient, jax_srv),
                            (jax_bridge.CodecBridgeClient, port_srv)):
        c = client_cls(port=srv.port)
        try:
            framed = c.compress_framed(blocks)
            assert c.decompress(framed) == b"".join(blocks)
            assert c.crc32c(blocks) == [crc32c(b) for b in blocks]
            assert c.adler32(blocks) == [zlib.adler32(b) for b in blocks]
            assert get_codec(codec).decompress_bytes(framed) == b"".join(blocks)
        finally:
            c.close()


# --- the tpu codec: the port's handler against the JAX oracle ---

@pytest.fixture
def jax_tlz_oracle(monkeypatch):
    monkeypatch.setenv("S3SHUFFLE_TLZ_PALLAS", "1")
    monkeypatch.setattr(jax_tlz, "_encode_block_native", lambda _data: None)


TPU_SHAPES = [(5, 777), (4, 0), (0, 1500)]


@pytest.mark.parametrize("n_full,tail", TPU_SHAPES)
def test_tpu_dispatch_equals_the_jax_oracle(jax_tlz_oracle, n_full, tail):
    blocks = [b for b in _terasort_blocks(n_full * 10 + tail, n_full, tail) if b or tail]
    port_codec = CudaCodec(block_size=BS, batch_blocks=BATCH, device="cpu")
    jax_codec = TpuCodec(block_size=BS, batch_blocks=BATCH, use_device=True)
    framed = bridge._Handler._dispatch(port_codec, bridge.OP_COMPRESS_FRAMED, blocks)
    assert framed == jax_bridge._Handler._dispatch(jax_codec, jax_bridge.OP_COMPRESS_FRAMED,
                                                   blocks)
    raw = bridge._Handler._dispatch(port_codec, bridge.OP_DECOMPRESS, framed)
    assert raw == jax_bridge._Handler._dispatch(jax_codec, jax_bridge.OP_DECOMPRESS, framed)
    assert raw == [b"".join(blocks)]
    for op in (bridge.OP_CRC32C_BATCH, bridge.OP_ADLER32_BATCH):
        assert bridge._Handler._dispatch(port_codec, op, blocks) == \
            jax_bridge._Handler._dispatch(jax_codec, op, blocks)


def test_cuda_codec_batch_entry_points_equal_tpu_codec(jax_tlz_oracle):
    blocks = _terasort_blocks(9, 6, 333)
    port_codec = CudaCodec(block_size=BS, batch_blocks=BATCH, device="cpu")
    jax_codec = TpuCodec(block_size=BS, batch_blocks=BATCH, use_device=True)
    assert port_codec.compress_blocks(blocks) == jax_codec.compress_blocks(blocks)
    framed = port_codec.frame_blocks(blocks)
    assert framed == jax_codec.frame_blocks(blocks)
    assert port_codec.decompress_bytes(framed) == b"".join(blocks)
    # a batch without a full block stays on the host encoder
    short = [blocks[-1], blocks[0][:100]]
    assert port_codec.compress_blocks(short) == jax_codec.compress_blocks(short)


def test_crc32c_batch_equals_jax():
    blocks = _blocks(seed=6, n=7, size=9_000) + [b""]
    concat = np.frombuffer(b"".join(blocks), dtype=np.uint8)
    offsets = np.concatenate([[0], np.cumsum([len(b) for b in blocks])]).astype(np.int64)
    got = NativeLZCodec().crc32c_batch(concat, offsets)
    assert got.dtype == np.uint32
    assert (got == JaxNativeLZCodec().crc32c_batch(concat, offsets)).all()
    assert got[-1] == 0


def test_a_tpu_server_on_the_cpu_round_trips(tmp_path):
    """A port server with the tpu codec on the CPU, 256 KiB blocks: one
    full block through the plain kernels and a short one on the host."""
    srv = bridge.CodecBridgeServer(port=0, codec_name="tpu", device="cpu").start()
    try:
        assert isinstance(srv.codec, CudaCodec) and srv.codec.block_size == 256 * 1024
        rng = np.random.default_rng(1)
        full = np.tile(rng.integers(0, 256, 100, dtype=np.uint8), 2700)[:256 * 1024].tobytes()
        c = bridge.CodecBridgeClient(port=srv.port)
        try:
            blocks = [full, full[:1000]]
            framed = c.compress_framed(blocks)
            assert len(framed) < 4096
            assert c.decompress(framed) == full + full[:1000]
        finally:
            c.close()
    finally:
        srv.stop()


def test_a_tpu_server_refuses_to_start_without_cuda():
    with pytest.raises(ValueError, match="codec 'tpu' unavailable: no CUDA device"):
        bridge.CodecBridgeServer(port=0, codec_name="tpu")


# --- the port counterparts of tests/test_bridge.py ---

@pytest.fixture(scope="module")
def native_server():
    srv = bridge.CodecBridgeServer(port=0, codec_name="native").start()
    yield srv
    srv.stop()


@pytest.fixture
def client(native_server):
    c = bridge.CodecBridgeClient(port=native_server.port)
    yield c
    c.close()


def test_compress_decompress_roundtrip(client):
    blocks = _blocks()
    framed = client.compress_framed(blocks)
    assert len(framed) < sum(len(b) for b in blocks)
    assert client.decompress(framed) == b"".join(blocks)
    assert jax_get_codec("native").decompress_bytes(framed) == b"".join(blocks)


def test_error_propagates_and_connection_survives(client):
    with pytest.raises(RuntimeError, match="bridge error"):
        client.decompress(b"\xff" * 32)
    blocks = _blocks(seed=3, n=2)
    assert client.decompress(client.compress_framed(blocks)) == b"".join(blocks)


def test_concurrent_clients(native_server):
    errors = []

    def worker(seed):
        try:
            c = bridge.CodecBridgeClient(port=native_server.port)
            try:
                blocks = _blocks(seed=seed, n=3, size=20_000)
                for _ in range(5):
                    assert c.decompress(c.compress_framed(blocks)) == b"".join(blocks)
            finally:
                c.close()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads) and not errors


def test_empty_batch_and_empty_block(client):
    assert client.decompress(client.compress_framed([b""])) == b""
    assert client.crc32c([b""]) == [0]
    assert client.crc32c([]) == [] and client.adler32([]) == []
    assert client.compress_framed([]) == b""


def test_protocol_violation_gets_status1_not_silence(native_server):
    sock = socket.create_connection(("127.0.0.1", native_server.port))
    try:
        sock.sendall(struct.pack("<BI", bridge.OP_CRC32C_BATCH, 1) + struct.pack("<I", 1 << 30))
        msg = bridge._read_message(sock)
        assert msg is not None, "server closed without replying"
        status, out = msg
        assert status == 1 and b"exceeds limit" in out[0]
    finally:
        sock.close()


def test_too_many_blocks_gets_status1(native_server):
    sock = socket.create_connection(("127.0.0.1", native_server.port))
    try:
        sock.sendall(struct.pack("<BI", bridge.OP_CRC32C_BATCH, bridge.MAX_BLOCKS + 1))
        status, out = bridge._read_message(sock)
        assert status == 1 and out == [f"block count {bridge.MAX_BLOCKS + 1} exceeds limit "
                                       f"{bridge.MAX_BLOCKS}".encode()]
    finally:
        sock.close()


@pytest.mark.parametrize("codec_name", ["native", "zlib"])
def test_oversized_block_rejected_before_framing(codec_name):
    class FakeBig(bytes):
        def __len__(self):
            return MAX_FRAME_ULEN + 1

    with pytest.raises(ValueError, match="frame limit") as err:
        bridge._Handler._dispatch(get_codec(codec_name), bridge.OP_COMPRESS_FRAMED, [FakeBig()])
    with pytest.raises(ValueError) as jax_err:
        jax_bridge._Handler._dispatch(jax_get_codec(codec_name), jax_bridge.OP_COMPRESS_FRAMED,
                                      [FakeBig()])
    assert str(err.value) == str(jax_err.value)


def test_server_request_cap_configurable():
    srv = bridge.CodecBridgeServer(port=0, codec_name="native", max_total_bytes=1024).start()
    try:
        c = bridge.CodecBridgeClient(port=srv.port)
        try:
            with pytest.raises((RuntimeError, ConnectionError), match="exceeds limit|closed"):
                c.crc32c([b"x" * 2048])
        finally:
            c.close()
    finally:
        srv.stop()


def test_unknown_codec_is_refused():
    with pytest.raises(ValueError, match="codec 'bogus' unavailable"):
        bridge.CodecBridgeServer(port=0, codec_name="bogus")
    with pytest.raises(ValueError, match="codec 'none' unavailable"):
        bridge.CodecBridgeServer(port=0, codec_name="none")
