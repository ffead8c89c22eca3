"""Kernel K1's plain PyTorch version and the host CRC helpers of the port,
held exactly against the JAX package: the tiled Pallas CRC fold in
interpret mode, the XLA bit-matmul ``crc32_batch``, ``google_crc32c`` and
the byte-serial remainder, over the shapes of the JAX package's own Pallas
CRC suite (right-aligned tails included)."""

import numpy as np
import pytest
import torch

from s3shuffle_tpu.ops import checksum as jax_checksum
from s3shuffle_tpu.ops import crc_pallas
from s3shuffle_tpu_torch.ops import checksum, crc_cuda
from s3shuffle_tpu_torch.utils import checksums as port_checksums

POLY = checksum.POLY_CRC32C


def _raw_ref(row: bytes) -> int:
    return jax_checksum._crc_raw_bytes(row, POLY, 0) & 0xFFFFFFFF


@pytest.mark.parametrize("b,length", [(8, 128), (8, 512), (16, 1280), (24, 256)])
def test_plain_crc_matches_pallas_and_xla(b, length):
    rng = np.random.default_rng(b * length)
    data = rng.integers(0, 256, (b, length), dtype=np.uint8)
    got = crc_cuda.crc_raw(torch.from_numpy(data), POLY).numpy()
    pallas = np.asarray(crc_pallas.crc_raw_batch(data, POLY, interpret=True))
    assert [int(c) for c in got] == [int(c) for c in pallas]
    assert [int(c) for c in got] == [_raw_ref(bytes(r)) for r in data]
    # full-algorithm CRCs: the host fixup over the port's raw remainders
    zero = checksum.zero_run_crcs(POLY, length)
    lengths = np.full(b, length)
    want = jax_checksum.crc32_batch(data, lengths, poly=POLY)
    assert [int(c) for c in (got.astype(np.uint32) ^ zero[lengths])] == [
        int(c) for c in want
    ]


@pytest.mark.parametrize("tail", [0, 1, 37, 127, 128, 300])
def test_plain_crc_right_aligned_rows(tail):
    """Right-aligned rows with zero front padding, and the same messages
    front-aligned with explicit lengths: both give the suffix's remainder,
    equal to the Pallas fold and to google_crc32c after the fixup."""
    import google_crc32c

    length = 512
    rng = np.random.default_rng(tail)
    rows = np.zeros((8, length), dtype=np.uint8)
    front = np.zeros((8, length), dtype=np.uint8)
    ns = [min(length, tail + i) for i in range(8)]
    for i, n in enumerate(ns):
        if n:
            msg = rng.integers(0, 256, n, dtype=np.uint8)
            rows[i, length - n:] = msg
            front[i, :n] = msg
    got = crc_cuda.crc_raw(torch.from_numpy(rows), POLY).numpy()
    got_front = crc_cuda.crc_raw(
        torch.from_numpy(front), POLY, torch.tensor(ns, dtype=torch.int32)
    ).numpy()
    pallas = np.asarray(crc_pallas.crc_raw_batch(rows, POLY, interpret=True))
    assert [int(c) for c in got] == [int(c) for c in pallas]
    assert [int(c) for c in got_front] == [int(c) for c in pallas]
    zero = checksum.zero_run_crcs(POLY, length)
    for i, n in enumerate(ns):
        msg = bytes(rows[i, length - n:])
        assert int(got[i]) ^ int(zero[n]) == google_crc32c.value(msg)


@pytest.mark.parametrize("poly", [checksum.POLY_CRC32, checksum.POLY_CRC32C])
@pytest.mark.parametrize("length", [8, 136, 1000, 4096])
def test_plain_crc_odd_widths_both_polys(poly, length):
    rng = np.random.default_rng(length)
    data = rng.integers(0, 256, (3, length), dtype=np.uint8)
    got = crc_cuda.crc_raw(torch.from_numpy(data), poly).numpy()
    want = [jax_checksum._crc_raw_bytes(bytes(r), poly, 0) for r in data]
    assert [int(c) for c in got] == want


def test_host_gf2_helpers_match_reference():
    rng = np.random.default_rng(7)
    for poly in (checksum.POLY_CRC32, checksum.POLY_CRC32C):
        for n in (0, 1, 9, 128, 1000, 262144):
            assert checksum._zero_op_power(poly, n) == jax_checksum._zero_op_power(poly, n)
        a = bytes(rng.integers(0, 256, 333, dtype=np.uint8))
        b = bytes(rng.integers(0, 256, 1234, dtype=np.uint8))
        ca, cb = checksum.host_crc(a, poly), checksum.host_crc(b, poly)
        assert checksum.crc_combine(ca, cb, len(b), poly) == jax_checksum.crc_combine(
            ca, cb, len(b), poly
        )
        assert checksum.crc_combine(ca, cb, len(b), poly) == checksum.host_crc(a + b, poly)
        assert np.array_equal(
            checksum.zero_run_crcs(poly, 4096), jax_checksum.zero_run_crcs(poly, 4096)
        )
    chunks = [b"abc", b"", bytes(range(40))]
    got = checksum.stage_right_aligned(chunks, 64)
    want = jax_checksum.stage_right_aligned(chunks, 64)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.mark.parametrize("n", [0, 1, 5, 63, 64, 65, 1000, 8191, 70000])
def test_host_crc32c_matches_reference(n):
    import google_crc32c

    from s3shuffle_tpu.utils.checksums import crc32c_py as jax_crc32c_py

    rng = np.random.default_rng(n)
    data = bytes(rng.integers(0, 256, n, dtype=np.uint8))
    assert port_checksums.crc32c(data) == google_crc32c.value(data)
    for value in (0, 0xDEADBEEF):
        assert port_checksums.crc32c(data, value) == jax_crc32c_py(data, value)
    stream = port_checksums.create_checksum("crc32c")
    stream.update(data[: n // 3])
    stream.update(data[n // 3 :])
    assert stream.value == google_crc32c.value(data)


def test_device_tables_are_the_reference_operators():
    """The CUDA kernels' inputs: slicing-by-8 tables and tree operators."""
    t = checksum.slice8_tables(POLY)
    rng = np.random.default_rng(3)
    word = rng.integers(0, 256, 8, dtype=np.uint8)
    crc = 0x12345678
    lo = int(word[:4].view("<u4")[0]) ^ crc
    hi = int(word[4:].view("<u4")[0])
    sliced = 0
    for k in range(4):
        sliced ^= int(t[7 - k][(lo >> (8 * k)) & 0xFF]) ^ int(t[3 - k][(hi >> (8 * k)) & 0xFF])
    assert sliced == jax_checksum._crc_raw_bytes(bytes(word), POLY, crc)
    cols = checksum.tree_columns(POLY, 64, crc_cuda.LEVELS)
    for lvl in range(crc_cuda.LEVELS):
        assert tuple(int(c) for c in cols[lvl]) == jax_checksum._zero_op_power(POLY, 64 << lvl)
    assert crc_cuda.chunk_for(262144) == 512
    assert crc_cuda.chunk_for(512) == 8
    assert crc_cuda.THREADS * crc_cuda.chunk_for(1280) >= 1280
