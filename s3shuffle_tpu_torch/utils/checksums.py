"""CPU checksum algorithms with a streaming interface.

Copied from the JAX package's ``utils/checksums.py`` (ADLER32 and CRC32 via
zlib, CRC32C as the port's extension). The JAX package backs CRC32C with its
native C library. The port never loads that library; it builds its own
(``codec/native.py``), whose SSE4.2 CRC32C serves ``ops.checksum.host_crc``
and the codec batch layer's stitches (``ops.checksum.stitch_crcs``). This
module's CRC32C, the streaming :class:`Crc32C` and the route of those two
wherever the library does not build or load, is :func:`crc32c` — a
vectorized numpy table CRC, and the oracle the native one is tested
against:

- the message is cut into 64-byte chunks (front-padded with zeros, which
  leave a zero-init register at zero); each chunk's zero-init remainder is
  one gather from a per-position table plus an xor-reduce;
- the chunk remainders fold pairwise in a log-depth tree with the "advance
  by n zero bytes" operator, applied through four byte tables;
- a running value enters by xoring its register into the first four message
  bytes (a reflected CRC's state and its next four input bytes combine the
  same way).

Equal to the byte-serial :func:`crc32c_py` for every input (tested).
"""

from __future__ import annotations

import functools
import zlib

import numpy as np

_POLY_CRC32C = 0x82F63B78
#: chunk width of the vectorized CRC32C
_CHUNK = 64
#: below this many bytes the byte-serial loop is faster than numpy dispatch
_SMALL = 64


class Checksum:
    """Streaming checksum: update(bytes) / value / reset."""

    name = "NONE"

    def update(self, data: bytes) -> None:
        raise NotImplementedError

    @property
    def value(self) -> int:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError


class Adler32(Checksum):
    name = "ADLER32"

    def __init__(self) -> None:
        self._value = 1

    def update(self, data: bytes) -> None:
        self._value = zlib.adler32(data, self._value)

    @property
    def value(self) -> int:
        return self._value & 0xFFFFFFFF

    def reset(self) -> None:
        self._value = 1


class Crc32(Checksum):
    name = "CRC32"

    def __init__(self) -> None:
        self._value = 0

    def update(self, data: bytes) -> None:
        self._value = zlib.crc32(data, self._value)

    @property
    def value(self) -> int:
        return self._value & 0xFFFFFFFF

    def reset(self) -> None:
        self._value = 0


# --- CRC32C (Castagnoli, reflected poly 0x82F63B78) -------------------------


@functools.lru_cache(maxsize=None)
def _crc32c_table() -> tuple:
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ _POLY_CRC32C if crc & 1 else crc >> 1
        table.append(crc)
    return tuple(table)


def crc32c_py(data: bytes, value: int = 0) -> int:
    """Byte-serial reference CRC32C."""
    crc = value ^ 0xFFFFFFFF
    table = _crc32c_table()
    for b in bytes(data):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def _position_table() -> np.ndarray:
    """(CHUNK, 256) uint32: the zero-init remainder contribution of byte
    value b at position p of a CHUNK-byte chunk."""
    table = np.array(_crc32c_table(), dtype=np.uint32)
    out = np.zeros((_CHUNK, 256), dtype=np.uint32)
    out[_CHUNK - 1] = table
    for p in range(_CHUNK - 2, -1, -1):
        prev = out[p + 1]
        out[p] = table[(prev & np.uint32(0xFF)).astype(np.int64)] ^ (prev >> np.uint32(8))
    return out


@functools.lru_cache(maxsize=64)
def _advance_tables(level: int) -> np.ndarray:
    """(4, 256) uint32 byte tables of ``A^(CHUNK * 2^level)``: the operator
    applied to v is the xor of ``tab[i][(v >> 8i) & 0xFF]`` over i."""
    from s3shuffle_tpu_torch.ops.checksum import _zero_op_power

    cols = np.array(_zero_op_power(_POLY_CRC32C, _CHUNK << level), dtype=np.uint32)
    byte_vals = np.arange(256, dtype=np.uint32)
    tabs = np.zeros((4, 256), dtype=np.uint32)
    for i in range(4):
        for bit in range(8):
            sel = ((byte_vals >> np.uint32(bit)) & 1).astype(bool)
            tabs[i, sel] ^= cols[8 * i + bit]
    return tabs


def crc32c(data, value: int = 0) -> int:
    """CRC32C of ``data`` continuing from the running CRC ``value`` (the
    ``zlib.crc32`` calling convention)."""
    mv = memoryview(data).cast("B") if not isinstance(data, bytes) else data
    n = len(mv)
    if n < _SMALL:
        return crc32c_py(bytes(mv), value)
    n_chunks = -(-n // _CHUNK)
    n_chunks = 1 << (n_chunks - 1).bit_length()  # pow2: extra chunks are zeros
    buf = np.zeros(n_chunks * _CHUNK, dtype=np.uint8)
    start = n_chunks * _CHUNK - n
    buf[start:] = np.frombuffer(mv, dtype=np.uint8)
    reg = (value ^ 0xFFFFFFFF) & 0xFFFFFFFF
    buf[start : start + 4] ^= np.array([reg], dtype="<u4").view(np.uint8)
    chunks = buf.reshape(n_chunks, _CHUNK)
    rem = np.bitwise_xor.reduce(
        _position_table()[np.arange(_CHUNK)[None, :], chunks], axis=1
    )
    level = 0
    while len(rem) > 1:
        left = rem[0::2]
        tabs = _advance_tables(level)
        adv = (
            tabs[0][left & 0xFF]
            ^ tabs[1][(left >> 8) & 0xFF]
            ^ tabs[2][(left >> 16) & 0xFF]
            ^ tabs[3][left >> 24]
        )
        rem = adv ^ rem[1::2]
        level += 1
    return int(rem[0]) ^ 0xFFFFFFFF


class Crc32C(Checksum):
    name = "CRC32C"

    def __init__(self) -> None:
        self._value = 0

    def update(self, data: bytes) -> None:
        self._value = crc32c(data, self._value)

    @property
    def value(self) -> int:
        return self._value & 0xFFFFFFFF

    def reset(self) -> None:
        self._value = 0


def create_checksum(algorithm: str) -> Checksum:
    """Factory; unknown algorithms raise (the reference's
    S3ShuffleHelper.createChecksumAlgorithm)."""
    algo = algorithm.upper()
    if algo == "ADLER32":
        return Adler32()
    if algo == "CRC32":
        return Crc32()
    if algo == "CRC32C":
        return Crc32C()
    raise ValueError(f"Unsupported checksum algorithm: {algorithm}")
