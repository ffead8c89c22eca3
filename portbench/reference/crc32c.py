"""Plain CRC32C (Castagnoli, reflected polynomial 0x82F63B78, init and
final xor 0xFFFFFFFF), written for the benchmark's reference.

The message is cut into equal lanes (front-padded with zero bytes, which
leave a zero-init register at zero); every lane runs the byte-serial table
update at once as numpy vectors, and the lane remainders are joined in a
tree by the "advance over n zero bytes" operator (a GF(2)-linear map of
the register, kept as four byte tables). The init value enters by
linearity: the register after a message of n bytes is the zero-init
remainder xor the init value advanced over n zero bytes.
"""

from __future__ import annotations

import functools

import numpy as np

POLY = 0x82F63B78
_MASK = np.uint32(0xFF)


def _byte_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ POLY if c & 1 else c >> 1
        table[i] = c
    return table


TABLE = _byte_table()


def crc32c_serial(data: bytes) -> int:
    """Byte-serial CRC32C, one byte at a time."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = int(TABLE[(crc ^ b) & 0xFF]) ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _apply(tabs: np.ndarray, x):
    x = np.asarray(x, dtype=np.uint32)
    return (tabs[0][x & _MASK] ^ tabs[1][(x >> np.uint32(8)) & _MASK]
            ^ tabs[2][(x >> np.uint32(16)) & _MASK] ^ tabs[3][x >> np.uint32(24)])


def _compose(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    """The byte tables of ``p`` applied after ``q``."""
    v = np.arange(256, dtype=np.uint32)
    return np.stack([_apply(p, _apply(q, v << np.uint32(8 * i))) for i in range(4)])


@functools.lru_cache(maxsize=None)
def _one_zero_byte() -> np.ndarray:
    v = np.arange(256, dtype=np.uint32)
    tabs = np.empty((4, 256), dtype=np.uint32)
    for i in range(4):
        x = v << np.uint32(8 * i)
        tabs[i] = TABLE[x & _MASK] ^ (x >> np.uint32(8))
    return tabs


@functools.lru_cache(maxsize=256)
def advance(n: int) -> np.ndarray:
    """Byte tables of the register advanced over ``n`` zero bytes."""
    v = np.arange(256, dtype=np.uint32)
    result = np.stack([v << np.uint32(8 * i) for i in range(4)])  # identity
    base = _one_zero_byte()
    while n:
        if n & 1:
            result = _compose(base, result)
        n >>= 1
        if n:
            base = _compose(base, base)
    return result


def _lane_length(n: int) -> int:
    return max(64, -(-n // 4096))


def crc32c(data) -> int:
    """CRC32C of ``data`` (bytes-like)."""
    buf = np.frombuffer(memoryview(data).cast("B"), dtype=np.uint8)
    n = len(buf)
    if n < 256:
        return crc32c_serial(buf.tobytes())
    m = _lane_length(n)
    lanes = -(-n // m)
    lanes = 1 << (lanes - 1).bit_length()  # a power of two: zero lanes in front
    padded = np.zeros(lanes * m, dtype=np.uint8)
    padded[lanes * m - n:] = buf
    cols = np.ascontiguousarray(padded.reshape(lanes, m).T)
    reg = np.zeros(lanes, dtype=np.uint32)
    for t in range(m):
        reg = TABLE[(reg ^ cols[t]) & _MASK] ^ (reg >> np.uint32(8))
    span = m
    while len(reg) > 1:
        reg = _apply(advance(span), reg[0::2]) ^ reg[1::2]
        span *= 2
    register = int(reg[0]) ^ int(_apply(advance(n), 0xFFFFFFFF))
    return register ^ 0xFFFFFFFF
