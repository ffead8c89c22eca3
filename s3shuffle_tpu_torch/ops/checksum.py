"""CRC32 / CRC32C helpers: the host GF(2) machinery and the plain PyTorch
raw-remainder CRC.

Host half (copied from the JAX package's ``ops/checksum.py``): a reflected
CRC register is GF(2)-linear in (state, data), so

- ``crc_combine`` stitches ``crc(A || B)`` from ``crc(A)``, ``crc(B)`` and
  ``len(B)`` with the "advance by n zero bytes" operator ``A^n``;
- a zero-init *raw remainder* of a front-zero-padded row equals that of the
  row without its padding (zeros from state 0 stay at state 0), and the
  0xFFFFFFFF init + final xor add exactly ``crc(0^n)``, so
  ``crc(data) = raw(data) ^ zero_run_crcs(poly, L)[len(data)]``.

Device half: :func:`crc_raw_plain` computes the raw zero-init remainders of a
batch of rows with plain PyTorch ops — the reference the CRC kernel
(``ops/crc_cuda.py``, kernel K1) is held against, and the path the CPU takes.
Per 128-byte tile the remainder is a bit-matrix product mod 2; the tiles of
a row then fold pairwise in a log-depth tree with the advance operator of
the left part's successor length.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

POLY_CRC32 = 0xEDB88320  # zlib / java.util.zip.CRC32
POLY_CRC32C = 0x82F63B78  # Castagnoli

#: tile width of the plain formulation (bytes per bit-matrix product)
_TILE = 128


# ---------------------------------------------------------------------------
# Host-side GF(2) machinery
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _crc_table(poly: int) -> np.ndarray:
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table[i] = crc
    return table


def crc_combine(crc1: int, crc2: int, len2: int, poly: int = POLY_CRC32) -> int:
    """crc(A || B) from crc(A), crc(B), len(B).

    Because init == final-xor == 0xFFFFFFFF, the init terms cancel and the
    identity collapses to ``crc(A||B) = Z^{len2}(crc1) ⊕ crc2`` where Z is the
    process-one-zero-byte linear operator. ``Z^{len2}`` is applied as the
    product of the cached ``Z^(2^k)`` for the set bits k of len2, each
    through four byte tables (the powers of Z commute), so a combine costs a
    few dozen table lookups whatever the length."""
    tables = _pow2_tables(poly)
    value, k = crc1, 0
    while len2:
        if len2 & 1:
            t0, t1, t2, t3 = tables[k]
            value = (
                t0[value & 0xFF] ^ t1[(value >> 8) & 0xFF]
                ^ t2[(value >> 16) & 0xFF] ^ t3[value >> 24]
            )
        len2 >>= 1
        k += 1
    return value ^ crc2


@functools.lru_cache(maxsize=None)
def _pow2_tables(poly: int) -> tuple:
    """For k in [0, 48): four 256-entry byte tables of ``Z^(2^k)``."""
    out = []
    cols = _zero_op_matrix(poly)
    for _ in range(48):
        tabs = []
        for byte in range(4):
            base = cols[8 * byte : 8 * byte + 8]
            tab = [0] * 256
            for v in range(1, 256):
                low = v & -v
                tab[v] = tab[v ^ low] ^ base[low.bit_length() - 1]
            tabs.append(tuple(tab))
        out.append(tuple(tabs))
        cols = _mat_mul(cols, cols)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _zero_op_matrix(poly: int) -> tuple:
    """The 'process one zero byte' linear operator as 32 uint32 columns."""
    table = _crc_table(poly)
    cols = []
    for bit in range(32):
        s = 1 << bit
        cols.append(int(table[s & 0xFF]) ^ (s >> 8))
    return tuple(cols)


def _mat_mul(a: tuple, b: tuple) -> tuple:
    return tuple(_mat_apply(a, col) for col in b)


def _mat_apply(mat: tuple, value: int) -> int:
    out = 0
    bit = 0
    while value:
        if value & 1:
            out ^= mat[bit]
        value >>= 1
        bit += 1
    return out


@functools.lru_cache(maxsize=4096)
def _zero_op_power_cached(poly: int, n: int) -> tuple:
    return _mat_power(_zero_op_matrix(poly), n)


def _zero_op_power(poly: int, n: int) -> tuple:
    """``A^n`` — advance a CRC register by ``n`` zero bytes — as 32 uint32
    columns (column i is the operator applied to ``1 << i``)."""
    return _zero_op_power_cached(poly, n)


def _mat_power(mat: tuple, n: int) -> tuple:
    result = tuple(1 << i for i in range(32))  # identity
    base = mat
    while n:
        if n & 1:
            result = _mat_mul(base, result)
        base = _mat_mul(base, base)
        n >>= 1
    return result


_zero_lock = threading.Lock()
_zero_cache: dict = {}


def zero_run_crcs(poly: int, length: int) -> np.ndarray:
    """Host-side fixup table: ``crc(0^n)`` for ``n in [0, length]`` (full
    init/final-xor semantics). Raw zero-init remainders from the device
    become true CRCs via ``raw ^ zero_run_crcs(poly, L)[n]``."""
    key = (poly, length)
    with _zero_lock:
        hit = _zero_cache.get(key)
    if hit is not None:
        return hit
    table = _crc_table(poly)
    zero_crc = np.zeros(length + 1, dtype=np.uint32)
    state = 0xFFFFFFFF
    for n in range(1, length + 1):
        state = int(table[state & 0xFF]) ^ (state >> 8)
        zero_crc[n] = state ^ 0xFFFFFFFF
    with _zero_lock:
        _zero_cache[key] = zero_crc
    return zero_crc


def host_crc(data, poly: int) -> int:
    """Full-algorithm HOST CRC for the two supported reflected polynomials —
    the small-slice companion of the fused device kernels (frame headers and
    TLZ metadata prefixes get hashed here and stitched around the device
    remainders with :func:`crc_combine`)."""
    if poly == POLY_CRC32:
        import zlib

        return zlib.crc32(data) & 0xFFFFFFFF
    if poly == POLY_CRC32C:
        from s3shuffle_tpu_torch.utils.checksums import crc32c

        return crc32c(data)
    raise ValueError(f"no host CRC for poly {poly:#x}")


def stage_right_aligned(chunks, block_len: int | None = None):
    """Stage a list of byte strings into a right-aligned (B, L) uint8 batch.
    Returns (batch, lengths)."""
    lengths = np.array([len(c) for c in chunks], dtype=np.int64)
    length = block_len or (int(lengths.max()) if len(chunks) else 0)
    if len(lengths) and int(lengths.max()) > length:
        raise ValueError("chunk longer than block_len")
    batch = np.zeros((len(chunks), length), dtype=np.uint8)
    for i, c in enumerate(chunks):
        if len(c):
            batch[i, length - len(c):] = np.frombuffer(c, dtype=np.uint8)
    return batch, lengths


def tree_columns(poly: int, chunk: int, levels: int) -> np.ndarray:
    """(levels, 32) uint32: ``A^(chunk * 2^l)`` for l in [0, levels) — the
    operators of a log-depth pairwise combine of equal ``chunk``-byte
    remainders. Built by repeated squaring of ``A^chunk``."""
    out = np.zeros((levels, 32), dtype=np.uint32)
    cols = _zero_op_power(poly, chunk)
    for lvl in range(levels):
        out[lvl] = cols
        cols = _mat_mul(cols, cols)
    return out


def power_columns(poly: int, span: int, count: int) -> np.ndarray:
    """(count, 32) uint32: ``A^(span * j)`` for j in [0, count) — the
    operators that place ``count`` consecutive ``span``-byte remainders of
    one message before its end (row 0 is the identity)."""
    out = np.zeros((count, 32), dtype=np.uint32)
    step = _zero_op_power(poly, span)
    cols = tuple(1 << i for i in range(32))
    for j in range(count):
        out[j] = cols
        cols = _mat_mul(step, cols)
    return out


@functools.lru_cache(maxsize=None)
def slice8_tables(poly: int) -> np.ndarray:
    """(8, 256) uint32 slicing-by-8 tables: ``T[0]`` is the byte table and
    ``T[k][i] = (T[k-1][i] >> 8) ^ T[0][T[k-1][i] & 0xFF]`` — the remainder
    contribution of byte ``i`` followed by ``k`` zero bytes."""
    t = np.zeros((8, 256), dtype=np.uint32)
    t[0] = _crc_table(poly)
    for k in range(1, 8):
        prev = t[k - 1]
        t[k] = (prev >> np.uint32(8)) ^ t[0][(prev & np.uint32(0xFF)).astype(np.int64)]
    return t


# ---------------------------------------------------------------------------
# Plain PyTorch raw remainders (the reference for kernel K1)
# ---------------------------------------------------------------------------


def _bit_matrix(cols) -> np.ndarray:
    """32 operator columns → (32, 32) 0/1 matrix M with
    ``new_bits = state_bits @ M`` (row i = bits of the column for 1 << i)."""
    cols = np.asarray(cols, dtype=np.uint32)
    return ((cols[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1).astype(
        np.float32
    )


@functools.lru_cache(maxsize=None)
def _tile_weights(poly: int) -> np.ndarray:
    """(TILE*8, 32) 0/1 weights: row ``j*8 + k`` holds the raw-remainder
    contribution of bit ``k`` of byte ``j`` of one TILE-byte tile."""
    table = _crc_table(poly)
    vec = table[(1 << np.arange(8)).astype(np.int64)].astype(np.uint32)
    w = np.zeros((_TILE, 8), dtype=np.uint32)
    for d in range(_TILE):  # d = distance of the byte from the tile's end
        w[_TILE - 1 - d] = vec
        vec = (vec >> np.uint32(8)) ^ table[(vec & np.uint32(0xFF)).astype(np.int64)]
    bits = (w[:, :, None] >> np.arange(32, dtype=np.uint32)[None, None, :]) & 1
    return bits.reshape(_TILE * 8, 32).astype(np.float32)


def right_align(rows: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Front-aligned rows (the first ``lengths[r]`` bytes of row r are the
    data) → right-aligned rows with zero front padding."""
    n_rows, width = rows.shape
    pos = torch.arange(width, device=rows.device)
    src = pos[None, :] - (width - lengths.to(rows.device, torch.int64))[:, None]
    gathered = torch.gather(rows, 1, src.clamp(min=0))
    return torch.where(src >= 0, gathered, torch.zeros_like(gathered))


def crc_raw_plain(rows: torch.Tensor, poly: int,
                  lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Raw zero-init CRC remainders of (R, L) uint8 rows as an (R,) int64
    tensor. Without ``lengths`` each whole row is one message (right-aligned
    staging: front zero padding is free); with ``lengths`` row r's message is
    its first ``lengths[r]`` bytes."""
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise ValueError("rows must be a (R, L) uint8 tensor")
    dev = rows.device
    if lengths is not None:
        rows = right_align(rows, lengths)
    n_rows, width = rows.shape
    n_tiles = max(1, -(-width // _TILE))
    padded_tiles = 1 << (n_tiles - 1).bit_length()
    pad = padded_tiles * _TILE - width
    if pad:
        rows = torch.cat(
            [torch.zeros((n_rows, pad), dtype=torch.uint8, device=dev), rows], dim=1
        )
    shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    bits = ((rows[:, :, None] >> shifts) & 1).to(torch.float32)
    bits = bits.reshape(n_rows, padded_tiles, _TILE * 8)
    weights = torch.from_numpy(_tile_weights(poly)).to(dev)
    state = torch.remainder(bits @ weights, 2)  # (R, T, 32) tile remainders
    span = _TILE
    while state.shape[1] > 1:
        adv = torch.from_numpy(_bit_matrix(_zero_op_power(poly, span))).to(dev)
        state = torch.remainder(state[:, 0::2] @ adv + state[:, 1::2], 2)
        span *= 2
    bit_w = torch.tensor([1 << i for i in range(32)], dtype=torch.int64, device=dev)
    return (state[:, 0].to(torch.int64) * bit_w).sum(dim=1)
