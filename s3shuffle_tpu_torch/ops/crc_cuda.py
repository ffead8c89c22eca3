"""Kernel K1: batched raw CRC32/CRC32C remainders on the GPU.

Replaces the JAX package's Pallas kernel ``_crc_fold_kernel``
(``s3shuffle_tpu/ops/crc_pallas.py:68``), which walks each row in 128-byte
tiles as int8 MXU bit-matrix products. Hopper has no reason for the matrix
shape: ``csrc/crc_fold.cu`` gives each row one CTA of 512 threads; every
thread takes a table CRC (slicing-by-8, tables in shared memory) of one
contiguous chunk of the row, and the 512 chunk remainders fold in a 9-level
tree with the GF(2) "advance by n zero bytes" operators — the same
remainders as the tile fold.

Bound on an H100: the bytes. Each input byte is read once and the
arithmetic is a few table lookups per 8 bytes, so a (128, 262144) batch
(32 MiB) needs at least ~10 µs at 3.35 TB/s. The design reads each byte
once (8-byte loads) and keeps every table in shared memory.

Contract: raw zero-init remainders. Without ``lengths`` each whole row is
one message (right-aligned staging; front zero padding is free); with
``lengths`` row r's message is its first ``lengths[r]`` bytes. The true CRC
is ``raw ^ zero_run_crcs(poly, L)[n]`` on the host.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from s3shuffle_tpu_torch.ops import _build
from s3shuffle_tpu_torch.ops.checksum import crc_raw_plain, slice8_tables, tree_columns

#: threads per CTA of the CRC fold (csrc/crc_common.cuh: CRC_NT)
THREADS = 512
#: tree levels of the chunk combine: log2(THREADS)
LEVELS = 9


def chunk_for(width: int) -> int:
    """Bytes per thread so that THREADS chunks cover ``width`` bytes; a
    multiple of 8 (the slicing-by-8 step)."""
    per = -(-width // THREADS)
    return max(8, -(-per // 8) * 8)


@functools.lru_cache(maxsize=32)
def device_tables(poly: int, chunk: int, device: torch.device):
    """(slicing-by-8 tables (8, 256), tree operators (LEVELS, 32)) as int32
    tensors on ``device`` (uint32 bit patterns)."""
    tab8 = torch.from_numpy(slice8_tables(poly).view(np.int32).copy()).to(device)
    cols = torch.from_numpy(tree_columns(poly, chunk, LEVELS).view(np.int32).copy())
    return tab8, cols.to(device)


def crc_raw(rows: torch.Tensor, poly: int, lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Raw zero-init CRC remainders of (R, L) uint8 rows → (R,) int64.

    A CPU tensor takes the plain PyTorch version
    (:func:`~s3shuffle_tpu_torch.ops.checksum.crc_raw_plain`); a CUDA tensor
    launches kernel K1 or raises."""
    if rows.device.type == "cpu":
        return crc_raw_plain(rows, poly, lengths)
    n_rows, width = rows.shape
    _build.require_cuda("rows", rows, torch.uint8)
    if width % 8:
        raise ValueError(f"row width {width} must be a multiple of 8")
    if lengths is not None:
        _build.require_cuda("lengths", lengths, torch.int32, (n_rows,))
    chunk = chunk_for(width)
    tab8, cols = device_tables(poly, chunk, rows.device)
    out = torch.empty(n_rows, dtype=torch.int64, device=rows.device)
    if n_rows:
        lib = _build.library()
        rc = lib.crc_fold_launch(
            rows.data_ptr(), n_rows, width,
            lengths.data_ptr() if lengths is not None else None,
            chunk, tab8.data_ptr(), cols.data_ptr(), out.data_ptr(),
            _build.stream_ptr(rows.device),
        )
        _build.check(rc, "crc_fold")
        _build.LAUNCHES["crc_fold"] += 1
    return out
