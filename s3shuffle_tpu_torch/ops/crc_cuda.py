"""Kernel K1: batched raw CRC32/CRC32C remainders on the GPU.

Replaces the JAX package's Pallas kernel ``_crc_fold_kernel``
(``s3shuffle_tpu/ops/crc_pallas.py:68``), which walks each row in 128-byte
tiles as int8 MXU bit-matrix products. Hopper has no reason for the matrix
shape: ``csrc/crc_fold.cu`` places each row's message right-aligned in a
window of :data:`SEG_BYTES`-byte segments (:func:`segment_count` per row)
and gives each segment that holds message bytes to one CTA
(:func:`segment_spans`): :data:`THREADS` threads take slicing-by-8 table
CRCs of :data:`CHUNK`-byte chunks of the staged segment and fold them in a
:data:`LEVELS`-level tree of GF(2) "advance by n zero bytes" operators
(applied through :func:`nibble_tables`); the
row's last segment CTA folds the segment remainders with ``A^(SEG_BYTES *
j)`` (:func:`segment_columns`). Kernel K3 takes its literal-plane CRC with
the same code (``csrc/crc_common.cuh``).

Bound on an H100: the bytes. Each message byte is read once and the
arithmetic is a few table lookups per 8 bytes, so the main path's batch (64
raw 256 KiB blocks and 64 literal planes) needs at least ~6 µs at
3.35 TB/s.

Contract: raw zero-init remainders. Without ``lengths`` each whole row is
one message (right-aligned staging; front zero padding is free); with
``lengths`` row r's message is its first ``lengths[r]`` bytes. The true CRC
is ``raw ^ zero_run_crcs(poly, L)[n]`` on the host. :func:`crc_raw_pair`
takes two row sets of one width in one launch, as :func:`crc_raw` would
take their concatenation.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from s3shuffle_tpu_torch.ops import _build
from s3shuffle_tpu_torch.ops.checksum import (
    crc_raw_plain,
    power_columns,
    slice8_tables,
    tree_columns,
)

#: bytes per segment (csrc/crc_common.cuh: CRC_SEG)
SEG_BYTES = 16384
#: walking threads per segment CTA (CRC_NT)
THREADS = 128
#: bytes per thread's table CRC (CRC_CHUNK)
CHUNK = SEG_BYTES // THREADS
#: tree levels of the chunk combine: log2(THREADS)
LEVELS = 7

#: (device, stream) → int32 per-row arrival counters of K1 launches on that
#: stream (zero between launches: the folding CTA resets its row's)
_counters: dict = {}


def segment_count(width: int) -> int:
    """Segments of :data:`SEG_BYTES` bytes in the window of a row of
    ``width`` bytes (at least one)."""
    return max(1, -(-width // SEG_BYTES))


def segment_spans(lengths: torch.Tensor, n_seg: int, seg_bytes: int = SEG_BYTES):
    """Where each segment's CTA works, for messages of ``lengths`` bytes
    right-aligned in ``n_seg`` segments: ``(lo, hi, active)``, each (R,
    n_seg). Segment j holds message bytes ``[lo, hi)`` (empty when ``hi <=
    lo``); ``active`` marks the (row, segment) pairs the kernel runs — the
    segments that hold bytes, and the last one of an empty message (its CTA
    reports 0)."""
    lengths = lengths.to(torch.int64).reshape(-1, 1)
    j = torch.arange(n_seg, dtype=torch.int64, device=lengths.device).reshape(1, -1)
    pad = n_seg * seg_bytes - lengths
    hi = (j + 1) * seg_bytes - pad
    lo = (hi - seg_bytes).clamp(min=0)
    expected = (-(-lengths // seg_bytes)).clamp(min=1)
    return lo, hi, j >= n_seg - expected


def nibble_tables(cols: np.ndarray) -> np.ndarray:
    """(L, 32) operator columns → (L, 8, 16) uint32 nibble tables:
    ``A(v) = XOR over k of tab[k][(v >> 4k) & 15]``."""
    x = np.arange(16)
    bits = ((x[:, None] >> np.arange(4)[None, :]) & 1).astype(bool)  # (16, 4)
    quads = cols.reshape(cols.shape[0], 8, 1, 4)
    return np.bitwise_xor.reduce(np.where(bits[None, None], quads, np.uint32(0)), axis=3)


@functools.lru_cache(maxsize=32)
def device_tables(poly: int, device: torch.device):
    """(slicing-by-8 tables (8, 256), the chunk tree's operators as nibble
    tables (LEVELS, 8, 16)) as int32 tensors on ``device`` (uint32 bit
    patterns)."""
    tab8 = torch.from_numpy(slice8_tables(poly).view(np.int32).copy()).to(device)
    nib = nibble_tables(tree_columns(poly, CHUNK, LEVELS)).astype(np.uint32)
    return tab8, torch.from_numpy(nib.view(np.int32).copy()).to(device)


@functools.lru_cache(maxsize=32)
def segment_columns(poly: int, seg_bytes: int, n_seg: int, device: torch.device):
    """(n_seg, 32) int32 operators ``A^(seg_bytes * j)`` on ``device``
    (uint32 bit patterns): the fold of a message's segment remainders."""
    cols = power_columns(poly, seg_bytes, n_seg).view(np.int32).copy()
    return torch.from_numpy(cols).to(device)


def _row_counters(device: torch.device, n_rows: int) -> torch.Tensor:
    key = (device, _build.stream_ptr(device))
    counters = _counters.get(key)
    if counters is None or counters.numel() < n_rows:
        counters = torch.zeros(n_rows, dtype=torch.int32, device=device)
        _counters[key] = counters
    return counters


def _plain_pair(rows, more, poly, lengths, more_lengths):
    def full(t, lens):
        if lens is not None:
            return lens.to(torch.int64)
        return torch.full((t.shape[0],), t.shape[1], dtype=torch.int64, device=t.device)

    return crc_raw_plain(
        torch.cat([rows, more]), poly,
        torch.cat([full(rows, lengths), full(more, more_lengths)]),
    )


def _launch(rows, lengths, more, more_lengths, poly: int) -> torch.Tensor:
    n_a, width = rows.shape
    _build.require_cuda("rows", rows, torch.uint8)
    if width % 8:
        raise ValueError(f"row width {width} must be a multiple of 8")
    if lengths is not None:
        _build.require_cuda("lengths", lengths, torch.int32, (n_a,))
    n_b = 0
    if more is not None:
        n_b = more.shape[0]
        _build.require_cuda("more", more, torch.uint8, (n_b, width))
        if more_lengths is not None:
            _build.require_cuda("more_lengths", more_lengths, torch.int32, (n_b,))
    dev = rows.device
    n_rows = n_a + n_b
    n_seg = segment_count(width)
    out = torch.empty(n_rows, dtype=torch.int64, device=dev)
    if n_rows:
        tab8, nib = device_tables(poly, dev)
        seg_cols = segment_columns(poly, SEG_BYTES, n_seg, dev)
        counters = _row_counters(dev, n_rows)
        partials = torch.empty(n_rows * n_seg, dtype=torch.int32, device=dev)
        rc = _build.library().crc_fold_launch(
            rows.data_ptr(), lengths.data_ptr() if lengths is not None else None, n_a,
            more.data_ptr() if n_b else None,
            more_lengths.data_ptr() if n_b and more_lengths is not None else None, n_b,
            width, n_seg, tab8.data_ptr(), nib.data_ptr(), seg_cols.data_ptr(),
            counters.data_ptr(), partials.data_ptr(), out.data_ptr(), _build.stream_ptr(dev),
        )
        _build.check(rc, "crc_fold")
        _build.count_launch("crc_fold")
    return out


def crc_raw(rows: torch.Tensor, poly: int, lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Raw zero-init CRC remainders of (R, L) uint8 rows → (R,) int64.

    A CPU tensor takes the plain PyTorch version
    (:func:`~s3shuffle_tpu_torch.ops.checksum.crc_raw_plain`); a CUDA tensor
    launches kernel K1 or raises."""
    if rows.device.type == "cpu":
        return crc_raw_plain(rows, poly, lengths)
    return _launch(rows, lengths, None, None, poly)


def crc_raw_pair(rows: torch.Tensor, more: torch.Tensor, poly: int,
                 lengths: torch.Tensor | None = None,
                 more_lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Raw remainders of two row sets of one width in one launch: equal to
    ``crc_raw(torch.cat([rows, more]), poly, <their lengths, each set's
    width where none are given>)``, without building the concatenation on
    the device."""
    if rows.device.type == "cpu":
        return _plain_pair(rows, more, poly, lengths, more_lengths)
    return _launch(rows, lengths, more, more_lengths, poly)
