"""Kernels K2 and K3: TLZ encode plane decisions and the fused decode + CRC.

- :func:`plane_decisions` (``csrc/tlz_planes.cu``) replaces the JAX
  package's Pallas ``_make_planes_kernel``
  (``s3shuffle_tpu/ops/tlz_pallas.py:77``). Bound on an H100: bytes — one
  read of the (B, G*8) rows and the (B, G) candidates, one write of five
  (B, G) planes (46 MiB for a 64 x 256 KiB batch, ~14 µs at 3.35 TB/s).
  A 256 KiB row does not fit in shared memory, so each CTA takes a tile of
  groups and reads the row from global memory (L2-resident); only the tile's
  decision planes live in shared memory.
- :func:`decode_fused` (``csrc/tlz_decode_fused.cu``) replaces the Pallas
  ``_make_decode_fused_kernel`` (``s3shuffle_tpu/ops/tlz_pallas.py:230``).
  Bound: bytes — planes, literals and decoded rows cross device memory once.
  One CTA per row resolves the source map by pointer jumping over a global
  scratch (the map of a 256 KiB row is 1 MiB, beyond shared memory) and
  folds the literal-plane CRC with K1's block function.

Each wrapper takes the plain PyTorch version in ``ops/tlz.py`` for a tensor
on the CPU; for a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import torch

from s3shuffle_tpu_torch.ops import _build, tlz
from s3shuffle_tpu_torch.ops.crc_cuda import chunk_for, device_tables


def plane_decisions(blocks: torch.Tensor, cand: torch.Tensor, n_groups: int):
    """Full decision planes (is_match, is_cont, is_split: (B, G) bool;
    dists, ks: (B, G) int32) of (B, G*8) uint8 blocks and their (B, G) int32
    candidate positions (each in [-1, G*8 - 8])."""
    if blocks.device.type == "cpu":
        return tlz.plane_decisions_plain(blocks, cand, n_groups)
    b = blocks.shape[0]
    _build.require_cuda("blocks", blocks, torch.uint8, (b, n_groups * tlz.GROUP))
    _build.require_cuda("cand", cand, torch.int32, (b, n_groups))
    dev = blocks.device
    is_match = torch.empty((b, n_groups), dtype=torch.bool, device=dev)
    is_cont = torch.empty_like(is_match)
    is_split = torch.empty_like(is_match)
    dists = torch.empty((b, n_groups), dtype=torch.int32, device=dev)
    ks = torch.empty_like(dists)
    if b:
        rc = _build.library().tlz_planes_launch(
            blocks.data_ptr(), cand.data_ptr(), b, n_groups,
            is_match.data_ptr(), is_cont.data_ptr(), is_split.data_ptr(),
            dists.data_ptr(), ks.data_ptr(), _build.stream_ptr(dev),
        )
        _build.check(rc, "tlz_planes")
        _build.LAUNCHES["tlz_planes"] += 1
    return is_match, is_cont, is_split, dists, ks


def decode_fused(is_match, is_cont, is_split, offs_padded, ks_padded, lits_padded,
                 n_lits, n_groups: int, poly: int):
    """Decoded (B, G*8) uint8 rows and (B,) int64 raw CRC remainders of the
    literal planes (see :func:`~s3shuffle_tpu_torch.ops.tlz.decode_fused_plain`
    for the contract). The kernel recomputes ``n_lits`` from the bitmaps."""
    if is_match.device.type == "cpu":
        return tlz.decode_fused_plain(
            is_match, is_cont, is_split, offs_padded, ks_padded, lits_padded,
            n_lits, n_groups, poly,
        )
    b = is_match.shape[0]
    n_bytes = n_groups * tlz.GROUP
    for name, t, dtype, shape in (
        ("is_match", is_match, torch.bool, (b, n_groups)),
        ("is_cont", is_cont, torch.bool, (b, n_groups)),
        ("is_split", is_split, torch.bool, (b, n_groups)),
        ("offs_padded", offs_padded, torch.int32, (b, n_groups)),
        ("ks_padded", ks_padded, torch.int32, (b, n_groups)),
        ("lits_padded", lits_padded, torch.uint8, (b, n_bytes)),
    ):
        _build.require_cuda(name, t, dtype, shape)
    dev = is_match.device
    chunk = chunk_for(n_bytes)
    tab8, cols = device_tables(poly, chunk, dev)
    scratch_src = torch.empty((b, 2, n_bytes), dtype=torch.int32, device=dev)
    scratch_sparse = torch.empty((b, n_bytes), dtype=torch.uint8, device=dev)
    decoded = torch.empty((b, n_bytes), dtype=torch.uint8, device=dev)
    crc = torch.empty(b, dtype=torch.int64, device=dev)
    if b:
        rc = _build.library().tlz_decode_fused_launch(
            is_match.data_ptr(), is_cont.data_ptr(), is_split.data_ptr(),
            offs_padded.data_ptr(), ks_padded.data_ptr(), lits_padded.data_ptr(),
            b, n_groups, chunk, tab8.data_ptr(), cols.data_ptr(),
            scratch_src.data_ptr(), scratch_sparse.data_ptr(),
            decoded.data_ptr(), crc.data_ptr(), _build.stream_ptr(dev),
        )
        _build.check(rc, "tlz_decode_fused")
        _build.LAUNCHES["tlz_decode_fused"] += 1
    return decoded, crc
