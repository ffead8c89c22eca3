"""Kernels K2 and K3: TLZ encode plane decisions and the fused decode + CRC.

- :func:`plane_decisions` (``csrc/tlz_planes.cu``) replaces the JAX
  package's Pallas ``_make_planes_kernel``
  (``s3shuffle_tpu/ops/tlz_pallas.py:77``). Bound on an H100: bytes — one
  read of the (B, G*8) rows and the (B, G) candidates, one write of five
  (B, G) planes (46 MiB for a 64 x 256 KiB batch, ~14 µs at 3.35 TB/s).
  One warp takes a tile of 124 groups of one row, four per lane, its last
  lane the tile's halo; neighbours' entries move by shuffles, source
  windows come from L2, each group reuses the last window it loaded, and
  the split tier compares whole words.
- :func:`decode_fused` (``csrc/tlz_decode_fused.cu``) replaces the Pallas
  ``_make_decode_fused_kernel`` (``s3shuffle_tpu/ops/tlz_pallas.py:230``).
  Bound: bytes — planes, literals and decoded rows cross device memory once
  (~8 µs for a 64 x 32768-group TeraSort batch). Each row is cut into
  segments of :data:`SEG_GROUPS` groups (16 KiB), one CTA each (1024 CTAs
  for that batch, two per SM: ~99 KiB of shared memory and at most 64
  registers a thread). A count launch gives every segment its starting
  ranks; the segment CTA resolves its bytes' sources by pointer jumping in
  shared memory and reads the sources that lie in earlier segments back
  from the decoded row once those segments have published (release/acquire
  flags, tickets taken in segment-major order so a CTA only waits on CTAs
  already running). Each CTA also takes the CRC of its slice of the
  literal plane with kernel K1's segment CRC (``ops/crc_cuda.py``); the
  row's last CTA folds the slices. That route is exact
  for rows whose sources all lie at or before their position — every row
  the parser stages. A row with a negative stored distance (forward
  pointers, cycles, int32 wraps) takes the general route in a third launch:
  one CTA per row, whole-row pointer jumping over a global map in one of
  :data:`GEN_SLOTS` scratch slots, with the reference's rounds and early
  exit. :func:`general_route_rows` counts those rows on the device.

Each wrapper takes the plain PyTorch version in ``ops/tlz.py`` for a tensor
on the CPU; for a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import torch

from s3shuffle_tpu_torch.ops import _build, crc_cuda, tlz

#: groups per segment of kernel K3 (csrc/tlz_decode_fused.cu: SEG_GROUPS)
SEG_GROUPS = 2048
#: scratch rows of K3's general route (one CTA and one int32 map each)
GEN_SLOTS = 4
#: int32 words of K3's call state: header, then per row an arrival counter
#: and a general-route list entry, then 8 words per (row, segment)
_STATE_HEADER = 4
_RECORD_WORDS = 8

#: device → (1,) int64 count of rows K3 decoded by its general route
_general_rows: dict = {}


def plane_decisions(blocks: torch.Tensor, cand: torch.Tensor, n_groups: int):
    """Full decision planes (is_match, is_cont, is_split: (B, G) bool;
    dists, ks: (B, G) int32) of (B, G*8) uint8 blocks and their (B, G) int32
    candidate positions (each in [-1, G*8 - 8]). The kernel takes G a
    multiple of 4 and rows below 2**31 bytes."""
    if blocks.device.type == "cpu":
        return tlz.plane_decisions_plain(blocks, cand, n_groups)
    b = blocks.shape[0]
    if n_groups % 4 or n_groups * tlz.GROUP >= 2**31:
        raise ValueError(f"K2 takes a multiple of 4 groups below 2**28, got {n_groups}")
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
        _build.count_launch("tlz_planes")
    return is_match, is_cont, is_split, dists, ks


def decode_layout(n_rows: int, n_groups: int):
    """K3's cut of a (n_rows, n_groups) batch: (groups per segment, segments
    per row, int32 words of call state)."""
    seg_groups = min(SEG_GROUPS, n_groups)
    n_seg = -(-n_groups // seg_groups)
    words = _STATE_HEADER + 2 * n_rows + _RECORD_WORDS * n_rows * n_seg
    return seg_groups, n_seg, words


def _general_counter(device: torch.device) -> torch.Tensor:
    key = torch.device(device.type, device.index if device.index is not None
                       else torch.cuda.current_device())
    counter = _general_rows.get(key)
    if counter is None:  # setdefault: concurrent first calls share one counter
        counter = _general_rows.setdefault(key, torch.zeros(1, dtype=torch.int64, device=key))
    return counter


def general_route_rows(device="cuda") -> int:
    """Rows K3 decoded by its general route on ``device`` since the last
    :func:`reset_general_route_rows` (reading it synchronises)."""
    return int(_general_counter(torch.device(device)).item())


def reset_general_route_rows() -> None:
    for counter in _general_rows.values():
        counter.zero_()


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
    seg_groups, n_seg, words = decode_layout(b, n_groups)
    tab8, nib = crc_cuda.device_tables(poly, dev)
    seg_cols = crc_cuda.segment_columns(poly, seg_groups * tlz.GROUP, n_seg, dev)
    state = torch.empty(words, dtype=torch.int32, device=dev)  # set by the count launch
    slots = min(GEN_SLOTS, b)
    scratch = torch.empty((slots, n_bytes), dtype=torch.int32, device=dev)
    counter = _general_counter(dev)
    decoded = torch.empty((b, n_bytes), dtype=torch.uint8, device=dev)
    crc = torch.empty(b, dtype=torch.int64, device=dev)
    if b:
        rc = _build.library().tlz_decode_fused_launch(
            is_match.data_ptr(), is_cont.data_ptr(), is_split.data_ptr(),
            offs_padded.data_ptr(), ks_padded.data_ptr(), lits_padded.data_ptr(),
            b, n_groups, tab8.data_ptr(), nib.data_ptr(), seg_cols.data_ptr(),
            state.data_ptr(), words, scratch.data_ptr(), slots, counter.data_ptr(),
            decoded.data_ptr(), crc.data_ptr(), _build.stream_ptr(dev),
        )
        _build.check(rc, "tlz_decode_fused")
        _build.count_launch("tlz_decode_fused")
    return decoded, crc
