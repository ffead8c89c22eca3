"""TLZ v2 — the block-parallel compression format, on PyTorch.

The wire format, the encoder's decisions and every host helper are the JAX
package's (``s3shuffle_tpu/ops/tlz.py``), copied so that frames are byte
for byte the same in both packages:

- a block is cut into 8-byte groups; each group is a literal, a *match* (a
  copy of 8 bytes from ``group_start - distance``, u16 distance), a
  continuation match (same distance as the previous group; no distance
  stored) or a *split literal* (prefix copied at the left neighbour's
  distance, suffix at the right neighbour's; only the split point stored);
- the encoder hashes the 8-byte window at every position, finds each
  group's nearest previous identical window with one stable sort, verifies
  candidates exactly, promotes continuations in two passes and adds the
  split tier;
- the decoder rebuilds a per-byte source map and resolves it by pointer
  jumping.

Wire format of one payload (after the shared 9-byte frame header)::

    [u16le flags+count] bit 15 ⇒ v2; bit 14 ⇒ packed meta; low 14 bits =
                        n_groups mod 16384
    [match bitmap][cont bitmap][split bitmap]   ceil(n_groups/8) bytes each
    [u16le distance × new matches][u8 split point × splits]
    [literal groups × 8 bytes]

With bit 14 the five metadata planes are stored as ``[u32le clen][zlib]``.

Device path of this module (the CUDA kernels live in ``ops/tlz_cuda.py``
and ``ops/crc_cuda.py``; each wrapper takes its plain PyTorch version here
only for a tensor on the CPU):

    encode: candidate search (torch: hash + stable sort) → plane decisions
            (kernel K2) → compaction (torch: cumsum ranks, boolean selection)
            + raw CRCs of the blocks and literal planes (kernel K1)
    decode: host parse + validation → fused decode + literal-plane CRC
            (kernel K3)
"""

from __future__ import annotations

import threading
import time
import zlib
from typing import List, Optional, Tuple

import numpy as np
import torch

GROUP = 8
#: v1 used 16-byte groups; kept for decoding legacy payloads.
_V1_GROUP = 16
#: bit 15 of the leading u16 marks the v2 format.
V2_FLAG = 0x8000
#: bit 14 (v2 only) marks zlib-packed metadata planes.
PACKED_FLAG = 0x4000
#: u16 match distances bound the window a source can reach back.
MAX_DIST = (1 << 16) - 1
#: block-size cap (pointer-jump rounds, sort length and decode maps scale
#: with it).
MAX_BLOCK = 1 << 18
#: deflate level of the packed metadata section (the JAX package's default).
META_PACK_LEVEL = 1

#: independent odd multipliers of the window hash (see the JAX package: a
#: relation between them would make structured data collide constantly).
_MULTS_I64 = np.array(
    [0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F,
     0x165667B1, 0xD3A2646D, 0xFD7046C5, 0xB55A4F09],
    dtype=np.int64,
)

def _jump_rounds(n_bytes: int) -> int:
    return int(np.ceil(np.log2(max(2, n_bytes))))


def _pack_meta(
    bitmap_b: bytes, cont_b: bytes, split_b: bytes, offs_b: bytes,
    ks_b: bytes, n_groups: int, level: int | None = None,
):
    """Header + metadata section, deflated when that shrinks it (and
    ``level`` > 0). Returns the payload prefix (everything before the
    literal plane)."""
    if level is None:
        level = META_PACK_LEVEL
    meta = bitmap_b + cont_b + split_b + offs_b + ks_b
    ng_field = n_groups & 0x3FFF
    if level == 0:
        return np.array([ng_field | V2_FLAG], dtype="<u2").tobytes() + meta
    packed = zlib.compress(meta, level)
    if len(packed) + 4 < len(meta):
        return (
            np.array([ng_field | V2_FLAG | PACKED_FLAG], dtype="<u2").tobytes()
            + np.array([len(packed)], dtype="<u4").tobytes()
            + packed
        )
    return np.array([ng_field | V2_FLAG], dtype="<u2").tobytes() + meta


def _check_block_size(block_size: int) -> None:
    if block_size % (8 * GROUP) != 0:
        raise ValueError("block_size must be a multiple of 64")
    if block_size > MAX_BLOCK:
        raise ValueError("block_size must be <= 256 KiB")


def _bucket_rows(n: int, cap: int) -> int:
    """Launch-shape bucketing: a partial batch pads up to the next power of
    two (capped at the configured batch rows)."""
    if n >= cap:
        return cap
    rows = 1
    while rows < n:
        rows <<= 1
    return min(rows, cap)


# ---------------------------------------------------------------------------
# Encoder stages on torch tensors (B, n_bytes) uint8
# ---------------------------------------------------------------------------


def candidate_math(blocks: torch.Tensor, n_groups: int) -> torch.Tensor:
    """Hash + nearest-previous-identical-window candidate search. Returns
    (B, G) int32 candidate source positions (-1 = none).

    The JAX package hashes in int32 with wraparound; here the multiply-adds
    run in int64 (no overflow: 8 · 255 · 2^32 < 2^43), are masked to 32 bits
    and mapped onto the signed int32 range, so the sort sees the same keys.
    Equal hashes keep position order through a stable sort."""
    b = blocks.shape[0]
    n_bytes = n_groups * GROUP
    n_pos = n_bytes - GROUP + 1
    buf = blocks.to(torch.int64)
    h = torch.zeros((b, n_pos), dtype=torch.int64, device=blocks.device)
    for k in range(GROUP):
        h += buf[:, k : k + n_pos] * int(_MULTS_I64[k])
    h &= 0xFFFFFFFF
    h = torch.where(h >= (1 << 31), h - (1 << 32), h).to(torch.int32)
    h_sorted, order = torch.sort(h, dim=1, stable=True)
    prev_same = torch.zeros((b, n_pos), dtype=torch.bool, device=blocks.device)
    prev_same[:, 1:] = h_sorted[:, 1:] == h_sorted[:, :-1]
    prev_pos = torch.zeros_like(order)
    prev_pos[:, 1:] = order[:, :-1]
    cand_sorted = torch.where(prev_same, prev_pos, torch.full_like(prev_pos, -1))
    # order is a permutation of each row: a scatter with unique indices
    cand = torch.empty_like(order).scatter_(1, order, cand_sorted)
    return cand[:, 0 : n_bytes - GROUP + 1 : GROUP].to(torch.int32).contiguous()


def _shift_right(x: torch.Tensor, fill) -> torch.Tensor:
    """out[:, g] = x[:, g-1], out[:, 0] = fill."""
    out = torch.empty_like(x)
    out[:, 0] = fill
    out[:, 1:] = x[:, :-1]
    return out


def _shift_left(x: torch.Tensor, fill) -> torch.Tensor:
    """out[:, g] = x[:, g+1], out[:, -1] = fill."""
    out = torch.empty_like(x)
    out[:, -1] = fill
    out[:, :-1] = x[:, 1:]
    return out


def plane_decisions_plain(blocks: torch.Tensor, cand: torch.Tensor, n_groups: int):
    """Plain PyTorch match/continuation/split decisions — the reference the
    plane kernel (K2, ``ops/tlz_cuda.py``) is held against, mirroring the JAX
    package's ``_plane_decisions_math`` op for op. Returns FULL planes:
    (is_match bool, is_cont bool, is_split bool, dists int32, ks int32)."""
    b = blocks.shape[0]
    n_bytes = n_groups * GROUP
    dev = blocks.device
    buf = blocks.to(torch.int32)
    lanes = torch.arange(GROUP, dtype=torch.int64, device=dev)
    groups = buf.reshape(b, n_groups, GROUP)
    dest = torch.arange(n_groups, dtype=torch.int64, device=dev) * GROUP
    cand = cand.to(torch.int64)

    def gather(idx):
        flat = idx.clamp(0, n_bytes - 1).reshape(b, -1)
        return torch.gather(buf, 1, flat).reshape(b, n_groups, GROUP)

    def window_at(pos):
        return gather(pos[:, :, None] + lanes)

    safe = cand.clamp(min=0)
    cand_dist = dest[None, :] - cand
    is_match = (
        (window_at(safe) == groups).all(dim=2)
        & (cand >= 0)
        & (cand_dist <= MAX_DIST)
    )
    dists = torch.where(is_match, cand_dist, torch.zeros_like(cand_dist))

    # continuation promotion: exactly two passes, each reading the previous
    # pass's planes (not a running scan)
    for _ in range(2):
        prev_dist = _shift_right(dists, 0)
        prev_match = _shift_right(is_match, False)
        c_src = dest[None, :] - prev_dist
        c_ok = (
            prev_match
            & (prev_dist > 0)
            & (window_at(c_src.clamp(min=0)) == groups).all(dim=2)
        )
        dists = torch.where(c_ok, prev_dist, dists)
        is_match = is_match | c_ok

    prev_dist = _shift_right(dists, 0)
    prev_match = _shift_right(is_match, False)
    is_cont = is_match & prev_match & (dists == prev_dist)

    next_dist = _shift_left(dists, 0)
    next_match = _shift_left(is_match, False)
    byte_pos = dest[None, :, None] + lanes[None, None, :]
    pre_src = byte_pos - prev_dist[:, :, None]
    suf_src = byte_pos - next_dist[:, :, None]
    pre_eq = gather(pre_src) == groups
    suf_eq = (gather(suf_src) == groups) & (suf_src >= 0)
    prefix_run = torch.cumprod(pre_eq.to(torch.int32), dim=2).sum(dim=2)
    suffix_start = GROUP - torch.cumprod(
        suf_eq.flip(2).to(torch.int32), dim=2
    ).sum(dim=2)
    ks = suffix_start.to(torch.int32)
    is_split = (
        ~is_match
        & prev_match
        & next_match
        & (prev_dist > 0)
        & (next_dist > 0)
        & (ks >= 1)
        & (ks <= GROUP - 1)
        & (ks <= prefix_run)
    )
    return is_match, is_cont, is_split, dists.to(torch.int32), ks


def compact_pack(blocks, is_match, is_cont, is_split, dists, ks, n_groups: int):
    """Rank compaction + bitmap packing of the full decision planes into the
    9-tuple wire layout of the JAX package's ``_compact_pack_math``:
    (match_bitmap, cont_bitmap, split_bitmap, dists_compact int32,
    ks_compact uint8, lits_compact (B, G, 8) uint8, n_new, n_split,
    n_match). Compaction writes each selected element to its (row, rank)
    slot — unique indices, so the result is deterministic on any device."""
    b = blocks.shape[0]
    dev = blocks.device
    groups = blocks.reshape(b, n_groups, GROUP)
    is_lit = ~is_match & ~is_split
    is_new = is_match & ~is_cont
    n_match = is_match.sum(dim=1, dtype=torch.int32)
    n_new = is_new.sum(dim=1, dtype=torch.int32)
    n_split = is_split.sum(dim=1, dtype=torch.int32)

    def compact(mask, values, out):
        rank = torch.cumsum(mask, dim=1) - 1
        r, g = mask.nonzero(as_tuple=True)
        out[r, rank[r, g]] = values[r, g]
        return out

    offs = compact(is_new, dists, torch.zeros((b, n_groups), dtype=torch.int32, device=dev))
    ks_c = compact(
        is_split, ks.to(torch.uint8),
        torch.zeros((b, n_groups), dtype=torch.uint8, device=dev),
    )
    lits = compact(
        is_lit, groups,
        torch.zeros((b, n_groups, GROUP), dtype=torch.uint8, device=dev),
    )
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.int32, device=dev)

    def pack(bits):
        return (
            (bits.reshape(b, n_groups // 8, 8).to(torch.int32) * weights)
            .sum(dim=2)
            .to(torch.uint8)
        )

    return (
        pack(is_match), pack(is_cont), pack(is_split), offs, ks_c, lits,
        n_new, n_split, n_match,
    )


def encode_planes(blocks: torch.Tensor, n_groups: int):
    """candidate search → plane decisions (K2 on CUDA) → compaction."""
    from s3shuffle_tpu_torch.ops import tlz_cuda

    cand = candidate_math(blocks, n_groups)
    planes = tlz_cuda.plane_decisions(blocks, cand, n_groups)
    return compact_pack(blocks, *planes, n_groups)


def encode_fused(blocks: torch.Tensor, n_groups: int, poly: int):
    """The planes of :func:`encode_planes` plus raw zero-init CRC
    remainders of (a) each raw block and (b) each block's literal plane
    (its first ``n_lits * 8`` bytes, compacted in literal order), both from
    ONE CRC launch over the two row sets (kernel K1 on CUDA)."""
    from s3shuffle_tpu_torch.ops import crc_cuda

    outs = encode_planes(blocks, n_groups)
    lits, n_split, n_match = outs[5], outs[7], outs[8]
    b = blocks.shape[0]
    lit_len = ((n_groups - n_match - n_split) * GROUP).to(torch.int32)
    raw = crc_cuda.crc_raw_pair(
        blocks, lits.reshape(b, n_groups * GROUP), poly, more_lengths=lit_len
    )
    return outs + (raw[:b], raw[b:])


# ---------------------------------------------------------------------------
# Host assembly of device encode batches
# ---------------------------------------------------------------------------


def _assemble_batch(arrs, n_blocks: int, n_groups: int) -> List[bytes]:
    """Whole-batch payload assembly — the host half of a device encode
    launch: bitmap planes convert to bytes once per batch and every payload
    copies its literal plane exactly once."""
    bitmap, cont, split, offs, ks, lits, n_new, n_split, n_match = arrs
    b = n_blocks
    bm_len = bitmap.shape[1]
    bitmap_b = np.ascontiguousarray(bitmap[:b]).tobytes()
    cont_b = np.ascontiguousarray(cont[:b]).tobytes()
    split_b = np.ascontiguousarray(split[:b]).tobytes()
    offs_c = np.ascontiguousarray(offs[:b])
    ks_c = np.ascontiguousarray(ks[:b])
    row_bytes = n_groups * GROUP
    lits_mv = memoryview(np.ascontiguousarray(lits[:b]).reshape(b * row_bytes))
    out: List[bytes] = []
    for i in range(b):
        nn, ns = int(n_new[i]), int(n_split[i])
        n_lits = n_groups - int(n_match[i]) - ns
        out.append(
            b"".join((
                _pack_meta(
                    bitmap_b[i * bm_len : (i + 1) * bm_len],
                    cont_b[i * bm_len : (i + 1) * bm_len],
                    split_b[i * bm_len : (i + 1) * bm_len],
                    offs_c[i, :nn].astype("<u2").tobytes(),
                    ks_c[i, :ns].tobytes(),
                    n_groups,
                ),
                lits_mv[i * row_bytes : i * row_bytes + n_lits * GROUP],
            ))
        )
    return out


#: guards every update of a caller's timings dict: one codec's dict is
#: shared by the map and reduce tasks running on its threads
_timings_lock = threading.Lock()


class _Clock:
    """Accumulates wall seconds of consecutive stages into a caller's dict
    (a no-op without one); concurrent callers' seconds add up."""

    def __init__(self, timings: Optional[dict]):
        self._timings = timings
        self._t = 0.0

    def start(self) -> None:
        if self._timings is not None:
            self._t = time.perf_counter()

    def lap(self, key: str) -> None:
        if self._timings is not None:
            now = time.perf_counter()
            with _timings_lock:
                self._timings[key] = self._timings.get(key, 0.0) + now - self._t
            self._t = now


class _Staging(threading.local):
    """Reusable per-thread host staging buffers, one per launch shape."""

    def __init__(self) -> None:
        self.buffers: dict = {}

    def get(self, key, make):
        buf = self.buffers.get(key)
        if buf is None:
            buf = make()
            self.buffers[key] = buf
        return buf


_encode_staging = _Staging()
_decode_staging = _Staging()


def encode_batch_device(
    buf,
    n_blocks: int,
    block_size: int,
    batch_blocks: Optional[int] = None,
    poly: Optional[int] = None,
    device=None,
    timings: Optional[dict] = None,
):
    """Encode ``n_blocks`` FULL blocks held contiguously in ``buf`` on
    ``device`` in launches of ``batch_blocks`` rows (a partial batch pads to
    a power-of-two bucket with zero rows whose outputs are dropped), with
    whole-batch host payload assembly.

    With ``poly`` set, each block's CRCs come back from the same launch
    sequence: returns ``(payloads, (block_crcs, lit_crcs, lit_lens))`` where
    ``block_crcs[i]`` is the full-algorithm CRC of raw block i (for the
    framing raw escape) and ``lit_crcs[i]``/``lit_lens[i]`` cover payload
    i's literal plane — callers stitch the small header/metadata CRCs around
    them with ``crc_combine``. Without ``poly``: ``(payloads, None)``.
    ``timings`` (optional dict) accumulates ``encode_device_s`` (staging,
    H2D, the device stages, D2H) and ``encode_assembly_s`` (host payload
    assembly) in seconds."""
    from s3shuffle_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    _check_block_size(block_size)
    clock = _Clock(timings)
    n_groups = block_size // GROUP
    cap = max(1, batch_blocks or n_blocks)
    mv = memoryview(buf)
    if mv.ndim != 1 or mv.itemsize != 1:
        mv = mv.cast("B")
    payloads: List[bytes] = []
    crc_parts: Optional[list] = [] if poly is not None else None
    for s in range(0, n_blocks, cap):
        e = min(n_blocks, s + cap)
        clock.start()
        rows = _bucket_rows(e - s, cap)
        staged = _encode_staging.get(
            (rows, block_size),
            lambda r=rows: np.zeros((r, block_size), dtype=np.uint8),
        )
        flat = staged.reshape(-1)
        used = (e - s) * block_size
        flat[:used] = np.frombuffer(mv[s * block_size : e * block_size], dtype=np.uint8)
        flat[used:] = 0  # deterministic pad rows (outputs discarded)
        blocks = torch.from_numpy(staged).to(dev)
        if poly is None:
            outs = encode_planes(blocks, n_groups)
        else:
            outs = encode_fused(blocks, n_groups, poly)
        arrs = tuple(x.cpu().numpy() for x in outs)
        clock.lap("encode_device_s")
        payloads.extend(_assemble_batch(arrs[:9], e - s, n_groups))
        clock.lap("encode_assembly_s")
        if crc_parts is not None:
            n_real = e - s
            crc_parts.append(
                (arrs[9][:n_real], arrs[10][:n_real], arrs[8][:n_real], arrs[7][:n_real])
            )
    if crc_parts is None:
        return payloads, None
    from s3shuffle_tpu_torch.ops.checksum import zero_run_crcs

    zero = zero_run_crcs(poly, n_groups * GROUP)
    block_crcs = (
        np.concatenate([p[0] for p in crc_parts]).astype(np.uint32)
        ^ zero[n_groups * GROUP]
    )
    lit_lens = np.concatenate(
        [
            (n_groups - p[2].astype(np.int64) - p[3].astype(np.int64)) * GROUP
            for p in crc_parts
        ]
    )
    lit_crcs = (
        np.concatenate([p[1] for p in crc_parts]).astype(np.uint32) ^ zero[lit_lens]
    )
    return payloads, (block_crcs, lit_crcs, lit_lens)


# ---------------------------------------------------------------------------
# Host (numpy) encoder/decoder — short tail blocks, host reads of single
# frames, and the differential oracle.
# ---------------------------------------------------------------------------


def _group_view(data: bytes, group: int = GROUP) -> Tuple[np.ndarray, int]:
    n_groups = (len(data) + group - 1) // group
    padded = np.zeros(n_groups * group, dtype=np.uint8)
    padded[: len(data)] = np.frombuffer(data, dtype=np.uint8)
    return padded.reshape(n_groups, group), n_groups


def _encode_planes_numpy(data: bytes):
    """Host encode producing the device-shaped wire planes — byte-identical
    decisions to the batched device encoder. Returns
    ``(bitmap_b, cont_b, split_b, offs_b, ks_b, lits_b, n_groups)`` or None
    for empty input."""
    groups, n_groups = _group_view(data)
    if n_groups == 0:
        return None
    flat = groups.reshape(-1)
    windows = np.lib.stride_tricks.sliding_window_view(flat, GROUP)
    n_bytes = n_groups * GROUP
    n_pos = n_bytes - GROUP + 1
    flat64 = flat.astype(np.int64)
    h = np.zeros(n_pos, dtype=np.int64)
    for k in range(GROUP):
        h += flat64[k : k + n_pos] * _MULTS_I64[k]
    order = np.argsort(h, kind="stable")
    h_sorted = h[order]
    prev_same = np.concatenate([[False], h_sorted[1:] == h_sorted[:-1]])
    prev_pos = np.concatenate([[0], order[:-1]])
    cand_sorted = np.where(prev_same, prev_pos, -1)
    cand = np.zeros(n_pos, dtype=np.int64)
    cand[order] = cand_sorted
    dest = np.arange(n_groups) * GROUP
    cand_d = cand[dest]
    safe = np.maximum(cand_d, 0)
    cand_dist = dest - cand_d
    is_match = (
        (windows[safe] == groups).all(axis=1)
        & (cand_d >= 0)
        & (cand_dist <= MAX_DIST)
    )
    dists = np.where(is_match, cand_dist, 0)
    for _ in range(2):  # continuation promotion
        prev_dist = np.concatenate([[0], dists[:-1]])
        prev_match = np.concatenate([[False], is_match[:-1]])
        c_src = dest - prev_dist
        c_ok = (
            prev_match
            & (prev_dist > 0)
            & (windows[np.maximum(c_src, 0)] == groups).all(axis=1)
        )
        dists = np.where(c_ok, prev_dist, dists)
        is_match = is_match | c_ok
    prev_dist = np.concatenate([[0], dists[:-1]])
    prev_match = np.concatenate([[False], is_match[:-1]])
    is_cont = is_match & prev_match & (dists == prev_dist)
    is_new = is_match & ~is_cont
    next_dist = np.concatenate([dists[1:], [0]])
    next_match = np.concatenate([is_match[1:], [False]])
    byte_pos = dest[:, None] + np.arange(GROUP)
    flat_i = groups.reshape(-1).astype(np.int64)
    pre_src = byte_pos - prev_dist[:, None]
    suf_src = byte_pos - next_dist[:, None]
    take = lambda idx: flat_i[np.clip(idx, 0, n_bytes - 1)]  # noqa: E731
    pre_eq = take(pre_src) == groups
    suf_eq = (take(suf_src) == groups) & (suf_src >= 0)
    prefix_run = np.cumprod(pre_eq, axis=1).sum(axis=1)
    ks = (GROUP - np.cumprod(suf_eq[:, ::-1], axis=1).sum(axis=1)).astype(np.int64)
    is_split = (
        ~is_match
        & prev_match
        & next_match
        & (prev_dist > 0)
        & (next_dist > 0)
        & (ks >= 1)
        & (ks <= GROUP - 1)
        & (ks <= prefix_run)
    )
    is_lit = ~is_match & ~is_split
    return (
        np.packbits(is_match.astype(np.uint8), bitorder="little").tobytes(),
        np.packbits(is_cont.astype(np.uint8), bitorder="little").tobytes(),
        np.packbits(is_split.astype(np.uint8), bitorder="little").tobytes(),
        dists[is_new].astype("<u2").tobytes(),
        ks[is_split].astype(np.uint8).tobytes(),
        groups[is_lit].tobytes(),
        n_groups,
    )


def _assemble_payload_numpy(data: bytes) -> bytes:
    planes = _encode_planes_numpy(data)
    if planes is None:
        return np.array([V2_FLAG], dtype="<u2").tobytes()
    bitmap_b, cont_b, split_b, offs_b, ks_b, lits_b, n_groups = planes
    return _pack_meta(bitmap_b, cont_b, split_b, offs_b, ks_b, n_groups) + lits_b


def _parse_payload(payload: bytes, uncompressed_len: int):
    """Split a TLZ payload into (version, n_groups, is_match, is_cont,
    is_split, dists, ks, lits). v1 has no cont/split bitmaps (both None),
    16-byte groups and literal-group-index sources."""
    if len(payload) < 2:
        raise IOError("TLZ payload too short")
    field = int(np.frombuffer(payload[:2], dtype="<u2")[0])
    version = 2 if field & V2_FLAG else 1
    packed = bool(field & PACKED_FLAG) and version == 2
    if version == 2:
        n_groups = (uncompressed_len + GROUP - 1) // GROUP
        if n_groups > MAX_BLOCK // GROUP:
            raise IOError(
                "ambiguous TLZ header: v2 flag set with out-of-range group "
                "count (legacy v1 payload from an oversized block?)"
            )
        if (field & 0x3FFF) != (n_groups & 0x3FFF):
            raise IOError(
                f"TLZ v2 header count {field & 0x3FFF} inconsistent with "
                f"frame length ({n_groups} groups) — corrupt or legacy header"
            )
    else:
        n_groups = field
    bm_len = (n_groups + 7) // 8
    group = GROUP if version == 2 else _V1_GROUP
    off = 2
    if packed:
        if len(payload) < 6:
            raise IOError("TLZ packed metadata length truncated")
        clen = int(np.frombuffer(payload[2:6], dtype="<u4")[0])
        if 6 + clen > len(payload):
            raise IOError("TLZ packed metadata truncated")
        # cap the inflation: clen is untrusted
        max_meta = 3 * ((n_groups + 7) // 8) + 3 * n_groups
        try:
            d = zlib.decompressobj()
            meta = d.decompress(payload[6 : 6 + clen], max_meta + 1)
        except zlib.error as e:
            raise IOError(f"TLZ packed metadata corrupt: {e}") from e
        if len(meta) > max_meta or d.unconsumed_tail:
            raise IOError("TLZ packed metadata inflates beyond any valid size")
        off = 6 + clen
        src = meta
        moff = 0
    else:
        src = payload
        moff = off
    bitmap = np.frombuffer(src[moff : moff + bm_len], dtype=np.uint8)
    moff += bm_len
    if len(bitmap) < bm_len:
        raise IOError("TLZ bitmap truncated")
    is_match = np.unpackbits(bitmap, count=n_groups, bitorder="little").astype(bool)
    is_cont = is_split = ks = None
    if version == 2:
        cont_b = np.frombuffer(src[moff : moff + bm_len], dtype=np.uint8)
        moff += bm_len
        if len(cont_b) < bm_len:
            raise IOError("TLZ cont bitmap truncated")
        is_cont = np.unpackbits(cont_b, count=n_groups, bitorder="little").astype(bool)
        if (is_cont & ~is_match).any():
            raise IOError("TLZ cont flag on non-match group")
        split_b = np.frombuffer(src[moff : moff + bm_len], dtype=np.uint8)
        moff += bm_len
        if len(split_b) < bm_len:
            raise IOError("TLZ split bitmap truncated")
        is_split = np.unpackbits(split_b, count=n_groups, bitorder="little").astype(bool)
        if (is_split & is_match).any():
            raise IOError("TLZ split flag on match group")
        n_offs = int((is_match & ~is_cont).sum())
        n_split = int(is_split.sum())
    else:
        n_offs = int(is_match.sum())
        n_split = 0
    offs_raw = src[moff : moff + 2 * n_offs]
    if len(offs_raw) < 2 * n_offs:
        raise IOError("TLZ sources truncated")
    offs = np.frombuffer(offs_raw, dtype="<u2")
    moff += 2 * n_offs
    if version == 2:
        ks = np.frombuffer(src[moff : moff + n_split], dtype=np.uint8)
        moff += n_split
        if len(ks) < n_split:
            raise IOError("TLZ split points truncated")
    if packed:
        if moff != len(meta):
            raise IOError(f"TLZ packed metadata has {len(meta) - moff} trailing bytes")
    else:
        off = moff
    n_lits = n_groups - int(is_match.sum()) - n_split
    lits = np.frombuffer(payload[off : off + n_lits * group], dtype=np.uint8)
    if len(lits) < n_lits * group:
        raise IOError("TLZ literals truncated")
    if version == 2 and off + n_lits * group != len(payload):
        raise IOError(
            f"TLZ v2 payload has {len(payload) - off - n_lits * group} "
            "trailing bytes — misread header (legacy v1 block?)"
        )
    return (
        version, n_groups, is_match, is_cont, is_split,
        offs.astype(np.int64), ks, lits,
    )


def _expand_dists_numpy(is_match, is_cont, dists, n_groups):
    """Each match group's source distance: continuation groups share their
    run leader's stored distance."""
    is_new = is_match & ~is_cont
    idx = np.arange(n_groups, dtype=np.int64)
    if not is_match.any():
        return np.zeros(n_groups, dtype=np.int64)
    leader = np.maximum.accumulate(np.where(is_new, idx, -1))
    if (leader[is_match] < 0).any() or len(dists) == 0:
        raise IOError("TLZ continuation run has no leader")
    new_rank = np.cumsum(is_new) - 1
    safe_rank = np.clip(new_rank, 0, len(dists) - 1)
    return dists[safe_rank]


def _validate_planes_v2(n_groups, is_match, is_cont, is_split, dists, ks):
    """Structural validation of parsed v2 planes; raises :class:`IOError`
    on out-of-range match distances or malformed split groups. Every decode
    path runs it, so corruption fails loudly even with checksums off (the
    device decoder clamps offsets and would otherwise decode corrupt frames
    to wrong bytes).

    Returns ``(dist_full, group_start, split_idx, kvals, d_prev, d_next)``."""
    dist_full = _expand_dists_numpy(is_match, is_cont, dists, n_groups)
    group_start = np.arange(n_groups, dtype=np.int64) * GROUP
    off_full = group_start - dist_full
    bad = is_match & ((dist_full < 1) | (off_full < 0))
    if bad.any():
        raise IOError("TLZ v2 source distance out of range")
    split_idx = np.flatnonzero(is_split)
    kvals = d_prev = d_next = None
    if len(split_idx):
        if split_idx[0] == 0 or split_idx[-1] == n_groups - 1:
            raise IOError("TLZ split group at block edge")
        if (~is_match[split_idx - 1]).any() or (~is_match[split_idx + 1]).any():
            raise IOError("TLZ split group without match neighbors")
        kvals = ks.astype(np.int64)
        if ((kvals < 1) | (kvals > GROUP - 1)).any():
            raise IOError("TLZ split point out of range")
        d_prev = dist_full[split_idx - 1]
        d_next = dist_full[split_idx + 1]
        if ((group_start[split_idx] + kvals - d_next) < 0).any():
            raise IOError("TLZ split suffix distance out of range")
    return dist_full, group_start, split_idx, kvals, d_prev, d_next


def decode_payload_numpy(payload: bytes, uncompressed_len: int) -> bytes:
    """Host decode of one TLZ payload: parse, validate with precise errors,
    and pointer-jump with an early convergence exit (the JAX package's numpy
    path; the port loads no native decoder)."""
    version, n_groups, is_match, is_cont, is_split, dists, ks, lits = (
        _parse_payload(payload, uncompressed_len)
    )
    if version == 1:
        # legacy format: 16-byte groups, sources are literal group indices
        n_lits = n_groups - int(is_match.sum())
        out = np.zeros((n_groups, _V1_GROUP), dtype=np.uint8)
        out[~is_match] = lits.reshape(n_lits, _V1_GROUP)
        if len(dists):
            if (dists >= n_groups).any() or is_match[dists].any():
                raise IOError("TLZ match source is not a literal group")
            out[is_match] = out[dists]
        return out.reshape(-1)[:uncompressed_len].tobytes()

    n_bytes = n_groups * GROUP
    if n_groups == 0:
        return b""
    n_lits = n_groups - int(is_match.sum()) - int(is_split.sum())
    dist_full, group_start, split_idx, kvals, d_prev, d_next = (
        _validate_planes_v2(n_groups, is_match, is_cont, is_split, dists, ks)
    )
    off_full = group_start - dist_full
    is_lit = ~is_match & ~is_split
    sparse = np.zeros((n_groups, GROUP), dtype=np.uint8)
    sparse[is_lit] = lits.reshape(n_lits, GROUP)
    sparse = sparse.reshape(-1)
    out = sparse
    match_groups = np.flatnonzero(is_match)
    if len(match_groups) or len(split_idx):
        lanes = np.arange(GROUP, dtype=np.int64)
        src = np.arange(n_bytes, dtype=np.int64)
        if len(match_groups):
            src_match = (off_full[match_groups][:, None] + lanes[None, :]).reshape(-1)
            dst_match = (group_start[match_groups][:, None] + lanes[None, :]).reshape(-1)
            src[dst_match] = src_match
        if len(split_idx):
            pos = group_start[split_idx][:, None] + lanes[None, :]
            d = np.where(lanes[None, :] < kvals[:, None], d_prev[:, None], d_next[:, None])
            src[pos.reshape(-1)] = (pos - d).reshape(-1)
        for _ in range(_jump_rounds(n_bytes)):
            nxt = src[src]
            if np.array_equal(nxt, src):
                break
            src = nxt
        out = sparse[src]
    return out[:uncompressed_len].tobytes()


# ---------------------------------------------------------------------------
# Fused decode on torch tensors (plain version of kernel K3)
# ---------------------------------------------------------------------------


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to int32 two's-complement wraparound (the
    reference computes source offsets in int32)."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def source_map_plain(is_match, is_cont, is_split, offs_padded, ks_padded, n_groups: int):
    """(B, G*8) int64 per-byte source map of staged decode planes, before
    pointer jumping: a literal byte is its own source, a match byte points at
    ``pos - distance``, a split byte at ``pos - d_prev`` below its split point
    and ``pos - d_next`` from it. Offsets are computed with the reference's
    int32 wraparound, then clamped into ``[0, G*8 - 1]``."""
    n_bytes = n_groups * GROUP
    b = is_match.shape[0]
    dev = is_match.device
    idx = torch.arange(n_groups, dtype=torch.int64, device=dev)
    offs_padded = offs_padded.to(torch.int64)
    ks_padded = ks_padded.to(torch.int64)
    is_new = is_match & ~is_cont
    new_rank = torch.cumsum(is_new, dim=1) - 1
    dist_of = torch.gather(offs_padded, 1, new_rank.clamp(min=0))
    split_rank = torch.cumsum(is_split, dim=1) - 1
    k_of = torch.gather(ks_padded, 1, split_rank.clamp(min=0))
    d_prev = _shift_right(dist_of, 0)
    d_next = _shift_left(dist_of, 0)
    lanes = torch.arange(GROUP, dtype=torch.int64, device=dev)
    pos = torch.arange(n_bytes, dtype=torch.int64, device=dev)
    grid = GROUP * idx[None, :, None] + lanes[None, None, :]
    off_b = _wrap_int32(grid - dist_of[:, :, None]).reshape(b, n_bytes)
    split_d = torch.where(
        lanes[None, None, :] < k_of[:, :, None], d_prev[:, :, None], d_next[:, :, None]
    )
    split_src = _wrap_int32(grid - split_d).reshape(b, n_bytes)
    match_b = is_match.repeat_interleave(GROUP, dim=1)
    split_b = is_split.repeat_interleave(GROUP, dim=1)
    src = torch.where(match_b, off_b.clamp(0, n_bytes - 1), pos[None, :].expand(b, n_bytes))
    return torch.where(split_b, split_src.clamp(0, n_bytes - 1), src)


def general_route_plain(offs_padded: torch.Tensor) -> torch.Tensor:
    """(B,) bool: the rows kernel K3 decodes by whole-row pointer jumping —
    those holding any negative stored distance. Only such rows can have a
    source after its position (forward pointers, cycles, int32 wraps); every
    source of the other rows is at or before its position, which the
    segmented route relies on. The parser never stages a negative distance."""
    return (offs_padded < 0).any(dim=1)


def decode_fused_plain(is_match, is_cont, is_split, offs_padded, ks_padded,
                       lits_padded, n_lits, n_groups: int, poly: int):
    """Plain PyTorch TLZ decode + literal-plane raw CRC — the reference the
    fused decode kernel (K3, ``ops/tlz_cuda.py``) is held against, mirroring
    the JAX package's ``_decode_math`` + ``_decode_fused_math``.

    is_match/is_cont/is_split: (B, G) bool; offs_padded / ks_padded: (B, G)
    int32 stored distances / split points in order; lits_padded: (B, G*8)
    uint8 literal groups in literal order; n_lits: (B,) int32. Returns
    ((B, G*8) uint8 decoded rows, (B,) int64 raw zero-init CRC remainders of
    each row's first ``n_lits*8`` literal bytes). Corrupt offsets wrap in
    int32 and clamp into the row, as in the reference."""
    from s3shuffle_tpu_torch.ops.checksum import crc_raw_plain

    n_bytes = n_groups * GROUP
    b = is_match.shape[0]
    is_lit = ~is_match & ~is_split
    lit_rank = torch.cumsum(is_lit, dim=1) - 1
    lits_g = lits_padded.reshape(b, n_groups, GROUP)
    lit_vals = torch.gather(
        lits_g, 1, lit_rank.clamp(min=0)[:, :, None].expand(b, n_groups, GROUP)
    )
    sparse = torch.where(
        is_lit[:, :, None], lit_vals, torch.zeros_like(lit_vals)
    ).reshape(b, n_bytes)
    src = source_map_plain(is_match, is_cont, is_split, offs_padded, ks_padded, n_groups)
    for _ in range(_jump_rounds(n_bytes)):
        src = torch.gather(src, 1, src)
    decoded = torch.gather(sparse, 1, src)
    lit_len = (n_lits.to(torch.int64) * GROUP).clamp(min=0)
    raw = crc_raw_plain(lits_padded.reshape(b, n_bytes).contiguous(), poly, lit_len)
    return decoded, raw


# ---------------------------------------------------------------------------
# Batched device decode
# ---------------------------------------------------------------------------


def _parse_batch_v2(payloads: List[bytes], ulens: List[int], n_groups: int):
    """Single vectorized batch parse of the v2 plane tables (the JAX
    package's, copied): the three bitmap planes of all rows unpack in one
    pass, cross-plane consistency checks run batch-wide, and structural
    validation (:func:`_validate_planes_v2`) runs on every device-shaped
    row.

    Returns ``(rows, fallback)`` where ``rows[i]`` is
    ``(is_match, is_cont, is_split, dists, ks, lits, n_lits, lit_off)`` for
    device-shaped rows and None for ``fallback`` members (legacy v1 frames,
    short blocks, foreign block sizes — the numpy decoder serves those)."""
    b = len(payloads)
    bm = (n_groups + 7) // 8
    fallback = set()
    metas: List = [None] * b
    for i, payload in enumerate(payloads):
        if len(payload) < 2:
            raise IOError("TLZ payload too short")
        field = int(np.frombuffer(payload[:2], dtype="<u2")[0])
        ng = (ulens[i] + GROUP - 1) // GROUP
        if not field & V2_FLAG or ng != n_groups:
            fallback.add(i)
            continue
        if (field & 0x3FFF) != (n_groups & 0x3FFF):
            raise IOError(
                f"TLZ v2 header count {field & 0x3FFF} inconsistent with "
                f"frame length ({n_groups} groups) — corrupt or legacy header"
            )
        if field & PACKED_FLAG:
            if len(payload) < 6:
                raise IOError("TLZ packed metadata length truncated")
            clen = int(np.frombuffer(payload[2:6], dtype="<u4")[0])
            if 6 + clen > len(payload):
                raise IOError("TLZ packed metadata truncated")
            max_meta = 3 * bm + 3 * n_groups
            try:
                d = zlib.decompressobj()
                meta = d.decompress(payload[6 : 6 + clen], max_meta + 1)
            except zlib.error as e:
                raise IOError(f"TLZ packed metadata corrupt: {e}") from e
            if len(meta) > max_meta or d.unconsumed_tail:
                raise IOError("TLZ packed metadata inflates beyond any valid size")
            metas[i] = (meta, 0, 6 + clen)
        else:
            metas[i] = (payload, 2, None)
        meta, moff, _lo = metas[i]
        if len(meta) - moff < 3 * bm:
            raise IOError("TLZ bitmap truncated")
    live = [i for i in range(b) if i not in fallback]
    if not live:
        return [None] * b, fallback
    stacked = np.empty((len(live), 3 * bm), dtype=np.uint8)
    for j, i in enumerate(live):
        meta, moff, _lo = metas[i]
        stacked[j] = np.frombuffer(meta, dtype=np.uint8, count=3 * bm, offset=moff)
    match_b = np.unpackbits(
        stacked[:, :bm], axis=1, count=n_groups, bitorder="little"
    ).astype(bool)
    cont_b = np.unpackbits(
        stacked[:, bm : 2 * bm], axis=1, count=n_groups, bitorder="little"
    ).astype(bool)
    split_b = np.unpackbits(
        stacked[:, 2 * bm :], axis=1, count=n_groups, bitorder="little"
    ).astype(bool)
    if (cont_b & ~match_b).any():
        raise IOError("TLZ cont flag on non-match group")
    if (split_b & match_b).any():
        raise IOError("TLZ split flag on match group")
    # counts from the TRUNCATED unpacked planes (bits past n_groups in the
    # final bitmap byte are padding)
    n_match = match_b.sum(axis=1)
    n_new = (match_b & ~cont_b).sum(axis=1)
    n_split = split_b.sum(axis=1)
    n_lits = n_groups - n_match - n_split
    rows: List = [None] * b
    for j, i in enumerate(live):
        meta, moff, lit_off = metas[i]
        payload = payloads[i]
        nn, ns, nl = int(n_new[j]), int(n_split[j]), int(n_lits[j])
        meta_len = 3 * bm + 2 * nn + ns
        if len(meta) - moff < meta_len:
            raise IOError(
                "TLZ sources truncated" if len(meta) - moff < 3 * bm + 2 * nn
                else "TLZ split points truncated"
            )
        dists = np.frombuffer(meta, dtype=np.uint8, count=2 * nn, offset=moff + 3 * bm)
        ks = np.frombuffer(meta, dtype=np.uint8, count=ns, offset=moff + 3 * bm + 2 * nn)
        if lit_off is None:
            lit_off = 2 + meta_len
        elif len(meta) != meta_len:
            raise IOError(f"TLZ packed metadata has {len(meta) - meta_len} trailing bytes")
        if len(payload) < lit_off + nl * GROUP:
            raise IOError("TLZ literals truncated")
        if len(payload) != lit_off + nl * GROUP:
            raise IOError(
                f"TLZ v2 payload has {len(payload) - lit_off - nl * GROUP} "
                "trailing bytes — misread header (legacy v1 block?)"
            )
        lits = np.frombuffer(payload, dtype=np.uint8, count=nl * GROUP, offset=lit_off)
        # unaligned-safe u16 view: pair the bytes back up on the host
        dist_vals = dists[0::2].astype(np.int64) | (dists[1::2].astype(np.int64) << 8)
        _validate_planes_v2(
            n_groups, match_b[j], cont_b[j], split_b[j], dist_vals, ks.astype(np.int64)
        )
        rows[i] = (match_b[j], cont_b[j], split_b[j], dist_vals, ks, lits, nl, lit_off)
    return rows, fallback


def _new_decode_staging(rows: int, n_groups: int) -> tuple:
    return (
        np.zeros((rows, n_groups), dtype=bool),
        np.zeros((rows, n_groups), dtype=bool),
        np.zeros((rows, n_groups), dtype=bool),
        np.zeros((rows, n_groups), dtype=np.int32),
        np.zeros((rows, n_groups), dtype=np.int32),
        np.zeros((rows, n_groups * GROUP), dtype=np.uint8),
        np.zeros(rows, dtype=np.int32),  # n_lits per row
    )


def decode_batch_device(
    payloads: List[bytes],
    ulens: List[int],
    block_size: int,
    batch_rows: Optional[int] = None,
    poly: Optional[int] = None,
    device=None,
    timings: Optional[dict] = None,
):
    """Batched device decode of v2 TLZ payloads in launches of
    ``batch_rows`` rows (partial batches pad to a power-of-two bucket),
    fed by :func:`_parse_batch_v2`. Short or legacy payloads decode on the
    host per row.

    With ``poly`` set, each device-shaped payload's full-algorithm CRC of
    its STORED bytes comes back from the same launch (the literal plane is
    CRC'd in the kernel; the host stitches the small header/metadata prefix
    with ``crc_combine``): returns ``(blocks, payload_crcs)`` where
    ``payload_crcs[i]`` is the CRC of ``payloads[i]`` or None for host rows.
    Without ``poly``: ``(blocks, None)``. ``timings`` (optional dict)
    accumulates ``decode_parse_s`` (host parse, validation and staging),
    ``decode_device_s`` (H2D, the kernel, D2H) and ``decode_emit_s`` (host
    bytes and CRC stitching) in seconds."""
    from s3shuffle_tpu_torch.device import resolve_device
    from s3shuffle_tpu_torch.ops import tlz_cuda
    from s3shuffle_tpu_torch.ops.checksum import (
        POLY_CRC32C,
        crc_combine,
        host_crc,
        zero_run_crcs,
    )

    dev = resolve_device(device)
    clock = _Clock(timings)
    n_groups = block_size // GROUP
    b = len(payloads)
    cap = max(1, batch_rows or b)
    out: List[Optional[bytes]] = [None] * b
    crcs: Optional[List[Optional[int]]] = [None] * b if poly is not None else None
    kernel_poly = POLY_CRC32C if poly is None else poly
    zero = zero_run_crcs(poly, n_groups * GROUP) if poly is not None else None
    for s in range(0, b, cap):
        e = min(b, s + cap)
        clock.start()
        rows, fallback = _parse_batch_v2(payloads[s:e], ulens[s:e], n_groups)
        for j in sorted(fallback):
            out[s + j] = decode_payload_numpy(payloads[s + j], ulens[s + j])
        if len(fallback) == e - s:
            continue
        launch_rows = _bucket_rows(e - s, cap)
        staging = _decode_staging.get(
            (launch_rows, n_groups),
            lambda r=launch_rows: _new_decode_staging(r, n_groups),
        )
        is_match, is_cont, is_split, offs, ks, lits, nlits = staging
        for arr in staging:
            arr[...] = 0  # deterministic pad + fallback rows
        for j in range(e - s):
            row = rows[j]
            if row is None:
                continue
            m, c, sp, dist_vals, kv, lit, nl, _lit_off = row
            is_match[j] = m
            is_cont[j] = c
            is_split[j] = sp
            offs[j, : len(dist_vals)] = dist_vals
            ks[j, : len(kv)] = kv
            lits[j, : nl * GROUP] = lit
            nlits[j] = nl
        clock.lap("decode_parse_s")
        tensors = [torch.from_numpy(a).to(dev) for a in staging]
        decoded_t, raw_t = tlz_cuda.decode_fused(*tensors, n_groups, kernel_poly)
        decoded = decoded_t.cpu().numpy()
        raw_crcs = raw_t.cpu().numpy() if poly is not None else None
        clock.lap("decode_device_s")
        for j, row in enumerate(rows[: e - s]):
            if row is None:
                continue
            out[s + j] = decoded[j, : ulens[s + j]].tobytes()
            if raw_crcs is not None:
                nl = row[6]
                lit_len = nl * GROUP
                payload = payloads[s + j]
                lit_crc = int(raw_crcs[j]) ^ int(zero[lit_len])
                crcs[s + j] = crc_combine(
                    host_crc(payload[: len(payload) - lit_len], poly),
                    lit_crc, lit_len, poly,
                )
        clock.lap("decode_emit_s")
    return out, crcs
