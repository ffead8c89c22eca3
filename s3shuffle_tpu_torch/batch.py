"""Columnar record batches — the record layer's vectorized data plane.

A copy of the JAX package's ``batch.py`` (byte-identical frames, the same
orderings): records move in columnar batches — two int32 length arrays
plus two contiguous uint8 buffers — so partitioning (``np.searchsorted``),
routing (stable argsort + gather) and key ordering (prefix argsort over
fixed-width key views) are O(records) numpy, and the per-record Python
loop only runs at the API boundary where callers want ``(key, value)``
tuples. The JAX package's native C gathers are not part of the port; every
gather takes the numpy route the JAX package falls back to without them.
"""

from __future__ import annotations

import os
import struct
import tempfile
from typing import BinaryIO, Iterator, List, Optional, Sequence, Tuple

import numpy as np

_U32 = struct.Struct("<I")

_EMPTY_I32 = np.empty(0, dtype=np.int32)
_EMPTY_U8 = np.empty(0, dtype=np.uint8)


class RecordBatch:
    """A batch of (key, value) byte records in columnar layout:
    ``klens``/``vlens`` (int32) and ``keys``/``values`` (uint8, concatenated).
    """

    __slots__ = (
        "klens", "vlens", "keys", "values", "_koff", "_voff", "_kw", "_vw", "_ks",
    )

    def __init__(
        self,
        klens: np.ndarray,
        vlens: np.ndarray,
        keys: np.ndarray,
        values: np.ndarray,
    ):
        self.klens = klens
        self.vlens = vlens
        self.keys = keys
        self.values = values
        self._koff: Optional[np.ndarray] = None
        self._voff: Optional[np.ndarray] = None
        # cached uniform row widths: None = not computed, -1 = ragged
        self._kw: Optional[int] = None
        self._vw: Optional[int] = None
        # cached (width, padded key strings) — spill-merge cuts reuse it
        self._ks: Optional[Tuple[int, np.ndarray]] = None

    # ------------------------------------------------------------------
    @property
    def n(self) -> int:
        return len(self.klens)

    @property
    def nbytes(self) -> int:
        return len(self.keys) + len(self.values) + 8 * self.n

    @property
    def koffsets(self) -> np.ndarray:
        """int64 offsets of each key in ``keys``; length n+1."""
        if self._koff is None:
            off = np.zeros(self.n + 1, dtype=np.int64)
            np.cumsum(self.klens, out=off[1:])
            self._koff = off
        return self._koff

    @property
    def voffsets(self) -> np.ndarray:
        if self._voff is None:
            off = np.zeros(self.n + 1, dtype=np.int64)
            np.cumsum(self.vlens, out=off[1:])
            self._voff = off
        return self._voff

    # ------------------------------------------------------------------
    @staticmethod
    def empty() -> "RecordBatch":
        return RecordBatch(_EMPTY_I32, _EMPTY_I32, _EMPTY_U8, _EMPTY_U8)

    @staticmethod
    def from_fixed(
        n: int, kw: int, vw: int, keys: np.ndarray, values: np.ndarray
    ) -> "RecordBatch":
        """Uniform-width batch with the width caches PRE-SEEDED — the shape
        parsed column frames arrive in. Seeding ``_kw``/``_vw`` up front
        means no downstream consumer ever pays the O(n) uniformity re-scan
        before taking a fixed-stride fast path."""
        out = RecordBatch(
            np.full(n, kw, dtype=np.int32),
            np.full(n, vw, dtype=np.int32),
            keys,
            values,
        )
        out._kw, out._vw = kw, vw
        return out

    @staticmethod
    def from_records(records: Sequence[Tuple[bytes, bytes]]) -> "RecordBatch":
        n = len(records)
        if n == 0:
            return RecordBatch.empty()
        key_list, val_list = zip(*records)
        # map(len, …) iterates in C — measurably faster than a genexpr with a
        # Python-level len call per record on multi-100k batches
        klens = np.fromiter(map(len, key_list), dtype=np.int32, count=n)
        vlens = np.fromiter(map(len, val_list), dtype=np.int32, count=n)
        keys = np.frombuffer(b"".join(key_list), dtype=np.uint8)
        values = np.frombuffer(b"".join(val_list), dtype=np.uint8)
        return RecordBatch(klens, vlens, keys, values)

    @staticmethod
    def concat(batches: Sequence["RecordBatch"]) -> "RecordBatch":
        batches = [b for b in batches if b.n]
        if not batches:
            return RecordBatch.empty()
        if len(batches) == 1:
            return batches[0]
        return RecordBatch(
            np.concatenate([b.klens for b in batches]),
            np.concatenate([b.vlens for b in batches]),
            np.concatenate([b.keys for b in batches]),
            np.concatenate([b.values for b in batches]),
        )

    # ------------------------------------------------------------------
    def iter_records(self) -> Iterator[Tuple[bytes, bytes]]:
        """Per-record view — the API boundary. One bytes-slice per field."""
        kb = self.keys.tobytes()
        vb = self.values.tobytes()
        ko = self.koffsets.tolist()
        vo = self.voffsets.tolist()
        for i in range(self.n):
            yield kb[ko[i] : ko[i + 1]], vb[vo[i] : vo[i + 1]]

    def iter_keys(self) -> Iterator[bytes]:
        kb = self.keys.tobytes()
        ko = self.koffsets.tolist()
        for i in range(self.n):
            yield kb[ko[i] : ko[i + 1]]

    def to_records(self) -> List[Tuple[bytes, bytes]]:
        return list(self.iter_records())

    # ------------------------------------------------------------------
    def _fixed_width(self, lens: np.ndarray, slot: str) -> int:
        """Uniform row width of ``lens``, or -1 if ragged. Cached (O(n) once)."""
        w = getattr(self, slot)
        if w is None:
            if len(lens) == 0:
                w = -1
            else:
                w0 = int(lens[0])
                w = w0 if (lens == w0).all() else -1
            setattr(self, slot, w)
        return w

    def take(self, indices: np.ndarray) -> "RecordBatch":
        """Row gather. Uniform-width columns (the common shuffle shape —
        fixed-size keys/values) skip the offsets cumsum and use a fixed-stride
        gather; ragged columns use the vectorized ragged gather."""
        idx = np.asarray(indices, dtype=np.int64)
        kw = self._fixed_width(self.klens, "_kw")
        vw = self._fixed_width(self.vlens, "_vw")
        if kw >= 0:
            klens, keys = np.full(len(idx), kw, np.int32), _gather_fixed(self.keys, kw, idx)
        else:
            klens = self.klens[idx]
            keys = _ragged_gather(self.keys, self.koffsets, self.klens, idx)
        if vw >= 0:
            vlens, values = np.full(len(idx), vw, np.int32), _gather_fixed(self.values, vw, idx)
        else:
            vlens = self.vlens[idx]
            values = _ragged_gather(self.values, self.voffsets, self.vlens, idx)
        out = RecordBatch(klens, vlens, keys, values)
        out._kw = kw if kw >= 0 else None
        out._vw = vw if vw >= 0 else None
        return out

    def slice_rows(self, start: int, stop: int) -> "RecordBatch":
        """Contiguous row slice — zero-copy views."""
        n = self.n
        if start < 0:
            start += n
        if stop < 0:
            stop += n
        start = max(0, min(start, n))
        stop = max(start, min(stop, n))
        kw = self._fixed_width(self.klens, "_kw")
        vw = self._fixed_width(self.vlens, "_vw")
        if kw >= 0 and vw >= 0:
            # Fixed-width byte ranges are start·w — skips materializing the
            # (n+1)-int64 offset arrays, which on a 20M-row map batch are
            # two 160 MB cumsum allocations just to read two scalars each.
            out = RecordBatch(
                self.klens[start:stop],
                self.vlens[start:stop],
                self.keys[start * kw : stop * kw],
                self.values[start * vw : stop * vw],
            )
            out._kw, out._vw = kw, vw
            return out
        ko, vo = self.koffsets, self.voffsets
        return RecordBatch(
            self.klens[start:stop],
            self.vlens[start:stop],
            self.keys[ko[start] : ko[stop]],
            self.values[vo[start] : vo[stop]],
        )

    # ------------------------------------------------------------------
    def key_strings(self, width: Optional[int] = None) -> np.ndarray:
        """Keys as a fixed-width ``S{width}`` array (zero-padded). Numpy ``S``
        comparison is memcmp over the padded width, so ordering matches bytes
        ordering except when one key is a zero-padding prefix of another —
        resolve those ties with ``klens`` (see :meth:`argsort_by_key`)."""
        n = self.n
        kmax = int(self.klens.max()) if n else 0
        w = max(width or 0, kmax, 1)
        if n == 0:
            return np.empty(0, dtype=f"S{w}")
        if self._ks is not None and self._ks[0] == w:
            return self._ks[1]
        if kmax and (self.klens == kmax).all() and w == kmax:
            mat = np.ascontiguousarray(self.keys).reshape(n, kmax)
        else:
            mat = np.zeros((n, w), dtype=np.uint8)
            total = int(self.koffsets[-1])
            if total:
                rows = _segment_ids(self.koffsets, total)
                cols = np.arange(total, dtype=np.int64) - self.koffsets[rows]
                mat[rows, cols] = self.keys
        out = mat.view(f"S{w}").ravel()
        self._ks = (w, out)
        return out

    def _key_prefix_u64(self, offset: int = 0) -> np.ndarray:
        """8 key bytes starting at ``offset`` as native uint64 whose numeric
        order equals big-endian bytes order (zero-padded on the right).
        Nonzero offsets are only meaningful for uniform-width keys (batch-
        local ordering with constant leading columns skipped)."""
        n = self.n
        kw = self._fixed_width(self.klens, "_kw")
        if kw >= 0:
            mat = np.ascontiguousarray(self.keys).reshape(n, kw) if kw else None
            p8 = min(kw - offset, 8)
            if kw == 8 and offset == 0:
                pre = np.ascontiguousarray(mat)
            else:
                pre = np.zeros((n, 8), dtype=np.uint8)
                if p8 > 0:
                    pre[:, :p8] = mat[:, offset : offset + p8]
        else:
            pre = np.zeros((n, 8), dtype=np.uint8)
            ko, lens = self.koffsets, np.minimum(self.klens, 8).astype(np.int64)
            off = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(lens, out=off[1:])
            total = int(off[-1])
            if total:
                rows = _segment_ids(off, total)
                cols = np.arange(total, dtype=np.int64) - off[rows]
                pre[rows, cols] = self.keys[ko[rows] + cols]
        return pre.view(">u8").ravel().astype(np.uint64)

    def argsort_by_key(self) -> np.ndarray:
        """Stable lexicographic argsort over keys (true bytes ordering: the
        zero-pad prefix tie is broken by key length — a shorter key sorts
        before any key it zero-pad-prefixes).

        Implemented as a radix argsort over the 8-byte big-endian key prefix
        (O(n), no string compares) plus a vectorized refinement pass over
        equal-prefix groups — which is empty for high-entropy keys, so the
        common terasort-style case never touches numpy's string machinery."""
        n = self.n
        if n == 0:
            return np.empty(0, dtype=np.int64)
        klens = self.klens
        kw = self._fixed_width(klens, "_kw")
        skip = 0
        prefix_covers_key = 0 <= kw <= 8
        prefix = None
        second_cols = None
        if kw > 8:
            # Constant columns never affect batch-local ordering (zero-padded
            # decimals, low-cardinality leading columns, zero high bytes of
            # small ints — typed keys). Scan for the
            # VARYING columns: ≤8 of them pack into one u64 whose order
            # equals key order (→ single unstable argsort, identity
            # refinement); ≤16 pack into two words (one stable two-key
            # lexsort). Only beyond that fall back to the first-varying-
            # column prefix + padded-string tie refinement. Packing by
            # varying columns (not a contiguous window) is what keeps e.g.
            # (small-int, small-int) 16-byte keys out of the string path —
            # their 6 varying bytes straddle both words.
            mat = np.ascontiguousarray(self.keys).reshape(n, kw)
            varying = []
            for c in range(kw):
                col = mat[:, c]
                if (col != col[0]).any():
                    varying.append(c)
                    if len(varying) > 16:
                        break
            if not varying:
                return np.arange(n, dtype=np.int64)  # all keys identical
            second_cols = None
            if len(varying) <= 8:
                pre = np.zeros((n, 8), dtype=np.uint8)
                pre[:, : len(varying)] = mat[:, varying]
                prefix = pre.view(">u8").ravel().astype(np.uint64)
                prefix_covers_key = True
            elif len(varying) <= 16:
                # first word = first 8 varying columns → the fast unstable
                # argsort below; ties refine with the remaining columns
                # (numeric, never the padded-string path) — see the
                # second_cols refinement branch
                pre = np.zeros((n, 8), dtype=np.uint8)
                pre[:, :8] = mat[:, varying[:8]]
                prefix = pre.view(">u8").ravel().astype(np.uint64)
                second_cols = varying[8:]
            else:
                # >16 varying columns: first-varying-column prefix + the
                # padded-string tie refinement. varying[0] IS the first
                # differing column (< kw-16 here, so never past kw-8) —
                # no rescan needed, and the prefix can't cover the key.
                skip = varying[0]
                prefix_covers_key = False
        if prefix is None:
            prefix = self._key_prefix_u64(skip)
        # UNSTABLE introsort: ~5x faster than numpy's stable radix on uint64.
        # Stability is restored below — within every equal-prefix group the
        # refinement key ends with the original row index.
        order = np.argsort(prefix)
        ps = prefix[order]
        neq = ps[1:] != ps[:-1]
        if neq.all():
            return order  # all prefixes distinct → total order, no ties at all
        kmax = kw if kw >= 0 else int(klens.max())
        gid = np.zeros(n, dtype=np.int64)
        np.cumsum(neq, out=gid[1:])
        sizes = np.bincount(gid)
        pos = np.flatnonzero(sizes[gid] > 1)  # members of multi-element groups
        sub = order[pos]
        if prefix_covers_key and n < (1 << 32):
            # the prefix spans every non-constant key byte, so equal prefix ==
            # equal key → restore original index order. (group, index) pairs
            # are unique, so one unstable u64 argsort of the packed pair is
            # deterministic and exact.
            refined = np.argsort(
                (gid[pos].astype(np.uint64) << 32) | sub.astype(np.uint64)
            )
        elif second_cols is not None:
            if len(pos) > (n >> 2):
                # heavy ties (low-entropy first word — e.g. a small-int
                # leading column): per-tie refinement would re-sort most of
                # the batch with three keys; ONE stable two-word lexsort over
                # everything is cheaper. Ordering = (word0, word1) = the
                # varying key bytes in order; lexsort stability gives
                # insertion order on full ties.
                w1 = np.zeros((n, 8), dtype=np.uint8)
                w1[:, : len(second_cols)] = mat[:, second_cols]
                return np.lexsort(
                    (w1.view(">u8").ravel().astype(np.uint64), prefix)
                )
            # sparse ties: numeric second word over just the tied rows
            w1s = np.zeros((len(pos), 8), dtype=np.uint8)
            w1s[:, : len(second_cols)] = mat[np.ix_(sub, second_cols)]
            refined = np.lexsort(
                (sub, w1s.view(">u8").ravel().astype(np.uint64), gid[pos])
            )
        elif kmax <= 8:
            # equal prefix + ragged lens: shorter (zero-pad-prefix) key first,
            # then original index for stability
            refined = np.lexsort((sub, klens[sub], gid[pos]))
        else:
            refined = np.lexsort((sub, klens[sub], self.key_strings()[sub], gid[pos]))
        order[pos] = sub[refined]
        return order


def cut_sorted_head(p: "RecordBatch", bound: bytes, inclusive: bool) -> int:
    """Rows at the head of key-sorted batch ``p`` with key < ``bound``
    (``inclusive=False``) or ≤ ``bound`` (``inclusive=True``), exact bytes
    order. Used by the k-way run merge in :class:`BatchSorter` (exclusive
    cuts, and inclusive ones when it streams one key — equal keys must keep
    run order). Uses the batch's natural-width padded key strings
    (cached on the batch, so untouched merge chunks don't re-pad every
    round); the S-compare pad-tie is resolved with klens — pad-tied rows sort
    short-first within a sorted run. A bound longer than the batch width
    compares greater than every pad-tied row (each such row is a proper
    zero-pad prefix of the bound)."""
    width = max(int(p.klens.max()) if p.n else 0, 1)
    ks = p.key_strings(width=width)
    bs = np.array([bound[:width]], dtype=f"S{width}")[0]
    lo = int(np.searchsorted(ks, bs, side="left"))
    hi = int(np.searchsorted(ks, bs, side="right"))
    if len(bound) > width:
        return hi  # every pad-tied row is a proper prefix of bound → < bound
    side = "right" if inclusive else "left"
    return lo + int(np.searchsorted(p.klens[lo:hi], len(bound), side=side))


def _segment_ids(boundaries: np.ndarray, total: int) -> np.ndarray:
    """Map output position → segment index given segment ``boundaries``
    (int64, length m+1, boundaries[0]=0, boundaries[-1]=total). Vectorized
    (bincount+cumsum) — O(total), no np.repeat (which walks segments in C one
    by one)."""
    inner = boundaries[1:-1]
    inner = inner[inner < total]  # trailing empty segments
    return np.cumsum(np.bincount(inner, minlength=total))


def _gather_fixed(buf: np.ndarray, row_len: int, idx: np.ndarray) -> np.ndarray:
    """Fixed-stride row gather: rows are ``row_len`` bytes each."""
    if row_len == 0 or len(idx) == 0:
        return _EMPTY_U8
    return np.ascontiguousarray(buf).reshape(-1, row_len)[idx].ravel()


def _ragged_gather(
    buf: np.ndarray, offsets: np.ndarray, lens: np.ndarray, idx: np.ndarray
) -> np.ndarray:
    out_lens = lens[idx].astype(np.int64)
    total = int(out_lens.sum())
    if total == 0:
        return _EMPTY_U8
    out_off = np.zeros(len(idx) + 1, dtype=np.int64)
    np.cumsum(out_lens, out=out_off[1:])
    seg = _segment_ids(out_off, total)
    flat = (
        np.arange(total, dtype=np.int64)
        - out_off[seg]
        + np.asarray(offsets)[idx][seg]
    )
    return np.ascontiguousarray(buf)[flat]


# ----------------------------------------------------------------------------
# Columnar wire frames: [u32 payload_len][u32 n][klens i32*n][vlens i32*n]
#                       [keys][values]
# Self-delimiting → concatenatable → relocatable (the property the reference
# requires for batch fetch, S3ShuffleReader.scala:55-75).
# ----------------------------------------------------------------------------


def write_frame(sink: BinaryIO, batch: RecordBatch) -> None:
    if batch.n == 0:
        return
    klens = np.ascontiguousarray(batch.klens, dtype=np.int32)
    vlens = np.ascontiguousarray(batch.vlens, dtype=np.int32)
    keys = np.ascontiguousarray(batch.keys)
    values = np.ascontiguousarray(batch.values)
    payload_len = 4 + klens.nbytes + vlens.nbytes + keys.nbytes + values.nbytes
    sink.write(_U32.pack(payload_len) + _U32.pack(batch.n))
    # byte-format memoryviews, NOT tobytes(): tobytes copies the column
    # before the sink copies it again — one full extra pass over the data
    for arr in (klens, vlens, keys, values):
        if arr.nbytes:
            sink.write(arr.view(np.uint8).data)


def read_frames(source: BinaryIO) -> Iterator[RecordBatch]:
    from s3shuffle_tpu_torch.utils.io import read_fully_view

    while True:
        # read_fully_view: a codec/prefetch stream may return short reads at
        # frame boundaries — only 0 bytes means EOF. Payloads come back as
        # whatever buffer the stream holds (bytes, or a zero-copy ndarray view
        # of a batch-decoded run) and flow into np.frombuffer uncopied.
        header = read_fully_view(source, _U32.size)
        if not len(header):
            return
        if len(header) < _U32.size:
            raise IOError("Truncated columnar frame header")
        (payload_len,) = _U32.unpack(header)  # accepts any buffer-protocol piece
        payload = read_fully_view(source, payload_len)
        if len(payload) < payload_len:
            raise IOError(f"Truncated columnar frame ({len(payload)}/{payload_len})")
        yield parse_frame_payload(payload)


def parse_frame_payload(payload: bytes) -> RecordBatch:
    (n,) = _U32.unpack_from(payload, 0)
    off = 4
    klens = np.frombuffer(payload, dtype=np.int32, count=n, offset=off)
    off += 4 * n
    vlens = np.frombuffer(payload, dtype=np.int32, count=n, offset=off)
    off += 4 * n
    ktotal = int(klens.sum(dtype=np.int64))
    vtotal = int(vlens.sum(dtype=np.int64))
    if off + ktotal + vtotal != len(payload):
        raise IOError(
            f"Columnar frame length mismatch: {off + ktotal + vtotal} != {len(payload)}"
        )
    keys = np.frombuffer(payload, dtype=np.uint8, count=ktotal, offset=off)
    values = np.frombuffer(payload, dtype=np.uint8, count=vtotal, offset=off + ktotal)
    return RecordBatch(klens, vlens, keys, values)


#: Default rows per columnar chunk wherever record streams are re-chunked
#: into batches (writer routing, sorter output).
DEFAULT_CHUNK_RECORDS = 1 << 16
#: Byte ceiling per chunk — bounds memory overshoot for large records (the
#: write plane checks its spill budget once per chunk).
DEFAULT_CHUNK_BYTES = 16 << 20


def iter_record_batches(
    records,
    chunk_records: int = DEFAULT_CHUNK_RECORDS,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
) -> Iterator[RecordBatch]:
    """Chunk a record source (RecordBatch, sequence, or iterator of (k, v)
    bytes tuples) into RecordBatches bounded by rows AND bytes."""
    if isinstance(records, RecordBatch):
        yield from _iter_bounded_slices(records, chunk_records, chunk_bytes)
        return
    if isinstance(records, (list, tuple)):
        # Sequence fast path: slice-chunk with no per-record Python loop in
        # the common case. Byte sizes are measured (C-speed map(len)) BEFORE
        # columnarizing, so a chunk_records-row slice of huge records is
        # trimmed first and peak allocation stays bounded by chunk_bytes.
        n = len(records)
        start = 0
        while start < n:
            sl = records[start : start + chunk_records]
            ks, vs = zip(*sl)
            sizes = (
                np.fromiter(map(len, ks), np.int64, len(sl))
                + np.fromiter(map(len, vs), np.int64, len(sl))
                + 8
            )
            cum = np.cumsum(sizes)
            if int(cum[-1]) > chunk_bytes:
                cut = max(1, int(np.searchsorted(cum, chunk_bytes, side="right")))
                sl = sl[:cut]
            yield RecordBatch.from_records(sl)
            start += len(sl)
        return
    pending: List[Tuple[bytes, bytes]] = []
    pending_bytes = 0
    for kv in records:
        pending.append(kv)
        pending_bytes += len(kv[0]) + len(kv[1]) + 8
        if len(pending) >= chunk_records or pending_bytes >= chunk_bytes:
            yield RecordBatch.from_records(pending)
            pending = []
            pending_bytes = 0
    if pending:
        yield RecordBatch.from_records(pending)


def _iter_bounded_slices(
    batch: RecordBatch, chunk_records: int, chunk_bytes: int
) -> Iterator[RecordBatch]:
    """Zero-copy row slices of ``batch`` bounded by rows AND bytes (a slice
    holding a single oversized record may exceed the byte bound)."""
    kw = batch._fixed_width(batch.klens, "_kw")
    vw = batch._fixed_width(batch.vlens, "_vw")
    if kw >= 0 and vw >= 0:
        # Uniform rows: the chunk row count is arithmetic — skip building
        # three (n,)-int64 arrays + two cumsums per map batch just to find
        # slice bounds.
        per_row = kw + vw + 8
        step = max(1, min(chunk_records, chunk_bytes // per_row))
        for lo in range(0, batch.n, step):
            yield batch.slice_rows(lo, min(lo + step, batch.n))
        return
    row_bytes = batch.koffsets[1:] + batch.voffsets[1:] + 8 * np.arange(1, batch.n + 1)
    lo = 0
    while lo < batch.n:
        base = int(row_bytes[lo - 1]) if lo else 0
        hi = int(np.searchsorted(row_bytes, base + chunk_bytes, side="right"))
        hi = max(hi, lo + 1)
        hi = min(hi, lo + chunk_records, batch.n)
        yield batch.slice_rows(lo, hi)
        lo = hi


# ----------------------------------------------------------------------------
# Partition routing
# ----------------------------------------------------------------------------


def split_by_partition(
    batch: RecordBatch, pids: np.ndarray, num_partitions: int
) -> Tuple[RecordBatch, np.ndarray]:
    """Stable-group rows by partition id. Returns (grouped_batch, bounds) where
    partition p's rows are ``grouped.slice_rows(bounds[p], bounds[p+1])``."""
    pids = np.asarray(pids)
    if num_partitions <= 0xFFFF and pids.dtype != np.uint16:
        # narrow dtype → 2 radix passes in the stable argsort instead of 8
        pids = pids.astype(np.uint16)
    order = np.argsort(pids, kind="stable")
    grouped = batch.take(order)
    bounds = np.searchsorted(pids[order], np.arange(num_partitions + 1))
    return grouped, bounds


# ----------------------------------------------------------------------------
# Batch external sorter: vectorized in-memory sort, columnar spill runs with a
# record-wise heap merge when over budget (same contract as sorter.ExternalSorter,
# which mirrors Spark's ExternalSorter — S3ShuffleReader.scala:141-149).
# ----------------------------------------------------------------------------


def sort_batches(batches: Sequence[RecordBatch]) -> RecordBatch:
    """Key-sort the concatenation of ``batches`` (a keys-only argsort, then
    one gather; the JAX package gathers rows straight out of the source
    batches with its native segmented gather — the same batch)."""
    return RecordBatch.concat(batches).take(argsort_batches_by_key(batches))


def argsort_batches_by_key(batches: Sequence[RecordBatch]) -> np.ndarray:
    """Stable key argsort over the virtual concatenation of ``batches``,
    materializing only the KEY columns — the values (the bulk of shuffle
    bytes) never move."""
    batches = [b for b in batches if b.n]
    if not batches:
        return np.empty(0, dtype=np.int64)
    if len(batches) == 1:
        return batches[0].argsort_by_key()
    total = sum(b.n for b in batches)
    keys_only = RecordBatch(
        np.concatenate([b.klens for b in batches]),
        np.zeros(total, dtype=np.int32),
        np.concatenate([b.keys for b in batches]),
        np.empty(0, dtype=np.uint8),
    )
    return keys_only.argsort_by_key()


#: bucket fanout of the external sort's spill plane: rows spill bucketed by
#: their first key byte, so draining is per-bucket (read → one small sort)
#: with no cross-run merge. 256 = every possible first byte, which makes
#: bucket order == lexicographic order by construction.
SORT_BUCKETS = 256


class BatchSorter:
    """External columnar sort: bounded memory via BUCKET spills.

    Spill events radix-partition the buffered rows by first key byte — an
    O(n) stable pass, NOT a sort — and append each bucket's rows (columnar
    frames) to per-bucket segments of a spill file. Draining then processes
    buckets in byte order: a bucket's segments concatenate in insertion
    order and one small argsort orders them. Compared to the sorted-run +
    k-way-merge design this replaces, each spilled row pays a cheap radix
    pass instead of a full argsort at spill time and never pays a merge;
    the sorts it does pay are bucket-sized — cache-resident for uniform
    keys.

    A bucket whose bytes exceed the budget (heavy first-byte skew) falls
    back to the previous design scoped to that bucket: its segments are
    re-sorted into bounded runs and frontier-merged (:meth:`_merge_runs`),
    preserving equal-key insertion order exactly like the record-wise heap
    merge both designs replace.

    Parity: the role of Spark's ExternalSorter on the reduce side
    (S3ShuffleReader.scala:141-149) — byte-budgeted, order-stable.
    """

    def __init__(self, spill_bytes: int = 1 << 28, spill_dir: Optional[str] = None):
        self._spill_bytes = max(1, spill_bytes)
        self._spill_dir = spill_dir
        self._pending: List[RecordBatch] = []
        self._pending_bytes = 0
        #: per bucket: list of (spill-file index, offset, length)
        self._segments: List[List[Tuple[int, int, int]]] = [
            [] for _ in range(SORT_BUCKETS)
        ]
        self._files: List[str] = []
        self._tmp_runs: List[str] = []  # skew-fallback run files
        self.spill_count = 0

    def add(self, batch: RecordBatch) -> None:
        if batch.n == 0:
            return
        self._pending.append(batch)
        self._pending_bytes += batch.nbytes
        if self._pending_bytes > self._spill_bytes:
            self._spill()

    def _sorted_pending(self) -> RecordBatch:
        batches = self._pending
        self._pending = []
        self._pending_bytes = 0
        if not batches:
            return RecordBatch.empty()
        return sort_batches(batches)

    @staticmethod
    def _first_key_bytes(batch: RecordBatch) -> np.ndarray:
        """First byte of each key (empty keys → 0, which also sorts first)."""
        first = np.zeros(batch.n, dtype=np.uint8)
        nz = batch.klens > 0
        if nz.any():
            first[nz] = batch.keys[batch.koffsets[:-1][nz]]
        return first

    def _spill(self) -> None:
        batches = self._pending
        self._pending = []
        self._pending_bytes = 0
        if not batches:
            return
        buckets = np.concatenate([self._first_key_bytes(b) for b in batches])
        # stable radix pass: rows grouped by bucket, insertion order kept
        grouped = RecordBatch.concat(batches).take(np.argsort(buckets, kind="stable"))
        bounds = np.zeros(SORT_BUCKETS + 1, dtype=np.int64)
        np.cumsum(np.bincount(buckets, minlength=SORT_BUCKETS), out=bounds[1:])
        fd, path = tempfile.mkstemp(prefix="s3shuffle-batchsort-", dir=self._spill_dir)
        # register the file BEFORE writing: a mid-write failure must leave it
        # reachable by cleanup(), and a later spill must never reuse its index
        fidx = len(self._files)
        self._files.append(path)
        with os.fdopen(fd, "wb") as f:
            for b in range(SORT_BUCKETS):
                lo, hi = int(bounds[b]), int(bounds[b + 1])
                if hi == lo:
                    continue
                start = f.tell()
                # chunk the segment so drain readers never need a whole
                # segment's rows in one frame
                for chunk in iter_record_batches(grouped.slice_rows(lo, hi)):
                    write_frame(f, chunk)
                self._segments[b].append((fidx, start, f.tell() - start))
        self.spill_count += 1

    def _read_segment(self, fh, offset: int, length: int) -> List[RecordBatch]:
        """Parse a segment's frames from ONE read — frame payloads are
        np.frombuffer views into the segment buffer, not re-copies."""
        fh.seek(offset)
        buf = fh.read(length)
        out: List[RecordBatch] = []
        off = 0
        while off < len(buf):
            if off + _U32.size > len(buf):
                raise IOError("Truncated columnar frame header in spill segment")
            (payload_len,) = _U32.unpack_from(buf, off)
            off += _U32.size
            if off + payload_len > len(buf):
                raise IOError(
                    f"Truncated columnar frame in spill segment "
                    f"({len(buf) - off}/{payload_len})"
                )
            out.append(parse_frame_payload(memoryview(buf)[off : off + payload_len]))
            off += payload_len
        return out

    def sorted_records(self) -> Iterator[Tuple[bytes, bytes]]:
        for batch in self.sorted_batches():
            yield from batch.iter_records()

    def sorted_batches(
        self, chunk_records: int = DEFAULT_CHUNK_RECORDS
    ) -> Iterator[RecordBatch]:
        """Sorted output as columnar batches, bucket by bucket (see class
        docstring); equal keys come back in insertion order."""
        if not self._files:
            try:
                final = self._sorted_pending()
            except BaseException:
                self.cleanup()
                raise
            yield from iter_record_batches(final, chunk_records=chunk_records)
            return
        try:
            self._spill()  # bucket the in-memory remainder too
            handles = [open(p, "rb") for p in self._files]
            try:
                for b in range(SORT_BUCKETS):
                    segs = self._segments[b]
                    if not segs:
                        continue
                    total = sum(length for _f, _o, length in segs)
                    if total <= self._spill_bytes:
                        parts: List[RecordBatch] = []
                        for fidx, off, length in segs:
                            parts.extend(self._read_segment(handles[fidx], off, length))
                        yield from iter_record_batches(
                            sort_batches(parts), chunk_records=chunk_records
                        )
                    else:
                        yield from self._drain_skewed_bucket(
                            handles, segs, chunk_records
                        )
            finally:
                for fh in handles:
                    fh.close()
        finally:
            self.cleanup()

    def _drain_skewed_bucket(
        self, handles, segs, chunk_records: int
    ) -> Iterator[RecordBatch]:
        """Skew fallback: one bucket larger than the budget. Re-sort its
        segments (in insertion order) into bounded sorted runs, then frontier-
        merge the runs — the previous whole-partition design, scoped to the
        one bucket that needs it."""
        run_paths: List[str] = []
        acc: List[RecordBatch] = []
        acc_bytes = 0

        def flush_run() -> None:
            nonlocal acc, acc_bytes
            batches, acc = acc, []
            acc_bytes = 0
            if not batches:
                return
            run = sort_batches(batches)
            if run.n == 0:
                return
            fd, path = tempfile.mkstemp(
                prefix="s3shuffle-batchsort-run-", dir=self._spill_dir
            )
            with os.fdopen(fd, "wb") as f:
                for chunk in iter_record_batches(run):
                    write_frame(f, chunk)
            run_paths.append(path)
            self._tmp_runs.append(path)

        for fidx, off, length in segs:
            for fr in self._read_segment(handles[fidx], off, length):
                acc.append(fr)
                acc_bytes += fr.nbytes
                if acc_bytes > self._spill_bytes:
                    flush_run()
        flush_run()
        yield from self._merge_runs(
            [self._iter_run_batches(p) for p in run_paths], chunk_records
        )

    def _iter_run_batches(self, path: str) -> Iterator[RecordBatch]:
        with open(path, "rb") as f:
            yield from read_frames(f)

    _cut = staticmethod(cut_sorted_head)

    def _merge_runs(
        self, iters: List[Optional[Iterator[RecordBatch]]], chunk_records: int
    ) -> Iterator[RecordBatch]:
        """Bounded-memory columnar k-way merge of SORTED run iterators. Bulk
        rounds emit every loaded row strictly below the frontier (the smallest
        LAST-loaded key of any undrained run — later chunks of those runs hold
        only keys ≥ it) as one concat + stable sort. When duplicates of the
        frontier key dominate (zero bulk progress), that single key is
        streamed run-by-run in index order, loading one chunk at a time, so
        equal keys keep run (= insertion) order and residency stays
        O(runs × chunk)."""
        pending: List[RecordBatch] = [RecordBatch.empty() for _ in iters]

        def refill(r: int) -> None:
            if pending[r].n == 0 and iters[r] is not None:
                nxt = next(iters[r], None)
                if nxt is None:
                    iters[r] = None
                else:
                    pending[r] = nxt

        while True:
            for r in range(len(iters)):
                refill(r)
            live = [r for r in range(len(iters)) if iters[r] is not None]
            if not live:
                rest = RecordBatch.concat([p for p in pending if p.n])
                if rest.n:
                    out = rest.take(rest.argsort_by_key())
                    yield from iter_record_batches(out, chunk_records=chunk_records)
                return
            frontier = min(
                pending[r].keys[pending[r].koffsets[-2] :].tobytes() for r in live
            )
            cuts = [self._cut(p, frontier, inclusive=False) if p.n else 0 for p in pending]
            if sum(cuts):
                emit = RecordBatch.concat(
                    [p.slice_rows(0, c) for p, c in zip(pending, cuts) if c]
                )
                for r, c in enumerate(cuts):
                    if c:
                        pending[r] = pending[r].slice_rows(c, pending[r].n)
                out = emit.take(emit.argsort_by_key())
                yield from iter_record_batches(out, chunk_records=chunk_records)
                continue
            # zero bulk progress: every loaded row is ≥ frontier, and each
            # run's head class is == frontier. Stream the frontier key in run
            # order, one chunk resident at a time.
            for r in range(len(iters)):
                while True:
                    refill(r)
                    p = pending[r]
                    if p.n == 0:
                        break  # run drained
                    m = self._cut(p, frontier, inclusive=True)
                    if m == 0:
                        break  # this run is past the frontier key
                    yield from iter_record_batches(
                        p.slice_rows(0, m), chunk_records=chunk_records
                    )
                    pending[r] = p.slice_rows(m, p.n)
                    if pending[r].n:
                        break  # rows beyond the frontier remain loaded
            continue

    def cleanup(self) -> None:
        for path in self._files + self._tmp_runs:
            try:
                os.remove(path)
            except OSError:
                pass
        self._files = []
        self._tmp_runs = []
        self._segments = [[] for _ in range(SORT_BUCKETS)]
