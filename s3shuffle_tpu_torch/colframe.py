"""Column-frame wire format (a copy of the JAX package's ``colframe.py``;
the bytes are the same).

The legacy columnar frame (:mod:`s3shuffle_tpu_torch.batch`, ``[u32 len]
[u32 n][klens][vlens][keys][values]``) ships one i32 length per row per
column even when key and value widths are fixed. The column frame is the
self-describing replacement:

- a BE-int64 header (magic, wire version, schema word, row count, column
  count) followed by a per-column ``[dtype, width, nbytes]`` table, so the
  reader learns the frame's layout before touching the payload and
  deserializes every column as one zero-copy ``np.frombuffer`` view;
- fixed-width columns carry only their payload bytes (width in the table);
  ragged columns ship an i32 length array followed by the bytes;
- the outer ``[u32 payload_len]`` envelope is kept, so column frames are
  self-delimiting and concatenatable (the relocatable-serializer property)
  and flow through the codec machinery unchanged.

Readers auto-detect the frame kind per frame (the payload's first 8 bytes
are the magic). Writers choose by the ``columnar`` config knob, resolved at
the map-writer seam.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Iterator, List, Tuple

import numpy as np

from s3shuffle_tpu_torch.batch import RecordBatch, parse_frame_payload
from s3shuffle_tpu_torch.utils import trace

_U32 = struct.Struct("<I")
_BE64 = np.dtype(">i8")

#: wire-schema binding (wire/schema.py); WIRE01 holds the constants below
#: against the registry
_WIRE_STRUCTS = ("column_frame",)

#: "S3COLFRM" as a BE int64 word — first 8 payload bytes of a column frame
COLFRAME_MAGIC = 0x5333434F4C46524D
_WIRE_VERSION = 1
#: header words: magic, wire version, schema word, n rows, n columns
HEADER_WORDS = 5
#: per-column table words: dtype code, fixed row width (0 when varlen),
#: column payload bytes
COLUMN_WORDS = 3

#: column dtype codes
DTYPE_FIXED = 1  # fixed-width rows: payload is n*width raw bytes
DTYPE_VARLEN = 2  # ragged rows: payload is [i32 len]*n then the bytes

#: schema word values (an application tag, not a shape: the column table
#: alone determines the byte layout). 0 = untyped bytes-KV.
SCHEMA_BYTES_KV = 0

#: row cap for frames with NO payload bytes (both columns fixed width 0):
#: nothing on the wire bounds such a frame's row count, so the parser
#: refuses beyond this — and the writer routes bigger degenerate batches
#: through the legacy framing (whose per-row lens bound n by payload), so
#: every frame the plane writes is readable by construction.
EMPTY_ROW_CAP = 1 << 24

_MAGIC_BYTES = COLFRAME_MAGIC.to_bytes(8, "big")


class ColumnFrame:
    """A parsed column frame: the decoded RecordBatch plus its wire-level
    column descriptors (``(dtype, width, nbytes)`` per column, key column
    first). The descriptors let typed consumers reason about the layout
    without re-scanning the length arrays."""

    __slots__ = ("schema", "columns", "batch")

    def __init__(
        self,
        schema: int,
        columns: Tuple[Tuple[int, int, int], ...],
        batch: RecordBatch,
    ):
        self.schema = schema
        self.columns = columns
        self.batch = batch

    @property
    def n(self) -> int:
        return self.batch.n


def _column_spec(lens: np.ndarray, data: np.ndarray, width: int):
    """(dtype, width, nbytes, buffers-to-write) for one column."""
    if width >= 0:
        return (DTYPE_FIXED, width, int(data.nbytes), (data,))
    # "<i4" explicitly: the registered wire layout pins varlen lengths as
    # i32-LE — native order would silently write BE lengths on a BE host
    lens32 = np.ascontiguousarray(lens, dtype="<i4")
    return (DTYPE_VARLEN, 0, int(lens32.nbytes + data.nbytes), (lens32, data))


def write_column_frame(
    sink: BinaryIO, batch: RecordBatch, schema: int = SCHEMA_BYTES_KV
) -> bool:
    """Emit ``batch`` as one column frame (empty batches emit nothing —
    same contract as the legacy :func:`~s3shuffle_tpu_torch.batch.write_frame`).
    Column payloads are written as zero-copy memoryviews, never copied
    through ``tobytes``. Returns whether a column frame was written (False:
    the degenerate-shape legacy fallback below), so the serializer's frame
    counter reports what landed on the wire."""
    n = batch.n
    if n == 0:
        return True
    keys = np.ascontiguousarray(batch.keys)
    values = np.ascontiguousarray(batch.values)
    kcol = _column_spec(batch.klens, keys, batch._fixed_width(batch.klens, "_kw"))
    vcol = _column_spec(batch.vlens, values, batch._fixed_width(batch.vlens, "_vw"))
    if kcol[2] + vcol[2] == 0 and n > EMPTY_ROW_CAP:
        # degenerate all-empty-rows batch beyond the parser's cap: the
        # legacy frame ships 8 lens bytes per row, which bounds n by
        # payload — never write a frame our own reader refuses
        from s3shuffle_tpu_torch.batch import write_frame

        write_frame(sink, batch)
        return False
    header = np.empty(HEADER_WORDS + 2 * COLUMN_WORDS, dtype=_BE64)
    header[:HEADER_WORDS] = (COLFRAME_MAGIC, _WIRE_VERSION, schema, n, 2)
    header[HEADER_WORDS : HEADER_WORDS + COLUMN_WORDS] = kcol[:3]
    header[HEADER_WORDS + COLUMN_WORDS :] = vcol[:3]
    payload_len = header.nbytes + kcol[2] + vcol[2]
    sink.write(_U32.pack(payload_len) + header.tobytes())
    for col in (kcol, vcol):
        for arr in col[3]:
            if arr.nbytes:
                sink.write(arr.view(np.uint8).data)
    return True


def is_column_frame_payload(payload) -> bool:
    """True when a frame payload's leading bytes carry the column-frame
    magic (the per-frame auto-detect used by :func:`read_frames_auto`)."""
    return len(payload) >= 8 and bytes(payload[:8]) == _MAGIC_BYTES


def parse_column_frame(payload) -> ColumnFrame:
    """One-pass zero-copy parse of a column-frame payload (any
    buffer-protocol object): every column comes back as an ``np.frombuffer``
    view into ``payload``; fixed-width columns additionally pre-seed the
    batch's uniform-width caches so every downstream fast path (fixed-stride
    gather, arithmetic row slicing, prefix sort) engages without an O(n)
    re-scan."""
    if len(payload) < (HEADER_WORDS + 2 * COLUMN_WORDS) * 8:
        raise IOError(f"column-frame payload truncated ({len(payload)} bytes)")
    head = np.frombuffer(payload, dtype=_BE64, count=HEADER_WORDS, offset=0)
    if int(head[0]) != COLFRAME_MAGIC:
        raise IOError(f"bad column-frame magic {int(head[0]):#x}")
    if int(head[1]) != _WIRE_VERSION:
        raise IOError(f"column-frame wire version {int(head[1])} != {_WIRE_VERSION}")
    schema, n, ncols = int(head[2]), int(head[3]), int(head[4])
    if ncols != 2:
        raise IOError(f"column frame has {ncols} columns; expected 2 (keys, values)")
    # Row-count sanity BEFORE any n-sized allocation: the header word is
    # int64, so a corrupt frame could otherwise claim a row count whose
    # per-row length arrays alone are a multi-GiB np.full. Every non-empty
    # column bounds n through its own nbytes check below (fixed: n*width;
    # varlen: 4 bytes of lens per row); only the degenerate all-empty-rows
    # shape is unbounded by payload bytes, so it gets an explicit cap far
    # above any writer's chunk size.
    if n < 0 or n > 0xFFFFFFFF:
        raise IOError(f"column-frame row count {n} out of range")
    table = np.frombuffer(
        payload, dtype=_BE64, count=ncols * COLUMN_WORDS,
        offset=HEADER_WORDS * 8,
    ).reshape(ncols, COLUMN_WORDS)
    off = (HEADER_WORDS + ncols * COLUMN_WORDS) * 8
    if off + int(table[:, 2].sum()) != len(payload):
        raise IOError(
            f"column-frame length mismatch: {off + int(table[:, 2].sum())} "
            f"!= {len(payload)}"
        )
    if int(table[:, 2].sum()) == 0 and n > EMPTY_ROW_CAP:
        # all-empty-rows frame: no payload byte bounds n, so a corrupt
        # header could still demand n-sized length arrays. The writer
        # routes such batches through the legacy framing (see
        # write_column_frame), so a conforming producer never hits this.
        raise IOError(f"empty-row column frame claims {n} rows")
    cols: List[Tuple] = []  # (lens-or-None, data, fixed-width-or-neg)
    columns: List[Tuple[int, int, int]] = []
    for dtype, width, nbytes in ((int(r[0]), int(r[1]), int(r[2])) for r in table):
        columns.append((dtype, width, nbytes))
        if dtype == DTYPE_FIXED:
            if width < 0 or nbytes != n * width:
                raise IOError(
                    f"fixed column payload {nbytes} != n*width ({n}*{width})"
                )
            data = np.frombuffer(payload, dtype=np.uint8, count=nbytes, offset=off)
            cols.append((None, data, width))
        elif dtype == DTYPE_VARLEN:
            if nbytes < 4 * n:
                raise IOError(f"varlen column payload {nbytes} < lens array {4 * n}")
            lens = np.frombuffer(payload, dtype="<i4", count=n, offset=off)
            if n and int(lens.min()) < 0:
                # a negative length could cancel against the others in the
                # sum check and parse "successfully" into wrong records
                raise IOError("negative row length in varlen column")
            total = int(lens.sum(dtype=np.int64))
            if 4 * n + total != nbytes:
                raise IOError(
                    f"varlen column bytes {nbytes} != lens {4 * n} + data {total}"
                )
            data = np.frombuffer(
                payload, dtype=np.uint8, count=total, offset=off + 4 * n
            )
            cols.append((lens, data, -1))
        else:
            raise IOError(f"unknown column dtype code {dtype}")
        off += nbytes
    (klens, keys, kw), (vlens, values, vw) = cols
    if kw >= 0 and vw >= 0:
        # both columns fixed: width caches pre-seeded straight from the wire
        # table — no downstream uniformity re-scan, ever
        batch = RecordBatch.from_fixed(n, kw, vw, keys, values)
    else:
        batch = RecordBatch(
            klens if klens is not None else np.full(n, kw, dtype=np.int32),
            vlens if vlens is not None else np.full(n, vw, dtype=np.int32),
            keys,
            values,
        )
        batch._kw = kw if kw >= 0 else None
        batch._vw = vw if vw >= 0 else None
    return ColumnFrame(schema, tuple(columns), batch)


def parse_any_frame(payload) -> RecordBatch:
    """Parse one frame payload of EITHER kind into a RecordBatch."""
    if is_column_frame_payload(payload):
        return parse_column_frame(payload).batch
    return parse_frame_payload(payload)


def read_frames_auto(source: BinaryIO, on_frame=None, sink=None) -> Iterator[RecordBatch]:
    """Yield RecordBatches from a stream of frames of either kind (legacy
    and column frames may interleave — e.g. spill segments written before a
    mid-job retune concatenated with frames written after). ``on_frame``
    (optional) receives ``(is_column, batch)`` per frame: the serializer's
    metrics hook, kept out of the parse loop's fast path. Each parse of a
    payload already read is a ``record.deserialize`` stage, timed into
    ``sink`` (see :func:`~s3shuffle_tpu_torch.utils.trace.stage`)."""
    from s3shuffle_tpu_torch.utils.io import read_fully_view

    while True:
        header = read_fully_view(source, _U32.size)
        if not len(header):
            return
        if len(header) < _U32.size:
            raise IOError("Truncated frame header")
        (payload_len,) = _U32.unpack(header)
        payload = read_fully_view(source, payload_len)
        if len(payload) < payload_len:
            raise IOError(f"Truncated frame ({len(payload)}/{payload_len})")
        with trace.stage("record.deserialize", sink, "record_host_s"):
            column = is_column_frame_payload(payload)
            batch = parse_column_frame(payload).batch if column else parse_frame_payload(payload)
        if on_frame is not None:
            on_frame(column, batch)
        yield batch
