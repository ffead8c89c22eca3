"""Record serialization (a copy of the JAX package's ``serializer.py``; the
stream bytes are the same).

Parity: the reference reuses Spark's serializer machinery (Java/Kryo via
``SerializerManager`` — storage/S3ShuffleReader.scala:98-110); this package
owns the seam. A serializer turns (key, value) records into a byte stream
and back; ``relocatable`` serializers produce streams whose concatenation
equals the serialization of the concatenated records — the property Spark
calls ``supportsRelocationOfSerializedObjects`` and the reference requires
for batch fetch (S3ShuffleReader.scala:55-75).
"""

from __future__ import annotations

import pickle
import struct
import time
from typing import Any, BinaryIO, Iterable, Iterator, Optional, Tuple

from s3shuffle_tpu_torch.metrics import registry as _metrics
from s3shuffle_tpu_torch.utils.io import read_fully as _read_fully

_U32 = struct.Struct("<I")

# Record-plane instruments: frames moved by wire format and side, rows
# through the batch plane, and rows that took a per-record route. Frame or
# chunk granular, never touched per record.
_C_FRAMES = _metrics.REGISTRY.counter(
    "record_frames_total",
    "Columnar record frames moved, by wire format and plane side",
    labelnames=("format", "plane"),
)
_C_ROWS = _metrics.REGISTRY.counter(
    "record_rows_total",
    "Records moved through the VECTORIZED columnar routes, by plane side "
    "(counted at the route, not the frame — rows a scalar route pushes "
    "through columnar frames land only in record_fallback_rows_total)",
    labelnames=("plane",),
)
_C_FALLBACK = _metrics.REGISTRY.counter(
    "record_fallback_rows_total",
    "Records that took a per-record scalar route instead of the vectorized "
    "columnar plane",
    labelnames=("site",),
)
_H_PARTITION = _metrics.REGISTRY.histogram(
    "record_partition_seconds",
    "Vectorized partition-assignment + stable-group pass latency per "
    "columnar chunk (map side)",
)


def _count_frame(column: bool, plane: str) -> None:
    """One frame's wire-format accounting (a no-op with the registry off).
    Rows are counted once, at the route that moved them, so a scalar route
    writing columnar frames never counts twice."""
    if _metrics.enabled():
        _C_FRAMES.labels(format="column" if column else "legacy", plane=plane).inc()


def count_plane_rows(plane: str, rows: int) -> None:
    """Vectorized-route hook (batch granularity): the map writers'
    partition pass and the reader's batch consumers."""
    if rows and _metrics.enabled():
        _C_ROWS.labels(plane=plane).inc(rows)


def observe_partition_pass(t0_ns: int, rows: int) -> None:
    """Map-writer hook: one vectorized partition/group pass finished.
    ``t0_ns`` is the writer's ``perf_counter_ns``, taken only with the
    registry on (0 skips); ``rows`` feeds the write-side row counter (0 for
    a pass whose rows were counted already)."""
    if t0_ns:
        _H_PARTITION.observe((time.perf_counter_ns() - t0_ns) / 1e9)
        count_plane_rows("write", rows)


def count_fallback_rows(site: str, rows: int) -> None:
    """Per-record-route hook of the write and read planes (chunk
    granularity). Disjoint from ``record_rows_total``: every row lands in
    exactly one of the two."""
    if rows and _metrics.enabled():
        _C_FALLBACK.labels(site=site).inc(rows)


class Serializer:
    name = "abstract"
    relocatable = False
    #: True when the serializer's wire format is columnar frames and the
    #: batch read/write APIs are available — enables the vectorized data
    #: plane end to end (see s3shuffle_tpu_torch.batch).
    supports_batches = False

    def new_write_stream(self, sink: BinaryIO) -> "RecordWriter":
        raise NotImplementedError

    def new_read_stream(self, source: BinaryIO) -> Iterator[Tuple[Any, Any]]:
        raise NotImplementedError

    def new_batch_read_stream(self, source: BinaryIO, sink=None):
        """Yield RecordBatches (only when ``supports_batches``); each
        frame's parse is timed into ``sink`` (``utils.trace.stage``)."""
        raise NotImplementedError(f"{self.name} does not support batch reads")

    def resolve_for_write(self, cfg) -> "Serializer":
        """The map-writer seam: return the serializer to WRITE with under
        ``cfg`` (the reader auto-detects, so only the write side consults
        config). Base: the serializer itself. ColumnarKVSerializer resolves
        its frame format from ``cfg.columnar`` here when the caller left it
        unpinned."""
        return self

    def new_chunk_read_stream(self, source: BinaryIO) -> Iterator[list]:
        """Yield LISTS of (key, value) records. The read plane consumes this
        and flattens with ``itertools.chain.from_iterable`` (C-level), so the
        per-record path crosses 3 fewer Python generator frames than stacking
        per-record iterators. Default: re-chunk ``new_read_stream`` bounded
        by records AND bytes (a record-count-only chunk of multi-MB values
        would buffer gigabytes that the per-record path streamed one at a
        time); serializers whose wire format already batches override with
        the natural unit."""
        chunk: list = []
        nbytes = 0
        for kv in self.new_read_stream(source):
            chunk.append(kv)
            # per-element sizing: an unsized KEY (int) must not hide a
            # multi-MB VALUE from the byte bound
            for x in kv:
                try:
                    nbytes += len(x)
                except TypeError:
                    nbytes += 32
            if len(chunk) >= 4096 or nbytes >= (4 << 20):
                yield chunk
                chunk = []
                nbytes = 0
        if chunk:
            yield chunk

    def dumps(self, records: Iterable[Tuple[Any, Any]]) -> bytes:
        import io

        buf = io.BytesIO()
        w = self.new_write_stream(buf)
        for k, v in records:
            w.write(k, v)
        w.close()
        return buf.getvalue()

    def loads(self, data: bytes) -> Iterator[Tuple[Any, Any]]:
        import io

        return self.new_read_stream(io.BytesIO(data))


class RecordWriter:
    def write(self, key: Any, value: Any) -> None:
        raise NotImplementedError

    def write_batch(self, batch) -> None:
        """Write a RecordBatch. Default: per-record fallback."""
        for k, v in batch.iter_records():
            self.write(k, v)

    def flush(self) -> None:
        """Push any buffered records downstream so the bytes emitted so far
        form a valid stream prefix (needed at spill boundaries)."""

    def close(self) -> None:
        raise NotImplementedError


# ----------------------------------------------------------------------------
# Pickle batch serializer (default — arbitrary Python KV)
# ----------------------------------------------------------------------------


class _PickleBatchWriter(RecordWriter):
    def __init__(self, sink: BinaryIO, batch_size: int):
        self._sink = sink
        self._batch: list = []
        self._batch_size = batch_size

    def write(self, key: Any, value: Any) -> None:
        self._batch.append((key, value))
        if len(self._batch) >= self._batch_size:
            self.flush()

    def flush(self) -> None:
        if self._batch:
            payload = pickle.dumps(self._batch, protocol=pickle.HIGHEST_PROTOCOL)
            self._sink.write(_U32.pack(len(payload)))
            self._sink.write(payload)
            self._batch = []

    def close(self) -> None:
        self.flush()


class PickleBatchSerializer(Serializer):
    """Frames of ``[u32le len][pickle([(k, v), ...])]``. Self-delimiting ⇒
    relocatable/concatenatable."""

    name = "pickle"
    relocatable = True

    def __init__(self, batch_size: int = 512):
        self.batch_size = batch_size

    def new_write_stream(self, sink: BinaryIO) -> RecordWriter:
        return _PickleBatchWriter(sink, self.batch_size)

    def new_read_stream(self, source: BinaryIO) -> Iterator[Tuple[Any, Any]]:
        import itertools

        return itertools.chain.from_iterable(self.new_chunk_read_stream(source))

    def new_chunk_read_stream(self, source: BinaryIO) -> Iterator[list]:
        """One pickled frame IS the natural chunk — no re-batching."""
        while True:
            # read_fully: codec streams return short reads at frame boundaries
            header = _read_fully(source, _U32.size)
            if not header:
                return
            if len(header) < _U32.size:
                raise IOError("Truncated record-batch header")
            (n,) = _U32.unpack(header)
            payload = _read_fully(source, n)
            if len(payload) < n:
                raise IOError(f"Truncated record batch ({len(payload)}/{n})")
            yield pickle.loads(payload)


# ----------------------------------------------------------------------------
# Bytes KV serializer (fast path — terasort-style byte keys/values)
# ----------------------------------------------------------------------------


class _BytesKVWriter(RecordWriter):
    def __init__(self, sink: BinaryIO):
        self._sink = sink

    def write(self, key: Any, value: Any) -> None:
        k = bytes(key)
        v = bytes(value)
        self._sink.write(_U32.pack(len(k)) + k + _U32.pack(len(v)) + v)

    def close(self) -> None:
        pass


class BytesKVSerializer(Serializer):
    """``[u32 klen][key][u32 vlen][value]`` — zero-copy-ish path for byte
    records (the terasort workload shape)."""

    name = "bytes-kv"
    relocatable = True

    def new_write_stream(self, sink: BinaryIO) -> RecordWriter:
        return _BytesKVWriter(sink)

    def new_read_stream(self, source: BinaryIO) -> Iterator[Tuple[bytes, bytes]]:
        while True:
            header = _read_fully(source, _U32.size)
            if not header:
                return
            if len(header) < _U32.size:
                raise IOError("Truncated key length")
            (klen,) = _U32.unpack(header)
            key = _read_fully(source, klen)
            vheader = _read_fully(source, _U32.size)
            if len(key) < klen or len(vheader) < _U32.size:
                raise IOError("Truncated record")
            (vlen,) = _U32.unpack(vheader)
            value = _read_fully(source, vlen)
            if len(value) < vlen:
                raise IOError("Truncated value")
            yield key, value


# ----------------------------------------------------------------------------
# Columnar KV serializer (the vectorized data plane — s3shuffle_tpu_torch.batch)
# ----------------------------------------------------------------------------


#: default rows buffered per frame by the columnar writer's per-record path
DEFAULT_BATCH_RECORDS = 8192


class _ColumnarKVWriter(RecordWriter):
    def __init__(self, sink: BinaryIO, batch_records: int, column_frames: bool):
        self._sink = sink
        self._pending: list = []
        self._batch_records = batch_records
        self._column_frames = column_frames

    def write(self, key: Any, value: Any) -> None:
        self._pending.append((bytes(key), bytes(value)))
        if len(self._pending) >= self._batch_records:
            self.flush()

    def _emit(self, batch) -> None:
        if batch.n == 0:
            return
        if self._column_frames:
            from s3shuffle_tpu_torch.colframe import write_column_frame

            # what landed on the wire: degenerate shapes fall back to legacy
            wrote_column = write_column_frame(self._sink, batch)
        else:
            from s3shuffle_tpu_torch.batch import write_frame

            write_frame(self._sink, batch)
            wrote_column = False
        _count_frame(wrote_column, "write")

    def write_batch(self, batch) -> None:
        self.flush()
        self._emit(batch)

    def flush(self) -> None:
        if self._pending:
            from s3shuffle_tpu_torch.batch import RecordBatch

            self._emit(RecordBatch.from_records(self._pending))
            self._pending = []

    def close(self) -> None:
        self.flush()


class ColumnarKVSerializer(Serializer):
    """Byte-KV records in columnar frames. Self-delimiting ⇒ relocatable;
    columnar ⇒ the whole write/read/partition/sort path is vectorized numpy
    instead of per-record Python (the reference's per-record JVM iterators
    would be the wrong design here — SURVEY.md §3.2/3.3 hot loops).

    Two wire framings (read side auto-detects per frame):

    - **column frames** (:mod:`s3shuffle_tpu_torch.colframe`): self-describing
      per-column dtype/width table; fixed-width columns ship no per-row
      lengths and deserialize into columns in one zero-copy pass;
    - **legacy frames** (:mod:`s3shuffle_tpu_torch.batch`,
      ``[u32 len][u32 n][klens][vlens][keys][values]``) — the pre-format-5
      wire.

    ``column_frames=None`` (the default) defers the choice to the managed
    write seam, which resolves it from ``ShuffleConfig.columnar``
    (:meth:`resolve_for_write`); unmanaged direct use stays on the legacy
    wire, byte-stable. ``columnar=0`` is therefore op-for-op byte-identical
    to the pre-column-frame wire everywhere."""

    name = "bytes-kv-columnar"
    relocatable = True
    supports_batches = True

    def __init__(
        self,
        batch_records: int = DEFAULT_BATCH_RECORDS,
        column_frames: Optional[bool] = None,
    ):
        self.batch_records = batch_records
        self.column_frames = column_frames

    def resolve_for_write(self, cfg) -> "ColumnarKVSerializer":
        if self.column_frames is not None:
            return self
        return ColumnarKVSerializer(
            self.batch_records, bool(getattr(cfg, "columnar", 0))
        )

    def new_write_stream(self, sink: BinaryIO) -> RecordWriter:
        return _ColumnarKVWriter(sink, self.batch_records, bool(self.column_frames))

    def new_read_stream(self, source: BinaryIO) -> Iterator[Tuple[bytes, bytes]]:
        for batch in self.new_batch_read_stream(source):
            yield from batch.iter_records()

    def new_batch_read_stream(self, source: BinaryIO, sink=None):
        from s3shuffle_tpu_torch.colframe import read_frames_auto

        return read_frames_auto(
            source, on_frame=lambda column, _b: _count_frame(column, "read"), sink=sink
        )

    def new_chunk_read_stream(self, source: BinaryIO) -> Iterator[list]:
        """One frame = one chunk: the whole frame decodes column-at-a-time
        and expands to records once, instead of the base class re-chunking a
        per-record generator."""
        for batch in self.new_batch_read_stream(source):
            yield batch.to_records()


def get_serializer(name: str) -> Serializer:
    if name in ("pickle", "default"):
        return PickleBatchSerializer()
    if name == "bytes-kv":
        return BytesKVSerializer()
    if name in ("bytes-kv-columnar", "columnar"):
        return ColumnarKVSerializer()
    raise ValueError(f"Unknown serializer: {name}")
