"""Map-task shuffle writer: partition records, spill when over budget, commit.

Counterpart of the JAX package's ``write/spill_writer.py``. Parity: the
role of Spark's map-side writers (SortShuffleWriter / UnsafeShuffleWriter /
BypassMergeSortShuffleWriter) feeding the reference's
``S3ShuffleMapOutputWriter``, collapsed into one strategy that keeps their
shared contract:

- records are routed to per-partition serializer → codec pipelines
  (map-side combine applied first when the dependency asks for it);
- memory is bounded: when buffered bytes (codec queues included) exceed
  ``max_buffer_size_task``, every partition's pipeline is flushed at a frame
  boundary and appended to a local spill file (frames concatenate, so spill
  segments concatenate into a valid partition stream);
- at a spill and at the commit the full blocks every partition's codec
  stream holds are encoded together, in launches shared across partitions
  (:func:`~s3shuffle_tpu_torch.codec.framing.flush_streams`), the same
  frames each stream would emit alone;
- with CRC32C and the TLZ codec each pipeline's codec stream carries a
  :class:`~s3shuffle_tpu_torch.codec.cuda.FusedChecksumAccumulator`: the
  partition's sidecar value is stitched from CRCs fused into the encode
  launches (kernels K1 and K2 run in the same batch), spilled segments
  included, and the commit hands it to the partition writer instead of
  hashing the stored bytes again; any other codec (or none) leaves the
  hashing to the partition writer, as the JAX writers do;
- a columnar aggregator with map-side combine runs the whole map task's
  input through one bounded :class:`~s3shuffle_tpu_torch.colagg.ColumnarReducer`,
  drained and routed to the partitions at commit; its work is the
  ``record.combine`` stage (``combine_host_s`` in the codec's timings), and
  the rows entering and leaving it count as ``combine_rows_in`` and
  ``combine_rows_out`` there;
- the skew plane's combine sidecar (``combine_threshold_bytes > 0``): for
  a columnar aggregator whose combine runs reduce-side, a partition whose
  routed bytes crossed the threshold has each further chunk pre-reduced
  (``ColumnarReducer.reduce_chunk``), and the reduced chunk ships when it
  is smaller in rows and in bytes; the map output is then flagged
  combined;
- on ``stop(success=True)`` partitions stream in monotone order into the
  single data object through :class:`MapOutputWriter`, and the commit
  registers a MapStatus addressed to the object store
  (S3ShuffleWriter.scala:10-18).
"""

from __future__ import annotations

import io
import itertools
import logging
import os
import tempfile
import time
from typing import Any, Callable, Iterable, List, Optional, Tuple

import numpy as np

from s3shuffle_tpu_torch.batch import (
    DEFAULT_CHUNK_RECORDS,
    RecordBatch,
    iter_record_batches,
    split_by_partition,
)
from s3shuffle_tpu_torch.codec.cuda import FusedChecksumAccumulator
from s3shuffle_tpu_torch.codec.framing import CodecOutputStream, FrameCodec, flush_streams
from s3shuffle_tpu_torch.metrics import registry as _metrics
from s3shuffle_tpu_torch.metrics.stats import COLLECTOR
from s3shuffle_tpu_torch.ops.checksum import POLY_CRC32C
from s3shuffle_tpu_torch.serializer import count_fallback_rows, observe_partition_pass
from s3shuffle_tpu_torch.skew import C_MAP_COMBINE_ROWS
from s3shuffle_tpu_torch.utils import gc_paused, trace
from s3shuffle_tpu_torch.write.map_output_writer import MapOutputCommitMessage, MapOutputWriter

logger = logging.getLogger("s3shuffle_tpu_torch.write")

_H_SPILL = _metrics.REGISTRY.histogram(
    "write_spill_seconds", "Per-spill flush latency (all partitions)"
)
_C_SPILL_BYTES = _metrics.REGISTRY.counter(
    "write_spill_bytes_total", "Bytes moved to local spill files"
)
_H_COMMIT = _metrics.REGISTRY.histogram(
    "write_commit_seconds",
    "Map-output commit latency (drain + serialize + upload + index)",
)


class _PartitionPipeline:
    """serializer → (codec) → in-memory sink for one reduce partition.

    ``fused_checksum`` (optional FusedChecksumAccumulator) rides the codec
    stream, so at :meth:`finish` its value equals a byte-serial checksum of
    every stored byte this pipeline emitted, spilled segments included."""

    def __init__(self, serializer, codec: Optional[FrameCodec], fused_checksum=None):
        self.sink = io.BytesIO()
        self.fused_checksum = fused_checksum if codec is not None else None
        self.codec_stream: Optional[CodecOutputStream] = None
        target = self.sink
        if codec is not None:
            self.codec_stream = target = CodecOutputStream(
                codec, self.sink, close_sink=False, checksum=self.fused_checksum
            )
        self.record_writer = serializer.new_write_stream(target)
        self.spill_segments: List[Tuple[int, int]] = []  # (offset, length) in spill file

    def serialize(self, batch: RecordBatch) -> None:
        """Append ``batch``'s frame to the partition's stream with the
        codec's framing held back: record compute only, no codec call
        (:meth:`emit_filled` frames what filled)."""
        stream = self.codec_stream
        if stream is None:
            self.record_writer.write_batch(batch)
            return
        stream._holding = True
        try:
            self.record_writer.write_batch(batch)
        finally:
            stream._holding = False

    def emit_filled(self) -> None:
        if self.codec_stream is not None:
            self.codec_stream.emit_filled()

    def buffered_bytes(self) -> int:
        # the codec stream holds raw bytes until a batch of full blocks is
        # framed: the spill budget must see them
        pending = self.codec_stream.pending_bytes if self.codec_stream is not None else 0
        return self.sink.tell() + pending

    def spill_into(self, f) -> int:
        """Append the buffered bytes to ``f`` without materializing them
        (after the writer's flush to a frame boundary). Returns the byte
        count written."""
        view = self.sink.getbuffer()
        n = len(view)
        if n:
            f.write(view)
        view.release()  # BytesIO refuses truncate while a buffer is exported
        self.sink.seek(0)
        self.sink.truncate(0)
        return n

    def finish(self) -> Optional[int]:
        """Close the codec stream (after the writer's flush with the record
        writer closed: the final frames are in the local sink). Returns the
        partition's checksum stitched from the fused per-frame CRCs, or
        None when the commit must hash the stored bytes itself."""
        if self.codec_stream is not None:
            self.codec_stream.close()
        return self.fused_checksum.value if self.fused_checksum is not None else None

    def drain_into(self, writer) -> None:
        """Stream the sink's bytes into ``writer`` (call :meth:`finish`
        first)."""
        view = self.sink.getbuffer()
        if len(view):
            writer.write(view)
        view.release()


class MapWriterBase:
    """Shared writer state + the stop()/commit/abort/cleanup protocol;
    subclasses implement the buffering strategy (``write``, ``_commit``)."""

    def __init__(
        self,
        handle,
        map_id: int,
        output_writer: MapOutputWriter,
        codec: Optional[FrameCodec],
        on_commit: Callable[..., None],  # (sid, map_id, lengths, map_index, message)
        spill_memory_budget: Optional[int] = None,
        map_index: Optional[int] = None,
    ):
        self.handle = handle
        self.dep = handle.dependency
        self.map_id = map_id
        self.map_index = map_id if map_index is None else map_index
        self.output_writer = output_writer
        self.codec = codec
        self.on_commit = on_commit
        cfg = output_writer.dispatcher.config
        # the record plane's write seam: a columnar serializer left unpinned
        # resolves its frame wire (column vs legacy) from cfg.columnar here —
        # the read side auto-detects
        self.serializer = self.dep.serializer.resolve_for_write(cfg)
        self.spill_memory_budget = spill_memory_budget or cfg.max_buffer_size_task
        self._spill_file: Optional[str] = None
        self._spill_fd = None
        self._stopped = False
        self.spill_count = 0
        self._records_written = 0

    def write(self, records) -> None:
        raise NotImplementedError

    def _commit(self) -> MapOutputCommitMessage:
        raise NotImplementedError

    def _on_abort(self) -> None:
        """Strategy-specific state release on an unsuccessful stop."""

    def stop(self, success: bool) -> Optional[MapOutputCommitMessage]:
        if self._stopped:
            return None
        self._stopped = True
        if not success:
            self._on_abort()
            self.output_writer.abort()
            self._cleanup_spill()
            return None
        try:
            t0 = time.perf_counter_ns()
            with trace.span("write.commit", map_id=self.map_id, records=self._records_written):
                message = self._commit()
            if _metrics.enabled():
                seconds = (time.perf_counter_ns() - t0) / 1e9
                _H_COMMIT.observe(seconds)
                # the map-commit stats entry (the reduce side reports at drain)
                COLLECTOR.record_map(
                    shuffle_id=self.handle.shuffle_id,
                    map_id=self.map_id,
                    bytes=int(np.sum(message.partition_lengths)),
                    records=self._records_written,
                    seconds=seconds,
                    spills=self.spill_count,
                )
            return message
        except BaseException as e:
            self.output_writer.abort(e if isinstance(e, Exception) else None)
            raise
        finally:
            self._cleanup_spill()

    def _register_commit(self) -> MapOutputCommitMessage:
        """Shared commit tail: seal the data object, write the sidecars,
        notify ``on_commit`` with the commit message."""
        message = self.output_writer.commit_all_partitions()
        self.on_commit(
            self.handle.shuffle_id, self.map_id, message.partition_lengths,
            self.map_index, message,
        )
        return message

    def _new_fused_checksum(self) -> Optional[FusedChecksumAccumulator]:
        """A partition's FusedChecksumAccumulator when the codec hands back
        CRCs fused into its encode launch (the TLZ codec) and the configured
        checksum is CRC32C (what the launches compute), else None: the
        sidecar value is then stitched from per-frame device CRCs instead of
        re-hashing every stored byte on the host."""
        cfg = self.output_writer.dispatcher.config
        if (
            not cfg.checksum_enabled
            or cfg.checksum_algorithm != "CRC32C"
            or not getattr(self.codec, "supports_fused_checksum", False)
        ):
            return None
        return FusedChecksumAccumulator(POLY_CRC32C)

    def _record_spill(self, start_ns: int, nbytes: int) -> None:
        """Metrics hook of both buffering strategies' spills."""
        if _metrics.enabled():
            _H_SPILL.observe((time.perf_counter_ns() - start_ns) / 1e9)
            _C_SPILL_BYTES.inc(nbytes)

    def _chunk_rows(self) -> int:
        """Rows per columnar chunk on the write path (``columnar_batch_rows``,
        through the commit tuner when autotune is on); ``columnar=0`` pins
        the legacy wire's chunking, so the knob cannot move legacy frame
        boundaries."""
        cfg = self.output_writer.dispatcher.config
        if not cfg.columnar:
            return DEFAULT_CHUNK_RECORDS
        tuner = self.output_writer.dispatcher.commit_tuner
        if tuner is None:
            return cfg.columnar_batch_rows
        return tuner.columnar_batch_rows(cfg.columnar_batch_rows)

    def _open_spill(self, prefix: str):
        if self._spill_fd is None:
            fd, self._spill_file = tempfile.mkstemp(prefix=prefix)
            self._spill_fd = os.fdopen(fd, "wb+")
        return self._spill_fd

    def _cleanup_spill(self) -> None:
        if self._spill_fd is not None:
            self._spill_fd.close()
            self._spill_fd = None
        if self._spill_file is not None:
            try:
                os.remove(self._spill_file)
            except OSError:
                pass
            self._spill_file = None

    def _copy_spill_range(self, writer, lo: int, hi: int) -> None:
        """Stream spill-file bytes [lo, hi) into a partition writer."""
        self._spill_fd.seek(lo)
        remaining = hi - lo
        while remaining > 0:
            chunk = self._spill_fd.read(min(remaining, 1 << 20))
            if not chunk:
                raise IOError("Truncated spill file")
            writer.write(chunk)
            remaining -= len(chunk)


class ShuffleMapWriter(MapWriterBase):
    """Buffer-per-partition strategy: one live serializer → codec pipeline
    per reduce partition. A columnar aggregator with map-side combine
    instead feeds every chunk of the task to one bounded ColumnarReducer
    (sorted unique-key partials, spilled at ``aggregator_spill_bytes``),
    drained and routed to the partitions at commit."""

    #: records routed between two spill-budget checks on the per-record path
    CHECK_EVERY = 4096

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._pipelines = [
            _PartitionPipeline(self.serializer, self.codec, self._new_fused_checksum())
            for _ in range(self.dep.num_partitions)
        ]
        self._combine_reducer = None  # the columnar map-side combine's state
        self._combine_tally = None  # its stage seconds and row counts
        self._since_budget_check = 0
        # the skew plane's combine sidecar: an aggregating dependency whose
        # combine runs reduce-side pre-reduces its hot partitions' chunks
        # here; 0 keeps the prong off
        dep = self.dep
        cfg = self.output_writer.dispatcher.config
        self._combine_gate = (
            not dep.map_side_combine
            and dep.aggregator is not None
            and getattr(dep.aggregator, "supports_columnar", False)
            and self.serializer.supports_batches
            and cfg.combine_threshold_bytes > 0
        )
        self._sidecar_reducer = None
        self._sidecar_routed = None  # per-partition routed-bytes tally
        self._sidecar_threshold = 0

    def write(self, records: Iterable[Tuple[Any, Any]]) -> None:
        dep = self.dep
        if self.serializer.supports_batches:
            if not dep.map_side_combine:
                self._write_batches(
                    iter_record_batches(records, chunk_records=self._chunk_rows())
                )
                return
            if dep.aggregator is not None and dep.aggregator.supports_columnar:
                # the whole task's input, across write() calls, goes through
                # one reducer; partition routing happens at commit
                if self._combine_reducer is None:
                    self._combine_tally = trace.Tally(self.codec)
                    self._combine_reducer = dep.aggregator.new_reducer(
                        spill_bytes=self.output_writer.dispatcher.config.aggregator_spill_bytes,
                        sink=self._combine_tally,
                    )
                rows = 0
                for chunk in iter_record_batches(records, chunk_records=self._chunk_rows()):
                    self._combine_reducer.add(chunk)
                    rows += chunk.n
                trace.add_count(self._combine_tally, "combine_rows_in", rows)
                trace.count("combine_rows_in", rows)
                return
        if isinstance(records, RecordBatch):
            # per-record routes (combine, or a non-batch serializer) consume
            # (k, v) tuples — expand columnar input at the boundary
            records = records.iter_records()
        if dep.map_side_combine:
            records = dep.aggregator.combine_values_by_key(
                records,
                spill_bytes=self.output_writer.dispatcher.config.aggregator_spill_bytes,
            )
        partitioner = dep.partitioner
        pipelines = self._pipelines
        it = iter(records)
        while True:
            # pull each chunk with the collector live: ``records`` may run
            # arbitrary user compute; the pause covers only routing and
            # serialization
            chunk = list(itertools.islice(it, self.CHECK_EVERY))
            if not chunk:
                break
            with gc_paused:
                for k, v in chunk:
                    pipelines[partitioner(k)].record_writer.write(k, v)
            self._records_written += len(chunk)
            count_fallback_rows("write", len(chunk))
            # amortize the O(num_partitions) budget scan across write() calls
            self._since_budget_check += len(chunk)
            if self._since_budget_check >= self.CHECK_EVERY:
                self._since_budget_check = 0
                if self._buffered_total() > self.spill_memory_budget:
                    self._spill()

    def _write_batches(self, batches) -> None:
        """Vectorized route: partition ids per columnar chunk, one stable
        grouping pass, one frame per (chunk × partition) through each
        pipeline. The record stages (``record.partition``,
        ``record.serialize``) add to the codec's ``record_host_s`` once per
        call; the codec frames each chunk's filled batches after them."""
        dep = self.dep
        tally = trace.Tally(self.codec)
        try:
            for batch in batches:
                if batch.n == 0:
                    continue
                t0 = time.perf_counter_ns() if _metrics.enabled() else 0
                with trace.stage("record.partition", tally, "record_host_s"):
                    pids = dep.partitioner.partition_batch(batch)
                    grouped, bounds = split_by_partition(batch, pids, dep.num_partitions)
                observe_partition_pass(t0, batch.n)
                filled = []
                with trace.stage("record.serialize", tally, "record_host_s"):
                    for pid in range(dep.num_partitions):
                        lo, hi = int(bounds[pid]), int(bounds[pid + 1])
                        if hi > lo:
                            sl = grouped.slice_rows(lo, hi)
                            if self._combine_gate:
                                sl = self._maybe_combine_chunk(pid, sl)
                            self._pipelines[pid].serialize(sl)
                            filled.append(pid)
                for pid in filled:
                    self._pipelines[pid].emit_filled()
                self._records_written += batch.n
                if self._buffered_total() > self.spill_memory_budget:
                    self._spill()
        finally:
            tally.flush()

    def _maybe_combine_chunk(self, pid: int, sl: RecordBatch) -> RecordBatch:
        """The combine sidecar's decision for one (chunk × partition) slice:
        once the partition's routed bytes crossed the threshold, the slice
        is pre-reduced on its own (argsort + reduceat, bounded by the chunk)
        and ships only when that is smaller in rows and in bytes (a chunk of
        mostly unique keys, widened, can grow), so the sidecar never adds
        wire bytes. Shipping a partial flags the map output
        (:meth:`MapOutputWriter.note_combined`)."""
        if self._sidecar_routed is None:
            cfg = self.output_writer.dispatcher.config
            # the engage point, through the commit tuner when autotune is
            # on; consulted once per map task
            threshold = cfg.combine_threshold_bytes
            tuner = self.output_writer.dispatcher.commit_tuner
            if tuner is not None:
                threshold = tuner.combine_threshold_bytes(threshold)
            self._sidecar_threshold = int(threshold)
            self._sidecar_routed = np.zeros(self.dep.num_partitions, dtype=np.int64)
            self._sidecar_reducer = self.dep.aggregator.new_reducer(
                spill_bytes=cfg.aggregator_spill_bytes
            )
        routed = int(self._sidecar_routed[pid])
        self._sidecar_routed[pid] += sl.nbytes
        if routed < self._sidecar_threshold:
            return sl
        try:
            reduced = self._sidecar_reducer.reduce_chunk(sl)
        except ValueError as e:
            # a value shape the columnar plane cannot combine: ship the raw
            # rows and stop trying for the rest of the task
            logger.debug("map-side combine sidecar disabled for map %d: %s", self.map_id, e)
            self._combine_gate = False
            return sl
        if reduced.n < sl.n and reduced.nbytes < sl.nbytes:
            if _metrics.enabled():
                C_MAP_COMBINE_ROWS.inc(sl.n - reduced.n)
            self.output_writer.note_combined()
            return reduced
        return sl

    def _buffered_total(self) -> int:
        return sum(p.buffered_bytes() for p in self._pipelines)

    def _flush_pipelines(self, close: bool) -> None:
        """Bring every partition stream to a frame boundary: each record
        writer flushed (closed at the commit), then the held blocks of all
        the codec streams framed together, their full blocks in shared
        launches (``flush_streams``)."""
        for pipeline in self._pipelines:
            if close:
                pipeline.record_writer.close()
            else:
                pipeline.record_writer.flush()
        flush_streams([p.codec_stream for p in self._pipelines if p.codec_stream is not None])

    def _spill(self) -> None:
        t0 = time.perf_counter_ns()
        self._flush_pipelines(close=False)
        f = self._open_spill("s3shuffle-map-spill-")
        spilled = 0
        for pipeline in self._pipelines:
            offset = f.tell()
            n = pipeline.spill_into(f)
            if n:
                pipeline.spill_segments.append((offset, n))
                spilled += n
        self._record_spill(t0, spilled)
        self.spill_count += 1
        logger.info("Map %d spilled to %s (spill #%d)", self.map_id, self._spill_file,
                    self.spill_count)

    def _on_abort(self) -> None:
        if self._combine_reducer is not None:
            self._combine_reducer.cleanup()
            self._combine_reducer = None

    def _combined(self):
        """The map-side combine's drain, its rows counted out."""
        tally = self._combine_tally
        rows = 0
        for batch in self._combine_reducer.results():
            rows += batch.n
            yield batch
        trace.add_count(tally, "combine_rows_out", rows)
        trace.count("combine_rows_out", rows)
        tally.flush()

    def _commit(self) -> MapOutputCommitMessage:
        if self._combine_reducer is not None:
            # drain the map-side combine: the reduced partials route to the
            # partition pipelines now, so every partition stream is complete
            self._write_batches(self._combined())
            self._combine_reducer = None
        # every stream's final frames land in its local sink and complete
        # its fused checksum before any partition writer exists: the
        # checksum then replaces the writer's hashing
        self._flush_pipelines(close=True)
        for pid, pipeline in enumerate(self._pipelines):
            fused_value = pipeline.finish()
            writer = self.output_writer.get_partition_writer(
                pid, precomputed_checksum=fused_value
            )
            for offset, length in pipeline.spill_segments:
                self._copy_spill_range(writer, offset, offset + length)
            pipeline.drain_into(writer)
            writer.close()
        return self._register_commit()
