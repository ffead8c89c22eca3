"""Serialized-handle map-side path — the UnsafeShuffleWriter analog.

Counterpart of the JAX package's ``write/serialized_writer.py``. Parity:
Spark's SortShuffleManager picks a *serialized* write strategy when the
serializer is relocatable and there is no aggregator
(sort/S3ShuffleManager.scala:114-146 routes such handles to
UnsafeShuffleWriter, which buffers serialized records with their partition
ids and sorts ONE buffer by partition id at spill time). Instead of
``num_partitions`` live serializer → codec pipelines, this writer keeps
RecordBatches and their partition-id arrays untouched; at spill and commit
one stable radix argsort by partition id groups the whole buffer
(``split_by_partition``), and each present partition's rows stream through
a short-lived serializer → codec pipeline into the spill file (recording
per-partition byte ranges) or the output object. Frames concatenate, so
spill segments plus the final segment form valid partition streams.

With CRC32C and the TLZ codec every partition keeps one
:class:`~s3shuffle_tpu_torch.codec.cuda.FusedChecksumAccumulator` across its
emissions (spill segments in order, then the final one), so its sidecar
value comes from the CRCs fused into the encode launches, as on the
buffer-per-partition path; the JAX package's serialized writer hashes the
stored bytes instead, and the sidecar bytes are the same.
"""

from __future__ import annotations

import io
import logging
import os
import time
from typing import Iterable, List, Tuple

import numpy as np

from s3shuffle_tpu_torch.batch import RecordBatch, iter_record_batches, split_by_partition
from s3shuffle_tpu_torch.codec.framing import CodecOutputStream
from s3shuffle_tpu_torch.metrics import registry as _metrics
from s3shuffle_tpu_torch.serializer import observe_partition_pass
from s3shuffle_tpu_torch.write.map_output_writer import MapOutputCommitMessage
from s3shuffle_tpu_torch.write.spill_writer import MapWriterBase

logger = logging.getLogger("s3shuffle_tpu_torch.write")

_H_SERIALIZE = _metrics.REGISTRY.histogram(
    "write_serialize_seconds",
    "Per-partition serializer→codec emission latency (serialized-sort path)",
)


class SerializedSortMapWriter(MapWriterBase):
    """Alternative to ShuffleMapWriter for serialized-handle dependencies
    whose serializer supports columnar batches."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._batches: List[RecordBatch] = []
        self._pids: List[np.ndarray] = []
        self._buffered = 0
        #: per spill: int64 array of num_partitions+1 absolute file offsets
        self._spill_offsets: List[np.ndarray] = []
        self._checksums = [self._new_fused_checksum() for _ in range(self.dep.num_partitions)]

    def write(self, records: Iterable[Tuple]) -> None:
        partitioner = self.dep.partitioner
        for batch in iter_record_batches(records, chunk_records=self._chunk_rows()):
            if batch.n == 0:
                continue
            t0 = time.perf_counter_ns() if _metrics.enabled() else 0
            pids = partitioner.partition_batch(batch)
            observe_partition_pass(t0, batch.n)
            self._batches.append(batch)
            self._pids.append(np.asarray(pids))
            self._buffered += batch.nbytes + pids.nbytes
            self._records_written += batch.n
            if self._buffered > self.spill_memory_budget:
                self._spill()

    def _sorted_pending(self):
        """One argsort over everything buffered → (grouped batch, partition
        bounds). Clears the buffer."""
        big = RecordBatch.concat(self._batches)
        pids = np.concatenate(self._pids) if self._pids else np.empty(0, dtype=np.int64)
        self._batches = []
        self._pids = []
        self._buffered = 0
        t0 = time.perf_counter_ns() if _metrics.enabled() else 0
        out = split_by_partition(big, pids, self.dep.num_partitions)
        # rows=0: counted at their write() pass already; this is the
        # spill- or commit-time regrouping of the same buffer
        observe_partition_pass(t0, 0)
        return out

    def _emit_partition(self, sink, pid: int, rows) -> None:
        """Serialize one partition's rows through serializer → codec into
        ``sink``. The pipeline is short-lived: frames are self-delimiting,
        so consecutive emissions concatenate."""
        t0 = time.perf_counter_ns() if _metrics.enabled() else 0
        if self.codec is None:
            w = self.serializer.new_write_stream(sink)
            w.write_batch(rows)
            w.close()
        else:
            codec_stream = CodecOutputStream(
                self.codec, sink, close_sink=False, checksum=self._checksums[pid]
            )
            w = self.serializer.new_write_stream(codec_stream)
            w.write_batch(rows)
            w.close()
            codec_stream.close()
        if t0:
            _H_SERIALIZE.observe((time.perf_counter_ns() - t0) / 1e9)

    def _spill(self) -> None:
        if not self._batches:
            return
        t0 = time.perf_counter_ns()
        grouped, bounds = self._sorted_pending()
        f = self._open_spill("s3shuffle-sersort-")
        f.seek(0, os.SEEK_END)
        n_parts = self.dep.num_partitions
        offsets = np.empty(n_parts + 1, dtype=np.int64)
        offsets[0] = f.tell()
        for pid in range(n_parts):
            lo, hi = int(bounds[pid]), int(bounds[pid + 1])
            if hi > lo:
                self._emit_partition(f, pid, grouped.slice_rows(lo, hi))
            offsets[pid + 1] = f.tell()
        self._spill_offsets.append(offsets)
        self._record_spill(t0, int(offsets[-1] - offsets[0]))
        self.spill_count += 1
        logger.info("Map %d (serialized path) spilled to %s (spill #%d)",
                    self.map_id, self._spill_file, self.spill_count)

    def _commit(self) -> MapOutputCommitMessage:
        grouped, bounds = self._sorted_pending()
        for pid in range(self.dep.num_partitions):
            # the final segment is encoded before the partition writer
            # exists, so the fused checksum is complete when it is handed over
            tail = io.BytesIO()
            lo, hi = int(bounds[pid]), int(bounds[pid + 1])
            if hi > lo:
                self._emit_partition(tail, pid, grouped.slice_rows(lo, hi))
            acc = self._checksums[pid]
            writer = self.output_writer.get_partition_writer(
                pid, precomputed_checksum=None if acc is None else acc.value
            )
            for offsets in self._spill_offsets:
                s_lo, s_hi = int(offsets[pid]), int(offsets[pid + 1])
                if s_hi > s_lo:
                    self._copy_spill_range(writer, s_lo, s_hi)
            view = tail.getbuffer()
            if len(view):
                writer.write(view)
            view.release()
            writer.close()
        return self._register_commit()
