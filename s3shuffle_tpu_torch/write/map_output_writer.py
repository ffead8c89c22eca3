"""Map-side writer: all reduce partitions of one map task → one data object.

Counterpart of the JAX package's ``write/map_output_writer.py`` (parity with
the reference's ``S3ShuffleMapOutputWriter``, S3ShuffleMapOutputWriter.scala:27-244):

- one data object ``shuffle_<s>_<m>_0.data`` streamed through one measured
  write stream, opened lazily on the first stored byte (an empty map creates
  no object); with ``upload_queue_bytes > 0`` a background uploader writes
  it (:class:`~s3shuffle_tpu_torch.write.pipelined_upload.PipelinedUploadStream`),
  else a buffered writer of ``buffer_size`` bytes;
- partition writers in strictly increasing reduce-id order (:67-73);
  :meth:`MapOutputWriter.get_partition_writer` takes the partition's STORED
  bytes (frames the record writers encoded) and counts them, and either
  hashes them with the configured checksum or records the caller's
  ``precomputed_checksum`` (stitched from CRCs fused into the encode
  launches, write/spill_writer.py);
  :meth:`MapOutputWriter.get_encoding_partition_writer` takes RAW bytes and
  encodes them through its own ``CodecOutputStream`` (partitions never share
  a frame; ``codec="none"`` writes them unframed), stitching the CRC32C
  sidecar value from the encode launches where the codec is the TLZ
  ``CudaCodec`` and hashing the stored bytes for any other codec;
- with ``parity_segments > 0`` every stored byte is also teed, once and in
  object order, into the streaming parity encoder
  (:class:`~s3shuffle_tpu_torch.coding.parity.ParityAccumulator`, kernel K4
  on the writer's device);
- ``commit_all_partitions`` checks the stream position against the sum of
  the partition lengths (:96-100), closes the data object, then PUTs the
  parity sidecars, then writes the checksum sidecar, then the index (with
  the stripe-geometry trailer when coded) — the commit point. An empty map
  commits nothing unless ``always_create_index`` asks for a visible empty
  output (:111), for listing-mode enumeration;
- ``abort`` drops the data object once it was created (even when the sink
  around it failed to build) and any parity sidecars PUT.
"""

from __future__ import annotations

import dataclasses
import io
import logging
from typing import Optional

import numpy as np

from s3shuffle_tpu_torch.block_ids import ShuffleDataBlockId
from s3shuffle_tpu_torch.codec import FROM_CONFIG, codec_from_config
from s3shuffle_tpu_torch.codec.cuda import FusedChecksumAccumulator
from s3shuffle_tpu_torch.codec.framing import CodecOutputStream, FrameCodec
from s3shuffle_tpu_torch.coding.parity import (
    accumulator_from_config,
    delete_parity_objects,
    put_parity_objects,
)
from s3shuffle_tpu_torch.device import resolve_device
from s3shuffle_tpu_torch.metadata.helper import ShuffleHelper
from s3shuffle_tpu_torch.ops.checksum import POLY_CRC32C
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
from s3shuffle_tpu_torch.utils.checksums import Checksum, create_checksum
from s3shuffle_tpu_torch.write.measure import MeasuredOutputStream
from s3shuffle_tpu_torch.write.pipelined_upload import PipelinedUploadStream

logger = logging.getLogger("s3shuffle_tpu_torch.write")


@dataclasses.dataclass
class MapOutputCommitMessage:
    partition_lengths: np.ndarray
    checksums: Optional[np.ndarray] = None
    #: parity sidecars emitted for this map's data object; 0 = uncoded
    parity_segments: int = 0


class MapOutputWriter:
    """``codec``: the frame codec of the encoding partition writers (default:
    the codec the config names, on ``device``; ``None`` writes raw bytes).
    ``device``: where the TLZ codec and the parity encode run — the CUDA
    device unless ``device="cpu"``, or the given codec's own device."""

    def __init__(self, dispatcher: Dispatcher, helper: ShuffleHelper, shuffle_id: int,
                 map_id: int, num_partitions: int, codec: FrameCodec | None = FROM_CONFIG,
                 device=None):
        self.dispatcher = dispatcher
        self.helper = helper
        self.shuffle_id = shuffle_id
        self.map_id = map_id
        self.num_partitions = num_partitions
        cfg = dispatcher.config
        if codec is FROM_CONFIG:
            self.device = resolve_device(device)
            codec = codec_from_config(cfg, self.device)
        else:
            self.device = resolve_device(device if device is not None
                                         else getattr(codec, "device", None))
        self.codec = codec
        self._checksums_enabled = cfg.checksum_enabled
        self._lengths = np.zeros(num_partitions, dtype=np.int64)
        self._checksum_values = np.zeros(num_partitions, dtype=np.int64)
        self._block = ShuffleDataBlockId(shuffle_id, map_id)
        #: the coded plane's tee (None at parity_segments = 0)
        self._parity_acc = accumulator_from_config(cfg, self.device)
        self._parity_blocks: list = []  # parity ids PUT (abort deletes them)
        # MeasuredOutputStream (serial) or PipelinedUploadStream — both count
        # accepted bytes in bytes_written and flush everything on close()
        self._stream: Optional[io.RawIOBase] = None
        # create_block ran (even if the sink around it then failed to build):
        # abort deletes the data object exactly when this is set
        self._object_created = False
        self._total_bytes = 0
        self._last_partition_id = -1
        self._committed = False

    def _write_stored(self, data) -> None:
        if self._stream is None:
            cfg = self.dispatcher.config
            raw = self.dispatcher.create_block(self._block)
            self._object_created = True
            if cfg.upload_queue_bytes > 0:
                # the measured stream sits beneath the pipeline, so its log
                # times store writes, not queue pushes
                self._stream = PipelinedUploadStream(
                    MeasuredOutputStream(raw, self._block.name),
                    cfg.upload_queue_bytes, label=self._block.name,
                )
            else:
                self._stream = MeasuredOutputStream(
                    io.BufferedWriter(raw, buffer_size=cfg.buffer_size), self._block.name
                )
        self._stream.write(data)
        if self._parity_acc is not None:
            # coded plane tee: the streaming parity encoder sees every
            # stored byte exactly once, in object order
            self._parity_acc.update(data)

    def _next_partition(self, reduce_partition_id: int) -> None:
        if reduce_partition_id <= self._last_partition_id:
            raise ValueError(
                f"Partition writers must be requested in increasing order: "
                f"{reduce_partition_id} after {self._last_partition_id}"
            )
        if reduce_partition_id >= self.num_partitions:
            raise IndexError(reduce_partition_id)
        self._last_partition_id = reduce_partition_id

    def get_partition_writer(self, reduce_partition_id: int,
                             precomputed_checksum: Optional[int] = None) -> "PartitionWriter":
        """A writer of one partition's STORED bytes. ``precomputed_checksum``:
        the partition's checksum over its stored bytes, already known to the
        caller (stitched from CRCs fused into the encode launch); the writer
        then skips hashing, and the sidecar bytes are identical."""
        self._next_partition(reduce_partition_id)
        checksum = (
            create_checksum(self.dispatcher.config.checksum_algorithm)
            if self._checksums_enabled and precomputed_checksum is None
            else None
        )
        return PartitionWriter(
            self, reduce_partition_id, checksum,
            precomputed_checksum if self._checksums_enabled else None,
        )

    def get_encoding_partition_writer(self, reduce_partition_id: int) -> "EncodingPartitionWriter":
        """A writer of one partition's RAW bytes, encoded through the codec."""
        self._next_partition(reduce_partition_id)
        return EncodingPartitionWriter(self, reduce_partition_id)

    def _record_partition(self, reduce_id: int, nbytes: int, checksum_value: int) -> None:
        self._lengths[reduce_id] = nbytes
        self._checksum_values[reduce_id] = checksum_value
        self._total_bytes += nbytes

    def commit_all_partitions(self) -> MapOutputCommitMessage:
        if self._committed:
            raise RuntimeError("commit_all_partitions called twice")
        self._committed = True
        if self._stream is not None:
            if self._stream.bytes_written != self._total_bytes:
                raise IOError(
                    f"Stream position {self._stream.bytes_written} does not match "
                    f"sum of partition lengths {self._total_bytes}"
                )
            self._stream.close()  # final flush to the store, logs bandwidth
        geometry = self._emit_parity()
        if self._total_bytes > 0 or self.dispatcher.config.always_create_index:
            if self._checksums_enabled:
                self.helper.write_checksums(self.shuffle_id, self.map_id, self._checksum_values)
            # index LAST: it is the commit point, for the parity sidecars too
            self.helper.write_partition_lengths(
                self.shuffle_id, self.map_id, self._lengths, parity=geometry
            )
        checksums = self._checksum_values if self._checksums_enabled else None
        return MapOutputCommitMessage(
            self._lengths, checksums,
            parity_segments=0 if geometry is None else geometry.segments,
        )

    def _emit_parity(self):
        """PUT the parity sidecars before the index, so a crash in between
        leaves only orphans. Returns the geometry for the index trailer, or
        None when the plane is off or the map is empty."""
        if self._parity_acc is None or self._total_bytes == 0:
            return None
        payloads = self._parity_acc.finish()
        geometry = self._parity_acc.geometry
        self._parity_blocks = put_parity_objects(self.dispatcher, self._block, geometry, payloads)
        return geometry

    def abort(self, error: Exception | None = None) -> None:
        if not self._object_created:
            return  # nothing was created: no store op
        if self._stream is not None:
            try:
                self._stream.close()
            except Exception:
                # best effort: the pipelined uploader re-raises its failure
                # on close, and the object is deleted right below either way
                logger.debug("close of aborted map output %s failed", self._block.name,
                             exc_info=True)
        self.dispatcher.backend.delete(self.dispatcher.get_path(self._block))
        delete_parity_objects(self.dispatcher, self._parity_blocks)
        logger.warning("Aborted map output %s: %s", self._block.name,
                       error if error else "unknown")


class PartitionWriter(io.RawIOBase):
    """Counts and checksums the stored bytes of one reduce partition while
    passing them through to the map's data object."""

    def __init__(self, parent: MapOutputWriter, reduce_id: int,
                 checksum: Optional[Checksum], precomputed_checksum: Optional[int] = None):
        self._parent = parent
        self.reduce_id = reduce_id
        self._checksum = checksum
        #: the partition's checksum when the caller knows it; read at close
        self.precomputed_checksum = precomputed_checksum
        self.bytes_written = 0
        self._finalized = False

    def writable(self) -> bool:
        return True

    def write(self, b) -> int:
        n = b.nbytes if isinstance(b, memoryview) else len(b)
        if n:
            self._parent._write_stored(b)
            if self._checksum is not None:
                self._checksum.update(b)
            self.bytes_written += n
        return n

    def close(self) -> None:
        # finalize this partition's length/checksum; the data object stays
        # open for the next partition
        if not self._finalized:
            self._finalized = True
            if self.precomputed_checksum is not None:
                value = self.precomputed_checksum
            else:
                value = self._checksum.value if self._checksum is not None else 0
            self._parent._record_partition(self.reduce_id, self.bytes_written, value)
        super().close()


class EncodingPartitionWriter(io.RawIOBase):
    """Takes one reduce partition's RAW bytes; ``close`` flushes the final
    short block and records the partition's stored length and checksum.
    With CRC32C the checksum is stitched from the CRCs fused into the encode
    launches (:class:`FusedChecksumAccumulator`) when the codec is the TLZ
    codec; other algorithms and other codecs hash the stored bytes, and
    without a codec the raw bytes are stored as they come."""

    def __init__(self, parent: MapOutputWriter, reduce_id: int):
        self._parent = parent
        cfg = parent.dispatcher.config
        fused = None
        checksum = None
        if cfg.checksum_enabled:
            if cfg.checksum_algorithm == "CRC32C" and \
                    getattr(parent.codec, "supports_fused_checksum", False):
                fused = FusedChecksumAccumulator(POLY_CRC32C)
            else:
                checksum = create_checksum(cfg.checksum_algorithm)
        self._fused = fused
        self._stored = PartitionWriter(parent, reduce_id, checksum)
        self._codec_stream = self._stored if parent.codec is None else CodecOutputStream(
            parent.codec, self._stored, close_sink=False, checksum=fused
        )
        self._finalized = False

    def writable(self) -> bool:
        return True

    def write(self, b) -> int:
        return self._codec_stream.write(b)

    def close(self) -> None:
        if not self._finalized:
            self._finalized = True
            if self._codec_stream is not self._stored:
                self._codec_stream.close()
            if self._fused is not None:
                self._stored.precomputed_checksum = self._fused.value
            self._stored.close()
        super().close()
