"""Map-side writer: all reduce partitions of one map task → one data object.

Counterpart of the JAX package's ``write/map_output_writer.py`` (parity with
the reference's ``S3ShuffleMapOutputWriter``), with the codec inside:

- one data object ``shuffle_<s>_<m>_0.data``, opened lazily on the first
  stored byte (an empty map creates no object);
- partition writers in strictly increasing reduce-id order; each takes the
  partition's RAW bytes through its own ``CodecOutputStream`` (partitions
  never share a frame) and records the partition's stored length and
  checksum;
- with ``checksum_algorithm = CRC32C`` the partition checksum is stitched
  from the CRCs fused into the encode launches
  (:class:`~s3shuffle_tpu_torch.codec.cuda.FusedChecksumAccumulator`, as
  the JAX package's ``write/spill_writer.py`` wires it); other algorithms
  hash the stored bytes on the host;
- with ``parity_segments > 0`` every stored byte is also teed, once and in
  object order, into the streaming parity encoder
  (:class:`~s3shuffle_tpu_torch.coding.parity.ParityAccumulator`, kernel K4
  on the codec's device);
- ``commit_all_partitions`` closes the data object, then PUTs the parity
  sidecars, then writes the checksum sidecar, then the index (with the
  stripe-geometry trailer when coded) — the commit point;
- ``abort`` drops the partial data object and any parity sidecars PUT.
"""

from __future__ import annotations

import dataclasses
import io
from typing import Optional

import numpy as np

from s3shuffle_tpu_torch.block_ids import ShuffleDataBlockId
from s3shuffle_tpu_torch.codec.cuda import CudaCodec, FusedChecksumAccumulator
from s3shuffle_tpu_torch.codec.framing import CodecOutputStream
from s3shuffle_tpu_torch.coding.parity import (
    accumulator_from_config,
    delete_parity_objects,
    put_parity_objects,
)
from s3shuffle_tpu_torch.metadata.helper import ShuffleHelper
from s3shuffle_tpu_torch.ops.checksum import POLY_CRC32C
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
from s3shuffle_tpu_torch.utils.checksums import create_checksum


@dataclasses.dataclass
class MapOutputCommitMessage:
    partition_lengths: np.ndarray
    checksums: Optional[np.ndarray] = None
    #: parity sidecars emitted for this map's data object; 0 = uncoded
    parity_segments: int = 0


class MapOutputWriter:
    """``codec``: the frame codec (default: a :class:`CudaCodec` built from
    the config on ``device`` — the CUDA device unless ``device="cpu"``)."""

    def __init__(self, dispatcher: Dispatcher, helper: ShuffleHelper, shuffle_id: int,
                 map_id: int, num_partitions: int, codec: CudaCodec | None = None,
                 device=None):
        self.dispatcher = dispatcher
        self.helper = helper
        self.shuffle_id = shuffle_id
        self.map_id = map_id
        self.num_partitions = num_partitions
        cfg = dispatcher.config
        self.codec = codec if codec is not None else CudaCodec.from_config(cfg, device)
        self._checksums_enabled = cfg.checksum_enabled
        self._lengths = np.zeros(num_partitions, dtype=np.int64)
        self._checksum_values = np.zeros(num_partitions, dtype=np.int64)
        self._block = ShuffleDataBlockId(shuffle_id, map_id)
        #: the coded plane's tee (None at parity_segments = 0)
        self._parity_acc = accumulator_from_config(cfg, self.codec.device)
        self._parity_blocks: list = []  # parity ids PUT (abort deletes them)
        self._stream: Optional[io.RawIOBase] = None
        self._bytes_written = 0
        self._total_bytes = 0
        self._last_partition_id = -1
        self._committed = False
        #: frames emitted, and those whose CRC came fused from the encode
        self.frames = 0
        self.fused_frames = 0

    def _write_stored(self, data) -> None:
        if self._stream is None:
            self._stream = self.dispatcher.create_block(self._block)
        self._stream.write(data)
        if self._parity_acc is not None:
            self._parity_acc.update(data)
        self._bytes_written += len(data)

    def get_partition_writer(self, reduce_partition_id: int) -> "PartitionWriter":
        if reduce_partition_id <= self._last_partition_id:
            raise ValueError(
                f"Partition writers must be requested in increasing order: "
                f"{reduce_partition_id} after {self._last_partition_id}"
            )
        if reduce_partition_id >= self.num_partitions:
            raise IndexError(reduce_partition_id)
        self._last_partition_id = reduce_partition_id
        return PartitionWriter(self, reduce_partition_id)

    def _record_partition(self, reduce_id: int, nbytes: int, checksum_value: int,
                          frames: int, fused_frames: int) -> None:
        self._lengths[reduce_id] = nbytes
        self._checksum_values[reduce_id] = checksum_value
        self._total_bytes += nbytes
        self.frames += frames
        self.fused_frames += fused_frames

    def commit_all_partitions(self) -> MapOutputCommitMessage:
        if self._committed:
            raise RuntimeError("commit_all_partitions called twice")
        self._committed = True
        if self._stream is not None:
            if self._bytes_written != self._total_bytes:
                raise IOError(
                    f"Stream position {self._bytes_written} does not match "
                    f"sum of partition lengths {self._total_bytes}"
                )
            self._stream.close()
        geometry = self._emit_parity()
        if self._total_bytes > 0:
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

    def abort(self) -> None:
        if self._stream is None:
            return  # nothing was created: no store op
        self._stream.close()
        self.dispatcher.backend.delete(self.dispatcher.get_path(self._block))
        delete_parity_objects(self.dispatcher, self._parity_blocks)


class _StoredSink(io.RawIOBase):
    """Where a partition's frames land: the map's data object, counted and
    (for non-fused algorithms) hashed on the way."""

    def __init__(self, parent: MapOutputWriter, checksum):
        self._parent = parent
        self._checksum = checksum
        self.count = 0

    def writable(self) -> bool:
        return True

    def write(self, b) -> int:
        n = len(b)
        if n:
            self._parent._write_stored(b)
            if self._checksum is not None:
                self._checksum.update(b)
            self.count += n
        return n


class PartitionWriter(io.RawIOBase):
    """Takes one reduce partition's RAW bytes; ``close`` flushes the final
    short block and records the partition's stored length and checksum."""

    def __init__(self, parent: MapOutputWriter, reduce_id: int):
        self._parent = parent
        self.reduce_id = reduce_id
        cfg = parent.dispatcher.config
        fused = None
        streaming = None
        if cfg.checksum_enabled:
            if cfg.checksum_algorithm == "CRC32C":
                fused = FusedChecksumAccumulator(POLY_CRC32C)
            else:
                streaming = create_checksum(cfg.checksum_algorithm)
        self._fused = fused
        self._streaming = streaming
        self._sink = _StoredSink(parent, streaming)
        self._codec_stream = CodecOutputStream(
            parent.codec, self._sink, close_sink=False, checksum=fused
        )
        self._finalized = False

    def writable(self) -> bool:
        return True

    def write(self, b) -> int:
        return self._codec_stream.write(b)

    def close(self) -> None:
        if not self._finalized:
            self._finalized = True
            self._codec_stream.close()
            if self._fused is not None:
                value = self._fused.value
            elif self._streaming is not None:
                value = self._streaming.value
            else:
                value = 0
            self._parent._record_partition(
                self.reduce_id, self._sink.count, value,
                self._codec_stream.frames, self._codec_stream.fused_frames,
            )
        super().close()
