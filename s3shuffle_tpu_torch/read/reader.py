"""Reduce-side reader: one reduce partition's bytes from every map output.

A lean counterpart of the JAX package's ``read/reader.py`` for this slice:
the partition's blocks are enumerated from the maps' index objects
(metadata mode: the caller names the committed map ids), and each block is
read through the reference's stream stack::

    BlockStream (ranged GET of [offsets[r], offsets[r+1]); a lost data
                 object is rebuilt from parity by the reader's DegradedReader)
      → ChecksumValidationStream (deferred: certified by the decode launch)
        → CodecInputStream (batched device decode + fused CRC)

Rebuilt bytes go through the same checksum validation and fused decode CRC
as bytes read from the data object.

The decoded bytes come back concatenated in map order. A checksum mismatch
raises :class:`~s3shuffle_tpu_torch.read.checksum_stream.ChecksumError`
naming the block; a map without an index raises FileNotFoundError. The
record layer (deserialization, aggregation, sorting), prefetch and scan
planning arrive with later slices.
"""

from __future__ import annotations

from typing import Iterable

from s3shuffle_tpu_torch.block_ids import ShuffleBlockId, ShuffleDataBlockId
from s3shuffle_tpu_torch.codec.cuda import CudaCodec
from s3shuffle_tpu_torch.codec.framing import CodecInputStream
from s3shuffle_tpu_torch.coding.degraded import DegradedReader
from s3shuffle_tpu_torch.metadata.helper import ShuffleHelper
from s3shuffle_tpu_torch.read.block_stream import BlockStream
from s3shuffle_tpu_torch.read.checksum_stream import ChecksumValidationStream
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher


class ShuffleReader:
    """``codec``: the frame codec (default: a :class:`CudaCodec` built from
    the config on ``device`` — the CUDA device unless ``device="cpu"``)."""

    def __init__(self, dispatcher: Dispatcher, helper: ShuffleHelper,
                 codec: CudaCodec | None = None, device=None):
        self.dispatcher = dispatcher
        self.helper = helper
        self.codec = (
            codec if codec is not None
            else CudaCodec.from_config(dispatcher.config, device)
        )
        #: loss reconstruction for coded map outputs (K4 on the codec's device)
        self.recovery = DegradedReader(dispatcher, self.codec.device)
        #: frames decoded, and those certified by a CRC fused into the decode
        self.frames = 0
        self.fused_frames = 0

    @property
    def reconstructions(self) -> int:
        """Block ranges served by parity reconstruction."""
        return self.recovery.reconstructions

    def open_block(self, block: ShuffleBlockId) -> CodecInputStream:
        """The decoded stream of one (map, reduce) block."""
        cfg = self.dispatcher.config
        offsets, geometry = self.helper.get_index(block.shuffle_id, block.map_id)
        data_block = ShuffleDataBlockId(block.shuffle_id, block.map_id)
        self.recovery.register(data_block, geometry)
        start, end = block.reduce_id, block.reduce_id + 1
        stream = BlockStream(
            self.dispatcher, block, data_block, int(offsets[start]), int(offsets[end]),
            recovery=self.recovery,
        )
        if cfg.checksum_enabled:
            checksums = self.helper.get_checksums(block.shuffle_id, block.map_id)
            stream = ChecksumValidationStream(
                block, stream, offsets, checksums, start, end, cfg.checksum_algorithm
            )
        return CodecInputStream(self.codec, stream)

    def read_partition(self, shuffle_id: int, reduce_id: int, map_ids: Iterable[int]) -> bytes:
        parts = []
        for map_id in map_ids:
            with self.open_block(ShuffleBlockId(shuffle_id, map_id, reduce_id)) as stream:
                parts.append(stream.read())
                self.frames += stream.frames
                self.fused_frames += stream.fused_frames
        return b"".join(parts)
