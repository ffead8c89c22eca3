"""Reduce-side reader (the JAX package's ``read/reader.py``; parity with the
reference's ``S3ShuffleReader``, storage/S3ShuffleReader.scala:37-198).

The record API (:meth:`ShuffleReader.read`, :meth:`read_batches`,
:meth:`read_result_batches`) assembles:

1. block enumeration through the map-output tracker (metadata mode,
   :169-180), dropping empty blocks; with batch fetch (relocatable
   serializer and more than one partition, or ``force_batch_fetch``) each
   map's contiguous partition range is one ``ShuffleBlockBatchId``;
2. per block, read in order through the reference's stream stack::

       BlockStream (ranged GET of the block's byte range; a lost data
                    object is rebuilt from parity by the DegradedReader)
         → ChecksumValidationStream (deferred: certified by the decode launch)
           → CodecInputStream (batched device decode + fused CRC, kernel K3;
                               frames of a host codec are decoded on the host
                               and hashed; no codec: the raw bytes)

   then the serializer's record or batch iterator (:98-110);
3. optional aggregation (:124-138) and key ordering (:141-149): a
   columnar aggregator (``supports_columnar``) over a batch serializer
   reduces read batches with its
   :class:`~s3shuffle_tpu_torch.colagg.ColumnarReducer` (output key-sorted),
   any other aggregator per record; the columnar plane sorts by natural key
   bytes with the :class:`~s3shuffle_tpu_torch.batch.BatchSorter`, other
   orderings with the :class:`~s3shuffle_tpu_torch.sorter.ExternalSorter`.

A map output flagged as carrying map-side-combined partial rows (the JAX
package's skew plane) is refused to a record read without an aggregator.
The raw API (:meth:`open_block`, :meth:`read_partition`) serves one
block's or one partition's decoded bytes. A checksum mismatch raises
:class:`~s3shuffle_tpu_torch.read.checksum_stream.ChecksumError` naming the
block; a map without an index raises FileNotFoundError. Prefetch and scan
planning are not ported yet: blocks are read one after another.
"""

from __future__ import annotations

import itertools
from typing import Any, Iterable, Iterator, List, Optional, Tuple, Union

from s3shuffle_tpu_torch.batch import BatchSorter, RecordBatch
from s3shuffle_tpu_torch.block_ids import (
    ShuffleBlockBatchId,
    ShuffleBlockId,
    ShuffleDataBlockId,
)
from s3shuffle_tpu_torch.codec import FROM_CONFIG, codec_from_config
from s3shuffle_tpu_torch.codec.framing import CodecInputStream, FrameCodec
from s3shuffle_tpu_torch.coding.degraded import DegradedReader
from s3shuffle_tpu_torch.dependency import ShuffleDependency, natural_key
from s3shuffle_tpu_torch.device import resolve_device
from s3shuffle_tpu_torch.metadata.helper import ShuffleHelper
from s3shuffle_tpu_torch.metadata.map_output import MapOutputTracker
from s3shuffle_tpu_torch.read.block_stream import BlockStream
from s3shuffle_tpu_torch.read.checksum_stream import ChecksumValidationStream
from s3shuffle_tpu_torch.sorter import ExternalSorter
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher

ReadableBlockId = Union[ShuffleBlockId, ShuffleBlockBatchId]


class ShuffleReader:
    """``codec``: the frame codec (default: the codec the config names, on
    ``device``; ``None`` reads raw bytes). ``device``: where TLZ frames are
    decoded and lost objects rebuilt — the CUDA device unless
    ``device="cpu"``, or the given codec's own device.
    ``tracker``/``dependency`` and the partition and map ranges serve the
    record API; the raw API needs neither."""

    def __init__(
        self,
        dispatcher: Dispatcher,
        helper: ShuffleHelper,
        tracker: Optional[MapOutputTracker] = None,
        dependency: Optional[ShuffleDependency] = None,
        start_partition: int = 0,
        end_partition: int = 0,
        start_map_index: int = 0,
        end_map_index: Optional[int] = None,
        codec: FrameCodec | None = FROM_CONFIG,
        device=None,
    ):
        self.dispatcher = dispatcher
        self.helper = helper
        self.tracker = tracker
        self.dep = dependency
        self.start_partition = start_partition
        self.end_partition = end_partition
        self.start_map_index = start_map_index
        self.end_map_index = end_map_index
        if codec is FROM_CONFIG:
            self.device = resolve_device(device)
            codec = codec_from_config(dispatcher.config, self.device)
        else:
            self.device = resolve_device(device if device is not None
                                         else getattr(codec, "device", None))
        self.codec = codec
        #: loss reconstruction for coded map outputs (K4 on the reader's device)
        self.recovery = DegradedReader(dispatcher, self.device)

    @property
    def reconstructions(self) -> int:
        """Block ranges served by parity reconstruction."""
        return self.recovery.reconstructions

    # --- the raw API ---
    def open_block(self, block: ReadableBlockId):
        """The decoded stream of one (map, reduce) block or one map's
        contiguous partition range (its stored bytes without a codec)."""
        cfg = self.dispatcher.config
        offsets, geometry, skew = self.helper.read_index(block.shuffle_id, block.map_id)
        if skew is not None and skew.combined and self.dep is not None \
                and self.dep.aggregator is None:
            # the partitions carry map-side-combined PARTIAL rows: only the
            # aggregator that merges partials may read them as records
            raise ValueError(
                f"map output {block.shuffle_id}/{block.map_id} carries "
                "map-side-combined partial rows but this read has no "
                "aggregator to merge them; read with the aggregating "
                "dependency that wrote the data"
            )
        data_block = ShuffleDataBlockId(block.shuffle_id, block.map_id)
        self.recovery.register(data_block, geometry)
        if isinstance(block, ShuffleBlockBatchId):
            start, end = block.start_reduce_id, block.end_reduce_id
        else:
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
        if self.codec is None:
            return stream
        return CodecInputStream(self.codec, stream, device=self.device)

    def read_partition(self, shuffle_id: int, reduce_id: int, map_ids: Iterable[int]) -> bytes:
        """One reduce partition's decoded bytes from the named maps, in order."""
        parts = []
        for map_id in map_ids:
            with self.open_block(ShuffleBlockId(shuffle_id, map_id, reduce_id)) as stream:
                parts.append(stream.read())
        return b"".join(parts)

    # --- the record API ---
    @property
    def do_batch_fetch(self) -> bool:
        """Batch-fetch eligibility (S3ShuffleReader.scala:55-75): a
        relocatable serializer over more than one partition (the framing
        always concatenates), or ``force_batch_fetch``."""
        return (
            self.dep.serializer.relocatable
            and self.end_partition - self.start_partition > 1
        ) or self.dispatcher.config.force_batch_fetch

    def compute_shuffle_blocks(self) -> List[ReadableBlockId]:
        """Parity: computeShuffleBlocks in metadata mode
        (S3ShuffleReader.scala:160-180): non-empty blocks only."""
        if self.tracker is None:
            raise RuntimeError("the record API needs a MapOutputTracker")
        sid = self.dep.shuffle_id
        entries = self.tracker.get_map_sizes_by_range(
            sid, self.start_map_index, self.end_map_index,
            self.start_partition, self.end_partition,
        )
        blocks: List[ReadableBlockId] = []
        for map_id, sizes in entries:
            if self.do_batch_fetch:
                if any(n > 0 for _r, n in sizes):
                    blocks.append(
                        ShuffleBlockBatchId(sid, map_id, self.start_partition, self.end_partition)
                    )
            else:
                blocks.extend(ShuffleBlockId(sid, map_id, rid) for rid, n in sizes if n > 0)
        return blocks

    def _block_streams(self) -> Iterator[CodecInputStream]:
        """The decoded stream of every block, in order, each closed once its
        consumer moves on."""
        for block in self.compute_shuffle_blocks():
            stream = self.open_block(block)
            try:
                yield stream
            finally:
                stream.close()

    def read_batches(self) -> Iterator[RecordBatch]:
        """RecordBatches of a columnar serializer (no aggregation or
        ordering applied)."""
        for stream in self._block_streams():
            yield from self.dep.serializer.new_batch_read_stream(stream)

    def _chunks(self) -> Iterator[list]:
        """Record chunks (lists) of every block."""
        for stream in self._block_streams():
            yield from self.dep.serializer.new_chunk_read_stream(stream)

    def read(self) -> Iterator[Tuple[Any, Any]]:
        """The partition range's records, aggregated and ordered as the
        dependency asks."""
        dep = self.dep
        if dep.serializer.supports_batches:
            if dep.aggregator is None:
                return self._read_batched()
            if dep.aggregator.supports_columnar:
                return self._read_columnar_agg()
        # chunk-level iteration + C-level flattening
        records = itertools.chain.from_iterable(self._chunks())
        spill = self.dispatcher.config.aggregator_spill_bytes
        if dep.aggregator is not None:
            if dep.map_side_combine:
                records = dep.aggregator.combine_combiners_by_key(records, spill_bytes=spill)
            else:
                records = dep.aggregator.combine_values_by_key(records, spill_bytes=spill)
        if dep.key_ordering is not None:
            sorter = ExternalSorter(
                key_func=dep.key_ordering,
                spill_bytes=self.dispatcher.config.sorter_spill_bytes,
            )
            sorter.insert_all(records)
            records = sorter.sorted_iterator()
        return records

    def _read_batched(self) -> Iterator[Tuple[Any, Any]]:
        key_ordering = self.dep.key_ordering
        if key_ordering is None:
            for batch in self.read_batches():
                yield from batch.iter_records()
            return
        if key_ordering is natural_key:
            yield from self._fed_batch_sorter().sorted_records()
            return
        # a custom key function: per-record external sort over batch records
        sorter = ExternalSorter(
            key_func=key_ordering,
            spill_bytes=self.dispatcher.config.sorter_spill_bytes,
        )
        for batch in self.read_batches():
            sorter.insert_batch(batch)
        yield from sorter.sorted_iterator()

    def _reduced_batches(self) -> Iterator[RecordBatch]:
        """Columnar combine: the read batches through the aggregator's
        ColumnarReducer (sort + reduceat group-by, bounded memory). Output
        batches arrive key-sorted."""
        reducer = self.dep.aggregator.new_reducer(
            spill_bytes=self.dispatcher.config.aggregator_spill_bytes
        )
        for batch in self.read_batches():
            reducer.add(batch)
        return reducer.results()

    def _read_columnar_agg(self) -> Iterator[Tuple[Any, Any]]:
        key_ordering = self.dep.key_ordering
        if key_ordering is None or key_ordering is natural_key:
            # the reducer's output is already in key-byte order
            for batch in self._reduced_batches():
                yield from batch.iter_records()
            return
        sorter = ExternalSorter(
            key_func=key_ordering,
            spill_bytes=self.dispatcher.config.sorter_spill_bytes,
        )
        for batch in self._reduced_batches():
            sorter.insert_batch(batch)
        yield from sorter.sorted_iterator()

    def _fed_batch_sorter(self) -> BatchSorter:
        """The natural-byte-order BatchSorter fed every read batch."""
        sorter = BatchSorter(spill_bytes=self.dispatcher.config.sorter_spill_bytes)
        for batch in self.read_batches():
            sorter.add(batch)
        return sorter

    def read_result_batches(self) -> List[RecordBatch]:
        """Fully columnar terminal read: the reduce output as a list of
        RecordBatches (ordered when the dependency asks for natural byte
        ordering)."""

        def fallback():
            records = list(self.read())
            for k, v in records[:1]:
                if not isinstance(k, (bytes, bytearray, memoryview)) or not isinstance(
                    v, (bytes, bytearray, memoryview)
                ):
                    raise ValueError(
                        "materialize='batches' requires byte keys/values "
                        f"(got {type(k).__name__}/{type(v).__name__}); use a "
                        "bytes serializer or materialize='records'"
                    )
            return [RecordBatch.from_records(records)]

        dep = self.dep
        if not dep.serializer.supports_batches:
            return fallback()
        if dep.aggregator is not None:
            if dep.aggregator.supports_columnar and (
                dep.key_ordering is None or dep.key_ordering is natural_key
            ):
                return list(self._reduced_batches())
            return fallback()
        if dep.key_ordering is None:
            return list(self.read_batches())
        if dep.key_ordering is natural_key:
            return list(self._fed_batch_sorter().sorted_batches())
        return fallback()
