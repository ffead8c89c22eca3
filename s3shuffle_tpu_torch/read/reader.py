"""Reduce-side reader (the JAX package's ``read/reader.py``; parity with the
reference's ``S3ShuffleReader``, storage/S3ShuffleReader.scala:37-198).

The record API (:meth:`ShuffleReader.read`, :meth:`read_batches`,
:meth:`read_result_batches`) assembles:

1. block enumeration: through the map-output tracker (metadata mode,
   :169-180), dropping empty blocks, or, at ``use_block_manager=False``, by
   listing the committed ``*.index`` objects and the composite groups'
   ``*.cindex`` fat indexes in the store (listing mode, :181-196; one GET
   per group enumerates its members, an unreadable group is skipped and
   logged), filtered by the map range (on ``map_id // stride`` and the
   latest attempt of each logical map at ``map_id_attempt_stride``); with
   batch fetch (relocatable serializer and more than one partition, or
   ``force_batch_fetch``) each map's contiguous partition range is one
   ``ShuffleBlockBatchId``. A composite member's coordinates (from the
   tracker when a composite or compaction knob is on, or from the listing)
   seed the helper's hints, which win over any per-map index;
2. the prefetching scan (``read/scan_plan.py``, :98): the coalescing
   planner's segments by default, the per-block
   :class:`~s3shuffle_tpu_torch.read.prefetch.BufferedPrefetchIterator` at
   ``coalesce_gap_bytes=0``; prefetch threads do the GETs (a lost data
   object is rebuilt from parity by the scan's DegradedReader), blocks
   arrive in completion order, and a fresh per-scan index memo serves
   range resolution and the checksum wiring;
3. per block, on the consumer thread, the reference's stream stack::

       prefetched (or sliced) block stream
         → ChecksumValidationStream (deferred: certified by the decode launch)
           → CodecInputStream (batched device decode + fused CRC, kernel K3;
                               frames of a host codec are decoded on the host
                               and hashed; no codec: the raw bytes; its
                               decode window on the shared decode pool
                               reserves against the scan's budget)

   then the serializer's record or batch iterator (:99-110), with the
   remote-bytes/blocks and records counters of :class:`ShuffleReadMetrics`;
4. optional aggregation (:124-138) and key ordering (:141-149): a
   columnar aggregator (``supports_columnar``) over a batch serializer
   reduces read batches with its
   :class:`~s3shuffle_tpu_torch.colagg.ColumnarReducer` (output key-sorted),
   any other aggregator per record; the columnar plane sorts by natural key
   bytes with the :class:`~s3shuffle_tpu_torch.batch.BatchSorter`, other
   orderings with the :class:`~s3shuffle_tpu_torch.sorter.ExternalSorter`.

A map output flagged as carrying map-side-combined partial rows (the JAX
package's skew plane) is refused to a record read without an aggregator.
The raw API serves one block's decoded stream (:meth:`open_block`, a
direct ranged read through the helper's caches) or one partition's decoded
bytes from the named maps in map order (:meth:`read_partition`, one scan).
A checksum mismatch raises
:class:`~s3shuffle_tpu_torch.read.checksum_stream.ChecksumError` naming the
block; a map without an index raises FileNotFoundError. A consumer that
stops early closes the scan: its prefetch threads exit and its budget comes
back.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
from typing import Any, Iterable, Iterator, List, Optional, Tuple, Union

from s3shuffle_tpu_torch.batch import BatchSorter, RecordBatch
from s3shuffle_tpu_torch.block_ids import (
    ShuffleBlockBatchId,
    ShuffleBlockId,
    ShuffleIndexBlockId,
)
from s3shuffle_tpu_torch.codec import FROM_CONFIG, codec_from_config
from s3shuffle_tpu_torch.codec.framing import CodecInputStream, FrameCodec
from s3shuffle_tpu_torch.coding.degraded import DegradedReader
from s3shuffle_tpu_torch.dependency import ShuffleDependency, natural_key
from s3shuffle_tpu_torch.device import resolve_device
from s3shuffle_tpu_torch.metadata.helper import ScanIndexMemo, ShuffleHelper
from s3shuffle_tpu_torch.metadata.map_output import MapOutputTrackerLike, dedupe_latest_attempt
from s3shuffle_tpu_torch.read.block_iterator import reduce_span
from s3shuffle_tpu_torch.read.block_stream import BlockStream
from s3shuffle_tpu_torch.read.checksum_stream import ChecksumValidationStream
from s3shuffle_tpu_torch.read.chunked_fetch import ChunkedRangeFetcher
from s3shuffle_tpu_torch.read.scan_plan import build_scan_iterator, tuned_scan_config
from s3shuffle_tpu_torch.metrics import registry as _metrics
from s3shuffle_tpu_torch.metrics.stats import COLLECTOR
from s3shuffle_tpu_torch.serializer import count_fallback_rows, count_plane_rows
from s3shuffle_tpu_torch.sorter import ExternalSorter
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
from s3shuffle_tpu_torch.utils import trace

ReadableBlockId = Union[ShuffleBlockId, ShuffleBlockBatchId]

logger = logging.getLogger("s3shuffle_tpu_torch.read")


@dataclasses.dataclass
class ShuffleReadMetrics:
    """Parity: the Spark metric names fed at S3ShuffleReader.scala:91-118."""

    remote_blocks_fetched: int = 0
    remote_bytes_read: int = 0
    records_read: int = 0
    wait_ns: int = 0
    prefetch_ns: int = 0


class ShuffleReader:
    """``codec``: the frame codec (default: the codec the config names, on
    ``device``; ``None`` reads raw bytes). ``device``: where TLZ frames are
    decoded and lost objects rebuilt — the CUDA device unless
    ``device="cpu"``, or the given codec's own device.
    ``tracker``/``dependency`` and the partition and map ranges serve the
    record API; the raw API needs neither. ``metrics`` sums every scan's
    counters; ``prefetch_stats`` holds the last drained scan's prefetcher
    statistics."""

    def __init__(
        self,
        dispatcher: Dispatcher,
        helper: ShuffleHelper,
        tracker: Optional[MapOutputTrackerLike] = None,
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
        #: loss reconstruction for :meth:`open_block` (each scan has its own)
        self.recovery = DegradedReader(dispatcher, self.device)
        self._scan_reconstructions = 0
        self.metrics = ShuffleReadMetrics()
        self.prefetch_stats: Optional[dict] = None

    @property
    def reconstructions(self) -> int:
        """Block ranges served by parity reconstruction (finished scans and
        :meth:`open_block`)."""
        return self.recovery.reconstructions + self._scan_reconstructions

    # --- the raw API ---
    def open_block(self, block: ReadableBlockId):
        """The decoded stream of one (map, reduce) block or one map's
        contiguous partition range (its stored bytes without a codec), read
        directly through the helper's caches."""
        location = self.helper.resolve_map_location(block.shuffle_id, block.map_id)
        self.recovery.register(location.data_block, location.parity)
        start, end = reduce_span(block)
        stream = BlockStream(
            self.dispatcher, block, location.data_block,
            int(location.offsets[start]), int(location.offsets[end]),
            recovery=self.recovery,
        )
        return self._validated_decoded(block, stream, location, self.helper, budget=None)

    def read_partition(self, shuffle_id: int, reduce_id: int, map_ids: Iterable[int]) -> bytes:
        """One reduce partition's decoded bytes from the named maps, in map
        order, fetched by one scan (blocks complete in any order)."""
        map_ids = list(map_ids)
        parts = {}
        blocks = [ShuffleBlockId(shuffle_id, m, reduce_id) for m in map_ids]
        for block, stream in self._decoded_streams(blocks):
            parts[block.map_id] = stream.read()
        return b"".join(parts.get(m, b"") for m in map_ids)

    def _validated_decoded(self, block, stream, location, metadata, budget):
        """Checksum validation and the codec over one block's stored-byte
        stream (the analog of ``serializerManager.wrapStream``, :98-110);
        ``metadata`` (the helper or the scan's memo) serves the checksums,
        and ``budget`` (the scan's prefetcher, or None) holds the decode
        window's in-flight bytes against ``max_buffer_size_task``. A map
        output flagged as carrying map-side-combined partial rows is refused
        to a read without an aggregator."""
        if location.combined and self.dep is not None and self.dep.aggregator is None:
            raise ValueError(
                f"map output {block.shuffle_id}/{block.map_id} carries "
                "map-side-combined partial rows but this read has no "
                "aggregator to merge them; read with the aggregating "
                "dependency that wrote the data"
            )
        cfg = self.dispatcher.config
        if cfg.checksum_enabled:
            start, end = reduce_span(block)
            checksums = metadata.get_checksums(block.shuffle_id, block.map_id)
            stream = ChecksumValidationStream(
                block, stream, location.offsets, checksums, start, end, cfg.checksum_algorithm
            )
        if self.codec is None:
            return stream
        return CodecInputStream(self.codec, stream, device=self.device, budget=budget)

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
        """Parity: computeShuffleBlocks (S3ShuffleReader.scala:160-197). In
        metadata mode the tracker's non-empty blocks; in listing mode a
        block per partition in range of every committed map (the planner
        drops the empty ones)."""
        if not self.dispatcher.config.use_block_manager:
            return self._listed_blocks()
        if self.tracker is None:
            raise RuntimeError("use_block_manager=True requires a MapOutputTracker")
        sid = self.dep.shuffle_id
        self._seed_composite_hints(sid)
        # the batch form: one control-plane round-trip for the whole scan
        # (none with a snapshot-backed tracker), as the JAX reader asks
        entries = self.tracker.get_map_sizes_by_ranges(
            sid, self.start_map_index, self.end_map_index,
            [(self.start_partition, self.end_partition)],
        )[0]
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

    def _seed_composite_hints(self, sid: int) -> None:
        """Feed the tracker's composite coordinates into the helper, so
        composite members resolve without any per-map index fetch. Skipped
        when no composite or compaction knob is on (the composite-off
        control-plane traffic stays as it was); a failure only leaves
        resolution to store-side discovery."""
        cfg = self.dispatcher.config
        if cfg.composite_commit_maps <= 1 and cfg.compact_below_bytes <= 0:
            return
        locs = getattr(self.tracker, "composite_locations", None)
        if locs is None:
            return
        try:
            for map_id, group_id, base in locs(sid):
                self.helper.note_composite_location(sid, map_id, group_id, base)
        except Exception as e:
            logger.warning("composite-location seed for shuffle %d failed: %s", sid, e)

    def _listed_blocks(self) -> List[ReadableBlockId]:
        """Listing mode (:181-196): the committed per-map ``*.index``
        objects and the members of every sealed composite group (one fat
        index GET each, cached; each member's coordinates become a helper
        hint), filtered by the map range. A map in both layouts (compacted,
        its old objects not yet swept) is listed once. With
        ``map_id_attempt_stride`` the logical map index is ``map_id //
        stride``, and only the latest committed attempt of each is read
        (the tracker's dedupe, shared)."""
        sid = self.dep.shuffle_id
        singles, groups = self.dispatcher.list_committed_outputs(sid)
        by_map = {idx.map_id: idx for idx in singles}
        for group_id in groups:
            try:
                fat = self.helper.read_fat_index(sid, group_id)
            except (OSError, ValueError) as e:
                logger.warning("Skipping composite group %d of shuffle %d: unreadable "
                               "fat index (%s)", group_id, sid, e)
                continue
            for m in fat.members.values():
                self.helper.note_composite_location(sid, m.map_id, group_id, m.base_offset)
                by_map.setdefault(m.map_id, ShuffleIndexBlockId(sid, m.map_id))
        indices = [by_map[mid] for mid in sorted(by_map)]
        stride = self.dispatcher.config.map_id_attempt_stride
        if stride:
            deduped = dedupe_latest_attempt(
                indices,
                logical_of=lambda idx: idx.map_id // stride,
                map_id_of=lambda idx: idx.map_id,
            )
            indices = [idx for _lg, idx in deduped]

            def logical(idx):
                return idx.map_id // stride
        else:
            def logical(idx):
                return idx.map_id
        blocks: List[ReadableBlockId] = []
        for idx in indices:
            if logical(idx) < self.start_map_index:
                continue
            if self.end_map_index is not None and logical(idx) >= self.end_map_index:
                continue
            if self.do_batch_fetch:
                blocks.append(
                    ShuffleBlockBatchId(sid, idx.map_id, self.start_partition, self.end_partition)
                )
            else:
                blocks.extend(
                    ShuffleBlockId(sid, idx.map_id, rid)
                    for rid in range(self.start_partition, self.end_partition)
                )
        return blocks

    # --- the scan ---
    def _count_block(self, _block, nbytes: int) -> None:
        """Remote bytes/blocks (:91-97), fed per non-empty block by either
        scan path."""
        self.metrics.remote_blocks_fetched += 1
        self.metrics.remote_bytes_read += nbytes

    def _make_prefetcher(self, blocks, memo: ScanIndexMemo, recovery: DegradedReader):
        """The scan's prefetching stream iterator: the planner's segments at
        ``coalesce_gap_bytes > 0``, the reference's per-block pipeline at 0
        (``read/scan_plan.py``). With ``autotune`` on the scan tuner is
        consulted once, before the fetcher is built, so the fetcher's chunk
        size and width are the rungs the planner plans with."""
        cfg = tuned_scan_config(self.dispatcher, self.dispatcher.config)
        return build_scan_iterator(
            self.dispatcher, memo, blocks, cfg, recovery=recovery,
            fetcher=ChunkedRangeFetcher.from_config(cfg),
            on_block=self._count_block,
            tuner_consulted=True,
        )

    def _finish_read(self, prefetcher) -> None:
        """Drain hook: fold the prefetcher's statistics into the metrics and,
        for a record read with the registry on, record the reduce-completion
        stats entry (``metrics/stats.py``; the raw ``read_partition`` API
        belongs to no shuffle dependency and records none)."""
        stats = prefetcher.stats
        self.metrics.wait_ns += stats["wait_ns"]
        self.metrics.prefetch_ns += stats["prefetch_ns"]
        self.prefetch_stats = dict(stats)
        if self.dep is None or not _metrics.enabled():
            return
        COLLECTOR.record_reduce(
            shuffle_id=self.dep.shuffle_id,
            partition=self.start_partition,
            bytes=self.metrics.remote_bytes_read,
            records=self.metrics.records_read,
            prefetch_seconds=stats["prefetch_ns"] / 1e9,
            wait_seconds=stats["wait_ns"] / 1e9,
            threads=stats["threads"],
        )

    def _wrapped_stream(self, prefetched, memo: ScanIndexMemo, budget):
        """Checksum validation and the codec over one prefetched block, with
        offsets and checksums from the scan's memo and the decode window's
        bytes reserved against the scan's ``budget``."""
        block = prefetched.block
        location = memo.resolve_map_location(block.shuffle_id, block.map_id)
        return self._validated_decoded(block, prefetched, location, memo, budget)

    def _decoded_streams(self, blocks=None) -> Iterator:
        """``(block, decoded stream)`` of every block of one scan
        (``blocks``: the record API's by default), in completion order. Each stream is closed once
        its consumer moves on, and the scan when the consumer stops, early
        or not."""
        if blocks is None:
            blocks = self.compute_shuffle_blocks()
        memo = ScanIndexMemo(self.helper)
        recovery = DegradedReader(self.dispatcher, self.device)
        prefetcher = None
        try:
            prefetcher = self._make_prefetcher(blocks, memo, recovery)
            for prefetched in prefetcher:
                stream = prefetched
                try:
                    stream = self._wrapped_stream(prefetched, memo, prefetcher.budget)
                    yield prefetched.block, stream
                finally:
                    stream.close()
                    prefetched.close()
            self._finish_read(prefetcher)
        finally:
            if prefetcher is not None:
                prefetcher.close()
            self._scan_reconstructions += recovery.reconstructions

    def read_batches(self, sink=None) -> Iterator[RecordBatch]:
        """RecordBatches of a columnar serializer (no aggregation or
        ordering applied). Their frames' parse is the ``record.deserialize``
        stage, timed into ``sink`` (by default a tally of this scan's, added
        to the codec's ``timings`` when the scan ends)."""
        tally = trace.Tally(self.codec) if sink is None else sink
        try:
            for _block, stream in self._decoded_streams():
                for batch in self.dep.serializer.new_batch_read_stream(stream, sink=tally):
                    self.metrics.records_read += batch.n
                    count_plane_rows("read", batch.n)
                    yield batch
        finally:
            if sink is None:
                tally.flush()

    def _chunk_iterator(self) -> Iterator[list]:
        """Record chunks (lists) of every block. A chunk is counted once its
        consumer asks for the next, so an early stop never over-counts."""
        for _block, stream in self._decoded_streams():
            pending = 0
            for chunk in self.dep.serializer.new_chunk_read_stream(stream):
                self.metrics.records_read += pending
                count_fallback_rows("read", pending)
                pending = len(chunk)
                yield chunk
            # the block's last chunk, before the scan's drain hook records
            # the reduce stats entry
            self.metrics.records_read += pending
            count_fallback_rows("read", pending)

    def read(self) -> Iterator[Tuple[Any, Any]]:
        """The partition range's records, aggregated and ordered as the
        dependency asks."""
        trace.count("read.tasks")
        dep = self.dep
        if dep.serializer.supports_batches:
            if dep.aggregator is None:
                return self._read_batched()
            if dep.aggregator.supports_columnar:
                return self._read_columnar_agg()
        # chunk-level iteration + C-level flattening
        records = itertools.chain.from_iterable(self._chunk_iterator())
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
        batches arrive key-sorted. The reducer's work is the
        ``record.combine`` stage, the frames' parse ``record.deserialize``,
        both added to the codec's timings as the drain ends."""
        tally = trace.Tally(self.codec)
        reducer = self.dep.aggregator.new_reducer(
            spill_bytes=self.dispatcher.config.aggregator_spill_bytes, sink=tally
        )
        try:
            for batch in self.read_batches(tally):
                reducer.add(batch)
            yield from reducer.results()
        finally:
            tally.flush()

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

    def _fed_batch_sorter(self, sink=None) -> BatchSorter:
        """The natural-byte-order BatchSorter fed every read batch; its
        stages and the frames' parse are timed into ``sink``."""
        sorter = BatchSorter(spill_bytes=self.dispatcher.config.sorter_spill_bytes, sink=sink)
        for batch in self.read_batches(sink):
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
            # the task's record stages add to the codec's timings at once
            tally = trace.Tally(self.codec)
            try:
                return list(self._fed_batch_sorter(tally).sorted_batches())
            finally:
                tally.flush()
        return fallback()
