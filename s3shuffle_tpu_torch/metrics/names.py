"""Every metric name the data plane emits, with its kind and label names
(the JAX package's ``metrics/names.py``, whole, so both packages name their
instruments alike and one dashboard reads either).

The port registers the names of every plane it has: the storage, read,
write, codec, record, coded, skew, cost, tuning, flight-recorder,
control-plane, fleet, multi-GPU (mesh), race-witness and schedule-explorer
instruments. The rate-gate names are declared though the measured-rate
gate is not ported, by rule. The value is ``(kind, labelnames)``: ``kind`` is
``counter``, ``gauge`` or ``histogram``; ``labelnames`` matches the
registration site's (``()`` for an unlabeled instrument).
``KNOWN_METRICS`` stays a pure literal.
"""

from __future__ import annotations

from typing import Dict, Tuple

#: metric name -> (kind, labelnames); a pure literal
KNOWN_METRICS: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    # --- storage plane: instrumented backend (storage/instrumented.py) ---
    "storage_op_seconds": ("histogram", ("scheme", "op")),
    "storage_errors_total": ("counter", ("scheme", "op")),
    "storage_read_bytes_total": ("counter", ("scheme",)),
    "storage_write_bytes_total": ("counter", ("scheme",)),
    # --- control plane: sharded tracker / batched client / snapshots
    # (metadata/service.py, metadata/async_client.py, metadata/snapshot.py) ---
    "meta_rpc_total": ("counter", ("method", "shard")),
    "meta_batch_flush_seconds": ("histogram", ()),
    "meta_snapshot_age_seconds": ("gauge", ()),
    "meta_lookup_source_total": ("counter", ("source",)),
    # --- storage plane: classified retries (storage/retrying.py) ---
    "storage_retries_total": ("counter", ("op", "scheme")),
    "storage_retry_backoff_seconds": ("histogram", ()),
    "storage_deadline_exceeded_total": ("counter", ("op", "scheme")),
    # --- storage plane: lifecycle sweeps (storage/dispatcher.py) ---
    "storage_sweep_deleted_total": ("counter", ("reason",)),
    # --- read plane: adaptive prefetch (read/prefetch.py) ---
    "read_prefetch_wait_seconds": ("histogram", ()),
    "read_prefetch_fill_seconds": ("histogram", ()),
    "read_prefetch_fill_class_seconds": ("histogram", ("size_class",)),
    "read_prefetch_fill_per_mib_seconds": ("histogram", ("size_class",)),
    "read_prefetch_threads": ("gauge", ()),
    "read_prefetch_thread_moves_total": ("counter", ("direction",)),
    # --- read plane: chunked concurrent ranged GETs (read/chunked_fetch.py) ---
    "read_chunk_fetch_seconds": ("histogram", ()),
    "read_chunk_inflight": ("gauge", ()),
    "read_chunked_prefills_total": ("counter", ()),
    # --- read plane: coalesced scan planner (read/scan_plan.py) ---
    "read_coalesced_segments_total": ("counter", ()),
    "read_gets_saved_total": ("counter", ()),
    "read_coalesce_waste_bytes_total": ("counter", ()),
    "read_index_prefetch_seconds": ("histogram", ()),
    # --- read plane: checksum validation (read/checksum_stream.py) ---
    "read_checksum_validate_seconds": ("histogram", ()),
    "read_checksum_failures_total": ("counter", ()),
    # --- record plane: columnar frames + vectorized partitioning
    # (serializer.py — the writers/reader feed them through its
    # count_*/observe_* hooks) ---
    "record_frames_total": ("counter", ("format", "plane")),
    "record_rows_total": ("counter", ("plane",)),
    "record_fallback_rows_total": ("counter", ("site",)),
    "record_partition_seconds": ("histogram", ()),
    # --- write plane: spill/commit/serialize (write/*.py) ---
    "write_spill_seconds": ("histogram", ()),
    "write_spill_bytes_total": ("counter", ()),
    "write_commit_seconds": ("histogram", ()),
    "write_serialize_seconds": ("histogram", ()),
    "write_upload_seconds": ("histogram", ()),
    "write_upload_bytes_total": ("counter", ()),
    # --- write plane: pipelined commit uploads (write/pipelined_upload.py) ---
    "write_upload_queue_wait_seconds": ("histogram", ()),
    "write_upload_queue_bytes": ("gauge", ()),
    "write_upload_chunk_seconds": ("histogram", ()),
    # --- write plane: composite commits + compactor
    # (write/composite_commit.py, write/compactor.py) ---
    "write_composite_members_total": ("counter", ()),
    "write_composite_groups_total": ("counter", ()),
    "write_composite_flush_seconds": ("histogram", ()),
    "write_puts_saved_total": ("counter", ()),
    "write_compaction_seconds": ("histogram", ()),
    "write_compacted_objects_total": ("counter", ()),
    # --- codec plane (codec/native.py) ---
    "codec_compress_seconds": ("histogram", ("codec",)),
    "codec_compress_bytes_total": ("counter", ("codec",)),
    # --- tuning plane: online autotuner
    # (tuning/controller.py, tuning/tuners.py) ---
    "tune_decisions_total": ("counter", ("knob", "direction")),
    "tune_knob_value": ("gauge", ("knob",)),
    "tune_controller_seconds": ("histogram", ()),
    # --- elastic fleet: membership / drain / task requeues / recovery
    # (metadata/service.py, recovery.py) ---
    "worker_membership_events_total": ("counter", ("event",)),
    "task_requeues_total": ("counter", ("reason",)),
    "worker_drain_seconds": ("histogram", ()),
    "recovery_decisions_total": ("counter", ("choice",)),
    # --- coding plane: k-of-n parity + degraded reads
    # (coding/parity.py, coding/degraded.py) ---
    "shuffle_parity_encode_seconds": ("histogram", ()),
    "shuffle_parity_bytes_written_total": ("counter", ()),
    "shuffle_parity_speculative_reads_total": ("counter", ()),
    "shuffle_parity_reconstructions_total": ("counter", ("reason",)),
    # --- skew mitigation plane: map-side combine sidecars, hot-partition
    # splitting, coded read fan-out (skew.py) ---
    "shuffle_map_combine_rows_total": ("counter", ()),
    "shuffle_partition_splits_total": ("counter", ()),
    "shuffle_hot_fanout_reads_total": ("counter", ()),
    # --- codec plane: device-resident batch pipeline
    # (codec/framing.py, codec/tpu.py) ---
    "codec_encode_batch_seconds": ("histogram", ()),
    "codec_encode_bytes_total": ("counter", ()),
    "codec_encode_inflight": ("gauge", ()),
    "codec_fused_crc_total": ("counter", ()),
    "codec_frames_total": ("counter", ()),
    "codec_assembly_seconds": ("histogram", ()),
    # --- codec plane: read-side batched decode pipeline (codec/framing.py) ---
    "codec_decode_batch_seconds": ("histogram", ()),
    "codec_decode_bytes_total": ("counter", ()),
    "codec_decode_inflight": ("gauge", ()),
    "codec_fused_crc_validated_total": ("counter", ()),
    # --- codec plane: measured-rate gate + Pallas kernels (ops/rates.py) ---
    "codec_path_selected_total": ("counter", ("path", "reason")),
    "codec_kernel_compile_seconds": ("histogram", ("kernel",)),
    # --- trace plane: span shards, flight recorder, fleet telemetry, cost
    # (utils/trace.py, metadata/service.py, costs.py) ---
    "trace_shard_bytes_total": ("counter", ()),
    "trace_shard_drops_total": ("counter", ("reason",)),
    "flight_dumps_total": ("counter", ("reason",)),
    "fleet_snapshot_age_seconds": ("gauge", ("worker",)),
    "cost_dollars_total": ("counter", ("op_class",)),
    # --- concurrency verification plane: race witness + schedule explorer
    # (utils/racewitness.py, utils/sched.py) ---
    "race_witness_checks_total": ("counter", ()),
    "race_witness_reports_total": ("counter", ()),
    "sched_schedules_explored_total": ("counter", ()),
    # --- mesh plane: multi-chip dispatcher + ICI routing
    # (parallel/dispatch.py, parallel/ici_shuffle.py) ---
    "mesh_batches_dispatched_total": ("counter", ("device",)),
    "mesh_dispatch_wait_seconds": ("histogram", ()),
    "mesh_route_rows_total": ("counter", ()),
    "mesh_device_outstanding": ("gauge", ("device",)),
}
