"""Configuration for the port's data plane.

The fields the ported slices read, with the JAX package's names, defaults
and validation (``s3shuffle_tpu/config.py``). A config written with the
reference's ``spark.shuffle.s3.*`` keys (README.md:31-85) is read by
:meth:`ShuffleConfig.from_dict`, ``S3SHUFFLE_<FIELD>`` environment
variables by :meth:`ShuffleConfig.from_env`, and :meth:`ShuffleConfig.log_values`
logs every value, as the reference's dispatcher does at start-up.

The port's own departures from the JAX fields:

- ``codec`` defaults to ``"tpu"`` (the TLZ codec on the GPU), where the JAX
  package's default is ``"auto"`` (SLZ on the host, or zlib). The port's
  write path exists to run on the card; ``"auto"`` and every host codec
  name are there to be asked for.
- Entry points take ``device=`` beside the config (``device.py``): the CUDA
  device unless ``"cpu"`` is asked for. No config field chooses it.
- The JAX package's host reroute knobs (``tpu_host_fallback``,
  ``codec_repin_probe_s``) are absent: the port has no reroute, and
  :meth:`ShuffleConfig.from_dict` refuses them as unknown keys.
  ``mesh_devices`` arms the multi-GPU plane (``parallel/dispatch.py``).
  The fleet's knobs (``worker_lease_s``, ``drain_on_sigterm``) are read by
  ``worker.py`` and ``cluster.py``; a worker and the cluster driver set the
  flight recorder up from ``flight_ring_events`` and ``flight_dir``. The composite commit plane's and the skew plane's
  knobs are here with the JAX defaults (off), as are the autotuner's
  (``autotune`` off, ``autotune_interval_s`` 0.25, no
  ``autotune_profile_path``), ``speculative_read_quantile`` (0.99) and
  ``cost_rate_card``. Speculation races a straggler only while the metrics
  registry is on (``S3SHUFFLE_METRICS``), in both packages: its threshold
  comes from the registry's fill histograms.

``codec_block_size=None`` resolves to each codec's own block (256 KiB for
TLZ, 64 KiB for the host codecs), as in the JAX package. The read-plane
knobs (prefetch concurrency, chunked fetch, the scan planner, the metadata
caches) and the codec windows keep the JAX defaults, so a shuffle at its
defaults encodes on the encode thread and decodes on the decode pool, as
the JAX package's does.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Mapping

logger = logging.getLogger("s3shuffle_tpu_torch.config")

MiB = 1024 * 1024
_ALGORITHMS = ("ADLER32", "CRC32", "CRC32C")

#: The reference's flag names (README.md:31-85) → the port's field names,
#: so configs written for the reference translate one for one. Every key of
#: the JAX package's table is here: each names a field the port has.
_REFERENCE_KEYS = {
    "spark.shuffle.s3.rootDir": "root_dir",
    "spark.shuffle.s3.bufferSize": "buffer_size",
    "spark.shuffle.s3.maxBufferSizeTask": "max_buffer_size_task",
    "spark.shuffle.s3.maxConcurrencyTask": "max_concurrency_task",
    "spark.shuffle.s3.cachePartitionLengths": "cache_partition_lengths",
    "spark.shuffle.s3.cacheChecksums": "cache_checksums",
    "spark.shuffle.s3.cleanup": "cleanup",
    "spark.shuffle.s3.folderPrefixes": "folder_prefixes",
    "spark.shuffle.s3.alwaysCreateIndex": "always_create_index",
    "spark.shuffle.s3.useBlockManager": "use_block_manager",
    "spark.shuffle.s3.forceBatchFetch": "force_batch_fetch",
    "spark.shuffle.s3.useSparkShuffleFetch": "use_fallback_fetch",
    "spark.shuffle.checksum.enabled": "checksum_enabled",
    "spark.shuffle.checksum.algorithm": "checksum_algorithm",
    # the knob's former name in the JAX package, still accepted there
    "tpu_batch_blocks": "codec_batch_blocks",
}


@dataclasses.dataclass
class ShuffleConfig:
    # --- storage layout ---
    root_dir: str = "file:///tmp/s3shuffle_tpu"
    app_id: str = "app"
    folder_prefixes: int = 10
    # --- write plane ---
    # buffered-writer size of the data object when the upload queue is off
    buffer_size: int = 8 * MiB
    # commit an index (the commit point) for an empty map too, so listing
    # mode sees every map and a missing index stays an error there
    always_create_index: bool = False
    # --- read plane ---
    # map-side spill budget (buffered partition bytes, codec queues
    # included) and the reduce side's prefetch budget (bytes in flight)
    max_buffer_size_task: int = 128 * MiB
    # ceiling of the prefetch thread-count hill climb
    max_concurrency_task: int = 10
    # --- transfer plane ---
    # prefills larger than this split into concurrent positioned sub-reads
    fetch_chunk_size: int = 8 * MiB
    # process-wide ranged-GET pool width; <= 1 disables chunked fetch
    fetch_parallelism: int = 4
    # bytes in flight between commit serialization and the background
    # uploader thread; 0 writes the data object serially
    upload_queue_bytes: int = 32 * MiB
    # --- reduce-side scan planner ---
    # merge block ranges on one data object across gaps of at most this many
    # bytes (fetched and discarded); 0 disables the planner and keeps the
    # per-block request pattern exactly
    coalesce_gap_bytes: int = 1 * MiB
    # ceiling of one merged segment; also clamped to max_buffer_size_task so
    # a merged segment fits the prefetch budget in one prefill
    coalesce_max_bytes: int = 64 * MiB
    # --- composite commit plane (write/composite_commit.py) ---
    # map outputs composed into ONE composite data object + ONE fat index
    # before the group seals; 0 or 1 turns the plane off and keeps the
    # one-object-per-map layout op for op
    composite_commit_maps: int = 0
    # seal the open composite group when its data bytes reach this
    composite_flush_bytes: int = 64 * MiB
    # seal groups older than this on the next aggregator touch (a commit or
    # a barrier flush); 0 disables age-based sealing
    composite_flush_ms: float = 250.0
    # a composite-mode map commit spools its payload in memory up to this
    # many bytes, then overflows to a local temp file
    composite_spool_bytes: int = 8 * MiB
    # the compactor rewrites committed singleton data objects smaller than
    # this into composites (write/compactor.py); 0 disables compaction
    compact_below_bytes: int = 0
    # the generation sweep deletes tombstoned (superseded) objects once
    # their generation stamp is older than this many seconds
    tombstone_ttl_s: float = 300.0
    # --- metadata caches (process-wide, per helper) ---
    cache_partition_lengths: bool = True
    cache_checksums: bool = True
    # --- record plane ---
    # 1 = columnar serializers emit column frames (colframe.py); 0 = the
    # legacy frame wire. Readers auto-detect per frame.
    columnar: int = 1
    # rows per columnar chunk on the map write path (inert at columnar=0)
    columnar_batch_rows: int = 65536
    # in-memory budget of key-ordered reduce output before the sorter spills
    sorter_spill_bytes: int = 256 * MiB
    # in-memory budget of reduce-side combine before the aggregator spills
    aggregator_spill_bytes: int = 256 * MiB
    # batch-fetch a map's contiguous partition range even for one partition
    # or a non-relocatable serializer
    force_batch_fetch: bool = False
    # --- block enumeration (S3ShuffleReader.scala:160-197) ---
    # reducers enumerate blocks through the map-output tracker (metadata
    # mode); False lists the committed ``*.index`` objects in the store
    use_block_manager: bool = True
    # attempt-unique map ids: listing mode takes map_id // stride as the
    # logical map index, filters the map range on it and keeps the latest
    # attempt of each (0: map ids are the logical indices)
    map_id_attempt_stride: int = 0
    # the layout of Spark's decommission fallback storage:
    # {root}{appId}/{shuffleId}/{hash(name)}/{name} (S3ShuffleDispatcher.scala:39-47)
    use_fallback_fetch: bool = False
    # --- lifecycle ---
    # unregister_shuffle / stop delete the shuffle's objects / the app root
    cleanup: bool = True
    # the single-spill writer may rename a local spill file into place;
    # None → what the backend supports
    supports_rename: bool | None = None
    # --- checksums (Spark-native flags) ---
    checksum_enabled: bool = True
    checksum_algorithm: str = "ADLER32"  # ADLER32 | CRC32 | CRC32C
    # --- codec ---
    # none | zlib | zstd | native | lz4 | tpu | auto (the JAX default is auto)
    codec: str = "tpu"
    # None → each codec's own default (TLZ 256 KiB, host codecs 64 KiB)
    codec_block_size: int | None = None
    codec_level: int = 1
    # blocks per device round trip of the TLZ codec
    codec_batch_blocks: int = 64
    # encode batches in flight between the serializer and the sink: batches
    # are encoded on the process-wide encode thread while the producer fills
    # the next; <= 1 encodes every batch on the producer thread
    encode_inflight_batches: int = 2
    # frames the reader decodes per batch (one device launch per run)
    decode_batch_frames: int = 32
    # decode batches in flight between the source and the consumer, decoded
    # on the shared decode pool; beyond the first, their bytes are reserved
    # against max_buffer_size_task (a full budget shrinks the window). <= 1
    # decodes every batch on the consumer thread
    decode_inflight_batches: int = 2
    # --- multi-GPU plane (parallel/) ---
    # lanes of the mesh dispatcher that places the batch encode/decode and
    # parity launches, and width of mesh-routed shuffles. 0 or 1 keeps the
    # single-device op pattern; widths beyond the local devices clamp
    mesh_devices: int = 0
    # --- coded shuffle plane ---
    # parity sidecar objects (m) per data object; 0 turns the plane off and
    # keeps the uncoded objects and store requests. A whole lost object is
    # recoverable when parity_segments >= parity_stripe_k.
    parity_segments: int = 0
    # data chunks (k) per stripe group: the parity overhead is m/k
    parity_stripe_k: int = 1
    # stripe chunk size, also the unit of degraded-read GETs
    parity_chunk_bytes: int = 1 * MiB
    # straggler speculation: a prefill that outlives this quantile of its
    # size class's per-MiB fill histogram races a parity reconstruction.
    # The histograms fill only while the metrics registry is on, so with it
    # off nothing races. 0 disables speculation (loss reconstruction stays)
    speculative_read_quantile: float = 0.99
    # --- skew mitigation plane (skew.py) ---
    # map-side combine sidecar: once a partition's routed bytes cross this,
    # its chunks are pre-reduced in the map task (aggregating dependencies
    # with a columnar aggregator and reduce-side combine); 0 = off
    combine_threshold_bytes: int = 0
    # hot-partition splitting: a partition whose committed size crosses
    # this records the threshold as its stripe, and the scan planner fans
    # it out as sub-range GETs; 0 = off
    split_threshold_bytes: int = 0
    # coded read fan-out: a read of a data object that already has this
    # many GETs in flight in the process reconstructs from parity instead
    # (needs parity_segments covering the stripe); 0 = off
    hot_read_fanout: int = 0
    # storage rate card of costs.cost_digest: "class=rate,..." in dollars
    # per op (get, put, list, delete) and per GiB moved (gb_read,
    # gb_written); "" = the built-in S3-Standard-like card
    cost_rate_card: str = ""
    # --- online autotuner (tuning/) ---
    # the closed-loop knob controllers: a read-side ScanTuner and a
    # write-side CommitTuner retune the transfer knobs within per-knob
    # clamps from the live metrics registry. Off reproduces the static
    # configuration's store request pattern op for op; a knob whose static
    # value switches its plane off stays off either way
    autotune: bool = False
    # controller cooldown: each knob moves at most once per this interval
    # (cost samples keep accumulating between moves)
    autotune_interval_s: float = 0.25
    # warm-start profile: with autotune on, the tuners' rung tables load
    # from this JSON file when the dispatcher is built and are written back
    # at manager stop; "" keeps no profile
    autotune_profile_path: str = ""
    # --- flight recorder (utils/trace.py) ---
    # records kept in the always-on bounded in-memory ring (milestones;
    # completed spans too while tracing is on); 0 turns recording off
    flight_ring_events: int = 512
    # directory of the postmortem dumps (atomic; on drain, task failure,
    # SIGTERM and atexit after an error); "" records but never dumps
    flight_dir: str = ""
    # --- resilient storage plane (the S3A ``fs.s3a.retry.*`` analog) ---
    # re-drives per store op after the first attempt; 0 stacks no retry
    # layer at all (every store op fails fast)
    storage_retries: int = 3
    # exponential-backoff base; each sleep is full jitter,
    # uniform(0, min(cap, base * 2**attempt))
    storage_retry_base_ms: float = 50.0
    # wall-clock budget per op, backoff sleeps included; 0 = unbounded
    storage_op_deadline_s: float = 30.0
    # --- control plane (metadata/service.py, shard.py, async_client.py,
    # snapshot.py) ---
    # tracker shard count of MetadataServer.from_config: the shuffle/map
    # keyspace is hashed across this many independent lock domains; 1 = a
    # flat tracker
    metadata_shards: int = 4
    # extra listener sockets of MetadataServer.from_config (each its own
    # accept loop) that batched clients spread their connections across;
    # 0 = the primary socket only
    metadata_shard_endpoints: int = 0
    # registrations AsyncTrackerClient.from_config buffers before it
    # flushes them as one RPC (it also flushes before every read and on
    # close)
    metadata_batch_max: int = 64
    # publish_snapshot writes a sealed shuffle's epoch-stamped map-output
    # snapshot through the store, so reduce scans look up without a tracker
    # RPC; False = it publishes nothing and every lookup is a live RPC
    metadata_snapshots: bool = True
    # --- worker fleet (worker.py, cluster.py) ---
    # a worker that sent no heartbeat or poll for this long is expired: its
    # membership drops, its running tasks are requeued in every stage and
    # the commit fence refuses its attempts. A WorkerAgent beats every ~5 s
    worker_lease_s: float = 30.0
    # SIGTERM asks a worker started by ``python -m s3shuffle_tpu_torch.worker``
    # to drain at its next task boundary (seal open composite groups, send
    # deferred reports and stats, deregister); False leaves SIGTERM fatal
    drain_on_sigterm: bool = True
    # options of the fsspec driver of a non-file, non-memory root
    # (credentials, endpoint_url); never logged or repr'd
    storage_options: dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self) -> None:
        if self.folder_prefixes < 1:
            raise ValueError("folder_prefixes must be >= 1")
        if self.fetch_chunk_size < 1:
            raise ValueError("fetch_chunk_size must be >= 1")
        if self.fetch_parallelism < 0 or self.upload_queue_bytes < 0:
            raise ValueError("fetch_parallelism / upload_queue_bytes must be >= 0")
        if self.coalesce_gap_bytes < 0:
            raise ValueError("coalesce_gap_bytes must be >= 0")
        if self.coalesce_max_bytes < 1:
            raise ValueError("coalesce_max_bytes must be >= 1")
        if self.composite_commit_maps < 0 or self.compact_below_bytes < 0:
            raise ValueError(
                "composite_commit_maps / compact_below_bytes must be >= 0"
            )
        if self.composite_flush_bytes < 1 or self.composite_spool_bytes < 1:
            raise ValueError(
                "composite_flush_bytes / composite_spool_bytes must be >= 1"
            )
        if self.composite_flush_ms < 0 or self.tombstone_ttl_s < 0:
            raise ValueError("composite_flush_ms / tombstone_ttl_s must be >= 0")
        if self.columnar not in (0, 1):
            raise ValueError("columnar must be 0 or 1")
        if self.columnar_batch_rows < 1:
            raise ValueError("columnar_batch_rows must be >= 1")
        if self.codec_batch_blocks < 1:
            raise ValueError("codec_batch_blocks must be >= 1")
        if self.encode_inflight_batches < 0:
            raise ValueError("encode_inflight_batches must be >= 0")
        if self.decode_batch_frames < 1:
            raise ValueError("decode_batch_frames must be >= 1")
        if self.decode_inflight_batches < 0:
            raise ValueError("decode_inflight_batches must be >= 0")
        if self.mesh_devices < 0:
            raise ValueError("mesh_devices must be >= 0")
        if self.metadata_shards < 1 or self.metadata_batch_max < 1:
            raise ValueError("metadata_shards / metadata_batch_max must be >= 1")
        if self.worker_lease_s <= 0:
            raise ValueError("worker_lease_s must be > 0")
        if self.metadata_shard_endpoints < 0:
            raise ValueError("metadata_shard_endpoints must be >= 0")
        if self.flight_ring_events < 0:
            raise ValueError("flight_ring_events must be >= 0")
        if self.autotune_interval_s < 0:
            raise ValueError("autotune_interval_s must be >= 0")
        if (
            self.storage_retries < 0
            or self.storage_retry_base_ms < 0
            or self.storage_op_deadline_s < 0
        ):
            raise ValueError("storage retry knobs must be >= 0")
        if self.parity_segments < 0 or self.parity_stripe_k < 1:
            raise ValueError("parity_segments must be >= 0, parity_stripe_k >= 1")
        if self.parity_segments + self.parity_stripe_k > 255:
            # GF(256) erasure coding addresses at most 255 segments in all
            raise ValueError("parity_segments + parity_stripe_k must be <= 255")
        if self.parity_chunk_bytes < 1:
            raise ValueError("parity_chunk_bytes must be >= 1")
        if not (0.0 <= self.speculative_read_quantile < 1.0):
            raise ValueError("speculative_read_quantile must be in [0, 1)")
        if (
            self.combine_threshold_bytes < 0
            or self.split_threshold_bytes < 0
            or self.hot_read_fanout < 0
        ):
            raise ValueError(
                "combine_threshold_bytes / split_threshold_bytes / "
                "hot_read_fanout must be >= 0"
            )
        # a mistyped rate card fails here, not at the first cost digest
        from s3shuffle_tpu_torch.costs import parse_rate_card

        parse_rate_card(self.cost_rate_card)
        algo = self.checksum_algorithm.upper()
        if algo not in _ALGORITHMS:
            raise ValueError(f"Unsupported checksum algorithm: {self.checksum_algorithm}")
        self.checksum_algorithm = algo
        if not self.root_dir.endswith("/"):
            self.root_dir += "/"

    @classmethod
    def from_dict(cls, d: Mapping[str, Any], **overrides: Any) -> "ShuffleConfig":
        """Build from a dict of the port's field names and the reference's
        ``spark.shuffle.s3.*`` keys; an unknown key raises KeyError."""
        kwargs: dict[str, Any] = {}
        fields = {f.name: f for f in dataclasses.fields(cls)}
        for key, value in d.items():
            name = _REFERENCE_KEYS.get(key, key)
            if name not in fields:
                raise KeyError(f"Unknown shuffle config key: {key}")
            kwargs[name] = _coerce(value, fields[name].type)
        kwargs.update(overrides)
        return cls(**kwargs)

    @classmethod
    def from_env(cls, env: Mapping[str, str] | None = None, **overrides: Any) -> "ShuffleConfig":
        """Build from ``S3SHUFFLE_<FIELD>`` environment variables; a renamed
        knob's old spelling (``S3SHUFFLE_TPU_BATCH_BLOCKS``) still works, and
        the new name wins when both are set."""
        env = os.environ if env is None else env
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kwargs: dict[str, Any] = {}
        for old, new in _REFERENCE_KEYS.items():
            if "." in old:  # spark.* keys are not environment-shaped
                continue
            key = "S3SHUFFLE_" + old.upper()
            if key in env:
                kwargs[new] = _coerce(env[key], fields[new].type)
        for f in fields.values():
            key = "S3SHUFFLE_" + f.name.upper()
            if key in env:
                kwargs[f.name] = _coerce(env[key], f.type)
        kwargs.update(overrides)
        return cls(**kwargs)

    def log_values(self) -> None:
        """Log every value, as the reference's dispatcher does at start-up
        (S3ShuffleDispatcher.scala:81-102); ``storage_options`` by its keys
        only (its values may hold credentials)."""
        for f in dataclasses.fields(self):
            if f.name == "storage_options":
                logger.info("config: storage_options keys=%r", sorted(self.storage_options))
                continue
            logger.info("config: %s=%r", f.name, getattr(self, f.name))


def _coerce(value: Any, typ: Any) -> Any:
    """A string value as the field's type: booleans from 1/true/yes/on,
    sizes with a k/m/g suffix, dicts from JSON; ``None`` for an optional
    field from "", none or null. Other values pass as they are."""
    if not isinstance(value, str):
        return value
    typ = str(typ)
    if "None" in typ and value.strip().lower() in ("", "none", "null"):
        return None
    if "bool" in typ:
        return value.strip().lower() in ("1", "true", "yes", "on")
    if "float" in typ:
        return float(value)
    if "int" in typ:
        from s3shuffle_tpu_torch.utils import parse_size

        return parse_size(value)
    if "dict" in typ:
        import json

        parsed = json.loads(value)
        if not isinstance(parsed, dict):
            raise ValueError(f"expected a JSON object, got {type(parsed).__name__}")
        return parsed
    return value
