"""Configuration for the port's data plane.

The fields the ported slices read, with the JAX package's names, defaults
and validation (``s3shuffle_tpu/config.py``), with one departure: ``codec``
defaults to ``"tpu"`` (the TLZ codec on the GPU), where the JAX package's
default is ``"auto"`` (SLZ on the host, or zlib). The port's write path
exists to run on the card; ``"auto"`` and every host codec name are there
to be asked for. ``codec_block_size=None`` resolves to each codec's own
block (256 KiB for TLZ, 64 KiB for the host codecs), as in the JAX package.
Reducers always enumerate blocks through the map-output tracker (metadata
mode).
"""

from __future__ import annotations

import dataclasses

MiB = 1024 * 1024
_ALGORITHMS = ("ADLER32", "CRC32", "CRC32C")


@dataclasses.dataclass
class ShuffleConfig:
    # --- storage layout ---
    root_dir: str = "file:///tmp/s3shuffle_tpu"
    app_id: str = "app"
    folder_prefixes: int = 10
    # --- write plane ---
    # buffered-writer size of the data object when the upload queue is off
    buffer_size: int = 8 * MiB
    # --- read plane ---
    # map-side spill budget (buffered partition bytes, codec queues included)
    max_buffer_size_task: int = 128 * MiB
    # bytes in flight between commit serialization and the background
    # uploader thread; 0 writes the data object serially
    upload_queue_bytes: int = 32 * MiB
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
    # --- coded shuffle plane ---
    # parity sidecar objects (m) per data object; 0 turns the plane off and
    # keeps the uncoded objects and store requests. A whole lost object is
    # recoverable when parity_segments >= parity_stripe_k.
    parity_segments: int = 0
    # data chunks (k) per stripe group: the parity overhead is m/k
    parity_stripe_k: int = 1
    # stripe chunk size, also the unit of degraded-read GETs
    parity_chunk_bytes: int = 1 * MiB

    def __post_init__(self) -> None:
        if self.folder_prefixes < 1:
            raise ValueError("folder_prefixes must be >= 1")
        if self.upload_queue_bytes < 0:
            raise ValueError("upload_queue_bytes must be >= 0")
        if self.columnar not in (0, 1):
            raise ValueError("columnar must be 0 or 1")
        if self.columnar_batch_rows < 1:
            raise ValueError("columnar_batch_rows must be >= 1")
        if self.codec_batch_blocks < 1:
            raise ValueError("codec_batch_blocks must be >= 1")
        if self.parity_segments < 0 or self.parity_stripe_k < 1:
            raise ValueError("parity_segments must be >= 0, parity_stripe_k >= 1")
        if self.parity_segments + self.parity_stripe_k > 255:
            # GF(256) erasure coding addresses at most 255 segments in all
            raise ValueError("parity_segments + parity_stripe_k must be <= 255")
        if self.parity_chunk_bytes < 1:
            raise ValueError("parity_chunk_bytes must be >= 1")
        algo = self.checksum_algorithm.upper()
        if algo not in _ALGORITHMS:
            raise ValueError(f"Unsupported checksum algorithm: {self.checksum_algorithm}")
        self.checksum_algorithm = algo
        if not self.root_dir.endswith("/"):
            self.root_dir += "/"
