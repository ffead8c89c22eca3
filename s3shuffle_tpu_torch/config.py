"""Configuration for the port's data plane.

The fields the ported slices read, with the JAX package's names, defaults
and validation (``s3shuffle_tpu/config.py``); the record layer's knobs
arrive with the slice that ports it. ``codec_block_size`` defaults to the
TLZ codec's 256 KiB block (the JAX package resolves its ``None`` default to
the same value for ``codec="tpu"``).
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
    # --- checksums (Spark-native flags) ---
    checksum_enabled: bool = True
    checksum_algorithm: str = "ADLER32"  # ADLER32 | CRC32 | CRC32C
    # --- codec ---
    codec_block_size: int = 256 * 1024
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
