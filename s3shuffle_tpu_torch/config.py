"""Configuration for the port's data plane.

The fields this slice reads, with the JAX package's names and defaults
(``s3shuffle_tpu/config.py``); the record layer's knobs arrive with the
slice that ports it. ``codec_block_size`` defaults to the TLZ codec's
256 KiB block (the JAX package resolves its ``None`` default to the same
value for ``codec="tpu"``).
"""

from __future__ import annotations

import dataclasses

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

    def __post_init__(self) -> None:
        if self.folder_prefixes < 1:
            raise ValueError("folder_prefixes must be >= 1")
        if self.codec_batch_blocks < 1:
            raise ValueError("codec_batch_blocks must be >= 1")
        algo = self.checksum_algorithm.upper()
        if algo not in _ALGORITHMS:
            raise ValueError(f"Unsupported checksum algorithm: {self.checksum_algorithm}")
        self.checksum_algorithm = algo
        if not self.root_dir.endswith("/"):
            self.root_dir += "/"
