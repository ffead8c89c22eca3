"""Device operations of the port: CRC (K1), TLZ encode plane decisions (K2)
and the fused TLZ decode + CRC (K3), each a hand-written CUDA kernel beside
its plain PyTorch version, plus the PyTorch stages around them and the
public batch checksums."""

from s3shuffle_tpu_torch.ops.checksum import (
    POLY_CRC32,
    POLY_CRC32C,
    adler32_batch,
    crc32_batch,
    crc_combine,
)

__all__ = [
    "POLY_CRC32",
    "POLY_CRC32C",
    "crc32_batch",
    "adler32_batch",
    "crc_combine",
]
