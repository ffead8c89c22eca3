"""s3shuffle_tpu_torch — the shuffle data plane on PyTorch and CUDA.

A second package beside ``s3shuffle_tpu`` (the JAX reference): the same
object layout and TLZ v2 frame format (codec id ``tpu-lz``), so either
package reads the other's shuffle files byte for byte. It imports torch and
numpy, never jax and nothing of ``s3shuffle_tpu``.

This slice covers the codec data plane from map commit to validated reduce
read:

- map side: :class:`~s3shuffle_tpu_torch.write.map_output_writer.MapOutputWriter`
  (one data object + index + checksum sidecar per map, counterpart of the
  reference's ``S3ShuffleMapOutputWriter``);
- reduce side: :class:`~s3shuffle_tpu_torch.read.reader.ShuffleReader`
  (ranged block reads, checksum validation, batched device decode);
- the codec: :class:`~s3shuffle_tpu_torch.codec.cuda.CudaCodec` on three
  hand-written Hopper kernels (``csrc/``): the CRC fold, the TLZ encode
  plane decisions and the fused TLZ decode + CRC;
- the coded plane (``parity_segments > 0``): parity sidecars written beside
  each data object (``coding/parity.py``) and lost data objects rebuilt on
  read (``coding/degraded.py``), on a fourth kernel, the GF(2^8) parity
  encode (``coding/gf_cuda.py``).

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (the plain PyTorch versions of the kernels); with no CUDA
device and no explicit ``device="cpu"`` they raise.
"""

from s3shuffle_tpu_torch.block_ids import (
    NOOP_REDUCE_ID,
    BlockId,
    ShuffleBlockId,
    ShuffleChecksumBlockId,
    ShuffleDataBlockId,
    ShuffleIndexBlockId,
    ShuffleParityBlockId,
)
from s3shuffle_tpu_torch.config import ShuffleConfig
from s3shuffle_tpu_torch.device import resolve_device

__version__ = "0.1.0"

__all__ = [
    "NOOP_REDUCE_ID",
    "BlockId",
    "ShuffleBlockId",
    "ShuffleChecksumBlockId",
    "ShuffleConfig",
    "ShuffleDataBlockId",
    "ShuffleIndexBlockId",
    "ShuffleParityBlockId",
    "resolve_device",
]
