"""s3shuffle_tpu_torch — the shuffle data plane on PyTorch and CUDA.

A second package beside ``s3shuffle_tpu`` (the JAX reference): the same
object layout and frame formats (TLZ v2, codec id ``tpu-lz``, by default;
the host codecs too), so either package reads the other's shuffle files
byte for byte. It imports torch and numpy, never jax and nothing of
``s3shuffle_tpu``.

The port covers:

- the entry points: :class:`~s3shuffle_tpu_torch.shuffle.ShuffleContext`
  (``run_shuffle``, ``sort_by_key``, ``group_by_key``, ``fold_by_key``,
  ``combine_by_key``) over a
  :class:`~s3shuffle_tpu_torch.manager.ShuffleManager` (handle choice, map
  writers, record readers, cleanup);
- the record layer: serializers (``serializer.py``, ``colframe.py``),
  columnar batches and the batch sorter (``batch.py``), partitioners and
  the dependency (``dependency.py``), aggregation (``aggregator.py``), the
  external sorter (``sorter.py``), the map writers
  (``write/spill_writer.py``, ``write/serialized_writer.py``,
  ``write/single_spill.py``), the DataIO components (``dataio.py``) and the
  in-process map-output tracker (``metadata/map_output.py``);
- the typed record paths: order-preserving typed keys and narrow value
  wires, hash aggregation and range sorts over them (``structured.py``)
  and the columnar aggregator (``colagg.py``);
- map side: :class:`~s3shuffle_tpu_torch.write.map_output_writer.MapOutputWriter`
  (one data object + index + checksum sidecar per map, counterpart of the
  reference's ``S3ShuffleMapOutputWriter``);
- reduce side: :class:`~s3shuffle_tpu_torch.read.reader.ShuffleReader`
  (ranged block reads, checksum validation, batched device decode);
- the codec: :class:`~s3shuffle_tpu_torch.codec.cuda.CudaCodec` (the
  default) on three hand-written Hopper kernels (``csrc/``): the CRC fold,
  the TLZ encode plane decisions and the fused TLZ decode + CRC; the host
  codecs zlib, zstd, SLZ and LZ4 (``codec/cpu.py``, ``codec/native.py``)
  behind the registry ``codec.get_codec``;
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
    ShuffleBlockBatchId,
    ShuffleBlockId,
    ShuffleChecksumBlockId,
    ShuffleDataBlockId,
    ShuffleIndexBlockId,
    ShuffleParityBlockId,
)
from s3shuffle_tpu_torch.config import ShuffleConfig
from s3shuffle_tpu_torch.device import resolve_device
from s3shuffle_tpu_torch.version import BUILD_INFO, __version__

#: the record layer's entry points import the codec stack: loaded on first use
_LAZY = {
    "ShuffleContext": "s3shuffle_tpu_torch.shuffle",
    "ShuffleManager": "s3shuffle_tpu_torch.manager",
}


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(module), name)

__all__ = [
    "BUILD_INFO",
    "__version__",
    "NOOP_REDUCE_ID",
    "BlockId",
    "ShuffleBlockBatchId",
    "ShuffleBlockId",
    "ShuffleChecksumBlockId",
    "ShuffleConfig",
    "ShuffleContext",
    "ShuffleDataBlockId",
    "ShuffleIndexBlockId",
    "ShuffleManager",
    "ShuffleParityBlockId",
    "resolve_device",
]
