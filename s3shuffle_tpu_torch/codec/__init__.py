"""Block codecs of the port behind the shared concatenatable framing, and
the registry that resolves a codec by its config name (the JAX package's
``codec/__init__.py``):

- ``none`` / ``raw`` / ``off``: no codec, unframed raw bytes;
- ``zlib``, ``zstd``: the standard compressors (:mod:`.cpu`);
- ``native`` (SLZ) and ``lz4``: the port's C++ library (:mod:`.native`);
- ``auto``: ``native`` when its library builds, else ``zlib``, as in the
  JAX package;
- ``tpu``: the TLZ codec on the GPU
  (:class:`~s3shuffle_tpu_torch.codec.cuda.CudaCodec`, frame id 4) on
  ``device``. Nothing here turns it into host frames: there is no host
  fallback.
"""

from __future__ import annotations

from s3shuffle_tpu_torch.codec.framing import (
    CODEC_IDS,
    HEADER,
    HEADER_SIZE,
    CodecInputStream,
    CodecOutputStream,
    FrameCodec,
)


def get_codec(
    name: str,
    block_size: int | None = None,
    level: int = 1,
    codec_batch_blocks: int | None = None,
    encode_inflight_batches: int | None = None,
    decode_batch_frames: int | None = None,
    decode_inflight_batches: int | None = None,
    device=None,
) -> "FrameCodec | None":
    """Resolve a codec by config name; ``none`` → None. ``block_size=None``
    → the codec's own default (64 KiB for the host codecs, 256 KiB for TLZ).
    ``codec_batch_blocks`` sizes the TLZ device batch and
    ``encode_inflight_batches`` its async encode window; ``device`` places
    the TLZ codec (the CUDA device by default; no CUDA device raises).
    ``decode_batch_frames`` / ``decode_inflight_batches`` are stamped onto
    any codec (``CodecInputStream`` reads them live), as in the JAX
    package."""

    def _stamp(codec: FrameCodec) -> FrameCodec:
        if decode_batch_frames is not None:
            codec.decode_batch_frames = max(1, int(decode_batch_frames))
        if decode_inflight_batches is not None:
            codec.decode_inflight_batches = max(0, int(decode_inflight_batches))
        return codec

    name = (name or "none").lower()
    if name in ("none", "raw", "off"):
        return None
    bs = {} if block_size is None else {"block_size": block_size}
    if name == "auto":
        from s3shuffle_tpu_torch.codec import native

        name = "native" if native.native_available() else "zlib"
    if name == "zlib":
        from s3shuffle_tpu_torch.codec.cpu import ZlibCodec

        return _stamp(ZlibCodec(level=level, **bs))
    if name == "zstd":
        from s3shuffle_tpu_torch.codec.cpu import ZstdCodec

        return _stamp(ZstdCodec(level=level, **bs))
    if name == "native":
        from s3shuffle_tpu_torch.codec.native import NativeLZCodec

        return _stamp(NativeLZCodec(**bs))
    if name == "lz4":
        from s3shuffle_tpu_torch.codec.native import NativeLZ4Codec

        return _stamp(NativeLZ4Codec(**bs))
    if name == "tpu":
        from s3shuffle_tpu_torch.codec.cuda import CudaCodec

        if codec_batch_blocks is not None:
            bs["batch_blocks"] = codec_batch_blocks
        if encode_inflight_batches is not None:
            bs["encode_inflight_batches"] = encode_inflight_batches
        return _stamp(CudaCodec(device=device, **bs))
    raise ValueError(f"Unknown codec: {name}")


def codec_from_config(config, device=None) -> "FrameCodec | None":
    """The codec a :class:`~s3shuffle_tpu_torch.config.ShuffleConfig`
    names, on ``device``, with the config's codec windows (as the JAX
    manager stamps them, ``s3shuffle_tpu/manager.py:96-104``)."""
    return get_codec(
        config.codec, config.codec_block_size, config.codec_level,
        config.codec_batch_blocks,
        encode_inflight_batches=config.encode_inflight_batches,
        decode_batch_frames=config.decode_batch_frames,
        decode_inflight_batches=config.decode_inflight_batches,
        device=device,
    )


#: a writer's or reader's ``codec`` argument when the caller passes none:
#: build the codec the config names (``None`` is a valid codec: raw bytes)
FROM_CONFIG = object()

__all__ = [
    "CODEC_IDS",
    "FROM_CONFIG",
    "HEADER",
    "HEADER_SIZE",
    "CodecInputStream",
    "CodecOutputStream",
    "FrameCodec",
    "codec_from_config",
    "get_codec",
]
