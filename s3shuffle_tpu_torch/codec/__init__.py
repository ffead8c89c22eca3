"""Block codec of the port: the shared concatenatable framing and the TLZ
codec on the GPU (:class:`~s3shuffle_tpu_torch.codec.cuda.CudaCodec`)."""

from s3shuffle_tpu_torch.codec.framing import (
    CODEC_IDS,
    HEADER,
    HEADER_SIZE,
    CodecInputStream,
    CodecOutputStream,
    FrameCodec,
)

__all__ = [
    "CODEC_IDS",
    "HEADER",
    "HEADER_SIZE",
    "CodecInputStream",
    "CodecOutputStream",
    "FrameCodec",
]
