"""Host codecs of the standard compressors behind the shared framing, copied
from the JAX package's ``codec/cpu.py``: zlib (raw deflate, frame id 1)
and zstd (frame id 2). Their frames are byte-identical to the JAX
package's.

``zstandard`` is imported when a :class:`ZstdCodec` is built, never when
this module is imported; without it the constructor raises an ImportError
that names ``codec="zstd"``.
"""

from __future__ import annotations

import threading
import zlib

from s3shuffle_tpu_torch.codec.framing import CODEC_IDS, FrameCodec


class ZlibCodec(FrameCodec):
    name = "zlib"
    codec_id = CODEC_IDS["zlib"]

    def __init__(self, block_size: int = 64 * 1024, level: int = 1):
        super().__init__(block_size)
        self.level = level

    def compress_block(self, data: bytes) -> bytes:
        # raw deflate (wbits=-15): no per-block zlib header/trailer overhead
        c = zlib.compressobj(self.level, zlib.DEFLATED, -15)
        return c.compress(data) + c.flush()

    def decompress_block(self, data: bytes, uncompressed_len: int) -> bytes:
        return zlib.decompress(data, -15, uncompressed_len)


def _zstandard():
    try:
        import zstandard
    except ImportError as e:
        raise ImportError(
            'codec="zstd" needs the zstandard package, which is not installed'
        ) from e
    return zstandard


class ZstdCodec(FrameCodec):
    """zstd behind the shared framing. ``zstandard``'s compressor and
    decompressor objects are not safe for concurrent calls (one codec serves
    every task thread of a manager), so each thread gets its own pair."""

    name = "zstd"
    codec_id = CODEC_IDS["zstd"]

    def __init__(self, block_size: int = 64 * 1024, level: int = 1):
        super().__init__(block_size)
        _zstandard()  # fail fast when the package is missing
        self.level = level
        self._local = threading.local()

    def _pair(self):
        pair = getattr(self._local, "pair", None)
        if pair is None:
            zstandard = _zstandard()
            pair = (
                zstandard.ZstdCompressor(level=self.level),
                zstandard.ZstdDecompressor(),
            )
            self._local.pair = pair
        return pair

    def compress_block(self, data: bytes) -> bytes:
        return self._pair()[0].compress(data)

    def decompress_block(self, data: bytes, uncompressed_len: int) -> bytes:
        return self._pair()[1].decompress(data, max_output_size=uncompressed_len)
