"""The TLZ codec on the GPU: batched encode with fused CRC32C, batched
fused decode + CRC, behind the shared framing.

Counterpart of the JAX package's ``TpuCodec`` (``codec/tpu.py``), with the
same frames (``codec_id = 4``, ``tpu-lz``) and the same fused-checksum
contract. Unlike ``TpuCodec`` nothing here hides the device: there is no
SLZ reroute, no measured-rate gate and no host fallback on a kernel
failure. On a CUDA device full blocks always go through the kernels and a
kernel failure raises; ``device="cpu"`` runs the plain PyTorch versions of
the same kernels. Short tail blocks (fewer bytes than ``block_size``) are
encoded by the host numpy encoder, which is byte-identical to the device
encoder.

Fused checksum semantics: a partition checksum covers *stored* bytes
(frames = 9-byte headers + payloads). CRC is GF(2)-linear, so the encode
launch returns per-block raw CRCs of the raw blocks and of the literal
planes, and the host stitches the small header/metadata slices around them
with ``crc_combine`` — see :class:`FusedChecksumAccumulator`.
"""

from __future__ import annotations

from typing import List

from s3shuffle_tpu_torch.codec.framing import CODEC_IDS, HEADER, HEADER_SIZE, FrameCodec
from s3shuffle_tpu_torch.device import resolve_device
from s3shuffle_tpu_torch.ops import tlz
from s3shuffle_tpu_torch.ops.checksum import (
    POLY_CRC32,
    POLY_CRC32C,
    crc_combine,
    host_crc,
)


class CudaCodec(FrameCodec):
    name = "tpu-lz"
    codec_id = CODEC_IDS["tpu-lz"]

    def __init__(self, block_size: int = 256 * 1024, batch_blocks: int = 64,
                 device=None, encode_inflight_batches: int = 0):
        if block_size % 128 != 0:
            raise ValueError("TLZ codec block_size must be a multiple of 128")
        if block_size > tlz.MAX_BLOCK:
            raise ValueError("TLZ codec block_size must be <= 256 KiB")
        super().__init__(block_size)
        self.batch_blocks = max(1, int(batch_blocks))
        #: the async encode window of CodecOutputStream (read live per batch)
        self.encode_inflight_batches = max(0, int(encode_inflight_batches))
        self.device = resolve_device(device)
        #: set to a dict to accumulate the batch stages' seconds
        #: (``tlz.encode_batch_device`` / ``tlz.decode_batch_device`` keys)
        self.timings: dict | None = None

    # --- single block (host numpy path: short tail blocks) ---
    def compress_block(self, data: bytes) -> bytes:
        return tlz._assemble_payload_numpy(data)

    def decompress_block(self, data: bytes, uncompressed_len: int) -> bytes:
        return tlz.decode_payload_numpy(data, uncompressed_len)

    # --- batch encode ---
    def wants_async_encode(self) -> bool:
        """True when CodecOutputStream should encode this codec's batches on
        the shared encode thread: whenever the window is wider than one
        batch (the port has no host delegate to route around)."""
        return self.encode_inflight_batches > 1

    @property
    def supports_fused_checksum(self) -> bool:
        """The encode launch returns each block's CRC32C with its planes."""
        return True

    def _compress_framed_impl(self, buf, n_blocks: int, block_size: int, want_crcs: bool):
        mv = memoryview(buf)
        payloads, crc_info = tlz.encode_batch_device(
            mv, n_blocks, block_size, batch_blocks=self.batch_blocks,
            poly=POLY_CRC32C if want_crcs else None, device=self.device,
            timings=self.timings,
        )
        out = bytearray()
        crcs: List | None = [] if crc_info is not None else None
        if crc_info is not None:
            block_crcs, lit_crcs, lit_lens = crc_info
        for i, pl in enumerate(payloads):
            if len(pl) >= block_size:  # framing raw escape
                header = HEADER.pack(0, block_size, block_size)
                out += header
                out += mv[i * block_size : (i + 1) * block_size]
                if crcs is not None:
                    # stored bytes = header + RAW block (CRC from the launch)
                    crcs.append((
                        crc_combine(host_crc(header, POLY_CRC32C), int(block_crcs[i]),
                                    block_size, POLY_CRC32C),
                        HEADER_SIZE + block_size,
                    ))
            else:
                header = HEADER.pack(self.codec_id, block_size, len(pl))
                out += header
                out += pl
                if crcs is not None:
                    # stored bytes = header + metadata prefix + literal plane;
                    # only the small prefix touches the host CRC
                    lit_len = int(lit_lens[i])
                    crcs.append((
                        crc_combine(
                            host_crc(header + pl[: len(pl) - lit_len], POLY_CRC32C),
                            int(lit_crcs[i]), lit_len, POLY_CRC32C,
                        ),
                        HEADER_SIZE + len(pl),
                    ))
        mv.release()
        return bytes(out), crcs

    def compress_framed(self, buf, n_blocks: int, block_size: int) -> bytes:
        """Contiguous-buffer batch path (CodecOutputStream hook): frames of
        ``n_blocks`` full blocks."""
        return self._compress_framed_impl(buf, n_blocks, block_size, False)[0]

    def compress_framed_fused(self, buf, n_blocks: int, block_size: int):
        """:meth:`compress_framed` + per-frame stored-byte CRC32C values from
        the same launches: ``(framed_bytes, [(frame_crc, frame_len), ...])``."""
        return self._compress_framed_impl(buf, n_blocks, block_size, True)

    # --- batch decode ---
    def decompress_blocks(self, blocks) -> List[bytes]:
        return self._decode(blocks, None)[0]

    def wants_fused_decode_validation(self, poly: int) -> bool:
        """The decode launch certifies each frame's stored bytes for the
        CRC polynomials it folds."""
        return poly in (POLY_CRC32, POLY_CRC32C)

    def _decode(self, blocks, poly):
        out, crcs = tlz.decode_batch_device(
            [b for b, _n in blocks], [n for _b, n in blocks], self.block_size,
            batch_rows=self.batch_blocks, poly=poly, device=self.device,
            timings=self.timings,
        )
        for (_, ulen), o in zip(blocks, out):
            if len(o) != ulen:
                raise IOError(f"Decompressed length {len(o)} != header {ulen}")
        return out, crcs

    def decompress_blocks_fused(self, blocks, poly: int):
        """Decoded bytes of a run of frames (one chunk) + per-frame PAYLOAD
        CRCs from the same decode launch; None per frame the launch did not
        cover (short frames, decoded on the host)."""
        out, crcs = self._decode(blocks, poly)
        return b"".join(out), crcs


class FusedChecksumAccumulator:
    """Streaming checksum of *stored* frame bytes where payload CRCs come
    from the device in batch and only small slices touch the host CPU.
    Equals a byte-serial CRC over the concatenated stored bytes exactly."""

    def __init__(self, poly: int = POLY_CRC32C):
        self.poly = poly
        self._crc = 0

    def add_bytes(self, data: bytes) -> None:
        self._crc = crc_combine(self._crc, host_crc(data, self.poly), len(data), self.poly)

    def add_stored(self, crc: int, length: int) -> None:
        """Append ``length`` stored bytes whose full-algorithm CRC is ``crc``
        (the per-frame form ``compress_framed_fused`` returns)."""
        self._crc = crc_combine(self._crc, crc, length, self.poly)

    @property
    def value(self) -> int:
        return self._crc
