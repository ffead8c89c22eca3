"""Concatenatable block framing shared with the JAX package.

Wire format per block (byte-identical to ``s3shuffle_tpu/codec/framing.py``)::

    [u8 codec_id][u32le uncompressed_len][u32le compressed_len][payload]

- **Self-delimiting**: a partition's stream is a sequence of frames.
- **Concatenatable**: two partitions' streams concatenate to a valid
  stream, which legalizes batch fetch.
- **Incompressible-block escape**: a block that does not shrink is stored
  raw (codec_id 0), so the worst-case expansion is 9 bytes per block.

Both streams carry the JAX package's async batch windows
(``CodecOutputStream`` / ``CodecInputStream``): at
``encode_inflight_batches`` / ``decode_inflight_batches`` above one, batch
encodes run on one process-wide encode thread and batch decodes on a shared
decode pool of at most four threads, each job on the codec's device (its
current stream); at one or less every batch runs on the caller's thread,
the synchronous path, byte for byte. A stream may mix codec ids: the
reader decodes each frame with the codec of its id (the stream's own codec
when the ids match, else the registry's, :func:`codec_for_frame_id`), as
the JAX package's reader does; an unknown id raises.
"""

from __future__ import annotations

import collections
import functools
import io
import os
import struct
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import BinaryIO, List, Optional, Tuple

from s3shuffle_tpu_torch.device import on_device
from s3shuffle_tpu_torch.metrics import registry as _metrics

HEADER = struct.Struct("<BII")
HEADER_SIZE = HEADER.size  # 9 bytes

#: Upper bound on a frame's claimed uncompressed length (a corrupt header
#: must not drive a huge allocation before validation rejects it).
MAX_FRAME_ULEN = 1 << 28

CODEC_IDS = {
    "raw": 0,
    "zlib": 1,
    "zstd": 2,
    "native-lz": 3,
    "tpu-lz": 4,
    "lz4": 5,
}
_NAMES = {v: k for k, v in CODEC_IDS.items()}

_H_ENCODE_BATCH = _metrics.REGISTRY.histogram(
    "codec_encode_batch_seconds",
    "Batch compress+frame call latency (device launch + host assembly)",
)
_C_ENCODE_BYTES = _metrics.REGISTRY.counter(
    "codec_encode_bytes_total", "Raw bytes through batch compress+frame calls"
)
_G_ENCODE_INFLIGHT = _metrics.REGISTRY.gauge(
    "codec_encode_inflight",
    "Encode batches in flight between serializers and their sinks "
    "(async batch mode, summed across streams)",
)
_C_FUSED_CRC = _metrics.REGISTRY.counter(
    "codec_fused_crc_total",
    "Frames whose stored-byte CRC came fused from the encode launch",
)
_C_FRAMES = _metrics.REGISTRY.counter(
    "codec_frames_total", "Frames emitted by codec output streams"
)

_H_DECODE_BATCH = _metrics.REGISTRY.histogram(
    "codec_decode_batch_seconds",
    "Batch decompress call latency (device launch + host parse/staging)",
)
_C_DECODE_BYTES = _metrics.REGISTRY.counter(
    "codec_decode_bytes_total",
    "Decoded (uncompressed) bytes out of batch decompress calls",
)
_G_DECODE_INFLIGHT = _metrics.REGISTRY.gauge(
    "codec_decode_inflight",
    "Decode batches in flight between sources and their consumers "
    "(async batch mode, summed across streams)",
)
_C_FUSED_VALIDATED = _metrics.REGISTRY.counter(
    "codec_fused_crc_validated_total",
    "Frames whose stored-byte CRC certificate came fused from the decode "
    "launch (the checksum stream's host hashing pass was skipped)",
)


class FrameCodec:
    """One compression algorithm behind the shared framing. Subclasses
    implement ``compress_block``/``decompress_block``; batch codecs also
    override the batch hooks."""

    name = "abstract"
    codec_id = 0
    #: full blocks a CodecOutputStream gathers per ``compress_framed`` call
    batch_blocks = 1
    #: read-plane knobs, stamped per instance by ``get_codec`` and read live
    #: per batch by CodecInputStream: frames read ahead and decoded per
    #: batch (None → the stream default), and the async decode window
    #: (<= 1: synchronous decode on the consumer thread)
    decode_batch_frames: int | None = None
    decode_inflight_batches: int = 0

    def __init__(self, block_size: int = 64 * 1024):
        if block_size <= 0:
            raise ValueError("block_size must be positive")
        if block_size > MAX_FRAME_ULEN:
            raise ValueError(
                f"block_size {block_size} exceeds MAX_FRAME_ULEN {MAX_FRAME_ULEN}"
            )
        self.block_size = block_size
        #: frames through this codec's streams, summed over every map and
        #: reduce task that shares the codec (keys ``written``,
        #: ``written_fused``, ``read``, ``read_fused``; added as each stream
        #: closes)
        self.frame_counts: collections.Counter = collections.Counter()
        self._counts_lock = threading.Lock()

    def count_frames(self, **counts: int) -> None:
        with self._counts_lock:
            self.frame_counts.update(counts)

    def compress_block(self, data: bytes) -> bytes:
        raise NotImplementedError

    def decompress_block(self, data: bytes, uncompressed_len: int) -> bytes:
        raise NotImplementedError

    def compress_blocks(self, blocks: List[bytes]) -> List[bytes]:
        return [self.compress_block(b) for b in blocks]

    def decompress_blocks(self, blocks: List[Tuple[bytes, int]]) -> List[bytes]:
        return [self.decompress_block(b, n) for b, n in blocks]

    def decompress_blocks_concat(self, blocks: List[Tuple[bytes, int]]) -> bytes:
        out = self.decompress_blocks(blocks)
        for (_, ulen), b in zip(blocks, out):
            if len(b) != ulen:
                raise IOError(f"Decompressed length {len(b)} != header {ulen}")
        return b"".join(out)

    def frame_from(self, raw: bytes, compressed: bytes) -> bytes:
        """Frame a pre-compressed block, applying the raw escape."""
        if len(compressed) >= len(raw):
            return HEADER.pack(0, len(raw), len(raw)) + raw
        return HEADER.pack(self.codec_id, len(raw), len(compressed)) + compressed

    def frame_block(self, raw: bytes) -> bytes:
        return self.frame_from(raw, self.compress_block(raw))

    def frame_blocks(self, blocks: List[bytes]) -> bytes:
        """Frame a batch of raw blocks as one bytes object, compressed
        through :meth:`compress_blocks`."""
        compressed = self.compress_blocks(blocks)
        return b"".join(self.frame_from(raw, comp) for raw, comp in zip(blocks, compressed))

    def wants_async_decode(self) -> bool:
        """True when CodecInputStream should decode this codec's batches on
        the shared decode pool: a window wider than one batch, and a codec
        that decodes batches (a per-frame codec gains nothing from it)."""
        return (
            int(getattr(self, "decode_inflight_batches", 0)) > 1
            and type(self).decompress_blocks is not FrameCodec.decompress_blocks
        )

    def compress_stream(self, sink: BinaryIO) -> "CodecOutputStream":
        return CodecOutputStream(self, sink)

    def decompress_stream(self, source: BinaryIO) -> "CodecInputStream":
        return CodecInputStream(self, source)

    def compress_bytes(self, data: bytes) -> bytes:
        out = io.BytesIO()
        s = CodecOutputStream(self, out, close_sink=False)
        s.write(data)
        s.close()
        return out.getvalue()

    def decompress_bytes(self, data: bytes) -> bytes:
        with CodecInputStream(self, io.BytesIO(data)) as stream:
            return stream.read()


#: process-wide encode executor with ONE worker: batches of every stream
#: run through it in submission order (each stream's FIFO harvest relies on
#: that), and the TLZ staging buffers, kept per thread, serve them all
_encode_executor_lock = threading.Lock()
_encode_executor: Optional[ThreadPoolExecutor] = None

#: process-wide decode pool of at most four workers: concurrent reduce
#: tasks decode in parallel; each stream keeps its own order by harvesting
#: its futures FIFO
_decode_executor_lock = threading.Lock()
_decode_executor: Optional[ThreadPoolExecutor] = None


def _get_encode_executor() -> ThreadPoolExecutor:
    global _encode_executor
    with _encode_executor_lock:
        if _encode_executor is None:
            _encode_executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="s3shuffle-torch-encode"
            )
        return _encode_executor


def _get_decode_executor() -> ThreadPoolExecutor:
    global _decode_executor
    with _decode_executor_lock:
        if _decode_executor is None:
            _decode_executor = ThreadPoolExecutor(
                max_workers=min(4, os.cpu_count() or 2),
                thread_name_prefix="s3shuffle-torch-decode",
            )
        return _decode_executor


class CodecOutputStream(io.RawIOBase):
    """Buffers raw bytes and emits frames. A codec with a ``compress_framed``
    hook (TLZ, SLZ, LZ4) gets full blocks ``batch_blocks`` at a time in one
    call (one device batch or one native call); any other codec frames its
    full blocks through ``frame_blocks`` as a batch of ``batch_blocks``
    fills. The final short block is framed at ``close``/``flush_block``.

    **Async batch mode** (``codec.encode_inflight_batches > 1`` and the
    codec answers ``wants_async_encode()``): each batch is handed, with the
    buffer that holds it, to the process-wide encode thread, and a window of
    encode futures rides between the producer and the sink; the producer
    fills the next batch while the device encodes this one. Emission keeps
    the order (one worker, FIFO harvest on the producer's thread), an encode
    failure re-raises on the producer's next ``write``/``flush_block``/
    ``close`` (the rest of the window is dropped), and ``pending_bytes``
    counts the in-flight raw bytes, so the spill budget sees them. The
    window is read live at every batch; at one or less the batches encode
    on the producer thread.

    ``checksum`` (optional FusedChecksumAccumulator-shaped object) receives
    every emitted byte: per-frame CRCs fused into the batch encode where the
    codec has ``compress_framed_fused``, byte hashes for every other frame —
    so its final value always equals a byte-serial checksum of the emitted
    stream.
    ``frames`` / ``fused_frames`` count emitted frames and those whose CRC
    came fused from the encode launch (taken as each batch is harvested)."""

    def __init__(self, codec: FrameCodec, sink: BinaryIO, close_sink: bool = True,
                 checksum=None):
        self._codec = codec
        self._sink = sink
        self._buf = bytearray()
        self._pending: List[bytes] = []  # full blocks awaiting frame_blocks
        self._close_sink = close_sink
        self._batch_blocks = max(1, codec.batch_blocks)
        self._framed = getattr(codec, "compress_framed", None)
        self._framed_fused = getattr(codec, "compress_framed_fused", None)
        self._wants_async = getattr(codec, "wants_async_encode", None)
        self._checksum = checksum
        self._inflight: deque = deque()  # (future, raw bytes)
        self._inflight_bytes = 0
        self.frames = 0
        self.fused_frames = 0

    @property
    def _window(self) -> int:
        """The async window, read live at every batch submission."""
        return max(0, int(getattr(self._codec, "encode_inflight_batches", 0)))

    def writable(self) -> bool:
        return True

    def write(self, b) -> int:
        before = len(self._buf)
        self._buf += b if isinstance(b, (bytes, bytearray, memoryview)) else memoryview(b)
        written = len(self._buf) - before
        bs = self._codec.block_size
        if self._framed is not None:
            if len(self._buf) >= bs * self._batch_blocks:
                self._emit_framed(len(self._buf) // bs)
            return written
        while len(self._buf) >= bs:
            self._pending.append(bytes(self._buf[:bs]))
            del self._buf[:bs]
            if len(self._pending) >= self._batch_blocks:
                self._emit_pending()
        return written

    def _write_out(self, data, crcs, n_frames: int) -> None:
        self._sink.write(data)
        self.frames += n_frames
        if _metrics.enabled():
            _C_FRAMES.inc(n_frames)
        if self._checksum is not None:
            if crcs is not None:
                for crc, length in crcs:
                    self._checksum.add_stored(crc, length)
                self.fused_frames += len(crcs)
                if _metrics.enabled():
                    _C_FUSED_CRC.inc(len(crcs))
            else:
                self._checksum.add_bytes(data if isinstance(data, bytes) else bytes(data))

    def _encode_batch(self, buf, n_blocks: int, bs: int):
        """Compress and frame the first ``n_blocks`` blocks of ``buf``:
        ``(framed bytes, per-frame CRCs or None)``."""
        mv = memoryview(buf)[: n_blocks * bs]
        t0 = time.perf_counter_ns()
        try:
            if self._checksum is not None and self._framed_fused is not None:
                out, crcs = self._framed_fused(mv, n_blocks, bs)
            else:
                out, crcs = self._framed(mv, n_blocks, bs), None
        finally:
            mv.release()
        if _metrics.enabled():
            _H_ENCODE_BATCH.observe((time.perf_counter_ns() - t0) / 1e9)
            _C_ENCODE_BYTES.inc(n_blocks * bs)
        return out, crcs

    def _encode_job(self, buf, n_blocks: int, bs: int):
        """One batch on the encode thread, on the codec's device."""
        with on_device(getattr(self._codec, "device", None)):
            return self._encode_batch(buf, n_blocks, bs)

    def _harvest_one(self) -> None:
        fut, nbytes = self._inflight.popleft()
        self._inflight_bytes -= nbytes
        if _metrics.enabled():
            _G_ENCODE_INFLIGHT.dec(1)
        try:
            out, crcs = fut.result()
        except BaseException:
            self._abort_inflight()
            raise
        self._write_out(out, crcs, nbytes // self._codec.block_size)

    def _drain_inflight(self) -> None:
        while self._inflight:
            self._harvest_one()

    def _abort_inflight(self) -> None:
        """A batch failed (or the writer gave up): drop the rest of the
        window; queued batches never run, a running one is discarded."""
        if _metrics.enabled():
            _G_ENCODE_INFLIGHT.dec(len(self._inflight))
        for fut, _nbytes in self._inflight:
            fut.cancel()
        self._inflight.clear()
        self._inflight_bytes = 0

    def _emit_framed(self, n_blocks: int) -> None:
        bs = self._codec.block_size
        cut = n_blocks * bs
        if self._window > 1 and self._wants_async is not None and self._wants_async():
            # the encode thread takes the whole buffer (it reads only the
            # first ``cut`` bytes and nobody resizes it); the partial-block
            # tail goes on in a fresh buffer
            buf = self._buf
            self._buf = bytearray(memoryview(buf)[cut:])
            fut = _get_encode_executor().submit(self._encode_job, buf, n_blocks, bs)
            self._inflight.append((fut, cut))
            self._inflight_bytes += cut
            if _metrics.enabled():
                _G_ENCODE_INFLIGHT.inc(1)
            while len(self._inflight) >= self._window:
                self._harvest_one()
            return
        # synchronous path: harvest what a wider window left in flight
        # first, so emission order holds
        self._drain_inflight()
        out, crcs = self._encode_batch(self._buf, n_blocks, bs)
        self._write_out(out, crcs, n_blocks)
        del self._buf[:cut]

    def _emit_pending(self) -> None:
        if self._pending:
            out = self._codec.frame_blocks(self._pending)
            self._write_out(out, None, len(self._pending))
            self._pending.clear()

    @property
    def pending_bytes(self) -> int:
        """Raw bytes buffered but not yet framed (partial block, batch queue
        and the async window's in-flight batches) — memory-budget accounting
        (the map writer's spill budget) must count these."""
        return len(self._buf) + sum(len(p) for p in self._pending) + self._inflight_bytes

    def flush_block(self) -> None:
        """Force everything buffered out (partition boundaries: partitions
        never share a frame)."""
        if self._framed is None:
            if self._buf:
                self._pending.append(bytes(self._buf))
                self._buf.clear()
            self._emit_pending()
            return
        bs = self._codec.block_size
        full = len(self._buf) // bs
        while full:
            n = min(full, self._batch_blocks)
            self._emit_framed(n)
            full -= n
        self._drain_inflight()
        if self._buf:
            tail = bytes(self._buf)
            framed = self._codec.frame_from(tail, self._codec.compress_block(tail))
            self._write_out(framed, None, 1)
            self._buf.clear()

    def close(self) -> None:
        if self.closed:
            return
        try:
            self.flush_block()
        except BaseException:
            # the window goes before anything else; the sink stays open for
            # the writer's abort, and the stream counts as closed
            self._abort_inflight()
            super().close()
            raise
        self._codec.count_frames(written=self.frames, written_fused=self.fused_frames)
        if self._close_sink:
            self._sink.close()
        else:
            try:
                self._sink.flush()
            except (AttributeError, ValueError):
                pass
        super().close()


class CodecInputStream(io.RawIOBase):
    """Reads frames from ``source`` and serves decompressed bytes; frames of
    one codec id are decoded in runs of up to ``decode_batch_frames`` (one
    device batch or native call per run) when the stream's codec decodes
    batches, else one frame at a time. Any codec's frames are accepted: a
    frame whose id is not the codec's is decoded by the registry's codec for
    that id (TLZ frames on ``device``, by default the stream codec's device).

    **Async batch mode** (``codec.decode_inflight_batches > 1`` and the codec
    answers ``wants_async_decode()``): runs are handed to the shared decode
    pool, and a window of decode futures rides between the source and the
    consumer; the consumer deserializes one chunk while the pool decodes
    the next. Harvests keep the order (each stream's futures FIFO), a decode
    failure re-raises on the consumer's next read, and the decoded bytes of
    every in-flight run beyond the first are reserved against ``budget``
    (the scan's prefetcher: ``try_reserve``/``release_reserved``), so
    concurrent reduce tasks stay inside their memory budget: a full budget
    shrinks the window instead of waiting. ``close`` releases every
    reservation. The window and the run size are read live at every batch;
    at one or less every run decodes on the consumer thread.

    **Fused validation**: when the codec can certify frames' stored-byte
    CRCs from its decode launch (``wants_fused_decode_validation``) and the
    source is a ``ChecksumValidationStream`` whose algorithm has a
    combinable CRC form, the stream arms the source's deferred mode and
    certifies each decoded frame itself, on the consumer thread only; a
    decode error first resolves pending certification, so corruption still
    surfaces as the checksum mismatch it is. ``frames`` / ``fused_frames``
    count decoded frames and those certified by a fused CRC.

    :meth:`readview` serves the decoded bytes without a copy: bytes, or a
    read-only uint8 ndarray for runs a native codec decoded in one call."""

    BATCH_FRAMES = 32
    SRC_CHUNK = 1 << 20

    def __init__(self, codec: FrameCodec | None, source: BinaryIO, device=None,
                 budget=None):
        self._codec = codec
        self._source = source
        self._device = device if device is not None else getattr(codec, "device", None)
        self._batch_capable = (
            codec is not None
            and type(codec).decompress_blocks is not FrameCodec.decompress_blocks
        )
        self._wants_async = getattr(codec, "wants_async_decode", None)
        self._budget = budget
        self._current = b""
        self._pos = 0
        self._eof = False
        self._decoded: deque = deque()  # (chunk, reserved budget bytes)
        self._inflight: deque = deque()  # (future, reserved budget bytes, frames)
        self._rbuf = b""
        self._rpos = 0
        self._pending_frame = None
        self._src_eof = False
        self._certify = None
        self._fused_poly = None
        self.frames = 0
        self.fused_frames = 0
        wants_fused = getattr(codec, "wants_fused_decode_validation", None)
        defer = getattr(source, "defer_validation", None)
        poly = getattr(source, "fused_poly", None)
        if wants_fused is not None and defer is not None and poly is not None:
            if wants_fused(poly) and defer():
                self._certify = source
                self._fused_poly = poly

    def readable(self) -> bool:
        return True

    @property
    def _batch_frames(self) -> int:
        """Frames per run, read live from the codec."""
        if not self._batch_capable:
            return 1
        v = getattr(self._codec, "decode_batch_frames", None)
        return self.BATCH_FRAMES if v is None else max(1, int(v))

    @property
    def _window(self) -> int:
        """The async decode window, read live at every batch boundary."""
        if self._codec is None:
            return 0
        return max(0, int(getattr(self._codec, "decode_inflight_batches", 0)))

    def _read_exact(self, n: int) -> bytes:
        """n bytes from the buffered source (fewer only at EOF), refilled in
        ``SRC_CHUNK`` pieces so the layers below see big reads."""
        avail = len(self._rbuf) - self._rpos
        if avail >= n:
            out = self._rbuf[self._rpos : self._rpos + n]
            self._rpos += n
            return out
        parts = [self._rbuf[self._rpos :]] if avail else []
        need = n - avail
        self._rbuf = b""
        self._rpos = 0
        while need > 0:
            chunk = self._source.read(max(need, self.SRC_CHUNK))
            if not chunk:
                break
            if len(chunk) > need:
                parts.append(chunk[:need])
                self._rbuf = chunk
                self._rpos = need
                need = 0
            else:
                parts.append(chunk)
                need -= len(chunk)
        return b"".join(parts) if len(parts) != 1 else parts[0]

    def _read_frame(self):
        """Returns (codec_id, payload, ulen) or None at EOF."""
        header = self._read_exact(HEADER_SIZE)
        if not header:
            return None
        if len(header) < HEADER_SIZE:
            raise IOError(f"Truncated frame header ({len(header)} bytes)")
        codec_id, ulen, clen = HEADER.unpack(header)
        if ulen > MAX_FRAME_ULEN or clen > MAX_FRAME_ULEN:
            raise IOError(
                f"Frame header claims {max(ulen, clen)} bytes "
                f"(> {MAX_FRAME_ULEN} cap) — corrupt stream"
            )
        payload = self._read_exact(clen)
        if len(payload) < clen:
            raise IOError(f"Truncated frame payload ({len(payload)}/{clen} bytes)")
        if codec_id == 0 and ulen != clen:
            raise IOError("Raw frame with mismatched lengths")
        return codec_id, payload, ulen

    def _read_run(self) -> list:
        """The next in-order run of frames sharing one codec_id, up to the
        batch size; a codec switch parks the switching frame for the next
        run (frames are never reordered)."""
        run: list = []
        limit = self._batch_frames
        if self._pending_frame is not None:
            run.append(self._pending_frame)
            self._pending_frame = None
        while len(run) < limit:
            frame = self._read_frame()
            if frame is None:
                self._src_eof = True
                break
            if run and frame[0] != run[0][0]:
                self._pending_frame = frame
                break
            run.append(frame)
        return run

    def _decode_frames(self, frames):
        """Decode a run sharing one codec_id into ONE chunk (consumer thread
        in sync mode, a decode-pool thread in async mode; it never touches
        the source or the validator). Returns ``(chunk, certs)``; ``certs``
        (fused validation armed) lists ``(frame_len, frame_crc_or_None)``
        per frame in order."""
        codec_id = frames[0][0]
        certs = [] if self._certify is not None else None
        t0 = time.perf_counter_ns()
        if codec_id == 0:
            out = b"".join(p for _c, p, _u in frames)
            if certs is not None:
                certs.extend((HEADER_SIZE + len(p), None) for _c, p, _u in frames)
            if _metrics.enabled():
                _H_DECODE_BATCH.observe((time.perf_counter_ns() - t0) / 1e9)
                _C_DECODE_BYTES.inc(len(out))
            return out, certs
        if self._codec is not None and codec_id == self._codec.codec_id:
            codec = self._codec
        else:
            codec = codec_for_frame_id(codec_id, self._device)
        total = sum(u for _c, _p, u in frames)
        blocks = [(p, u) for _c, p, u in frames]
        crcs = None
        if certs is not None and getattr(codec, "decompress_blocks_fused", None):
            out, crcs = codec.decompress_blocks_fused(blocks, self._fused_poly)
        else:
            out = codec.decompress_blocks_concat(blocks)
        if len(out) != total:
            raise IOError(f"Decompressed run length {len(out)} != headers {total}")
        if certs is not None:
            from s3shuffle_tpu_torch.ops.checksum import crc_combine, host_crc

            for i, (_c, p, u) in enumerate(frames):
                crc = crcs[i] if crcs is not None else None
                if crc is not None:
                    # frame = 9-byte header (host-hashed) + payload (fused)
                    header = HEADER.pack(codec_id, u, len(p))
                    crc = crc_combine(
                        host_crc(header, self._fused_poly), crc, len(p), self._fused_poly
                    )
                certs.append((HEADER_SIZE + len(p), crc))
        if _metrics.enabled():
            _H_DECODE_BATCH.observe((time.perf_counter_ns() - t0) / 1e9)
            _C_DECODE_BYTES.inc(len(out))
        return out, certs

    def _decode_job(self, frames):
        """One run on a decode-pool thread, on the stream's device."""
        with on_device(self._device):
            return self._decode_frames(frames)

    def _apply_certs(self, certs) -> None:
        """Feed a decoded run's certificates to the deferred checksum stream
        in order (consumer thread only: certification moves the validator's
        cursor); raises its ChecksumError on a partition mismatch."""
        if not certs:
            return
        fused = 0
        for length, crc in certs:
            self._certify.certify(length, stored_crc=crc)
            if crc is not None:
                self.fused_frames += 1
                fused += 1
        if fused and _metrics.enabled():
            _C_FUSED_VALIDATED.inc(fused)

    # --- the async window ---
    def _submit_window(self) -> None:
        while not self._src_eof or self._pending_frame is not None:
            if len(self._inflight) >= self._window:
                break
            reserved = 0
            if self._inflight and self._budget is not None:
                # beyond the first in-flight run the decoded bytes must fit
                # the task budget; a full budget shrinks the window instead
                # of blocking (this consumer's closes are what free it)
                est = self._batch_frames * max(1, int(getattr(self._codec, "block_size", 1 << 16)))
                if not self._budget.try_reserve(est):
                    break
                reserved = est
            try:
                run = self._read_run()
                if run:
                    fut = _get_decode_executor().submit(self._decode_job, run)
            except BaseException:
                # the reservation is in neither window yet: release it here
                if reserved:
                    self._budget.release_reserved(reserved)
                raise
            if not run:
                if reserved:
                    self._budget.release_reserved(reserved)
                break
            self._inflight.append((fut, reserved, len(run)))
            if _metrics.enabled():
                _G_DECODE_INFLIGHT.inc(1)

    def _harvest_one_decode(self) -> None:
        fut, reserved, n_frames = self._inflight.popleft()
        if _metrics.enabled():
            _G_DECODE_INFLIGHT.dec(1)
        try:
            chunk, certs = fut.result()
            self.frames += n_frames
            self._apply_certs(certs)
        except BaseException:
            if reserved:
                self._budget.release_reserved(reserved)
            raise
        self._decoded.append((chunk, reserved))

    def _drain_decode_inflight(self) -> None:
        while self._inflight:
            self._harvest_one_decode()

    def _abort_decode_window(self) -> None:
        if _metrics.enabled() and self._inflight:
            _G_DECODE_INFLIGHT.dec(len(self._inflight))
        for fut, reserved, _n in self._inflight:
            fut.cancel()
            if reserved:
                self._budget.release_reserved(reserved)
        self._inflight.clear()

    def _fill(self) -> bool:
        if not self._decoded:
            try:
                if self._window > 1 and self._wants_async is not None and self._wants_async():
                    while not self._decoded:
                        self._submit_window()
                        if not self._inflight:
                            break
                        self._harvest_one_decode()
                else:
                    # synchronous path (window off, or shrunk mid-stream:
                    # the window's leftovers first, so the order holds)
                    self._drain_decode_inflight()
                    if not self._decoded:
                        run = self._read_run()
                        if run:
                            chunk, certs = self._decode_frames(run)
                            self.frames += len(run)
                            self._apply_certs(certs)
                            self._decoded.append((chunk, 0))
            except BaseException:
                self._abort_decode_window()
                if self._certify is not None:
                    # corruption classifies as streaming validation would:
                    # a checksum mismatch takes precedence over the decoder's
                    # parse error
                    self._certify.resolve_pending()
                raise
        if not self._decoded:
            self._eof = True
            return False
        chunk, reserved = self._decoded.popleft()
        if reserved:
            self._budget.release_reserved(reserved)
        self._current = chunk
        self._pos = 0
        return True

    def read(self, size: int = -1) -> bytes:
        if size is None or size < 0:
            chunks = []
            while True:
                chunk = self.read(1 << 20)
                if not chunk:
                    return b"".join(chunks)
                chunks.append(chunk)
        out = self.readview(size)
        return out if isinstance(out, bytes) else bytes(out)

    def readview(self, size: int):
        """Like :meth:`read` but without the copy: up to ``size`` bytes as a
        slice of the current decoded chunk (bytes, or a read-only uint8
        ndarray for a run a native codec decoded). The frame parsers read
        through it (``utils.io.read_fully_view``)."""
        while self._pos >= len(self._current):
            if self._eof or not self._fill():
                return b""
        end = min(self._pos + size, len(self._current))
        out = self._current[self._pos : end]
        self._pos = end
        return out

    def close(self) -> None:
        if not self.closed:
            self._abort_decode_window()
            for _chunk, reserved in self._decoded:
                if reserved:
                    self._budget.release_reserved(reserved)
            self._decoded.clear()
            self._source.close()
            if self._codec is not None:
                self._codec.count_frames(read=self.frames, read_fused=self.fused_frames)
        super().close()


def codec_for_frame_id(codec_id: int, device=None) -> FrameCodec:
    """The registry's codec for a frame id, built once per process (and per
    device for TLZ frames): frames whose id differs from the stream codec's
    must not rebuild a codec per frame. An unknown id raises."""
    name = _NAMES.get(codec_id)
    if name is None or codec_id == 0:
        raise IOError(f"Unknown codec id in frame: {codec_id}")
    if name == "tpu-lz":
        from s3shuffle_tpu_torch.device import resolve_device

        return _registry_codec(name, resolve_device(device))
    return _registry_codec(name, None)


@functools.lru_cache(maxsize=None)
def _registry_codec(name: str, device) -> FrameCodec:
    from s3shuffle_tpu_torch.codec import get_codec

    # frame name → registry name: two are aliased, the rest are the same
    return get_codec({"native-lz": "native", "tpu-lz": "tpu"}.get(name, name), device=device)


#: the JAX package's name for :func:`codec_for_frame_id`
_codec_for_frame_id = codec_for_frame_id


def decompress_frame_payload(codec_id: int, payload: bytes, ulen: int,
                             hint: FrameCodec | None, device=None) -> bytes:
    """Dispatch on the frame's codec id; ``hint`` avoids a registry lookup when
    the configured codec matches (the common case). ``device`` places a TLZ
    frame's registry codec (the CUDA device unless ``"cpu"``)."""
    if hint is not None and codec_id == hint.codec_id:
        return hint.decompress_block(payload, ulen)
    return codec_for_frame_id(codec_id, device).decompress_block(payload, ulen)
