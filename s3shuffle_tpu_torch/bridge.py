"""Codec bridge service: a batch-granular socket gateway to the port's
codecs for external (JVM) clients (the JAX package's ``bridge.py``, with
the same wire protocol, so a client of either package talks to a server of
either).

The reference compresses and checksums on the JVM through Spark codec
streams and ``java.util.zip`` (S3ShuffleReader.scala:99-110,
S3ShuffleHelper.scala:94-103). Per-block round trips would drown the codec,
so one request carries a whole batch of blocks in one contiguous payload
and the response comes back the same way.

Wire protocol (all integers little-endian)::

    request  = [u8 op][u32 n][u32 lens[n]][payload bytes (concatenated)]
    response = [u8 status][u32 n][u32 lens[n]][payload bytes]

ops:
    1  COMPRESS_FRAMED: blocks in, one framed stream out (response n == 1),
       a valid ``codec/framing.py`` stream the JVM side can upload as the
       shuffle object payload unchanged.
    2  DECOMPRESS: one framed stream in, the raw bytes out.
    3  CRC32C_BATCH: blocks in, one u32 checksum per block out.
    4  ADLER32_BATCH: blocks in, one u32 checksum per block out.

status: 0 ok, 1 error (payload = utf-8 message).

With ``codec_name="tpu"`` the server's codec is the TLZ codec on
``device`` (the CUDA device unless ``"cpu"`` is asked for):
``COMPRESS_FRAMED`` encodes the request's full blocks in device launches
(kernels K1 and K2) and ``DECOMPRESS`` decodes its frames in batches
(kernel K3). There is no host reroute: without a CUDA device the server
refuses to start unless ``device="cpu"``.
"""

from __future__ import annotations

import logging
import socket
import socketserver
import struct
import threading
from typing import List, Optional, Tuple

logger = logging.getLogger(__name__)

OP_COMPRESS_FRAMED = 1
OP_DECOMPRESS = 2
OP_CRC32C_BATCH = 3
OP_ADLER32_BATCH = 4

_U32 = struct.Struct("<I")
_HDR = struct.Struct("<BI")

#: Refuse absurd batch shapes before allocating (defense against a confused
#: or malicious client writing garbage lengths). The byte cap bounds how much
#: one request can make the server buffer (the recv path materializes the
#: whole payload, roughly twice, before dispatch) — it is a DoS bound, not a
#: codec limit; multi-block batches above it are legitimate, and servers
#: expecting them should raise the cap per-instance or via
#: ``--max-request-bytes``.
MAX_BLOCKS = 1 << 20
MAX_TOTAL_BYTES = 1 << 28


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    parts = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            raise ConnectionError(f"peer closed mid-message ({got}/{n} bytes)")
        parts.append(chunk)
        got += len(chunk)
    return b"".join(parts)


def _read_message(
    sock: socket.socket, max_total_bytes: int = MAX_TOTAL_BYTES
) -> Optional[Tuple[int, List[bytes]]]:
    """Returns (op, blocks) or None on clean EOF before a message starts."""
    try:
        hdr = _recv_exact(sock, _HDR.size)
    except ConnectionError:
        return None
    op, n = _HDR.unpack(hdr)
    if n > MAX_BLOCKS:
        raise ValueError(f"block count {n} exceeds limit {MAX_BLOCKS}")
    lens_raw = _recv_exact(sock, 4 * n)
    lens = [_U32.unpack_from(lens_raw, 4 * i)[0] for i in range(n)]
    total = sum(lens)
    if total > max_total_bytes:
        raise ValueError(f"payload {total} exceeds limit {max_total_bytes}")
    payload = _recv_exact(sock, total)
    blocks, off = [], 0
    for ln in lens:
        blocks.append(payload[off : off + ln])
        off += ln
    return op, blocks


def _write_message(sock: socket.socket, status: int, blocks: List[bytes]) -> None:
    lens = b"".join(_U32.pack(len(b)) for b in blocks)
    sock.sendall(_HDR.pack(status, len(blocks)) + lens + b"".join(blocks))


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:  # one connection, many requests
        codec = self.server.codec  # type: ignore[attr-defined]
        max_total = getattr(self.server, "max_total_bytes", MAX_TOTAL_BYTES)
        while True:
            try:
                msg = _read_message(self.request, max_total)
            except (ConnectionError, OSError):
                return
            except ValueError as e:
                # Protocol-confused client (bad block count / payload size):
                # report and drop the connection — the stream position is
                # unrecoverable once we refuse to read the declared payload.
                logger.warning("bridge rejected request: %s", e)
                try:
                    _write_message(self.request, 1, [str(e).encode()])
                except OSError:
                    pass
                return
            if msg is None:
                return
            op, blocks = msg
            try:
                out = self._dispatch(codec, op, blocks)
                _write_message(self.request, 0, out)
            except BrokenPipeError:
                return
            except Exception as e:  # report to client, keep serving
                logger.warning("bridge op %d failed: %s", op, e)
                try:
                    _write_message(self.request, 1, [str(e).encode()])
                except OSError:
                    return

    @staticmethod
    def _dispatch(codec, op: int, blocks: List[bytes]) -> List[bytes]:
        import numpy as np

        if op == OP_COMPRESS_FRAMED:
            from s3shuffle_tpu_torch.codec.framing import MAX_FRAME_ULEN

            # Never emit a frame our own decoder (or OP_DECOMPRESS) rejects.
            for i, b in enumerate(blocks):
                if len(b) > MAX_FRAME_ULEN:
                    raise ValueError(
                        f"block {i} is {len(b)} bytes, exceeds the "
                        f"{MAX_FRAME_ULEN}-byte frame limit — split it"
                    )
            # one native batch call for the whole request, framing in Python
            out = bytearray()
            for raw, comp in zip(blocks, codec.compress_blocks(blocks)):
                out += codec.frame_from(raw, comp)
            return [bytes(out)]
        if op == OP_DECOMPRESS:
            if len(blocks) != 1:
                raise ValueError("DECOMPRESS takes one framed stream")
            return [codec.decompress_bytes(blocks[0])]
        if op in (OP_CRC32C_BATCH, OP_ADLER32_BATCH):
            concat = np.frombuffer(b"".join(blocks), dtype=np.uint8)
            offsets = np.zeros(len(blocks) + 1, dtype=np.int64)
            np.cumsum(
                np.fromiter(map(len, blocks), dtype=np.int64, count=len(blocks)),
                out=offsets[1:],
            )
            if op == OP_CRC32C_BATCH and hasattr(codec, "crc32c_batch"):
                sums = codec.crc32c_batch(concat, offsets).astype("<u4")
            elif op == OP_CRC32C_BATCH:
                # a codec without the batch entry (zlib, tpu): the native
                # library's batch CRC when it builds, else the port's own
                from s3shuffle_tpu_torch.codec import native

                if native.native_available():
                    sums = native.crc32c_batch(concat, offsets).astype("<u4")
                else:
                    from s3shuffle_tpu_torch.utils.checksums import crc32c

                    sums = np.array([crc32c(b, 0) for b in blocks], dtype="<u4")
            else:
                import zlib as _zlib

                sums = np.array([_zlib.adler32(b) for b in blocks], dtype="<u4")
            return [sums.tobytes()]
        raise ValueError(f"unknown op {op}")


class CodecBridgeServer:
    """Threaded TCP service exposing the port's codecs to external (JVM)
    clients. ``port=0`` picks a free port (see ``.port``); ``device`` places
    the ``tpu`` codec (the CUDA device by default)."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        codec_name: str = "native",
        max_total_bytes: int = MAX_TOTAL_BYTES,
        device=None,
    ):
        from s3shuffle_tpu_torch.codec import get_codec

        try:
            codec = get_codec(codec_name, device=device)
        except Exception as e:
            raise ValueError(f"codec {codec_name!r} unavailable: {e}") from e
        if codec is None:
            raise ValueError(f"codec {codec_name!r} unavailable")

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server((host, port), _Handler)
        self.codec = codec
        self._server.codec = codec  # type: ignore[attr-defined]
        self._server.max_total_bytes = max_total_bytes  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> "CodecBridgeServer":
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        logger.info("codec bridge serving on port %d", self.port)
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=5)


class CodecBridgeClient:
    """Reference client (and the shape of the JVM-side implementation).

    ``max_reply_bytes`` bounds reply buffering; it defaults far above the
    server's request cap because replies legitimately outgrow requests
    (DECOMPRESS inflates, COMPRESS_FRAMED adds per-frame headers).
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        max_reply_bytes: int = 1 << 31,
    ):
        self._sock = socket.create_connection((host, port))
        self._max_reply_bytes = max_reply_bytes

    def _call(self, op: int, blocks: List[bytes]) -> List[bytes]:
        _write_message(self._sock, op, blocks)
        msg = _read_message(self._sock, self._max_reply_bytes)
        if msg is None:
            raise ConnectionError("bridge closed the connection")
        status, out = msg
        if status != 0:
            raise RuntimeError(f"bridge error: {out[0].decode(errors='replace')}")
        return out

    def compress_framed(self, blocks: List[bytes]) -> bytes:
        return self._call(OP_COMPRESS_FRAMED, blocks)[0]

    def decompress(self, framed: bytes) -> bytes:
        return self._call(OP_DECOMPRESS, [framed])[0]

    def crc32c(self, blocks: List[bytes]) -> List[int]:
        import numpy as np

        raw = self._call(OP_CRC32C_BATCH, blocks)[0]
        return np.frombuffer(raw, dtype="<u4").tolist()

    def adler32(self, blocks: List[bytes]) -> List[int]:
        import numpy as np

        raw = self._call(OP_ADLER32_BATCH, blocks)[0]
        return np.frombuffer(raw, dtype="<u4").tolist()

    def close(self) -> None:
        self._sock.close()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="s3shuffle_tpu_torch codec bridge service")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7717)
    ap.add_argument("--codec", default="native")
    ap.add_argument(
        "--device",
        default=None,
        help="device of the tpu codec: cuda (the default), cuda:N or cpu",
    )
    ap.add_argument(
        "--max-request-bytes",
        type=int,
        default=MAX_TOTAL_BYTES,
        help="reject requests whose total payload exceeds this many bytes",
    )
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    server = CodecBridgeServer(
        args.host, args.port, args.codec, max_total_bytes=args.max_request_bytes,
        device=args.device,
    ).start()
    print(f"codec bridge on {args.host}:{server.port} (codec={args.codec})", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
