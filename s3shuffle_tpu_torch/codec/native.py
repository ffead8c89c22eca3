"""Host codecs of the port's native library: SLZ (frame id 3) and the LZ4
block format (frame id 5), bound with ``ctypes`` as in the JAX package's
``codec/native.py``.

The library is the port's own copy of the JAX package's C++ source
(``s3shuffle_tpu_torch/native/s3shuffle_native.cpp``). It is built on first
use with ``g++`` and the flags of the JAX package's ``native/Makefile`` into
``build/native/`` at the repository root, and rebuilt when the source is
newer than the built library (a library left from an older source could
misread the arguments of a changed C entry). The build writes to a
temporary file in that directory and renames it into place, so processes
that build at the same time agree. The JAX package's library is never
loaded. A failed build or load is kept and raised again on every later
call, so a hot path never re-runs the compiler.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

from s3shuffle_tpu_torch.codec.framing import CODEC_IDS, FrameCodec

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "s3shuffle_native.cpp"
BUILD_DIR = _PKG.parent / "build" / "native"
LIBRARY = BUILD_DIR / "libs3shuffle_native.so"
#: s3shuffle_tpu/native/Makefile's CXXFLAGS; -march=native is added where
#: the compiler takes it, as the Makefile does
CXXFLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall", "-Wextra"]

_lib = None
_lib_error: Exception | None = None
_lib_lock = threading.Lock()
#: wall seconds of this process's build (0.0 when the library was current)
build_seconds = 0.0

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I64P = ctypes.POINTER(ctypes.c_int64)
#: C entry suffix → (restype, argtypes), the same for the slz_ and lz4_
#: families
_SIGNATURES = {
    "compress": (ctypes.c_size_t, [_U8P, ctypes.c_size_t, _U8P, ctypes.c_size_t]),
    "decompress": (ctypes.c_size_t, [_U8P, ctypes.c_size_t, _U8P, ctypes.c_size_t]),
    "decompress_batch": (None, [_U8P, _I64P, ctypes.c_int64, _U8P, _I64P, _I64P]),
    "compress_framed": (
        ctypes.c_int64, [_U8P, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint8, _U8P]
    ),
}


def _compiler() -> str:
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native host codecs cannot be built")
    return cxx


def _build() -> None:
    """Compile the source into :data:`LIBRARY` (temporary file, then an
    atomic rename)."""
    global build_seconds
    cxx = _compiler()
    march = subprocess.run(
        [cxx, "-march=native", "-E", "-x", "c++", os.devnull],
        capture_output=True, check=False, timeout=60,
    )
    flags = CXXFLAGS + (["-march=native"] if march.returncode == 0 else [])
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        t0 = time.perf_counter()
        res = subprocess.run(
            [cxx, *flags, "-o", tmp, str(SOURCE)],
            capture_output=True, text=True, check=False, timeout=300,
        )
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{res.stdout}{res.stderr}")
        os.replace(tmp, LIBRARY)
        build_seconds = time.perf_counter() - t0
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _stale() -> bool:
    return not LIBRARY.exists() or SOURCE.stat().st_mtime > LIBRARY.stat().st_mtime


def _load() -> ctypes.CDLL:
    global _lib, _lib_error
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _lib_error is not None:
            raise _lib_error
        try:
            if _stale():
                _build()
            lib = ctypes.CDLL(str(LIBRARY))
            for prefix in ("slz", "lz4"):
                for suffix, (restype, argtypes) in _SIGNATURES.items():
                    fn = getattr(lib, f"{prefix}_{suffix}")
                    fn.restype = restype
                    fn.argtypes = argtypes
        except Exception as e:
            _lib_error = e
            raise
        _lib = lib
        return lib


def native_available() -> bool:
    """True when the library builds (or is current) and loads."""
    try:
        _load()
        return True
    except Exception:
        return False


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(_U8P)


def _ptr64(arr: np.ndarray):
    return arr.ctypes.data_as(_I64P)


class NativeLZCodec(FrameCodec):
    """SLZ, the C++ greedy LZ77 block codec.

    ``batch_blocks`` makes :class:`~s3shuffle_tpu_torch.codec.framing.CodecOutputStream`
    accumulate full blocks and compress and frame them in one
    ``compress_framed`` call: one ctypes crossing per batch instead of one
    per 64 KiB block."""

    name = "native-lz"
    codec_id = CODEC_IDS["native-lz"]
    batch_blocks = 64
    #: native symbol family; NativeLZ4Codec swaps it
    _prefix = "slz"

    def __init__(self, block_size: int = 64 * 1024):
        super().__init__(block_size)
        self._lib = _load()
        pre = self._prefix
        self._c_compress = getattr(self._lib, f"{pre}_compress")
        self._c_decompress = getattr(self._lib, f"{pre}_decompress")
        self._c_decompress_batch = getattr(self._lib, f"{pre}_decompress_batch")
        self._c_compress_framed = getattr(self._lib, f"{pre}_compress_framed")

    def compress_block(self, data: bytes) -> bytes:
        n = len(data)
        if n == 0:
            return b"\x00"  # varint 0 literals (valid empty block)
        src = ctypes.cast(ctypes.c_char_p(bytes(data)), _U8P)
        dst = ctypes.create_string_buffer(n)  # no shrink: framing stores raw
        clen = self._c_compress(src, n, ctypes.cast(dst, _U8P), n)
        if clen == 0:
            return data  # incompressible: framing's raw escape triggers
        return ctypes.string_at(dst, clen)

    def decompress_block(self, data: bytes, uncompressed_len: int) -> bytes:
        src = ctypes.cast(ctypes.c_char_p(bytes(data)), _U8P)
        dst = ctypes.create_string_buffer(max(1, uncompressed_len))
        n = self._c_decompress(src, len(data), ctypes.cast(dst, _U8P), uncompressed_len)
        if n != uncompressed_len:
            raise IOError(
                f"{self.name} decompression produced {n} bytes, "
                f"expected {uncompressed_len}"
            )
        return ctypes.string_at(dst, uncompressed_len)

    def compress_framed(self, buf, n_blocks: int, block_size: int) -> bytes:
        """Compress ``n_blocks`` equal-size blocks of one contiguous buffer
        and return them framed (headers and payloads back to back, raw escape
        applied) in one native call."""
        src = np.ascontiguousarray(
            np.frombuffer(buf, dtype=np.uint8, count=n_blocks * block_size)
        )
        dst = np.empty(n_blocks * (block_size + 9), dtype=np.uint8)
        total = self._c_compress_framed(_ptr(src), n_blocks, block_size,
                                        self.codec_id, _ptr(dst))
        return dst[:total].tobytes()

    def decompress_blocks(self, blocks):
        """One native call for a run of frames."""
        n = len(blocks)
        if n <= 1:
            return [self.decompress_block(b, ulen) for b, ulen in blocks]
        dst, dst_off = self._decompress_batch(blocks)
        return [dst[dst_off[i] : dst_off[i + 1]].tobytes() for i in range(n)]

    def decompress_blocks_concat(self, blocks):
        """A run of frames decoded into one contiguous buffer, handed back
        whole as a read-only uint8 ndarray: no per-block slices and no bytes
        copy (``CodecInputStream.readview`` serves views of it; the
        read-only flag keeps a stray write from reaching sibling frames)."""
        if len(blocks) == 1:
            return self.decompress_block(*blocks[0])
        dst, dst_off = self._decompress_batch(blocks)
        dst.setflags(write=False)
        return dst[: int(dst_off[-1])]

    def _decompress_batch(self, blocks):
        # the batch decoder copies in 16-byte strides: both buffers carry
        # 16 bytes of slack
        n = len(blocks)
        src = np.frombuffer(b"".join([*(bytes(b) for b, _ in blocks), b"\x00" * 16]),
                            dtype=np.uint8)
        src_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.fromiter((len(b) for b, _ in blocks), dtype=np.int64, count=n),
                  out=src_off[1:])
        ulens = np.fromiter((u for _, u in blocks), dtype=np.int64, count=n)
        dst_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(ulens, out=dst_off[1:])
        dst = np.empty(int(dst_off[-1]) + 16, dtype=np.uint8)
        out_sizes = np.zeros(n, dtype=np.int64)
        self._c_decompress_batch(_ptr(src), _ptr64(src_off), n, _ptr(dst),
                                 _ptr64(dst_off), _ptr64(out_sizes))
        if not (out_sizes == ulens).all():
            bad = int(np.nonzero(out_sizes != ulens)[0][0])
            raise IOError(
                f"{self.name} batch decompression: block {bad} produced "
                f"{int(out_sizes[bad])} bytes, expected {int(ulens[bad])}"
            )
        return dst, dst_off


class NativeLZ4Codec(NativeLZCodec):
    """The LZ4 block format (a public interchange format) behind the shared
    framing: the same greedy hash-chain matcher as SLZ with LZ4's sequence
    encoding and end-of-block rules."""

    name = "lz4"
    codec_id = CODEC_IDS["lz4"]
    _prefix = "lz4"
