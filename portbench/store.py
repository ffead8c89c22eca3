"""Counts what reaches the store, beneath the port's retry layer.

``CountingBackend`` is a frozen copy of ``chip_smoke.py``'s: it counts the
positioned reads (GETs), LIST calls, status calls and creates by object
kind; this copy also counts renames into the store, the bytes written to
each created object and, when asked, the frames of the data objects as
their bytes pass (``[u8 codec id][u32le raw length][u32le stored
length][payload]``, the wire format of the port's ``codec/framing.py``).
``count_store`` installs it beneath the dispatcher's retry layer, as
``chip_smoke.py``'s ``count_store`` does, so each re-driven attempt counts.
"""

from __future__ import annotations

import collections
import os
import struct
import threading

HEADER = struct.Struct("<BII")
#: the codec id of the TLZ frames the port's ``tpu`` codec writes
TLZ_ID = 4


class CountingBackend:
    KINDS = (".data", ".index", ".checksum", ".parity")

    def __init__(self, inner, frames: bool = False):
        self._inner = inner
        self.frames = frames
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self.gets = collections.Counter()
            self.statuses = collections.Counter()
            self.creates = collections.Counter()
            self.created_bytes = collections.Counter()
            self.renames = 0
            #: raw and stored payload bytes of every frame written, and of
            #: the TLZ frames alone
            self.frame_bytes = collections.Counter()

    def requests(self) -> int:
        """Creates, renames, GETs (LIST calls among them) and status calls."""
        with self._lock:
            return (sum(self.creates.values()) + self.renames + sum(self.gets.values())
                    + sum(self.statuses.values()))

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _kind(self, path):
        name = path.rsplit("/", 1)[-1]
        if "_comp_" in name:
            return "comp-" + ("parity" if name.endswith(".parity") else name.rsplit(".", 1)[1])
        return next((k[1:] for k in self.KINDS if k in name), "other")

    def create(self, path):
        kind = self._kind(path)
        with self._lock:
            self.creates[kind] += 1
        parser = _FrameParser(self) if self.frames and kind == "data" else None
        return _CountingWriter(self, kind, self._inner.create(path), parser)

    def rename(self, src, dst):
        size = os.path.getsize(src[len("file://"):]) if src.startswith("file://") else 0
        with self._lock:
            self.renames += 1
            self.created_bytes[self._kind(dst)] += size
        return self._inner.rename(src, dst)

    def open_ranged(self, path, size_hint=None):
        return _CountingReader(self, self._kind(path), self._inner.open_ranged(path, size_hint))

    def read_all(self, path):
        with self.open_ranged(path) as r:
            return r.read_fully(0, r.size)

    def status(self, path):
        with self._lock:
            self.statuses[self._kind(path)] += 1
        return self._inner.status(path)

    def list_prefix(self, prefix):
        with self._lock:
            self.gets["list"] += 1
        return self._inner.list_prefix(prefix)


class _FrameParser:
    """Walks the frames of a data object as its bytes are written."""

    def __init__(self, owner: CountingBackend):
        self._owner = owner
        self._head = b""
        self._skip = 0

    def feed(self, b: bytes) -> None:
        pos, n = 0, len(b)
        while pos < n:
            if self._skip:
                step = min(self._skip, n - pos)
                self._skip -= step
                pos += step
                continue
            need = HEADER.size - len(self._head)
            self._head += bytes(b[pos: pos + need])
            pos += min(need, n - pos)
            if len(self._head) == HEADER.size:
                codec_id, raw, stored = HEADER.unpack(self._head)
                self._head = b""
                self._skip = stored
                with self._owner._lock:
                    counts = self._owner.frame_bytes
                    counts["raw"] += raw
                    counts["stored"] += stored
                    counts["frames"] += 1
                    if codec_id == TLZ_ID:
                        counts["tlz_raw"] += raw
                        counts["tlz_stored"] += stored


class _CountingWriter:
    def __init__(self, owner, kind, inner, parser):
        self._owner, self._kind, self._inner, self._parser = owner, kind, inner, parser

    def write(self, b):
        n = memoryview(b).nbytes
        if self._parser is not None:
            self._parser.feed(memoryview(b).cast("B"))
        with self._owner._lock:
            self._owner.created_bytes[self._kind] += n
        return self._inner.write(b)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._inner.close()


class _CountingReader:
    def __init__(self, owner: CountingBackend, kind: str, inner):
        self._owner, self._kind, self._inner = owner, kind, inner

    @property
    def size(self):
        return self._inner.size

    def read_fully(self, position: int, length: int) -> bytes:
        with self._owner._lock:
            self._owner.gets[self._kind] += 1
        return self._inner.read_fully(position, length)

    def close(self):
        self._inner.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def retry_layer(dispatcher):
    """The dispatcher's retry layer: its backend (the port stacks it by
    default, and nothing above it while its metrics registry, tracer and
    protocol witness are off, as they are here)."""
    from s3shuffle_tpu_torch.storage.retrying import RetryingBackend

    top = dispatcher.backend
    if not isinstance(top, RetryingBackend):
        raise RuntimeError(f"expected the port's retry layer on top, found {type(top).__name__}")
    return top


def count_store(dispatcher, frames: bool = False) -> CountingBackend:
    """Install a :class:`CountingBackend` beneath the dispatcher's retry
    layer, so its counts are requests that reach the store."""
    top = retry_layer(dispatcher)
    counting = CountingBackend(top.inner, frames=frames)
    top.inner = counting
    return counting
