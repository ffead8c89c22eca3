"""Byte-stream helpers (the JAX package's ``utils/io.py``)."""

from __future__ import annotations

from typing import BinaryIO


def read_fully(source: BinaryIO, n: int) -> bytes:
    """Read up to ``n`` bytes, looping over short reads; short only at EOF."""
    chunks = []
    remaining = n
    while remaining > 0:
        chunk = source.read(remaining)
        if not chunk:
            break
        chunks.append(chunk)
        remaining -= len(chunk)
    return b"".join(chunks)


def read_fully_view(source, n: int):
    """Like :func:`read_fully` but prefers the source's zero-copy ``readview``
    when it has one: a single satisfying piece is returned as is (bytes,
    memoryview or uint8 ndarray — all support the buffer protocol);
    multi-piece reads fall back to one joined bytes. Callers treat the
    result as a read-only buffer."""
    reader = getattr(source, "readview", None)
    if reader is None:
        return read_fully(source, n)
    first = reader(n)
    if len(first) == n or len(first) == 0:
        return first
    chunks = [first]
    remaining = n - len(first)
    while remaining > 0:
        chunk = reader(remaining)
        if not len(chunk):
            break
        chunks.append(chunk)
        remaining -= len(chunk)
    return b"".join(chunks)
