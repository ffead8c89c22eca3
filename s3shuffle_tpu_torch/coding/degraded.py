"""Degraded reads: loss reconstruction (the JAX package's
``coding/degraded.py``, its loss trigger).

When a data-object GET dies with ``FileNotFoundError`` (the object is lost,
not slow), :class:`~s3shuffle_tpu_torch.read.block_stream.BlockStream` asks
:meth:`DegradedReader.reconstruct` for the missing byte range before it
falls back to the logged EOF that the checksum layer reports as a
``ChecksumError``. Reconstruction is unconditional: if the survivors
suffice the read completes with the same bytes (validated by the unchanged
per-block checksums); if not, the behaviour is that of an uncoded shuffle.

Per stripe group: read the group's parity slices (ranged GETs against the
parity sidecars, one span per sidecar for the whole range), solve
parity-only when that determines the group, otherwise fill in with sibling
data chunks from the data object while it is still readable. Sources that
fail shrink the survivor set; too few survivors return None.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from s3shuffle_tpu_torch.coding import gf
from s3shuffle_tpu_torch.coding.parity import (
    HEADER_BYTES,
    ParityGeometry,
    parity_blocks_for,
    parse_parity_header,
)
from s3shuffle_tpu_torch.device import on_device

logger = logging.getLogger("s3shuffle_tpu_torch.coding")


class DegradedReader:
    """Per-reader reconstruction engine over the registered geometries.

    Geometry is registered from the index each block read fetches anyway,
    keyed by the data object. An empty reader is inert: ``has`` is False
    everywhere and every reconstruct returns None. ``device`` is where the
    survivors' parity contribution is encoded (K4 on the CUDA device);
    ``reconstructions`` counts the byte ranges served from parity.
    :meth:`reconstruct` may run on a prefetch thread: it selects
    ``device`` on that thread and synchronises it before the bytes are
    handed over."""

    def __init__(self, dispatcher, device=None):
        self.dispatcher = dispatcher
        self.device = device
        self.reconstructions = 0
        self._lock = threading.Lock()
        self._geoms: Dict[str, tuple] = {}  # data object name -> (data_block, geometry)

    def register(self, data_block, geometry: Optional[ParityGeometry]) -> None:
        if geometry is None or geometry.segments <= 0:
            return
        with self._lock:
            self._geoms[data_block.name] = (data_block, geometry)

    def note(self, helper, shuffle_id: int, map_id: int) -> None:
        """Register one map output's geometry through the helper (or the
        scan's memo, where the location is already resolved)."""
        try:
            loc = helper.resolve_map_location(shuffle_id, map_id)
        except (OSError, ValueError):
            return
        self.register(loc.data_block, loc.parity)

    def has(self, data_block) -> bool:
        name = getattr(data_block, "name", None)
        if name is None:
            return False
        with self._lock:
            return name in self._geoms

    def geometry_of(self, data_block) -> Optional[ParityGeometry]:
        name = getattr(data_block, "name", None)
        if name is None:
            return None
        with self._lock:
            entry = self._geoms.get(name)
        return None if entry is None else entry[1]

    def __bool__(self) -> bool:
        with self._lock:
            return bool(self._geoms)

    def reconstruct(self, data_block, start: int, end: int, reason: str = "loss") -> Optional[bytes]:
        """Rebuild the byte range ``[start, end)`` of ``data_block`` from
        parity (+ surviving sibling chunks). None when the object carries no
        parity or the survivors are insufficient: the caller then falls back
        to the uncoded behaviour."""
        with self._lock:
            entry = self._geoms.get(getattr(data_block, "name", ""))
        if entry is None:
            return None
        block, geom = entry
        end = min(end, geom.payload_len)
        if end <= start:
            return b""
        try:
            with on_device(self.device):
                out = self._reconstruct_range(block, geom, start, end)
        except (OSError, ValueError):  # a store or wire fault: best effort
            logger.warning(
                "parity reconstruction of %s [%d,%d) failed", block.name, start, end,
                exc_info=True,
            )
            return None
        if out is not None:
            with self._lock:
                self.reconstructions += 1
            logger.warning(
                "reconstructed %s [%d,%d) from parity (%s)", block.name, start, end, reason
            )
        return out

    def _reconstruct_range(self, block, geom: ParityGeometry, start: int, end: int) -> Optional[bytes]:
        c0 = start // geom.chunk_bytes
        c1 = (end - 1) // geom.chunk_bytes
        coefs = gf.parity_coefficients(geom.segments, geom.stripe_k)
        parity_readers = _ParityHandles(self.dispatcher, block, geom)
        parity_readers.prefetch_span(c0 // geom.stripe_k, c1 // geom.stripe_k)
        data_reader = _DataHandle(self.dispatcher, block, geom)
        try:
            chunks: Dict[int, np.ndarray] = {}
            for group in range(c0 // geom.stripe_k, c1 // geom.stripe_k + 1):
                member_lo = group * geom.stripe_k
                member_hi = min(member_lo + geom.stripe_k, geom.n_chunks)
                want = [c - member_lo for c in range(max(c0, member_lo), min(c1 + 1, member_hi))]
                if not want:
                    continue
                plen = geom.group_parity_len(group)
                parity_present = parity_readers.read_group(group, plen)
                # the encoder zero-pads a short final group to k chunks:
                # those phantom positions are known zero survivors, so a tail
                # group needs only as many parity slices as it has real chunks
                known: Dict[int, np.ndarray] = {
                    j: np.zeros(plen, dtype=np.uint8)
                    for j in range(member_hi - member_lo, geom.stripe_k)
                }
                # parity (+ phantoms) first; sibling data chunks only when
                # that cannot determine the group
                recovered = gf.recover_group(
                    geom.stripe_k, coefs, dict(known), parity_present, want, self.device
                )
                if recovered is None:
                    known.update(data_reader.read_chunks(
                        group, [j for j in range(member_hi - member_lo) if j not in want], plen,
                    ))
                    recovered = gf.recover_group(
                        geom.stripe_k, coefs, known, parity_present, want, self.device
                    )
                if recovered is None:
                    logger.warning(
                        "cannot reconstruct %s stripe group %d: %d parity + %d "
                        "sibling survivors for %d missing chunk(s)",
                        block.name, group, len(parity_present),
                        data_reader.last_count, len(want),
                    )
                    return None
                for pos, data in recovered.items():
                    chunks[member_lo + pos] = data
            parts = []
            for c in range(c0, c1 + 1):
                lo, hi = geom.chunk_span(c)
                chunk = chunks[c][: hi - lo]
                parts.append(bytes(chunk[max(start, lo) - lo : min(end, hi) - lo]))
            return b"".join(parts)
        finally:
            parity_readers.close()
            data_reader.close()


class _ParityHandles:
    """Lazy ranged readers over one data object's parity sidecars, with the
    self-describing header cross-checked on first open."""

    def __init__(self, dispatcher, data_block, geom: ParityGeometry):
        self.dispatcher = dispatcher
        self.geom = geom
        self.blocks = parity_blocks_for(data_block, geom.segments)
        self._readers: Dict[int, object] = {}
        self._dead: set = set()
        self._span_bounds: Optional[Tuple[int, int]] = None
        self._spans: Dict[int, bytes] = {}
        self._span_failed: set = set()

    def prefetch_span(self, g_lo: int, g_hi: int) -> None:
        """Arm one contiguous ranged GET per parity object covering every
        group of the reconstruction [g_lo, g_hi]: the touched slices are
        adjacent in the sidecar, so one round trip serves them all."""
        lo = self.geom.parity_chunk_offset(g_lo)
        hi = self.geom.parity_chunk_offset(g_hi) + self.geom.group_parity_len(g_hi)
        if hi > lo:
            self._span_bounds = (lo, hi)

    def _from_span(self, seg: int, offset: int, plen: int) -> Optional[bytes]:
        if self._span_bounds is None or seg in self._span_failed:
            return None
        lo, hi = self._span_bounds
        if offset < lo or offset + plen > hi:
            return None
        span = self._spans.get(seg)
        if span is None:
            reader = self._reader(seg)
            if reader is None:
                return None
            try:
                span = reader.read_fully(lo, hi - lo)
            except OSError as e:
                logger.warning(
                    "parity span read %s [%d,%d) failed: %s — degrading to "
                    "per-group reads", self.blocks[seg].name, lo, hi, e,
                )
                self._span_failed.add(seg)
                return None
            if len(span) != hi - lo:
                self._span_failed.add(seg)
                return None
            self._spans[seg] = span
        o = offset - lo
        return span[o : o + plen]

    def _reader(self, seg: int):
        if seg in self._dead:
            return None
        reader = self._readers.get(seg)
        if reader is None:
            try:
                reader = self.dispatcher.backend.open_ranged(
                    self.dispatcher.get_path(self.blocks[seg])
                )
                header = parse_parity_header(reader.read_fully(0, HEADER_BYTES))
                if header != self.geom:
                    raise ValueError(
                        f"parity object {self.blocks[seg].name} geometry "
                        f"{header} != recorded {self.geom}"
                    )
            except (OSError, ValueError) as e:
                logger.warning("parity segment %s unavailable: %s", self.blocks[seg].name, e)
                if reader is not None:
                    reader.close()
                self._dead.add(seg)
                return None
            self._readers[seg] = reader
        return reader

    def read_group(self, group: int, plen: int) -> Dict[int, np.ndarray]:
        out: Dict[int, np.ndarray] = {}
        offset = self.geom.parity_chunk_offset(group)
        for seg in range(self.geom.segments):
            data = self._from_span(seg, offset, plen)
            if data is None:
                reader = self._reader(seg)
                if reader is None:
                    continue
                try:
                    data = reader.read_fully(offset, plen)
                except OSError as e:
                    logger.warning(
                        "parity read %s group %d failed: %s", self.blocks[seg].name, group, e
                    )
                    continue
            if len(data) == plen:
                out[seg] = np.frombuffer(data, dtype=np.uint8)
        return out

    def close(self) -> None:
        for reader in self._readers.values():
            try:
                reader.close()
            except OSError:
                pass
        self._readers = {}


class _DataHandle:
    """Lazy ranged reader over the data object itself, the source of
    sibling chunks for a partial-range reconstruction; every failure just
    shrinks the survivor set (the object may be lost entirely)."""

    def __init__(self, dispatcher, data_block, geom: ParityGeometry):
        self.dispatcher = dispatcher
        self.block = data_block
        self.geom = geom
        self._reader = None
        self._dead = False
        self.last_count = 0

    def read_chunks(self, group: int, positions, plen: int) -> Dict[int, np.ndarray]:
        out: Dict[int, np.ndarray] = {}
        self.last_count = 0
        if self._dead:
            return out
        if self._reader is None:
            try:
                self._reader = self.dispatcher.backend.open_ranged(
                    self.dispatcher.get_path(self.block)
                )
            except OSError as e:
                logger.warning(
                    "data object %s unavailable for sibling reads: %s", self.block.name, e
                )
                self._dead = True
                return out
        base = group * self.geom.stripe_k
        for j in positions:
            lo, hi = self.geom.chunk_span(base + j)
            if hi <= lo:
                continue
            try:
                data = self._reader.read_fully(lo, hi - lo)
            except OSError:
                continue
            if len(data) != hi - lo:
                continue
            chunk = np.zeros(plen, dtype=np.uint8)
            chunk[: len(data)] = np.frombuffer(data, dtype=np.uint8)
            out[j] = chunk
        self.last_count = len(out)
        return out

    def close(self) -> None:
        if self._reader is not None:
            try:
                self._reader.close()
            except OSError:
                pass
            self._reader = None
