"""Parity sidecar objects: geometry, wire format, and the streaming encoder
(the JAX package's ``coding/parity.py``).

Every data object written with ``parity_segments = m > 0`` — a per-map
object, or a composite object whose parity is encoded over the group's
stored bytes as the members are appended (write/composite_commit.py) —
gets m parity sidecar objects:

- the payload is striped into fixed ``parity_chunk_bytes`` chunks; each run
  of ``parity_stripe_k = k`` consecutive chunks is one **stripe group**;
- parity object *i* holds, per group, one chunk-sized parity slice
  ``P_i = XOR_j gfmul(C[i][j], chunk_j)`` (coding/gf.py) at a fixed offset
  (``header + group * chunk_bytes``), so a degraded read fetches exactly the
  parity slices its byte range needs with ranged GETs;
- the accumulator sees the stored bytes in commit order, closes a group
  every k full chunks, and encodes closed groups ``ENCODE_BATCH_GROUPS`` at
  a time in one batched ``encode_groups`` call (kernel K4).

The parity objects are committed by the index (a composite's by its fat
index): they are PUT after the data object and before the index, so a crash leaves orphans, never a half-coded
committed output. Each PUT is re-driven whole after a transient failure, as
the index and checksum sidecars are. A byte range missing at most m chunks
per stripe group reconstructs from the survivors; losing the whole data
object erases all k data chunks of every group, so whole-object loss needs
``m >= k``.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional, Sequence

import numpy as np

from s3shuffle_tpu_torch.block_ids import (
    BlockId,
    ShuffleCompositeDataBlockId,
    ShuffleCompositeParityBlockId,
    ShuffleParityBlockId,
)
from s3shuffle_tpu_torch.coding import gf
from s3shuffle_tpu_torch.storage.retrying import retry_call

logger = logging.getLogger("s3shuffle_tpu_torch.coding")

#: "S3PARITY"-shaped int64 — first word of every parity object
PARITY_MAGIC = 0x5333504152495459
_WIRE_VERSION = 1
#: [magic, version, shuffle_id, seg_index, m, k, chunk_bytes, payload_len]
HEADER_WORDS = 8
HEADER_BYTES = HEADER_WORDS * 8

#: magic word of the stripe-geometry trailer appended to per-map ``.index``
#: objects when parity is on: ``[GEOMETRY_MAGIC, m, k, chunk_bytes]`` after
#: the cumulative offsets (metadata/helper.py parses it back out)
GEOMETRY_MAGIC = 0x5333504152474D54  # "S3PARGMT"
#: trailer width in int64 words
TRAILER_WORDS = 4

#: closed stripe groups buffered before one batched encode call
ENCODE_BATCH_GROUPS = 16


@dataclasses.dataclass(frozen=True)
class ParityGeometry:
    """How one data object's payload is striped: what a reader needs to
    plan a degraded read (recorded in the index trailer and in every parity
    object's header)."""

    segments: int  # m parity objects
    stripe_k: int  # k data chunks per stripe group
    chunk_bytes: int
    payload_len: int

    @property
    def n_chunks(self) -> int:
        return -(-self.payload_len // self.chunk_bytes) if self.payload_len else 0

    @property
    def n_groups(self) -> int:
        return -(-self.n_chunks // self.stripe_k) if self.n_chunks else 0

    def chunk_span(self, index: int) -> tuple:
        """[start, end) byte range of data chunk ``index`` in the payload."""
        start = index * self.chunk_bytes
        return start, min(start + self.chunk_bytes, self.payload_len)

    def group_parity_len(self, group: int) -> int:
        """Length of one parity chunk for stripe group ``group``: the size
        of the group's largest (first) data chunk."""
        first = group * self.stripe_k * self.chunk_bytes
        return min(self.chunk_bytes, self.payload_len - first)

    def parity_chunk_offset(self, group: int) -> int:
        """Byte offset of group ``group``'s slice inside a parity object
        (groups before the last are always full ``chunk_bytes``)."""
        return HEADER_BYTES + group * self.chunk_bytes


def parity_blocks_for(data_block: BlockId, segments: int) -> List[BlockId]:
    """The parity sidecar ids of one data object (per-map or composite)."""
    if isinstance(data_block, ShuffleCompositeDataBlockId):
        return [
            ShuffleCompositeParityBlockId(data_block.shuffle_id, data_block.group_id, i)
            for i in range(segments)
        ]
    return [
        ShuffleParityBlockId(data_block.shuffle_id, data_block.map_id, i)  # type: ignore[attr-defined]
        for i in range(segments)
    ]


def parity_header(data_block: BlockId, geometry: ParityGeometry, seg: int) -> bytes:
    words = np.array(
        [
            PARITY_MAGIC, _WIRE_VERSION,
            data_block.shuffle_id,  # type: ignore[attr-defined]
            seg, geometry.segments, geometry.stripe_k,
            geometry.chunk_bytes, geometry.payload_len,
        ],
        dtype=np.int64,
    )
    return np.ascontiguousarray(words, dtype=">i8").tobytes()


def parse_parity_header(data: bytes) -> ParityGeometry:
    if len(data) < HEADER_BYTES:
        raise ValueError(f"parity header too short: {len(data)} bytes")
    words = np.frombuffer(data[:HEADER_BYTES], dtype=">i8").astype(np.int64)
    if int(words[0]) != PARITY_MAGIC:
        raise ValueError("parity object has wrong magic")
    if int(words[1]) != _WIRE_VERSION:
        raise ValueError(f"parity wire version {int(words[1])} != {_WIRE_VERSION}")
    return ParityGeometry(
        segments=int(words[4]), stripe_k=int(words[5]),
        chunk_bytes=int(words[6]), payload_len=int(words[7]),
    )


class ParityAccumulator:
    """Streaming chunked parity encoder: the write path's tee.

    Feed the data object's bytes in commit order through :meth:`update`;
    :meth:`finish` flushes the final (possibly partial) group and returns
    the m parity payloads (header excluded). Closed groups are encoded
    ``ENCODE_BATCH_GROUPS`` at a time on ``device`` (kernel K4 on the CUDA
    device); the final short group is encoded alone at its own (shorter)
    chunk length."""

    def __init__(self, segments: int, stripe_k: int, chunk_bytes: int, device=None):
        if segments < 1 or stripe_k < 1 or chunk_bytes < 1:
            raise ValueError("parity accumulator needs m, k, chunk_bytes >= 1")
        self.segments = int(segments)
        self.stripe_k = int(stripe_k)
        self.chunk_bytes = int(chunk_bytes)
        self.device = device
        self.payload_len = 0
        self._coefs = gf.parity_coefficients(self.segments, self.stripe_k)
        self._chunk = bytearray()  # current partial chunk
        self._group: List[np.ndarray] = []  # full chunks of the open group
        self._pending: List[List[np.ndarray]] = []  # closed full-size groups
        self._parity = [bytearray() for _ in range(self.segments)]
        self._finished = False

    def update(self, b) -> None:
        data = memoryview(b).cast("B") if not isinstance(b, (bytes, bytearray)) else b
        n = len(data)
        if n == 0:
            return
        self.payload_len += n
        pos = 0
        while pos < n:
            take = min(self.chunk_bytes - len(self._chunk), n - pos)
            self._chunk += data[pos : pos + take]
            pos += take
            if len(self._chunk) == self.chunk_bytes:
                self._group.append(np.frombuffer(bytes(self._chunk), dtype=np.uint8))
                self._chunk = bytearray()
                if len(self._group) == self.stripe_k:
                    self._pending.append(self._group)
                    self._group = []
                    if len(self._pending) >= ENCODE_BATCH_GROUPS:
                        self._encode_pending()

    def _encode_pending(self) -> None:
        if not self._pending:
            return
        batch = np.stack([np.stack(g) for g in self._pending])  # [G, k, L]
        self._pending = []
        parity = gf.encode_groups(batch, self._coefs, self.device)  # [G, m, L]
        for i in range(self.segments):
            self._parity[i] += parity[:, i, :].tobytes()

    def _encode_tail(self) -> None:
        """Encode the final short group: chunks zero-padded to the group's
        largest (first) chunk length, which the parity slice takes (K4
        takes any length, so no pad to the full chunk size)."""
        if self._chunk:
            self._group.append(np.frombuffer(bytes(self._chunk), dtype=np.uint8))
            self._chunk = bytearray()
        if not self._group:
            return
        length = len(self._group[0])
        padded = np.zeros((1, self.stripe_k, length), dtype=np.uint8)
        for j, chunk in enumerate(self._group):
            padded[0, j, : len(chunk)] = chunk
        self._group = []
        parity = gf.encode_groups(padded, self._coefs, self.device)
        for i in range(self.segments):
            self._parity[i] += parity[0, i, :].tobytes()

    def finish(self) -> List[bytes]:
        """Flush everything; returns the m parity payloads. Idempotent."""
        if not self._finished:
            self._finished = True
            self._encode_pending()
            self._encode_tail()
        return [bytes(p) for p in self._parity]

    @property
    def geometry(self) -> ParityGeometry:
        return ParityGeometry(self.segments, self.stripe_k, self.chunk_bytes, self.payload_len)


def accumulator_from_config(cfg, device=None) -> Optional[ParityAccumulator]:
    """None when the plane is off (``parity_segments = 0``): no tee, no
    parity objects, no trailer."""
    if cfg.parity_segments <= 0:
        return None
    return ParityAccumulator(
        cfg.parity_segments, cfg.parity_stripe_k, cfg.parity_chunk_bytes, device
    )


def put_parity_objects(
    dispatcher,
    data_block: BlockId,
    geometry: ParityGeometry,
    payloads: Sequence[bytes],
) -> List[BlockId]:
    """PUT the m parity sidecars (header + parity bytes each): small objects
    that an overwrite makes idempotent, each re-driven whole after a
    transient failure like the index and checksum sidecars (one attempt at
    ``storage_retries = 0``). Must run before the index write (the commit
    point). Returns the ids written, which the caller's abort path deletes."""
    policy = dispatcher.retry_policy
    scheme = dispatcher.backend.scheme
    blocks = parity_blocks_for(data_block, geometry.segments)
    for seg, (block, payload) in enumerate(zip(blocks, payloads)):
        header = parity_header(data_block, geometry, seg)

        def put_one(block=block, body=header + payload):
            stream = dispatcher.create_block(block)
            try:
                stream.write(body)
            finally:
                stream.close()

        retry_call(put_one, policy, op="commit_parity", scheme=scheme)
    return blocks


def delete_parity_objects(dispatcher, blocks: Sequence[BlockId]) -> None:
    """Best-effort abort-path cleanup of parity sidecars already PUT."""
    for block in blocks:
        try:
            dispatcher.backend.delete(dispatcher.get_path(block))
        except OSError:
            logger.debug("delete of aborted parity object %s failed", block.name, exc_info=True)


def geometry_trailer_words(geometry: ParityGeometry) -> np.ndarray:
    """The 4-word stripe-geometry trailer appended to a per-map index:
    ``[GEOMETRY_MAGIC, m, k, chunk_bytes]`` (payload_len is the index's own
    final cumulative offset)."""
    return np.array(
        [GEOMETRY_MAGIC, geometry.segments, geometry.stripe_k, geometry.chunk_bytes],
        dtype=np.int64,
    )


def split_index_geometry(words: np.ndarray):
    """Split a raw index-blob int64 array into ``(offsets, geometry|None)``,
    dropping a skew trailer if there is one (the full parse is
    ``skew.split_index_trailers``)."""
    from s3shuffle_tpu_torch.skew import split_index_trailers

    offsets, geometry, _skew = split_index_trailers(words)
    return offsets, geometry
