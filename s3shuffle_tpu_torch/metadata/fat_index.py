"""Fat shuffle index: one index object for many map outputs (the JAX
package's ``metadata/fat_index.py``, byte for byte).

The composite commit plane (write/composite_commit.py) composes many map
outputs into one data object, and this sidecar replaces all of their
per-map index and checksum objects with a single PUT:

- a header and a per-member ``(map_id, map_index, base_offset)`` table;
- per member, the cumulative partition offsets ``[0, l0, l0+l1, ...]`` a
  per-map index would hold (member-RELATIVE: readers add
  ``base_offset``);
- optionally per member, the uint32-in-int64 checksum row a per-map
  checksum object would hold.

The wire is big-endian int64 words, as every other metadata blob.
Writing the fat index is the commit point of every member of its group:
data object first, fat index last, no fat index ⇒ no member is visible.

Versions: v1 is the 7-word header; v2 (what the port writes) appends
``[parity_segments, parity_stripe_k, parity_chunk_bytes, payload_len]``,
the composite object's stripe geometry (zeros when uncoded); v3, which
the JAX package's skew plane writes, adds a ``split_bytes`` header word and
a flags word per member row. The port parses all three.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from s3shuffle_tpu_torch.coding.parity import ParityGeometry
from s3shuffle_tpu_torch.skew import FLAG_COMBINED

#: wire-schema binding (wire/schema.py); WIRE01 holds the constants below
#: against the registry
_WIRE_STRUCTS = ("fat_index",)

#: "S3FATIDX"-shaped int64, then the format version
_MAGIC = 0x5333464154494458
_VERSION = 3
_HEADER_V1 = 7
_HEADER_V2 = 11
_HEADER_V3 = 12
_MEMBER_WORDS_V3 = 4


@dataclasses.dataclass
class FatIndexMember:
    """One map output inside a composite group."""

    map_id: int
    map_index: int
    base_offset: int
    #: member-relative cumulative offsets, ``num_partitions + 1`` entries
    offsets: np.ndarray
    #: per-partition checksum values, or None when checksums were disabled
    checksums: Optional[np.ndarray] = None
    #: the member's partitions carry map-side-combined partial rows
    combined: bool = False

    @property
    def total_bytes(self) -> int:
        return int(self.offsets[-1])


class FatIndex:
    """The parsed form of one composite group's fat index object."""

    def __init__(
        self,
        shuffle_id: int,
        group_id: int,
        num_partitions: int,
        members: List[FatIndexMember],
        parity: Optional[ParityGeometry] = None,
        split_bytes: int = 0,
    ):
        self.shuffle_id = int(shuffle_id)
        self.group_id = int(group_id)
        self.num_partitions = int(num_partitions)
        self.parity = parity
        self.split_bytes = int(split_bytes)
        self.members: Dict[int, FatIndexMember] = {}
        for m in members:
            if len(m.offsets) != self.num_partitions + 1:
                raise ValueError(
                    f"member {m.map_id} has {len(m.offsets)} offsets, "
                    f"expected {self.num_partitions + 1}"
                )
            self.members[int(m.map_id)] = m
        self.has_checksums = bool(members) and all(m.checksums is not None for m in members)

    def member(self, map_id: int) -> FatIndexMember:
        try:
            return self.members[int(map_id)]
        except KeyError:
            raise FileNotFoundError(
                f"map {map_id} is not a member of composite group "
                f"{self.group_id} (shuffle {self.shuffle_id})"
            ) from None

    def to_bytes(self) -> bytes:
        """``[magic, version, shuffle_id, group_id, num_partitions,
        n_members, has_checksums, parity_segments, parity_stripe_k,
        parity_chunk_bytes, payload_len]`` (+ ``split_bytes`` in v3), then
        ``n_members`` rows of ``[map_id, map_index, base_offset]`` (+ flags
        in v3), then ``n_members`` offset rows of ``num_partitions + 1``
        words, then (with checksums) ``n_members`` checksum rows of
        ``num_partitions`` words. v3 only when a skew prong engaged (a split
        or a combined member), as in the JAX package: otherwise v2."""
        members = list(self.members.values())
        p = self.num_partitions
        has_ck = 1 if self.has_checksums else 0
        par = self.parity
        skew_active = self.split_bytes > 0 or any(m.combined for m in members)
        header_words = [
            _MAGIC, _VERSION if skew_active else 2,
            self.shuffle_id, self.group_id, p,
            len(members), has_ck,
            0 if par is None else int(par.segments),
            0 if par is None else int(par.stripe_k),
            0 if par is None else int(par.chunk_bytes),
            0 if par is None else int(par.payload_len),
        ]
        if skew_active:
            header_words.append(self.split_bytes)
        row_words = _MEMBER_WORDS_V3 if skew_active else 3
        rows = np.zeros((len(members), row_words), dtype=np.int64)
        offs = np.zeros((len(members), p + 1), dtype=np.int64)
        cks = np.zeros((len(members), p), dtype=np.int64) if has_ck else None
        for i, m in enumerate(members):
            rows[i, :3] = (m.map_id, m.map_index, m.base_offset)
            if skew_active:
                rows[i, 3] = FLAG_COMBINED if m.combined else 0
            offs[i] = np.asarray(m.offsets, dtype=np.int64)
            if cks is not None:
                cks[i] = np.asarray(m.checksums, dtype=np.int64)
        parts = [np.array(header_words, dtype=np.int64), rows.reshape(-1), offs.reshape(-1)]
        if cks is not None:
            parts.append(cks.reshape(-1))
        return b"".join(np.ascontiguousarray(a, dtype=">i8").tobytes() for a in parts)

    @classmethod
    def from_bytes(cls, data: bytes) -> "FatIndex":
        if len(data) % 8 != 0 or len(data) < _HEADER_V1 * 8:
            raise ValueError(f"fat index blob has invalid length {len(data)}")
        words = np.frombuffer(data, dtype=">i8").astype(np.int64)
        magic, version, shuffle_id, group_id, p, n, has_ck = (int(w) for w in words[:_HEADER_V1])
        if magic != _MAGIC:
            raise ValueError("fat index blob has wrong magic")
        split_bytes = 0
        row_words = 3
        parity = None
        if version == 1:
            header = _HEADER_V1
        elif version in (2, _VERSION):
            header = _HEADER_V2 if version == 2 else _HEADER_V3
            if len(words) < header:
                raise ValueError(f"fat index v{version} blob has invalid length {len(data)}")
            par_m, par_k, par_chunk, par_len = (int(w) for w in words[7:11])
            if par_m > 0:
                parity = ParityGeometry(par_m, par_k, par_chunk, par_len)
            if version == _VERSION:
                split_bytes = int(words[11])
                row_words = _MEMBER_WORDS_V3
        else:
            raise ValueError(f"fat index format version {version} > {_VERSION}")
        expect = header + n * row_words + n * (p + 1) + (n * p if has_ck else 0)
        if len(words) != expect:
            raise ValueError(f"fat index blob has {len(words)} words, expected {expect}")
        pos = header
        rows = words[pos : pos + n * row_words].reshape(n, row_words)
        pos += n * row_words
        offs = words[pos : pos + n * (p + 1)].reshape(n, p + 1)
        pos += n * (p + 1)
        cks = words[pos:].reshape(n, p) if has_ck else None
        members = [
            FatIndexMember(
                map_id=int(rows[i, 0]),
                map_index=int(rows[i, 1]),
                base_offset=int(rows[i, 2]),
                offsets=np.array(offs[i], dtype=np.int64),
                checksums=None if cks is None else np.array(cks[i], dtype=np.int64),
                combined=bool(row_words > 3 and int(rows[i, 3]) & FLAG_COMBINED),
            )
            for i in range(n)
        ]
        return cls(shuffle_id, group_id, p, members, parity=parity, split_bytes=split_bytes)
