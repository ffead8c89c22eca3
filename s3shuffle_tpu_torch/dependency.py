"""Shuffle dependency + partitioners (a copy of the JAX package's
``dependency.py``; the partition functions are the same bit for bit).

Parity: the analog of Spark's ``ShuffleDependency`` (partitioner,
serializer, aggregator, keyOrdering, mapSideCombine) that the reference's
manager receives in ``registerShuffle`` (sort/S3ShuffleManager.scala:52-71)
and consults in the reader (storage/S3ShuffleReader.scala:124-149).
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Callable, Optional

from s3shuffle_tpu_torch.aggregator import Aggregator
from s3shuffle_tpu_torch.serializer import PickleBatchSerializer, Serializer


def natural_key(k):
    """Identity key function. Used as a *marker*: when a dependency's
    ``key_ordering`` or a RangePartitioner's key func IS this function, the
    batch data plane knows keys order by raw bytes and takes the vectorized
    sort/searchsorted path."""
    return k


class Partitioner:
    num_partitions: int

    def __call__(self, key: Any) -> int:
        raise NotImplementedError

    def partition_batch(self, batch) -> "Any":
        """Partition ids (np.int64 array) for a RecordBatch. Base: scalar
        loop; subclasses vectorize where the key domain allows."""
        import numpy as np

        return np.fromiter((self(k) for k in batch.iter_keys()), np.int64, batch.n)


class HashPartitioner(Partitioner):
    def __init__(self, num_partitions: int):
        if num_partitions < 1:
            raise ValueError("num_partitions must be >= 1")
        self.num_partitions = num_partitions

    def __call__(self, key: Any) -> int:
        return _stable_key_hash(key) % self.num_partitions


_FNV64_PRIME = 1099511628211
_M64 = (1 << 64) - 1
# multiplicative inverse of the prime mod 2^64 (prime is odd → invertible):
# un-does the Horner factor contributed by zero padding columns
_FNV64_PRIME_INV = pow(_FNV64_PRIME, -1, 1 << 64)
_LEN_SALT = 0x9E3779B97F4A7C15


def _mix64(h: int) -> int:
    """splitmix64 finalizer (scalar) — must match `_mix64_vec` bit-for-bit."""
    h &= _M64
    h ^= h >> 30
    h = (h * 0xBF58476D1CE4E5B9) & _M64
    h ^= h >> 27
    h = (h * 0x94D049BB133111EB) & _M64
    h ^= h >> 31
    return h


def _mix64_vec(h):
    import numpy as np

    h = h ^ (h >> np.uint64(30))
    h = h * np.uint64(0xBF58476D1CE4E5B9)
    h = h ^ (h >> np.uint64(27))
    h = h * np.uint64(0x94D049BB133111EB)
    return h ^ (h >> np.uint64(31))


class BytesHashPartitioner(Partitioner):
    """Hash partitioner over raw key BYTES, vectorized over RecordBatches.

    The columnar plane routes on this instead of :class:`HashPartitioner`
    because `_stable_key_hash` (zlib.crc32 per key)
    has no vectorized form — this partitioner's hash is a base-P Horner
    polynomial over the key bytes, length-salted, splitmix64-finalized, which
    maps to O(width) numpy column passes over the padded key matrix. Padding
    zeros contribute a pure ``P^pad`` factor that is cancelled exactly with
    the precomputed multiplicative inverse, so the scalar ``__call__`` (used
    by per-record fallback paths) and :meth:`partition_batch` agree
    bit-for-bit on every key.

    NOTE: deterministic across processes by construction (no PYTHONHASHSEED
    anywhere), but it is a *different* partition function from
    HashPartitioner — the two must not be mixed within one shuffle.
    """

    def __init__(self, num_partitions: int):
        if num_partitions < 1:
            raise ValueError("num_partitions must be >= 1")
        self.num_partitions = num_partitions
        self._inv_pows = None  # lazily grown [P^-0, P^-1, ...] uint64 table

    def __call__(self, key: Any) -> int:
        if isinstance(key, str):
            key = key.encode("utf-8")
        b = bytes(key)
        h = 0
        for x in b:
            h = (h * _FNV64_PRIME + x) & _M64
        h ^= (len(b) * _LEN_SALT) & _M64
        return _mix64(h) % self.num_partitions

    def _inverse_powers(self, upto: int):
        import numpy as np

        if self._inv_pows is None or len(self._inv_pows) <= upto:
            pows = [1]
            for _ in range(upto):
                pows.append((pows[-1] * _FNV64_PRIME_INV) & _M64)
            self._inv_pows = np.array(pows, dtype=np.uint64)
        return self._inv_pows

    def partition_batch(self, batch):
        import numpy as np

        n = batch.n
        if n == 0:
            return np.zeros(0, dtype=np.int64)
        klens = batch.klens
        kw = batch._fixed_width(klens, "_kw")
        prime = np.uint64(_FNV64_PRIME)
        h = np.zeros(n, dtype=np.uint64)
        if kw >= 0:
            mat = (
                np.ascontiguousarray(batch.keys).reshape(n, kw)
                if kw
                else np.zeros((n, 0), dtype=np.uint8)
            )
            for c in range(kw):
                h = h * prime + mat[:, c]
        elif int(klens.max()) <= 64:
            # ragged: reuse the cached padded key matrix (key_strings builds
            # and caches it) and cancel each row's padding factor
            w = max(int(klens.max()), 1)
            mat = batch.key_strings(width=w).view(np.uint8).reshape(n, w)
            for c in range(w):
                h = h * prime + mat[:, c]
            pad = (w - klens).astype(np.int64)
            h = h * self._inverse_powers(w)[pad]
        else:
            # one oversized key must not size the padded matrix for the whole
            # chunk (n × max_klen can be GBs) — rows ≤ 64 B vectorize at a
            # bounded width, longer keys (rare) hash scalar
            w = 64
            small = np.flatnonzero(klens <= w)
            large = np.flatnonzero(klens > w)
            if len(small):
                from s3shuffle_tpu_torch.batch import _ragged_gather, _segment_ids

                lens = klens[small].astype(np.int64)
                off = np.zeros(len(small) + 1, dtype=np.int64)
                np.cumsum(lens, out=off[1:])
                mat = np.zeros((len(small), w), dtype=np.uint8)
                total = int(off[-1])
                if total:
                    rows = _segment_ids(off, total)
                    cols = np.arange(total, dtype=np.int64) - off[rows]
                    mat[rows, cols] = _ragged_gather(
                        batch.keys, batch.koffsets, batch.klens, small
                    )
                hs = np.zeros(len(small), dtype=np.uint64)
                for c in range(w):
                    hs = hs * prime + mat[:, c]
                hs = hs * self._inverse_powers(w)[(w - lens)]
                h[small] = hs
            if len(large):
                keys, ko = batch.keys, batch.koffsets
                for i in large.tolist():
                    hh = 0
                    for x in keys[ko[i] : ko[i + 1]].tobytes():
                        hh = (hh * _FNV64_PRIME + x) & _M64
                    h[i] = hh
        h = h ^ (klens.astype(np.uint64) * np.uint64(_LEN_SALT))
        h = _mix64_vec(h)
        return (h % np.uint64(self.num_partitions)).astype(np.int64)


class RangePartitioner(Partitioner):
    """Key-range partitioner (what sortByKey uses): bounds[i] is the inclusive
    upper key of partition i; computed from a sample by :func:`range_bounds`."""

    def __init__(self, bounds, key_func: Optional[Callable[[Any], Any]] = None):
        self.bounds = list(bounds)
        self.num_partitions = len(self.bounds) + 1
        self._key = key_func or natural_key
        self._bprefix = None  # cached uint64 prefixes of bytes bounds

    def __call__(self, key: Any) -> int:
        import bisect

        return bisect.bisect_left(self.bounds, self._key(key))

    def partition_batch(self, batch):
        import bisect

        import numpy as np

        if (
            self._key is not natural_key
            or not self.bounds
            or not isinstance(self.bounds[0], bytes)
        ):
            if not self.bounds:
                return np.zeros(batch.n, dtype=np.int64)
            return super().partition_batch(batch)
        # Compare on 8-byte big-endian uint64 prefixes: prefix(a) < prefix(b)
        # decides a < b except on prefix equality. searchsorted-left over bound
        # prefixes is exact for every key whose prefix differs from the bound
        # at its insertion point (bounds[pos-1] < key is strict by
        # construction); only prefix-tied rows re-resolve with true-bytes
        # bisect (matches __call__ exactly, incl. the zero-pad ambiguity).
        kprefix = batch._key_prefix_u64()
        if self._bprefix is None:
            bpre = np.zeros((len(self.bounds), 8), dtype=np.uint8)
            for i, b in enumerate(self.bounds):
                head = b[:8]
                bpre[i, : len(head)] = np.frombuffer(head, dtype=np.uint8)
            self._bprefix = bpre.view(">u8").ravel().astype(np.uint64)
        bprefix = self._bprefix
        pos = np.searchsorted(bprefix, kprefix, side="left").astype(np.int64)
        cand = np.nonzero((pos < len(bprefix)) & (bprefix[np.minimum(pos, len(bprefix) - 1)] == kprefix))[0]
        if len(cand) > 64:
            # prefix ties are common (long shared key prefixes) — resolve the
            # tied rows with one vectorized full-width string searchsorted
            # over just those rows (never materialize the full batch's padded
            # key matrix)
            from s3shuffle_tpu_torch.batch import _EMPTY_U8, RecordBatch, _ragged_gather

            width = max(int(batch.klens[cand].max()), max(len(b) for b in self.bounds), 1)
            sub = RecordBatch(
                batch.klens[cand],
                np.zeros(len(cand), dtype=np.int32),
                _ragged_gather(batch.keys, batch.koffsets, batch.klens, cand),
                _EMPTY_U8,
            )
            skeys = sub.key_strings(width=width)
            sbounds = np.array(self.bounds, dtype=f"S{width}")
            pos[cand] = np.searchsorted(sbounds, skeys, side="left")
            # numpy S-compare can't see trailing \x00s: keys that zero-pad-
            # equal their bound may truly be greater — only those re-resolve
            cand = cand[(pos[cand] < len(sbounds)) & (sbounds[np.minimum(pos[cand], len(sbounds) - 1)] == skeys)]
        if len(cand):
            keys, ko = batch.keys, batch.koffsets
            for i in cand.tolist():
                key = keys[ko[i] : ko[i + 1]].tobytes()
                pos[i] = bisect.bisect_left(self.bounds, key)
        return pos


def range_bounds(sample_keys, num_partitions: int):
    keys = sorted(sample_keys)
    if not keys or num_partitions <= 1:
        return []
    step = len(keys) / num_partitions
    return [keys[min(len(keys) - 1, int(step * (i + 1)))] for i in range(num_partitions - 1)]


def _stable_key_hash(key: Any) -> int:
    """Deterministic across processes (PYTHONHASHSEED-independent) so map and
    reduce tasks in different processes agree on partition assignment.

    COMPATIBILITY: this is part of the shuffle wire contract — every task of
    one job must route with the same function, and it equals the JAX
    package's bit for bit, so either package's map outputs are read by the
    other's reducers.

    Per-record hot path of every hash shuffle: common key types avoid the
    generic pickle+blake2b route — ints fold directly, bytes/str go through
    C crc32, and tuples of such (the join-key shape) mix element hashes
    with a Weyl constant. Only exotic key types pay for pickle."""
    t = type(key)
    if t is bool:
        return int(key)
    if t is int:
        # built-in hash(): numeric types that compare equal hash equal
        # (1 == 1.0 == Decimal(1) must share a partition), and numeric
        # hashing is NOT salted by PYTHONHASHSEED — only str/bytes are
        return hash(key) & 0x7FFFFFFF
    if t is float:
        if key != key:  # NaN: hash() is id-based on CPython >= 3.10 —
            return 0x7F8AAAAA  # nondeterministic across processes/retries
        return hash(key) & 0x7FFFFFFF
    if t is bytes:
        return zlib.crc32(key) & 0x7FFFFFFF
    if t is str:
        return zlib.crc32(key.encode("utf-8")) & 0x7FFFFFFF
    if t is tuple:
        h = 0x345678AF
        for item in key:
            # int elements inline (the dominant join-key shape): a recursive
            # call per element doubled the per-record hash cost
            eh = (
                hash(item) & 0x7FFFFFFF
                if type(item) is int
                else _stable_key_hash(item)
            )
            h = (h * 0x9E3779B1 + eh) & 0xFFFFFFFF
        return h & 0x7FFFFFFF
    # subclasses (IntEnum, namedtuple, str/bytes subclasses) and the other
    # numeric types (Decimal, Fraction, complex) compare equal to builtin
    # counterparts, so they MUST hash like them — equal keys landing in
    # different partitions would split a group
    if isinstance(key, bool):
        return int(key)
    import numbers

    if isinstance(key, numbers.Number):
        if key != key:  # Decimal('NaN')/complex NaN: see the float branch
            return 0x7F8AAAAA
        return hash(key) & 0x7FFFFFFF
    if isinstance(key, bytes):
        return zlib.crc32(key) & 0x7FFFFFFF
    if isinstance(key, str):
        return zlib.crc32(key.encode("utf-8")) & 0x7FFFFFFF
    if isinstance(key, tuple):
        h = 0x345678AF
        for item in key:
            h = (h * 0x9E3779B1 + _stable_key_hash(item)) & 0xFFFFFFFF
        return h & 0x7FFFFFFF
    import hashlib
    import pickle

    data = pickle.dumps(key, protocol=4)
    return int.from_bytes(hashlib.blake2b(data, digest_size=4).digest(), "big") & 0x7FFFFFFF


@dataclasses.dataclass
class ShuffleDependency:
    shuffle_id: int
    partitioner: Partitioner
    serializer: Serializer = dataclasses.field(default_factory=PickleBatchSerializer)
    aggregator: Optional[Aggregator] = None
    key_ordering: Optional[Callable[[Any], Any]] = None  # key func; None = no ordering
    map_side_combine: bool = False

    def __post_init__(self) -> None:
        if self.map_side_combine and self.aggregator is None:
            raise ValueError("map_side_combine requires an aggregator")

    @property
    def num_partitions(self) -> int:
        return self.partitioner.num_partitions
