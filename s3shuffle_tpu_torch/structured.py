"""Typed columnar shuffle layer: order-preserving key packing and decoded
aggregation and sort results (a copy of the JAX package's
``structured.py``, the TPC-DS-shaped query plane of
``examples/sql_queries.py``).

Typed key columns pack into fixed-width, order-preserving big-endian bytes,
so the byte-sorting data plane (``argsort_by_key``, range partitioning,
``BatchSorter``) is the typed sort; value columns pack into fixed-width
little-endian int64 rows, the shape :mod:`s3shuffle_tpu_torch.colagg`
reduces with ``ufunc.reduceat``.

Key encodings (all order-preserving under bytes comparison):

- ``i64``: sign-bit-flipped uint64, big-endian;
- ``i32``: sign-bit-flipped uint32, big-endian (``pack`` range-checks and
  raises on overflow; ``unpack`` returns int64);
- ``f64``: IEEE-754 total order — negative floats bit-inverted, positive
  floats sign-bit-set, big-endian (NaNs order after +inf; -0.0 < +0.0);
- ``("bytes", w)``: raw bytes right-padded with NULs to width ``w``.

Value columns may declare narrow wire dtypes (``i1``/``i2``/``i4``/``i8``):
:func:`pack_values` packs them into little-endian packed structs and
range-checks each column, and the reduce side widens to int64 before any
reduction, so aggregates cannot overflow.

:func:`agg_shuffle` and :func:`sort_shuffle_batches` run on the given
:class:`~s3shuffle_tpu_torch.shuffle.ShuffleContext`, on its device, as do
the two operators of a ranked rollup (TPC-DS q67's plan in Spark):

- :func:`rollup_shuffle`: ``GROUP BY ROLLUP`` over a codec's fields
  (:class:`Rollup`: Spark's Expand into the grouping sets, the grouping id
  in the key); each map task expands its own rows as it pulls them
  (``record.expand`` stages, ``expand_host_s``) into the map-side combine of
  an aggregating shuffle (the sort-shuffle handle);
- :func:`rank_shuffle`: the window exchange of ``rank() ... <= k``: each map
  task prunes its rows with :func:`window_group_limit`, the exchange
  hashes them on the window's partition key without combine, and each
  output partition's rows get their exact :func:`rank` (``record.rank``
  stages, ``rank_host_s``).

The stages time into the context's codec's ``timings``
(``utils.trace.stage``).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from s3shuffle_tpu_torch.batch import RecordBatch
from s3shuffle_tpu_torch.utils import trace

_SIGN = np.uint64(0x8000000000000000)
_SIGN32 = np.uint32(0x80000000)

FieldSpec = Union[str, Tuple[str, int]]

#: value-column dtype code -> (numpy little-endian dtype, byte width)
_VAL_DTYPES = {
    "i1": ("<i1", 1),
    "i2": ("<i2", 2),
    "i4": ("<i4", 4),
    "i8": ("<i8", 8),
}


def _enc_i64_words(col) -> np.ndarray:
    """int64 column → order-preserving native uint64 words (no byteswap)."""
    return np.ascontiguousarray(col, dtype=np.int64).view(np.uint64) ^ _SIGN


def _dec_i64_words(u: np.ndarray) -> np.ndarray:
    return (u ^ _SIGN).view(np.int64)


def _enc_f64_words(col) -> np.ndarray:
    """float64 column → IEEE-754 total-order native uint64 words."""
    bits = np.ascontiguousarray(col, dtype=np.float64).view(np.uint64)
    return np.where(bits >> np.uint64(63), ~bits, bits | _SIGN)


def _dec_f64_words(u: np.ndarray) -> np.ndarray:
    bits = np.where(u & _SIGN, u ^ _SIGN, ~u)
    return bits.view(np.float64)


def _enc_i32_words(col) -> np.ndarray:
    """int64-valued column → order-preserving native uint32 words; range-
    checked (silent wraparound would silently mis-sort and mis-join), and
    integer-dtype-checked (a float column cast to int64 would silently
    TRUNCATE — e.g. 1.9 → 1 — and mis-join just as silently)."""
    raw = np.asarray(col)
    if raw.size and raw.dtype.kind not in "iu":
        raise ValueError(
            f"i32 key column requires an integer dtype, got {raw.dtype} "
            "(float values would be silently truncated; use an f64 field)"
        )
    a = np.ascontiguousarray(raw, dtype=np.int64)
    if a.size and (
        int(a.min()) < -(1 << 31) or int(a.max()) >= (1 << 31)
    ):
        raise ValueError("i32 key column value out of int32 range")
    return a.astype(np.int32).view(np.uint32) ^ _SIGN32


def _dec_i32_words(u: np.ndarray) -> np.ndarray:
    return (u ^ _SIGN32).view(np.int32).astype(np.int64)


def _enc_i64(col: np.ndarray) -> np.ndarray:
    """int64 column → (n, 8) big-endian order-preserving bytes."""
    return _enc_i64_words(col).astype(">u8").view(np.uint8).reshape(-1, 8)


def _dec_i64(mat: np.ndarray) -> np.ndarray:
    u = np.ascontiguousarray(mat).view(">u8").ravel().astype(np.uint64)
    return _dec_i64_words(u)


def _enc_f64(col: np.ndarray) -> np.ndarray:
    return _enc_f64_words(col).astype(">u8").view(np.uint8).reshape(-1, 8)


def _dec_f64(mat: np.ndarray) -> np.ndarray:
    enc = np.ascontiguousarray(mat).view(">u8").ravel().astype(np.uint64)
    return _dec_f64_words(enc)


class KeyCodec:
    """Fixed-width multi-column key packer. ``fields`` are ``"i64"``,
    ``"i32"``, ``"f64"``, or ``("bytes", width)``; key bytes order == tuple
    order of the decoded columns (ints/floats numerically, bytes
    lexicographically)."""

    def __init__(self, *fields: FieldSpec):
        if not fields:
            raise ValueError("KeyCodec needs at least one field")
        self.fields: Tuple[FieldSpec, ...] = tuple(fields)
        self.widths: List[int] = []
        for f in self.fields:
            if f in ("i64", "f64"):
                self.widths.append(8)
            elif f == "i32":
                self.widths.append(4)
            elif isinstance(f, tuple) and f[0] == "bytes" and int(f[1]) > 0:
                self.widths.append(int(f[1]))
            else:
                raise ValueError(f"Unknown key field spec: {f!r}")
        self.width = sum(self.widths)
        # uniform-width numeric fields take the word-matrix fast paths
        self._word_dtype = None
        if all(f in ("i64", "f64") for f in self.fields):
            self._word_dtype = (">u8", np.uint64)
        elif all(f == "i32" for f in self.fields):
            self._word_dtype = (">u4", np.uint32)

    # ------------------------------------------------------------------
    def pack(self, *cols) -> np.ndarray:
        """Columns → flat uint8 key buffer (n × width)."""
        if len(cols) != len(self.fields):
            raise ValueError(f"expected {len(self.fields)} key columns, got {len(cols)}")
        n = len(cols[0])
        if self._word_dtype is not None:
            # Uniform-width numeric fast path: write each column's encoded
            # words straight into a big-endian word matrix — numpy byteswaps
            # during the strided assignment, so each column costs one
            # transform pass + one write pass (the generic path below pays
            # an extra ``astype`` temp + copy per column).
            be, _native = self._word_dtype
            m = np.empty((n, len(self.fields)), dtype=be)
            for j, (f, col) in enumerate(zip(self.fields, cols)):
                if f == "i64":
                    m[:, j] = _enc_i64_words(col)
                elif f == "i32":
                    m[:, j] = _enc_i32_words(col)
                else:
                    m[:, j] = _enc_f64_words(col)
            return m.view(np.uint8).ravel()
        mat = np.empty((n, self.width), dtype=np.uint8)
        off = 0
        for f, w, col in zip(self.fields, self.widths, cols):
            if f == "i64":
                mat[:, off : off + 8] = _enc_i64(col)
            elif f == "i32":
                mat[:, off : off + 4] = (
                    _enc_i32_words(col).astype(">u4").view(np.uint8).reshape(-1, 4)
                )
            elif f == "f64":
                mat[:, off : off + 8] = _enc_f64(col)
            else:
                part = np.zeros((n, w), dtype=np.uint8)
                if isinstance(col, np.ndarray) and col.dtype.kind == "S":
                    if col.dtype.itemsize > w and (np.char.str_len(col) > w).any():
                        raise ValueError(
                            f"bytes key longer than declared width {w}"
                        )
                    raw = np.ascontiguousarray(col.astype(f"S{w}")).view(np.uint8)
                    part[:, :] = raw.reshape(n, w)
                else:
                    for i, b in enumerate(col):
                        bb = bytes(b)
                        if len(bb) > w:
                            raise ValueError(
                                f"bytes key {bb[:16]!r}... longer than declared "
                                f"width {w}"
                            )
                        part[i, : len(bb)] = np.frombuffer(bb, dtype=np.uint8)
                mat[:, off : off + w] = part
            off += w
        return mat.ravel()

    def unpack(self, keys: np.ndarray, n: int) -> List[np.ndarray]:
        """Flat key buffer (n × width) → decoded columns."""
        mat = np.ascontiguousarray(keys).reshape(n, self.width)
        if self._word_dtype is not None:
            # Mirror of the pack fast path: view the contiguous key matrix
            # as big-endian words and byteswap-convert each strided column
            # in one astype pass (no per-column contiguous copy).
            be, native = self._word_dtype
            mw = mat.view(be)
            outw: List[np.ndarray] = []
            for j, f in enumerate(self.fields):
                u = mw[:, j].astype(native)
                if f == "i64":
                    outw.append(_dec_i64_words(u))
                elif f == "i32":
                    outw.append(_dec_i32_words(u))
                else:
                    outw.append(_dec_f64_words(u))
            return outw
        out: List[np.ndarray] = []
        off = 0
        for f, w in zip(self.fields, self.widths):
            sub = mat[:, off : off + w]
            if f == "i64":
                out.append(_dec_i64(sub))
            elif f == "i32":
                u = np.ascontiguousarray(sub).view(">u4").ravel().astype(np.uint32)
                out.append(_dec_i32_words(u))
            elif f == "f64":
                out.append(_dec_f64(sub))
            else:
                out.append(np.ascontiguousarray(sub).view(f"S{w}").ravel())
            off += w
        return out


def val_struct_dtype(dtypes: Sequence[str]) -> np.dtype:
    """Packed (unaligned) little-endian struct dtype for a value schema —
    the wire layout of one value row."""
    return np.dtype(
        [(f"c{j}", _VAL_DTYPES[d][0]) for j, d in enumerate(dtypes)]
    )


def val_schema_width(dtypes: Sequence[str]) -> int:
    return sum(_VAL_DTYPES[d][1] for d in dtypes)


def widen_values(values: np.ndarray, n: int, dtypes: Sequence[str]) -> np.ndarray:
    """Packed narrow value rows → flat uint8 buffer of (n × 8·k) LE int64
    rows (the shape the segmented reducers consume). One strided astype pass
    per column."""
    st = val_struct_dtype(dtypes)
    rows = np.ascontiguousarray(values).view(st)
    wide = np.empty((n, len(dtypes)), dtype="<i8")
    for j in range(len(dtypes)):
        wide[:, j] = rows[f"c{j}"]
    return wide.view(np.uint8).ravel()


def pack_values(*cols, dtypes: Optional[Sequence[str]] = None) -> np.ndarray:
    """int64 columns → flat uint8 value buffer of fixed-width LE rows — the
    layout ColumnarAggregator reduces. With ``dtypes`` (``"i1"``/``"i2"``/
    ``"i4"``/``"i8"`` per column), rows pack into narrow structs for the
    shuffle wire; each column is range-checked (a silently wrapped value
    would silently corrupt the aggregate). Without, rows are int64 columns
    (the reduce-native shape)."""
    if dtypes is None:
        stacked = np.column_stack([np.asarray(c, dtype="<i8") for c in cols])
        return np.ascontiguousarray(stacked).view(np.uint8).ravel()
    if len(dtypes) != len(cols):
        raise ValueError(f"expected {len(cols)} value dtypes, got {len(dtypes)}")
    n = len(cols[0]) if cols else 0
    st = val_struct_dtype(dtypes)
    rows = np.empty(n, dtype=st)
    for j, (d, c) in enumerate(zip(dtypes, cols)):
        a = np.asarray(c)
        if a.size and a.dtype.kind not in "iu":
            raise ValueError(
                f"value column {j} requires an integer dtype for {d} "
                f"packing, got {a.dtype} (float values would be silently "
                "truncated on the struct assignment)"
            )
        info = np.iinfo(_VAL_DTYPES[d][0])
        if a.size and (int(a.min()) < info.min or int(a.max()) > info.max):
            raise ValueError(
                f"value column {j} out of declared {d} range "
                f"[{info.min}, {info.max}]"
            )
        rows[f"c{j}"] = a
    return rows.view(np.uint8)


def values_matrix(batch: RecordBatch, ncols: int) -> np.ndarray:
    """A reduced batch's values as an (n, ncols) int64 matrix."""
    return np.ascontiguousarray(batch.values).reshape(batch.n, 8 * ncols).view("<i8")


def make_batch(
    codec: KeyCodec,
    key_cols: Sequence,
    val_cols: Sequence,
    val_dtypes: Optional[Sequence[str]] = None,
) -> RecordBatch:
    """Pack typed columns into a RecordBatch (fixed-width keys AND values —
    every downstream fast path engages). ``val_dtypes`` packs value columns
    narrow for the wire (see :func:`pack_values`); pass the same schema to
    the aggregation so the reduce side widens before reducing."""
    n = len(key_cols[0])
    keys = codec.pack(*key_cols)
    if val_cols:
        values = pack_values(*val_cols, dtypes=val_dtypes)
        vw = val_schema_width(val_dtypes) if val_dtypes else 8 * len(val_cols)
    else:
        values = np.empty(0, dtype=np.uint8)
        vw = 0
    # from_fixed seeds the width caches, so the typed batch takes every
    # fixed-stride fast path (and ships lens-free column frames on the wire)
    # without any downstream uniformity scan
    return RecordBatch.from_fixed(n, codec.width, vw, keys, values)


def split_batch(batch: RecordBatch, n_parts: int) -> List[RecordBatch]:
    """Contiguous row split into ``n_parts`` map partitions (zero-copy)."""
    n = batch.n
    bounds = [n * i // n_parts for i in range(n_parts + 1)]
    return [batch.slice_rows(bounds[i], bounds[i + 1]) for i in range(n_parts)]


def window_group_limit(
    group: np.ndarray, order: np.ndarray, k: int, largest: bool = True
) -> np.ndarray:
    """Boolean mask of rows that can reach rank ≤ ``k`` within their group
    when rows are ranked by ``order`` (descending when ``largest``).

    This is the rank-pushdown filter Spark 3.5 applies before the window
    shuffle (``WindowGroupLimitExec``): any row whose order value is strictly
    beyond the group's k-th best cannot rank ≤ k regardless of tie-breaking,
    so it is pruned before the expensive sort. Rows tied AT the k-th value
    are all kept — the downstream full-tiebreak sort resolves them — so the
    surviving rows' ranks equal their ranks in the unpruned input.
    """
    group = np.asarray(group)
    n = len(group)
    if k <= 0 or n == 0:
        return np.zeros(n, dtype=bool)
    vals = np.asarray(order) if largest else -np.asarray(order)
    # Dense small-range groups (the broadcast-dimension case — q67's ~10
    # categories over tens of millions of rows): a counting pass + one
    # np.partition per group finds each threshold in O(n) with ~4 cheap
    # passes. The generic path below lexsorts (group, -val) — robust for
    # arbitrary high-cardinality groups but ~10x the passes.
    dense_ok = group.dtype.kind in "iu" and (
        vals.dtype.kind != "f" or not np.isnan(vals).any()
    )  # NaN order values: np.partition ranks NaN largest, which would make
    # a group's threshold NaN and prune the WHOLE group — the lexsort path
    # below drops only the NaN rows, so NaN inputs take that path
    if dense_ok:
        gmin = int(group.min())
        grange = int(group.max()) - gmin + 1
        if grange <= 4096:
            # uint16 cast: numpy's stable argsort radixes per BYTE of the
            # dtype, so sorting the int64 group column directly pays 8
            # passes for a value that fits in 2 (subtract in int64 first:
            # small signed dtypes can overflow on the span)
            bucket = (group.astype(np.int64) - gmin).astype(np.uint16)
            counts = np.bincount(bucket, minlength=grange)
            idx = np.argsort(bucket, kind="stable")  # radix: rows by group
            vs = vals[idx]
            bounds = np.zeros(grange + 1, dtype=np.int64)
            np.cumsum(counts, out=bounds[1:])
            kth = np.empty(grange, dtype=vals.dtype)
            for g in range(grange):
                lo, hi = int(bounds[g]), int(bounds[g + 1])
                if hi == lo:
                    continue
                size = hi - lo
                kk = min(k, size)
                kth[g] = np.partition(vs[lo:hi], size - kk)[size - kk]
            return vals >= kth[bucket]
    idx = np.lexsort((-vals, group))
    gs, vs = group[idx], vals[idx]
    starts = np.flatnonzero(np.r_[True, gs[1:] != gs[:-1]])
    sizes = np.diff(np.r_[starts, n])
    kth = vs[starts + np.minimum(k, sizes) - 1]  # per-group k-th best value
    keep = np.empty(n, dtype=bool)
    keep[idx] = vs >= np.repeat(kth, sizes)
    return keep


# ----------------------------------------------------------------------------
# Context-level typed operations
# ----------------------------------------------------------------------------


def agg_shuffle(
    ctx,
    codec: KeyCodec,
    parts: Sequence[RecordBatch],
    ops: Sequence[str],
    num_partitions: int,
    map_side_combine: bool = True,
    val_dtypes: Optional[Sequence[str]] = None,
) -> Tuple[List[np.ndarray], np.ndarray]:
    """Hash-shuffle + columnar aggregation; returns (key_columns, value
    matrix) concatenated over all output partitions (each partition's rows
    are key-sorted; cross-partition order is by hash, i.e. unspecified).
    ``val_dtypes`` declares the narrow wire schema the input batches were
    packed with (``make_batch(..., val_dtypes=...)``)."""
    from s3shuffle_tpu_torch.colagg import ColumnarAggregator
    from s3shuffle_tpu_torch.dependency import BytesHashPartitioner
    from s3shuffle_tpu_torch.serializer import ColumnarKVSerializer

    out = ctx.run_shuffle(
        list(parts),
        partitioner=BytesHashPartitioner(num_partitions),
        aggregator=ColumnarAggregator(ops, val_dtypes=val_dtypes),
        serializer=ColumnarKVSerializer(),
        map_side_combine=map_side_combine,
        materialize="batches",
    )
    batches = [b for part in out for b in part if b.n]
    if not batches:
        empty_cols = [
            np.empty(0, dtype=np.float64)
            if f == "f64"
            else np.empty(0, dtype=f"S{w}")
            if isinstance(f, tuple)
            else np.empty(0, dtype=np.int64)
            for f, w in zip(codec.fields, codec.widths)
        ]
        return empty_cols, np.empty((0, len(ops)), dtype=np.int64)
    if len(batches) == 1:
        b = batches[0]
        return codec.unpack(b.keys, b.n), values_matrix(b, len(ops))
    # Decode per batch and concatenate the DECODED columns: concatenating
    # the raw RecordBatches first would be a full extra pass over every key
    # and value byte.
    key_parts = [codec.unpack(b.keys, b.n) for b in batches]
    key_cols = [
        np.concatenate([kp[i] for kp in key_parts])
        for i in range(len(codec.fields))
    ]
    vals = np.concatenate([values_matrix(b, len(ops)) for b in batches], axis=0)
    return key_cols, vals


def sort_shuffle_batches(
    ctx,
    codec: KeyCodec,
    parts: Sequence[RecordBatch],
    val_ncols: int,
    num_partitions: int,
) -> Iterator[Tuple[List[np.ndarray], np.ndarray]]:
    """Range-partitioned global sort; yields decoded (key_columns, value
    matrix) per output batch in GLOBAL key order."""
    from s3shuffle_tpu_torch.serializer import ColumnarKVSerializer

    out = ctx.sort_by_key(
        list(parts),
        num_partitions=num_partitions,
        serializer=ColumnarKVSerializer(),
        materialize="batches",
    )
    for part in out:
        for b in part:
            if b.n:
                yield codec.unpack(b.keys, b.n), values_matrix(b, val_ncols) if val_ncols else np.empty((b.n, 0), dtype=np.int64)


# ----------------------------------------------------------------------------
# Ranked rollup: GROUP BY ROLLUP, then rank() within a window partition
# ----------------------------------------------------------------------------


def rank(group: np.ndarray, order: np.ndarray) -> np.ndarray:
    """SQL ``rank() over (partition by group order by order desc)``: rows
    with equal ``order`` in a group share a rank and the next rank skips
    (1, 1, 3). Returns int64 ranks in input row order."""
    group = np.asarray(group)
    vals = np.asarray(order)
    n = len(group)
    if n == 0:
        return np.empty(0, dtype=np.int64)
    idx = np.lexsort((vals, group))  # ascending by (group, order)
    g, v = group[idx], vals[idx]
    pos = np.arange(n, dtype=np.int64)
    new_group = np.r_[True, g[1:] != g[:-1]]
    starts = np.flatnonzero(new_group)
    ends = np.r_[starts[1:], n][np.cumsum(new_group) - 1]
    # a run of equal values ends where the next row starts a group or a run
    run_ends_here = np.r_[new_group[1:] | (v[1:] != v[:-1]), True]
    run_end = np.minimum.accumulate(np.where(run_ends_here, pos, n)[::-1])[::-1]
    out = np.empty(n, dtype=np.int64)
    out[idx] = ends - run_end  # 1 + the group's rows after this run
    return out


class Rollup:
    """``GROUP BY ROLLUP(c1, ..., cn)`` over the fields of ``codec``: Spark's
    Expand of every row into the n + 1 grouping sets (c1..cn), (c1..cn-1),
    ..., (), each with its ``spark_grouping_id`` (bit n-1-j set when column
    j is rolled up: 0 keeps every column, 2**n - 1 is the grand total).

    An expanded row's key is the input key with every rolled-up field's
    bytes zeroed, then the grouping id as an ``i32`` field
    (:attr:`out_codec`). A field whose bytes are all zero is NULL: a
    rolled-up column, or a data NULL (``b""`` for a bytes field, the type's
    minimum for an ``i32`` or ``i64`` field, which is thereby reserved), the
    two told apart by the grouping id. All-zero bytes order first, as NULLs
    do in Spark's ascending order."""

    def __init__(self, codec: KeyCodec):
        if "f64" in codec.fields:
            raise ValueError("a rollup's fields are bytes, i32 or i64 (f64 has no NULL)")
        self.codec = codec
        self.out_codec = KeyCodec(*codec.fields, "i32")
        self.offsets = np.r_[0, np.cumsum(codec.widths)].astype(np.int64)
        n = len(codec.fields)
        #: (columns kept, grouping id), finest first
        self.sets = [(kept, (1 << (n - kept)) - 1) for kept in range(n, -1, -1)]

    def expand(self, batch: RecordBatch, kept: int, gid: int) -> RecordBatch:
        """``batch``'s rows in the grouping set that keeps the first
        ``kept`` columns (values shared, not copied)."""
        n, w = batch.n, self.codec.width
        vw = batch._fixed_width(batch.vlens, "_vw")
        if n and batch._fixed_width(batch.klens, "_kw") != w:
            raise ValueError(f"a rollup's input keys are {w} bytes ({self.codec.fields})")
        cut = int(self.offsets[kept])
        keys = np.zeros((n, w + 4), dtype=np.uint8)
        keys[:, :cut] = np.asarray(batch.keys).reshape(n, w)[:, :cut]
        keys[:, w:] = _enc_i32_words([gid]).astype(">u4").view(np.uint8)
        return RecordBatch.from_fixed(n, w + 4, max(vw, 0), keys.ravel(), batch.values)

    def decode(self, batch: RecordBatch):
        """An output batch's keys as ``(columns, nulls, gid)``: the decoded
        columns (a NULL's slot holds the all-zero bytes' value), one NULL
        mask per column, and the grouping ids."""
        n = batch.n
        mat = np.ascontiguousarray(batch.keys).reshape(n, self.out_codec.width)
        *cols, gid = self.out_codec.unpack(batch.keys, n)
        nulls = [~mat[:, lo:hi].any(axis=1)
                 for lo, hi in zip(self.offsets[:-1], self.offsets[1:])]
        return cols, nulls, gid


def _expanded(rollup: Rollup, batch: RecordBatch, sink) -> Iterator[RecordBatch]:
    """One map task's input to :func:`rollup_shuffle`: its rows in one
    grouping set after another, each expanded as the task pulls it (a
    ``record.expand`` stage timed into ``sink``)."""
    tally = trace.Tally(sink)
    try:
        for kept, gid in rollup.sets:
            with trace.stage("record.expand", tally, "expand_host_s"):
                out = rollup.expand(batch, kept, gid)
            yield out
    finally:
        tally.flush()


def rollup_shuffle(
    ctx,
    codec: KeyCodec,
    parts: Sequence[RecordBatch],
    ops: Sequence[str],
    num_partitions: int,
    val_dtypes: Optional[Sequence[str]] = None,
) -> Tuple[Rollup, List[List[RecordBatch]]]:
    """``SELECT codec's fields, ops(values) ... GROUP BY ROLLUP(fields)``:
    ``parts`` (one per map task, ``make_batch(codec, ...)``) expand inside
    their map tasks into the grouping sets of :class:`Rollup` and go
    straight into the map-side combine of a hash-partitioned aggregating
    shuffle (``ColumnarAggregator``; the manager gives it the sort-shuffle
    handle). Returns the rollup and the output partitions: lists of
    key-sorted batches of unique ``rollup.out_codec`` keys and int64 value
    rows."""
    from s3shuffle_tpu_torch.colagg import ColumnarAggregator
    from s3shuffle_tpu_torch.dependency import BytesHashPartitioner
    from s3shuffle_tpu_torch.serializer import ColumnarKVSerializer

    rollup = Rollup(codec)
    sink = ctx.manager.codec
    out = ctx.run_shuffle(
        [_expanded(rollup, p, sink) for p in parts],
        partitioner=BytesHashPartitioner(num_partitions),
        aggregator=ColumnarAggregator(ops, val_dtypes=val_dtypes),
        serializer=ColumnarKVSerializer(),
        map_side_combine=True,
        materialize="batches",
    )
    return rollup, out


def _pruned(batches: Sequence[RecordBatch], window: "_Window") -> Iterator[RecordBatch]:
    """One map task's input to :func:`rank_shuffle`: its batches pruned by
    :func:`window_group_limit` (a ``record.rank`` stage) and re-keyed on the
    window's partition key, as the task pulls them."""
    batch = RecordBatch.concat(list(batches))
    if batch.n == 0:
        return
    with trace.stage("record.rank", window.sink, "rank_host_s"):
        group, order = window.columns(batch)
        keep = window_group_limit(group, order, window.k)
    yield window.split_key(batch.take(np.flatnonzero(keep)))


class _Window:
    """``rank() over (partition by <the first group_width key bytes> order
    by <the value row's last int64 column> desc)`` with ``rank <= k``
    kept."""

    def __init__(self, group_width: int, k: int, sink):
        self.group_width, self.k, self.sink = group_width, k, sink

    def columns(self, batch: RecordBatch):
        """(group ids, order values) of a batch of fixed-width rows, in the
        input layout or re-keyed (the order value ends either row)."""
        n, gw = batch.n, self.group_width
        kw = batch._fixed_width(batch.klens, "_kw")
        vw = batch._fixed_width(batch.vlens, "_vw")
        prefix = np.ascontiguousarray(np.asarray(batch.keys).reshape(n, kw)[:, :gw])
        _u, group = np.unique(prefix.view(f"V{gw}").ravel(), return_inverse=True)
        order = np.ascontiguousarray(np.asarray(batch.values).reshape(n, vw)[:, vw - 8:])
        return group.ravel(), order.view("<i8").ravel()

    def split_key(self, batch: RecordBatch) -> RecordBatch:
        """Rows re-keyed on their first ``group_width`` key bytes: the rest
        of the key moves to the front of the value."""
        n, gw = batch.n, self.group_width
        kw = batch._fixed_width(batch.klens, "_kw")
        vw = batch._fixed_width(batch.vlens, "_vw")
        keys = np.asarray(batch.keys).reshape(n, kw)
        values = np.empty((n, kw - gw + vw), dtype=np.uint8)
        values[:, : kw - gw] = keys[:, gw:]
        values[:, kw - gw:] = np.asarray(batch.values).reshape(n, vw)
        return RecordBatch.from_fixed(n, gw, kw - gw + vw,
                                      np.ascontiguousarray(keys[:, :gw]).ravel(),
                                      values.ravel())

    def join_key(self, batch: RecordBatch, key_width: int) -> RecordBatch:
        """Re-keyed rows back in the input layout of ``key_width``-byte
        keys."""
        n, gw = batch.n, self.group_width
        width = gw + batch._fixed_width(batch.vlens, "_vw")
        rows = np.empty((n, width), dtype=np.uint8)
        rows[:, :gw] = np.asarray(batch.keys).reshape(n, gw)
        rows[:, gw:] = np.asarray(batch.values).reshape(n, width - gw)
        return RecordBatch.from_fixed(n, key_width, width - key_width,
                                      np.ascontiguousarray(rows[:, :key_width]).ravel(),
                                      np.ascontiguousarray(rows[:, key_width:]).ravel())


def rank_shuffle(
    ctx,
    parts: Sequence[Sequence[RecordBatch]],
    group_width: int,
    k: int,
    num_partitions: int,
) -> List[Tuple[RecordBatch, np.ndarray]]:
    """The window exchange of ``rank() over (partition by g order by o
    desc)`` with ``rank <= k`` kept, as Spark 3.5 plans it: each map task
    prunes its rows with :func:`window_group_limit` (the partial
    ``WindowGroupLimitExec``), the exchange hashes them on the window's
    partition key without combine (the bypass handle up to 200 partitions),
    and each output partition's rows get their exact :func:`rank`, those
    at most ``k`` kept.

    ``parts`` holds one map task's batches each, of one key width: g is
    the first ``group_width`` key bytes, o the value row's last int64
    column (the shape :func:`rollup_shuffle` returns, o its last
    aggregate). Returns, per output partition, the kept rows in that
    layout and their ranks."""
    from s3shuffle_tpu_torch.dependency import BytesHashPartitioner
    from s3shuffle_tpu_torch.serializer import ColumnarKVSerializer

    key_width = next((b._fixed_width(b.klens, "_kw") for batches in parts for b in batches
                      if b.n), group_width)
    window = _Window(group_width, k, ctx.manager.codec)
    out = ctx.run_shuffle(
        [_pruned(batches, window) for batches in parts],
        partitioner=BytesHashPartitioner(num_partitions),
        serializer=ColumnarKVSerializer(),
        materialize="batches",
    )
    result = []
    for partition in out:
        batch = RecordBatch.concat(partition)
        if batch.n == 0:
            result.append((RecordBatch.empty(), np.empty(0, dtype=np.int64)))
            continue
        with trace.stage("record.rank", window.sink, "rank_host_s"):
            group, order = window.columns(batch)
            ranks = rank(group, order)
            kept = np.flatnonzero(ranks <= k)
        result.append((window.join_key(batch.take(kept), key_width), ranks[kept]))
    return result
