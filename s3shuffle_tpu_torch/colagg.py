"""Columnar hash aggregation over RecordBatches, the vectorized reduce
tail (a copy of the JAX package's ``colagg.py``; the reduction order is the
JAX one, so results are bit-equal).

Parity: the reference hands aggregation to Spark's ExternalAppendOnlyMap
(storage/S3ShuffleReader.scala:124-138). Records stay columnar end to end:

- group-by = stable argsort over key bytes + run-boundary detection
  (``argsort_by_key``, no per-record hashing);
- combine = ``ufunc.reduceat`` segmented reductions over fixed-width int64
  value columns (sum/min/max; counts are sums over a ones column);
- bounded memory = pending batches consolidate (keys-only argsort +
  segmented gather + reduceat) at a byte budget and spill as sorted
  unique-key runs; runs merge with the frontier invariant of
  :class:`s3shuffle_tpu_torch.batch.BatchSorter` — inclusive frontier cuts
  are safe because every run has unique keys and the ops are commutative.

The reduced output streams in key-byte-sorted order, so
``key_ordering=natural_key`` needs no extra sort after a columnar combine.
These are host numpy stages: the shuffle around them runs the TLZ kernels.
"""

from __future__ import annotations

import os
import tempfile
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from s3shuffle_tpu_torch.aggregator import Aggregator
from s3shuffle_tpu_torch.batch import (
    RecordBatch,
    cut_sorted_head,
    _ragged_gather,
    iter_record_batches,
    read_frames,
    sort_batches,
    write_frame,
)

#: op name -> (ufunc, identity) — identity only used for empty-input guards
_OPS = {
    "sum": np.add,
    "min": np.minimum,
    "max": np.maximum,
}


def _validate_ops(ops: Sequence[str]) -> Tuple[str, ...]:
    ops = tuple(ops)
    if not ops:
        raise ValueError("ColumnarAggregator needs at least one value column op")
    for op in ops:
        if op not in _OPS:
            raise ValueError(f"Unknown columnar op {op!r}; supported: {sorted(_OPS)}")
    return ops


class ColumnarReducer:
    """Stateful bounded-memory reducer: feed RecordBatches via :meth:`add`,
    drain reduced (sorted, unique-key) RecordBatches from :meth:`results`.

    Values must be fixed-width rows of ``len(ops)`` little-endian int64
    columns; keys are arbitrary ragged bytes. Raw and already-reduced batches
    mix freely in the pending set — reduction is idempotent on reduced data —
    so consolidation is one code path.
    """

    def __init__(
        self,
        ops: Sequence[str],
        spill_bytes: int = 256 * 1024 * 1024,
        spill_dir: Optional[str] = None,
        val_dtypes: Optional[Sequence[str]] = None,
    ):
        self.ops = _validate_ops(ops)
        self.ncols = len(self.ops)
        self.value_width = 8 * self.ncols
        # Narrow wire schema (structured.pack_values dtypes): incoming raw
        # batches carry packed narrow rows; they widen to int64 here BEFORE
        # any reduction, so only per-row inputs — never aggregates — must
        # fit the narrow widths. Already-wide batches (map-side-combined
        # partials, re-added reduced runs) pass through untouched; the two
        # are told apart by row width, which is unambiguous whenever the
        # schema is actually narrow.
        self._val_dtypes = tuple(val_dtypes) if val_dtypes else None
        if self._val_dtypes is not None:
            from s3shuffle_tpu_torch.structured import val_schema_width

            if len(self._val_dtypes) != self.ncols:
                raise ValueError(
                    f"val_dtypes has {len(self._val_dtypes)} columns, "
                    f"ops has {self.ncols}"
                )
            self._narrow_width = val_schema_width(self._val_dtypes)
            if self._narrow_width == self.value_width:
                self._val_dtypes = None  # all-i8 schema: already wide
        self._spill_bytes = max(1, spill_bytes)
        self._spill_dir = spill_dir
        self._pending: List[RecordBatch] = []
        self._pending_bytes = 0
        self._spills: List[str] = []
        self.spill_count = 0
        self._all_sum = all(op == "sum" for op in self.ops)

    # ------------------------------------------------------------------
    def _widen(self, batch: RecordBatch) -> RecordBatch:
        from s3shuffle_tpu_torch.structured import widen_values

        out = RecordBatch(
            batch.klens,
            np.full(batch.n, self.value_width, dtype=np.int32),
            batch.keys,
            widen_values(batch.values, batch.n, self._val_dtypes),
        )
        out._kw, out._vw = batch._kw, self.value_width
        return out

    def _coerce(self, batch: RecordBatch) -> RecordBatch:
        """Validate value widths and widen declared narrow rows to the wide
        int64 combiner representation — the shared entry check of both the
        stateful :meth:`add` path and the one-shot :meth:`reduce_chunk`."""
        if batch.vlens.size and not (batch.vlens == self.value_width).all():
            if (
                self._val_dtypes is not None
                and (batch.vlens == self._narrow_width).all()
            ):
                return self._widen(batch)
            raise ValueError(
                f"columnar aggregation requires fixed {self.value_width}-byte "
                f"values ({self.ncols} int64 columns"
                + (
                    f") or the declared {self._narrow_width}-byte narrow "
                    f"schema {self._val_dtypes}"
                    if self._val_dtypes is not None
                    else ""
                )
                + "; got ragged/mismatched vlens"
            )
        return batch

    def reduce_chunk(self, batch: RecordBatch) -> RecordBatch:
        """One-shot in-memory reduce of a single batch: argsort + reduceat
        over just these rows, touching NO pending/spill state. Output rows
        are sorted unique-key WIDE partials, the shape the reduce-side merge
        accepts mixed with raw rows (the JAX package's skew plane pre-reduces
        hot partitions' chunks with it)."""
        if batch.n == 0:
            return batch
        return self._reduce(self._coerce(batch))

    def add(self, batch: RecordBatch) -> None:
        if batch.n == 0:
            return
        batch = self._coerce(batch)
        self._pending.append(batch)
        self._pending_bytes += batch.nbytes
        if self._pending_bytes >= self._spill_bytes:
            merged = self._reduce_pending(self._pending)
            self._pending = [merged]
            self._pending_bytes = merged.nbytes
            # High-cardinality keys barely shrink under reduction — without
            # this spill the next consolidation would re-sort ~budget bytes
            # per incoming batch (quadratic). Half-budget is the classic cut.
            if merged.nbytes >= self._spill_bytes // 2:
                self._spill(merged)
                self._pending = []
                self._pending_bytes = 0

    # ------------------------------------------------------------------
    def _values_matrix(self, batch: RecordBatch) -> np.ndarray:
        return (
            np.ascontiguousarray(batch.values)
            .reshape(batch.n, self.value_width)
            .view("<i8")
        )

    def _reduce_pending(self, batches: List[RecordBatch]) -> RecordBatch:
        """Reduce a batch LIST without materializing its concatenation —
        sort_batches' keys-only argsort + segmented gather."""
        return self._reduce(sort_batches(batches), presorted=True)

    def _reduce(self, batch: RecordBatch, presorted: bool = False) -> RecordBatch:
        """Sort ``batch`` by key and collapse equal-key runs with the column
        ops. Output keys are sorted and unique."""
        n = batch.n
        if n == 0:
            return batch
        sb = batch if presorted else batch.take(batch.argsort_by_key())
        klens = sb.klens
        ks = sb.key_strings()
        neq = np.empty(n, dtype=bool)
        neq[0] = True
        # padded S-compare ties (one key a zero-pad prefix of another) are
        # resolved by length — equal keys require equal padded bytes AND lens
        np.logical_or(ks[1:] != ks[:-1], klens[1:] != klens[:-1], out=neq[1:])
        starts = np.flatnonzero(neq)
        vals = self._values_matrix(sb)
        if len(starts) == n:
            # all keys unique — the sorted batch IS the reduction
            return sb
        if self._all_sum:
            out = np.add.reduceat(vals, starts, axis=0)
        else:
            out = np.empty((len(starts), self.ncols), dtype="<i8")
            for c, op in enumerate(self.ops):
                out[:, c] = _OPS[op].reduceat(np.ascontiguousarray(vals[:, c]), starts)
        g = len(starts)
        return RecordBatch(
            np.ascontiguousarray(klens[starts]),
            np.full(g, self.value_width, dtype=np.int32),
            _ragged_gather(sb.keys, sb.koffsets, sb.klens, starts),
            np.ascontiguousarray(out).view(np.uint8).ravel(),
        )

    def _spill(self, run: RecordBatch) -> None:
        fd, path = tempfile.mkstemp(prefix="s3shuffle-colagg-", dir=self._spill_dir)
        with os.fdopen(fd, "wb") as f:
            for chunk in iter_record_batches(run):
                write_frame(f, chunk)
        self._spills.append(path)
        self.spill_count += 1

    # ------------------------------------------------------------------
    def results(self) -> Iterator[RecordBatch]:
        """Drain the reduction. Streams sorted unique-key batches; cleans up
        spill files on exhaustion (or error)."""
        final = self._reduce_pending(self._pending)
        self._pending = []
        self._pending_bytes = 0
        if not self._spills:
            yield from iter_record_batches(final)
            return
        try:
            yield from self._merge_runs(final)
        finally:
            self.cleanup()

    def _merge_runs(self, final: RecordBatch) -> Iterator[RecordBatch]:
        def run_frames(path: str) -> Iterator[RecordBatch]:
            with open(path, "rb") as f:
                yield from read_frames(f)

        iters: List[Optional[Iterator[RecordBatch]]] = [
            run_frames(p) for p in self._spills
        ]
        if final.n:
            iters.append(iter(iter_record_batches(final)))
        pending: List[RecordBatch] = [RecordBatch.empty() for _ in iters]

        def refill(r: int) -> None:
            if pending[r].n == 0 and iters[r] is not None:
                nxt = next(iters[r], None)  # type: ignore[arg-type]
                if nxt is None:
                    iters[r] = None
                else:
                    pending[r] = nxt

        while True:
            for r in range(len(iters)):
                refill(r)
            live = [r for r in range(len(iters)) if iters[r] is not None]
            if not live:
                rest = self._reduce_pending([p for p in pending if p.n])
                if rest.n:
                    yield from iter_record_batches(rest)
                return
            # frontier = smallest LAST-loaded key over undrained runs. Keys
            # are unique within a run, so unloaded chunks hold keys strictly
            # greater than the frontier → every copy of a key ≤ frontier is
            # resident → inclusive cuts emit complete groups.
            frontier = min(
                pending[r].keys[pending[r].koffsets[-2] :].tobytes() for r in live
            )
            cuts = [
                cut_sorted_head(p, frontier, inclusive=True) if p.n else 0
                for p in pending
            ]
            spans = [p.slice_rows(0, c) for p, c in zip(pending, cuts) if c]
            for r, c in enumerate(cuts):
                if c:
                    pending[r] = pending[r].slice_rows(c, pending[r].n)
            # progress is guaranteed: the run attaining the frontier cuts its
            # whole loaded chunk
            if spans:
                out = self._reduce_pending(spans)
                if out.n:
                    yield from iter_record_batches(out)

    def cleanup(self) -> None:
        for path in self._spills:
            try:
                os.remove(path)
            except OSError:
                pass
        self._spills = []


class ColumnarAggregator(Aggregator):
    """Aggregator whose combine is expressible as per-column int64 reductions
    — the declaration that lets the read plane (and the map-side combine in
    the write plane) run the vectorized :class:`ColumnarReducer` instead of
    the per-record dict loop.

    Values are fixed-width rows of ``len(ops)`` little-endian int64 columns;
    ``ops[c]`` ∈ {"sum", "min", "max"} reduces column ``c`` over equal keys.
    Combiner rows are ALWAYS wide int64; without ``val_dtypes`` a value row
    IS a combiner row (``create_combiner`` is identity and
    ``combine_values_by_key`` ≡ ``combine_combiners_by_key``). With a narrow
    ``val_dtypes`` wire schema, incoming rows may be either narrow (raw map
    output) or wide (partials) — told apart by row length — and widen on
    entry, so the equivalence still holds on the wide representation.

    The per-record fallback (non-columnar serializer, custom read paths)
    stays correct via the inherited dict machinery with numpy row merges.
    """

    supports_columnar = True

    def __init__(
        self,
        ops: Sequence[str],
        spill_bytes: int = 256 * 1024 * 1024,
        spill_dir: Optional[str] = None,
        val_dtypes: Optional[Sequence[str]] = None,
    ):
        self.ops = _validate_ops(ops)
        self.ncols = len(self.ops)
        self.value_width = 8 * self.ncols
        self.val_dtypes = tuple(val_dtypes) if val_dtypes else None
        super().__init__(
            # per-record fallback: combiners are ALWAYS wide int64 rows;
            # narrow wire values widen in create_combiner / merge_value, so
            # the dict loop agrees with the columnar plane bit-for-bit.
            # Bound methods, NOT lambdas: the cluster path pickles the whole
            # dependency (aggregator included) to map/reduce worker
            # processes (cluster.py), and lambdas don't pickle.
            create_combiner=self._widen_row,
            merge_value=self._merge_value,
            merge_combiners=self._merge_rows,
            spill_bytes=spill_bytes,
            spill_dir=spill_dir,
        )

    def _merge_value(self, c, v):
        return self._merge_rows(c, self._widen_row(v))

    def _widen_row(self, v):
        if self.val_dtypes is None:
            return v
        b = bytes(v)
        if len(b) == self.value_width:
            return b  # already-wide row (e.g. a map-side-combined partial)
        from s3shuffle_tpu_torch.structured import val_schema_width, val_struct_dtype

        if len(b) != val_schema_width(self.val_dtypes):
            raise ValueError(
                f"value row is {len(b)} bytes; expected the declared narrow "
                f"schema {self.val_dtypes} ({val_schema_width(self.val_dtypes)} "
                f"bytes) or wide int64 rows ({self.value_width} bytes)"
            )
        row = np.frombuffer(b, dtype=val_struct_dtype(self.val_dtypes))
        return np.array(
            [int(row[f"c{j}"][0]) for j in range(self.ncols)], dtype="<i8"
        ).tobytes()

    def _merge_rows(self, a, b):
        av = np.frombuffer(bytes(a), dtype="<i8")
        bv = np.frombuffer(bytes(b), dtype="<i8")
        if len(av) != self.ncols or len(bv) != self.ncols:
            raise ValueError(
                f"columnar value rows must be {self.value_width} bytes "
                f"({self.ncols} int64 columns)"
            )
        out = np.empty(self.ncols, dtype="<i8")
        for c, op in enumerate(self.ops):
            out[c] = _OPS[op](av[c], bv[c])
        return out.tobytes()

    def new_reducer(
        self, spill_bytes: Optional[int] = None, spill_dir: Optional[str] = None
    ) -> ColumnarReducer:
        return ColumnarReducer(
            self.ops,
            spill_bytes=self.spill_bytes if spill_bytes is None else spill_bytes,
            spill_dir=spill_dir if spill_dir is not None else self.spill_dir,
            val_dtypes=self.val_dtypes,
        )

    # ------------------------------------------------------------------
    def reduce_batches(
        self,
        batches: Iterable[RecordBatch],
        spill_bytes: Optional[int] = None,
        spill_dir: Optional[str] = None,
    ) -> Iterator[RecordBatch]:
        """One-shot convenience: reduce a batch stream to sorted unique-key
        batches with bounded memory."""
        reducer = self.new_reducer(spill_bytes=spill_bytes, spill_dir=spill_dir)
        for batch in batches:
            reducer.add(batch)
        return reducer.results()
