"""The typed record paths of the port against the JAX package, on the CPU,
exactly (bytes, and float64 by their bits):

- ``KeyCodec`` packs byte-equal for every field type (negative values,
  float64 -0.0, NaN and infinities, fixed bytes), and its byte order is
  the columns' order;
- the narrow packs raise where the JAX ones raise, with the same message;
- ``window_group_limit`` keeps the same rows;
- ``ColumnarReducer`` gives the same batches for every op, narrow wire
  schemas included, and when it spills;
- ``agg_shuffle`` (map-side combine on and off, spilling reducers too) and
  ``sort_shuffle_batches`` write object trees byte-equal to the JAX
  package's through both packages' ``ShuffleContext``, with equal results;
- q5 and q67 of ``examples/sql_queries.py`` at SF 0.05 through the port
  (``chip_smoke.q5`` / ``q67``, the copies phase 6a runs) equal the
  example's plain-Python reference, the JAX run and ``chip_smoke``'s numpy
  recomputations.

The JAX side runs ``codec="tpu"`` as ``tests/test_torch_record_slice.py``
runs it (``tpu_host_fallback=False``, its numpy TLZ host encoder; the
Pallas kernels in interpret mode in one case); the port runs with
``device="cpu"``. Both packages' encode windows are pinned at one batch
(``encode_inflight_batches=1``), and ``agg_shuffle`` runs again with every
codec window at both packages' defaults.
"""

import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from s3shuffle_tpu import colagg as jax_colagg
from s3shuffle_tpu import structured as jax_structured
from s3shuffle_tpu.batch import RecordBatch as JaxRecordBatch
from s3shuffle_tpu.config import ShuffleConfig as JaxConfig
from s3shuffle_tpu.manager import ShuffleManager as JaxManager
from s3shuffle_tpu.ops import tlz as jax_tlz
from s3shuffle_tpu.shuffle import ShuffleContext as JaxContext
from s3shuffle_tpu.storage.dispatcher import Dispatcher as JaxDispatcher
from s3shuffle_tpu_torch import ShuffleConfig, ShuffleContext
from s3shuffle_tpu_torch import colagg, structured
from s3shuffle_tpu_torch.aggregator import Aggregator
from s3shuffle_tpu_torch.batch import RecordBatch
from torch_jax_native import jax_native_library  # noqa: F401  (loads the JAX oracle's native library)
from torch_port_dispatcher import port_dispatcher_reset  # noqa: F401  (resets the port's process dispatcher)

REPO = Path(__file__).resolve().parent.parent
BS = 2048
BATCH = 4


def _load_example():
    spec = importlib.util.spec_from_file_location("sql_queries", REPO / "examples" / "sql_queries.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


sql_queries = _load_example()


@pytest.fixture(autouse=True)
def no_c_encoder(monkeypatch):
    """The JAX side encodes TLZ host blocks with numpy (its C encoder picks
    other valid matches than the device encoders)."""
    monkeypatch.setattr(jax_tlz, "_encode_block_native", lambda _data: None)


@pytest.fixture
def force_pallas(monkeypatch):
    monkeypatch.setenv("S3SHUFFLE_TPU_CODEC_DEVICE", "1")
    monkeypatch.setenv("S3SHUFFLE_TLZ_PALLAS", "1")


# --- KeyCodec and the narrow packs ---

def _column(field, rng, n):
    if field == "i64":
        col = rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64)
        col[:4] = [np.iinfo(np.int64).min, -1, 0, np.iinfo(np.int64).max]
        return col
    if field == "i32":
        col = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64)
        col[:3] = [-(1 << 31), -1, (1 << 31) - 1]
        return col
    if field == "f64":
        col = rng.normal(0, 1e6, n)
        col[:8] = [-0.0, 0.0, np.nan, np.inf, -np.inf, -1e-300, 5e-324, -np.nan]
        return col
    width = field[1]
    return np.array([rng.bytes(int(rng.integers(0, width + 1))) for _ in range(n)],
                    dtype=f"S{width}")


KEY_SPECS = {
    "i64": ("i64",),
    "i32": ("i32",),
    "f64": ("f64",),
    "bytes": (("bytes", 6),),
    "i32x3": ("i32", "i32", "i32"),
    "i64-f64": ("i64", "f64"),
    "mixed": ("i32", "f64", ("bytes", 3), "i64"),
}


def _bits(col):
    return col.view(np.uint64) if col.dtype == np.float64 else col


@pytest.mark.parametrize("spec", list(KEY_SPECS))
def test_key_codec_packs_like_jax_and_orders_like_the_columns(spec):
    fields = KEY_SPECS[spec]
    rng = np.random.default_rng(len(spec))
    n = 300
    cols = [_column(f, rng, n) for f in fields]
    port, jax = structured.KeyCodec(*fields), jax_structured.KeyCodec(*fields)
    packed = port.pack(*cols)
    assert packed.dtype == np.uint8 and packed.nbytes == n * port.width == n * jax.width
    assert packed.tobytes() == jax.pack(*cols).tobytes()
    for got, want in zip(port.unpack(packed, n), jax.unpack(packed, n)):
        assert got.dtype == want.dtype and np.array_equal(_bits(got), _bits(want))
    # bytes fields also pack from a list of bytes objects
    if any(isinstance(f, tuple) for f in fields):
        listed = [list(c) if c.dtype.kind == "S" else c for c in cols]
        assert port.pack(*listed).tobytes() == packed.tobytes()
    # byte order of the keys == tuple order of the decoded columns
    keys = packed.reshape(n, port.width)
    by_bytes = sorted(range(n), key=lambda i: keys[i].tobytes())
    decoded = port.unpack(packed, n)

    def sort_key(i):
        out = []
        for f, c in zip(fields, decoded):
            v = c[i]
            if f == "f64":
                # IEEE-754 total order: -NaN < -inf < ... < -0.0 < +0.0
                # < ... < +inf < +NaN
                if np.isnan(v):
                    out.append((0 if np.signbit(v) else 2, 0.0, False))
                else:
                    out.append((1, float(v), not np.signbit(v)))
            else:
                out.append(v)
        return tuple(out)

    assert [sort_key(i) for i in by_bytes] == sorted(sort_key(i) for i in range(n))


NARROW_CASES = {
    "i1-over": (lambda m: m.pack_values(np.array([1, 200]), dtypes=("i1",))),
    "i2-under": (lambda m: m.pack_values(np.array([-40000]), np.array([1]), dtypes=("i2", "i4"))),
    "i4-over": (lambda m: m.pack_values(np.array([1 << 31]), dtypes=("i4",))),
    "float-values": (lambda m: m.pack_values(np.array([1.5]), dtypes=("i4",))),
    "arity": (lambda m: m.pack_values(np.array([1]), dtypes=("i4", "i4"))),
    "i32-key-over": (lambda m: m.KeyCodec("i32").pack(np.array([1 << 31]))),
    "i32-key-float": (lambda m: m.KeyCodec("i32").pack(np.array([1.9]))),
    "bytes-too-long": (lambda m: m.KeyCodec(("bytes", 2)).pack(np.array([b"abc"]))),
    "bytes-list-too-long": (lambda m: m.KeyCodec(("bytes", 2), "i64").pack([b"abc"], [1])),
    "unknown-field": (lambda m: m.KeyCodec("u8")),
}


@pytest.mark.parametrize("case", list(NARROW_CASES))
def test_narrow_packs_raise_like_jax(case):
    with pytest.raises(ValueError) as port_err:
        NARROW_CASES[case](structured)
    with pytest.raises(ValueError) as jax_err:
        NARROW_CASES[case](jax_structured)
    assert str(port_err.value) == str(jax_err.value)


def test_narrow_values_pack_and_widen_like_jax():
    rng = np.random.default_rng(4)
    dtypes = ("i1", "i2", "i4", "i8")
    cols = [rng.integers(np.iinfo(d).min, np.iinfo(d).max, 500, dtype=np.int64, endpoint=True)
            for d in ("i1", "i2", "i4", "i8")]
    packed = structured.pack_values(*cols, dtypes=dtypes)
    assert packed.tobytes() == jax_structured.pack_values(*cols, dtypes=dtypes).tobytes()
    assert structured.val_struct_dtype(dtypes) == jax_structured.val_struct_dtype(dtypes)
    wide = structured.widen_values(packed, 500, dtypes)
    assert wide.tobytes() == jax_structured.widen_values(packed, 500, dtypes).tobytes()
    assert np.array_equal(wide.view("<i8").reshape(500, 4), np.column_stack(cols))
    assert structured.pack_values(*cols).tobytes() == jax_structured.pack_values(*cols).tobytes()
    codec = structured.KeyCodec("i32")
    batch = structured.make_batch(codec, (cols[2],), cols[:2], val_dtypes=("i1", "i2"))
    jbatch = jax_structured.make_batch(jax_structured.KeyCodec("i32"), (cols[2],), cols[:2],
                                       val_dtypes=("i1", "i2"))
    assert batch.keys.tobytes() == jbatch.keys.tobytes()
    assert batch.values.tobytes() == jbatch.values.tobytes()
    parts = structured.split_batch(batch, 3)
    assert [p.n for p in parts] == [p.n for p in jax_structured.split_batch(jbatch, 3)]


# --- window_group_limit ---

def _wgl_inputs(case, rng):
    n = 5000
    if case == "dense":
        return rng.integers(0, 10, n), rng.integers(0, 50, n), 3, True
    if case == "dense-smallest":
        return rng.integers(-5, 5, n).astype(np.int16), rng.integers(0, 50, n), 4, False
    if case == "sparse-groups":
        return rng.integers(0, 1 << 40, n) % 7919 * 1000, rng.normal(size=n), 2, True
    if case == "nan-order":
        order = rng.normal(size=n)
        order[::17] = np.nan
        return rng.integers(0, 10, n), order, 5, True
    if case == "k-zero":
        return rng.integers(0, 10, n), rng.integers(0, 50, n), 0, True
    return rng.integers(0, 3, 2), np.array([1.0, 1.0]), 10, True  # k past group sizes


@pytest.mark.parametrize("case", ["dense", "dense-smallest", "sparse-groups", "nan-order",
                                  "k-zero", "tiny"])
def test_window_group_limit_equals_jax(case):
    group, order, k, largest = _wgl_inputs(case, np.random.default_rng(9))
    got = structured.window_group_limit(group, order, k, largest)
    want = jax_structured.window_group_limit(group, order, k, largest)
    assert got.dtype == want.dtype == bool and np.array_equal(got, want)


# --- ColumnarReducer ---

OPS = {
    "sum": (("sum",), None),
    "min": (("min",), None),
    "max": (("max",), None),
    "sum-min-max-narrow": (("sum", "min", "max"), ("i4", "i2", "i1")),
    "max-sum-wide-schema": (("max", "sum"), ("i8", "i8")),
}


def _reducer_batches(cls, ops, val_dtypes, seed):
    rng = np.random.default_rng(seed)
    codec = structured.KeyCodec("i32", ("bytes", 3))
    out = []
    for _ in range(6):
        n = int(rng.integers(200, 900))
        keys = codec.pack(rng.integers(-50, 50, n),
                          np.array([rng.bytes(int(rng.integers(0, 4))) for _ in range(n)],
                                   dtype="S3"))
        kinds = val_dtypes or ("i8",) * len(ops)
        vals = [rng.integers(np.iinfo(d).min, np.iinfo(d).max, n, dtype=np.int64)
                for d in kinds]
        values = structured.pack_values(*vals, dtypes=val_dtypes)
        width = structured.val_schema_width(kinds)
        out.append(cls.from_fixed(n, codec.width, width, keys.copy(), values.copy()))
    return out


def _flatten(batches):
    return [(b.keys.tobytes(), b.values.tobytes(), b.klens.tobytes()) for b in batches if b.n]


@pytest.mark.parametrize("spill", [None, 2048], ids=["in-memory", "spilling"])
@pytest.mark.parametrize("case", list(OPS))
def test_columnar_reducer_equals_jax(case, spill):
    ops, val_dtypes = OPS[case]
    kwargs = {} if spill is None else {"spill_bytes": spill}
    port = colagg.ColumnarReducer(ops, val_dtypes=val_dtypes, **kwargs)
    jax = jax_colagg.ColumnarReducer(ops, val_dtypes=val_dtypes, **kwargs)
    for b in _reducer_batches(RecordBatch, ops, val_dtypes, 1):
        port.add(b)
    for b in _reducer_batches(JaxRecordBatch, ops, val_dtypes, 1):
        jax.add(b)
    if spill is not None:
        assert port.spill_count == jax.spill_count > 0
    got, want = list(port.results()), list(jax.results())
    assert _flatten(got) == _flatten(want)
    merged = RecordBatch.concat(got)
    assert merged.n > 0
    ks = merged.key_strings()
    assert (ks[:-1] < ks[1:]).all()  # sorted, unique keys
    # reduce_chunk and the per-record fallback agree with the stream
    agg = colagg.ColumnarAggregator(ops, val_dtypes=val_dtypes)
    jagg = jax_colagg.ColumnarAggregator(ops, val_dtypes=val_dtypes)
    chunk = _reducer_batches(RecordBatch, ops, val_dtypes, 2)[0]
    jchunk = _reducer_batches(JaxRecordBatch, ops, val_dtypes, 2)[0]
    assert _flatten([agg.new_reducer().reduce_chunk(chunk)]) == \
        _flatten([jagg.new_reducer().reduce_chunk(jchunk)])
    records = list(chunk.iter_records())
    assert list(agg.combine_values_by_key(records)) == list(jagg.combine_values_by_key(records))
    assert agg.supports_columnar and not Aggregator.supports_columnar


def test_columnar_reducer_refuses_ragged_values_like_jax():
    for mod, cls in ((colagg, RecordBatch), (jax_colagg, JaxRecordBatch)):
        reducer = mod.ColumnarReducer(("sum",), val_dtypes=("i4",))
        with pytest.raises(ValueError, match="requires fixed 8-byte values"):
            reducer.add(cls.from_records([(b"a", b"123")]))
    with pytest.raises(ValueError, match="Unknown columnar op"):
        colagg.ColumnarAggregator(("avg",))


# --- agg_shuffle and sort_shuffle_batches through both contexts ---

def _objects(root) -> dict:
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            full = os.path.join(dirpath, fn)
            with open(full, "rb") as f:
                out[os.path.relpath(full, root)] = f.read()
    return out


#: the codec windows both packages run with: the encode window pinned at one
#: batch, or every window at its default
PINNED = {"encode_inflight_batches": 1}


def _contexts(tmp_path, window=PINNED, **knobs):
    knobs = dict(checksum_algorithm="CRC32C", codec_block_size=BS, codec_batch_blocks=BATCH,
                 cleanup=False, **window, **knobs)
    port = ShuffleContext(ShuffleConfig(root_dir=f"file://{tmp_path / 'port'}", **knobs),
                          num_workers=2, device="cpu")
    JaxDispatcher.reset()
    jax = JaxContext(manager=JaxManager(JaxConfig(
        root_dir=f"file://{tmp_path / 'jax'}", codec="tpu", tpu_host_fallback=False,
        **knobs)), num_workers=2)
    return port, jax


def _assert_same_objects(tmp_path):
    port, jax = _objects(tmp_path / "port"), _objects(tmp_path / "jax")
    assert sorted(port) == sorted(jax) and any(n.endswith(".data") for n in port)
    for name in port:
        assert port[name] == jax[name], name


def _typed_input(seed: int, n: int = 6000):
    rng = np.random.default_rng(seed)
    keys = (rng.integers(0, 400, n), rng.integers(-3, 3, n))
    vals = (rng.integers(0, 100_000, n), rng.integers(-5, 5, n), np.ones(n, np.int64))
    return keys, vals


AGG_CASES = {
    "combine": (True, {}),
    "no-combine": (False, {}),
    "combine-spilling": (True, {"aggregator_spill_bytes": 4096, "columnar_batch_rows": 500}),
    "no-combine-spilling": (False, {"aggregator_spill_bytes": 4096}),
}


@pytest.mark.parametrize("case", list(AGG_CASES))
def test_agg_shuffle_objects_and_results_equal_jax(tmp_path, monkeypatch, case):
    _agg_shuffle_equals_jax(tmp_path, monkeypatch, case, PINNED)


@pytest.mark.parametrize("case", list(AGG_CASES))
def test_agg_shuffle_equals_jax_at_the_default_codec_windows(tmp_path, monkeypatch, case):
    _agg_shuffle_equals_jax(tmp_path, monkeypatch, case, {})


def _agg_shuffle_equals_jax(tmp_path, monkeypatch, case, window):
    combine, knobs = AGG_CASES[case]
    spills = {"port": 0, "jax": 0}
    for label, mod in (("port", colagg), ("jax", jax_colagg)):
        original = mod.ColumnarReducer._spill

        def counted(self, run, _orig=original, _label=label):
            spills[_label] += 1
            return _orig(self, run)

        monkeypatch.setattr(mod.ColumnarReducer, "_spill", counted)
    keys, vals = _typed_input(3)
    ops, dtypes = ("sum", "min", "sum"), ("i4", "i1", "i1")
    port_ctx, jax_ctx = _contexts(tmp_path, window, **knobs)
    codec = structured.KeyCodec("i32", "i64")
    jcodec = jax_structured.KeyCodec("i32", "i64")
    parts = structured.split_batch(structured.make_batch(codec, keys, vals, dtypes), 4)
    jparts = jax_structured.split_batch(jax_structured.make_batch(jcodec, keys, vals, dtypes), 4)
    got = structured.agg_shuffle(port_ctx, codec, parts, ops, 3, combine, dtypes)
    want = jax_structured.agg_shuffle(jax_ctx, jcodec, jparts, ops, 3, combine, dtypes)
    assert all(np.array_equal(g, w) for g, w in zip(got[0], want[0]))
    assert np.array_equal(got[1], want[1])
    _assert_same_objects(tmp_path)
    if knobs:
        assert spills["port"] == spills["jax"] > 0
    # the plain numpy sums
    order = np.lexsort(keys[::-1])
    k0, k1 = keys[0][order], keys[1][order]
    starts = np.flatnonzero(np.r_[True, (k0[1:] != k0[:-1]) | (k1[1:] != k1[:-1])])
    expect = {
        (int(a), int(b)): (int(s), int(m), int(c))
        for a, b, s, m, c in zip(k0[starts], k1[starts],
                                 np.add.reduceat(vals[0][order], starts),
                                 np.minimum.reduceat(vals[1][order], starts),
                                 np.add.reduceat(vals[2][order], starts))
    }
    assert {(int(a), int(b)): tuple(int(x) for x in row)
            for a, b, row in zip(got[0][0], got[0][1], got[1])} == expect


def test_agg_shuffle_pallas_and_sort_shuffle_batches_equal_jax(tmp_path, force_pallas):
    """The JAX side on its Pallas kernels (interpret mode); the range sort
    yields decoded batches in global key order."""
    rng = np.random.default_rng(8)
    n = 4000
    cols = (rng.integers(0, 5, n), rng.normal(size=n), rng.integers(-1 << 40, 1 << 40, n))
    port_ctx, jax_ctx = _contexts(tmp_path)
    codec = structured.KeyCodec("i64", "f64", "i64")
    jcodec = jax_structured.KeyCodec("i64", "f64", "i64")
    vals = (rng.integers(0, 1000, n),)
    parts = structured.split_batch(structured.make_batch(codec, cols, vals), 3)
    jparts = jax_structured.split_batch(jax_structured.make_batch(jcodec, cols, vals), 3)
    got = list(structured.sort_shuffle_batches(port_ctx, codec, parts, 1, 3))
    want = list(jax_structured.sort_shuffle_batches(jax_ctx, jcodec, jparts, 1, 3))
    assert len(got) == len(want)
    for (gk, gv), (wk, wv) in zip(got, want):
        assert all(np.array_equal(_bits(a), _bits(b)) for a, b in zip(gk, wk))
        assert np.array_equal(gv, wv)
    _assert_same_objects(tmp_path)
    keys = np.concatenate([codec.pack(*k) for k, _v in got]).reshape(-1, codec.width)
    flat = keys.view(f"S{codec.width}").ravel()
    assert len(flat) == n and (flat[:-1] <= flat[1:]).all()


# --- q5 and q67 at SF 0.05 ---

@pytest.mark.parametrize("query", ["q5", "q67"])
def test_sql_queries_equal_the_reference_the_jax_run_and_numpy(tmp_path, query):
    sales, returns = chip_smoke.gen_tables(0.05)
    jsales, jreturns = sql_queries.gen_tables(0.05)
    for mine, theirs in ((sales, jsales), (returns, jreturns)):
        assert mine.keys() == theirs.keys()
        assert all(np.array_equal(mine[c], theirs[c]) for c in mine)
    assert (chip_smoke.SQL_MAPS, chip_smoke.SQL_REDUCERS, chip_smoke.SQL_TOP_K) == \
        (sql_queries.N_MAPS, sql_queries.N_REDUCERS, sql_queries.TOP_K)
    port_ctx, jax_ctx = _contexts(tmp_path)
    got = getattr(chip_smoke, query)(chip_smoke.TypedStages(port_ctx), sales, returns)
    jax_result, reference = getattr(sql_queries, query)(sql_queries.ColumnarStages(jax_ctx),
                                                        jsales, jreturns)
    plain = getattr(chip_smoke, f"{query}_numpy")(sales, returns)
    assert got and got == reference() == jax_result == plain


READ_ROUTES = {
    "records": dict(materialize="records"),
    "records-natural-order": dict(materialize="records", key_ordering="natural"),
    "records-custom-order": dict(materialize="records", key_ordering="reversed"),
    "pickled-serializer": dict(materialize="records", serializer="pickle"),
}


@pytest.mark.parametrize("route", list(READ_ROUTES))
def test_columnar_aggregator_read_routes_equal_jax(tmp_path, route):
    """``run_shuffle`` with a ColumnarAggregator through the reader's other
    routes: records in key order (the reducer's own order), a custom
    ordering (external sorter over reduced batches), and a non-batch
    serializer (the per-record dict combine on both sides)."""
    from s3shuffle_tpu.dependency import BytesHashPartitioner as JaxBytesHash
    from s3shuffle_tpu.dependency import natural_key as jax_natural
    from s3shuffle_tpu.serializer import ColumnarKVSerializer as JaxColumnarKV
    from s3shuffle_tpu.serializer import PickleBatchSerializer as JaxPickle
    from s3shuffle_tpu_torch.dependency import BytesHashPartitioner, natural_key
    from s3shuffle_tpu_torch.serializer import ColumnarKVSerializer, PickleBatchSerializer

    knobs = READ_ROUTES[route]
    keys, vals = _typed_input(6, n=3000)
    dtypes = ("i4", "i1", "i1")
    port_ctx, jax_ctx = _contexts(tmp_path)
    results = []
    for ctx, mod, agg_mod, part, ser, natural in (
        (port_ctx, structured, colagg, BytesHashPartitioner,
         (ColumnarKVSerializer, PickleBatchSerializer), natural_key),
        (jax_ctx, jax_structured, jax_colagg, JaxBytesHash, (JaxColumnarKV, JaxPickle),
         jax_natural),
    ):
        codec = mod.KeyCodec("i32", "i64")
        parts = mod.split_batch(mod.make_batch(codec, keys, vals, dtypes), 3)
        serializer = ser[1]() if knobs.get("serializer") == "pickle" else ser[0]()
        inputs = [list(p.iter_records()) for p in parts] if knobs.get("serializer") else parts
        ordering = {"natural": natural, "reversed": lambda k: bytes(255 - b for b in k)}.get(
            knobs.get("key_ordering"))
        out = ctx.run_shuffle(
            inputs, partitioner=part(3),
            aggregator=agg_mod.ColumnarAggregator(("sum", "max", "sum"), val_dtypes=dtypes),
            serializer=serializer, key_ordering=ordering, map_side_combine=True,
            materialize="records",
        )
        results.append([[(bytes(k), bytes(v)) for k, v in p] for p in out])
    if knobs.get("serializer"):
        # the per-record combine's output order is not defined: compare sets
        results = [[dict(p) for p in r] for r in results]
    assert results[0] == results[1]
    assert sum(len(p) for p in results[0]) == len(set(zip(*keys)))
    if knobs.get("key_ordering") == "reversed":
        for p in results[0]:
            assert [k for k, _v in p] == sorted((k for k, _v in p), reverse=True)
