"""The record layer's row gathers on the CPU: the port's native route (its
own C++ library's ``slz_gather_fixed``, ``slz_ragged_gather`` and
``slz_gather_fixed_segmented``) against its numpy route and against the
JAX package's ``batch.py``, on seeded batches: fixed widths on both sides of
the 64-byte switch of ``RecordBatch.gather_from``, ragged rows, one batch,
empty batches and an empty permutation. The route counter must move on the
route taken, and TeraSort-shaped (100-byte row) shuffles must still write
objects byte-equal to the JAX package's, with the segmented route taken.
"""

import os

import numpy as np
import pytest

from s3shuffle_tpu import batch as jax_batch
from s3shuffle_tpu.config import ShuffleConfig as JaxConfig
from s3shuffle_tpu.manager import ShuffleManager as JaxManager
from s3shuffle_tpu.ops import tlz as jax_tlz
from s3shuffle_tpu.serializer import ColumnarKVSerializer as JaxColumnarKV
from s3shuffle_tpu.shuffle import ShuffleContext as JaxContext
from s3shuffle_tpu.storage.dispatcher import Dispatcher as JaxDispatcher
from s3shuffle_tpu_torch import ShuffleConfig, ShuffleContext, ShuffleManager
from s3shuffle_tpu_torch import batch
from s3shuffle_tpu_torch.codec import native
from s3shuffle_tpu_torch.serializer import ColumnarKVSerializer
from torch_jax_native import jax_native_library  # noqa: F401  (loads the JAX oracle's native library)
from torch_port_dispatcher import port_dispatcher_reset  # noqa: F401  (resets the port's process dispatcher)

#: (key width, value width) per batch set; None = ragged
SHAPES = {
    "fixed-10+90": (10, 90),   # TeraSort: 100-byte rows, the segmented route
    "fixed-16+48": (16, 48),   # exactly at the switch
    "fixed-8+16": (8, 16),     # under the switch: concat + take
    "fixed-0+70": (0, 70),     # an empty key column
    "ragged": (None, None),
}


def _batches(cls, shape, seed, counts):
    kw, vw = SHAPES[shape]
    rng = np.random.default_rng(seed)
    out = []
    for n in counts:
        klens = np.full(n, kw, np.int32) if kw is not None else rng.integers(0, 40, n).astype(np.int32)
        vlens = np.full(n, vw, np.int32) if vw is not None else rng.integers(0, 200, n).astype(np.int32)
        keys = rng.integers(0, 256, int(klens.sum()), dtype=np.uint8)
        values = rng.integers(0, 256, int(vlens.sum()), dtype=np.uint8)
        out.append(cls(klens, vlens, keys, values))
    return out


#: batch counts: several (with an empty one), a single one, all empty
COUNTS = {"several": (300, 0, 17, 1, 250), "single": (400,), "empty": (0, 0)}


def _columns(b):
    return (np.asarray(b.klens).tolist(), np.asarray(b.vlens).tolist(),
            bytes(np.asarray(b.keys)), bytes(np.asarray(b.values)))


def _force_numpy(monkeypatch):
    """The port's gathers as they run without the native library."""
    monkeypatch.setattr(batch, "_native_gather", False)
    monkeypatch.setattr(batch, "_native_gather_fixed", False)


def _native_loaded():
    assert native.native_available(), "the port's native library must build here"
    assert batch._load_native_gather()


def _perm(total, seed, empty):
    if empty:
        return np.empty(0, dtype=np.int64)
    return np.random.default_rng(seed).permutation(total)


@pytest.mark.parametrize("empty_perm", [False, True], ids=["perm", "empty-perm"])
@pytest.mark.parametrize("counts", list(COUNTS))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_gather_from_native_equals_numpy_and_jax(shape, counts, empty_perm, monkeypatch):
    _native_loaded()
    mine = _batches(batch.RecordBatch, shape, 1, COUNTS[counts])
    theirs = _batches(jax_batch.RecordBatch, shape, 1, COUNTS[counts])
    perm = _perm(sum(COUNTS[counts]), 2, empty_perm)
    batch.reset_gather_routes()
    native_out = _columns(batch.RecordBatch.gather_from(mine, perm))
    routes = dict(batch.GATHER_ROUTES)
    jax_out = _columns(jax_batch.RecordBatch.gather_from(theirs, perm))
    _force_numpy(monkeypatch)
    numpy_out = _columns(batch.RecordBatch.gather_from(mine, perm))
    concat_take = _columns(batch.RecordBatch.concat(mine).take(perm)) if len(perm) else None
    assert native_out == numpy_out == jax_out
    if concat_take is not None:
        assert native_out == concat_take
    kw, vw = SHAPES[shape]
    segmented = counts == "several" and kw is not None and kw + vw >= 64
    assert routes["native-segmented"] == int(segmented)
    assert routes["numpy"] == 0


@pytest.mark.parametrize("row_len", [1, 10, 16, 17, 90, 100])
@pytest.mark.parametrize("route", ["native", "numpy"])
def test_gather_fixed_equals_jax(row_len, route, monkeypatch):
    _native_loaded()
    if route == "numpy":
        _force_numpy(monkeypatch)
    rng = np.random.default_rng(row_len)
    buf = rng.integers(0, 256, 513 * row_len, dtype=np.uint8)
    idx = rng.integers(0, 513, 2000)
    batch.reset_gather_routes()
    got = batch._gather_fixed(buf, row_len, idx)
    assert batch.GATHER_ROUTES["native-fixed" if route == "native" else "numpy"] == 1
    assert bytes(got) == bytes(jax_batch._gather_fixed(buf, row_len, idx))
    assert bytes(got) == bytes(buf.reshape(-1, row_len)[idx].ravel())
    assert len(batch._gather_fixed(buf, row_len, idx[:0])) == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("route", ["native", "numpy"])
def test_ragged_gather_equals_jax(seed, route, monkeypatch):
    _native_loaded()
    if route == "numpy":
        _force_numpy(monkeypatch)
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 40, 700).astype(np.int32)
    lens[::7] = 0  # empty rows
    offsets = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    buf = rng.integers(0, 256, int(offsets[-1]), dtype=np.uint8)
    idx = rng.integers(0, len(lens), 1500)
    batch.reset_gather_routes()
    got = batch._ragged_gather(buf, offsets, lens, idx)
    assert batch.GATHER_ROUTES["native-ragged" if route == "native" else "numpy"] == 1
    want = b"".join(bytes(buf[offsets[i]:offsets[i] + lens[i]]) for i in idx)
    assert bytes(got) == want == bytes(jax_batch._ragged_gather(buf, offsets, lens, idx))


@pytest.mark.parametrize("counts", list(COUNTS))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_sort_batches_equals_numpy_and_jax(shape, counts, monkeypatch):
    _native_loaded()
    mine = _batches(batch.RecordBatch, shape, 3, COUNTS[counts])
    theirs = _batches(jax_batch.RecordBatch, shape, 3, COUNTS[counts])
    native_out = _columns(batch.sort_batches(mine))
    jax_out = _columns(jax_batch.sort_batches(theirs))
    _force_numpy(monkeypatch)
    assert native_out == _columns(batch.sort_batches(mine)) == jax_out


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_batch_sorter_spill_grouping_equals_jax(route, monkeypatch, tmp_path):
    """The external sorter's spill groups rows by bucket with
    ``gather_from`` straight out of the pending batches."""
    _native_loaded()
    if route == "numpy":
        _force_numpy(monkeypatch)
    mine = _batches(batch.RecordBatch, "fixed-10+90", 4, (400, 300, 200))
    theirs = _batches(jax_batch.RecordBatch, "fixed-10+90", 4, (400, 300, 200))
    outs = []
    for mod, batches in ((batch, mine), (jax_batch, theirs)):
        sorter = mod.BatchSorter(spill_bytes=20_000, spill_dir=str(tmp_path))
        for b in batches:
            sorter.add(b)
        out = mod.RecordBatch.concat(list(sorter.sorted_batches()))
        assert sorter.spill_count > 0
        outs.append(_columns(out))
        sorter.cleanup()
    assert outs[0] == outs[1]


# --- TeraSort objects through both packages ---

BS, BATCH, MAPS, PARTS = 2048, 4, 3, 3


def _terasort(cls, seed=7, n=1500):
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (16, 90), dtype=np.uint8)
    out = []
    for _ in range(MAPS):
        keys = rng.integers(0, 256, (n, 10), dtype=np.uint8).reshape(-1)
        out.append(cls(np.full(n, 10, np.int32), np.full(n, 90, np.int32), keys,
                       pool[rng.integers(0, 16, n)].reshape(-1)))
    return out


def _objects(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            with open(os.path.join(dirpath, fn), "rb") as f:
                out[os.path.relpath(os.path.join(dirpath, fn), root)] = f.read()
    return out


@pytest.mark.parametrize("spill", [False, True], ids=["in-memory", "map-and-reduce-spills"])
def test_terasort_objects_stay_byte_equal_on_the_native_route(tmp_path, monkeypatch, spill):
    _native_loaded()
    # the JAX side's numpy TLZ host encoder (its C encoder picks other valid
    # matches on column-frame blocks)
    monkeypatch.setattr(jax_tlz, "_encode_block_native", lambda _data: None)
    extra = dict(max_buffer_size_task=24 * 1024, columnar_batch_rows=500,
                 sorter_spill_bytes=40 * 1024) if spill else {}
    knobs = dict(checksum_algorithm="CRC32C", codec_block_size=BS, codec_batch_blocks=BATCH,
                 cleanup=False, encode_inflight_batches=1, **extra)
    batch.reset_gather_routes()
    mgr = ShuffleManager(ShuffleConfig(root_dir=f"file://{tmp_path}/port", **knobs), device="cpu")
    port_out = ShuffleContext(manager=mgr, num_workers=2).sort_by_key(
        _terasort(batch.RecordBatch), PARTS, serializer=ColumnarKVSerializer(),
        materialize="batches", cleanup=False)
    routes = dict(batch.GATHER_ROUTES)
    JaxDispatcher.reset()
    jax_mgr = JaxManager(JaxConfig(root_dir=f"file://{tmp_path}/jax", codec="tpu",
                                   tpu_host_fallback=False, **knobs))
    jax_out = JaxContext(manager=jax_mgr, num_workers=2).sort_by_key(
        _terasort(jax_batch.RecordBatch), PARTS, serializer=JaxColumnarKV(),
        materialize="batches", cleanup=False)
    mine, theirs = _objects(tmp_path / "port"), _objects(tmp_path / "jax")
    assert mine and sorted(mine) == sorted(theirs)
    for key in mine:
        assert mine[key] == theirs[key], key
    rows = [[k + v for b in p for k, v in b.iter_records()] for p in port_out]
    assert rows == [[k + v for b in p for k, v in b.iter_records()] for p in jax_out]
    assert routes["native-segmented"] > 0 and routes["numpy"] == 0
