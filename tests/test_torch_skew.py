"""The skew plane of the port against the JAX package, on the CPU, at a few
KiB (the cases of ``tests/test_skew_plane.py``, each held against the JAX
package):

- **wire**: the skew trailer round-trips beside the parity geometry
  trailer, is absent when no prong engaged, and the index objects are
  byte-equal to the JAX package's; each package parses the other's;
- **combine sidecar**: the aggregated output is equal with the sidecar on
  and off, in the port and in the JAX package; with it on, data, index and
  checksum objects are byte-equal to the JAX package's (the TLZ codec, the
  port on ``device="cpu"``); non-aggregating dependencies pass through; a
  read without an aggregator refuses combined partials;
- **splitting**: split scans return the bytes of unsplit reads across
  split counts × coalescing × parity, with objects byte-equal to the JAX
  package's and the same plans; the fan-out cap, the composite fat index
  v3, the short-part prefix, the group budget funded once, the
  single-spill split, inert at 0;
- **hot fan-out**: reads divert to parity exactly when the object is hot
  and the range is at least one parity chunk, as often as in the JAX
  package, with the bytes unchanged;
- **off switches**: the knobs at 0 leave the request pattern and the index
  wire as they are, and the knobs on add no store op on the write side.

Every test that turns a registry on or touches ``OBJECT_GETS`` resets it
in a fixture's teardown. No test asserts a wall-clock budget.
"""

import os
import random
import struct
import threading
import time

import numpy as np
import pytest

from s3shuffle_tpu.batch import RecordBatch as JaxRecordBatch
from s3shuffle_tpu.block_ids import ShuffleBlockId as JaxBlockId
from s3shuffle_tpu.colagg import ColumnarAggregator as JaxColumnarAggregator
from s3shuffle_tpu.config import ShuffleConfig as JaxConfig
from s3shuffle_tpu.dependency import BytesHashPartitioner as JaxBytesHashPartitioner
from s3shuffle_tpu.dependency import ShuffleDependency as JaxDependency
from s3shuffle_tpu.manager import ShuffleManager as JaxManager
from s3shuffle_tpu.metadata.helper import ScanIndexMemo as JaxMemo
from s3shuffle_tpu.metadata.helper import ShuffleHelper as JaxHelper
from s3shuffle_tpu.metrics import registry as jax_reg
from s3shuffle_tpu.ops import tlz as jax_tlz
from s3shuffle_tpu.read import scan_plan as jax_scan_plan
from s3shuffle_tpu.read.chunked_fetch import ChunkedRangeFetcher as JaxFetcher
from s3shuffle_tpu.serializer import ColumnarKVSerializer as JaxColumnarKV
from s3shuffle_tpu import skew as jax_skew
from s3shuffle_tpu.storage.dispatcher import Dispatcher as JaxDispatcher
from s3shuffle_tpu.write.composite_commit import CompositeCommitAggregator as JaxAggregator
from s3shuffle_tpu.write.map_output_writer import MapOutputWriter as JaxMapOutputWriter
from s3shuffle_tpu.write.single_spill import SingleSpillMapOutputWriter as JaxSingleSpill
from s3shuffle_tpu_torch import ShuffleConfig, ShuffleManager, skew
from s3shuffle_tpu_torch.batch import RecordBatch
from s3shuffle_tpu_torch.block_ids import (
    ShuffleBlockId,
    ShuffleFatIndexBlockId,
    ShuffleIndexBlockId,
)
from s3shuffle_tpu_torch.colagg import ColumnarAggregator
from s3shuffle_tpu_torch.coding.degraded import DegradedReader
from s3shuffle_tpu_torch.coding.parity import GEOMETRY_MAGIC
from s3shuffle_tpu_torch.dependency import BytesHashPartitioner, ShuffleDependency
from s3shuffle_tpu_torch.metadata.fat_index import FatIndex
from s3shuffle_tpu_torch.metadata.helper import ScanIndexMemo, ShuffleHelper
from s3shuffle_tpu_torch.metadata.map_output import STORE_LOCATION, MapStatus
from s3shuffle_tpu_torch.metrics import registry as reg
from s3shuffle_tpu_torch.read import scan_plan
from s3shuffle_tpu_torch.read.chunked_fetch import ChunkedRangeFetcher
from s3shuffle_tpu_torch.read.prefetch import BufferedPrefetchIterator
from s3shuffle_tpu_torch.serializer import ColumnarKVSerializer
from s3shuffle_tpu_torch.skew import OBJECT_GETS, SkewInfo
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
from s3shuffle_tpu_torch.storage.fault import FlakyBackend, LatencyRule
from s3shuffle_tpu_torch.storage.local import LocalBackend
from s3shuffle_tpu_torch.write.composite_commit import CompositeCommitAggregator
from s3shuffle_tpu_torch.write.map_output_writer import MapOutputWriter
from s3shuffle_tpu_torch.write.single_spill import SingleSpillMapOutputWriter
from torch_jax_native import jax_native_library  # noqa: F401  (loads the JAX oracle's native library)
from torch_port_dispatcher import port_dispatcher_reset  # noqa: F401  (resets the port's process dispatcher)

BS = 2048
BATCH = 4
CODED = dict(parity_segments=1, parity_stripe_k=1, parity_chunk_bytes=4096)


@pytest.fixture
def metrics_on():
    """Both packages' registries on, zeroed before and after."""
    for r in (reg, jax_reg):
        r.REGISTRY.reset_values()
        r.enable()
    yield reg.REGISTRY
    for r in (reg, jax_reg):
        r.disable()
        r.REGISTRY.reset_values()


@pytest.fixture(autouse=True)
def object_gets_reset():
    """No live count or peak of a test survives it, in either package."""
    yield
    for tracker in (OBJECT_GETS, jax_skew.OBJECT_GETS):
        with tracker._lock:
            tracker._inflight.clear()
        tracker.reset_peaks()


@pytest.fixture
def no_c_encoder(monkeypatch):
    """The JAX side encodes TLZ host blocks with numpy (its C encoder picks
    other valid matches than the device encoders)."""
    monkeypatch.setattr(jax_tlz, "_encode_block_native", lambda _data: None)


def _counter(registry, name, **labels):
    snap = registry.snapshot(compact=True)
    return sum(
        float(s.get("value", 0))
        for s in snap.get(name, {}).get("series", [])
        if all(s.get("labels", {}).get(k) == v for k, v in labels.items())
    )


def _objects(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            with open(os.path.join(dirpath, fn), "rb") as f:
                out[os.path.relpath(os.path.join(dirpath, fn), root)] = f.read()
    return out


def _assert_same_objects(port_root, jax_root):
    port, jax = _objects(port_root), _objects(jax_root)
    assert sorted(port) == sorted(jax) and port
    for name in port:
        assert port[name] == jax[name], name


# --- raw maps of stored bytes, written and scanned by either package ---

def _port_env(root, **knobs):
    knobs.setdefault("composite_flush_ms", 0.0)
    cfg = ShuffleConfig(root_dir=f"file://{root}", **knobs)
    d = Dispatcher(cfg)
    return cfg, d, ShuffleHelper(d)


def _jax_env(root, **knobs):
    JaxDispatcher.reset()
    knobs.setdefault("composite_flush_ms", 0.0)
    knobs.setdefault("speculative_read_quantile", 0.0)
    cfg = JaxConfig(root_dir=f"file://{root}", **knobs)
    d = JaxDispatcher(cfg)
    return cfg, d, JaxHelper(d)


def _payload(seed, m, p, n):
    return random.Random(seed * 1000 + m * 31 + p).randbytes(n)


def _write_maps(jax, d, helper, sizes, seed=0, agg=None, combined=()):
    for m, row in enumerate(sizes):
        if jax:
            w = JaxMapOutputWriter(d, helper, 0, m, len(row), aggregator=agg)
        else:
            w = MapOutputWriter(d, helper, 0, m, len(row), codec=None, device="cpu",
                                aggregator=agg)
        for p, n in enumerate(row):
            pw = w.get_partition_writer(p)
            if n:
                pw.write(_payload(seed, m, p, n))
            pw.close()
        if m in combined:
            w.note_combined()
        w.commit_all_partitions()
    return {(m, p): _payload(seed, m, p, n) for m, row in enumerate(sizes)
            for p, n in enumerate(row)}


def _blocks(sizes, cls=ShuffleBlockId):
    return [cls(0, m, p) for m in range(len(sizes)) for p in range(len(sizes[m]))]


def _port_scan(d, helper, cfg, sizes, recovery=None):
    """``{(map, partition): bytes}`` of one port scan, with its recovery."""
    recovery = recovery if recovery is not None else DegradedReader(d, device="cpu")
    it = scan_plan.build_scan_iterator(
        d, ScanIndexMemo(helper), _blocks(sizes), cfg, recovery,
        fetcher=ChunkedRangeFetcher.from_config(cfg),
    )
    got = {}
    try:
        for s in it:
            got[(s.block.map_id, s.block.reduce_id)] = s.readall()
            s.close()
    finally:
        it.close()
    return got


def _jax_scan(d, helper, cfg, sizes):
    it = jax_scan_plan.build_scan_iterator(
        d, JaxMemo(helper), _blocks(sizes, JaxBlockId), cfg,
        fetcher=JaxFetcher.from_config(cfg),
    )
    got = {}
    for s in it:
        got[(s.block.map_id, s.block.reduce_id)] = s.readall()
        s.close()
    return got


# --- wire: the skew trailer ---

@pytest.mark.parametrize("parity_on", [False, True])
def test_skew_trailer_round_trips_and_equals_jax(tmp_path, parity_on):
    over = dict(parity_segments=1, parity_stripe_k=1, parity_chunk_bytes=1024) if parity_on else {}
    sizes = [[3000, 500]]
    _cfg, d, helper = _port_env(tmp_path / "port", split_threshold_bytes=2048, **over)
    truth = _write_maps(False, d, helper, sizes, combined=(0,))
    _jcfg, jd, jhelper = _jax_env(tmp_path / "jax", split_threshold_bytes=2048, **over)
    _write_maps(True, jd, jhelper, sizes, combined=(0,))
    _assert_same_objects(tmp_path / "port", tmp_path / "jax")
    for h in (helper, jhelper):
        loc = h.resolve_map_location(0, 0)
        assert loc.combined is True and loc.split_bytes == 2048
        assert list(loc.offsets) == [0, 3000, 3500]
        assert (loc.parity is not None and loc.parity.payload_len == 3500) == parity_on
    # each package parses the other's index
    _cfg2, d2, helper2 = _port_env(tmp_path / "jax")
    loc = helper2.resolve_map_location(0, 0)
    assert (loc.combined, loc.split_bytes, list(loc.offsets)) == (True, 2048, [0, 3000, 3500])
    assert _port_scan(d2, helper2, _cfg2, sizes) == truth


def test_skew_trailer_absent_when_no_prong_engaged(tmp_path):
    _cfg, d, helper = _port_env(tmp_path)
    _write_maps(False, d, helper, [[1000, 200]], seed=1)
    blob = d.backend.read_all(d.get_path(ShuffleIndexBlockId(0, 0)))
    assert blob == np.array([0, 1000, 1200], dtype=">i8").tobytes()  # the reference wire
    loc = helper.resolve_map_location(0, 0)
    assert loc.split_bytes == 0 and loc.combined is False


def test_skew_info_and_trailer_words_equal_jax():
    for combined in (False, True):
        for split in (0, 1, 4096):
            mine = SkewInfo(combined=combined, split_bytes=split)
            theirs = jax_skew.SkewInfo(combined=combined, split_bytes=split)
            assert mine.active == theirs.active == (combined or split > 0)
            assert np.array_equal(skew.skew_trailer_words(mine),
                                  jax_skew.skew_trailer_words(theirs))
    assert (skew.SKEW_MAGIC, skew.SKEW_TRAILER_WORDS, skew.FLAG_COMBINED) == \
        (jax_skew.SKEW_MAGIC, jax_skew.SKEW_TRAILER_WORDS, jax_skew.FLAG_COMBINED)


_GEOM = [GEOMETRY_MAGIC, 2, 4, 32]
_SKEW = [skew.SKEW_MAGIC, 1, 40, 0]
TRAILER_CASES = {
    "none": [0, 10, 30],
    "skew": [0, 10, 30] + _SKEW,
    "geometry": [0, 10, 30] + _GEOM,
    "both": [0, 10, 30, 60, 100] + _SKEW + _GEOM,
    "split-only": [0, 5] + [skew.SKEW_MAGIC, 0, 4096, 0],
    "too-short": [0] + _SKEW,
}


@pytest.mark.parametrize("case", list(TRAILER_CASES))
def test_split_index_trailers_equals_jax(case):
    words = np.array(TRAILER_CASES[case], dtype=np.int64)
    off, geom, sk = skew.split_index_trailers(words)
    joff, jgeom, jsk = jax_skew.split_index_trailers(words)
    assert list(off) == list(joff)
    assert (geom is None) == (jgeom is None)
    if geom is not None:
        assert (geom.segments, geom.stripe_k, geom.chunk_bytes, geom.payload_len) == \
            (jgeom.segments, jgeom.stripe_k, jgeom.chunk_bytes, jgeom.payload_len)
    assert (sk is None) == (jsk is None)
    if sk is not None:
        assert (sk.combined, sk.split_bytes) == (jsk.combined, jsk.split_bytes)


def test_object_get_tracker_equals_jax():
    rng = random.Random(3)
    mine, theirs = skew.ObjectGetTracker(), jax_skew.ObjectGetTracker()
    live = []
    for _ in range(400):
        if live and rng.random() < 0.45:
            name = live.pop(rng.randrange(len(live)))
            mine.finish(name)
            theirs.finish(name)
        else:
            name = f"o{rng.randrange(6)}"
            live.append(name)
            mine.start(name)
            theirs.start(name)
        for n in ("o0", "o3", "o5"):
            assert mine.inflight(n) == theirs.inflight(n)
    assert mine.peaks() == theirs.peaks() and mine.peak("o1") == theirs.peak("o1")
    mine.reset_peaks()
    assert mine.peaks() == {}


def test_tracked_get_counts_only_while_the_get_runs():
    seen = []

    def get():
        seen.append(OBJECT_GETS.inflight("x.data"))
        return b"bytes"

    assert skew.tracked_get("x.data", get) == b"bytes"
    assert skew.tracked_get(None, lambda: b"n") == b"n"
    assert seen == [1] and OBJECT_GETS.inflight("x.data") == 0
    assert OBJECT_GETS.peak("x.data") == 1
    with pytest.raises(OSError):
        skew.tracked_get("y.data", lambda: (_ for _ in ()).throw(OSError("boom")))
    assert OBJECT_GETS.inflight("y.data") == 0


# --- the combine sidecar, through both packages' managers ---

OPS_CASES = [("sum",), ("min",), ("max",), ("sum", "min", "max")]


def _agg_rows(ops, n_rows=6000, hot_keys=6, parts=4, seed=7):
    """Rows with a hot partition (a few duplicate keys) and unique-key
    background: (8-byte key, len(ops) int64 values)."""
    rng = np.random.default_rng(seed)
    part_fn = JaxBytesHashPartitioner(parts)
    hot = []
    i = 100
    hot_pid = part_fn(struct.pack(">q", 77))
    while len(hot) < hot_keys:
        if part_fn(struct.pack(">q", i)) == hot_pid:
            hot.append(i)
        i += 1
    keys = np.concatenate([
        np.asarray(hot, dtype=np.int64)[np.arange(n_rows) % hot_keys],
        rng.integers(1 << 30, 1 << 40, size=n_rows // 4),
    ])
    vals = rng.integers(-1000, 1000, size=(len(keys), len(ops)))
    return [(struct.pack(">q", int(k)), np.asarray(v, dtype="<i8").tobytes())
            for k, v in zip(keys, vals)], parts


def _codec_knobs():
    return dict(checksum_algorithm="CRC32C", codec_block_size=BS, codec_batch_blocks=BATCH,
                encode_inflight_batches=1, columnar_batch_rows=512)


def _agg_run(jax, root, ops, rows, parts, n_maps=2, val_dtypes=None, aggregate=True, **knobs):
    knobs = dict(_codec_knobs(), **knobs)
    if jax:
        JaxDispatcher.reset()
        mgr = JaxManager(JaxConfig(root_dir=f"file://{root}", codec="tpu",
                                   tpu_host_fallback=False, **knobs))
        dep = JaxDependency(
            shuffle_id=0, partitioner=JaxBytesHashPartitioner(parts),
            serializer=JaxColumnarKV(),
            aggregator=JaxColumnarAggregator(ops, val_dtypes=val_dtypes) if aggregate else None)
        batch_cls = JaxRecordBatch
    else:
        mgr = ShuffleManager(ShuffleConfig(root_dir=f"file://{root}", **knobs), device="cpu")
        dep = ShuffleDependency(
            shuffle_id=0, partitioner=BytesHashPartitioner(parts),
            serializer=ColumnarKVSerializer(),
            aggregator=ColumnarAggregator(ops, val_dtypes=val_dtypes) if aggregate else None)
        batch_cls = RecordBatch
    handle = mgr.register_shuffle(0, dep)
    for m in range(n_maps):
        w = mgr.get_writer(handle, map_id=m)
        w.write(batch_cls.from_records(rows[m::n_maps]))
        assert w.stop(success=True) is not None
    out = {}
    if aggregate:
        for rid in range(parts):
            for k, v in mgr.get_reader(handle, rid, rid + 1).read():
                assert k not in out
                out[k] = bytes(v)
    return mgr, handle, out


@pytest.mark.parametrize("ops", OPS_CASES, ids="-".join)
def test_combine_sidecar_identity_and_objects_equal_jax(tmp_path, metrics_on, no_c_encoder, ops):
    rows, parts = _agg_rows(ops)
    _m, _h, base = _agg_run(False, tmp_path / "off", ops, rows, parts)
    assert _counter(metrics_on, "shuffle_map_combine_rows_total") == 0
    mgr, _h, combined = _agg_run(False, tmp_path / "port", ops, rows, parts,
                                 combine_threshold_bytes=4096)
    assert combined == base
    port_rows = _counter(metrics_on, "shuffle_map_combine_rows_total")
    assert port_rows > 0
    assert any(mgr.helper.resolve_map_location(0, m).combined for m in range(2))
    _jm, _jh, jax_out = _agg_run(True, tmp_path / "jax", ops, rows, parts,
                                 combine_threshold_bytes=4096)
    assert jax_out == combined
    assert _counter(jax_reg.REGISTRY, "shuffle_map_combine_rows_total") == port_rows
    _assert_same_objects(tmp_path / "port", tmp_path / "jax")


def test_combine_sidecar_narrow_schema_identity(tmp_path, metrics_on, no_c_encoder):
    """Narrow wire values: raw narrow rows and wide combined partials share
    one partition stream; the reduce side widens and merges them."""
    rng = np.random.default_rng(3)
    keys = [int(k) for k in rng.integers(0, 40, size=4000)]
    rows = [(struct.pack(">q", k), np.array([k % 7, k % 5], dtype="<i2").tobytes()) for k in keys]
    run = dict(ops=("sum", "max"), rows=rows, parts=3, n_maps=1, val_dtypes=("i2", "i2"),
               columnar_batch_rows=256)
    _m, _h, base = _agg_run(False, tmp_path / "off", **run)
    _m, _h, port = _agg_run(False, tmp_path / "port", combine_threshold_bytes=1024, **run)
    _m, _h, jax = _agg_run(True, tmp_path / "jax", combine_threshold_bytes=1024, **run)
    assert port == base == jax
    assert _counter(metrics_on, "shuffle_map_combine_rows_total") > 0
    _assert_same_objects(tmp_path / "port", tmp_path / "jax")


def test_combine_passes_through_without_aggregator(tmp_path, metrics_on):
    rows = [(b"k%03d" % (i % 50), b"v" * 8) for i in range(2000)]
    run = dict(ops=(), rows=rows, parts=2, n_maps=1, aggregate=False, columnar_batch_rows=256)
    mgr_off, _h, _o = _agg_run(False, tmp_path / "off", **run)
    mgr_on, _h, _o = _agg_run(False, tmp_path / "on", combine_threshold_bytes=1024, **run)
    _assert_same_objects(tmp_path / "off", tmp_path / "on")
    assert mgr_on.helper.resolve_map_location(0, 0).combined is False
    assert _counter(metrics_on, "shuffle_map_combine_rows_total") == 0


def test_reader_without_aggregator_refuses_combined_partials(tmp_path, metrics_on):
    ops = ("sum",)
    rows, parts = _agg_rows(ops, n_rows=3000)
    mgr, _h, _o = _agg_run(False, tmp_path, ops, rows, parts, combine_threshold_bytes=2048)
    assert any(mgr.helper.resolve_map_location(0, m).combined for m in range(2))
    raw = mgr.register_shuffle(0, ShuffleDependency(
        shuffle_id=0, partitioner=BytesHashPartitioner(parts), serializer=ColumnarKVSerializer()))
    with pytest.raises(ValueError, match="partial rows"):
        list(mgr.get_reader(raw, 0, parts).read())


@pytest.mark.parametrize("coded", [False, True], ids=["uncoded", "k1m1"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_combined_partials(tmp_path, metrics_on, no_c_encoder,
                                                         writer, coded):
    """Combined map outputs written by one package (coded or not), read by
    the other's manager with the tracker statuses copied over, aggregate
    to the writer's result."""
    ops = ("sum", "max")
    rows, parts = _agg_rows(ops, n_rows=3000, seed=9)
    knobs = dict(CODED) if coded else {}
    _m, _h, want = _agg_run(writer == "jax", tmp_path, ops, rows, parts,
                            combine_threshold_bytes=2048, **knobs)
    if writer == "jax":
        mgr = ShuffleManager(ShuffleConfig(root_dir=f"file://{tmp_path}", **_codec_knobs(),
                                           **knobs), device="cpu")
        dep = ShuffleDependency(shuffle_id=0, partitioner=BytesHashPartitioner(parts),
                                serializer=ColumnarKVSerializer(),
                                aggregator=ColumnarAggregator(ops))
        status = MapStatus
    else:
        from s3shuffle_tpu.metadata.map_output import MapStatus as JaxMapStatus

        JaxDispatcher.reset()
        mgr = JaxManager(JaxConfig(root_dir=f"file://{tmp_path}", codec="tpu",
                                   tpu_host_fallback=False, **_codec_knobs(), **knobs))
        dep = JaxDependency(shuffle_id=0, partitioner=JaxBytesHashPartitioner(parts),
                            serializer=JaxColumnarKV(), aggregator=JaxColumnarAggregator(ops))
        status = JaxMapStatus
    handle = mgr.register_shuffle(0, dep)
    for m in range(2):
        loc = mgr.helper.resolve_map_location(0, m)
        assert loc.combined and (loc.parity is not None) == coded
        mgr.tracker.register_map_output(0, status(map_id=m, location=STORE_LOCATION,
                                                  sizes=np.diff(loc.offsets)))
    out = {}
    for rid in range(parts):
        for k, v in mgr.get_reader(handle, rid, rid + 1).read():
            out[k] = bytes(v)
    assert out == want


def test_combine_sidecar_coded_objects_equal_jax(tmp_path, metrics_on, no_c_encoder):
    """The combine prong with parity on: data, index (skew and geometry
    trailers), checksum and parity objects byte-equal to the JAX package's."""
    ops = ("sum",)
    rows, parts = _agg_rows(ops, n_rows=4000, seed=15)
    run = dict(ops=ops, rows=rows, parts=parts, combine_threshold_bytes=2048,
               split_threshold_bytes=2048, **CODED)
    mgr, _h, port = _agg_run(False, tmp_path / "port", **run)
    _jm, _jh, jax = _agg_run(True, tmp_path / "jax", **run)
    assert port == jax
    loc = mgr.helper.resolve_map_location(0, 0)
    assert loc.combined and loc.parity is not None
    assert any(mgr.helper.resolve_map_location(0, m).split_bytes == 2048 for m in range(2))
    _assert_same_objects(tmp_path / "port", tmp_path / "jax")
    assert any(name.endswith(".parity") for name in _objects(tmp_path / "port"))


def test_reduce_chunk_is_a_stateless_one_shot_like_jax():
    recs = [(b"b", np.array([1, 5], dtype="<i8").tobytes()),
            (b"a", np.array([2, 7], dtype="<i8").tobytes()),
            (b"b", np.array([3, 2], dtype="<i8").tobytes())]
    reducer = ColumnarAggregator(("sum", "min")).new_reducer()
    out = reducer.reduce_chunk(RecordBatch.from_records(recs))
    jout = JaxColumnarAggregator(("sum", "min")).new_reducer().reduce_chunk(
        JaxRecordBatch.from_records(recs))
    assert list(out.iter_records()) == list(jout.iter_records())
    got = {k: tuple(np.frombuffer(v, dtype="<i8")) for k, v in out.iter_records()}
    assert got == {b"a": (2, 7), b"b": (4, 2)}
    assert sum(b.n for b in reducer.results()) == 0


# --- hot-partition splitting ---

def _plan(jax, d, helper, cfg, sizes):
    if jax:
        return jax_scan_plan.plan_scan(
            d, JaxMemo(helper), _blocks(sizes, JaxBlockId), gap_bytes=cfg.coalesce_gap_bytes,
            max_bytes=cfg.coalesce_max_bytes, split_budget=cfg.max_buffer_size_task)
    return scan_plan.plan_scan(
        d, ScanIndexMemo(helper), _blocks(sizes), gap_bytes=cfg.coalesce_gap_bytes,
        max_bytes=cfg.coalesce_max_bytes, split_budget=cfg.max_buffer_size_task)


def _shape(segs):
    return [(s.start, s.end, [(m.start, m.end, None if m.part is None else
                               (m.part.index, m.part.group.count)) for m in s.members])
            for s in segs]


@pytest.mark.parametrize("fat_parts", [2, 4, 8])
@pytest.mark.parametrize("gap", [0, 1 << 20])
@pytest.mark.parametrize("parity", [0, 1])
def test_split_scan_byte_identity_and_objects_equal_jax(tmp_path, metrics_on, fat_parts, gap,
                                                       parity):
    split = 8 * 1024
    sizes = [[512, split * fat_parts, 300], [256, 700, split * fat_parts]]
    over = dict(split_threshold_bytes=split, coalesce_gap_bytes=gap)
    if parity:
        over.update(CODED)
    cfg, d, helper = _port_env(tmp_path / "port", **over)
    truth = _write_maps(False, d, helper, sizes, seed=fat_parts)
    assert _counter(metrics_on, "shuffle_partition_splits_total") == 2
    jcfg, jd, jhelper = _jax_env(tmp_path / "jax", **over)
    _write_maps(True, jd, jhelper, sizes, seed=fat_parts)
    _assert_same_objects(tmp_path / "port", tmp_path / "jax")
    assert _port_scan(d, helper, cfg, sizes) == truth
    # each package reads the other's split shuffle
    assert _jax_scan(jd, JaxHelper(jd), jcfg, sizes) == truth
    cfg2, d2, helper2 = _port_env(tmp_path / "jax", **over)
    assert _port_scan(d2, helper2, cfg2, sizes) == truth
    if gap > 0:
        segs = _plan(False, d, helper, cfg, sizes)
        assert _shape(segs) == _shape(_plan(True, jd, jhelper, jcfg, sizes))
        parts = [s.members[0].part for s in segs if s.members[0].part is not None]
        assert len(parts) == 2 * fat_parts
        assert {p.group.count for p in parts} == {fat_parts}


@pytest.mark.parametrize("gap", [0, 1 << 20])
def test_split_record_read_through_the_reader_equals_jax(tmp_path, metrics_on, no_c_encoder,
                                                         monkeypatch, gap):
    """A split partition read through the manager's validating, decoding
    reader (TLZ frames, CRC32C): the same aggregate as the unsplit read
    and as the JAX package's, with byte-equal objects. The planner (gap >
    0) reassembles split parts; the per-block path (gap 0) reads unsplit,
    as the JAX one does."""
    assembled = []
    real = scan_plan.SplitBlockStream.__init__

    def counted(self, group, parts):
        assembled.append(group.count)
        real(self, group, parts)

    monkeypatch.setattr(scan_plan.SplitBlockStream, "__init__", counted)
    ops = ("sum", "max")
    rows, parts = _agg_rows(ops, n_rows=8000, seed=13)
    run = dict(ops=ops, rows=rows, parts=parts, coalesce_gap_bytes=gap)
    _m, _h, base = _agg_run(False, tmp_path / "off", **run)
    mgr, _h, split = _agg_run(False, tmp_path / "port", split_threshold_bytes=4096, **run)
    _jm, _jh, jax = _agg_run(True, tmp_path / "jax", split_threshold_bytes=4096, **run)
    assert split == base == jax
    assert _counter(metrics_on, "shuffle_partition_splits_total") > 0
    assert any(mgr.helper.resolve_map_location(0, m).split_bytes == 4096 for m in range(2))
    assert (len(assembled) > 0 and min(assembled) >= 2) if gap else not assembled
    _assert_same_objects(tmp_path / "port", tmp_path / "jax")


def test_split_fanout_capped_like_jax(tmp_path):
    cfg, d, helper = _port_env(tmp_path / "port", split_threshold_bytes=64)
    sizes = [[64 * 200]]
    truth = _write_maps(False, d, helper, sizes, seed=2)
    jcfg, jd, jhelper = _jax_env(tmp_path / "jax", split_threshold_bytes=64)
    _write_maps(True, jd, jhelper, sizes, seed=2)
    segs = _plan(False, d, helper, cfg, sizes)
    assert 2 <= len(segs) <= scan_plan.MAX_SPLIT_PARTS == jax_scan_plan.MAX_SPLIT_PARTS
    assert _shape(segs) == _shape(_plan(True, jd, jhelper, jcfg, sizes))
    assert _port_scan(d, helper, cfg, sizes) == truth


def test_split_composite_rides_fat_index_v3_like_jax(tmp_path, metrics_on):
    split = 8 * 1024
    sizes = [[400, split * 3], [split * 2, 128]]
    knobs = dict(composite_commit_maps=2, split_threshold_bytes=split)
    cfg, d, helper = _port_env(tmp_path / "port", **knobs)
    agg = CompositeCommitAggregator(d, helper, device="cpu")
    truth = _write_maps(False, d, helper, sizes, seed=5, agg=agg, combined=(1,))
    agg.flush_shuffle(0)
    jcfg, jd, jhelper = _jax_env(tmp_path / "jax", **knobs)
    jagg = JaxAggregator(jd, jhelper)
    _write_maps(True, jd, jhelper, sizes, seed=5, agg=jagg, combined=(1,))
    jagg.flush_shuffle(0)
    _assert_same_objects(tmp_path / "port", tmp_path / "jax")
    assert _counter(metrics_on, "shuffle_partition_splits_total") == 2
    fat = helper.read_fat_index(0, 0)
    assert fat.split_bytes == split and fat.member(1).combined and not fat.member(0).combined
    raw = d.backend.read_all(d.get_path(ShuffleFatIndexBlockId(0, 0)))
    assert int(np.frombuffer(raw, dtype=">i8")[1]) == 3  # v3 on the wire
    loc = helper.resolve_map_location(0, 1)
    assert loc.split_bytes == split and loc.combined
    assert _port_scan(d, helper, cfg, sizes) == truth
    assert _jax_scan(jd, JaxHelper(jd), jcfg, sizes) == truth
    # a port helper reads the JAX composite by listing
    cfg2, d2, _h = _port_env(tmp_path / "jax", **knobs)
    assert _port_scan(d2, ShuffleHelper(d2), cfg2, sizes) == truth
    assert int(np.frombuffer(FatIndex(9, 1, 2, []).to_bytes(), dtype=">i8")[1]) == 2


def test_split_block_stream_short_part_serves_the_prefix():
    class _FakePart:
        def __init__(self, part, payload):
            self.block, self._data, self._pos, self.closed = part, payload, 0, False

        def read(self, n):
            out = self._data[self._pos : self._pos + n]
            self._pos += len(out)
            return out

        def close(self):
            self.closed = True

    block = ShuffleBlockId(0, 0, 1)
    grp = scan_plan.SplitGroup(block, 0, 30, 3)
    parts = [scan_plan.SplitPart(grp, i, i * 10, (i + 1) * 10) for i in range(3)]
    assert parts[1].name == "shuffle_0_0_1[part 2/3]" and parts[1].length == 10
    fakes = [_FakePart(parts[0], b"a" * 10), _FakePart(parts[1], b"b" * 4),
             _FakePart(parts[2], b"c" * 10)]
    stream = scan_plan.SplitBlockStream(grp, fakes)
    assert stream.block is block and stream.max_bytes == 30
    assert stream.readall() == b"a" * 10 + b"b" * 4  # never part 3's bytes
    assert stream.read(5) == b""
    stream.close()
    assert all(f.closed for f in fakes)
    stream.close()  # idempotent


def test_split_group_budget_funds_the_block_once(tmp_path):
    """A split block as large as the whole budget: one claim funds it, the
    siblings piggyback, the last close releases it, and the scan ends with
    the budget whole."""
    split = 16 * 1024
    sizes = [[split * 4]]
    cfg, d, helper = _port_env(tmp_path, split_threshold_bytes=split,
                               max_buffer_size_task=split * 4)
    truth = _write_maps(False, d, helper, sizes, seed=11)
    it = scan_plan.build_scan_iterator(
        d, ScanIndexMemo(helper), _blocks(sizes), cfg, DegradedReader(d, device="cpu"),
        fetcher=ChunkedRangeFetcher.from_config(cfg))
    got = {}
    for s in it:
        assert isinstance(s, scan_plan.SplitBlockStream)
        got[(s.block.map_id, s.block.reduce_id)] = s.readall()
        assert it.budget._buffers_in_flight == split * 4  # reserved exactly once
        s.close()
    assert it.budget._buffers_in_flight == 0
    it.close()
    assert got == truth


def test_group_budget_single_claim_under_racing_parts():
    """Two sibling parts racing the group's first reservation while the
    budget is contended: one claims, the other piggybacks once the claim
    lands; never a double reservation, never a stuck waiter."""
    it = BufferedPrefetchIterator(iter([]), max_buffer_size=100)
    grp = scan_plan.SplitGroup(ShuffleBlockId(0, 0, 0), 0, 80, 2)
    assert it.try_reserve(60)  # 80 more cannot fit
    results = []

    def claimant():
        with it._lock:
            it._await_budget_locked(80, satisfied=lambda: grp.reserved)
            if not grp.reserved:
                grp.reserved = True
                grp.reserved_bytes = 80
                it._buffers_in_flight += 80
                it._lock.notify_all()
                results.append("claimed")
            else:
                results.append("piggyback")

    threads = [threading.Thread(target=claimant) for _ in range(2)]
    for t in threads:
        t.start()
    time.sleep(0.05)  # both park on the budget wait
    it.release_reserved(60)
    for t in threads:
        t.join(timeout=5.0)
    assert not any(t.is_alive() for t in threads), "a waiter never woke"
    assert sorted(results) == ["claimed", "piggyback"]
    assert it._buffers_in_flight == 80
    release = it._release_group_budget(grp)
    release(0)
    assert it._buffers_in_flight == 80  # the first of two parts closed
    release(0)
    assert it._buffers_in_flight == 0
    it.close()


def test_single_spill_commit_records_the_split_like_jax(tmp_path, metrics_on):
    split = 8 * 1024
    rng = random.Random(8)
    parts_bytes = [rng.randbytes(512), rng.randbytes(split * 3)]
    lengths = np.array([len(b) for b in parts_bytes], dtype=np.int64)
    cfg, d, helper = _port_env(tmp_path / "port", split_threshold_bytes=split)
    spill = tmp_path / "spill-port.bin"
    spill.write_bytes(b"".join(parts_bytes))
    SingleSpillMapOutputWriter(d, helper, 0, 0, device="cpu").transfer_map_spill_file(
        str(spill), lengths)
    _jcfg, jd, jhelper = _jax_env(tmp_path / "jax", split_threshold_bytes=split)
    jspill = tmp_path / "spill-jax.bin"
    jspill.write_bytes(b"".join(parts_bytes))
    JaxSingleSpill(jd, jhelper, 0, 0).transfer_map_spill_file(str(jspill), lengths)
    _assert_same_objects(tmp_path / "port", tmp_path / "jax")
    assert _counter(metrics_on, "shuffle_partition_splits_total") == 1
    loc = helper.resolve_map_location(0, 0)
    assert loc.split_bytes == split and loc.combined is False
    assert _port_scan(d, helper, cfg, [list(lengths)]) == \
        {(0, 0): parts_bytes[0], (0, 1): parts_bytes[1]}


def test_split_inert_at_zero_and_for_small_blocks(tmp_path):
    cfg, d, helper = _port_env(tmp_path)
    sizes = [[40_000, 200]]
    _write_maps(False, d, helper, sizes, seed=4)
    segs = _plan(False, d, helper, cfg, sizes)
    assert all(m.part is None and m.split == 0 for s in segs for m in s.members)
    cfg2, d2, helper2 = _port_env(tmp_path / "small", split_threshold_bytes=1 << 20)
    _write_maps(False, d2, helper2, sizes, seed=4)
    assert helper2.resolve_map_location(0, 0).split_bytes == 0  # nothing crossed
    assert all(m.part is None for s in _plan(False, d2, helper2, cfg2, sizes) for m in s.members)


# --- the coded read fan-out ---

def _hot_scan(jax, root, sizes, fanout, heat, seed):
    if jax:
        cfg, d, helper = _jax_env(root, hot_read_fanout=fanout, **CODED)
        truth = _write_maps(True, d, helper, sizes, seed=seed)
        tracker = jax_skew.OBJECT_GETS
    else:
        cfg, d, helper = _port_env(root, hot_read_fanout=fanout, **CODED)
        truth = _write_maps(False, d, helper, sizes, seed=seed)
        tracker = OBJECT_GETS
    hot = "shuffle_0_0_0.data"
    if heat:
        tracker.start(hot)  # another reader mid-GET on the object
    try:
        if jax:
            got = _jax_scan(d, helper, cfg, sizes)
            fanned = None
        else:
            recovery = DegradedReader(d, device="cpu")
            got = _port_scan(d, helper, cfg, sizes, recovery)
            fanned = recovery.reconstructions  # no loss here: each is a fan-out
    finally:
        if heat:
            tracker.finish(hot)
    assert got == truth
    return fanned


def test_hot_fanout_diverts_when_the_object_is_hot_as_jax_does(tmp_path, metrics_on):
    sizes = [[8192, 8192], [8192, 8192]]
    fanned = _hot_scan(False, tmp_path / "port", sizes, 1, True, 21)
    _hot_scan(True, tmp_path / "jax", sizes, 1, True, 21)
    assert fanned > 0
    assert _counter(metrics_on, "shuffle_hot_fanout_reads_total") == fanned
    assert _counter(jax_reg.REGISTRY, "shuffle_hot_fanout_reads_total") == fanned


@pytest.mark.parametrize("case", ["off", "cold", "sub-chunk"])
def test_hot_fanout_stays_off(tmp_path, metrics_on, case):
    sizes = [[512, 256]] if case == "sub-chunk" else [[8192, 8192]]
    fanout, heat = {"off": (0, True), "cold": (1, False), "sub-chunk": (1, True)}[case]
    assert _hot_scan(False, tmp_path / "port", sizes, fanout, heat, 22) == 0
    _hot_scan(True, tmp_path / "jax", sizes, fanout, heat, 22)
    assert _counter(metrics_on, "shuffle_hot_fanout_reads_total") == 0
    assert _counter(jax_reg.REGISTRY, "shuffle_hot_fanout_reads_total") == 0


def test_hot_fanout_under_latency_with_concurrent_readers(tmp_path, metrics_on):
    """Reader A grinds through a slow hot object; reader B arrives while
    A's GETs are in flight and serves its ranges from parity. Both read
    the same bytes."""
    sizes = [[8192, 8192, 8192]]
    cfg, d, helper = _port_env(tmp_path, hot_read_fanout=1, **CODED)
    truth = _write_maps(False, d, helper, sizes, seed=25)
    hot = "shuffle_0_0_0.data"
    flaky = FlakyBackend(d.backend)
    flaky.add_latency(LatencyRule("read", match=hot, delay_s=1.0))
    saved, d.backend = d.backend, flaky
    cold = ShuffleConfig(root_dir=cfg.root_dir, hot_read_fanout=0, **CODED)
    results = {}
    try:
        t = threading.Thread(target=lambda: results.update(a=_port_scan(d, helper, cold, sizes)))
        t.start()
        deadline = time.time() + 5.0
        while OBJECT_GETS.inflight(hot) < 1 and time.time() < deadline:
            time.sleep(0.005)
        assert OBJECT_GETS.inflight(hot) >= 1
        recovery = DegradedReader(d, device="cpu")
        results["b"] = _port_scan(d, helper, cfg, sizes, recovery)
        t.join()
    finally:
        d.backend = saved
    assert results["a"] == truth and results["b"] == truth
    assert recovery.reconstructions >= 1
    assert _counter(metrics_on, "shuffle_hot_fanout_reads_total") >= 1
    assert OBJECT_GETS.peak(hot) >= 1


# --- off switches ---

class _Recording(FlakyBackend):
    def __init__(self, inner):
        super().__init__(inner)
        self.ops = []

    def _check(self, op, path, nbytes=0):
        self.ops.append((op, path))
        super()._check(op, path, nbytes=nbytes)


def test_knobs_at_zero_keep_the_wire_and_knobs_on_add_no_store_op(tmp_path, no_c_encoder):
    ops = ("sum",)
    rows, parts = _agg_rows(ops, n_rows=3000)

    def run(tag, **knobs):
        mgr = ShuffleManager(ShuffleConfig(root_dir=f"file://{tmp_path / tag}",
                                           **_codec_knobs(), **knobs), device="cpu")
        rec = _Recording(LocalBackend())
        mgr.dispatcher.backend = rec
        handle = mgr.register_shuffle(0, ShuffleDependency(
            shuffle_id=0, partitioner=BytesHashPartitioner(parts),
            serializer=ColumnarKVSerializer(), aggregator=ColumnarAggregator(ops)))
        for m in range(2):
            w = mgr.get_writer(handle, map_id=m)
            w.write(RecordBatch.from_records(rows[m::2]))
            w.stop(success=True)
        return mgr, rec

    mgr_off, rec_off = run("off")
    _mgr_on, rec_on = run("on", combine_threshold_bytes=2048, split_threshold_bytes=4096)

    def shape(rec):
        names = [(op, p.rsplit("/", 1)[-1]) for op, p in rec.ops]
        return (sorted({n for op, n in names if op in ("create", "write")}),
                sorted((op, n) for op, n in names if op != "write"))

    assert shape(rec_on)[0] == shape(rec_off)[0]
    assert [op for op, _n in shape(rec_on)[1]] == [op for op, _n in shape(rec_off)[1]]
    loc = mgr_off.helper.resolve_map_location(0, 0)
    blob = LocalBackend().read_all(mgr_off.dispatcher.get_path(ShuffleIndexBlockId(0, 0)))
    assert blob == np.ascontiguousarray(loc.offsets, dtype=">i8").tobytes()


def test_fanout_zero_scan_ops_unchanged_under_heat(tmp_path):
    sizes = [[8192, 8192]]
    cfg, d, helper = _port_env(tmp_path, hot_read_fanout=0, **CODED)
    truth = _write_maps(False, d, helper, sizes, seed=31)

    def scan_ops(heat):
        rec = _Recording(d.backend)
        saved, d.backend = d.backend, rec
        d.clear_status_cache()
        helper.clear_caches()
        if heat:
            OBJECT_GETS.start("shuffle_0_0_0.data")
        try:
            assert _port_scan(d, helper, cfg, sizes) == truth
        finally:
            if heat:
                OBJECT_GETS.finish("shuffle_0_0_0.data")
            d.backend = saved
        return sorted((op, p.rsplit("/", 1)[-1]) for op, p in rec.ops)

    assert scan_ops(heat=False) == scan_ops(heat=True)


def test_split_write_ops_equal_jax(tmp_path):
    """Knobs on: the write side's store requests are the JAX package's, op
    for op and object for object (the trailer rides the index PUT)."""
    sizes = [[512, 20_000, 300]]
    knobs = dict(split_threshold_bytes=4096, **CODED)
    _cfg, d, helper = _port_env(tmp_path / "port", **knobs)
    rec = _Recording(d.backend)
    d.backend = rec
    _write_maps(False, d, helper, sizes, combined=(0,))
    from s3shuffle_tpu.storage.fault import FlakyBackend as JaxFlaky

    class _JaxRecording(JaxFlaky):
        def __init__(self, inner):
            super().__init__(inner)
            self.ops = []

        def _check(self, op, path, nbytes=0):
            self.ops.append((op, path))
            super()._check(op, path, nbytes=nbytes)

    _jcfg, jd, jhelper = _jax_env(tmp_path / "jax", **knobs)
    jrec = _JaxRecording(jd.backend)
    jd.backend = jrec
    _write_maps(True, jd, jhelper, sizes, combined=(0,))

    def shape(ops):
        return [(op, p.rsplit("/", 1)[-1]) for op, p in ops if op != "write"]

    assert shape(rec.ops) == shape(jrec.ops)
    _assert_same_objects(tmp_path / "port", tmp_path / "jax")
