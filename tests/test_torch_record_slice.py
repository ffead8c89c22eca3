"""The record slice on the CPU, port against the JAX package, exactly: the
JAX ``ShuffleContext`` and the port's ``ShuffleContext(device="cpu")`` get
the same seeded records with ``cleanup=False`` on two ``file://`` roots,
under CRC32C and ADLER32:

- TeraSort-shaped ``sort_by_key`` (10-byte random keys, 90-byte values from
  a small pool, ``ColumnarKVSerializer``, ``materialize="batches"``) on the
  bypass-merge handle and on the serialized handle;
- ``group_by_key``, ``fold_by_key`` (map-side combine) and
  ``combine_by_key`` on pickled records;
- the TeraSort on both handles with a ``max_buffer_size_task`` small enough
  that every map writer spills;
- a coded TeraSort (``parity_segments=2, parity_stripe_k=2,
  parity_chunk_bytes=1024``) with a data object deleted before the read;
- the serial data-object writer (``upload_queue_bytes=0``), the legacy
  frame wire (``columnar=0``) and ``force_batch_fetch``;
- one q67-shaped map task of 200 small partitions at 32 KiB blocks, whose
  held full blocks the port encodes in launches shared across partitions
  at commit (and an encode failure there, which must leave no object).

The object trees must be byte-equal and the results equal. Then each
package reads the other's objects through its own manager and reader.
``unregister_shuffle`` and ``stop`` with ``cleanup`` must leave the root
without objects. The JAX side runs its TLZ Pallas kernels in interpret mode
in the first TeraSort case (``S3SHUFFLE_TPU_CODEC_DEVICE=1``,
``S3SHUFFLE_TLZ_PALLAS=1``) and its numpy TLZ host encoder elsewhere
(its C encoder emits other valid payloads, which the port reads — checked
apart). Both packages' encode windows are pinned at one batch
(``encode_inflight_batches=1``, each writer encoding on its own thread),
and a second set of cases runs both at their defaults (encode window 2,
decode runs of 32 frames, decode window 2), where the port must encode on
its encode thread and decode on its decode pool; the async window counts
its in-flight bytes against the spill budget, so both writers spill at the
same points either way.
"""

import collections
import operator
import os
import threading

import numpy as np
import pytest

from s3shuffle_tpu.aggregator import GroupingAggregator as JaxGroupingAggregator
from s3shuffle_tpu.aggregator import fold_by_key_aggregator as jax_fold_aggregator
from s3shuffle_tpu.batch import RecordBatch as JaxRecordBatch
from s3shuffle_tpu.block_ids import ShuffleDataBlockId as JaxDataBlockId
from s3shuffle_tpu.config import ShuffleConfig as JaxConfig
from s3shuffle_tpu.dependency import HashPartitioner as JaxHashPartitioner
from s3shuffle_tpu.dependency import RangePartitioner as JaxRangePartitioner
from s3shuffle_tpu.dependency import ShuffleDependency as JaxDependency
from s3shuffle_tpu.dependency import natural_key as jax_natural_key
from s3shuffle_tpu.dependency import range_bounds as jax_range_bounds
from s3shuffle_tpu.manager import ShuffleManager as JaxManager
from s3shuffle_tpu.metadata.map_output import MapStatus as JaxMapStatus
from s3shuffle_tpu.ops import tlz as jax_tlz
from s3shuffle_tpu.serializer import ColumnarKVSerializer as JaxColumnarKV
from s3shuffle_tpu.shuffle import ShuffleContext as JaxContext
from s3shuffle_tpu.storage.dispatcher import Dispatcher as JaxDispatcher
from s3shuffle_tpu.write import serialized_writer as jax_serialized_writer
from s3shuffle_tpu.write import spill_writer as jax_spill_writer
from s3shuffle_tpu_torch import ShuffleConfig, ShuffleContext, ShuffleDataBlockId, ShuffleManager
from s3shuffle_tpu_torch.aggregator import GroupingAggregator, fold_by_key_aggregator
from s3shuffle_tpu_torch.batch import RecordBatch
from s3shuffle_tpu_torch.block_ids import ShuffleBlockBatchId
from s3shuffle_tpu_torch.dependency import (
    HashPartitioner,
    RangePartitioner,
    ShuffleDependency,
    natural_key,
    range_bounds,
)
from s3shuffle_tpu_torch.metadata.map_output import STORE_LOCATION, MapStatus
from s3shuffle_tpu_torch.serializer import ColumnarKVSerializer
from s3shuffle_tpu_torch.write import map_output_writer, serialized_writer, spill_writer
from torch_jax_native import jax_native_library  # noqa: F401  (loads the JAX oracle's native library)
from torch_port_dispatcher import port_dispatcher_reset  # noqa: F401  (resets the port's process dispatcher)

BS = 2048
BATCH = 4
MAPS = 3
PARTS = 3
ALGORITHMS = ["CRC32C", "ADLER32"]
CODED = {"parity_segments": 2, "parity_stripe_k": 2, "parity_chunk_bytes": 1024}
#: small enough that every map writer spills (several times with 500-row chunks)
SPILL = {"max_buffer_size_task": 24 * 1024, "columnar_batch_rows": 500}


def _terasort_arrays(seed: int, n: int = 1500):
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (16, 90), dtype=np.uint8)
    out = []
    for _ in range(MAPS):
        keys = rng.integers(0, 256, (n, 10), dtype=np.uint8)
        out.append((keys.reshape(-1), pool[rng.integers(0, 16, n)].reshape(-1)))
    return out


def _batches(arrays, cls):
    return [cls(np.full(len(k) // 10, 10, np.int32), np.full(len(v) // 90, 90, np.int32),
                k.copy(), v.copy()) for k, v in arrays]


def _pickled(seed: int, n: int = 2000):
    rng = np.random.default_rng(seed)
    return [
        [(int(k), bytes(v)) for k, v in zip(rng.integers(0, 300, n),
                                            rng.integers(0, 256, (n, 16), dtype=np.uint8))]
        for _ in range(MAPS)
    ]


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
DEFAULT_WINDOWS: dict = {}


def _port_manager(root, algorithm, bypass=200, window=PINNED, **extra):
    extra = {"codec_block_size": BS, "codec_batch_blocks": BATCH, **extra}
    cfg = ShuffleConfig(root_dir=f"file://{root}", checksum_algorithm=algorithm,
                        cleanup=False, **window, **extra)
    return ShuffleManager(cfg, bypass_merge_threshold=bypass, device="cpu")


def _jax_manager(root, algorithm, bypass=200, window=PINNED, **extra):
    JaxDispatcher.reset()
    extra = {"codec_block_size": BS, "codec_batch_blocks": BATCH, **extra}
    cfg = JaxConfig(root_dir=f"file://{root}", checksum_algorithm=algorithm, codec="tpu",
                    tpu_host_fallback=False, cleanup=False, **window, **extra)
    return JaxManager(cfg, bypass_merge_threshold=bypass)


# --- the operations, each through both packages' ShuffleContext ---

def _sort(ctx, parts, jax):
    cls = JaxColumnarKV if jax else ColumnarKVSerializer
    return ctx.sort_by_key(parts, PARTS, serializer=cls(), materialize="batches", cleanup=False)


def _group(ctx, parts, jax):
    return ctx.group_by_key(parts, PARTS)


def _fold(ctx, parts, jax):
    return ctx.fold_by_key([[(k, v[0]) for k, v in p] for p in parts], 0, operator.add, PARTS)


def _combine(ctx, parts, jax):
    return ctx.combine_by_key(
        parts, lambda v: len(v), lambda c, v: c + len(v), operator.add, PARTS
    )


def _rows(part_batches, cls):
    b = cls.concat(list(part_batches))
    return [k + v for k, v in b.iter_records()]


def _norm(op, out, jax):
    """Results in a package-independent form: ordered rows per partition for
    the sort (keys are distinct, so key order fixes row order), per-key
    value multisets for the group, dicts for the folds."""
    if op is _sort:
        return [_rows(p, JaxRecordBatch if jax else RecordBatch) for p in out]
    if op is _group:
        return {k: sorted(vs) for k, vs in out}
    return dict(out)


def _expected(op, parts):
    if op is _sort:
        rows = sorted(
            bytes(k[i * 10:(i + 1) * 10]) + bytes(v[i * 90:(i + 1) * 90])
            for k, v in parts for i in range(len(k) // 10)
        )
        return rows
    flat = [kv for p in parts for kv in p]
    if op is _group:
        groups = collections.defaultdict(list)
        for k, v in flat:
            groups[k].append(v)
        return {k: sorted(vs) for k, vs in groups.items()}
    acc = collections.Counter()
    for k, v in flat:
        acc[k] += v[0] if op is _fold else len(v)
    return dict(acc)


def _check_result(op, got, parts):
    want = _expected(op, parts)
    if op is _sort:
        assert [r for p in got for r in p] == want
    else:
        assert got == want


def _run_both(tmp_path, op, algorithm, bypass=200, window=PINNED, **extra):
    port_root, jax_root = tmp_path / "port", tmp_path / "jax"
    if op is _sort:
        arrays = _terasort_arrays(7)
        port_in, jax_in = _batches(arrays, RecordBatch), _batches(arrays, JaxRecordBatch)
    else:
        port_in = jax_in = _pickled(11)
    port_mgr = _port_manager(port_root, algorithm, bypass, window, **extra)
    port_out = op(ShuffleContext(manager=port_mgr, num_workers=2), port_in, False)
    jax_mgr = _jax_manager(jax_root, algorithm, bypass, window, **extra)
    jax_out = op(JaxContext(manager=jax_mgr, num_workers=2), jax_in, True)
    port_objs, jax_objs = _objects(port_root), _objects(jax_root)
    assert sorted(port_objs) == sorted(jax_objs)
    assert any(name.endswith(".data") for name in port_objs)
    for name in port_objs:
        assert port_objs[name] == jax_objs[name], name
    got = _norm(op, port_out, False)
    assert got == _norm(op, jax_out, True)
    _check_result(op, got, arrays if op is _sort else port_in)
    return port_root, jax_root, port_mgr, jax_mgr, got


# --- cross reads: each package's manager and reader over the other's objects ---

def _dep_kwargs(op, bounds_or_parts, jax):
    if op is _sort:
        part = (JaxRangePartitioner if jax else RangePartitioner)(bounds_or_parts)
        return dict(partitioner=part, serializer=(JaxColumnarKV if jax else ColumnarKVSerializer)(),
                    key_ordering=jax_natural_key if jax else natural_key)
    hp = (JaxHashPartitioner if jax else HashPartitioner)(PARTS)
    if op is _group:
        return dict(partitioner=hp, aggregator=(JaxGroupingAggregator if jax else GroupingAggregator)())
    if op is _fold:
        agg = (jax_fold_aggregator if jax else fold_by_key_aggregator)(0, operator.add)
        return dict(partitioner=hp, aggregator=agg, map_side_combine=True)
    from s3shuffle_tpu.aggregator import Aggregator as JaxAggregator

    from s3shuffle_tpu_torch.aggregator import Aggregator

    agg = (JaxAggregator if jax else Aggregator)(
        lambda v: len(v), lambda c, v: c + len(v), operator.add)
    return dict(partitioner=hp, aggregator=agg, map_side_combine=True)


def _register_from_store(mgr, dep, jax):
    """Register the shuffle and every committed map output found in the
    store (sizes from the index objects) with a fresh manager."""
    handle = mgr.register_shuffle(dep.shuffle_id, dep)
    status_cls = JaxMapStatus if jax else MapStatus
    for m in range(MAPS):
        try:
            offsets = mgr.helper.get_partition_lengths(dep.shuffle_id, m)
        except FileNotFoundError:
            continue
        mgr.tracker.register_map_output(
            dep.shuffle_id, status_cls(map_id=m, location=STORE_LOCATION,
                                       sizes=np.diff(np.asarray(offsets)))
        )
    return handle


def _read_all(mgr, handle, op, jax):
    out = []
    for p in range(PARTS):
        reader = mgr.get_reader(handle, p, p + 1)
        out.append(reader.read_result_batches() if op is _sort else list(reader.read()))
    if op is _sort:
        return _norm(op, out, jax)
    return _norm(op, [kv for part in out for kv in part], jax)


def _cross_read(op, port_root, jax_root, algorithm, want, sample, window=PINNED, **extra):
    bounds = None
    if op is _sort:
        bounds = sample
    port_on_jax = _port_manager(jax_root, algorithm, window=window, **extra)
    dep = ShuffleDependency(shuffle_id=0, **_dep_kwargs(op, bounds, False))
    got = _read_all(port_on_jax, _register_from_store(port_on_jax, dep, False), op, False)
    assert got == want
    jax_on_port = _jax_manager(port_root, algorithm, window=window, **extra)
    jdep = JaxDependency(shuffle_id=0, **_dep_kwargs(op, bounds, True))
    got = _read_all(jax_on_port, _register_from_store(jax_on_port, jdep, True), op, True)
    assert got == want


def _sort_bounds(arrays):
    """The range bounds sort_by_key samples (every len/64-th key per map)."""
    sample = []
    for k, _v in arrays:
        n = len(k) // 10
        sample.extend(bytes(k[i * 10:(i + 1) * 10]) for i in range(0, n, max(1, n // 64)))
    bounds = range_bounds(sample, PARTS)
    assert bounds == jax_range_bounds(sample, PARTS)
    return bounds


@pytest.fixture(autouse=True)
def no_c_encoder(monkeypatch):
    """The JAX package's host C TLZ encoder picks other (valid) matches than
    its numpy and device encoders on some blocks; the port's encoder is the
    device one, so the JAX side encodes host blocks with numpy here, the
    branch it takes when its native library does not load."""
    monkeypatch.setattr(jax_tlz, "_encode_block_native", lambda _data: None)


@pytest.fixture
def force_pallas(monkeypatch):
    monkeypatch.setenv("S3SHUFFLE_TPU_CODEC_DEVICE", "1")
    monkeypatch.setenv("S3SHUFFLE_TLZ_PALLAS", "1")


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_terasort_bypass_handle_pallas(force_pallas, tmp_path, algorithm):
    port_root, jax_root, port_mgr, _jax_mgr, got = _run_both(tmp_path, _sort, algorithm)
    assert port_mgr.handle(0).kind == "bypass-merge"
    counts = port_mgr.codec.frame_counts
    assert counts["written"] > 0 and counts["read"] == counts["written"]
    if algorithm == "CRC32C":
        # full TLZ frames: CRCs fused into the encode and the decode
        assert counts["written_fused"] > 0 and counts["read_fused"] > 0
    else:
        assert counts["written_fused"] == counts["read_fused"] == 0
    _cross_read(_sort, port_root, jax_root, algorithm, got, _sort_bounds(_terasort_arrays(7)))


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_terasort_serialized_handle(tmp_path, algorithm):
    port_root, jax_root, port_mgr, jax_mgr, got = _run_both(tmp_path, _sort, algorithm, bypass=0)
    assert port_mgr.handle(0).kind == "serialized"
    assert jax_mgr._registered[0].kind == "serialized"
    _cross_read(_sort, port_root, jax_root, algorithm, got, _sort_bounds(_terasort_arrays(7)))


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("op", [_group, _fold, _combine], ids=["group", "fold", "combine"])
def test_pickled_record_operations(tmp_path, op, algorithm):
    port_root, jax_root, _pm, _jm, got = _run_both(tmp_path, op, algorithm)
    _cross_read(op, port_root, jax_root, algorithm, got, None)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("bypass", [200, 0], ids=["bypass", "serialized"])
def test_terasort_with_map_side_spills(tmp_path, monkeypatch, algorithm, bypass):
    spills = collections.Counter()
    for name, module in (("port", spill_writer), ("port", serialized_writer),
                         ("jax", jax_spill_writer), ("jax", jax_serialized_writer)):
        cls = module.ShuffleMapWriter if hasattr(module, "ShuffleMapWriter") \
            else module.SerializedSortMapWriter
        original = cls._spill

        def counted(self, _orig=original, _name=name):
            spills[_name] += 1
            return _orig(self)

        monkeypatch.setattr(cls, "_spill", counted)
    port_root, jax_root, _pm, _jm, got = _run_both(tmp_path, _sort, algorithm, bypass=bypass, **SPILL)
    assert spills["port"] >= 2 * MAPS and spills["port"] == spills["jax"]
    _cross_read(_sort, port_root, jax_root, algorithm, got, _sort_bounds(_terasort_arrays(7)),
                **SPILL)


def _executor_threads(monkeypatch) -> dict:
    """The port's batch encodes and decodes, by the thread that ran them
    (the encode thread, a decode-pool thread, or another)."""
    from s3shuffle_tpu_torch.codec import framing

    seen = {"encode": 0, "decode": 0, "other": 0}

    def tally(kind):
        name = threading.current_thread().name
        seen[kind if name.startswith(f"s3shuffle-torch-{kind}") else "other"] += 1

    encode, decode = framing.CodecOutputStream._encode_batch, framing.CodecInputStream._decode_frames

    def encode_batch(self, *args):
        tally("encode")
        return encode(self, *args)

    def decode_frames(self, frames):
        tally("decode")
        return decode(self, frames)

    monkeypatch.setattr(framing.CodecOutputStream, "_encode_batch", encode_batch)
    monkeypatch.setattr(framing.CodecInputStream, "_decode_frames", decode_frames)
    return seen


#: the record operations again with both packages' codec windows at their
#: defaults: (operation, bypass-merge threshold, further knobs)
WINDOW_CASES = {
    "sort-bypass": (_sort, 200, {}),
    "sort-serialized": (_sort, 0, {}),
    "group": (_group, 200, {}),
    "sort-spilling": (_sort, 200, SPILL),
}


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_record_operations_at_the_default_codec_windows(tmp_path, monkeypatch, case, algorithm):
    assert (ShuffleConfig().encode_inflight_batches, ShuffleConfig().decode_batch_frames,
            ShuffleConfig().decode_inflight_batches) == (2, 32, 2)
    assert (JaxConfig().encode_inflight_batches, JaxConfig().decode_batch_frames,
            JaxConfig().decode_inflight_batches) == (2, 32, 2)
    threads = _executor_threads(monkeypatch)
    op, bypass, extra = WINDOW_CASES[case]
    port_root, jax_root, _pm, _jm, got = _run_both(
        tmp_path, op, algorithm, bypass=bypass, window=DEFAULT_WINDOWS, **extra)
    # every full batch encoded on the encode thread, every run decoded on
    # the decode pool (only short tails take the producer's thread)
    assert threads["encode"] > 0 and threads["decode"] > 0 and threads["other"] == 0, threads
    sample = _sort_bounds(_terasort_arrays(7)) if op is _sort else None
    _cross_read(op, port_root, jax_root, algorithm, got, sample, window=DEFAULT_WINDOWS, **extra)


#: the knobs whose non-default value picks another code path: the serial
#: data-object writer (a small buffer, so it flushes mid-object), the legacy
#: frame wire on the map side, and batch fetch of one partition and of a
#: non-relocatable serializer
KNOB_CASES = {
    "serial-upload": (_sort, {"upload_queue_bytes": 0, "buffer_size": 4096}),
    "legacy-wire": (_sort, {"columnar": 0}),
    "force-batch-fetch": (_group, {"force_batch_fetch": True}),
}


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("case", list(KNOB_CASES))
def test_record_path_under_non_default_knobs(tmp_path, monkeypatch, algorithm, case):
    op, knobs = KNOB_CASES[case]
    if case == "serial-upload":
        def no_queue(*_a, **_k):
            raise AssertionError("upload_queue_bytes=0 must not start the upload queue")

        monkeypatch.setattr(map_output_writer, "PipelinedUploadStream", no_queue)
    port_root, jax_root, _pm, _jm, got = _run_both(tmp_path, op, algorithm, **knobs)
    bounds = _sort_bounds(_terasort_arrays(7)) if op is _sort else None
    _cross_read(op, port_root, jax_root, algorithm, got, bounds, **knobs)
    if case == "force-batch-fetch":
        mgr = _port_manager(port_root, algorithm, **knobs)
        dep = ShuffleDependency(shuffle_id=0, **_dep_kwargs(op, bounds, False))
        blocks = mgr.get_reader(_register_from_store(mgr, dep, False), 0, 1).compute_shuffle_blocks()
        assert blocks and all(isinstance(b, ShuffleBlockBatchId) for b in blocks)


def _write_coded(mgr, dep, parts):
    handle = mgr.register_shuffle(0, dep)
    for m, part in enumerate(parts):
        writer = mgr.get_writer(handle, m)
        writer.write(part)
        assert writer.stop(success=True).parity_segments == CODED["parity_segments"]
    return handle


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_coded_terasort_survives_a_lost_data_object(tmp_path, algorithm):
    arrays = _terasort_arrays(5)
    bounds = _sort_bounds(arrays)
    want = _expected(_sort, arrays)
    port_root, jax_root = tmp_path / "port", tmp_path / "jax"
    port_mgr = _port_manager(port_root, algorithm, **CODED)
    port_handle = _write_coded(port_mgr, ShuffleDependency(0, **_dep_kwargs(_sort, bounds, False)),
                               _batches(arrays, RecordBatch))
    jax_mgr = _jax_manager(jax_root, algorithm, **CODED)
    jax_handle = _write_coded(jax_mgr, JaxDependency(0, **_dep_kwargs(_sort, bounds, True)),
                              _batches(arrays, JaxRecordBatch))
    port_objs, jax_objs = _objects(port_root), _objects(jax_root)
    assert sorted(port_objs) == sorted(jax_objs)
    assert sum(name.endswith(".parity") for name in port_objs) == MAPS * CODED["parity_segments"]
    for name in port_objs:
        assert port_objs[name] == jax_objs[name], name
    # lose map 1's data object in both stores
    port_mgr.dispatcher.backend.delete(port_mgr.dispatcher.get_path(ShuffleDataBlockId(0, 1)))
    jax_mgr.dispatcher.backend.delete(jax_mgr.dispatcher.get_path(JaxDataBlockId(0, 1)))
    got = _read_all(port_mgr, port_handle, _sort, False)
    assert [r for p in got for r in p] == want
    assert _read_all(jax_mgr, jax_handle, _sort, True) == got
    _cross_read(_sort, port_root, jax_root, algorithm, got, bounds, **CODED)


def test_unregister_and_stop_with_cleanup_leave_no_objects(tmp_path):
    cfg = ShuffleConfig(root_dir=f"file://{tmp_path}", checksum_algorithm="CRC32C",
                        codec_block_size=BS, codec_batch_blocks=BATCH, folder_prefixes=3)
    ctx = ShuffleContext(cfg, num_workers=2, device="cpu")
    arrays = _terasort_arrays(3, n=400)
    parts = _batches(arrays, RecordBatch)
    first = ctx.sort_by_key(parts, PARTS, serializer=ColumnarKVSerializer(),
                            materialize="batches", cleanup=False)
    assert [r for p in _norm(_sort, first, False) for r in p] == _expected(_sort, arrays)
    names = list(_objects(tmp_path))
    assert names and all("/app/0/" in "/" + n for n in names)
    ctx.manager.unregister_shuffle(0)
    assert _objects(tmp_path) == {}
    ctx.group_by_key(_pickled(4, n=300), PARTS)  # run_shuffle's own cleanup
    assert _objects(tmp_path) == {}
    ctx.sort_by_key(parts, PARTS, serializer=ColumnarKVSerializer(), cleanup=False)
    assert _objects(tmp_path)
    ctx.stop()  # unregisters shuffle 2 and removes the app root
    assert _objects(tmp_path) == {}


def test_port_reads_objects_of_the_jax_c_encoder(tmp_path, monkeypatch):
    """The JAX package's host C TLZ encoder (when its native library
    loads) emits other valid payloads than the device encoder; the port
    reads them."""
    monkeypatch.undo()
    arrays = _terasort_arrays(13)
    jax_root = tmp_path / "jax"
    jax_out = _sort(JaxContext(manager=_jax_manager(jax_root, "CRC32C"), num_workers=2),
                    _batches(arrays, JaxRecordBatch), True)
    want = _norm(_sort, jax_out, True)
    _check_result(_sort, want, arrays)
    port_on_jax = _port_manager(jax_root, "CRC32C")
    dep = ShuffleDependency(0, **_dep_kwargs(_sort, _sort_bounds(arrays), False))
    handle = _register_from_store(port_on_jax, dep, False)
    assert _read_all(port_on_jax, handle, _sort, False) == want


# --- a q67-shaped map task: 200 small partitions at 32 KiB blocks ---

Q67_BS = 32 * 1024
Q67_PARTS = 200
#: rows of each partition, cycled: empty, a short tail only, and one to
#: three full 32 KiB blocks with their tails (the rollup stage's ~100 KB
#: partition streams)
Q67_ROWS = (0, 90, 400, 700, 1000)


def _q67_batch(cls, seed: int = 29):
    """One map task's rows: 10-byte keys whose first two bytes name the
    partition, 90-byte values from a small pool (every seventh partition's
    random, so some of its blocks take the raw escape)."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (16, 90), dtype=np.uint8)
    keys, vals = [], []
    for p in range(Q67_PARTS):
        n = Q67_ROWS[p % len(Q67_ROWS)]
        head = np.frombuffer(p.to_bytes(2, "big"), np.uint8)
        keys.append(np.hstack([np.tile(head, (n, 1)),
                               rng.integers(0, 256, (n, 8), dtype=np.uint8)]))
        vals.append(rng.integers(0, 256, (n, 90), dtype=np.uint8) if p % 7 == 3
                    else pool[rng.integers(0, 16, n)])
    k, v = np.vstack(keys), np.vstack(vals)
    order = rng.permutation(len(k))
    n = len(k)
    return cls(np.full(n, 10, np.int32), np.full(n, 90, np.int32),
               k[order].reshape(-1).copy(), v[order].reshape(-1).copy())


def _q67_bounds():
    return [p.to_bytes(2, "big") + b"\xff" * 8 for p in range(Q67_PARTS - 1)]


def _q67_write(mgr, jax, batch):
    if jax:
        dep = JaxDependency(0, partitioner=JaxRangePartitioner(_q67_bounds()),
                            serializer=JaxColumnarKV(), key_ordering=jax_natural_key)
    else:
        dep = ShuffleDependency(0, partitioner=RangePartitioner(_q67_bounds()),
                                serializer=ColumnarKVSerializer(), key_ordering=natural_key)
    writer = mgr.get_writer(mgr.register_shuffle(0, dep), 0)
    writer.write(batch)
    return writer


@pytest.mark.parametrize("window", [PINNED, DEFAULT_WINDOWS], ids=["sync", "window2"])
def test_a_q67_shaped_commit_stores_the_jax_objects(tmp_path, window):
    """One map task of 200 partitions at 32 KiB blocks under CRC32C: the
    port frames the held full blocks of all its partition streams in
    shared launches at commit, the JAX package each stream's alone; the
    data object, the index and the CRC32C sidecar are byte-equal."""
    knobs = dict(codec_block_size=Q67_BS, codec_batch_blocks=64)
    port_root, jax_root = tmp_path / "port", tmp_path / "jax"
    port_mgr = _port_manager(port_root, "CRC32C", window=window, **knobs)
    port_mgr.codec.timings = timings = {}
    port = _q67_write(port_mgr, False, _q67_batch(RecordBatch))
    assert port.__class__ is spill_writer.ShuffleMapWriter
    port.stop(success=True)
    jax_mgr = _jax_manager(jax_root, "CRC32C", window=window, **knobs)
    _q67_write(jax_mgr, True, _q67_batch(JaxRecordBatch)).stop(success=True)
    port_objs, jax_objs = _objects(port_root), _objects(jax_root)
    assert sorted(port_objs) == sorted(jax_objs)
    assert {n.rsplit(".", 1)[-1] for n in port_objs} >= {"data", "index", "CRC32C"}
    for name in port_objs:
        assert port_objs[name] == jax_objs[name], name
    # every partition's full blocks held until the commit, none launched alone
    full = sum(n * 100 // Q67_BS for n in Q67_ROWS) * (Q67_PARTS // len(Q67_ROWS))
    assert timings["encode_launches"] == -(-full // 64) < Q67_PARTS
    assert timings["encode_shared_streams"] > 0
    assert port_mgr.codec.frame_counts["written_fused"] > 0


@pytest.mark.parametrize("window", [PINNED, DEFAULT_WINDOWS], ids=["sync", "window2"])
def test_an_encode_failure_in_a_shared_launch_aborts_the_task(tmp_path, monkeypatch, window):
    """The commit's second shared launch fails: the task stores no object,
    as when one partition stream's launch failed, and no partition stream
    keeps an encode window."""
    from s3shuffle_tpu_torch.codec import framing

    encode = framing.CodecOutputStream._encode_batch
    calls = []

    def failing(self, *args):
        calls.append(args[1])
        if len(calls) == 2:
            raise IOError("the second shared launch failed")
        return encode(self, *args)

    monkeypatch.setattr(framing.CodecOutputStream, "_encode_batch", failing)
    mgr = _port_manager(tmp_path / "port", "CRC32C", window=window,
                        codec_block_size=Q67_BS, codec_batch_blocks=64)
    writer = _q67_write(mgr, False, _q67_batch(RecordBatch))
    with pytest.raises(IOError, match="second shared launch"):
        writer.stop(success=True)
    assert calls[:2] == [64, 64]
    assert _objects(tmp_path / "port") == {}
    assert all(not p.codec_stream._inflight for p in writer._pipelines)
