"""The port's record layer module against module, JAX package against port,
on seeded numpy inputs, exactly: legacy and column frames byte-equal and
cross-parsed; ``split_by_partition``, ``iter_record_batches``, key sorts
and the ``BatchSorter`` (spills forced, skewed buckets) equal; every
serializer's stream bytes equal; the partition ids of all three
partitioners (``partition_batch`` included) and ``range_bounds`` equal;
``ExternalSorter``, ``Aggregator`` and ``GroupingAggregator`` equal with
spills forced; ``MapOutputTracker.get_map_sizes_by_ranges`` equal; the
manager's handle choice as the JAX manager's."""

import decimal
import io
import operator

import numpy as np
import pytest

from s3shuffle_tpu import aggregator as jax_aggregator
from s3shuffle_tpu import batch as jax_batch
from s3shuffle_tpu import colframe as jax_colframe
from s3shuffle_tpu import dependency as jax_dependency
from s3shuffle_tpu import serializer as jax_serializer
from s3shuffle_tpu import sorter as jax_sorter
from s3shuffle_tpu.metadata import map_output as jax_map_output
from s3shuffle_tpu_torch import aggregator, batch, colframe, dependency, serializer, sorter
from s3shuffle_tpu_torch.metadata import map_output

# --- seeded batches of several shapes ---

SHAPES = ["terasort", "ragged-keys", "ragged-values", "wide-keys", "short-keys",
          "dup-keys", "one-byte-bucket", "empty-values"]


def _records(shape: str, n: int = 700, seed: int = 0):
    rng = np.random.default_rng(seed)
    if shape == "terasort":
        keys = [bytes(k) for k in rng.integers(0, 256, (n, 10), dtype=np.uint8)]
        vals = [bytes(v) for v in rng.integers(0, 256, (n, 90), dtype=np.uint8)]
    elif shape == "ragged-keys":
        keys = [bytes(rng.integers(0, 4, rng.integers(0, 12), dtype=np.uint8)) for _ in range(n)]
        vals = [bytes(v) for v in rng.integers(0, 256, (n, 8), dtype=np.uint8)]
    elif shape == "ragged-values":
        keys = [bytes(k) for k in rng.integers(0, 256, (n, 4), dtype=np.uint8)]
        vals = [bytes(rng.integers(0, 256, rng.integers(0, 40), dtype=np.uint8))
                for _ in range(n)]
    elif shape == "wide-keys":  # 24-byte keys: > 16 varying columns, a shared prefix
        head = rng.integers(0, 2, (n, 4), dtype=np.uint8)
        keys = [bytes(np.concatenate([[7, 7], h, t])) for h, t in
                zip(head, rng.integers(0, 256, (n, 18), dtype=np.uint8))]
        vals = [bytes(v) for v in rng.integers(0, 256, (n, 3), dtype=np.uint8)]
    elif shape == "short-keys":  # 12-byte keys with 9..16 varying columns
        keys = [bytes(np.concatenate([[0, 0, 1], k])) for k in
                rng.integers(0, 3, (n, 9), dtype=np.uint8)]
        vals = [bytes(v) for v in rng.integers(0, 256, (n, 5), dtype=np.uint8)]
    elif shape == "dup-keys":
        keys = [bytes([int(k)]) * 3 for k in rng.integers(0, 5, n)]
        vals = [i.to_bytes(4, "little") for i in range(n)]
    elif shape == "one-byte-bucket":  # every key in one first-byte bucket
        keys = [b"\x42" + bytes(k) for k in rng.integers(0, 256, (n, 5), dtype=np.uint8)]
        vals = [i.to_bytes(4, "little") for i in range(n)]
    else:  # empty values
        keys = [bytes(k) for k in rng.integers(0, 256, (n, 6), dtype=np.uint8)]
        vals = [b""] * n
    return list(zip(keys, vals))


def _pair(records):
    return (batch.RecordBatch.from_records(records),
            jax_batch.RecordBatch.from_records(records))


def _frame_bytes(write, b) -> bytes:
    sink = io.BytesIO()
    write(sink, b)
    return sink.getvalue()


@pytest.mark.parametrize("shape", SHAPES)
def test_frames_byte_equal_and_cross_parsed(shape):
    records = _records(shape)
    port, ref = _pair(records)
    for port_write, ref_write in ((batch.write_frame, jax_batch.write_frame),
                                  (colframe.write_column_frame, jax_colframe.write_column_frame)):
        got = _frame_bytes(port_write, port)
        assert got == _frame_bytes(ref_write, ref)
        assert [b.to_records() for b in colframe.read_frames_auto(io.BytesIO(got))] == [records]
        assert [b.to_records() for b in jax_colframe.read_frames_auto(io.BytesIO(got))] == [records]


@pytest.mark.parametrize("shape", SHAPES)
def test_split_by_partition_and_key_sort_equal(shape):
    records = _records(shape, seed=1)
    port, ref = _pair(records)
    pids = np.random.default_rng(2).integers(0, 7, len(records))
    g1, b1 = batch.split_by_partition(port, pids, 7)
    g2, b2 = jax_batch.split_by_partition(ref, pids, 7)
    assert np.array_equal(b1, b2) and g1.to_records() == g2.to_records()
    assert np.array_equal(port.argsort_by_key(), ref.argsort_by_key())
    halves = [port.slice_rows(0, 300), port.slice_rows(300, port.n)]
    ref_halves = [ref.slice_rows(0, 300), ref.slice_rows(300, ref.n)]
    assert batch.sort_batches(halves).to_records() == jax_batch.sort_batches(ref_halves).to_records()


@pytest.mark.parametrize("source", ["batch", "list", "generator"])
@pytest.mark.parametrize("chunk_records,chunk_bytes", [(64, 1 << 20), (1000, 3000)])
def test_iter_record_batches_equal(source, chunk_records, chunk_bytes):
    records = _records("ragged-values", seed=3)

    def make(mod):
        if source == "batch":
            return mod.RecordBatch.from_records(records)
        return list(records) if source == "list" else iter(records)

    got = [b.to_records() for b in batch.iter_record_batches(make(batch), chunk_records, chunk_bytes)]
    want = [b.to_records() for b in jax_batch.iter_record_batches(make(jax_batch),
                                                                  chunk_records, chunk_bytes)]
    assert got == want and len(got) > 1


@pytest.mark.parametrize("shape", ["terasort", "ragged-keys", "dup-keys", "one-byte-bucket"])
def test_batch_sorter_equal_with_spills(shape):
    records = _records(shape, n=3000, seed=4)
    port_sorter = batch.BatchSorter(spill_bytes=6000)
    ref_sorter = jax_batch.BatchSorter(spill_bytes=6000)
    for lo in range(0, len(records), 250):
        p, r = _pair(records[lo:lo + 250])
        port_sorter.add(p)
        ref_sorter.add(r)
    assert port_sorter.spill_count == ref_sorter.spill_count > 0
    got = [b.to_records() for b in port_sorter.sorted_batches(chunk_records=500)]
    want = [b.to_records() for b in ref_sorter.sorted_batches(chunk_records=500)]
    assert got == want
    flat = [kv for b in got for kv in b]
    # equal keys keep insertion order
    assert flat == sorted(records, key=lambda kv: kv[0])


SERIALIZERS = [
    ("pickle", lambda m: m.PickleBatchSerializer(batch_size=64)),
    ("bytes-kv", lambda m: m.BytesKVSerializer()),
    ("columnar-legacy", lambda m: m.ColumnarKVSerializer(batch_records=100, column_frames=False)),
    ("columnar-frames", lambda m: m.ColumnarKVSerializer(batch_records=100, column_frames=True)),
]


@pytest.mark.parametrize("name,make", SERIALIZERS, ids=[s[0] for s in SERIALIZERS])
def test_serializer_streams_byte_equal(name, make):
    records = _records("ragged-values", n=450, seed=5)
    port, ref = make(serializer), make(jax_serializer)
    got = port.dumps(records)
    assert got == ref.dumps(records)
    assert list(port.loads(got)) == records == list(ref.loads(got))
    if port.supports_batches:
        sink = io.BytesIO()
        w = port.new_write_stream(sink)
        w.write_batch(batch.RecordBatch.from_records(records))
        w.close()
        ref_sink = io.BytesIO()
        w = ref.new_write_stream(ref_sink)
        w.write_batch(jax_batch.RecordBatch.from_records(records))
        w.close()
        assert sink.getvalue() == ref_sink.getvalue()


@pytest.mark.parametrize("columnar", [0, 1])
def test_serializer_resolves_its_frames_from_the_config(columnar):
    class Cfg:
        pass

    cfg = Cfg()
    cfg.columnar = columnar
    port = serializer.ColumnarKVSerializer().resolve_for_write(cfg)
    ref = jax_serializer.ColumnarKVSerializer().resolve_for_write(cfg)
    assert port.column_frames == ref.column_frames == bool(columnar)
    assert serializer.get_serializer("columnar").name == jax_serializer.get_serializer("columnar").name


SCALAR_KEYS = [0, 1, -5, 2**40, 3.5, float("nan"), True, b"", b"abc", "héllo", (1, "a", b"z"),
               (2, (3, 4)), None, decimal.Decimal("7"), frozenset({1})]


@pytest.mark.parametrize("n", [1, 7, 64])
def test_hash_partitioner_equal(n):
    port, ref = dependency.HashPartitioner(n), jax_dependency.HashPartitioner(n)
    assert [port(k) for k in SCALAR_KEYS] == [ref(k) for k in SCALAR_KEYS]
    ints = np.random.default_rng(n).integers(-2**31, 2**31, 500).tolist()
    assert [port(k) for k in ints] == [ref(k) for k in ints]


@pytest.mark.parametrize("shape", ["terasort", "ragged-keys", "wide-keys", "long-keys"])
def test_bytes_hash_partitioner_equal(shape):
    if shape == "long-keys":  # ragged keys beyond the 64-byte vectorized width
        rng = np.random.default_rng(6)
        records = [(bytes(rng.integers(0, 256, rng.integers(0, 90), dtype=np.uint8)), b"v")
                   for _ in range(300)]
    else:
        records = _records(shape, seed=6)
    port_b, ref_b = _pair(records)
    port, ref = dependency.BytesHashPartitioner(13), jax_dependency.BytesHashPartitioner(13)
    got = port.partition_batch(port_b)
    assert np.array_equal(got, ref.partition_batch(ref_b))
    assert got.tolist() == [ref(k) for k, _v in records]


@pytest.mark.parametrize("shape", ["terasort", "ragged-keys", "wide-keys", "dup-keys"])
def test_range_partitioner_and_bounds_equal(shape):
    records = _records(shape, n=900, seed=7)
    sample = [k for k, _v in records[::7]]
    bounds = dependency.range_bounds(sample, 6)
    assert bounds == jax_dependency.range_bounds(sample, 6)
    port_b, ref_b = _pair(records)
    port = dependency.RangePartitioner(bounds)
    ref = jax_dependency.RangePartitioner(bounds)
    got = port.partition_batch(port_b)
    assert np.array_equal(got, ref.partition_batch(ref_b))
    assert got.tolist() == [ref(k) for k, _v in records]
    # a key function takes the scalar route
    ints = list(range(-50, 50, 3))
    port = dependency.RangePartitioner(dependency.range_bounds(ints, 4), key_func=abs)
    ref = jax_dependency.RangePartitioner(jax_dependency.range_bounds(ints, 4), key_func=abs)
    assert [port(k) for k in ints] == [ref(k) for k in ints]


def test_range_partitioner_resolves_prefix_ties_equal():
    # > 64 keys sharing their 8-byte prefix with a bound: the tie pass
    rng = np.random.default_rng(8)
    prefix = b"\x10" * 8
    records = [(prefix + bytes(rng.integers(0, 3, rng.integers(0, 4), dtype=np.uint8)), b"")
               for _ in range(400)]
    bounds = sorted({prefix, prefix + b"\x01", prefix + b"\x02\x00"})
    port_b, ref_b = _pair(records)
    got = dependency.RangePartitioner(bounds).partition_batch(port_b)
    assert np.array_equal(got, jax_dependency.RangePartitioner(bounds).partition_batch(ref_b))


@pytest.mark.parametrize("key_func", [None, lambda k: -k], ids=["natural", "negated"])
def test_external_sorter_equal_with_spills(key_func):
    rng = np.random.default_rng(9)
    records = [(int(k), bytes(v)) for k, v in zip(rng.integers(0, 400, 3000),
                                                  rng.integers(0, 256, (3000, 6), dtype=np.uint8))]
    port = sorter.ExternalSorter(key_func=key_func, spill_bytes=20_000)
    ref = jax_sorter.ExternalSorter(key_func=key_func, spill_bytes=20_000)
    port.insert_all(records[:1500])
    ref.insert_all(records[:1500])
    port.insert_all(iter(records[1500:]))
    ref.insert_all(iter(records[1500:]))
    assert port.spill_count == ref.spill_count > 1
    assert list(port.sorted_iterator()) == list(ref.sorted_iterator())
    assert sorter.estimate_record_bytes(records[0]) == jax_sorter.estimate_record_bytes(records[0])


def test_external_sorter_insert_batch_equal():
    records = _records("ragged-keys", n=2000, seed=10)
    port = sorter.ExternalSorter(spill_bytes=30_000)
    ref = jax_sorter.ExternalSorter(spill_bytes=30_000)
    for lo in range(0, 2000, 400):
        p, r = _pair(records[lo:lo + 400])
        port.insert_batch(p)
        ref.insert_batch(r)
    assert port.spill_count == ref.spill_count > 0
    assert list(port.sorted_iterator()) == list(ref.sorted_iterator())


AGGREGATORS = [
    ("sum", lambda m: m.Aggregator(lambda v: v, operator.add, operator.add, spill_bytes=4000)),
    ("fold", lambda m: m.fold_by_key_aggregator(10, operator.add)),
    ("group", lambda m: m.GroupingAggregator(spill_bytes=4000)),
    ("list", lambda m: m.Aggregator(lambda v: [v], lambda c, v: c + [v], operator.add,
                                    spill_bytes=4000)),
]


@pytest.mark.parametrize("name,make", AGGREGATORS, ids=[a[0] for a in AGGREGATORS])
@pytest.mark.parametrize("combiners", [False, True], ids=["values", "combiners"])
def test_aggregators_equal_with_spills(name, make, combiners):
    def records():  # fresh lists each time: list combiners merge in place
        rng = np.random.default_rng(11)
        keys = rng.integers(0, 1500, 6000).tolist()
        vals = rng.integers(0, 100, 6000).tolist()
        if name in ("group", "list") and combiners:
            vals = [[v] for v in vals]
        return list(zip(keys, vals))

    port, ref = make(aggregator), make(jax_aggregator)
    spill = None if name != "fold" else 4000
    method = "combine_combiners_by_key" if combiners else "combine_values_by_key"
    got = list(getattr(port, method)(records(), spill_bytes=spill))
    want = list(getattr(ref, method)(records(), spill_bytes=spill))
    assert port.spill_count == ref.spill_count > 0
    assert got == want


def test_map_output_tracker_sizes_by_ranges_equal():
    rng = np.random.default_rng(12)
    trackers = (map_output.MapOutputTracker(), jax_map_output.MapOutputTracker())
    statuses = (map_output.MapStatus, jax_map_output.MapStatus)
    for tracker in trackers:
        tracker.register_shuffle(4, 6)
    # attempt-unique map ids: maps 2 and 5 have two committed attempts
    attempts = [(0, 0), (1, 1), (2, 2), (102, 2), (3, 3), (4, 4), (5, 5), (205, 5)]
    for map_id, index in attempts:
        sizes = rng.integers(0, 1000, 6)
        for tracker, cls in zip(trackers, statuses):
            tracker.register_map_output(
                4, cls(map_id=map_id, location="object-store", sizes=sizes, map_index=index))
    for start, end, ranges in [(0, None, [(0, 6)]), (1, 5, [(0, 1), (2, 4), (5, 6)]),
                               (3, 3, [(0, 6)]), (0, None, [])]:
        assert (trackers[0].get_map_sizes_by_ranges(4, start, end, ranges)
                == trackers[1].get_map_sizes_by_ranges(4, start, end, ranges))
    assert (trackers[0].get_map_sizes_by_range(4, 2, None, 1, 3)
            == trackers[1].get_map_sizes_by_range(4, 2, None, 1, 3))
    trackers[0].unregister_shuffle(4)
    assert not trackers[0].contains(4) and trackers[0].shuffle_ids() == []


@pytest.mark.parametrize("parts,combine,agg,ser", [
    (3, False, False, "columnar"), (300, False, False, "columnar"),
    (300, False, True, "pickle"), (300, False, False, "bytes-kv"), (3, True, True, "pickle"),
])
def test_handle_choice_equal(tmp_path, parts, combine, agg, ser):
    from s3shuffle_tpu.manager import ShuffleManager as JaxManager
    from s3shuffle_tpu.config import ShuffleConfig as JaxConfig
    from s3shuffle_tpu.storage.dispatcher import Dispatcher as JaxDispatcher
    from s3shuffle_tpu_torch import ShuffleConfig, ShuffleManager

    kinds = []
    for mods, mgr in (
        ((dependency, aggregator, serializer),
         ShuffleManager(ShuffleConfig(root_dir=f"file://{tmp_path}"), device="cpu")),
        ((jax_dependency, jax_aggregator, jax_serializer),
         JaxManager(JaxConfig(root_dir=f"file://{tmp_path}/j", codec="none"))),
    ):
        dep_mod, agg_mod, ser_mod = mods
        dep = dep_mod.ShuffleDependency(
            shuffle_id=1, partitioner=dep_mod.HashPartitioner(parts),
            serializer=ser_mod.get_serializer(ser),
            aggregator=agg_mod.GroupingAggregator() if agg else None,
            map_side_combine=combine,
        )
        kinds.append(mgr.register_shuffle(1, dep).kind)
    JaxDispatcher.reset()
    assert kinds[0] == kinds[1]
