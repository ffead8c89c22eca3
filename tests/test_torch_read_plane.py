"""The reduce-side read plane of the port against the JAX package, on the
CPU, at a few MiB: the thread-count controller, the knobs, the scan planner,
positioned block reads, chunked fetch, the prefetch budget, early exit, the
metadata caches and the store requests a record read issues.

Every oracle is deterministic: plans and controller decisions are compared
exactly; request sequences are compared at ``max_concurrency_task=1``, where
one prefetch thread issues the data GETs in block order (index GETs of the
planner's parallel bulk prefetch and checksum GETs of the consumer, whose
block order is LIFO, are compared as multisets); at four threads the
multiset of every GET is compared. No test starts more than four prefetch
threads or injects a fault into concurrent streams.

The JAX side runs ``speculative_read_quantile=0`` and the port its default
(0.99) with the metrics registry off, where neither package races a
straggler (``tests/test_torch_speculation.py`` holds the race itself
against the JAX package's, registry on). Both packages run their codec
windows at one batch (``encode_inflight_batches=1,
decode_inflight_batches=1``), so the async decode window's reservations
against the prefetch budget stay out of the request sequences.
"""

import collections
import operator
import random
import sys
import threading
import time

import numpy as np
import pytest

from s3shuffle_tpu import structured as jax_structured
from s3shuffle_tpu.batch import RecordBatch as JaxRecordBatch
from s3shuffle_tpu.block_ids import ShuffleBlockBatchId as JaxBatchId
from s3shuffle_tpu.block_ids import ShuffleBlockId as JaxBlockId
from s3shuffle_tpu.block_ids import ShuffleDataBlockId as JaxDataBlockId
from s3shuffle_tpu.coding import degraded as jax_degraded
from s3shuffle_tpu.config import ShuffleConfig as JaxConfig
from s3shuffle_tpu.dependency import HashPartitioner as JaxHashPartitioner
from s3shuffle_tpu.dependency import ShuffleDependency as JaxDependency
from s3shuffle_tpu.dependency import natural_key as jax_natural_key
from s3shuffle_tpu.manager import ShuffleManager as JaxManager
from s3shuffle_tpu.metadata.helper import ScanIndexMemo as JaxMemo
from s3shuffle_tpu.metadata.helper import ShuffleHelper as JaxHelper
from s3shuffle_tpu.metadata.map_output import MapStatus as JaxMapStatus
from s3shuffle_tpu.ops import tlz as jax_tlz
from s3shuffle_tpu.read import scan_plan as jax_scan_plan
from s3shuffle_tpu.read.block_iterator import BlockIterator as JaxBlockIterator
from s3shuffle_tpu.read.block_stream import BlockStream as JaxBlockStream
from s3shuffle_tpu.read.chunked_fetch import ChunkedRangeFetcher as JaxFetcher
from s3shuffle_tpu.read.prefetch import BufferedPrefetchIterator as JaxPrefetcher
from s3shuffle_tpu.read.prefetch import ThreadPredictor as JaxPredictor
from s3shuffle_tpu.serializer import ColumnarKVSerializer as JaxColumnarKV
from s3shuffle_tpu.shuffle import ShuffleContext as JaxContext
from s3shuffle_tpu.storage.dispatcher import Dispatcher as JaxDispatcher
from s3shuffle_tpu.tuning import controller as jax_controller
from s3shuffle_tpu.utils.growpool import GrowReapExecutor as JaxGrowReap
from s3shuffle_tpu.write.map_output_writer import MapOutputWriter as JaxMapOutputWriter
from s3shuffle_tpu_torch import ShuffleConfig, ShuffleContext, ShuffleManager, structured
from s3shuffle_tpu_torch.batch import RecordBatch
from s3shuffle_tpu_torch.block_ids import (
    ShuffleBlockBatchId,
    ShuffleBlockId,
    ShuffleDataBlockId,
)
from s3shuffle_tpu_torch.coding.degraded import DegradedReader
from s3shuffle_tpu_torch.dependency import HashPartitioner, ShuffleDependency, natural_key
from s3shuffle_tpu_torch.metadata.helper import ScanIndexMemo, ShuffleHelper
from s3shuffle_tpu_torch.metadata.map_output import STORE_LOCATION, MapStatus
from s3shuffle_tpu_torch.read import prefetch, scan_plan
from s3shuffle_tpu_torch.read.block_iterator import BlockIterator
from s3shuffle_tpu_torch.read.block_stream import BlockStream
from s3shuffle_tpu_torch.read.chunked_fetch import ChunkedRangeFetcher
from s3shuffle_tpu_torch.read.prefetch import BufferedPrefetchIterator
from s3shuffle_tpu_torch.serializer import ColumnarKVSerializer
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
from s3shuffle_tpu_torch.tuning import controller
from s3shuffle_tpu_torch.utils.growpool import GrowReapExecutor
from torch_jax_native import jax_native_library  # noqa: F401  (loads the JAX oracle's native library)
from torch_port_dispatcher import port_dispatcher_reset  # noqa: F401  (resets the port's process dispatcher)

BS = 2048
BATCH = 4
MAPS = 4
PARTS = 3
CODED = {"parity_segments": 2, "parity_stripe_k": 2, "parity_chunk_bytes": 1024}
#: the read settings the record paths run under: the per-block path, the
#: defaults (the planner), and a small budget with chunked prefills
READ_SETTINGS = {
    "gap0": {"coalesce_gap_bytes": 0},
    "defaults": {},
    "chunked-small-budget": {"max_buffer_size_task": 6000, "fetch_chunk_size": 1500,
                             "fetch_parallelism": 4, "max_concurrency_task": 4},
}
#: the JAX side's straggler race off where request sequences are compared
#: (with its registry off it would not race either)
JAX_ONLY = {"speculative_read_quantile": 0.0}
#: both packages' codec windows at one batch: every encode and decode on the
#: task's own thread
SYNC_WINDOWS = {"encode_inflight_batches": 1, "decode_inflight_batches": 1}


# --- recording backends: every positioned read as (object, offset, length) ---

class _RecordingReader:
    def __init__(self, rec, name, inner):
        self._rec, self._name, self._inner = rec, name, inner

    @property
    def size(self):
        return self._inner.size

    def read_fully(self, position, length):
        with self._rec.lock:
            self._rec.reads.append((self._name, position, length))
        return self._inner.read_fully(position, length)

    def close(self):
        self._inner.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _Recorder:
    """Wraps either package's backend; ``reads`` lists every GET."""

    def __init__(self, inner):
        self._inner = inner
        self.reads = []
        self.lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def open_ranged(self, path, *args, **kwargs):
        inner = self._inner.open_ranged(path, *args, **kwargs)
        return _RecordingReader(self, path.rsplit("/", 1)[-1], inner)

    def read_all(self, path):
        with self.open_ranged(path) as r:
            return r.read_fully(0, r.size)

    def of(self, suffix):
        return [r for r in self.reads if r[0].endswith(suffix)]


def _record(disp):
    rec = _Recorder(disp.backend)
    disp.backend = rec
    return rec


# --- environments ---

def _port_env(root, **knobs):
    cfg = ShuffleConfig(root_dir=f"file://{root}", **knobs)
    disp = Dispatcher(cfg)
    return cfg, disp, ShuffleHelper(disp)


def _jax_env(root, **knobs):
    cfg = JaxConfig(root_dir=f"file://{root}", **JAX_ONLY, **knobs)
    disp = JaxDispatcher(cfg)
    return cfg, disp, JaxHelper(disp)


def _write_matrix(root, sizes, seed=0, sid=0):
    """Raw partition bytes ``sizes[m][p]`` written by the JAX package."""
    _cfg, disp, helper = _jax_env(root)
    rng = random.Random(seed)
    truth = {}
    for m, row in enumerate(sizes):
        w = JaxMapOutputWriter(disp, helper, sid, m, len(row))
        for p, n in enumerate(row):
            data = rng.randbytes(n)
            truth[(m, p)] = data
            pw = w.get_partition_writer(p)
            if data:
                pw.write(data)
            pw.close()
        w.commit_all_partitions()
    return truth


SIZES = [[300, 0, 900, 50, 1200], [0, 0, 700, 700, 0], [5000, 10, 10, 4000, 2], [0, 0, 0, 0, 64]]


def _blocks(batch_ids, jax, sid=0):
    if batch_ids:
        cls = JaxBatchId if jax else ShuffleBlockBatchId
        return [cls(sid, m, 1, 4) for m in range(len(SIZES))]
    cls = JaxBlockId if jax else ShuffleBlockId
    return [cls(sid, m, p) for m in range(len(SIZES)) for p in range(len(SIZES[m]))]


def _segments(segs):
    return [
        (s.data_block.name, s.start, s.end, [(r.block.name, r.start, r.end) for r in s.members])
        for s in segs
    ]


def _drain(it):
    got = {}
    for s in it:
        got[s.block.name] = s.readall()
        s.close()
    return got


# --- knobs, controller, pool ---

READ_KNOBS = ("max_buffer_size_task", "max_concurrency_task", "fetch_chunk_size",
              "fetch_parallelism", "coalesce_gap_bytes", "coalesce_max_bytes",
              "cache_partition_lengths", "cache_checksums")


@pytest.mark.parametrize("bad", [None, {"fetch_chunk_size": 0}, {"fetch_parallelism": -1},
                                 {"coalesce_gap_bytes": -1}, {"coalesce_max_bytes": 0}],
                         ids=["defaults", "chunk", "parallelism", "gap", "max"])
def test_read_knobs_defaults_and_validation_match_jax(tmp_path, bad):
    if bad is None:
        port, jax = ShuffleConfig(), JaxConfig()
        assert {k: getattr(port, k) for k in READ_KNOBS} == {k: getattr(jax, k) for k in READ_KNOBS}
        return
    with pytest.raises(ValueError):
        JaxConfig(**bad)
    with pytest.raises(ValueError):
        ShuffleConfig(**bad)


@pytest.mark.parametrize("args", [(1, 64), (3, 100, 1.5), (1 << 20, 64 << 20, 4.0), (5, 5)])
def test_geometric_ladder_equals_jax(args):
    assert controller.geometric_ladder(*args) == jax_controller.geometric_ladder(*args)


def _costs(seed, n=400):
    """A fixed cost sequence with a drift halfway (a backend that slows)."""
    rng = np.random.default_rng(seed)
    base = rng.gamma(2.0, 1e6, n)
    base[n // 2:] *= np.linspace(1.0, 3.0, n - n // 2)
    return [float(c) for c in base]


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.01
        return self.t


CONTROLLERS = {
    "predictor-4": lambda mod: (mod.ThreadPredictor if mod is prefetch else JaxPredictor)(4),
    "predictor-10-from-3": lambda mod: (mod.ThreadPredictor if mod is prefetch else JaxPredictor)(10, initial=3),
    "hysteresis-cooldown": lambda mod: mod.Controller(
        mod.geometric_ladder(1, 64), initial=8, ring_size=5, hysteresis=0.05,
        cooldown_s=0.03, knob="k", time_fn=_Clock()),
    "ladder-ring-7": lambda mod: mod.Controller([1, 2, 3, 5, 8, 13], initial=6, ring_size=7),
}


@pytest.mark.parametrize("case", list(CONTROLLERS))
def test_controller_and_thread_predictor_decide_like_jax(case):
    make = CONTROLLERS[case]
    ours = make(prefetch if case.startswith("predictor") else controller)
    ref = make(None if case.startswith("predictor") else jax_controller)
    got = [ours.add_measurement_and_predict(c) for c in _costs(len(case))]
    want = [ref.add_measurement_and_predict(c) for c in _costs(len(case))]
    assert got == want
    assert (ours.decisions, ours.moves) == (ref.decisions, ref.moves)
    assert len(set(got)) > 1  # the sequence moved the knob
    assert ours._totals == ref._totals


def test_grow_reap_pool_widths_follow_jax():
    widths = [2, 4, 1, 1, 3, 6, 2]
    got, want = [], []
    for cls, out in ((GrowReapExecutor, got), (JaxGrowReap, want)):
        pool = cls("t", reap_idle_s=0.0)
        for w in widths:
            assert pool.submit(w, operator.add, w, 1).result() == w + 1
            out.append(pool.width)
        pool.pool.shutdown(wait=True)
    assert got == want == [2, 4, 1, 1, 3, 6, 2]


# --- the planner, positioned reads, chunked fetch ---

PLAN_SETTINGS = {"defaults": (1 << 20, 64 << 20), "gap100-max2000": (100, 2000),
                 "adjacent-only": (0, 1 << 20)}


@pytest.mark.parametrize("batch_ids", [False, True], ids=["blocks", "batch-ids"])
@pytest.mark.parametrize("setting", list(PLAN_SETTINGS))
def test_plan_scan_equals_jax_segment_for_segment(tmp_path, setting, batch_ids):
    _write_matrix(tmp_path, SIZES)
    gap, cap = PLAN_SETTINGS[setting]
    _c, jdisp, jhelper = _jax_env(tmp_path)
    want = jax_scan_plan.plan_scan(jdisp, JaxMemo(jhelper), _blocks(batch_ids, True),
                                   gap_bytes=gap, max_bytes=cap, prefetch_width=4)
    _c, disp, helper = _port_env(tmp_path)
    recovery = DegradedReader(disp, "cpu")
    got = scan_plan.plan_scan(disp, ScanIndexMemo(helper), _blocks(batch_ids, False),
                              gap_bytes=gap, max_bytes=cap, prefetch_width=4, recovery=recovery)
    assert _segments(got) == _segments(want)
    assert not recovery  # uncoded: the scan's DegradedReader stays inert
    if setting == "defaults" and not batch_ids:
        assert [len(s.members) for s in got] == [4, 2, 5, 1]


def test_block_iterator_resolves_like_jax(tmp_path):
    _write_matrix(tmp_path, SIZES)
    _c, jdisp, jhelper = _jax_env(tmp_path)
    _c, disp, helper = _port_env(tmp_path)
    want = []
    for b, s in JaxBlockIterator(jdisp, JaxMemo(jhelper), _blocks(False, True)):
        want.append((b.name, s.data_block.name, s.start_offset, s.end_offset, s.readall()))
        s.close()
    got = []
    for b, s in BlockIterator(disp, ScanIndexMemo(helper), _blocks(False, False)):
        got.append((b.name, s.data_block.name, s.start_offset, s.end_offset, s.readall()))
        s.close()
    assert got == want and len(got) == 12
    missing = [ShuffleBlockId(0, 9, 0)]
    with pytest.raises(FileNotFoundError, match="no index object"):
        list(BlockIterator(disp, ScanIndexMemo(helper), missing))
    with pytest.raises(FileNotFoundError):
        list(JaxBlockIterator(jdisp, JaxMemo(jhelper), [JaxBlockId(0, 9, 0)]))


def test_block_stream_positioned_reads_equal_jax(tmp_path):
    truth = _write_matrix(tmp_path, SIZES)
    _c, jdisp, _h = _jax_env(tmp_path)
    _c, disp, _h = _port_env(tmp_path)
    lo, hi = 300, 300 + 900 + 50 + 1200

    def script(stream):
        out = [stream.position, stream.available(), stream.pread(lo + 10, 40),
               stream.read(100), stream.position, stream.skip(500), stream.position,
               stream.pread(lo, 2000), stream.pread(hi - 5, 100), stream.read(),
               stream.available(), stream.skip(10), stream.read(5)]
        stream.close()
        return out

    got = script(BlockStream(disp, ShuffleBlockId(0, 0, 2), ShuffleDataBlockId(0, 0), lo, hi))
    want = script(JaxBlockStream(jdisp, JaxBlockId(0, 0, 2), JaxDataBlockId(0, 0), lo, hi))
    assert got == want
    assert got[9] == (truth[(0, 2)] + truth[(0, 3)] + truth[(0, 4)])[600:]


@pytest.mark.parametrize("chunk", [700, 1000, 4096])
def test_chunked_fetch_sub_ranges_equal_jax(tmp_path, chunk):
    truth = _write_matrix(tmp_path, [[9000, 5]])
    results = []
    for env, stream_cls, fetcher_cls, data_id in (
        (_jax_env, JaxBlockStream, JaxFetcher, JaxDataBlockId),
        (_port_env, BlockStream, ChunkedRangeFetcher, ShuffleDataBlockId),
    ):
        _c, disp, _h = env(tmp_path)
        rec = _record(disp)
        stream = stream_cls(disp, data_id(0, 0), data_id(0, 0), 0, 9000)
        stream.read(123)  # the prefill starts at a cursor inside the range
        fetcher = fetcher_cls(chunk, 4)
        buf = fetcher.prefill(stream, 8000)
        rest = stream.read()
        stream.close()
        results.append((buf, rest, sorted(rec.reads)))
    (jbuf, jrest, jreads), (buf, rest, reads) = results
    assert (buf, rest) == (jbuf, jrest)
    assert buf == truth[(0, 0)][123:8123] and rest == truth[(0, 0)][8123:]
    assert reads == jreads and len(reads) > 2


SERIAL_PREFILL = 6 << 20


@pytest.mark.parametrize("route", ["fetcher", "scan"])
def test_a_serial_prefill_over_4_mib_gets_like_jax(tmp_path, route):
    """A 6 MiB block read serially, through ``ChunkedRangeFetcher(8 MiB,
    4).prefill`` (one chunk: the serial path) and through a scan at
    ``fetch_parallelism=1`` (the prefetcher's own read): both packages
    issue one ranged GET per 4 MiB, recorded beneath the retry layer."""
    truth = _write_matrix(tmp_path, [[SERIAL_PREFILL]])
    reads = []
    for jax in (True, False):
        _c, disp, helper = (_jax_env if jax else _port_env)(tmp_path, fetch_parallelism=1)
        rec = _Recorder(disp.backend.inner)
        disp.backend.inner = rec
        if route == "fetcher":
            stream_cls, fetcher_cls, data_id = (
                (JaxBlockStream, JaxFetcher, JaxDataBlockId) if jax
                else (BlockStream, ChunkedRangeFetcher, ShuffleDataBlockId))
            stream = stream_cls(disp, data_id(0, 0), data_id(0, 0), 0, SERIAL_PREFILL)
            got = fetcher_cls(8 << 20, 4).prefill(stream, SERIAL_PREFILL)
            stream.close()
        else:
            cfg = disp.config
            blocks = [(JaxBlockId if jax else ShuffleBlockId)(0, 0, 0)]
            if jax:
                it = jax_scan_plan.build_scan_iterator(disp, JaxMemo(helper), blocks, cfg)
            else:
                it = scan_plan.build_scan_iterator(disp, ScanIndexMemo(helper), blocks, cfg,
                                                   recovery=DegradedReader(disp, "cpu"))
            got = _drain(it)[blocks[0].name]
        assert got == truth[(0, 0)]
        reads.append(rec.of(".data"))
    name = ShuffleDataBlockId(0, 0).name
    assert reads[1] == reads[0] == [(name, 0, 4 << 20), (name, 4 << 20, 2 << 20)]


# --- the budget, early exit, errors ---

def _scan(tmp_path, setting, **knobs):
    cfg, disp, helper = _port_env(tmp_path, **READ_SETTINGS[setting], **knobs)
    recovery = DegradedReader(disp, "cpu")
    return disp, scan_plan.build_scan_iterator(
        disp, ScanIndexMemo(helper), _blocks(False, False), cfg, recovery=recovery,
        fetcher=ChunkedRangeFetcher.from_config(cfg))


@pytest.mark.parametrize("setting", ["gap0", "defaults"])
def test_in_flight_bytes_never_exceed_the_budget(tmp_path, monkeypatch, setting):
    """A 5000-byte block (and 4-member segments) against a 2048-byte budget:
    blocks are clamped to the budget and finished synchronously, segments are
    planned within it, and the reserved bytes never pass it (every change of
    the counter is seen)."""
    truth = _write_matrix(tmp_path, SIZES)
    budget = 2048
    seen = []

    class Watched(BufferedPrefetchIterator):
        def __setattr__(self, name, value):
            if name == "_buffers_in_flight":
                seen.append(value)
            object.__setattr__(self, name, value)

    monkeypatch.setattr(scan_plan, "BufferedPrefetchIterator", Watched)
    disp, it = _scan(tmp_path, setting, max_buffer_size_task=budget, max_concurrency_task=4)
    got = _drain(it)
    assert got == {f"shuffle_0_{m}_{p}": v for (m, p), v in truth.items() if v}
    assert max(seen) == budget and min(seen) == 0 and seen[-1] == 0
    if setting == "defaults":
        plan = scan_plan.plan_scan(disp, ScanIndexMemo(ShuffleHelper(disp)), _blocks(False, False),
                                   gap_bytes=1 << 20, max_bytes=budget)
        merged = [s.length for s in plan if len(s.members) > 1]
        assert merged and max(merged) <= budget


def test_budget_holds_under_a_short_switch_interval(tmp_path, monkeypatch):
    """Four prefetch threads and chunked sub-reads over 120 small blocks with
    the interpreter switching threads every microsecond: every change of the
    reserved bytes stays within the budget, every block arrives once with its
    bytes, and the budget drains to zero."""
    rng = random.Random(11)
    sizes = [[rng.choice([0, 7, 300, 1900, 3000]) for _ in range(20)] for _ in range(6)]
    truth = _write_matrix(tmp_path, sizes, seed=3)
    seen = []

    class Watched(BufferedPrefetchIterator):
        def __setattr__(self, name, value):
            if name == "_buffers_in_flight":
                seen.append(value)
            object.__setattr__(self, name, value)

    monkeypatch.setattr(scan_plan, "BufferedPrefetchIterator", Watched)
    cfg, disp, helper = _port_env(tmp_path, coalesce_gap_bytes=0, max_buffer_size_task=4000,
                                  max_concurrency_task=4, fetch_chunk_size=512,
                                  fetch_parallelism=4)
    blocks = [ShuffleBlockId(0, m, p) for m in range(6) for p in range(20)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    t0 = time.monotonic()
    try:
        it = scan_plan.build_scan_iterator(disp, ScanIndexMemo(helper), blocks, cfg,
                                           recovery=DegradedReader(disp, "cpu"),
                                           fetcher=ChunkedRangeFetcher.from_config(cfg))
        got = _drain(it)
    finally:
        sys.setswitchinterval(old)
    assert time.monotonic() - t0 < 60
    assert got == {f"shuffle_0_{m}_{p}": v for (m, p), v in truth.items() if v}
    assert max(seen) <= 4000 and seen[-1] == 0


def test_try_reserve_is_non_blocking_like_jax():
    for cls in (BufferedPrefetchIterator, JaxPrefetcher):
        it = cls(iter(()), max_buffer_size=1000, max_threads=1)
        assert [it.try_reserve(600), it.try_reserve(500), it.try_reserve(400)] == [True, False, True]
        assert it.budget is it
        it.release_reserved(600)
        it.release_reserved(400)
        assert it._buffers_in_flight == 0
        with pytest.raises(StopIteration):
            next(it)  # an empty source drains: no thread is left


@pytest.mark.parametrize("setting", ["gap0", "defaults"])
def test_early_exit_joins_every_thread_and_returns_the_budget(tmp_path, setting):
    _write_matrix(tmp_path, SIZES)
    _disp, it = _scan(tmp_path, setting, max_concurrency_task=4, max_buffer_size_task=3000)
    inner = it if isinstance(it, BufferedPrefetchIterator) else it.budget
    first = next(it)
    assert first.read(10)
    first.close()
    threads = list(inner._threads)
    it.close()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert inner._buffers_in_flight == 0
    with pytest.raises(StopIteration):
        next(it)
    it.close()  # idempotent


def test_reader_that_stops_early_leaves_no_prefetch_thread(tmp_path):
    ctx = ShuffleContext(ShuffleConfig(root_dir=f"file://{tmp_path}", codec_block_size=BS,
                                       codec_batch_blocks=BATCH, max_concurrency_task=4),
                         num_workers=1, device="cpu")
    parts = _terasort(3, RecordBatch)
    ctx.sort_by_key(parts, PARTS, serializer=ColumnarKVSerializer(), cleanup=False)
    handle = ctx.manager.handle(0)
    before = {t for t in threading.enumerate() if t.name.startswith("prefetch-")}
    reader = ctx.manager.get_reader(handle, 0, PARTS)
    batches = reader.read_batches()
    assert next(batches).n > 0
    batches.close()  # the consumer stops after its first batch
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        live = {t for t in threading.enumerate() if t.name.startswith("prefetch-")} - before
        if not live:
            break
        time.sleep(0.01)
    assert not live
    ctx.stop()


def test_a_failing_source_reaches_the_consumer():
    def source():
        yield from ()
        raise OSError("index GET failed")

    it = BufferedPrefetchIterator(source(), max_buffer_size=1024, max_threads=1)
    with pytest.raises(OSError, match="index GET failed"):
        next(it)
    it.close()


# --- the metadata caches ---

def _terasort(seed, cls, n=600):
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (16, 90), dtype=np.uint8)
    out = []
    for _ in range(MAPS):
        keys = rng.integers(0, 256, (n, 10), dtype=np.uint8).reshape(-1)
        vals = pool[rng.integers(0, 16, n)].reshape(-1)
        out.append(cls(np.full(n, 10, np.int32), np.full(n, 90, np.int32), keys, vals))
    return out


def _sorted_store(root, **knobs):
    """A TeraSort shuffle 0 written by the port (objects kept)."""
    ctx = ShuffleContext(ShuffleConfig(root_dir=f"file://{root}", checksum_algorithm="CRC32C",
                                       codec_block_size=BS, codec_batch_blocks=BATCH, **knobs),
                         num_workers=2, device="cpu")
    out = ctx.sort_by_key(_terasort(5, RecordBatch), PARTS, serializer=ColumnarKVSerializer(),
                          cleanup=False)
    return ctx, out


def _sizes(root):
    _c, _d, helper = _port_env(root)
    return {m: np.diff(helper.get_partition_lengths(0, m)) for m in range(MAPS)}


def _reader_manager(root, jax, **knobs):
    """A fresh manager of either package with the store's map outputs
    registered; its caches start empty and every GET is recorded."""
    base = dict(checksum_algorithm="CRC32C", codec_block_size=BS, codec_batch_blocks=BATCH,
                cleanup=False, **SYNC_WINDOWS, **knobs)
    if jax:
        JaxDispatcher.reset()
        mgr = JaxManager(JaxConfig(root_dir=f"file://{root}", codec="tpu", tpu_host_fallback=False,
                                   **JAX_ONLY, **base))
        dep = JaxDependency(0, JaxHashPartitioner(PARTS), serializer=JaxColumnarKV(),
                            key_ordering=jax_natural_key)
        status = JaxMapStatus
    else:
        mgr = ShuffleManager(ShuffleConfig(root_dir=f"file://{root}", **base), device="cpu")
        dep = ShuffleDependency(0, HashPartitioner(PARTS), serializer=ColumnarKVSerializer(),
                                key_ordering=natural_key)
        status = MapStatus
    handle = mgr.register_shuffle(0, dep)
    for m, sizes in _sizes(root).items():
        mgr.tracker.register_map_output(0, status(map_id=m, location=STORE_LOCATION, sizes=sizes))
    return mgr, handle, _record(mgr.dispatcher)


def _read_partitions(mgr, handle, ranges):
    rows, metrics = [], []
    for lo, hi in ranges:
        reader = mgr.get_reader(handle, lo, hi)
        b = RecordBatch.concat if isinstance(mgr, ShuffleManager) else JaxRecordBatch.concat
        batch = b(list(reader.read_result_batches()))
        rows.append([k + v for k, v in batch.iter_records()])
        metrics.append(reader.metrics)
    return rows, metrics


PER_PARTITION = [(p, p + 1) for p in range(PARTS)]


@pytest.mark.parametrize("caches", [True, False], ids=["caches-on", "caches-off"])
def test_index_and_checksum_gets_per_scan(tmp_path, caches):
    """Caches on: the second scan reads no index or checksum object. Off:
    every scan reads each map's index and checksum once (never per block)."""
    _sorted_store(tmp_path)
    mgr, handle, rec = _reader_manager(tmp_path, False, cache_partition_lengths=caches,
                                       cache_checksums=caches)
    for scan in range(2):
        rec.reads.clear()
        # the whole range, then one partition: batch ids, then block ids
        _read_partitions(mgr, handle, [(0, PARTS), (1, 2)])
        for suffix in (".index", ".checksum.CRC32C"):
            names = collections.Counter(r[0] for r in rec.of(suffix))
            if caches and scan == 1:
                assert not names
            else:
                assert sorted(names.values()) == [2 - caches] * MAPS, (suffix, names)


def test_unregister_and_reinitialize_purge_the_caches(tmp_path):
    ctx, _out = _sorted_store(tmp_path)
    mgr = ctx.manager
    rec = _record(mgr.dispatcher)
    _read_partitions(mgr, mgr.handle(0), PER_PARTITION)
    assert len(mgr.helper._length_cache) == MAPS and len(mgr.helper._checksum_cache) == MAPS
    rec.reads.clear()
    _read_partitions(mgr, mgr.handle(0), PER_PARTITION)
    assert not rec.of(".index") and not rec.of(".checksum.CRC32C")
    mgr.dispatcher.reinitialize("app")
    assert len(mgr.helper._length_cache) == 0
    _read_partitions(mgr, mgr.handle(0), PER_PARTITION)
    assert len(rec.of(".index")) == MAPS
    mgr.unregister_shuffle(0)
    assert len(mgr.helper._length_cache) == 0 and len(mgr.helper._checksum_cache) == 0
    ctx.stop()


def test_a_jax_composite_commit_raises_a_clear_error(tmp_path):
    JaxDispatcher.reset()
    jax_ctx = JaxContext(manager=JaxManager(JaxConfig(
        root_dir=f"file://{tmp_path}", composite_commit_maps=MAPS, **JAX_ONLY)), num_workers=1)
    jax_ctx.sort_by_key(_terasort(2, JaxRecordBatch, n=50), PARTS,
                        serializer=JaxColumnarKV(), cleanup=False)
    _c, _d, helper = _port_env(tmp_path)
    for m in range(MAPS):
        with pytest.raises(FileNotFoundError, match="composite"):
            helper.resolve_map_location(0, m)
    mgr = ShuffleManager(ShuffleConfig(root_dir=f"file://{tmp_path}", cleanup=False), device="cpu")
    handle = mgr.register_shuffle(0, ShuffleDependency(0, HashPartitioner(PARTS),
                                                       serializer=ColumnarKVSerializer()))
    for m in range(MAPS):
        mgr.tracker.register_map_output(0, MapStatus(map_id=m, location=STORE_LOCATION,
                                                     sizes=np.ones(PARTS, np.int64)))
    with pytest.raises(FileNotFoundError, match="composite"):
        list(mgr.get_reader(handle, 0, PARTS).read_batches())


# --- record reads against the JAX package ---

@pytest.fixture(autouse=True)
def no_c_encoder(monkeypatch):
    """The JAX side's numpy TLZ host encoder (its C encoder picks other
    valid matches; tests/test_torch_record_slice.py)."""
    monkeypatch.setattr(jax_tlz, "_encode_block_native", lambda _data: None)


@pytest.mark.parametrize("setting", ["gap0", "defaults"])
def test_record_read_request_sequence_equals_jax_at_one_thread(tmp_path, setting):
    _sorted_store(tmp_path)
    knobs = dict(READ_SETTINGS[setting], max_concurrency_task=1)
    out = {}
    for jax in (False, True):
        mgr, handle, rec = _reader_manager(tmp_path, jax, **knobs)
        rows, metrics = _read_partitions(mgr, handle, PER_PARTITION + [(0, PARTS)])
        out[jax] = (rows, [(m.remote_blocks_fetched, m.remote_bytes_read, m.records_read)
                           for m in metrics], rec)
        if not jax:  # the deferred certificate still certifies through the scan
            assert mgr.codec.frame_counts["read_fused"] > 0
    (rows, counts, rec), (jrows, jcounts, jrec) = out[False], out[True]
    assert rows == jrows and counts == jcounts
    # one prefetch thread issues the data GETs in block order: op for op
    assert rec.of(".data") == jrec.of(".data") and len(rec.of(".data")) >= MAPS * PARTS
    if setting == "gap0":  # the same thread resolves the indexes, in order
        assert rec.of(".index") == jrec.of(".index")
    assert sorted(rec.of(".index")) == sorted(jrec.of(".index"))
    assert sorted(rec.of(".checksum.CRC32C")) == sorted(jrec.of(".checksum.CRC32C"))
    assert sorted(rec.reads) == sorted(jrec.reads)


@pytest.mark.parametrize("setting", ["gap0", "defaults", "chunked-small-budget"])
def test_record_read_request_multiset_equals_jax_at_four_threads(tmp_path, setting):
    _sorted_store(tmp_path)
    knobs = dict(READ_SETTINGS[setting], max_concurrency_task=4)
    out = {}
    for jax in (False, True):
        mgr, handle, rec = _reader_manager(tmp_path, jax, **knobs)
        rows, metrics = _read_partitions(mgr, handle, PER_PARTITION + [(0, PARTS)])
        out[jax] = (rows, [(m.remote_blocks_fetched, m.remote_bytes_read, m.records_read)
                           for m in metrics], sorted(rec.reads))
    assert out[False] == out[True]


def _group_parts(seed, n=800):
    rng = np.random.default_rng(seed)
    return [[(int(k), bytes(v)) for k, v in zip(rng.integers(0, 200, n),
                                                rng.integers(0, 256, (n, 12), dtype=np.uint8))]
            for _ in range(MAPS)]


def _contexts(tmp_path, **knobs):
    base = dict(checksum_algorithm="CRC32C", codec_block_size=BS, codec_batch_blocks=BATCH,
                cleanup=False, **SYNC_WINDOWS, **knobs)
    port = ShuffleContext(ShuffleConfig(root_dir=f"file://{tmp_path / 'port'}", **base),
                          num_workers=2, device="cpu")
    JaxDispatcher.reset()
    jax = JaxContext(manager=JaxManager(JaxConfig(
        root_dir=f"file://{tmp_path / 'jax'}", codec="tpu", tpu_host_fallback=False,
        **JAX_ONLY, **base)), num_workers=2)
    return port, jax


def _op_sort(ctx, jax):
    cls = JaxRecordBatch if jax else RecordBatch
    out = ctx.sort_by_key(_terasort(9, cls), PARTS,
                          serializer=(JaxColumnarKV if jax else ColumnarKVSerializer)(),
                          materialize="batches", cleanup=False)
    return [[k + v for k, v in cls.concat(list(p)).iter_records()] for p in out]


def _op_group(ctx, jax):
    return {k: sorted(vs) for k, vs in ctx.group_by_key(_group_parts(4), PARTS)}


def _op_q5_agg(ctx, jax):
    """A q5-shaped aggregation: two int keys, summed values, map-side combine."""
    mod = jax_structured if jax else structured
    rng = np.random.default_rng(6)
    n = 5000
    keys = (rng.integers(0, 300, n), rng.integers(0, 4, n))
    vals = (rng.integers(0, 100_000, n), rng.integers(-50, 50, n))
    codec = mod.KeyCodec("i32", "i32")
    parts = mod.split_batch(mod.make_batch(codec, keys, vals, ("i8", "i8")), MAPS)
    k, v = mod.agg_shuffle(ctx, codec, parts, ("sum", "sum"), PARTS, True, ("i8", "i8"))
    return [np.asarray(c).tolist() for c in k], np.asarray(v).tolist()


@pytest.mark.parametrize("setting", list(READ_SETTINGS))
@pytest.mark.parametrize("op", [_op_sort, _op_group, _op_q5_agg], ids=["sort", "group", "q5-agg"])
def test_record_operations_equal_jax_under_read_settings(tmp_path, op, setting):
    port, jax = _contexts(tmp_path, **READ_SETTINGS[setting])
    assert op(port, False) == op(jax, True)


@pytest.mark.parametrize("setting", ["gap0", "defaults", "chunked-small-budget"])
def test_coded_loss_through_the_planner_equals_jax(tmp_path, monkeypatch, setting):
    """A lost data object read through the scan (with chunked prefills, its
    positioned sub-reads): the rebuilt rows equal the JAX package's, with as
    many reconstructions."""
    counts = {"jax": 0}
    original = jax_degraded.DegradedReader.reconstruct

    def counted(self, *args, **kwargs):
        out = original(self, *args, **kwargs)
        if out is not None:
            counts["jax"] += 1
        return out

    monkeypatch.setattr(jax_degraded.DegradedReader, "reconstruct", counted)
    _sorted_store(tmp_path, **CODED)
    rows = {}
    for jax in (False, True):
        mgr, handle, _rec = _reader_manager(tmp_path, jax, **READ_SETTINGS[setting], **CODED)
        if not jax:
            path = mgr.dispatcher.get_path(ShuffleDataBlockId(0, 1))
            mgr.dispatcher.backend.delete(path)
        readers = []
        got = []
        for lo, hi in PER_PARTITION:
            reader = mgr.get_reader(handle, lo, hi)
            readers.append(reader)
            b = (JaxRecordBatch if jax else RecordBatch).concat(list(reader.read_result_batches()))
            got.append([k + v for k, v in b.iter_records()])
        rows[jax] = got
        if not jax:
            port_count = sum(r.reconstructions for r in readers)
    assert rows[False] == rows[True]
    assert port_count == counts["jax"] == PARTS


def test_read_partition_keeps_map_order_at_four_threads(tmp_path):
    truth = _write_matrix(tmp_path, SIZES)
    from s3shuffle_tpu_torch.read.reader import ShuffleReader

    _c, disp, helper = _port_env(tmp_path, max_concurrency_task=4)
    reader = ShuffleReader(disp, helper, codec=None, device="cpu")
    for p in range(5):
        for maps in (range(4), [2, 0, 1]):
            want = b"".join(truth[(m, p)] for m in maps)
            assert reader.read_partition(0, p, maps) == want
    with pytest.raises(FileNotFoundError):
        reader.read_partition(0, 0, [0, 7])
