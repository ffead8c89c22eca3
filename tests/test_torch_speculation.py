"""Straggler speculation of the port against the JAX package, on the CPU, at
a few KiB (the speculation cases of ``tests/test_coding_plane.py``, each
held against the JAX package):

- the viability gate decides as the JAX one on every geometry (m < k over
  full groups never races; mirrored, m >= k and tail-only objects do);
- the size classes, the per-MiB normalisation and ``threshold_s`` from the
  same seeded histogram equal the JAX package's, and there is no threshold
  below ``MIN_FILL_SAMPLES`` samples, at quantile 0, or with the registry
  off;
- a straggling data GET is raced and won by a parity reconstruction in
  both packages alike, the raced read returns the unraced bytes, and the
  abandoned primary's reader closes when its GET ends;
- without samples, without a quantile or with the registry off nothing
  races: no parity GET, no reconstruction;
- at the defaults (``speculative_read_quantile = 0.99``, the registry off,
  the skew knobs at 0) a record read and a coded read issue the JAX
  package's store requests, in order at one prefetch thread, with no
  speculative or fan-out read.

Thresholds come from histograms fed here with chosen values, not from
timing, and no test asserts a wall-clock budget: a straggler is delayed
seconds past a threshold of a fraction of a second. Every test that turns a
registry on resets it in a fixture's teardown.
"""

import random
import threading
import time

import numpy as np
import pytest

from s3shuffle_tpu.batch import RecordBatch as JaxRecordBatch
from s3shuffle_tpu.block_ids import ShuffleBlockId as JaxBlockId
from s3shuffle_tpu.block_ids import ShuffleCompositeDataBlockId as JaxCompositeDataBlockId
from s3shuffle_tpu.block_ids import ShuffleDataBlockId as JaxDataBlockId
from s3shuffle_tpu.coding import degraded as jax_degraded
from s3shuffle_tpu.coding.parity import ParityGeometry as JaxParityGeometry
from s3shuffle_tpu.config import ShuffleConfig as JaxConfig
from s3shuffle_tpu.dependency import HashPartitioner as JaxHashPartitioner
from s3shuffle_tpu.dependency import ShuffleDependency as JaxDependency
from s3shuffle_tpu.dependency import natural_key as jax_natural_key
from s3shuffle_tpu.manager import ShuffleManager as JaxManager
from s3shuffle_tpu.metadata.helper import ScanIndexMemo as JaxMemo
from s3shuffle_tpu.metadata.helper import ShuffleHelper as JaxHelper
from s3shuffle_tpu.metadata.map_output import MapStatus as JaxMapStatus
from s3shuffle_tpu.metrics import registry as jax_reg
from s3shuffle_tpu.ops import tlz as jax_tlz
from s3shuffle_tpu.read import prefetch as jax_prefetch
from s3shuffle_tpu.read import scan_plan as jax_scan_plan
from s3shuffle_tpu.read.chunked_fetch import ChunkedRangeFetcher as JaxFetcher
from s3shuffle_tpu.serializer import ColumnarKVSerializer as JaxColumnarKV
from s3shuffle_tpu import skew as jax_skew
from s3shuffle_tpu.storage.dispatcher import Dispatcher as JaxDispatcher
from s3shuffle_tpu.storage.fault import FlakyBackend as JaxFlaky
from s3shuffle_tpu.storage.fault import LatencyRule as JaxLatencyRule
from s3shuffle_tpu.write.map_output_writer import MapOutputWriter as JaxMapOutputWriter
from s3shuffle_tpu_torch import ShuffleConfig, ShuffleContext, ShuffleManager
from s3shuffle_tpu_torch.batch import RecordBatch
from s3shuffle_tpu_torch.block_ids import (
    ShuffleBlockId,
    ShuffleCompositeDataBlockId,
    ShuffleDataBlockId,
)
from s3shuffle_tpu_torch.coding import degraded
from s3shuffle_tpu_torch.coding.degraded import DegradedReader, SpeculativeFetcher
from s3shuffle_tpu_torch.coding.parity import ParityGeometry
from s3shuffle_tpu_torch.dependency import HashPartitioner, ShuffleDependency, natural_key
from s3shuffle_tpu_torch.metadata.helper import ScanIndexMemo, ShuffleHelper
from s3shuffle_tpu_torch.metadata.map_output import STORE_LOCATION, MapStatus
from s3shuffle_tpu_torch.metrics import registry as reg
from s3shuffle_tpu_torch.read import prefetch, scan_plan
from s3shuffle_tpu_torch.read.chunked_fetch import ChunkedRangeFetcher
from s3shuffle_tpu_torch.serializer import ColumnarKVSerializer
from s3shuffle_tpu_torch.skew import OBJECT_GETS
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
from s3shuffle_tpu_torch.storage.fault import FlakyBackend, LatencyRule
from torch_jax_native import jax_native_library  # noqa: F401  (loads the JAX oracle's native library)
from torch_port_dispatcher import port_dispatcher_reset  # noqa: F401  (resets the port's process dispatcher)

K1M1 = dict(parity_segments=1, parity_stripe_k=1, parity_chunk_bytes=4096)
K2M2 = dict(parity_segments=2, parity_stripe_k=2, parity_chunk_bytes=1024)
SIZES = [[6000, 6000]] * 3
STRAGGLER = "shuffle_0_1_0.data"
#: the fill every seeded sample says a healthy prefill takes (per MiB)
HEALTHY_S = 0.5
#: the straggler's delay, far past any threshold the samples give
DELAY_S = 2.5


@pytest.fixture
def metrics_on():
    for r in (reg, jax_reg):
        r.REGISTRY.reset_values()
        r.enable()
    yield
    for r in (reg, jax_reg):
        r.disable()
        r.REGISTRY.reset_values()


@pytest.fixture(autouse=True)
def object_gets_reset():
    yield
    for tracker in (OBJECT_GETS, jax_skew.OBJECT_GETS):
        with tracker._lock:
            tracker._inflight.clear()
        tracker.reset_peaks()


def _counter(registry, name):
    snap = registry.snapshot(compact=True)
    return sum(float(s.get("value", 0)) for s in snap.get(name, {}).get("series", []))


def _seed_fills(mod, values, size_class="le1m"):
    """Observe ``values`` into one package's per-MiB fill histogram."""
    hist = mod.REGISTRY.histogram("read_prefetch_fill_per_mib_seconds",
                                  labelnames=("size_class",))
    for v in values:
        hist.labels(size_class=size_class).observe(float(v))


# --- the gate and the threshold ---

GEOMETRIES = {
    "m<k-full-groups": (1, 4, 1024, 64 * 1024),
    "mirrored": (1, 1, 1024, 64 * 1024),
    "tail-only": (1, 4, 1024, 700),
    "k2m2": (2, 2, 1024, 10_000),
    "k4m2": (2, 4, 1024, 10_000),
    "k4m2-short": (2, 4, 1024, 1500),
    "k3m1-two-chunks": (1, 3, 512, 1000),
}


@pytest.mark.parametrize("kind", ["singleton", "composite"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_speculation_viability_gate_equals_jax(geometry, kind):
    """Singleton and composite data objects alike (a composite group's
    parity covers the whole composite object)."""
    args = GEOMETRIES[geometry]
    if kind == "singleton":
        block, jblock = ShuffleDataBlockId(0, 0), JaxDataBlockId(0, 0)
    else:
        block, jblock = ShuffleCompositeDataBlockId(0, 4), JaxCompositeDataBlockId(0, 4)
    port = DegradedReader(dispatcher=None, device="cpu")
    jax = jax_degraded.DegradedReader(dispatcher=None)
    port.register(block, ParityGeometry(*args))
    jax.register(jblock, JaxParityGeometry(*args))
    got = port.speculation_viable(block)
    assert got == jax.speculation_viable(jblock)
    assert got == (geometry not in ("m<k-full-groups", "k4m2", "k3m1-two-chunks"))
    assert not port.speculation_viable(ShuffleDataBlockId(0, 1))  # unregistered
    assert port.geometry_of(block) == ParityGeometry(*args)


@pytest.mark.parametrize("nbytes", [0, 1, 1 << 20, (1 << 20) + 1, 3 << 20, 8 << 20,
                                    (8 << 20) + 1, 64 << 20, 65 << 20, 1 << 30])
def test_size_classes_equal_jax(nbytes):
    assert prefetch.fill_size_class(nbytes) == jax_prefetch.fill_size_class(nbytes)
    assert prefetch.fill_norm_mib(nbytes) == jax_prefetch.fill_norm_mib(nbytes)


@pytest.mark.parametrize("seed", range(4))
def test_threshold_equals_jax_on_a_seeded_histogram(metrics_on, seed):
    rng = np.random.default_rng(seed)
    for cls, n in (("le1m", 40), ("le8m", 12), ("le64m", degraded.MIN_FILL_SAMPLES - 1)):
        values = rng.exponential(0.02, n)
        _seed_fills(reg, values, cls)
        _seed_fills(jax_reg, values, cls)
    assert degraded.MIN_FILL_SAMPLES == jax_degraded.MIN_FILL_SAMPLES
    for q in (0.0, 0.5, 0.9, 0.99):
        mine = SpeculativeFetcher(DegradedReader(None, device="cpu"), q)
        theirs = jax_degraded.SpeculativeFetcher(jax_degraded.DegradedReader(None), q)
        for nbytes in (100, 1 << 20, 3 << 20, 8 << 20, 20 << 20, 100 << 20):
            got = mine.threshold_s(nbytes)
            assert got == theirs.threshold_s(nbytes), (q, nbytes)
            # no threshold at quantile 0, for the short class, for an unseen one
            assert (got is None) == (q == 0.0 or nbytes > 8 << 20)


def test_no_threshold_with_the_registry_off():
    _seed_fills(reg, [0.1] * 20)  # the registry is off: nothing records
    assert not reg.enabled()
    assert SpeculativeFetcher(DegradedReader(None, device="cpu"), 0.9).threshold_s(1000) is None


# --- the race, in either package ---

def _env(jax, root, **knobs):
    if jax:
        JaxDispatcher.reset()
        cfg = JaxConfig(root_dir=f"file://{root}", **knobs)
        d = JaxDispatcher(cfg)
        return cfg, d, JaxHelper(d)
    cfg = ShuffleConfig(root_dir=f"file://{root}", **knobs)
    d = Dispatcher(cfg)
    return cfg, d, ShuffleHelper(d)


def _write(jax, d, helper, sizes, seed, agg=None):
    from s3shuffle_tpu_torch.write.map_output_writer import MapOutputWriter

    rng = random.Random(seed)
    truth = {}
    for m, row in enumerate(sizes):
        w = (JaxMapOutputWriter(d, helper, 0, m, len(row), aggregator=agg) if jax else
             MapOutputWriter(d, helper, 0, m, len(row), codec=None, device="cpu",
                             aggregator=agg))
        for p, n in enumerate(row):
            data = rng.randbytes(n)
            truth[(m, p)] = data
            pw = w.get_partition_writer(p)
            pw.write(data)
            pw.close()
        w.commit_all_partitions()
    return truth


class _Opens:
    """Counts each package's open ranged readers through a backend wrapper
    and records every (object, op)."""

    def __init__(self, inner):
        self._inner = inner
        self.live = 0
        self.gets = []
        self.lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def open_ranged(self, path, *args, **kwargs):
        reader = self._inner.open_ranged(path, *args, **kwargs)
        name = path.rsplit("/", 1)[-1]
        owner = self
        with self.lock:
            self.live += 1

        class _Reader:
            size = property(lambda _s: reader.size)

            def read_fully(self, position, length):
                with owner.lock:
                    owner.gets.append(name)
                return reader.read_fully(position, length)

            def close(self):
                reader.close()
                with owner.lock:
                    owner.live -= 1

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                self.close()

        return _Reader()

    def read_all(self, path):
        with self.open_ranged(path) as r:
            return r.read_fully(0, r.size)


def _scan(jax, d, helper, cfg, sizes):
    """One scan; returns ``(bytes by block, the port's reconstructions)``
    (no object is lost in these tests, so each is a won race)."""
    if jax:
        it = jax_scan_plan.build_scan_iterator(
            d, JaxMemo(helper), [JaxBlockId(0, m, p) for m in range(len(sizes))
                                 for p in range(len(sizes[m]))],
            cfg, fetcher=JaxFetcher.from_config(cfg))
        recovery = None
    else:
        recovery = DegradedReader(d, device="cpu")
        it = scan_plan.build_scan_iterator(
            d, ScanIndexMemo(helper), [ShuffleBlockId(0, m, p) for m in range(len(sizes))
                                       for p in range(len(sizes[m]))],
            cfg, recovery, fetcher=ChunkedRangeFetcher.from_config(cfg))
    got = {}
    for s in it:
        got[(s.block.map_id, s.block.reduce_id)] = s.readall()
        s.close()
    won = None if recovery is None else recovery.reconstructions
    return got, won


def _straggle(jax, d, fn, straggler=STRAGGLER):
    """Run ``fn`` with every read of the straggler's data object delayed
    below the retry layer, then wait for the abandoned GET to end."""
    flaky_cls, rule_cls = (JaxFlaky, JaxLatencyRule) if jax else (FlakyBackend, LatencyRule)
    tracker = jax_skew.OBJECT_GETS if jax else OBJECT_GETS
    opens = _Opens(d.backend)
    flaky = flaky_cls(opens)
    flaky.add_latency(rule_cls("read", match=straggler, delay_s=DELAY_S))
    saved, d.backend = d.backend, flaky
    try:
        d.clear_status_cache()
        return fn(), opens
    finally:
        deadline = time.monotonic() + DELAY_S + 10.0
        while tracker.inflight(straggler) and time.monotonic() < deadline:
            time.sleep(0.02)
        d.backend = saved


@pytest.mark.parametrize("jax", [False, True], ids=["port", "jax"])
def test_a_straggler_is_raced_and_won(tmp_path, metrics_on, jax):
    cfg, d, helper = _env(jax, tmp_path, speculative_read_quantile=0.9, **K1M1)
    truth = _write(jax, d, helper, SIZES, seed=8)
    _seed_fills(jax_reg if jax else reg, [HEALTHY_S] * 2 * degraded.MIN_FILL_SAMPLES)
    (got, won), opens = _straggle(jax, d, lambda: _scan(jax, d, helper, cfg, SIZES))
    assert got == truth  # the raced read returns the unraced bytes
    registry = jax_reg.REGISTRY if jax else reg.REGISTRY
    assert _counter(registry, "shuffle_parity_speculative_reads_total") == 1
    assert any(n.endswith(".parity") for n in opens.gets)
    if not jax:
        assert won == 1
        # the abandoned primary's reader closes when its GET ends
        deadline = time.monotonic() + 10.0
        while opens.live and time.monotonic() < deadline:
            time.sleep(0.02)
        assert opens.live == 0


@pytest.mark.parametrize("jax", [False, True], ids=["port", "jax"])
def test_a_straggling_composite_object_is_raced_and_won(tmp_path, metrics_on, jax):
    """A composite data object (three maps, group parity) raced as a
    singleton is: its members' partitions merge into one prefill, raced
    once and rebuilt from the group's parity."""
    from s3shuffle_tpu.write.composite_commit import CompositeCommitAggregator as JaxAggregator
    from s3shuffle_tpu_torch.write.composite_commit import CompositeCommitAggregator

    cfg, d, helper = _env(jax, tmp_path, speculative_read_quantile=0.9, composite_commit_maps=3,
                          composite_flush_ms=0.0, **K1M1)
    agg = JaxAggregator(d, helper) if jax else CompositeCommitAggregator(d, helper, device="cpu")
    truth = _write(jax, d, helper, SIZES, seed=14, agg=agg)
    agg.flush_shuffle(0)
    _seed_fills(jax_reg if jax else reg, [HEALTHY_S] * degraded.MIN_FILL_SAMPLES)
    (got, won), opens = _straggle(jax, d, lambda: _scan(jax, d, helper, cfg, SIZES),
                                  straggler="shuffle_0_comp_0.data")
    assert got == truth
    registry = jax_reg.REGISTRY if jax else reg.REGISTRY
    assert _counter(registry, "shuffle_parity_speculative_reads_total") == 1
    assert "shuffle_0_comp_0_par0.parity" in opens.gets
    assert won in (None, 1)


def test_the_race_decides_as_jax(tmp_path, metrics_on):
    """The same seeded histogram and straggler in both packages: one race
    each, on the same object, with the same parity GETs and the same bytes."""
    out = {}
    for jax in (False, True):
        cfg, d, helper = _env(jax, tmp_path / str(jax), speculative_read_quantile=0.9, **K2M2)
        truth = _write(jax, d, helper, [[3000, 2000], [4000, 100]], seed=12)
        _seed_fills(jax_reg if jax else reg, [HEALTHY_S] * degraded.MIN_FILL_SAMPLES)
        (got, _won), opens = _straggle(jax, d, lambda: _scan(jax, d, helper, cfg,
                                                             [[3000, 2000], [4000, 100]]))
        assert got == truth
        out[jax] = sorted(n for n in opens.gets if n.endswith(".parity"))
    assert out[False] == out[True] and out[False]
    assert _counter(reg.REGISTRY, "shuffle_parity_speculative_reads_total") == \
        _counter(jax_reg.REGISTRY, "shuffle_parity_speculative_reads_total") == 1


def test_an_ineligible_object_is_never_raced(tmp_path, metrics_on):
    """m < k over full stripe groups: parity alone cannot rebuild the
    range, so the straggler is waited out, as in the JAX package."""
    geometry = dict(parity_segments=1, parity_stripe_k=2, parity_chunk_bytes=1024)
    cfg, d, helper = _env(False, tmp_path, speculative_read_quantile=0.9, **geometry)
    truth = _write(False, d, helper, SIZES, seed=3)
    _seed_fills(reg, [0.001] * 20)
    (got, won), opens = _straggle(False, d, lambda: _scan(False, d, helper, cfg, SIZES))
    assert got == truth and won == 0
    assert _counter(reg.REGISTRY, "shuffle_parity_speculative_reads_total") == 0
    assert not any(n.endswith(".parity") for n in opens.gets)


@pytest.mark.parametrize("case", ["no-samples", "quantile-0", "registry-off"])
def test_speculation_never_fires_without_samples_quantile_or_registry(tmp_path, case):
    quantile = 0.0 if case == "quantile-0" else 0.9
    cfg, d, helper = _env(False, tmp_path, speculative_read_quantile=quantile, **K1M1)
    truth = _write(False, d, helper, [[2000, 2000], [3000, 10]], seed=9)
    if case != "registry-off":
        reg.REGISTRY.reset_values()
        reg.enable()
    try:
        if case != "no-samples":
            _seed_fills(reg, [0.001] * 20)
        flaky = FlakyBackend(d.backend)
        flaky.add_latency(LatencyRule("read", match="shuffle_0_0_0.data", delay_s=0.3))
        opens = _Opens(flaky)
        saved, d.backend = d.backend, opens
        try:
            got, won = _scan(False, d, helper, cfg, [[2000, 2000], [3000, 10]])
        finally:
            d.backend = saved
        assert got == truth and won == 0
        assert _counter(reg.REGISTRY, "shuffle_parity_speculative_reads_total") == 0
        assert not any(n.endswith(".parity") for n in opens.gets)
    finally:
        reg.disable()
        reg.REGISTRY.reset_values()


def test_a_speculation_won_fill_is_not_observed(tmp_path, metrics_on):
    """The fill the race won never enters the histogram its threshold came
    from; every fill the primaries won does."""
    cfg, d, helper = _env(False, tmp_path, speculative_read_quantile=0.9, **K1M1)
    _write(False, d, helper, SIZES, seed=5)
    _seed_fills(reg, [HEALTHY_S] * degraded.MIN_FILL_SAMPLES)
    _straggle(False, d, lambda: _scan(False, d, helper, cfg, SIZES))
    fills = reg.REGISTRY.histogram("read_prefetch_fill_seconds").read().count
    per_mib = reg.REGISTRY.histogram("read_prefetch_fill_per_mib_seconds",
                                     labelnames=("size_class",))
    # three one-segment maps: two primaries observed, the raced one not
    assert fills == 2
    assert per_mib.labels(size_class="le1m").read().count == degraded.MIN_FILL_SAMPLES + 2


# --- the defaults, op for op against the JAX package ---

BS = 2048
BATCH = 4
PARTS = 3
MAPS = 4


def _terasort(seed, n=600):
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (16, 90), dtype=np.uint8)
    out = []
    for _ in range(MAPS):
        keys = rng.integers(0, 256, (n, 10), dtype=np.uint8).reshape(-1)
        vals = pool[rng.integers(0, 16, n)].reshape(-1)
        out.append(RecordBatch(np.full(n, 10, np.int32), np.full(n, 90, np.int32), keys, vals))
    return out


class _Recorder:
    """Every positioned read of either package's backend as (object,
    offset, length), in order."""

    def __init__(self, inner):
        self._inner = inner
        self.reads = []
        self.lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def open_ranged(self, path, *args, **kwargs):
        inner = self._inner.open_ranged(path, *args, **kwargs)
        rec, name = self, path.rsplit("/", 1)[-1]

        class _Reader:
            size = property(lambda _s: inner.size)

            def read_fully(self, position, length):
                with rec.lock:
                    rec.reads.append((name, position, length))
                return inner.read_fully(position, length)

            def close(self):
                inner.close()

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                self.close()

        return _Reader()

    def read_all(self, path):
        with self.open_ranged(path) as r:
            return r.read_fully(0, r.size)

    def of(self, suffix):
        return [r for r in self.reads if r[0].endswith(suffix)]


def _reader_manager(root, jax, **knobs):
    base = dict(checksum_algorithm="CRC32C", codec_block_size=BS, codec_batch_blocks=BATCH,
                cleanup=False, max_concurrency_task=1, **knobs)
    if jax:
        JaxDispatcher.reset()
        mgr = JaxManager(JaxConfig(root_dir=f"file://{root}", codec="tpu",
                                   tpu_host_fallback=False, **base))
        dep = JaxDependency(0, JaxHashPartitioner(PARTS), serializer=JaxColumnarKV(),
                            key_ordering=jax_natural_key)
        status = JaxMapStatus
    else:
        mgr = ShuffleManager(ShuffleConfig(root_dir=f"file://{root}", **base), device="cpu")
        dep = ShuffleDependency(0, HashPartitioner(PARTS), serializer=ColumnarKVSerializer(),
                                key_ordering=natural_key)
        status = MapStatus
    _c, _d, helper = _env(False, root)
    handle = mgr.register_shuffle(0, dep)
    for m in range(MAPS):
        sizes = np.diff(helper.get_partition_lengths(0, m))
        mgr.tracker.register_map_output(0, status(map_id=m, location=STORE_LOCATION, sizes=sizes))
    rec = _Recorder(mgr.dispatcher.backend)
    mgr.dispatcher.backend = rec
    return mgr, handle, rec


@pytest.mark.parametrize("coded", [False, True], ids=["record-read", "coded-read"])
def test_defaults_issue_the_jax_requests_in_order(tmp_path, monkeypatch, coded):
    monkeypatch.setattr(jax_tlz, "_encode_block_native", lambda _data: None)
    knobs = K2M2 if coded else {}
    assert not reg.enabled() and not jax_reg.enabled()
    ctx = ShuffleContext(ShuffleConfig(root_dir=f"file://{tmp_path}", checksum_algorithm="CRC32C",
                                       codec_block_size=BS, codec_batch_blocks=BATCH, **knobs),
                         num_workers=2, device="cpu")
    ctx.sort_by_key(_terasort(5), PARTS, serializer=ColumnarKVSerializer(), cleanup=False)
    OBJECT_GETS.reset_peaks()
    out = {}
    for jax in (False, True):
        mgr, handle, rec = _reader_manager(tmp_path, jax, **knobs)
        assert mgr.config.speculative_read_quantile == 0.99
        assert (mgr.config.combine_threshold_bytes, mgr.config.split_threshold_bytes,
                mgr.config.hot_read_fanout) == (0, 0, 0)
        rows = []
        for lo, hi in [(p, p + 1) for p in range(PARTS)]:
            reader = mgr.get_reader(handle, lo, hi)
            batch = (JaxRecordBatch if jax else RecordBatch).concat(
                list(reader.read_result_batches()))
            rows.append([k + v for k, v in batch.iter_records()])
        out[jax] = (rows, rec)
    (rows, rec), (jrows, jrec) = out[False], out[True]
    assert rows == jrows
    # one prefetch thread issues the data GETs in block order: op for op
    assert rec.of(".data") == jrec.of(".data") and rec.of(".data")
    assert sorted(rec.reads) == sorted(jrec.reads)
    assert not rec.of(".parity") and not jrec.of(".parity")  # no race, no fan-out
    assert OBJECT_GETS.peak("shuffle_0_0_0.data") == 1  # tracked, one GET at a time
