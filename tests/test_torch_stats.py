"""The port's per-shuffle stats reports (``metrics/stats.py``) and the
single-process metric hooks against the JAX package's, on the CPU.

- ``TaskStats``, ``ShuffleStats`` and ``ShuffleStatsCollector`` on the same
  seeded sequences of map and reduce entries give the same reports, dumps
  and outbox; the tracker side folds and answers as the JAX tracker does;
  ``S3SHUFFLE_STATS`` dumps at exit.
- The repairs: a ``ShuffleContext`` run records one map entry per commit
  and one reduce entry per completed reduce task.
- Stats parity: the counts, bytes and records of one TeraSort's report are
  equal between the packages (seconds are not compared).
- Hook parity: counter values and histogram counts are equal between the
  packages for the codec frames and fused CRCs, the record rows and frames,
  the checksum validations and a failure on a corrupted object, retries
  and backoffs under a seeded fault rule, parity bytes and
  reconstructions, composite members, groups and saved PUTs, compaction,
  and sweep deletes. The launch histograms (``codec_encode_batch_seconds``,
  ``codec_assembly_seconds``) are the exception: the port's map writer
  encodes the held blocks of a task's partition streams in shared
  launches, so their counts are the shared launches that the streams'
  held blocks make, at most the JAX package's one launch per stream.

Registries and collectors are turned on only inside fixtures that turn them
off and empty them; a module fixture checks both packages' planes, the
``S3SHUFFLE_*`` variables and the file's threads when the file ends.
"""

import collections
import json
import os
import random
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from s3shuffle_tpu.batch import RecordBatch as JaxRecordBatch
from s3shuffle_tpu.config import ShuffleConfig as JaxConfig
from s3shuffle_tpu.coding.degraded import DegradedReader as JaxDegradedReader
from s3shuffle_tpu.block_ids import ShuffleDataBlockId as JaxDataBlockId
from s3shuffle_tpu.manager import ShuffleManager as JaxManager
from s3shuffle_tpu.metadata.helper import ShuffleHelper as JaxHelper
from s3shuffle_tpu.metadata.map_output import MapOutputTracker as JaxTracker
from s3shuffle_tpu.metadata.map_output import MapStatus as JaxMapStatus
from s3shuffle_tpu.metrics import registry as jax_reg
from s3shuffle_tpu.metrics import stats as jax_stats
from s3shuffle_tpu.ops import tlz as jax_tlz
from s3shuffle_tpu.read.chunked_fetch import ChunkedRangeFetcher as JaxFetcher
from s3shuffle_tpu.read.block_stream import BlockStream as JaxBlockStream
from s3shuffle_tpu.read.checksum_stream import ChecksumError as JaxChecksumError
from s3shuffle_tpu.read.checksum_stream import ChecksumValidationStream as JaxChecksumStream
from s3shuffle_tpu.metadata.helper import ScanIndexMemo as JaxMemo
from s3shuffle_tpu.block_ids import ShuffleBlockId as JaxBlockId
from s3shuffle_tpu.read.scan_plan import build_scan_iterator as jax_build_scan
from s3shuffle_tpu.serializer import ColumnarKVSerializer as JaxColumnarKV
from s3shuffle_tpu.shuffle import ShuffleContext as JaxContext
from s3shuffle_tpu.storage import retrying as jax_retrying
from s3shuffle_tpu.storage.dispatcher import Dispatcher as JaxDispatcher
from s3shuffle_tpu.storage.fault import FaultRule as JaxFaultRule
from s3shuffle_tpu.storage.fault import FlakyBackend as JaxFlaky
from s3shuffle_tpu.storage.fault import transient_connection_reset as jax_reset_fault
from s3shuffle_tpu.storage.retrying import RetryingBackend as JaxRetrying
from s3shuffle_tpu.utils import trace as jax_trace
from s3shuffle_tpu.write.compactor import compact_shuffle as jax_compact
from s3shuffle_tpu.write.composite_commit import CompositeCommitAggregator as JaxAggregator
from s3shuffle_tpu.write.map_output_writer import MapOutputWriter as JaxMapOutputWriter
from s3shuffle_tpu_torch import ShuffleConfig, ShuffleContext
from s3shuffle_tpu_torch.batch import RecordBatch
from s3shuffle_tpu_torch.block_ids import ShuffleBlockId, ShuffleDataBlockId
from s3shuffle_tpu_torch.coding.degraded import DegradedReader
from s3shuffle_tpu_torch.manager import ShuffleManager
from s3shuffle_tpu_torch.metadata.helper import ShuffleHelper
from s3shuffle_tpu_torch.metadata.map_output import STORE_LOCATION, MapOutputTracker, MapStatus
from s3shuffle_tpu_torch.metrics import registry as reg
from s3shuffle_tpu_torch.metrics import stats
from s3shuffle_tpu_torch.read.checksum_stream import ChecksumError
from s3shuffle_tpu_torch.read.reader import ShuffleReader
from s3shuffle_tpu_torch.serializer import ColumnarKVSerializer
from s3shuffle_tpu_torch.storage import retrying
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
from s3shuffle_tpu_torch.storage.fault import FaultRule, FlakyBackend, transient_connection_reset
from s3shuffle_tpu_torch.storage.retrying import RetryingBackend
from s3shuffle_tpu_torch.utils import trace
from s3shuffle_tpu_torch.write.compactor import compact_shuffle
from s3shuffle_tpu_torch.write.composite_commit import CompositeCommitAggregator
from s3shuffle_tpu_torch.write.map_output_writer import MapOutputWriter
from torch_jax_native import jax_native_library  # noqa: F401  (loads the JAX oracle's native library)
from torch_port_dispatcher import port_dispatcher_reset  # noqa: F401  (resets the port's process dispatcher)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROCESS_POOLS = ("s3shuffle-torch-encode", "s3shuffle-torch-decode", "s3shuffle-torch-fetch",
                 "s3shuffle-torch-speculate", "s3shuffle-encode", "s3shuffle-decode",
                 "s3shuffle-fetch", "s3shuffle-speculate", "s3shuffle-tpu-encode",
                 "s3shuffle-tpu-decode")
TRACERS = (trace, jax_trace)
REGISTRIES = (reg, jax_reg)
COLLECTORS = (stats.COLLECTOR, jax_stats.COLLECTOR)


def _env_vars():
    return {k: v for k, v in os.environ.items() if k.startswith("S3SHUFFLE_")}


def _reset_planes():
    for t in TRACERS:
        t.disable()
        t.reset()
        t.configure_flight(dir="", ring=t.FLIGHT_RING_DEFAULT, worker_id="")
        t._flight.clear()
        t._flight_error = False
    for r in REGISTRIES:
        r.disable()
        r.REGISTRY.reset_values()
    for c in COLLECTORS:
        c.reset()


@pytest.fixture(scope="module", autouse=True)
def file_hygiene():
    """When the file ends: both packages' tracers off and empty with the
    flight ring at its default, registries off and zero, collectors empty;
    no ``S3SHUFFLE_*`` variable changed; no thread of this file alive but
    the process-wide pools' workers; no ``s3shuffle_trace.json`` written."""
    _reset_planes()
    env = _env_vars()
    threads = set(threading.enumerate())
    residue = os.path.exists("s3shuffle_trace.json")
    yield
    for t in TRACERS:
        assert not t.enabled() and t.events_snapshot() == [] and t.counters() == {}
        assert t._flight_enabled and t._flight.maxlen == t.FLIGHT_RING_DEFAULT
        assert len(t._flight) == 0 and t._flight_dir is None
    for r in REGISTRIES:
        assert not r.enabled() and r.REGISTRY.snapshot(compact=True) == {}
    for c in COLLECTORS:
        assert c.shuffle_ids() == [] and len(c._outbox) == 0
    assert _env_vars() == env
    assert os.path.exists("s3shuffle_trace.json") == residue
    deadline = time.monotonic() + 10.0
    while True:
        left = [t for t in threading.enumerate() if t not in threads and t.is_alive()
                and not t.name.startswith(PROCESS_POOLS)]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert not left, [t.name for t in left]


@pytest.fixture
def metrics_on():
    """Both registries on and zero, both collectors empty; all of it off
    and empty after."""
    _reset_planes()
    for r in REGISTRIES:
        r.enable()
    yield
    _reset_planes()


@pytest.fixture(autouse=True)
def fresh_jax_dispatcher():
    JaxDispatcher.reset()
    yield
    JaxDispatcher.reset()


@pytest.fixture(autouse=True)
def no_c_encoder(monkeypatch):
    """The JAX side's numpy TLZ host encoder (its C encoder picks other
    valid matches; tests/test_torch_record_slice.py)."""
    monkeypatch.setattr(jax_tlz, "_encode_block_native", lambda _data: None)


# --- the collector, unit by unit ---------------------------------------------

def _sequence(seed):
    """A seeded mix of map and reduce entries over three shuffles."""
    rng = random.Random(seed)
    out = []
    for _ in range(rng.randrange(5, 40)):
        sid = rng.randrange(3)
        if rng.random() < 0.5:
            out.append(("map", dict(shuffle_id=sid, map_id=rng.randrange(50),
                                    bytes=rng.randrange(1 << 20), records=rng.randrange(9999),
                                    seconds=rng.random(), spills=rng.randrange(3))))
        else:
            out.append(("reduce", dict(shuffle_id=sid, partition=rng.randrange(9),
                                       bytes=rng.randrange(1 << 20),
                                       records=rng.randrange(9999),
                                       prefetch_seconds=rng.random(),
                                       wait_seconds=rng.random(),
                                       threads=rng.randrange(1, 9))))
    return out


def _feed(collector, sequence):
    for kind, kw in sequence:
        (collector.record_map if kind == "map" else collector.record_reduce)(**kw)


def _without_origin(entries):
    return [{k: v for k, v in e.items() if k != "origin"} for e in entries]


@pytest.mark.parametrize("seed", range(5))
def test_reports_equal_jax_on_the_same_entries(metrics_on, seed):
    port, jax = stats.ShuffleStatsCollector(), jax_stats.ShuffleStatsCollector()
    _feed(port, _sequence(seed))
    _feed(jax, _sequence(seed))
    assert port.shuffle_ids() == jax.shuffle_ids()
    for sid in port.shuffle_ids():
        assert (port.report(sid, include_metrics=False).to_dict()
                == jax.report(sid, include_metrics=False).to_dict())
    assert ([r.to_dict() for r in port.reports(include_metrics=False)]
            == [r.to_dict() for r in jax.reports(include_metrics=False)])
    assert _without_origin(port.drain_outbox()) == _without_origin(jax.drain_outbox())
    assert port.drain_outbox() == []


def test_recording_is_a_no_op_with_the_registry_off():
    _reset_planes()
    collector = stats.ShuffleStatsCollector()
    collector.record_map(0, 0, 10, 1, 0.1)
    collector.merge(stats.TaskStats("map", 0, 1, 5).to_dict())
    assert collector.report(0) is None and collector.drain_outbox() == []


def test_merge_folds_remote_entries_once_and_skips_its_own(metrics_on):
    here, there = stats.ShuffleStatsCollector(), stats.ShuffleStatsCollector()
    jax_here, jax_there = jax_stats.ShuffleStatsCollector(), jax_stats.ShuffleStatsCollector()
    for a, b in ((here, there), (jax_here, jax_there)):
        a.record_map(7, 0, 100, 10, 0.5, spills=1)
        b.record_reduce(7, 0, 80, 10, 0.2, 0.1, threads=2)
        for entry in b.drain_outbox():
            a.merge(entry)
        for entry in a.drain_outbox():
            a.merge(entry)  # its own entry: already counted
    for a, b in ((here, jax_here), (there, jax_there)):
        assert a.report(7, include_metrics=False).to_dict() == b.report(
            7, include_metrics=False).to_dict()
    got = here.report(7, include_metrics=False)
    assert (got.map_tasks, got.reduce_tasks, got.bytes_read, got.spills) == (1, 1, 80, 1)
    assert here.drain_outbox() == []  # merging enqueues nothing


def test_report_attaches_the_registry_snapshot(metrics_on):
    collector = stats.ShuffleStatsCollector()
    collector.record_map(1, 0, 10, 1, 0.1)
    reg.REGISTRY.counter("storage_read_bytes_total", labelnames=("scheme",)).labels(
        scheme="file").inc(5)
    assert collector.report(1).metrics == reg.REGISTRY.snapshot(compact=True)
    assert collector.report(1, include_metrics=False).metrics == {}
    assert collector.report(2) is None


def test_the_aggregate_and_the_outbox_stay_bounded(metrics_on, monkeypatch):
    for cls in (stats.ShuffleStatsCollector, jax_stats.ShuffleStatsCollector):
        monkeypatch.setattr(cls, "SHUFFLES_MAX", 3)
        monkeypatch.setattr(cls, "OUTBOX_MAX", 4)
    port, jax = stats.ShuffleStatsCollector(), jax_stats.ShuffleStatsCollector()
    for c in (port, jax):
        for sid in range(6):
            c.record_map(sid, 0, 1, 1, 0.0)
    assert port.shuffle_ids() == jax.shuffle_ids() == [3, 4, 5]
    assert len(port.drain_outbox()) == len(jax.drain_outbox()) == 4


def test_drop_reset_and_the_dump_document(metrics_on, tmp_path):
    from tools.trace_report import render

    collector = stats.ShuffleStatsCollector()
    _feed(collector, _sequence(3))
    path = str(tmp_path / "stats.json")
    collector.dump(path)
    with open(path) as f:
        doc = json.load(f)
    assert [r["shuffle_id"] for r in doc["shuffles"]] == collector.shuffle_ids()
    for r in doc["shuffles"]:  # the JAX package reads the port's dump
        assert jax_stats.ShuffleStats.from_dict(r).to_dict() == r
        assert stats.ShuffleStats.from_json(json.dumps(r)).to_dict() == r
    assert "shuffle" in render(doc).lower()
    first = collector.shuffle_ids()[0]
    collector.drop(first)
    assert first not in collector.shuffle_ids()
    collector.reset()
    assert collector.shuffle_ids() == [] and collector.drain_outbox() == []


def test_task_and_shuffle_stats_round_trip_across_packages():
    ts = stats.TaskStats("reduce", 2, 5, 100, 9, 0.5, wait_seconds=0.25, threads=3)
    assert jax_stats.TaskStats.from_dict(ts.to_dict()).to_dict() == ts.to_dict()
    assert stats.TaskStats.from_dict(dict(ts.to_dict(), extra=1)) == ts
    agg = stats.ShuffleStats(2)
    agg.add(ts)
    agg.add(stats.TaskStats("map", 2, 0, 50, 9, 1.0, spills=2))
    jagg = jax_stats.ShuffleStats(2)
    jagg.add(jax_stats.TaskStats.from_dict(ts.to_dict()))
    jagg.add(jax_stats.TaskStats("map", 2, 0, 50, 9, 1.0, spills=2))
    assert agg.to_dict() == jagg.to_dict()
    assert stats.ShuffleStats.from_json(agg.to_json()) == agg


def test_the_tracker_folds_entries_and_answers_as_jax(metrics_on):
    entries = [stats.TaskStats("map", 4, m, 10 * m, m, 0.1).to_dict() for m in range(3)]
    entries.append(stats.TaskStats("reduce", 4, 0, 30, 3, 0.1, 0.2, 1).to_dict())
    port, jax = MapOutputTracker(), JaxTracker()
    port.report_task_stats(entries)
    jax.report_task_stats(entries)
    got, want = port.get_shuffle_stats(4), jax.get_shuffle_stats(4)
    got.pop("metrics"), want.pop("metrics")
    assert got == want
    assert (got["map_tasks"], got["reduce_tasks"], got["bytes_written"]) == (3, 1, 30)
    assert port.get_shuffle_stats(5) is None


def test_the_stats_variable_dumps_every_report_at_exit(tmp_path):
    path = tmp_path / "stats.json"
    code = (
        "from s3shuffle_tpu_torch.metrics import registry, stats\n"
        "assert registry.enabled()\n"
        "stats.COLLECTOR.record_map(3, 0, 123, 4, 0.5)\n"
        "stats.COLLECTOR.record_reduce(3, 0, 100, 4, 0.1, 0.2, threads=1)\n"
    )
    env = dict(os.environ, S3SHUFFLE_STATS=str(path), PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    (report,) = json.loads(path.read_text())["shuffles"]
    assert (report["shuffle_id"], report["map_tasks"], report["reduce_tasks"],
            report["bytes_written"], report["bytes_read"]) == (3, 1, 1, 123, 100)
    assert os.listdir(tmp_path) == ["stats.json"]


# --- one TeraSort through both packages: reports and hooks ---------------------

BS, BATCH, MAPS, PARTS, ROWS = 2048, 4, 3, 3, 700
SYNC = dict(encode_inflight_batches=1, decode_inflight_batches=1)
BASE = dict(checksum_algorithm="CRC32C", codec_block_size=BS, codec_batch_blocks=BATCH,
            cleanup=False, max_concurrency_task=1, speculative_read_quantile=0.0)


@pytest.fixture
def jax_device_codec(monkeypatch):
    """The JAX codec on its device path (its kernels interpreted on the
    CPU), past its measured-rate gate, which the port does not have."""
    monkeypatch.setenv("S3SHUFFLE_TPU_CODEC_DEVICE", "1")
    monkeypatch.setenv("S3SHUFFLE_TLZ_PALLAS", "1")


def _terasort_parts(cls, seed=9, n=ROWS):
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (16, 90), dtype=np.uint8)
    out = []
    for _ in range(MAPS):
        keys = rng.integers(0, 256, (n, 10), dtype=np.uint8).reshape(-1)
        vals = pool[rng.integers(0, 16, n)].reshape(-1)
        out.append(cls(np.full(n, 10, np.int32), np.full(n, 90, np.int32), keys, vals))
    return out


def _group_parts(seed=4, n=500):
    rng = np.random.default_rng(seed)
    return [[(int(k), bytes(v)) for k, v in zip(rng.integers(0, 60, n),
                                                rng.integers(0, 256, (n, 12), dtype=np.uint8))]
            for _ in range(MAPS)]


def _readings(registry, skip=("codec_path_selected_total",)):
    """Counter values and histogram counts, by series labels (gauges and
    the JAX rate gate's path counter left out)."""
    out = {}
    for name, metric in registry.REGISTRY.snapshot(compact=True).items():
        if name in skip or metric["kind"] == "gauge":
            continue
        for series in metric["series"]:
            labels = tuple(sorted(series.get("labels", {}).items()))
            out[(name,) + labels] = series["count"] if "count" in series else series["value"]
    return out


def _run(root, jax, bypass=None, group=False, **knobs):
    """TeraSort (and optionally a pickled group_by_key) through a fresh
    context with the registry on. Returns (report dicts by shuffle, the
    registry's readings, sorted rows, records)."""
    extra = {} if bypass is None else {"bypass_merge_threshold": bypass}
    if jax:
        mgr = JaxManager(JaxConfig(root_dir=f"file://{root}", codec="tpu",
                                   tpu_host_fallback=False, **BASE, **knobs), **extra)
        ctx = JaxContext(manager=mgr, num_workers=2)
        parts, ser, cls, collector, registry = (
            _terasort_parts(JaxRecordBatch), JaxColumnarKV(), JaxRecordBatch,
            jax_stats.COLLECTOR, jax_reg)
    else:
        mgr = ShuffleManager(ShuffleConfig(root_dir=f"file://{root}", **BASE, **knobs),
                             device="cpu", **extra)
        ctx = ShuffleContext(manager=mgr, num_workers=2)
        parts, ser, cls, collector, registry = (
            _terasort_parts(RecordBatch), ColumnarKVSerializer(), RecordBatch,
            stats.COLLECTOR, reg)
    collector.reset()
    registry.REGISTRY.reset_values()
    try:
        out = ctx.sort_by_key(parts, PARTS, serializer=ser, materialize="batches",
                              cleanup=False)
        if group:
            ctx.group_by_key(_group_parts(), PARTS)
        reports = {sid: collector.report(sid, include_metrics=False).to_dict()
                   for sid in collector.shuffle_ids()}
        readings = _readings(registry)
        # the maps' partition lengths sum to their data objects' sizes
        lengths = sum(os.path.getsize(os.path.join(d, f)) for d, _s, files in os.walk(root)
                      for f in files if f.endswith(".data"))
    finally:
        ctx.stop()
        collector.reset()
        registry.REGISTRY.reset_values()
    rows = [[k + v for k, v in cls.concat(list(p)).iter_records()] for p in out]
    return reports, readings, rows, lengths


SECONDS = ("write_seconds", "read_wait_seconds", "read_prefetch_seconds")


def _counts(report):
    return {k: v for k, v in report.items() if k not in SECONDS + ("metrics",)}


def test_a_port_context_records_every_map_commit_and_reduce_completion(tmp_path, metrics_on):
    """The repairs: the map side's entry at commit and the reduce side's at
    completion, for every task of a ShuffleContext run."""
    reports, readings, rows, lengths = _run(tmp_path / "port", False)
    (report,) = reports.values()
    assert (report["map_tasks"], report["reduce_tasks"]) == (MAPS, PARTS)
    assert report["records_written"] == report["records_read"] == MAPS * ROWS
    assert report["bytes_written"] == lengths
    assert report["bytes_read"] == readings[("storage_read_bytes_total", ("scheme", "file"))] \
        - _index_and_checksum_bytes(tmp_path / "port")
    assert report["write_seconds"] > 0 and report["read_prefetch_seconds"] > 0
    assert report["max_prefetch_threads"] == 1
    assert readings[("write_commit_seconds",)] == MAPS


def _index_and_checksum_bytes(root):
    total = 0
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            if fn.endswith(".index") or ".checksum." in fn:
                total += os.path.getsize(os.path.join(dirpath, fn))
    return total


def _launch_tally(monkeypatch) -> dict:
    """The port's batch launches: those a stream makes as a batch of full
    blocks fills while it is written (``write``), and the full blocks each
    stream holds at every ``flush_streams`` call (``held``, one list per
    call: a map writer's partition streams at its spills and its commit,
    a lone stream at its own flush)."""
    from s3shuffle_tpu_torch.codec import framing
    from s3shuffle_tpu_torch.write import spill_writer

    seen = {"write": 0, "held": []}
    emit_framed, flush_streams = framing.CodecOutputStream._emit_framed, framing.flush_streams

    def counted_emit(self, n_blocks):
        seen["write"] += 1
        return emit_framed(self, n_blocks)

    def counted_flush(streams):
        seen["held"].append([len(s._buf) // s._codec.block_size for s in streams])
        return flush_streams(streams)

    monkeypatch.setattr(framing.CodecOutputStream, "_emit_framed", counted_emit)
    monkeypatch.setattr(framing, "flush_streams", counted_flush)
    monkeypatch.setattr(spill_writer, "flush_streams", counted_flush)
    return seen


#: one observation per batch launch (the launch and its host assembly)
LAUNCH_HISTOGRAMS = (("codec_encode_batch_seconds",), ("codec_assembly_seconds",))


@pytest.mark.parametrize("case", ["bypass", "serialized-spills", "windows", "group"])
def test_one_terasort_reports_and_hooks_equal_jax(tmp_path, metrics_on, jax_device_codec,
                                                   monkeypatch, case):
    knobs = {"bypass": {}, "serialized-spills": dict(bypass=0, max_buffer_size_task=20000),
             "windows": {}, "group": dict(group=True)}[case]
    if case != "windows":
        knobs = dict(knobs, **SYNC)
    launches = _launch_tally(monkeypatch)
    port_reports, port, port_rows, _ = _run(tmp_path / "port", False, **knobs)
    jax_reports, jax, jax_rows, _ = _run(tmp_path / "jax", True, **knobs)
    # the port's map writer frames the held full blocks of all a task's
    # partition streams in shared launches of BATCH rows, the JAX package
    # each stream's alone: the launch histograms count the port's launches
    ceil = lambda n: -(-n // BATCH)  # noqa: E731
    shared = launches["write"] + sum(ceil(sum(held)) for held in launches["held"])
    alone = launches["write"] + sum(ceil(h) for held in launches["held"] for h in held)
    for key in LAUNCH_HISTOGRAMS:
        assert (port.pop(key), jax.pop(key)) == (shared, alone), key
    assert shared <= alone
    if case == "group":
        assert shared < alone
    if case == "serialized-spills":
        # the port's serialized writer stitches its sidecar from the encode
        # launch's fused CRCs; the JAX one hashes the stored bytes (the
        # same sidecar bytes)
        fused = port.pop(("codec_fused_crc_total",))
        assert fused > 0 and ("codec_fused_crc_total",) not in jax
    assert port_rows == jax_rows
    assert {s: _counts(r) for s, r in port_reports.items()} == {
        s: _counts(r) for s, r in jax_reports.items()}
    assert port == jax
    assert shared > 0
    for name in ("codec_decode_batch_seconds", "codec_frames_total",
                 "codec_fused_crc_validated_total", "read_checksum_validate_seconds",
                 "write_commit_seconds", "write_upload_seconds", "record_partition_seconds"):
        assert port[(name,)] > 0, name
    if case != "serialized-spills":
        assert port[("codec_fused_crc_total",)] > 0
    assert port[("record_rows_total", ("plane", "read"))] == MAPS * ROWS
    if case == "serialized-spills":
        assert port[("write_spill_seconds",)] > 0 and port[("write_serialize_seconds",)] > 0
    if case == "group":
        assert port[("record_fallback_rows_total", ("site", "write"))] > 0


# --- checksum failure, retries, parity, composites, compaction, sweeps ---------

def _port_env(root, **knobs):
    knobs.setdefault("composite_flush_ms", 0.0)
    d = Dispatcher(ShuffleConfig(root_dir=f"file://{root}", **knobs))
    return d, ShuffleHelper(d)


def _jax_env(root, **knobs):
    JaxDispatcher.reset()
    knobs.setdefault("composite_flush_ms", 0.0)
    d = JaxDispatcher(JaxConfig(root_dir=f"file://{root}", speculative_read_quantile=0.0,
                                **knobs))
    return d, JaxHelper(d)


def _payload(m, p, n):
    return random.Random(m * 31 + p).randbytes(n)


def _write_raw(jax, d, helper, sizes, sid=0, agg=None, base_map=0):
    for i, row in enumerate(sizes):
        m = base_map + i
        if jax:
            w = JaxMapOutputWriter(d, helper, sid, m, len(row), aggregator=agg)
        else:
            w = MapOutputWriter(d, helper, sid, m, len(row), codec=None, device="cpu",
                                aggregator=agg)
        for p, n in enumerate(row):
            pw = w.get_partition_writer(p)
            if n:
                pw.write(_payload(m, p, n))
            pw.close()
        w.commit_all_partitions()


def _scan_all(jax, d, helper, sizes, sid=0):
    """Every non-empty (map, partition) read back and validated against
    the checksum sidecar: the port through ``ShuffleReader.read_partition``,
    the JAX package through its scan and checksum stream."""
    blocks = [(m, p) for m in range(len(sizes)) for p in range(len(sizes[0])) if sizes[m][p]]
    got = {}
    if jax:
        it = jax_build_scan(d, JaxMemo(helper), [JaxBlockId(sid, m, p) for m, p in blocks],
                            d.config, fetcher=JaxFetcher.from_config(d.config))
        try:
            for s in it:
                m, p = s.block.map_id, s.block.reduce_id
                offsets = helper.get_partition_lengths(sid, m)
                checked = JaxChecksumStream(s.block, s, offsets, helper.get_checksums(sid, m),
                                            p, p + 1, d.config.checksum_algorithm)
                with checked:
                    got[(m, p)] = checked.read()
        finally:
            it.close() if hasattr(it, "close") else None
        return got
    reader = ShuffleReader(d, helper, codec=None, device="cpu")
    for m, p in blocks:
        got[(m, p)] = reader.read_partition(sid, p, [m])
    return got


def _retry_layer(d):
    top = d.backend
    while not isinstance(top, (RetryingBackend, JaxRetrying)):
        top = top.inner
    return top


SIZES = [[3000, 0, 700], [1200, 900, 50], [0, 2500, 10]]


def _corrupt(root, name, offset=5):
    for dirpath, _dirs, files in os.walk(root):
        if name in files:
            path = os.path.join(dirpath, name)
            with open(path, "r+b") as f:
                f.seek(offset)
                byte = f.read(1)
                f.seek(offset)
                f.write(bytes([byte[0] ^ 0xFF]))
            return
    raise AssertionError(f"{name} not found")


def test_checksum_validations_and_a_failure_count_as_in_jax(tmp_path, metrics_on):
    readings = []
    for jax in (False, True):
        root = tmp_path / ("jax" if jax else "port")
        d, h = (_jax_env if jax else _port_env)(root)
        _write_raw(jax, d, h, SIZES)
        assert _scan_all(jax, d, h, SIZES) == {
            (m, p): _payload(m, p, n) for m, row in enumerate(SIZES) for p, n in enumerate(row)
            if n}
        _corrupt(root, "shuffle_0_1_0.data")
        with pytest.raises(JaxChecksumError if jax else ChecksumError, match="shuffle_0_1_0"):
            _scan_all(jax, d, h, [[0] * 3, [SIZES[1][0], 0, 0], [0] * 3])
        readings.append(_readings(jax_reg if jax else reg))
    port, jax = readings
    for r in (port, jax):
        r.pop(("storage_read_bytes_total", ("scheme", "file")), None)
        for key in [k for k in r if k[0] in ("storage_op_seconds", "read_prefetch_wait_seconds",
                                             "read_prefetch_fill_seconds",
                                             "read_prefetch_fill_class_seconds",
                                             "read_prefetch_fill_per_mib_seconds",
                                             "read_index_prefetch_seconds",
                                             "read_coalesced_segments_total",
                                             "read_gets_saved_total",
                                             "read_coalesce_waste_bytes_total",
                                             "read_checksum_validate_seconds")]:
            r.pop(key)
    assert port[("read_checksum_failures_total",)] == jax[("read_checksum_failures_total",)] == 1
    assert port == jax


def test_every_validated_partition_is_timed_as_in_jax(tmp_path, metrics_on):
    counts = []
    for jax in (False, True):
        root = tmp_path / ("jax" if jax else "port")
        d, h = (_jax_env if jax else _port_env)(root, coalesce_gap_bytes=0)
        _write_raw(jax, d, h, SIZES)
        _scan_all(jax, d, h, SIZES)
        counts.append(_readings(jax_reg if jax else reg)[("read_checksum_validate_seconds",)])
    assert counts[0] == counts[1] > 0


def test_retries_and_backoffs_count_as_in_jax_under_a_seeded_rule(tmp_path, metrics_on):
    readings = []
    for jax in (False, True):
        root = tmp_path / ("jax" if jax else "port")
        d, h = (_jax_env if jax else _port_env)(root, storage_retry_base_ms=0.1,
                                                 coalesce_gap_bytes=0)
        rule = (JaxFaultRule if jax else FaultRule)(
            "read", match=".data", times=None, prob=0.3, rng_seed=5,
            exc=jax_reset_fault if jax else transient_connection_reset)
        retry = _retry_layer(d)
        retry.inner = (JaxFlaky if jax else FlakyBackend)(retry.inner, [rule])
        _write_raw(jax, d, h, SIZES)
        assert _scan_all(jax, d, h, SIZES) == {
            (m, p): _payload(m, p, n) for m, row in enumerate(SIZES) for p, n in enumerate(row)
            if n}
        readings.append({k: v for k, v in _readings(jax_reg if jax else reg).items()
                         if k[0].startswith("storage_retr")})
    port, jax = readings
    assert port == jax
    assert port[("storage_retries_total", ("op", "read"), ("scheme", "file"))] > 0
    assert port[("storage_retry_backoff_seconds",)] == sum(
        v for k, v in port.items() if k[0] == "storage_retries_total")


def test_a_deadline_counts_as_in_jax(metrics_on):
    for module, counter in ((retrying, reg), (jax_retrying, jax_reg)):
        policy = module.RetryPolicy(retries=5, base_ms=1000.0, max_backoff_s=1.0,
                                    deadline_s=0.5)
        calls = []

        def fail():
            calls.append(1)
            raise ConnectionResetError("reset")

        with pytest.raises(ConnectionResetError):
            module.retry_call(fail, policy, op="read", scheme="file", sleep=lambda _s: None,
                              clock=lambda: 0.0, rng=random.Random(0))
    port, jax = _readings(reg), _readings(jax_reg)
    assert port == jax
    assert port[("storage_deadline_exceeded_total", ("op", "read"), ("scheme", "file"))] == 1


CODED = dict(parity_segments=1, parity_stripe_k=2, parity_chunk_bytes=1024)


def test_parity_bytes_and_reconstructions_count_as_in_jax(tmp_path, metrics_on):
    readings = []
    for jax in (False, True):
        root = tmp_path / ("jax" if jax else "port")
        d, h = (_jax_env if jax else _port_env)(root, **CODED)
        _write_raw(jax, d, h, SIZES)
        recovery = JaxDegradedReader(d) if jax else DegradedReader(d, device="cpu")
        recovery.note(h, 0, 1)
        block = JaxDataBlockId(0, 1) if jax else ShuffleDataBlockId(0, 1)
        with open(d.get_path(block)[len("file://"):], "rb") as f:
            stored = f.read()
        for start, end in [(10, 900), (1030, 2000), (2100, 2140)]:
            got = recovery.reconstruct(block, start, end, reason="loss")
            assert got == stored[start:end]
        readings.append({k: v for k, v in _readings(jax_reg if jax else reg).items()
                         if k[0].startswith("shuffle_parity")})
    port, jax = readings
    assert port == jax
    assert port[("shuffle_parity_reconstructions_total", ("reason", "loss"))] == 3
    assert port[("shuffle_parity_bytes_written_total",)] > 0
    assert port[("shuffle_parity_encode_seconds",)] > 0


def test_composite_groups_members_and_saved_puts_count_as_in_jax(tmp_path, metrics_on):
    readings = []
    for jax in (False, True):
        root = tmp_path / ("jax" if jax else "port")
        d, h = (_jax_env if jax else _port_env)(root, composite_commit_maps=2)
        agg = JaxAggregator(d, h) if jax else CompositeCommitAggregator(d, h, device="cpu")
        _write_raw(jax, d, h, SIZES, agg=agg)
        agg.flush_all()
        readings.append({k: v for k, v in _readings(jax_reg if jax else reg).items()
                         if k[0].startswith(("write_composite", "write_puts_saved"))})
    port, jax = readings
    assert port == jax
    assert port[("write_composite_groups_total",)] == 2
    assert port[("write_composite_members_total",)] == 3
    # three PUTs a map in the per-map layout, two a group (data, fat index)
    assert port[("write_puts_saved_total",)] == (3 * 2 - 2) + (3 * 1 - 2)


def _tracker_with(sizes, cls, status):
    tracker = cls()
    tracker.register_shuffle(0, len(sizes[0]))
    for m, row in enumerate(sizes):
        tracker.register_map_output(0, status(map_id=m, location=STORE_LOCATION,
                                              sizes=np.array(row, dtype=np.int64)))
    return tracker


def test_compaction_and_sweep_deletes_count_as_in_jax(tmp_path, metrics_on):
    readings = []
    for jax in (False, True):
        root = tmp_path / ("jax" if jax else "port")
        d, h = (_jax_env if jax else _port_env)(root, compact_below_bytes=1 << 20)
        _write_raw(jax, d, h, SIZES)
        _write_raw(jax, d, h, [[10, 20, 30]], base_map=1000)  # a dead attempt
        tracker = (_tracker_with(SIZES, JaxTracker, JaxMapStatus) if jax
                   else _tracker_with(SIZES, MapOutputTracker, MapStatus))
        report = (jax_compact if jax else compact_shuffle)(d, h, 0, tracker=tracker)
        assert (report.groups, report.maps) == (1, 3)
        orphans = d.sweep_orphan_attempts(0, winner_map_ids=[0, 1, 2])
        expired = d.sweep_expired_generations(0, ttl_s=0)
        assert len(orphans) == 3 and len(expired) == 3 * 3 + 1
        readings.append({k: v for k, v in _readings(jax_reg if jax else reg).items()
                         if k[0].startswith(("write_compact", "storage_sweep"))})
    port, jax = readings
    assert port == jax
    assert port[("write_compacted_objects_total",)] == 3
    assert port[("write_compaction_seconds",)] == 1
    sweeps = collections.Counter({k[1][1]: v for k, v in port.items()
                                  if k[0] == "storage_sweep_deleted_total"})
    assert sum(sweeps.values()) == 3 + 3 * 3 + 1
