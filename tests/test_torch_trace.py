"""The port's trace plane (``utils/trace.py``, ``trace/names.py``) against
the JAX package's, on the CPU.

- The tracer's unit cases (causal ids on a per-thread stack, wall-anchored
  timestamps, remote contexts, draining, assembly, the atomic write, the
  flight recorder and its ``atexit`` hook), as ``tests/test_trace_plane.py``
  runs them on the JAX tracer.
- ``assemble`` of the same shards, with fixed ids and times, gives the same
  document in both packages; a port trace file reads through
  ``tools/critical_path.py`` and ``tools/trace_report.py``.
- Spans open ``torch.profiler.record_function`` and close it on every path.
- Span parity: one small TeraSort through both ``ShuffleContext``s, at one
  prefetch thread, records the same multiset of span names (``storage.op``
  by its ``op``) and the same counters, but for the port's own stage,
  task, record and codec spans, which the table holds besides the JAX
  one's names.
- Tracing off is byte- and op-identical to tracing on, and tracing alone
  stacks the instrumented store (the repair of the port's wrap decision).

Every test that turns tracing, the flight recorder or a registry on does so
inside a fixture that turns it off and empties it. Trace paths go under
``tmp_path``. A module fixture checks, when the file ends, both packages'
trace, flight, registry and stats state, the ``S3SHUFFLE_*`` variables, the
file's threads and the working directory.
"""

import collections
import json
import logging
import os
import threading
import time

import numpy as np
import pytest
import torch

from s3shuffle_tpu.config import ShuffleConfig as JaxConfig
from s3shuffle_tpu.manager import ShuffleManager as JaxManager
from s3shuffle_tpu.batch import RecordBatch as JaxRecordBatch
from s3shuffle_tpu.metrics import registry as jax_reg
from s3shuffle_tpu.metrics import stats as jax_stats
from s3shuffle_tpu.ops import tlz as jax_tlz
from s3shuffle_tpu.serializer import ColumnarKVSerializer as JaxColumnarKV
from s3shuffle_tpu.shuffle import ShuffleContext as JaxContext
from s3shuffle_tpu.storage.dispatcher import Dispatcher as JaxDispatcher
from s3shuffle_tpu.trace import names as jax_span_names
from s3shuffle_tpu.utils import trace as jax_trace
from s3shuffle_tpu_torch import ShuffleConfig, ShuffleContext
from s3shuffle_tpu_torch.batch import RecordBatch
from s3shuffle_tpu_torch.dependency import HashPartitioner, ShuffleDependency
from s3shuffle_tpu_torch.manager import ShuffleManager
from s3shuffle_tpu_torch.metrics import registry as reg
from s3shuffle_tpu_torch.metrics import stats
from s3shuffle_tpu_torch.serializer import ColumnarKVSerializer
from s3shuffle_tpu_torch.storage import backend as port_backend
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
from s3shuffle_tpu_torch.storage.fault import FlakyBackend
from s3shuffle_tpu_torch.storage.instrumented import InstrumentedBackend
from s3shuffle_tpu_torch.storage.local import LocalBackend
from s3shuffle_tpu_torch.trace import KNOWN_SPANS
from s3shuffle_tpu_torch.utils import trace
from torch_jax_native import jax_native_library  # noqa: F401  (loads the JAX oracle's native library)
from torch_port_dispatcher import port_dispatcher_reset  # noqa: F401  (resets the port's process dispatcher)

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
    """Both packages' tracers off and empty with the flight ring at its
    default, both registries off and zero, both collectors empty."""
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


def assert_planes_clean():
    for t in TRACERS:
        assert not t.enabled()
        assert t.events_snapshot() == [] and t.counters() == {}
        assert t._flight_enabled and t._flight.maxlen == t.FLIGHT_RING_DEFAULT
        assert len(t._flight) == 0 and t._flight_dir is None and not t._flight_error
        assert t.current_context() is None
    for r in REGISTRIES:
        assert not r.enabled()
        assert r.REGISTRY.snapshot(compact=True) == {}
    for c in COLLECTORS:
        assert c.shuffle_ids() == [] and len(c._outbox) == 0


@pytest.fixture(scope="module", autouse=True)
def file_hygiene():
    """When the file ends: both packages' planes clean (tracing off, no
    buffered event or counter, the flight ring at its default, registries
    off and zero, collectors empty), no ``S3SHUFFLE_*`` variable changed, no
    thread of this file alive but the process-wide pools' workers, and no
    ``s3shuffle_trace.json`` in the working directory."""
    _reset_planes()
    env = _env_vars()
    threads = set(threading.enumerate())
    residue = os.path.exists("s3shuffle_trace.json")
    yield
    assert_planes_clean()
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
def planes():
    """Clean planes in, clean planes out (whatever the test turned on)."""
    _reset_planes()
    yield
    _reset_planes()


@pytest.fixture
def trace_sandbox(tmp_path, planes):
    """The port's tracer on onto a file under ``tmp_path``."""
    path = str(tmp_path / "trace.json")
    trace.enable(path, torch_annotations=False)
    return path


@pytest.fixture
def flight_sandbox(tmp_path, planes):
    return str(tmp_path / "flight")


@pytest.fixture(autouse=True)
def fresh_jax_dispatcher():
    JaxDispatcher.reset()
    yield
    JaxDispatcher.reset()


# --- causal spans and context propagation (test_trace_plane.py:57-129) ---

def test_span_records_ids_and_wall_clock(trace_sandbox):
    before = time.time() * 1e6
    with trace.span("driver.job", app="t"):
        pass
    after = time.time() * 1e6
    (event,) = trace.events_snapshot()
    assert event["ph"] == "X" and event["name"] == "driver.job"
    args = event["args"]
    assert args["app"] == "t" and args["trace_id"] and args["span_id"]
    assert "parent_id" not in args
    assert before - 1e6 <= event["ts"] <= after + 1e6
    assert event["pid"] == os.getpid()
    assert event["tid"] == threading.get_ident() & 0xFFFFFFFF


def test_nested_spans_share_trace_and_chain_parents(trace_sandbox):
    with trace.span("driver.job"):
        with trace.span("driver.map_stage"):
            pass
    stage, job = trace.events_snapshot()  # the inner span completes first
    assert (job["name"], stage["name"]) == ("driver.job", "driver.map_stage")
    assert stage["args"]["trace_id"] == job["args"]["trace_id"]
    assert stage["args"]["parent_id"] == job["args"]["span_id"]


def test_spans_on_other_threads_start_their_own_trees(trace_sandbox):
    def child():
        with trace.span("read.prefetch"):
            pass

    with trace.span("driver.job"):
        t = threading.Thread(target=child)
        t.start()
        t.join()
    prefetch, job = trace.events_snapshot()
    assert prefetch["name"] == "read.prefetch" and "parent_id" not in prefetch["args"]
    assert prefetch["args"]["trace_id"] != job["args"]["trace_id"]


def test_current_context_is_none_outside_any_span(trace_sandbox):
    assert trace.current_context() is None


def test_context_adoption_links_remote_child(trace_sandbox):
    with trace.span("driver.job"):
        ctx = trace.current_context()
    assert set(ctx) == {"trace_id", "parent_id"}
    trace.reset()
    with trace.context(ctx):
        with trace.span("worker.task", task_id="0"):
            pass
    (task,) = trace.events_snapshot()
    assert task["args"]["trace_id"] == ctx["trace_id"]
    assert task["args"]["parent_id"] == ctx["parent_id"]
    assert trace.current_context() is None


@pytest.mark.parametrize("ctx", [None, {}, {"trace_id": "abc"}, "garbage"],
                         ids=["none", "empty", "partial", "garbage"])
def test_context_with_falsy_or_partial_ctx_is_noop(trace_sandbox, ctx):
    with trace.context(ctx):
        with trace.span("worker.task"):
            pass
    (event,) = trace.events_snapshot()
    assert "parent_id" not in event["args"]


def test_drain_spans_pops_the_buffer(trace_sandbox):
    with trace.span("read.prefetch"):
        pass
    assert len(trace.drain_spans()) == 1
    assert trace.drain_spans() == []
    assert trace.events_snapshot() == []


def test_disabled_tracing_records_nothing(trace_sandbox):
    trace.disable()
    with trace.span("driver.job"):
        trace.count("read.tasks")
    assert trace.events_snapshot() == []
    assert trace.counters() == {}
    assert trace.current_context() is None
    assert trace.span("driver.job") is trace._NOOP


def test_counters_accumulate_and_flush_writes_the_chrome_document(trace_sandbox):
    assert trace.flush() is None  # nothing recorded: no file
    trace.count("read.tasks")
    trace.count("read.tasks", 2.0)
    with trace.span("write.commit", map_id=3):
        pass
    assert trace.counters() == {"read.tasks": 3.0}
    assert trace.trace_path() == trace_sandbox
    assert trace.flush() == trace_sandbox
    with open(trace_sandbox) as f:
        doc = json.load(f)
    assert set(doc) == {"traceEvents", "otherData", "displayTimeUnit"}
    assert doc["otherData"] == {"counters": {"read.tasks": 3.0}}
    assert [e["name"] for e in doc["traceEvents"]] == ["write.commit"]
    assert doc["displayTimeUnit"] == "ms"


def test_the_environment_variable_enables_tracing_onto_its_path(tmp_path, planes,
                                                                monkeypatch):
    path = str(tmp_path / "env.json")
    monkeypatch.setenv("S3SHUFFLE_TRACE", path)
    trace._maybe_enable_from_env()
    assert trace.enabled() and trace.trace_path() == path
    assert trace._use_torch_annotations  # the default, as the JAX tracer's
    monkeypatch.delenv("S3SHUFFLE_TRACE")


# --- torch profiler annotations ---

def test_spans_open_a_record_function_that_the_profiler_sees(tmp_path, planes):
    trace.enable(str(tmp_path / "t.json"))  # torch_annotations defaults to on
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("write.commit", map_id=0):
            torch.ones(4).sum()
        with pytest.raises(ValueError):
            with trace.span("read.prefetch"):
                raise ValueError("a failing fill")
        with trace.span("storage.op", op="read"):
            pass
    names = collections.Counter(e.name for e in prof.events())
    assert names["write.commit"] == 1 and names["read.prefetch"] == 1
    assert names["storage.op"] == 1
    assert [e["name"] for e in trace.events_snapshot()] == [
        "write.commit", "read.prefetch", "storage.op"]
    assert trace.current_context() is None


def test_spans_on_worker_threads_reach_a_profiler_that_records_every_thread(tmp_path,
                                                                             planes):
    """The data plane's spans run on task, prefetch and upload threads;
    ``chip_smoke.py`` 13c profiles with every thread recorded."""
    from torch._C._profiler import _ExperimentalConfig

    trace.enable(str(tmp_path / "t.json"), torch_annotations=True)

    def worker():
        with trace.span("read.prefetch", block="b"):
            torch.ones(4).sum()

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                experimental_config=_ExperimentalConfig(
                                    profile_all_threads=True)) as prof:
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    assert "read.prefetch" in {e.name for e in prof.events()}
    (event,) = trace.events_snapshot()
    assert event["tid"] == t.ident & 0xFFFFFFFF


def test_an_annotation_that_cannot_open_is_skipped_not_the_span(tmp_path, planes,
                                                                monkeypatch, caplog):
    def broken(_name):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "record_function", broken)
    trace.enable(str(tmp_path / "t.json"), torch_annotations=True)
    with caplog.at_level(logging.DEBUG, logger="s3shuffle_tpu_torch.trace"):
        with trace.span("write.commit"):
            pass
    assert [e["name"] for e in trace.events_snapshot()] == ["write.commit"]
    assert "annotation unavailable" in caplog.text


def test_annotations_off_never_touch_the_profiler(tmp_path, planes, monkeypatch):
    def broken(_name):
        raise AssertionError("record_function opened with annotations off")

    monkeypatch.setattr(torch.profiler, "record_function", broken)
    trace.enable(str(tmp_path / "t.json"), torch_annotations=False)
    with trace.span("write.commit"):
        pass
    assert len(trace.events_snapshot()) == 1


# --- assembly (test_trace_plane.py:138-179), equal between the packages ---

def _evt(name, span_id, parent_id=None, pid=1, ts=0.0, dur=10.0, trace_id="t1"):
    args = {"trace_id": trace_id, "span_id": span_id}
    if parent_id:
        args["parent_id"] = parent_id
    return {"name": name, "ph": "X", "ts": ts, "dur": dur, "pid": pid, "tid": 7, "args": args}


def test_assemble_emits_flows_only_for_cross_pid_edges():
    root = _evt("driver.job", "a", pid=1)
    local = _evt("driver.map_stage", "b", parent_id="a", pid=1)
    remote = _evt("worker.task", "c", parent_id="a", pid=2)
    doc = trace.assemble([[root, local], [remote]], counters={"read.tasks": 3})
    flows = [e for e in doc["traceEvents"] if e["ph"] in ("s", "f")]
    assert sorted(e["ph"] for e in flows) == ["f", "s"]
    src = next(e for e in flows if e["ph"] == "s")
    fin = next(e for e in flows if e["ph"] == "f")
    assert (src["pid"], fin["pid"], src["id"], fin["id"]) == (1, 2, "a", "a")
    assert doc["otherData"]["counters"] == {"read.tasks": 3}
    assert [e for e in doc["traceEvents"] if e["ph"] == "X"] == [root, local, remote]


def test_assemble_orphan_parent_produces_no_flow():
    doc = trace.assemble([[_evt("worker.task", "c", parent_id="missing", pid=2)]])
    assert [e for e in doc["traceEvents"] if e["ph"] in ("s", "f")] == []


def _shards(seed):
    """Seeded shards over 3 pids with fixed ids and times: local and remote
    edges, a shared parent with several remote children, orphans."""
    rng = np.random.default_rng(seed)
    spans = []
    for i in range(int(rng.integers(5, 30))):
        parent = None
        if spans and rng.random() < 0.8:
            parent = spans[int(rng.integers(0, len(spans)))]["args"]["span_id"]
        elif rng.random() < 0.5:
            parent = "gone"
        spans.append(_evt(str(rng.choice(sorted(KNOWN_SPANS))), f"s{i}", parent,
                          pid=int(rng.integers(1, 4)), ts=float(rng.integers(0, 1000)),
                          dur=float(rng.integers(1, 100))))
    by_pid = collections.defaultdict(list)
    for e in spans:
        by_pid[e["pid"]].append(e)
    counters = {"read.tasks": float(rng.integers(0, 9))}
    return [by_pid[p] for p in sorted(by_pid)], counters


@pytest.mark.parametrize("seed", range(4))
def test_assemble_of_the_same_shards_equals_jax(seed):
    shards, counters = _shards(seed)
    port = trace.assemble(json.loads(json.dumps(shards)), counters=counters)
    jax = jax_trace.assemble(json.loads(json.dumps(shards)), counters=counters)
    assert port == jax
    spans = [e for shard in shards for e in shard]
    pid_of = {e["args"]["span_id"]: e["pid"] for e in spans}
    crossing = [e for e in spans if pid_of.get(e["args"].get("parent_id"), e["pid"]) != e["pid"]]
    assert sum(e["ph"] == "f" for e in port["traceEvents"]) == len(crossing)
    assert sum(e["ph"] == "s" for e in port["traceEvents"]) == len(
        {e["args"]["parent_id"] for e in crossing})


def test_write_trace_doc_is_atomic_and_leaves_no_tmp(tmp_path):
    target = str(tmp_path / "out.json")
    assert trace.write_trace_doc(target, {"traceEvents": []}) == target
    with open(target) as f:
        assert json.load(f) == {"traceEvents": []}
    assert os.listdir(tmp_path) == ["out.json"]


# --- the flight recorder (test_trace_plane.py:182-260) ---

def test_flight_ring_is_bounded_and_dump_is_parseable(flight_sandbox):
    trace.configure_flight(dir=flight_sandbox, ring=4, worker_id="w9")
    for i in range(10):
        trace.flight_record("worker.task", "B", task_id=i)
    path = trace.flight_dump("task_failure")
    assert os.path.basename(path).startswith("flight-w9-")
    assert path.endswith("-task_failure.jsonl")
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    header, records = lines[0], lines[1:]
    assert (header["flight_recorder"], header["reason"], header["worker"]) == (
        1, "task_failure", "w9")
    assert header["pid"] == os.getpid()
    assert header["events"] == len(records) == 4
    assert [r["args"]["task_id"] for r in records] == [6, 7, 8, 9]
    assert not any(n.endswith(".tmp") for n in os.listdir(flight_sandbox))


def test_flight_dump_without_dir_returns_none(flight_sandbox):
    trace.flight_record("worker.task", "B")
    assert trace.flight_dump("drain") is None


def test_flight_ring_zero_disables_recording(flight_sandbox):
    trace.configure_flight(dir=flight_sandbox, ring=0)
    trace.flight_record("worker.task", "B")
    with trace.span("read.prefetch"):
        pass
    trace.configure_flight(ring=8)
    with open(trace.flight_dump("drain")) as f:
        assert json.loads(f.readline())["events"] == 0


def test_completed_spans_enter_the_ring_while_tracing_is_on(trace_sandbox, flight_sandbox):
    trace.configure_flight(dir=flight_sandbox, ring=8)
    with trace.span("write.commit"):
        pass
    trace.disable()
    with trace.span("write.commit"):
        pass
    assert [r["name"] for r in trace._flight] == ["write.commit"]


def test_flight_record_stamps_causal_context(trace_sandbox, flight_sandbox):
    trace.configure_flight(dir=flight_sandbox, ring=16)
    with trace.span("worker.task"):
        trace.flight_record("write.commit", "i")
        ctx = trace.current_context()
    with open(trace.flight_dump("drain")) as f:
        records = [json.loads(line) for line in f][1:]
    commit = next(r for r in records if r["name"] == "write.commit")
    assert commit["args"]["trace_id"] == ctx["trace_id"]
    assert commit["args"]["parent_id"] == ctx["parent_id"]


def test_flight_atexit_hook_dumps_only_after_error(flight_sandbox):
    trace.configure_flight(dir=flight_sandbox, ring=8)
    trace.flight_record("worker.task", "B")
    trace._atexit_hook()
    assert not os.path.exists(flight_sandbox)
    trace.flight_note_error()
    trace._atexit_hook()
    dumps = os.listdir(flight_sandbox)
    assert len(dumps) == 1 and dumps[0].endswith("-atexit_after_error.jsonl")
    trace._atexit_hook()
    assert len(os.listdir(flight_sandbox)) == 1


def test_flight_dump_counts_metric_by_reason(flight_sandbox):
    reg.enable()
    trace.configure_flight(dir=flight_sandbox, ring=8)
    trace.flight_dump("drain")
    series = reg.REGISTRY.snapshot(compact=True)["flight_dumps_total"]["series"]
    assert [(s["labels"], s["value"]) for s in series] == [({"reason": "drain"}, 1.0)]


#: the port's own stage spans (``shuffle.py``'s job stages, the record
#: layer, the codec's batch stages); the JAX table has none of them
PORT_ONLY_SPANS = (
    "codec.crc_host", "codec.decode_emit", "codec.decode_parse", "codec.decode_validate",
    "codec.device_wait", "codec.encode_assembly", "codec.encode_stage", "driver.cleanup",
    "driver.sample", "record.combine", "record.deserialize", "record.expand",
    "record.partition", "record.rank", "record.serialize", "record.sort",
)
#: the map-side combine's row counts, which the JAX package does not keep
PORT_ONLY_COUNTERS = ("combine_rows_in", "combine_rows_out")
#: the spans of ``ShuffleContext``'s stages and tasks, which the JAX
#: package's ``ShuffleContext`` does not open
CONTEXT_SPANS = PORT_ONLY_SPANS + ("driver.map_stage", "driver.reduce_stage", "worker.task")


def test_the_span_table_is_the_jax_one():
    assert KNOWN_SPANS == {**jax_span_names.KNOWN_SPANS,
                           **{name: "span" for name in PORT_ONLY_SPANS},
                           **{name: "counter" for name in PORT_ONLY_COUNTERS}}
    assert not set(PORT_ONLY_SPANS + PORT_ONLY_COUNTERS) & set(jax_span_names.KNOWN_SPANS)
    assert trace.FLIGHT_RING_DEFAULT == jax_trace.FLIGHT_RING_DEFAULT


# --- the flight knobs of the config ---

def test_flight_knobs_have_the_jax_defaults_keys_and_validation():
    port, jax = ShuffleConfig(), JaxConfig()
    assert (port.flight_ring_events, port.flight_dir) == (jax.flight_ring_events,
                                                           jax.flight_dir) == (512, "")
    for cls in (ShuffleConfig, JaxConfig):
        with pytest.raises(ValueError, match="flight_ring_events"):
            cls(flight_ring_events=-1)
    got = ShuffleConfig.from_dict({"flight_ring_events": "64", "flight_dir": "/x"})
    assert (got.flight_ring_events, got.flight_dir) == (64, "/x")
    env = {"S3SHUFFLE_FLIGHT_RING_EVENTS": "0", "S3SHUFFLE_FLIGHT_DIR": "/y"}
    got = ShuffleConfig.from_env(env)
    assert (got.flight_ring_events, got.flight_dir) == (0, "/y")
    assert (got.flight_ring_events, got.flight_dir) == (
        JaxConfig.from_env(env).flight_ring_events, JaxConfig.from_env(env).flight_dir)


def test_log_values_names_the_flight_knobs(caplog):
    with caplog.at_level(logging.INFO, logger="s3shuffle_tpu_torch.config"):
        ShuffleConfig().log_values()
    assert "flight_ring_events=512" in caplog.text and "flight_dir=''" in caplog.text


# --- the instrumented store under tracing (the repair of the wrap) ---

@pytest.mark.parametrize("retries", [0, 3])
def test_tracing_alone_stacks_the_instrumented_store(trace_sandbox, retries):
    disp = Dispatcher(ShuffleConfig(root_dir="memory://traced-stack", storage_retries=retries))
    assert isinstance(disp.backend, InstrumentedBackend)
    assert not reg.enabled()
    with disp.backend.create("memory://traced-stack/a.bin") as f:
        f.write(b"abc")
    assert disp.backend.read_all("memory://traced-stack/a.bin") == b"abc"
    ops = [(e["name"], e["args"]["op"]) for e in trace.events_snapshot()]
    assert ops == [("storage.op", "create"), ("storage.op", "open"), ("storage.op", "read")]
    (read,) = [e for e in trace.events_snapshot() if e["args"]["op"] == "read"]
    assert read["args"]["bytes"] == 3
    assert reg.REGISTRY.snapshot(compact=True) == {}  # spans only: no metric


def test_with_everything_off_no_wrapper_is_stacked(planes):
    raw = LocalBackend()
    assert port_backend._maybe_instrument(raw) is raw


# --- one TeraSort through both packages ---

BS, BATCH, MAPS, PARTS = 2048, 4, 3, 3
BASE = dict(checksum_algorithm="CRC32C", codec_block_size=BS, codec_batch_blocks=BATCH,
            cleanup=False, encode_inflight_batches=1, decode_inflight_batches=1,
            max_concurrency_task=1, speculative_read_quantile=0.0)


@pytest.fixture(autouse=True)
def no_c_encoder(monkeypatch):
    """The JAX side's numpy TLZ host encoder (its C encoder picks other
    valid matches; tests/test_torch_record_slice.py), so the objects, and
    the upload chunks that carry them, are equal."""
    monkeypatch.setattr(jax_tlz, "_encode_block_native", lambda _data: None)


def _terasort_parts(cls, seed=9, n=700):
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (16, 90), dtype=np.uint8)
    out = []
    for _ in range(MAPS):
        keys = rng.integers(0, 256, (n, 10), dtype=np.uint8).reshape(-1)
        vals = pool[rng.integers(0, 16, n)].reshape(-1)
        out.append(cls(np.full(n, 10, np.int32), np.full(n, 90, np.int32), keys, vals))
    return out


def _traced_sort(root, jax, tmp_path, **knobs):
    """TeraSort with tracing on (annotations off) through a fresh context:
    the span-name multiset (storage.op by op), the counters, the rows."""
    tracer = jax_trace if jax else trace
    tracer.reset()
    if jax:
        tracer.enable(str(tmp_path / "jax.json"), jax_annotations=False)
        ctx = JaxContext(manager=JaxManager(JaxConfig(
            root_dir=f"file://{root}", codec="tpu", tpu_host_fallback=False,
            **BASE, **knobs)), num_workers=2)
        parts, ser, cls = _terasort_parts(JaxRecordBatch), JaxColumnarKV(), JaxRecordBatch
    else:
        tracer.enable(str(tmp_path / "port.json"), torch_annotations=False)
        ctx = ShuffleContext(ShuffleConfig(root_dir=f"file://{root}", **BASE, **knobs),
                             num_workers=2, device="cpu")
        parts, ser, cls = _terasort_parts(RecordBatch), ColumnarKVSerializer(), RecordBatch
    try:
        out = ctx.sort_by_key(parts, PARTS, serializer=ser, materialize="batches",
                              cleanup=False)
        events = tracer.events_snapshot()
        counters = tracer.counters()
    finally:
        tracer.disable()
        tracer.reset()
        ctx.stop()
    names = collections.Counter(
        (e["name"], e["args"].get("op")) for e in events)
    rows = [[k + v for k, v in cls.concat(list(p)).iter_records()] for p in out]
    return names, counters, rows, events


@pytest.mark.parametrize("knobs", [{}, {"coalesce_gap_bytes": 0},
                                   {"fetch_chunk_size": 1024, "fetch_parallelism": 2}],
                         ids=["defaults", "per-block", "chunked"])
def test_span_names_of_one_terasort_equal_jax(tmp_path, planes, knobs):
    port, port_counters, port_rows, events = _traced_sort(tmp_path / "port", False, tmp_path,
                                                          **knobs)
    jax, jax_counters, jax_rows, _ = _traced_sort(tmp_path / "jax", True, tmp_path, **knobs)
    assert port_rows == jax_rows
    # the spans of the port's ShuffleContext stages, tasks, record layer and
    # codec stages apart, the same names as many times
    assert {k: n for k, n in port.items() if k[0] not in CONTEXT_SPANS} == jax
    assert port_counters == jax_counters
    for name in ("driver.sample", "driver.map_stage", "driver.reduce_stage"):
        assert port[(name, None)] == 1, name
    assert port[("driver.cleanup", None)] == 0  # cleanup=False
    assert port[("worker.task", None)] == MAPS + PARTS
    for name in ("record.partition", "record.serialize", "record.deserialize", "record.sort",
                 "codec.decode_validate", "codec.crc_host", "codec.device_wait"):
        assert port[(name, None)] > 0, name
    for name in ("read.prefetch", "write.commit", "write.upload_chunk"):
        assert port[(name, None)] > 0, name
    # the planner's bulk index prefetch; the per-block path resolves each
    # index on its prefetch thread
    assert (port[("read.index_prefetch", None)] > 0) == (knobs.get("coalesce_gap_bytes") != 0)
    assert port[("write.commit", None)] == MAPS
    for op in ("create", "open", "read"):
        assert port[("storage.op", op)] > 0, op
    if "fetch_chunk_size" in knobs:
        assert port[("read.chunked_prefill", None)] > 0
    # every parent is a span of the document, or absent
    ids = {e["args"]["span_id"] for e in events}
    assert all(e["args"].get("parent_id", next(iter(ids))) in ids for e in events)
    assert set(n for n, _op in port) <= set(KNOWN_SPANS)


def test_the_read_tasks_counter_counts_record_reads_as_jax_does(tmp_path, planes):
    """``read.tasks`` counts reduce tasks that enter ``read()``: the record
    route. The batch route (``materialize="batches"``) counts none, in both
    packages."""
    counts = {}
    for jax in (False, True):
        tracer = jax_trace if jax else trace
        tracer.reset()
        if jax:
            tracer.enable(str(tmp_path / "j.json"), jax_annotations=False)
            ctx = JaxContext(manager=JaxManager(JaxConfig(
                root_dir=f"file://{tmp_path / 'jr'}", codec="tpu", tpu_host_fallback=False,
                **BASE)), num_workers=2)
            parts, ser = _terasort_parts(JaxRecordBatch, n=200), JaxColumnarKV()
        else:
            tracer.enable(str(tmp_path / "p.json"), torch_annotations=False)
            ctx = ShuffleContext(ShuffleConfig(root_dir=f"file://{tmp_path / 'pr'}", **BASE),
                                 num_workers=2, device="cpu")
            parts, ser = _terasort_parts(RecordBatch, n=200), ColumnarKVSerializer()
        try:
            ctx.sort_by_key(parts, PARTS, serializer=ser, materialize="records")
            counts[jax] = tracer.counters()
        finally:
            tracer.disable()
            tracer.reset()
            ctx.stop()
    assert counts[False] == counts[True] == {"read.tasks": float(PARTS)}


def test_a_port_trace_file_reads_through_the_trace_tools(tmp_path, planes, capsys):
    from tools.critical_path import analyze
    from tools.critical_path import main as critical_main
    from tools.trace_report import render

    _names, _counters, _rows, _events = _traced_sort(tmp_path / "port", False, tmp_path)
    # the sort's spans, written the way flush writes them, under one root span
    trace.enable(str(tmp_path / "doc.json"), torch_annotations=False)
    with trace.span("driver.job"):
        with trace.span("write.commit", map_id=0):
            with trace.span("storage.op", op="write_close"):
                time.sleep(0.002)
        with trace.span("read.prefetch", block="b"):
            with trace.span("storage.op", op="read", bytes=10):
                time.sleep(0.002)
        trace.count("read.tasks")
    path = trace.flush()
    trace.disable()
    with open(path) as f:
        doc = json.load(f)
    digest = analyze(doc)
    assert digest["job_wall_us"] > 0 and digest["coverage"] > 0.5
    blame = {row["bucket"] for row in digest["blame"]}
    assert "get_wait" in blame and "commit" in blame
    assert [e["name"] for e in digest["critical_path"]][0] == "driver.job"
    assert critical_main([path]) == 0
    text = render(doc)
    assert "storage.op" in text and "read.prefetch" in text
    out = capsys.readouterr().out
    assert "driver.job" in out


# --- tracing off: byte- and op-identical (test_trace_plane.py:672-720) ---

class _Recording(FlakyBackend):
    def __init__(self, inner):
        super().__init__(inner)
        self.ops = []

    def _check(self, op, path, nbytes=0):
        self.ops.append((op, path))
        super()._check(op, path, nbytes=nbytes)


def _recorded_roundtrip(tmp_path, tag, trace_on):
    import random

    trace.reset()
    if trace_on:
        trace.enable(str(tmp_path / f"{tag}.json"), torch_annotations=False)
    try:
        cfg = ShuffleConfig(root_dir=f"file://{tmp_path}/{tag}", app_id=tag, codec="zlib",
                            cleanup=False)
        d = Dispatcher(cfg)
        rec = _Recording(LocalBackend())
        d.backend = port_backend._maybe_instrument(rec)  # the production decision
        assert isinstance(d.backend, InstrumentedBackend) == trace_on
        manager = ShuffleManager(dispatcher=d, device="cpu")
        rng = random.Random(31)
        handle = manager.register_shuffle(0, ShuffleDependency(0, HashPartitioner(3)))
        for map_id in range(2):
            w = manager.get_writer(handle, map_id)
            w.write([(rng.randrange(1000), rng.randbytes(40)) for _ in range(800)])
            w.stop(success=True)
        out = [sorted(manager.get_reader(handle, p, p + 1).read()) for p in range(3)]
        spans = len(trace.events_snapshot())
        objects = {}
        for dirpath, _dirs, files in os.walk(tmp_path / tag):
            for fn in files:
                with open(os.path.join(dirpath, fn), "rb") as f:
                    objects[fn] = f.read()
        return out, sorted((op, p.rsplit("/", 1)[-1]) for op, p in rec.ops), objects, spans
    finally:
        trace.disable()
        trace.reset()


def test_tracing_off_is_byte_and_op_identical(tmp_path, planes):
    out_on, ops_on, objects_on, spans_on = _recorded_roundtrip(tmp_path, "on", True)
    out_off, ops_off, objects_off, spans_off = _recorded_roundtrip(tmp_path, "off", False)
    assert out_on == out_off
    assert ops_on == ops_off
    assert objects_on == objects_off
    assert spans_on > 0 and spans_off == 0
