"""The port's transfer-plane instruments against the JAX package's, on the
CPU, small and deterministic: the instrumented store
(``storage/instrumented.py``: per-op latency, read and write bytes, errors),
the planner's segment, saved-GET, waste and index-prefetch metrics, the
prefetcher's wait histogram and thread gauge, the chunked fetch's counters
and the pipelined upload's queue instruments.

- The instrumented store is stacked over the retry layer exactly when the
  registry is on, in both packages, and it changes no request: the store
  sees the same requests with the registry on and off.
- One shuffle (seeded raw partitions written on one thread, read on one
  prefetch thread; the objects byte-equal between the packages) gives the
  same counter values and histogram counts in both registries.
- Errors count alike; a miss (``FileNotFoundError``) is not an error.
- The upload queue's backpressure is observed once per blocked enqueue and
  its gauge returns to zero.

Hygiene as in ``tests/test_torch_autotune.py``: registries are turned on
only inside fixtures that turn them off and zero them, and ``OBJECT_GETS``
is reset after each test; a module-scoped
autouse fixture asserts the switches, the ``S3SHUFFLE_*`` variables and the
file's threads are as they were.
"""

import os
import threading
import time

import numpy as np
import pytest

from s3shuffle_tpu.block_ids import ShuffleBlockId as JaxBlockId
from s3shuffle_tpu.config import ShuffleConfig as JaxConfig
from s3shuffle_tpu.metadata.helper import ScanIndexMemo as JaxMemo
from s3shuffle_tpu.metadata.helper import ShuffleHelper as JaxHelper
from s3shuffle_tpu import skew as jax_skew
from s3shuffle_tpu.metrics import registry as jax_reg
from s3shuffle_tpu.read.chunked_fetch import ChunkedRangeFetcher as JaxFetcher
from s3shuffle_tpu.read.scan_plan import build_scan_iterator as jax_build_scan
from s3shuffle_tpu.storage import backend as jax_backend
from s3shuffle_tpu.storage.dispatcher import Dispatcher as JaxDispatcher
from s3shuffle_tpu.storage.instrumented import InstrumentedBackend as JaxInstrumented
from s3shuffle_tpu.storage.retrying import RetryingBackend as JaxRetrying
from s3shuffle_tpu.write.map_output_writer import MapOutputWriter as JaxMapOutputWriter
from s3shuffle_tpu.write.pipelined_upload import PipelinedUploadStream as JaxUploadStream
from s3shuffle_tpu_torch import ShuffleConfig
from s3shuffle_tpu_torch.block_ids import ShuffleBlockId
from s3shuffle_tpu_torch.coding.degraded import DegradedReader
from s3shuffle_tpu_torch.metadata.helper import ScanIndexMemo, ShuffleHelper
from s3shuffle_tpu_torch.metrics import names
from s3shuffle_tpu_torch.metrics import registry as reg
from s3shuffle_tpu_torch.read.chunked_fetch import ChunkedRangeFetcher
from s3shuffle_tpu_torch.read.scan_plan import build_scan_iterator
from s3shuffle_tpu_torch.storage import backend as port_backend
from s3shuffle_tpu_torch.skew import OBJECT_GETS
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
from s3shuffle_tpu_torch.storage.fault import FaultRule, FlakyBackend
from s3shuffle_tpu_torch.storage.instrumented import InstrumentedBackend
from s3shuffle_tpu_torch.storage.retrying import RetryingBackend
from s3shuffle_tpu_torch.write.map_output_writer import MapOutputWriter
from s3shuffle_tpu_torch.write.pipelined_upload import PipelinedUploadStream

PROCESS_POOLS = ("s3shuffle-torch-encode", "s3shuffle-torch-decode", "s3shuffle-torch-fetch",
                 "s3shuffle-torch-speculate", "s3shuffle-encode", "s3shuffle-decode",
                 "s3shuffle-fetch", "s3shuffle-speculate", "s3shuffle-tpu-encode",
                 "s3shuffle-tpu-decode")


def _env_vars():
    return {k: v for k, v in os.environ.items() if k.startswith("S3SHUFFLE_")}


@pytest.fixture(scope="module", autouse=True)
def file_hygiene():
    """After this file: both registries' switches and the ``S3SHUFFLE_*``
    variables as before, and no thread this file started still alive but
    the process-wide pools' workers."""
    before = (jax_reg.enabled(), reg.enabled(), _env_vars())
    threads = set(threading.enumerate())
    yield
    assert (jax_reg.enabled(), reg.enabled(), _env_vars()) == before
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
    """Both packages' registries on and zeroed; off and zeroed after."""
    for r in (reg, jax_reg):
        r.REGISTRY.reset_values()
        r.enable()
    yield
    for r in (reg, jax_reg):
        r.disable()
        r.REGISTRY.reset_values()


@pytest.fixture(autouse=True)
def object_gets_reset():
    """No live GET count or peak of a scan here survives its test, in
    either package (the skew plane's process-wide tracker)."""
    yield
    for tracker in (OBJECT_GETS, jax_skew.OBJECT_GETS):
        with tracker._lock:
            tracker._inflight.clear()
        tracker.reset_peaks()


@pytest.fixture(autouse=True)
def fresh_jax_dispatcher():
    JaxDispatcher.reset()
    yield
    JaxDispatcher.reset()


# --- stacking ---------------------------------------------------------------

@pytest.mark.parametrize("retries", [0, 3])
@pytest.mark.parametrize("on", [False, True])
def test_the_instrumented_store_is_stacked_exactly_when_the_registry_is_on(request, on,
                                                                           retries):
    if on:
        request.getfixturevalue("metrics_on")
    port = Dispatcher(ShuffleConfig(root_dir="memory://stack-port", storage_retries=retries))
    jax = JaxDispatcher(JaxConfig(root_dir="memory://stack-jax", storage_retries=retries))
    layers = []
    for disp, instr, retry in ((port, InstrumentedBackend, RetryingBackend),
                               (jax, JaxInstrumented, JaxRetrying)):
        top, stack = disp.backend, []
        while True:
            stack.append("instrumented" if isinstance(top, instr) else
                         "retry" if isinstance(top, retry) else type(top).__name__)
            if "inner" not in vars(top):
                break
            top = top.inner
        layers.append(stack)
    assert layers[0] == layers[1]
    assert (layers[0][0] == "instrumented") == on
    assert ("retry" in layers[0]) == (retries > 0)


def test_attributes_pass_through_the_instrumented_store_both_ways(metrics_on):
    disp = Dispatcher(ShuffleConfig(root_dir="memory://through", storage_retries=0))
    top = disp.backend
    assert isinstance(top, InstrumentedBackend)
    seen = []
    top.open_interceptor = seen.append  # lands on the memory backend
    assert top.inner.open_interceptor is not None
    with top.create("memory://through/a.bin") as f:
        f.write(b"xyz")
    assert top.read_all("memory://through/a.bin") == b"xyz"
    assert seen == ["memory://through/a.bin"]
    assert top._store  # an unknown attribute reads through
    top.open_interceptor = None


# --- one shuffle through both packages ---------------------------------------

MAPS, PARTS = 3, 6


class _Requests:
    """Records the requests that reach the store beneath every wrapper."""

    def __init__(self, inner):
        self._inner = inner
        self.ops = []
        self._lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def create(self, path):
        with self._lock:
            self.ops.append(("create", path.rsplit("/", 1)[-1]))
        return self._inner.create(path)

    def open_ranged(self, path, size_hint=None):
        reader = self._inner.open_ranged(path, size_hint)
        owner, name = self, path.rsplit("/", 1)[-1]

        class _Reader:
            size = reader.size

            def read_fully(self, position, length):
                with owner._lock:
                    owner.ops.append(("read", name, position, length))
                return reader.read_fully(position, length)

            def close(self):
                reader.close()

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                self.close()

        return _Reader()

    def read_all(self, path):
        with self.open_ranged(path) as r:
            return r.read_fully(0, r.size)

    def status(self, path):
        with self._lock:
            self.ops.append(("status", path.rsplit("/", 1)[-1]))
        return self._inner.status(path)


def _record_beneath(disp) -> _Requests:
    """A request recorder beneath every wrapper of the dispatcher's stack."""
    top = disp.backend
    if "inner" not in vars(top):
        disp.backend = _Requests(top)
        return disp.backend
    while "inner" in vars(top.inner):
        top = top.inner
    top.inner = _Requests(top.inner)
    return top.inner


def _shuffle(root, jax, seed, knobs):
    """Seeded raw partitions written on one thread, then one scan of every
    partition on one prefetch thread. Returns (requests, object bytes)."""
    rng = np.random.default_rng(seed)
    if jax:
        cfg = JaxConfig(root_dir=f"file://{root}", max_concurrency_task=1,
                        speculative_read_quantile=0.0, **knobs)
        disp = JaxDispatcher(cfg)
        helper = JaxHelper(disp)
    else:
        cfg = ShuffleConfig(root_dir=f"file://{root}", max_concurrency_task=1, **knobs)
        disp = Dispatcher(cfg)
        helper = ShuffleHelper(disp)
    requests = _record_beneath(disp)
    truth = {}
    for m in range(MAPS):
        w = JaxMapOutputWriter(disp, helper, 0, m, PARTS) if jax else \
            MapOutputWriter(disp, helper, 0, m, PARTS, codec=None, device="cpu")
        for p in range(PARTS):
            data = rng.integers(0, 256, size=int(rng.integers(0, 20000)),
                                dtype=np.uint8).tobytes()
            truth[(m, p)] = data
            pw = w.get_partition_writer(p)
            pw.write(data)
            pw.close()
        w.commit_all_partitions()
    disp.clear_status_cache()
    blocks = [(m, p) for m in range(MAPS) for p in range(PARTS)]
    if jax:
        it = jax_build_scan(disp, JaxMemo(helper), [JaxBlockId(0, m, p) for m, p in blocks],
                            cfg, fetcher=JaxFetcher.from_config(cfg))
    else:
        it = build_scan_iterator(disp, ScanIndexMemo(helper),
                                 [ShuffleBlockId(0, m, p) for m, p in blocks], cfg,
                                 recovery=DegradedReader(disp, "cpu"),
                                 fetcher=ChunkedRangeFetcher.from_config(cfg))
    got = {}
    for s in it:
        got[(s.block.map_id, s.block.reduce_id)] = s.readall()
        s.close()
    assert got == {b: d for b, d in truth.items() if d}
    objects = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                objects[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return requests.ops, objects


#: the transfer plane's instruments this slice ports
COUNTERS = ("storage_read_bytes_total", "storage_write_bytes_total", "storage_errors_total",
            "read_coalesced_segments_total", "read_gets_saved_total",
            "read_coalesce_waste_bytes_total", "read_chunked_prefills_total",
            "read_prefetch_thread_moves_total")
HISTOGRAMS = ("storage_op_seconds", "read_chunk_fetch_seconds", "read_prefetch_wait_seconds",
              "read_index_prefetch_seconds", "write_upload_chunk_seconds",
              "read_prefetch_fill_seconds")
#: counted only when the producer found the upload queue full: a matter of
#: thread timing, so checked with a gated sink below, not compared
TIMING_DEPENDENT = ("write_upload_queue_wait_seconds",)
GAUGES = ("write_upload_queue_bytes", "read_chunk_inflight", "read_prefetch_threads")


def _readings(registry):
    """Counter and gauge values and histogram counts, by series labels."""
    snap = registry.REGISTRY.snapshot(compact=True)
    out = {}
    for name in COUNTERS + HISTOGRAMS + GAUGES:
        for series in snap.get(name, {}).get("series", []):
            labels = tuple(sorted(series.get("labels", {}).items()))
            value = series["count"] if name in HISTOGRAMS else series.get("value")
            out[(name,) + labels] = value
    return out


SETTINGS = {
    "planner-chunked": {"coalesce_gap_bytes": 4096, "fetch_chunk_size": 5000,
                        "fetch_parallelism": 3, "upload_queue_bytes": 8192},
    "per-block-serial": {"coalesce_gap_bytes": 0, "fetch_parallelism": 1,
                         "upload_queue_bytes": 0},
    "defaults": {},
}


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("seed", range(2))
def test_one_shuffle_counts_what_jax_counts(tmp_path, metrics_on, setting, seed):
    knobs = SETTINGS[setting]
    port_ops, port_objects = _shuffle(tmp_path / "port", False, seed, knobs)
    port = _readings(reg)
    jax_ops, jax_objects = _shuffle(tmp_path / "jax", True, seed, knobs)
    jax = _readings(jax_reg)
    assert port_objects == jax_objects
    assert sorted(port_ops) == sorted(jax_ops)
    assert port == jax
    read = sum(op[3] for op in port_ops if op[0] == "read")
    written = sum(len(b) for b in port_objects.values())
    assert port[("storage_read_bytes_total", ("scheme", "file"))] == read
    assert port[("storage_write_bytes_total", ("scheme", "file"))] == written
    if setting == "planner-chunked":
        assert port[("read_chunked_prefills_total",)] > 0
        assert port[("read_coalesced_segments_total",)] > 0
    assert port.get(("write_upload_queue_bytes",), 0) == 0
    assert port.get(("read_chunk_inflight",), 0) == 0


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_the_instrumented_store_changes_no_request(tmp_path, request, setting):
    """The same shuffle with the registry off and on: the same requests
    reach the store, and the same objects."""
    knobs = dict(SETTINGS[setting], coalesce_gap_bytes=0, fetch_parallelism=1)
    off_ops, off_objects = _shuffle(tmp_path / "off", False, 5, knobs)
    request.getfixturevalue("metrics_on")
    on_ops, on_objects = _shuffle(tmp_path / "on", False, 5, knobs)
    assert on_ops == off_ops
    assert on_objects == off_objects
    assert reg.read_counter_total("storage_read_bytes_total") == \
        sum(op[3] for op in on_ops if op[0] == "read")


# --- errors ------------------------------------------------------------------

def _errors(registry):
    snap = registry.REGISTRY.snapshot(compact=True)
    return sorted((tuple(sorted(s["labels"].items())), s["value"])
                  for s in snap.get("storage_errors_total", {}).get("series", []))


def test_errors_count_like_jax_and_a_miss_is_no_error(metrics_on):
    from s3shuffle_tpu.storage.fault import FaultRule as JaxRule
    from s3shuffle_tpu.storage.fault import FlakyBackend as JaxFlaky

    for pkg, instr, flaky, rule, backend in (
        ("port", InstrumentedBackend, FlakyBackend, FaultRule, port_backend),
        ("jax", JaxInstrumented, JaxFlaky, JaxRule, jax_backend),
    ):
        b = instr(flaky(backend.MemoryBackend(), rules=[
            rule("read", times=2, exc=lambda *_: OSError("connection reset")),
            rule("create", times=1, exc=lambda *_: OSError("503 Slow Down"))]))
        root = f"memory://errors-{pkg}/"
        with pytest.raises(OSError):
            b.create(root + "a")
        with b.create(root + "a") as f:
            f.write(b"0123456789")
        r = b.open_ranged(root + "a")
        for _ in range(2):
            with pytest.raises(OSError):
                r.read_fully(0, 4)
        assert r.read_fully(2, 4) == b"2345"
        r.close()
        with pytest.raises(FileNotFoundError):
            b.status(root + "missing")
        assert not b.exists(root + "missing")
    assert _errors(reg) == _errors(jax_reg)
    assert _errors(reg) == [((("op", "create"), ("scheme", "memory")), 1.0),
                            ((("op", "read"), ("scheme", "memory")), 2.0)]
    assert _readings(reg) == _readings(jax_reg)


# --- the upload queue ---------------------------------------------------------

class _GatedSink:
    """A store stream whose writes wait for ``gate``."""

    def __init__(self):
        self.gate = threading.Event()
        self.data = bytearray()

    def write(self, b):
        assert self.gate.wait(timeout=10.0)
        self.data += b
        return len(b)

    def flush(self):
        pass

    def close(self):
        pass


@pytest.mark.parametrize("cls", [PipelinedUploadStream, JaxUploadStream],
                         ids=["port", "jax"])
def test_backpressure_is_observed_once_per_blocked_enqueue(metrics_on, cls):
    registry = reg if cls is PipelinedUploadStream else jax_reg
    sink = _GatedSink()
    stream = cls(sink, 4096, label="gated")
    stream._chunk_bytes = 4096
    stream.write(b"a" * 4096)  # queued: the uploader waits at the gate
    release = threading.Timer(0.2, sink.gate.set)
    release.start()
    stream.write(b"b" * 4096)  # the queue is full until the gate opens
    stream.close()
    release.join()
    assert bytes(sink.data) == b"a" * 4096 + b"b" * 4096
    assert registry.read_histogram("write_upload_queue_wait_seconds").count == 1
    assert registry.read_histogram("write_upload_chunk_seconds").count == 2
    snap = registry.REGISTRY.snapshot(compact=True)
    assert all(s["value"] == 0 for s in
               snap.get("write_upload_queue_bytes", {}).get("series", []))


# --- the names -------------------------------------------------------------

def test_every_transfer_instrument_is_registered_as_the_names_table_says():
    import s3shuffle_tpu_torch.read.chunked_fetch  # noqa: F401
    import s3shuffle_tpu_torch.read.prefetch  # noqa: F401
    import s3shuffle_tpu_torch.read.scan_plan  # noqa: F401
    import s3shuffle_tpu_torch.storage.instrumented  # noqa: F401
    import s3shuffle_tpu_torch.tuning.tuners  # noqa: F401
    import s3shuffle_tpu_torch.write.pipelined_upload  # noqa: F401

    registered = {m.name: (m.kind, m.labelnames) for m in reg.REGISTRY.metrics()}
    for name in COUNTERS + HISTOGRAMS + GAUGES + TIMING_DEPENDENT + (
            "tune_decisions_total", "tune_knob_value", "tune_controller_seconds"):
        assert registered[name] == names.KNOWN_METRICS[name], name
