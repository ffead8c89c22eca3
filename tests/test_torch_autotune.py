"""The port's online autotuner against the JAX package's, on the CPU, small
and deterministic:

- the controller core, the scan tuner and the commit tuner take the same
  decisions, ``overrides()`` and ``tuner_state`` as the JAX ones on the same
  seeded sequence of ``observe_scan`` / ``observe_commit`` samples and the
  same registry-signal deltas (``autotune_interval_s=0``; no test sleeps or
  reads a wall clock to decide), and emit the same decision counters;
- a warm-start profile written by either package loads into the other, and
  a missing, torn or stale one is a cold start in both;
- ``autotune=False`` builds no tuner, and it and a tuner pinned to its
  static rungs both give the JAX package's static store request sequence op
  for op (``tests/test_autotune.py:249, 258``);
- tuned values stay inside the clamps, and a plane that is switched off
  stays off (``:286, 323``);
- a bound codec's windows retune mid-stream (``:343``), and the shared
  fetch pool follows a tuned ``fetch_parallelism`` (``:371``).

Hygiene: the registries, the skew plane's ``OBJECT_GETS`` tracker and the
JAX dispatcher singleton are restored in fixture teardowns (which run on
failure too); no test sets the environment; profiles go under
``tmp_path``. A module-scoped autouse
fixture asserts that, after this file, both registries' switches and the
``S3SHUFFLE_*`` variables are as they were and no thread the file started
is alive, but the workers of the packages' process-wide pools.
"""

import dataclasses
import io
import json
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
from s3shuffle_tpu.read.scan_plan import tuned_scan_config as jax_tuned_scan_config
from s3shuffle_tpu.storage.dispatcher import Dispatcher as JaxDispatcher
from s3shuffle_tpu.tuning import controller as jax_controller
from s3shuffle_tpu.tuning import profile as jax_profile
from s3shuffle_tpu.tuning import tuners as jax_tuners
from s3shuffle_tpu.write.map_output_writer import MapOutputWriter as JaxMapOutputWriter
from s3shuffle_tpu_torch import ShuffleConfig, ShuffleContext, ShuffleManager
from s3shuffle_tpu_torch.batch import RecordBatch
from s3shuffle_tpu_torch.block_ids import ShuffleBlockId
from s3shuffle_tpu_torch.codec.cuda import CudaCodec
from s3shuffle_tpu_torch.codec.framing import CodecInputStream, CodecOutputStream
from s3shuffle_tpu_torch.coding.degraded import DegradedReader
from s3shuffle_tpu_torch.metadata.helper import ScanIndexMemo, ShuffleHelper
from s3shuffle_tpu_torch.metrics import registry as reg
from s3shuffle_tpu_torch.read import chunked_fetch, scan_plan
from s3shuffle_tpu_torch.read.chunked_fetch import ChunkedRangeFetcher
from s3shuffle_tpu_torch.serializer import ColumnarKVSerializer
from s3shuffle_tpu_torch.skew import OBJECT_GETS
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
from s3shuffle_tpu_torch.tuning import CommitTuner, Controller, ScanTuner, profile
from s3shuffle_tpu_torch.tuning import tuners as port_tuners
from s3shuffle_tpu_torch.write.map_output_writer import MapOutputWriter
from torch_port_dispatcher import port_dispatcher_reset  # noqa: F401  (resets the port's process dispatcher)

MiB = 1 << 20
#: thread-name prefixes of the two packages' process-wide pools (the
#: encode thread, the decode pool, the ranged-GET and speculation pools):
#: they live for the process by design
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
    """The JAX dispatcher's process singleton, cleared around each test."""
    JaxDispatcher.reset()
    yield
    JaxDispatcher.reset()


def _configs(**knobs):
    return (ShuffleConfig(root_dir="memory://autotune-port", **knobs),
            JaxConfig(root_dir="memory://autotune-jax", **knobs))


# --- the controller core ----------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_controller_decisions_equal_jax(seed):
    """Seeded ladders, rings, hysteresis and cooldowns on a fake clock: the
    same rung after every sample, the same decisions, moves and state."""
    rng = np.random.default_rng(seed)
    ladder = sorted({int(v) for v in rng.integers(1, 4096, size=int(rng.integers(2, 9)))})
    kw = dict(initial=int(rng.choice(ladder)), ring_size=int(rng.integers(1, 5)),
              hysteresis=float(rng.choice([0.0, 0.05, 0.2])),
              cooldown_s=float(rng.choice([0.0, 2.0])))
    now = [0.0]
    port = Controller(ladder, time_fn=lambda: now[0], **kw)
    jax = jax_controller.Controller(ladder, time_fn=lambda: now[0], **kw)
    for cost in rng.exponential(1.0, size=300):
        now[0] += float(rng.uniform(0.0, 1.5))
        assert port.add_measurement_and_predict(float(cost)) == \
            jax.add_measurement_and_predict(float(cost))
    assert (port.decisions, port.moves, port.lo, port.hi) == \
        (jax.decisions, jax.moves, jax.lo, jax.hi)
    assert port.export_state() == jax.export_state()


def test_controller_replays_the_predictor_drift_semantics_like_jax():
    """``tests/test_autotune.py``'s drift walk, through both cores."""
    cores = [Controller(range(1, 4), initial=2, ring_size=20),
             jax_controller.Controller(range(1, 4), initial=2, ring_size=20)]

    def ring(c, cost):
        v = c.current
        for _ in range(20):
            v = c.observe(cost)
        return v

    for c in cores:
        walk = [ring(c, cost) for cost in (100, 200, 300, 50, 10_000, 10_000, 10_000, 10_000)]
        assert walk == [3, 2, 1, 1, 2, 3, 2, 1]


@pytest.mark.parametrize("stale", [False, True])
def test_controller_state_round_trips_across_packages(stale):
    """A state exported by one core restores into the other; rungs no longer
    on the ladder are dropped alike."""
    src = jax_controller.Controller([1, 2, 4, 8], initial=2, ring_size=1)
    for cost in (3.0, 1.0, 2.0, 0.5):
        src.observe(cost)
    state = json.loads(json.dumps(src.export_state()))
    ladder = [2, 4, 16] if stale else [1, 2, 4, 8]
    port = Controller(ladder, initial=ladder[0], ring_size=1)
    jax = jax_controller.Controller(ladder, initial=ladder[0], ring_size=1)
    port.restore_state(state)
    jax.restore_state(state)
    assert port.export_state() == jax.export_state()
    assert port.current == jax.current


# --- the tuners against the JAX ones ----------------------------------------

#: configurations whose ladders the tuners must build alike: the defaults,
#: planes switched off, composites and skew knobs on, statics outside clamps
TUNER_CONFIGS = {
    "defaults": {},
    "planes-off": {"fetch_parallelism": 1, "coalesce_gap_bytes": 0, "upload_queue_bytes": 0,
                   "encode_inflight_batches": 1, "decode_inflight_batches": 1,
                   "decode_batch_frames": 1, "columnar": 0},
    "composite-skew": {"composite_commit_maps": 16, "combine_threshold_bytes": 4 * MiB,
                       "split_threshold_bytes": 8 * MiB, "hot_read_fanout": 6},
    "outside-clamps": {"fetch_parallelism": 40, "fetch_chunk_size": 512 * 1024,
                       "coalesce_gap_bytes": 16 * MiB, "max_buffer_size_task": 4 * MiB,
                       "upload_queue_bytes": 1 * MiB, "decode_batch_frames": 300,
                       "columnar_batch_rows": 1000},
}


def _ladders(tuner):
    return {k.field: list(k.controller.ladder) for k in tuner._knobs}


@pytest.mark.parametrize("name", sorted(TUNER_CONFIGS))
def test_tuner_ladders_and_start_rungs_equal_jax(name):
    port_cfg, jax_cfg = _configs(autotune=True, **TUNER_CONFIGS[name])
    for port_cls, jax_cls in ((ScanTuner, jax_tuners.ScanTuner),
                              (CommitTuner, jax_tuners.CommitTuner)):
        port, jax = port_cls(port_cfg), jax_cls(jax_cfg)
        assert _ladders(port) == _ladders(jax)
        assert port.overrides() == jax.overrides()
        # a tuned run starts at the operator's configuration
        assert all(v == getattr(port_cfg, f) for f, v in port.overrides().items())
    assert port_tuners.ScanTuner.CLAMPS == jax_tuners.ScanTuner.CLAMPS
    assert port_tuners.CommitTuner.CLAMPS == jax_tuners.CommitTuner.CLAMPS
    assert (ScanTuner.RING_SIZE, ScanTuner.HYSTERESIS) == (2, 0.05)


def _feed_read_signals(registry, rng_values):
    waste, read_bytes, waits = rng_values
    registry.REGISTRY.counter("read_coalesce_waste_bytes_total").inc(waste)
    registry.REGISTRY.counter("storage_read_bytes_total", labelnames=("scheme",)) \
        .labels(scheme="file").inc(read_bytes)
    hist = registry.REGISTRY.histogram("read_prefetch_wait_seconds")
    for w in waits:
        hist.observe(w)


def _decision_series(registry):
    snap = registry.REGISTRY.snapshot(compact=True)
    return {name: snap.get(name) for name in ("tune_decisions_total", "tune_knob_value")}


@pytest.mark.parametrize("registry_on", [True, False])
@pytest.mark.parametrize("name", ["defaults", "composite-skew"])
@pytest.mark.parametrize("seed", range(3))
def test_scan_tuner_decides_like_jax(request, seed, name, registry_on):
    """The same scans and the same registry deltas (waste, read bytes,
    prefetch waits) between them: the same rung after every scan, and the
    same decision counters and knob gauges."""
    if registry_on:
        request.getfixturevalue("metrics_on")
    rng = np.random.default_rng(100 + seed)
    port_cfg, jax_cfg = _configs(autotune=True, autotune_interval_s=0.0, **TUNER_CONFIGS[name])
    port, jax = ScanTuner(port_cfg), jax_tuners.ScanTuner(jax_cfg)
    for _ in range(60):
        signals = (float(rng.integers(0, 1 << 20)), float(rng.integers(1, 1 << 24)),
                   [float(w) for w in rng.exponential(0.01, size=int(rng.integers(0, 4)))])
        if registry_on:
            _feed_read_signals(reg, signals)
            _feed_read_signals(jax_reg, signals)
        wall, nbytes = float(rng.uniform(0.0, 2.0)), int(rng.integers(1, 1 << 26))
        port.observe_scan(wall, nbytes)
        jax.observe_scan(wall, nbytes)
        assert port.overrides() == jax.overrides()
    assert port_tuners.tuner_state(port) == jax_tuners.tuner_state(jax)
    assert port.tuned(port_cfg).fetch_chunk_size == jax.tuned(jax_cfg).fetch_chunk_size
    assert port.export_profile() == jax.export_profile()
    assert _decision_series(reg) == _decision_series(jax_reg)
    if registry_on:
        assert reg.read_counter_total("tune_decisions_total") > 0
        assert reg.read_histogram("tune_controller_seconds").count == 60


@pytest.mark.parametrize("registry_on", [True, False])
@pytest.mark.parametrize("name", ["defaults", "composite-skew"])
@pytest.mark.parametrize("seed", range(3))
def test_commit_tuner_decides_like_jax(request, seed, name, registry_on):
    """The same commits and upload-queue backpressure between them: the same
    rungs, consults and decision counters."""
    if registry_on:
        request.getfixturevalue("metrics_on")
    rng = np.random.default_rng(200 + seed)
    port_cfg, jax_cfg = _configs(autotune=True, autotune_interval_s=0.0, **TUNER_CONFIGS[name])
    port, jax = CommitTuner(port_cfg), jax_tuners.CommitTuner(jax_cfg)
    for _ in range(60):
        if registry_on:
            for w in rng.exponential(0.02, size=int(rng.integers(0, 3))):
                for r in (reg, jax_reg):
                    r.REGISTRY.histogram("write_upload_queue_wait_seconds").observe(float(w))
        wall, nbytes = float(rng.uniform(0.0, 1.0)), int(rng.integers(1, 1 << 27))
        port.observe_commit(wall, nbytes)
        jax.observe_commit(wall, nbytes)
        assert port.overrides() == jax.overrides()
        cfg = port_cfg
        for tuner in (port, jax):
            assert tuner.upload_queue_bytes(0) == 0
        assert port.upload_queue_bytes(cfg.upload_queue_bytes) == \
            jax.upload_queue_bytes(cfg.upload_queue_bytes)
        assert port.columnar_batch_rows(cfg.columnar_batch_rows) == \
            jax.columnar_batch_rows(cfg.columnar_batch_rows)
        assert port.seal_thresholds(cfg.composite_commit_maps, cfg.composite_flush_bytes) == \
            jax.seal_thresholds(cfg.composite_commit_maps, cfg.composite_flush_bytes)
        for consult in ("combine_threshold_bytes", "split_threshold_bytes"):
            static = getattr(cfg, consult)
            assert getattr(port, consult)(static) == getattr(jax, consult)(static)
    assert port_tuners.tuner_state(port) == jax_tuners.tuner_state(jax)
    assert port.export_profile() == jax.export_profile()
    assert _decision_series(reg) == _decision_series(jax_reg)


def test_tuner_state_is_empty_without_a_tuner():
    assert port_tuners.tuner_state(None) == jax_tuners.tuner_state(None) == {}


# --- clamps and off switches --------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_tuned_values_stay_inside_the_clamps_like_jax(metrics_on, seed):
    """Adversarial costs: every rung on its ladder, whose ends are the clamps
    (the prefetch budget's ceiling is the operator's value), in both
    packages alike."""
    rng = np.random.default_rng(300 + seed)
    port_cfg, jax_cfg = _configs(autotune=True, autotune_interval_s=0.0,
                                 composite_commit_maps=8, split_threshold_bytes=2 * MiB)
    tuners = [(ScanTuner(port_cfg), jax_tuners.ScanTuner(jax_cfg), "observe_scan"),
              (CommitTuner(port_cfg), jax_tuners.CommitTuner(jax_cfg), "observe_commit")]
    for port, jax, observe in tuners:
        for _ in range(200):
            wall, nbytes = float(rng.uniform(0.0, 2.0)), int(rng.integers(1, 1 << 24))
            getattr(port, observe)(wall, nbytes)
            getattr(jax, observe)(wall, nbytes)
        assert port.overrides() == jax.overrides()
        for knob in port._knobs:
            lo, hi = type(port).CLAMPS[knob.field]
            if knob.field == "max_buffer_size_task":
                hi = port_cfg.max_buffer_size_task
            assert (knob.controller.lo, knob.controller.hi) == (lo, hi), knob.field
            assert lo <= knob.controller.current <= hi, knob.field
    assert reg.read_counter_total("tune_decisions_total") == \
        jax_reg.read_counter_total("tune_decisions_total") > 0


#: each plane's off switch, and the knob that must then stay off the ladder
OFF_SWITCHES = [
    ("fetch_parallelism", {"fetch_parallelism": 1}, ("fetch_parallelism", "fetch_chunk_size")),
    ("coalesce_gap_bytes", {"coalesce_gap_bytes": 0}, ("coalesce_gap_bytes",)),
    ("decode_batch_frames", {"decode_batch_frames": 1}, ("decode_batch_frames",)),
    ("decode_inflight_batches", {"decode_inflight_batches": 1}, ("decode_inflight_batches",)),
    ("hot_read_fanout", {"hot_read_fanout": 0}, ("hot_read_fanout",)),
    ("upload_queue_bytes", {"upload_queue_bytes": 0}, ("upload_queue_bytes",)),
    ("composite_commit_maps", {"composite_commit_maps": 1},
     ("composite_commit_maps", "composite_flush_bytes")),
    ("encode_inflight_batches", {"encode_inflight_batches": 1}, ("encode_inflight_batches",)),
    ("columnar", {"columnar": 0}, ("columnar_batch_rows",)),
    ("combine_threshold_bytes", {"combine_threshold_bytes": 0}, ("combine_threshold_bytes",)),
    ("split_threshold_bytes", {"split_threshold_bytes": 0}, ("split_threshold_bytes",)),
]


@pytest.mark.parametrize("switch,knobs,fields", OFF_SWITCHES, ids=[s[0] for s in OFF_SWITCHES])
def test_a_switched_off_plane_stays_off(switch, knobs, fields):
    """A plane the operator switched off is on no ladder, however the costs
    go, and its consult returns the static value, as in the JAX package."""
    port_cfg, jax_cfg = _configs(autotune=True, autotune_interval_s=0.0, **knobs)
    scan, commit = ScanTuner(port_cfg), CommitTuner(port_cfg)
    jax_scan, jax_commit = jax_tuners.ScanTuner(jax_cfg), jax_tuners.CommitTuner(jax_cfg)
    for i in range(80):
        for tuner in (scan, jax_scan):
            tuner.observe_scan(0.001 * (i % 7), 1 << 20)
        for tuner in (commit, jax_commit):
            tuner.observe_commit(0.001 * (i % 5), 1 << 20)
    for field in fields:
        for tuner in (scan, commit, jax_scan, jax_commit):
            assert field not in tuner.overrides(), (switch, field)
    for field in fields:
        assert getattr(scan.tuned(port_cfg), field) == getattr(port_cfg, field)
    assert commit.upload_queue_bytes(0) == 0
    assert commit.seal_thresholds(1, 123) == (1, 123)
    assert commit.seal_thresholds(0, 456) == (0, 456)
    assert commit.columnar_batch_rows(1) == 1
    assert commit.combine_threshold_bytes(0) == commit.split_threshold_bytes(0) == 0


def test_the_budget_is_only_tuned_down(metrics_on):
    """``max_buffer_size_task`` is a memory cap: its ladder ends at the
    operator's value, in both packages."""
    port_cfg, jax_cfg = _configs(autotune=True, max_buffer_size_task=48 * MiB)
    port, jax = ScanTuner(port_cfg), jax_tuners.ScanTuner(jax_cfg)
    assert _ladders(port)["max_buffer_size_task"] == _ladders(jax)["max_buffer_size_task"]
    assert max(_ladders(port)["max_buffer_size_task"]) == 48 * MiB


# --- warm-start profiles ---------------------------------------------------

def _trained(pkg, seed):
    """A scan and a commit tuner of ``pkg`` after a seeded sequence."""
    rng = np.random.default_rng(400 + seed)
    if pkg == "port":
        cfg = ShuffleConfig(root_dir="memory://p", autotune=True, autotune_interval_s=0.0)
        scan, commit = ScanTuner(cfg), CommitTuner(cfg)
    else:
        cfg = JaxConfig(root_dir="memory://p", autotune=True, autotune_interval_s=0.0)
        scan, commit = jax_tuners.ScanTuner(cfg), jax_tuners.CommitTuner(cfg)
    for _ in range(40):
        scan.observe_scan(float(rng.uniform(0, 1)), int(rng.integers(1, 1 << 24)))
        commit.observe_commit(float(rng.uniform(0, 1)), int(rng.integers(1, 1 << 24)))
    return scan, commit


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_profile_either_package_wrote_loads_into_the_other(tmp_path, writer, seed):
    scan, commit = _trained(writer, seed)
    path = str(tmp_path / "profile.json")
    save = profile.save_profile if writer == "port" else jax_profile.save_profile
    assert save(path, scan, commit)
    fresh = {"port": (ScanTuner, CommitTuner, profile.load_into),
             "jax": (jax_tuners.ScanTuner, jax_tuners.CommitTuner, jax_profile.load_into)}
    for pkg, (scan_cls, commit_cls, load_into) in fresh.items():
        cfg_cls = ShuffleConfig if pkg == "port" else JaxConfig
        cfg = cfg_cls(root_dir="memory://p", autotune=True, autotune_interval_s=0.0)
        s, c = scan_cls(cfg), commit_cls(cfg)
        assert load_into(path, s, c)
        assert s.overrides() == scan.overrides() and c.overrides() == commit.overrides()
        assert s.export_profile() == scan.export_profile()
        assert c.export_profile() == commit.export_profile()


@pytest.mark.parametrize("seed", range(2))
def test_both_packages_write_the_same_profile_document(tmp_path, seed):
    paths = {}
    for pkg, save in (("port", profile.save_profile), ("jax", jax_profile.save_profile)):
        paths[pkg] = str(tmp_path / f"{pkg}.json")
        assert save(paths[pkg], *_trained(pkg, seed))
    with open(paths["port"]) as a, open(paths["jax"]) as b:
        assert a.read() == b.read()
    assert sorted(os.listdir(tmp_path)) == ["jax.json", "port.json"]  # no temp file left


BAD_PROFILES = {
    "missing": None,
    "torn": '{"version": 1, "tuners": {"scan": {"fetch_',
    "wrong-version": json.dumps({"version": 2, "tuners": {}}),
    "not-a-dict": json.dumps([1, 2]),
    "stale-rungs": json.dumps({"version": 1, "tuners": {
        "scan": {"fetch_chunk_size": {"value": 3, "totals": {"3": 1.0, "x": "y"}},
                 "no_such_knob": {"value": 1}},
        "commit": {"upload_queue_bytes": "not-a-state"}}}),
}


@pytest.mark.parametrize("case", sorted(BAD_PROFILES))
def test_a_missing_torn_or_stale_profile_is_a_cold_start_in_both(tmp_path, case):
    path = tmp_path / "profile.json"
    if BAD_PROFILES[case] is not None:
        path.write_text(BAD_PROFILES[case])
    results = []
    for cfg_cls, scan_cls, commit_cls, mod in (
        (ShuffleConfig, ScanTuner, CommitTuner, profile),
        (JaxConfig, jax_tuners.ScanTuner, jax_tuners.CommitTuner, jax_profile),
    ):
        cfg = cfg_cls(root_dir="memory://p", autotune=True)
        s, c = scan_cls(cfg), commit_cls(cfg)
        loaded = mod.load_into(str(path), s, c)
        results.append((loaded, s.overrides(), c.overrides(), s.export_profile()))
        assert s.overrides()["fetch_chunk_size"] == cfg.fetch_chunk_size
    assert results[0] == results[1]
    assert results[0][0] == (case == "stale-rungs")


def test_a_failed_profile_write_logs_and_returns_false(tmp_path, caplog):
    scan, commit = _trained("port", 0)
    path = str(tmp_path / "no-such-dir" / "profile.json")
    assert profile.save_profile(path, scan, commit) is False
    assert jax_profile.save_profile(path, *_trained("jax", 0)) is False
    assert any("profile dump" in r.getMessage() for r in caplog.records)


def test_the_dispatcher_warm_starts_and_the_manager_saves_at_stop(tmp_path):
    """``ShuffleManager.stop`` writes the profile; a new dispatcher on the
    same path starts from it, and so does a JAX dispatcher."""
    path = str(tmp_path / "profile.json")
    knobs = dict(autotune=True, autotune_interval_s=0.0, autotune_profile_path=path)
    cfg = ShuffleConfig(root_dir=f"file://{tmp_path}/a", **knobs)
    manager = ShuffleManager(cfg, device="cpu")
    disp = manager.dispatcher
    for i in range(12):
        disp.scan_tuner.observe_scan(0.01 * (i % 3 + 1), 1 << 20)
        disp.commit_tuner.observe_commit(0.02 * (i % 2 + 1), 1 << 20)
    learned = (disp.scan_tuner.overrides(), disp.commit_tuner.overrides())
    assert learned != (ScanTuner(cfg).overrides(), CommitTuner(cfg).overrides())
    manager.stop()
    assert os.path.exists(path)
    again = Dispatcher(ShuffleConfig(root_dir=f"file://{tmp_path}/b", **knobs))
    assert (again.scan_tuner.overrides(), again.commit_tuner.overrides()) == learned
    jax = JaxDispatcher(JaxConfig(root_dir=f"file://{tmp_path}/c", **knobs))
    assert (jax.scan_tuner.overrides(), jax.commit_tuner.overrides()) == learned
    # no profile is written without a path, nor without autotune
    Dispatcher(ShuffleConfig(root_dir=f"file://{tmp_path}/d", autotune=True)).save_tuner_profile()
    Dispatcher(ShuffleConfig(root_dir=f"file://{tmp_path}/e",
                             autotune_profile_path=str(tmp_path / "x.json"))).save_tuner_profile()
    assert os.listdir(tmp_path) == ["profile.json"]  # nor any temporary file


# --- autotune=False and a pinned tuner: the static request pattern ----------

class _Ops:
    """Records every store request of either package's backend: creates,
    opens, positioned reads, status calls and listings, by object name."""

    def __init__(self, inner):
        self._inner = inner
        self.ops = []
        self._lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _note(self, *op):
        with self._lock:
            self.ops.append(op)

    def create(self, path):
        self._note("create", path.rsplit("/", 1)[-1])
        return self._inner.create(path)

    def open_ranged(self, path, size_hint=None):
        name = path.rsplit("/", 1)[-1]
        self._note("open", name)
        return _OpsReader(self, name, self._inner.open_ranged(path, size_hint))

    def read_all(self, path):
        with self.open_ranged(path) as r:
            return r.read_fully(0, r.size)

    def status(self, path):
        self._note("status", path.rsplit("/", 1)[-1])
        return self._inner.status(path)

    def list_prefix(self, prefix):
        self._note("list", prefix.rsplit("/", 1)[-1])
        return self._inner.list_prefix(prefix)


class _OpsReader:
    def __init__(self, owner, name, inner):
        self._owner, self._name, self._inner = owner, name, inner

    @property
    def size(self):
        return self._inner.size

    def read_fully(self, position, length):
        self._owner._note("read", self._name, position, length)
        return self._inner.read_fully(position, length)

    def close(self):
        self._inner.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _pin(disp):
    """Every controller of the dispatcher's tuners pinned to its start rung."""
    for tuner in (disp.scan_tuner, disp.commit_tuner):
        for knob in tuner._knobs:
            knob.controller.ladder = [knob.controller.current]
            knob.controller._i = 0


MAPS, PARTS = 3, 5


def _write_and_scan(root, jax, knobs, pin=False):
    """Write MAPS maps of seeded raw partitions on one thread, then one scan
    of every other partition on one prefetch thread; every store request
    recorded. Returns (ops, bytes read)."""
    rng = np.random.default_rng(7)
    cfg_cls, disp_cls, helper_cls, writer_cls = (
        (JaxConfig, JaxDispatcher, JaxHelper, JaxMapOutputWriter) if jax
        else (ShuffleConfig, Dispatcher, ShuffleHelper, MapOutputWriter))
    cfg = cfg_cls(root_dir=f"file://{root}", max_concurrency_task=1, fetch_chunk_size=3000,
                  **({"speculative_read_quantile": 0.0} if jax else {}), **knobs)
    disp = disp_cls(cfg)
    if pin:
        _pin(disp)
    ops = _Ops(disp.backend)
    disp.backend = ops
    helper = helper_cls(disp)
    truth = {}
    for m in range(MAPS):
        w = writer_cls(disp, helper, 0, m, PARTS) if jax else \
            MapOutputWriter(disp, helper, 0, m, PARTS, codec=None, device="cpu")
        for p in range(PARTS):
            data = rng.integers(0, 256, size=int(rng.integers(0, 9000)), dtype=np.uint8).tobytes()
            truth[(m, p)] = data
            pw = w.get_partition_writer(p)
            pw.write(data)
            pw.close()
        w.commit_all_partitions()
    disp.clear_status_cache()
    blocks = [(m, p) for m in range(MAPS) for p in range(0, PARTS, 2)]
    if jax:
        run_cfg = jax_tuned_scan_config(disp, cfg)
        it = jax_build_scan(disp, JaxMemo(helper), [JaxBlockId(0, m, p) for m, p in blocks],
                            run_cfg, fetcher=JaxFetcher.from_config(run_cfg),
                            tuner_consulted=True)
    else:
        run_cfg = scan_plan.tuned_scan_config(disp, cfg)
        it = scan_plan.build_scan_iterator(
            disp, ScanIndexMemo(helper), [ShuffleBlockId(0, m, p) for m, p in blocks],
            run_cfg, DegradedReader(disp, "cpu"),
            fetcher=ChunkedRangeFetcher.from_config(run_cfg), tuner_consulted=True)
    got = {}
    for s in it:
        got[(s.block.map_id, s.block.reduce_id)] = s.readall()
        s.close()
    assert got == {b: truth[b] for b in blocks}
    return disp, ops.ops


def _gets_sorted(ops):
    return sorted(op for op in ops if op[0] != "create")


@pytest.mark.parametrize("gap", [0, 1 << 20])
@pytest.mark.parametrize("mode", ["off", "pinned"])
def test_the_static_request_sequence_equals_jax(tmp_path, mode, gap):
    """``autotune=False`` (no tuner at all) and a tuner pinned to its static
    rungs both issue the JAX package's static request sequence: the writes'
    creates op for op, and the scan's requests op for op on the serial
    per-block path (``coalesce_gap_bytes=0``, one GET at a time), as the
    same multiset with the planner and chunked prefills (the bulk index
    prefetch and a prefill's sub-reads run in parallel in both packages)."""
    knobs = {"coalesce_gap_bytes": gap, "fetch_parallelism": 1 if gap == 0 else 2}
    port, port_ops = _write_and_scan(tmp_path / "port", False,
                                     dict(knobs, autotune=mode == "pinned"),
                                     pin=mode == "pinned")
    _jax, jax_ops = _write_and_scan(tmp_path / "jax", True, knobs)
    if mode == "off":
        assert port.scan_tuner is None and port.commit_tuner is None
        assert scan_plan.tuned_scan_config(port, port.config) is port.config
    else:
        # the pinned tuner was consulted and fed: the wired path, no bypass
        assert sum(len(k.controller._ring) + len(k.controller._totals)
                   for k in port.commit_tuner._knobs) > 0
    creates = [op for op in port_ops if op[0] == "create"]
    assert creates == [op for op in jax_ops if op[0] == "create"]
    if gap == 0:
        assert [op for op in port_ops if op[0] != "create"] == \
            [op for op in jax_ops if op[0] != "create"]
    else:
        assert _gets_sorted(port_ops) == _gets_sorted(jax_ops)


def test_autotune_off_builds_no_tuner_and_the_consults_read_the_static_knobs(tmp_path):
    cfg = ShuffleConfig(root_dir=f"file://{tmp_path}")
    disp = Dispatcher(cfg)
    assert disp.scan_tuner is None and disp.commit_tuner is None
    assert scan_plan.tuned_scan_config(disp, cfg) is cfg
    manager = ShuffleManager(cfg, dispatcher=disp, device="cpu")
    assert manager.codec.encode_inflight_batches == cfg.encode_inflight_batches
    manager.stop()
    tuned = Dispatcher(dataclasses.replace(cfg, autotune=True))
    assert isinstance(tuned.scan_tuner, ScanTuner) and isinstance(tuned.commit_tuner, CommitTuner)
    # the consult is the tuner's current rungs, and a config without the
    # switch is never retuned by a dispatcher's tuner
    assert scan_plan.tuned_scan_config(tuned, tuned.config) == tuned.config
    assert scan_plan.tuned_scan_config(tuned, cfg) is cfg


# --- the codec windows, retuned mid-stream -----------------------------------

BS, BATCH = 2048, 4


def _payload(seed, n):
    rng = np.random.default_rng(seed)
    pool = [rng.integers(0, 256, size=48, dtype=np.uint8).tobytes() for _ in range(8)]
    out = bytearray()
    while len(out) < n:
        out += pool[int(rng.integers(0, 8))] if rng.random() < 0.6 else \
            rng.integers(0, 256, size=64, dtype=np.uint8).tobytes()
    return bytes(out[:n])


def _thread_tally(monkeypatch):
    seen = []
    encode, decode = CodecOutputStream._encode_batch, CodecInputStream._decode_frames

    def tally(kind, rows):
        name = threading.current_thread().name
        seen.append((kind, name.startswith(f"s3shuffle-torch-{kind}"), rows))

    def encode_batch(self, *args):
        tally("encode", None)
        return encode(self, *args)

    def decode_frames(self, frames):
        tally("decode", len(frames))
        return decode(self, frames)

    monkeypatch.setattr(CodecOutputStream, "_encode_batch", encode_batch)
    monkeypatch.setattr(CodecInputStream, "_decode_frames", decode_frames)
    return seen


def test_a_retuned_encode_window_applies_mid_stream(monkeypatch):
    """The commit tuner moves a bound codec's encode window while a stream is
    open: batches before the move encode on the encode thread, after it on
    the caller's; the stored bytes equal the synchronous stream's."""
    seen = _thread_tally(monkeypatch)
    cfg = ShuffleConfig(root_dir="memory://win", autotune=True, upload_queue_bytes=0,
                        columnar=0)
    tuner = CommitTuner(cfg)
    assert [k.field for k in tuner._knobs] == ["encode_inflight_batches"]
    codec = CudaCodec(block_size=BS, batch_blocks=BATCH, device="cpu", encode_inflight_batches=2)
    tuner.bind_codec(codec)
    data = _payload(1, BS * BATCH * 4)
    half = len(data) // 2
    out = io.BytesIO()
    stream = CodecOutputStream(codec, out, close_sink=False)
    stream.write(data[:half])
    tuner.restore_profile({"encode_inflight_batches": {"value": 1}})
    assert codec.encode_inflight_batches == 1
    stream.write(data[half:])
    stream.close()
    sync = io.BytesIO()
    ref = CodecOutputStream(CudaCodec(block_size=BS, batch_blocks=BATCH, device="cpu"), sync,
                            close_sink=False)
    ref.write(data)
    ref.close()
    assert out.getvalue() == sync.getvalue()
    on_thread = [pool for kind, pool, _ in seen if kind == "encode"]
    assert on_thread[0] is True and on_thread[-1] is False


def test_retuned_decode_windows_apply_mid_stream(monkeypatch):
    """The scan tuner moves a bound codec's decode run length and window
    while a stream is open: later runs take the new frame count on the
    caller's thread, and the bytes are the input's."""
    cfg = ShuffleConfig(root_dir="memory://win", autotune=True, fetch_parallelism=1,
                        coalesce_gap_bytes=0, decode_batch_frames=8)
    tuner = ScanTuner(cfg)
    codec = CudaCodec(block_size=BS, batch_blocks=BATCH, device="cpu")
    tuner.bind_codec(codec)
    assert (codec.decode_batch_frames, codec.decode_inflight_batches) == (8, 2)
    data = _payload(2, BS * 40)
    out = io.BytesIO()
    w = CodecOutputStream(codec, out, close_sink=False)
    w.write(data)
    w.close()
    seen = _thread_tally(monkeypatch)
    r = CodecInputStream(codec, io.BytesIO(out.getvalue()))
    first = r.read(BS * 10)
    tuner.restore_profile({"decode_batch_frames": {"value": 4},
                           "decode_inflight_batches": {"value": 1}})
    assert (codec.decode_batch_frames, codec.decode_inflight_batches) == (4, 1)
    rest = r.read()
    r.close()
    assert first + rest == data
    runs = [(pool, rows) for kind, pool, rows in seen if kind == "decode"]
    assert runs[0] == (True, 8)
    assert runs[-1][0] is False and all(rows <= 4 for pool, rows in runs if not pool)


def test_bind_codec_skips_what_has_no_window():
    cfg = ShuffleConfig(root_dir="memory://win", autotune=True)
    CommitTuner(cfg).bind_codec(object())
    ScanTuner(cfg).bind_codec(None)
    jax_tuners.CommitTuner(JaxConfig(root_dir="memory://win", autotune=True)).bind_codec(object())


# --- the wired loop -----------------------------------------------------------

def _terasort_parts(seed, maps=4, rows=3000):
    """TeraSort-shaped batches: 10-byte random keys, 22-byte values from a
    small pool."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (16, 22), dtype=np.uint8)
    return [RecordBatch.from_fixed(rows, 10, 22,
                                   rng.integers(0, 256, rows * 10, dtype=np.uint8),
                                   pool[rng.integers(0, 16, rows)].reshape(-1))
            for _ in range(maps)]


def _sorted_rows(out):
    return sorted(rec for part in out for b in part for rec in b.iter_records())


def test_a_tuned_context_sorts_like_a_static_one_and_the_loop_fires(tmp_path, metrics_on,
                                                                    monkeypatch):
    """Three sorts through one context with autotune on and the registry on:
    each output equals the static run's, both tuners decided, every rung
    stayed in its clamps, and ``stop`` wrote the profile."""
    parts = _terasort_parts(3)
    knobs = dict(codec_block_size=BS, codec_batch_blocks=BATCH, checksum_algorithm="CRC32C")
    static = ShuffleContext(ShuffleConfig(root_dir=f"file://{tmp_path}/s", **knobs),
                            num_workers=2, device="cpu")
    want = _sorted_rows(static.sort_by_key(parts, 3, serializer=ColumnarKVSerializer(),
                                           materialize="batches"))
    static.stop()
    path = str(tmp_path / "profile.json")
    ctx = ShuffleContext(ShuffleConfig(root_dir=f"file://{tmp_path}/t", autotune=True,
                                       autotune_interval_s=0.0, autotune_profile_path=path,
                                       **knobs), num_workers=2, device="cpu")
    disp = ctx.manager.dispatcher
    consults = []
    real_tuned = ScanTuner.tuned

    def tuned(self, c):
        consults.append(1)
        return real_tuned(self, c)

    monkeypatch.setattr(ScanTuner, "tuned", tuned)
    for _ in range(3):
        out = ctx.sort_by_key(parts, 3, serializer=ColumnarKVSerializer(),
                              materialize="batches")
        assert _sorted_rows(out) == want
    # one consult per reduce task's scan (3 sorts x 3 partitions)
    assert len(consults) == 9
    assert sum(k.controller.decisions for k in disp.scan_tuner._knobs) > 0
    assert sum(k.controller.decisions for k in disp.commit_tuner._knobs) > 0
    for tuner in (disp.scan_tuner, disp.commit_tuner):
        for knob in tuner._knobs:
            lo, hi = type(tuner).CLAMPS[knob.field]
            assert min(lo, knob.controller.ladder[0]) <= knob.controller.current <= \
                max(hi, knob.controller.ladder[-1])
    assert reg.read_counter_total("tune_decisions_total") > 0
    assert reg.read_histogram("tune_controller_seconds").count > 0
    state = (disp.scan_tuner.overrides(), disp.commit_tuner.overrides())
    ctx.stop()
    warm = Dispatcher(ShuffleConfig(root_dir=f"file://{tmp_path}/w", autotune=True,
                                    autotune_interval_s=0.0, autotune_profile_path=path,
                                    **knobs))
    assert (warm.scan_tuner.overrides(), warm.commit_tuner.overrides()) == state


class _Samples:
    def __init__(self):
        self.samples = []

    def observe_scan(self, wall, nbytes):
        self.samples.append(nbytes)


class _Inner:
    def __init__(self, items, fail=False):
        self._items, self._fail = iter(items), fail
        self.stats = {"bytes": 123}
        self.budget = "budget"
        self.closed = False

    def __next__(self):
        try:
            return next(self._items)
        except StopIteration:
            if self._fail:
                raise OSError("scan failed")
            raise

    def close(self):
        self.closed = True


@pytest.mark.parametrize("end", ["clean", "failed", "closed"])
def test_a_scan_feeds_one_sample_at_clean_exhaustion_only(end):
    sink = _Samples()
    it = scan_plan._ObservedScanIterator(_Inner([1, 2], fail=end == "failed"), sink)
    assert (it.stats, it.budget) == ({"bytes": 123}, "budget")
    assert next(it) == 1
    if end == "closed":
        it.close()
        assert it._inner.closed and sink.samples == []
        return
    assert next(it) == 2
    with pytest.raises(StopIteration if end == "clean" else OSError):
        next(it)
    with pytest.raises(StopIteration if end == "clean" else OSError):
        next(it)
    assert sink.samples == ([123] if end == "clean" else [])


def test_the_fetcher_takes_the_tuned_rungs_and_the_fetch_pool_grows_to_them(tmp_path):
    """A consult before the fetcher is built: the fetcher's chunk size and
    width are the tuned rungs, the bytes are the written ones, and the
    shared ranged-GET pool grows to the tuned width."""
    cfg = ShuffleConfig(root_dir=f"file://{tmp_path}", autotune=True, autotune_interval_s=0.0,
                        fetch_chunk_size=4096, fetch_parallelism=2, max_concurrency_task=1)
    disp = Dispatcher(cfg)
    disp.scan_tuner.restore_profile({"fetch_parallelism": {"value": 8},
                                     "fetch_chunk_size": {"value": 1 * MiB}})
    helper = ShuffleHelper(disp)
    data = _payload(5, 3 * MiB)
    w = MapOutputWriter(disp, helper, 0, 0, 1, codec=None, device="cpu")
    pw = w.get_partition_writer(0)
    pw.write(data)
    pw.close()
    w.commit_all_partitions()
    run_cfg = scan_plan.tuned_scan_config(disp, cfg)
    fetcher = ChunkedRangeFetcher.from_config(run_cfg)
    assert (fetcher.parallelism, fetcher.chunk_size) == (8, 1 * MiB)
    it = scan_plan.build_scan_iterator(disp, ScanIndexMemo(helper), [ShuffleBlockId(0, 0, 0)],
                                       run_cfg, DegradedReader(disp, "cpu"), fetcher=fetcher,
                                       tuner_consulted=True)
    got = b""
    for s in it:
        got += s.readall()
        s.close()
    assert got == data
    assert chunked_fetch._POOL.width >= 8
