"""The port's multi-GPU plane on the CPU: ``ShuffleContext.mesh_shuffle``,
the device dispatcher (``parallel/dispatch.py``) and the batch executors it
places (``ops/tlz.py`` encode/decode, ``coding/gf.py`` K4 striping),
against the JAX package where it has a counterpart.

The port's lanes are the CPU repeated (``dispatch.local_devices`` patched
to ``[cpu] * 8``), the seam that lets one GPU host emulated lanes; the JAX
side runs on the eight host devices ``tests/conftest.py`` forces. Results
must be exact:

- the JAX ``test_mesh_matches_host_across_shapes`` grid through both
  packages' ``mesh_shuffle``;
- ``mesh_devices`` 0 and 1 op for op (and byte for byte) against the plain
  map-task pattern, and ``mesh_devices=4`` with one real device the same;
- armed encode, decode and K4 striping byte-identical to disarmed (and to
  the JAX package's outputs);
- a ``device="cpu"`` call never placed on CUDA lanes.

Left out, on purpose: the JAX rate-gate tests
(``test_mesh_plane.py:305-366``; the port has no measured-rate gate, by
rule) and the race-witness test (``:283``; the witnesses are a later slice
of the port). A thread stress test of the dispatcher's counters stands in
for the latter.
"""

import random
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from s3shuffle_tpu.batch import RecordBatch as JaxRecordBatch
from s3shuffle_tpu.coding import gf as jax_gf
from s3shuffle_tpu.config import ShuffleConfig as JaxConfig
from s3shuffle_tpu.ops import tlz as jax_tlz
from s3shuffle_tpu.parallel import dispatch as jax_dispatch
from s3shuffle_tpu.shuffle import ShuffleContext as JaxContext
from s3shuffle_tpu.storage.dispatcher import Dispatcher as JaxDispatcher
from s3shuffle_tpu_torch import ShuffleConfig, ShuffleContext, ShuffleManager
from s3shuffle_tpu_torch.batch import RecordBatch
from s3shuffle_tpu_torch.coding import gf
from s3shuffle_tpu_torch.dependency import HashPartitioner, ShuffleDependency
from s3shuffle_tpu_torch.metrics import registry as reg
from s3shuffle_tpu_torch.ops import tlz, tlz_cuda
from s3shuffle_tpu_torch.ops.checksum import POLY_CRC32C
from s3shuffle_tpu_torch.parallel import dispatch
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
from s3shuffle_tpu_torch.storage.fault import FlakyBackend
from s3shuffle_tpu_torch.storage.local import LocalBackend
from torch_jax_native import jax_native_library  # noqa: F401  (loads the JAX oracle's native library)
from torch_port_dispatcher import port_dispatcher_reset  # noqa: F401  (resets the port's process dispatcher)

CPU = torch.device("cpu")
BS = 2048
BATCH = 4


@pytest.fixture(autouse=True)
def _mesh_reset(monkeypatch):
    monkeypatch.delenv("S3SHUFFLE_MESH_DEVICES", raising=False)
    dispatch.reset_for_testing()
    jax_dispatch.reset_for_testing()
    yield
    dispatch.reset_for_testing()
    jax_dispatch.reset_for_testing()


@pytest.fixture
def cpu_lanes(monkeypatch):
    """Eight local "devices" of every type, all the CPU."""
    monkeypatch.setattr(dispatch, "local_devices", lambda device_type="cuda": [CPU] * 8)


@pytest.fixture
def metrics_on():
    reg.REGISTRY.reset_values()
    reg.enable()
    yield reg.REGISTRY
    reg.disable()
    reg.REGISTRY.reset_values()


def _fixed_batch(cls, rng, n, kb=8, vb=16):
    keys = rng.integers(0, 256, size=n * kb, dtype=np.uint8)
    vals = rng.integers(0, 256, size=n * vb, dtype=np.uint8)
    return cls.from_fixed(n, kb, vb, keys, vals)


def _port_ctx(tmp_path, tag, **knobs):
    cfg = ShuffleConfig(root_dir=f"file://{tmp_path}/{tag}", app_id=tag, codec_block_size=BS,
                        codec_batch_blocks=BATCH, **knobs)
    return ShuffleContext(cfg, device="cpu")


def _series_total(registry, name) -> float:
    return sum(s["value"] for s in registry.snapshot().get(name, {}).get("series", []))


# --- mesh vs store path, against the JAX package (the JAX grid) ---

@pytest.mark.parametrize(
    "width,n_parts,sizes",
    [
        (2, 3, (50, 17)),
        (4, 8, (100, 37, 250, 0, 64)),
        (5, 7, (33, 1, 0, 90)),
        (8, 16, (40,) * 8),
        (8, 2, (301,)),
    ],
)
def test_mesh_matches_host_across_shapes(tmp_path, cpu_lanes, width, n_parts, sizes):
    """The mesh route delivers record-identical partitions to the store
    path for every (width x partitions x batch sizes), in the port and in
    the JAX package; the armed dispatcher places the TLZ batches on the
    lanes meanwhile."""
    seed = width * 1000 + n_parts
    batches = [_fixed_batch(RecordBatch, np.random.default_rng(seed), n) for n in sizes]
    jax_batches = [_fixed_batch(JaxRecordBatch, np.random.default_rng(seed), n) for n in sizes]

    with _port_ctx(tmp_path, f"mesh{width}", mesh_devices=width) as ctx:
        mesh_parts, used_mesh = ctx.mesh_shuffle(batches, n_parts)
    assert used_mesh, "uniform widths at width >= 2 must ride the mesh"
    with _port_ctx(tmp_path, "host") as ctx:
        host_parts, used_host = ctx.mesh_shuffle(batches, n_parts)
    assert not used_host
    JaxDispatcher.reset()
    jax_cfg = JaxConfig(root_dir=f"file://{tmp_path}/jax", app_id="jax", mesh_devices=width)
    with JaxContext(jax_cfg) as jctx:
        jax_parts, jax_used = jctx.mesh_shuffle(jax_batches, n_parts)
    assert jax_used

    assert len(mesh_parts) == len(host_parts) == n_parts
    for p in range(n_parts):
        assert sorted(mesh_parts[p]) == sorted(host_parts[p]) == sorted(jax_parts[p]), p
    assert sum(len(p) for p in mesh_parts) == sum(sizes)


def test_mesh_route_rows_metric_counts_real_rows(tmp_path, cpu_lanes, metrics_on):
    rng = np.random.default_rng(3)
    batches = [_fixed_batch(RecordBatch, rng, n) for n in (64, 21)]
    with _port_ctx(tmp_path, "routed", mesh_devices=4) as ctx:
        _, used = ctx.mesh_shuffle(batches, 4)
    assert used
    assert _series_total(metrics_on, "mesh_route_rows_total") == 85


def test_ragged_input_falls_back_to_host_path(tmp_path, cpu_lanes):
    prng = random.Random(5)
    ragged = [
        RecordBatch.from_records([(prng.randbytes(prng.randint(2, 12)), prng.randbytes(6))
                                  for _ in range(80)]),
        RecordBatch.from_records([(b"solo-key", b"v")]),
    ]
    expected = sorted(kv for b in ragged for kv in b.iter_records())
    with _port_ctx(tmp_path, "ragged", mesh_devices=8) as ctx:
        parts, used_mesh = ctx.mesh_shuffle(ragged, 3)
    assert used_mesh is False
    assert sorted(kv for p in parts for kv in p) == expected


def test_mesh_shuffle_needs_partitions():
    ctx = ShuffleContext(manager=object())
    with pytest.raises(ValueError, match="need num_output_partitions or partitioner"):
        ctx.mesh_shuffle([RecordBatch.empty()])


# --- mesh_devices 0 and 1: op for op ---

class RecordingBackend(FlakyBackend):
    """Records every (op, path) the store sees (the port's FlakyBackend
    hook, as ``tests/conftest.py``'s JAX one)."""

    def __init__(self, inner):
        super().__init__(inner)
        self.ops = []

    def _check(self, op, path, nbytes=0):
        self.ops.append((op, path))
        super()._check(op, path, nbytes=nbytes)


def _recorded_run(tmp_path, tag, drive, **knobs):
    """``drive(manager)`` over a RecordingBackend: its output, the op
    multiset (basenames) and every blob written."""
    Dispatcher.reset()
    cfg = ShuffleConfig(root_dir=f"file://{tmp_path}/{tag}", app_id=tag, cleanup=False,
                        codec_block_size=BS, codec_batch_blocks=BATCH, storage_retries=0,
                        **knobs)
    d = Dispatcher(cfg)
    rec = RecordingBackend(LocalBackend())
    d.backend = rec
    manager = ShuffleManager(dispatcher=d, device="cpu")
    try:
        out = drive(manager)
    finally:
        manager.stop()
    ops = sorted((op, p.rsplit("/", 1)[-1]) for op, p in rec.ops)
    blobs = {}
    for op, p in rec.ops:
        if op in ("write", "create"):
            blobs[p.rsplit("/", 1)[-1]] = rec.read_all(p)
    return out, ops, blobs


OP_BATCH_SIZES = (120, 45, 0, 77)
OP_PARTS = 5


def _op_batches():
    rng = np.random.default_rng(11)
    return [_fixed_batch(RecordBatch, rng, n) for n in OP_BATCH_SIZES]


def _via_mesh_entry(manager):
    ctx = ShuffleContext(manager=manager)
    parts, used_mesh = ctx.mesh_shuffle(_op_batches(), OP_PARTS, cleanup=False)
    assert used_mesh is False
    return parts


def _via_plain_pattern(manager):
    dep = ShuffleDependency(shuffle_id=0, partitioner=HashPartitioner(OP_PARTS))
    handle = manager.register_shuffle(0, dep)
    for map_id, b in enumerate(_op_batches()):
        w = manager.get_writer(handle, map_id)
        w.write(b)
        w.stop(success=True)
    return [list(manager.get_reader(handle, p, p + 1).read()) for p in range(OP_PARTS)]


@pytest.mark.parametrize("width", [0, 1])
def test_mesh_devices_zero_and_one_are_op_for_op(tmp_path, cpu_lanes, width):
    """With the plane disarmed the entry point issues exactly the plain
    map-task pattern: the same store-op multiset and byte-identical
    blobs."""
    out_a, ops_a, blobs_a = _recorded_run(tmp_path, f"mesh{width}", _via_mesh_entry,
                                          mesh_devices=width)
    out_b, ops_b, blobs_b = _recorded_run(tmp_path, f"plain{width}", _via_plain_pattern)
    assert [sorted(p) for p in out_a] == [sorted(p) for p in out_b]
    assert ops_a == ops_b
    assert blobs_a == blobs_b


def test_one_real_device_keeps_the_store_path(tmp_path):
    """``mesh_devices=4`` on a host with one device of the manager's type
    (here the one CPU, unpatched) is the one-card case: no mesh, and the
    store ops of ``mesh_devices=0``."""
    assert dispatch.local_devices("cpu") == [CPU]
    out_a, ops_a, blobs_a = _recorded_run(tmp_path, "four", _via_mesh_entry, mesh_devices=4)
    assert dispatch.get_dispatcher("cpu") is None
    out_b, ops_b, blobs_b = _recorded_run(tmp_path, "zero", _via_mesh_entry)
    assert [sorted(p) for p in out_a] == [sorted(p) for p in out_b]
    assert ops_a == ops_b and blobs_a == blobs_b


# --- the dispatcher ---

def test_dispatcher_least_outstanding_placement():
    disp = dispatch.DeviceDispatcher(["cpu"] * 4)
    assert disp.n_devices == 4 and disp.max_inflight() == 4
    assert disp.device_type == "cpu" and disp.stream(0) is None
    # an idle dispatcher walks the lanes round-robin (ties -> lowest index)
    assert [disp.acquire() for _ in range(4)] == [0, 1, 2, 3]
    assert disp.outstanding_snapshot() == [1, 1, 1, 1]
    disp.release(2)
    assert disp.acquire() == 2  # the unique least-loaded lane
    assert disp.acquire() == 0  # then the tie goes to the lowest index
    disp.release(0)
    for i in range(4):
        disp.release(i)
    assert disp.outstanding_snapshot() == [0] * 4


def test_dispatcher_labels_stay_unique_when_a_device_repeats():
    assert [dispatch.DeviceDispatcher(["cpu"] * 3).label(i) for i in range(3)] == [
        "cpu/0", "cpu/1", "cpu/2"]
    mixed = dispatch.DeviceDispatcher(["cuda:0", "cuda:1", "cuda:0"])
    assert [mixed.label(i) for i in range(3)] == ["cuda:0/0", "cuda:1", "cuda:0/1"]
    assert mixed.device_type == "cuda"
    with pytest.raises(ValueError, match="mix device types"):
        dispatch.DeviceDispatcher(["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="at least one device"):
        dispatch.DeviceDispatcher([])


def test_dispatcher_counts_and_gauges_by_lane(metrics_on):
    disp = dispatch.DeviceDispatcher(["cpu"] * 2)
    a, b = disp.acquire(), disp.acquire()
    disp.observe_wait(0.25)
    snap = metrics_on.snapshot()
    dispatched = {s["labels"]["device"]: s["value"]
                  for s in snap["mesh_batches_dispatched_total"]["series"]}
    assert dispatched == {"cpu/0": 1, "cpu/1": 1}
    disp.release(a)
    disp.release(b)
    gauges = {s["labels"]["device"]: s["value"]
              for s in metrics_on.snapshot()["mesh_device_outstanding"]["series"]}
    assert gauges == {"cpu/0": 0, "cpu/1": 0}
    (wait,) = snap["mesh_dispatch_wait_seconds"]["series"]
    assert wait["count"] == 1 and wait["sum"] == 0.25


def test_dispatcher_counters_survive_a_thread_storm():
    """More threads than cores acquiring and releasing with a short switch
    interval: every slot comes back (a lost update would leave a count)."""
    disp = dispatch.DeviceDispatcher(["cpu"] * 3)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def storm():
            for _ in range(300):
                disp.release(disp.acquire())

        threads = [threading.Thread(target=storm) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert disp.outstanding_snapshot() == [0, 0, 0]


# --- arming ---

def test_get_dispatcher_disarmed_and_armed(cpu_lanes):
    assert dispatch.get_dispatcher("cpu") is None  # width 0
    dispatch.configure(1)
    assert dispatch.get_dispatcher("cpu") is None  # width 1: op for op
    dispatch.configure(3)
    disp = dispatch.get_dispatcher("cpu")
    assert disp is not None and disp.n_devices == 3
    assert dispatch.get_dispatcher("cpu") is disp  # cached
    dispatch.configure(12)
    assert dispatch.get_dispatcher("cpu").n_devices == 8  # clamps to the devices
    dispatch.configure(0)
    assert dispatch.get_dispatcher("cpu") is None  # re-disarm drops it


def test_get_dispatcher_is_off_with_fewer_than_two_devices():
    dispatch.configure(4)
    assert dispatch.local_devices("cpu") == [CPU]
    assert dispatch.get_dispatcher("cpu") is None
    assert dispatch.get_dispatcher("cuda") is None  # no CUDA device here


def test_enumeration_errors_raise(monkeypatch):
    """The JAX plane turns a failed enumeration into "plane off"; the port
    raises, so a broken device is never hidden."""
    def broken(device_type="cuda"):
        raise RuntimeError("driver gone")

    with pytest.raises(ValueError, match="unsupported device type"):
        dispatch.local_devices("tpu")
    monkeypatch.setattr(dispatch, "local_devices", broken)
    dispatch.configure(2)
    with pytest.raises(RuntimeError, match="driver gone"):
        dispatch.get_dispatcher("cuda")


def test_env_override_wins_over_config(monkeypatch, cpu_lanes):
    dispatch.configure(0)
    monkeypatch.setenv("S3SHUFFLE_MESH_DEVICES", "2")
    assert dispatch.requested_devices() == jax_dispatch.requested_devices() == 2
    disp = dispatch.get_dispatcher("cpu")
    assert disp is not None and disp.n_devices == 2
    monkeypatch.setenv("S3SHUFFLE_MESH_DEVICES", "bogus")
    assert dispatch.requested_devices() == jax_dispatch.requested_devices() == 0


def test_manager_arms_dispatcher_from_config(tmp_path, cpu_lanes):
    manager = ShuffleManager(ShuffleConfig(root_dir=f"file://{tmp_path}", app_id="arm",
                                           mesh_devices=6), device="cpu")
    try:
        assert dispatch.requested_devices() == 6
        disp = dispatch.get_dispatcher("cpu")
        assert disp is not None and disp.n_devices == 6
    finally:
        manager.stop()


def test_config_knob_matches_jax(monkeypatch):
    for cls in (ShuffleConfig, JaxConfig):
        with pytest.raises(ValueError, match="^mesh_devices must be >= 0$"):
            cls(mesh_devices=-1)
        assert cls().mesh_devices == 0
        assert cls.from_dict({"mesh_devices": "3"}).mesh_devices == 3
    monkeypatch.setenv("S3SHUFFLE_MESH_DEVICES", "5")
    assert ShuffleConfig.from_env().mesh_devices == JaxConfig.from_env().mesh_devices == 5


# --- the executors under the dispatcher ---

def _encode_input(blocks=13):
    rng = np.random.default_rng(8)
    data = np.where(
        rng.random((blocks, BS)) < 0.5,
        rng.integers(0, 256, (blocks, BS)),
        np.tile(rng.integers(0, 256, (1, tlz.GROUP)), (blocks, BS // tlz.GROUP)),
    ).astype(np.uint8)
    return data


def _encode_decode(buf, blocks):
    payloads, crcs = tlz.encode_batch_device(buf, blocks, BS, batch_blocks=BATCH,
                                             poly=POLY_CRC32C, device="cpu")
    decoded, dcrcs = tlz.decode_batch_device(payloads, [BS] * blocks, BS, batch_rows=BATCH,
                                             poly=POLY_CRC32C, device="cpu")
    return payloads, [tuple(c.tolist()) for c in crcs], [bytes(b) for b in decoded], dcrcs


def test_encode_decode_bytes_identical_armed_vs_disarmed(cpu_lanes, metrics_on):
    data = _encode_input()
    blocks = data.shape[0]
    ref = _encode_decode(data.tobytes(), blocks)
    dispatch.configure(8)
    disp = dispatch.get_dispatcher("cpu")
    assert disp is not None and disp.n_devices == 8
    armed = _encode_decode(data.tobytes(), blocks)
    assert armed == ref
    assert ref[2] == [data[i].tobytes() for i in range(blocks)]
    assert disp.outstanding_snapshot() == [0] * 8
    # 4 encode + 4 decode launches of 4, 4, 4, 1 rows: the lanes round-robin
    assert _series_total(metrics_on, "mesh_batches_dispatched_total") == 8
    # and the JAX device encoder's payloads are the same bytes
    jax_payloads, _ = jax_tlz.encode_batch_device(data.tobytes(), blocks, BS, batch_blocks=BATCH)
    assert armed[0] == jax_payloads


def test_armed_encode_and_decode_are_safe_from_threads(cpu_lanes):
    """Four threads encode and decode through one armed dispatcher; each
    gets its disarmed bytes and every slot comes back."""
    data = _encode_input(9)
    ref = _encode_decode(data.tobytes(), 9)
    dispatch.configure(3)
    results, errors = [], []

    def work():
        try:
            results.append(_encode_decode(data.tobytes(), 9))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert results == [ref] * 4
    assert dispatch.get_dispatcher("cpu").outstanding_snapshot() == [0, 0, 0]


def test_an_error_releases_every_slot(cpu_lanes, monkeypatch):
    data = _encode_input()
    payloads = _encode_decode(data.tobytes(), data.shape[0])[0]
    dispatch.configure(4)
    disp = dispatch.get_dispatcher("cpu")
    real = tlz_cuda.decode_fused
    calls = []

    def flaky(*args):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("launch failed")
        return real(*args)

    monkeypatch.setattr(tlz_cuda, "decode_fused", flaky)
    with pytest.raises(RuntimeError, match="launch failed"):
        tlz.decode_batch_device(payloads, [BS] * len(payloads), BS, batch_rows=BATCH,
                                device="cpu")
    assert disp.outstanding_snapshot() == [0] * 4


def test_blocks_helpers_equal_jax():
    """``encode_blocks_device`` (full blocks on the device, the short tail
    on the host) and ``decode_blocks_device`` against the JAX helpers."""
    data = _encode_input(5).tobytes()
    blocks = [data[i * BS:(i + 1) * BS] for i in range(4)] + [data[4 * BS:4 * BS + 999], b""]
    got = tlz.encode_blocks_device(blocks, BS, device="cpu", batch_blocks=BATCH)
    assert got == jax_tlz.encode_blocks_device(blocks, BS)
    assert tlz.encode_buffer_device(data, 5, BS, device="cpu") == \
        jax_tlz.encode_buffer_device(data, 5, BS)
    ulens = [len(b) for b in blocks]
    assert tlz.decode_blocks_device(got, ulens, BS, device="cpu") == blocks


# --- K4 striping ---

@pytest.mark.parametrize("groups,lanes", [(5, 3), (2, 4), (1, 2), (8, 8)])
def test_k4_striped_equals_unstriped_and_jax(cpu_lanes, groups, lanes):
    rng = np.random.default_rng(groups * 10 + lanes)
    coefs = gf.parity_coefficients(2, 2)
    chunks = rng.integers(0, 256, (groups, 2, 64), dtype=np.uint8)
    plain = gf.encode_groups(chunks, coefs, "cpu")
    dispatch.configure(lanes)
    disp = dispatch.get_dispatcher("cpu")
    striped = gf.encode_groups(chunks, coefs, "cpu")
    assert (striped == plain).all()
    assert disp.outstanding_snapshot() == [0] * lanes
    jax_disp = jax_dispatch.DeviceDispatcher(jax.devices()[:lanes])
    assert (jax_gf._encode_striped(chunks, coefs, jax_disp) == striped).all()


def test_k4_stripes_over_every_lane(cpu_lanes, metrics_on):
    dispatch.configure(3)
    chunks = np.random.default_rng(1).integers(0, 256, (7, 2, 32), dtype=np.uint8)
    gf.encode_groups(chunks, gf.parity_coefficients(2, 2), "cpu")
    dispatched = {s["labels"]["device"]: s["value"]
                  for s in metrics_on.snapshot()["mesh_batches_dispatched_total"]["series"]}
    assert dispatched == {"cpu/0": 1, "cpu/1": 1, "cpu/2": 1}


# --- placement keeps the device type ---

def test_a_cpu_call_stays_unplaced_under_cuda_lanes(monkeypatch, metrics_on):
    monkeypatch.setattr(dispatch, "local_devices",
                        lambda device_type="cuda": [torch.device("cuda", 0)] * 4)
    dispatch.configure(4)
    cuda_disp = dispatch.get_dispatcher("cuda")
    assert cuda_disp is not None and cuda_disp.device_type == "cuda"
    assert dispatch.get_dispatcher("cpu") is None
    data = _encode_input(6)
    payloads, _crcs, decoded, _d = _encode_decode(data.tobytes(), 6)
    assert decoded == [data[i].tobytes() for i in range(6)]
    chunks = np.zeros((3, 2, 16), dtype=np.uint8)
    gf.encode_groups(chunks, gf.parity_coefficients(2, 2), "cpu")
    assert _series_total(metrics_on, "mesh_batches_dispatched_total") == 0
    assert cuda_disp.outstanding_snapshot() == [0] * 4
