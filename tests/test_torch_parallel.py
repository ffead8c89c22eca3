"""The port's mesh helper, on-device repartition and mesh-routed shuffle
(``s3shuffle_tpu_torch/parallel/{mesh,repartition,ici_shuffle}.py``)
against the JAX package's, exactly, on the CPU.

The JAX side runs on the eight host devices ``tests/conftest.py`` forces;
the port side runs its lanes on the CPU, a device repeated once per lane
(``make_mesh(..., devices=["cpu"] * width)``), which is the same seam that
lets one GPU host emulated lanes. ``device_repartition``'s outputs,
concatenated in lane order, must equal the JAX outputs bytewise, overflow
included (the same message); ``mesh_shuffle_to_store`` must leave data,
index and checksum objects byte-equal to the JAX function's under zlib and
TLZ (the JAX side on its numpy TLZ host encoder, as in
``test_torch_record_slice.py``).
"""

import collections
import os
import random

import jax
import numpy as np
import pytest
import torch

from s3shuffle_tpu.batch import RecordBatch as JaxRecordBatch
from s3shuffle_tpu.config import ShuffleConfig as JaxConfig
from s3shuffle_tpu.dependency import HashPartitioner as JaxHashPartitioner
from s3shuffle_tpu.manager import ShuffleManager as JaxManager
from s3shuffle_tpu.ops import tlz as jax_tlz
from s3shuffle_tpu.parallel import device_repartition as jax_device_repartition
from s3shuffle_tpu.parallel import make_mesh as jax_make_mesh
from s3shuffle_tpu.parallel import mesh_shuffle_to_store as jax_mesh_shuffle_to_store
from s3shuffle_tpu.parallel import plan_capacity as jax_plan_capacity
from s3shuffle_tpu.parallel.ici_shuffle import batch_to_rows as jax_batch_to_rows
from s3shuffle_tpu.storage.dispatcher import Dispatcher as JaxDispatcher
from s3shuffle_tpu_torch import ShuffleConfig, ShuffleManager
from s3shuffle_tpu_torch.batch import RecordBatch
from s3shuffle_tpu_torch.dependency import HashPartitioner
from s3shuffle_tpu_torch.parallel import (
    device_repartition,
    dispatch,
    make_mesh,
    mesh_shuffle_to_store,
    plan_capacity,
)
from s3shuffle_tpu_torch.parallel.ici_shuffle import (
    batch_to_rows,
    mesh_shuffle_or_fallback,
    rows_to_batch,
)
from torch_jax_native import jax_native_library  # noqa: F401  (loads the JAX oracle's native library)
from torch_port_dispatcher import port_dispatcher_reset  # noqa: F401  (resets the port's process dispatcher)

CPU = torch.device("cpu")
BS = 2048
BATCH = 4


@pytest.fixture(autouse=True)
def _mesh_reset(monkeypatch):
    monkeypatch.delenv("S3SHUFFLE_MESH_DEVICES", raising=False)
    dispatch.reset_for_testing()
    yield
    dispatch.reset_for_testing()


@pytest.fixture
def cpu_lanes(monkeypatch):
    """Eight local "devices" of each type, all the CPU (the lanes seam)."""
    monkeypatch.setattr(dispatch, "local_devices", lambda device_type="cuda": [CPU] * 8)


# --- make_mesh ---

def test_make_mesh_shapes(cpu_lanes):
    mesh = make_mesh()
    assert mesh.size == 8 and mesh.shape == {"data": 8}
    assert mesh.lanes("data") == (CPU,) * 8
    mesh2 = make_mesh({"hosts": 2, "chips": 4})
    assert mesh2.shape == jax_make_mesh({"hosts": 2, "chips": 4}).shape == {"hosts": 2, "chips": 4}
    assert mesh2.devices.shape == (2, 4)
    with pytest.raises(ValueError, match="not one-dimensional"):
        mesh2.lanes("hosts")


@pytest.mark.parametrize("axes", [{"data": 3}, {"a": 2, "b": 3}, {"data": 0}])
def test_make_mesh_error_is_the_jax_error(cpu_lanes, axes):
    with pytest.raises(ValueError) as port_err:
        make_mesh(axes)
    with pytest.raises(ValueError) as jax_err:
        jax_make_mesh(axes)
    assert str(port_err.value) == str(jax_err.value)


def test_make_mesh_default_is_every_local_cuda_device():
    """Unpatched, the default mesh is over the CUDA devices; this CPU host
    has none, so the default mesh is empty (JAX's would hold its CPU
    devices: the port never puts a default mesh on the CPU)."""
    assert make_mesh().shape == {"data": len(dispatch.local_devices("cuda"))}


def test_make_mesh_accepts_a_repeated_device():
    mesh = make_mesh({"data": 4}, devices=["cpu"] * 4)
    assert mesh.lanes("data") == (CPU,) * 4


@pytest.mark.parametrize("rows,n_dev,slack", [(1000, 8, 2.0), (0, 8, 2.0), (7, 3, 1.5),
                                              (64, 1, 2.0), (5, 0, 2.0), (33, 4, 1.0)])
def test_plan_capacity_equals_jax(rows, n_dev, slack):
    assert plan_capacity(rows, n_dev, slack) == jax_plan_capacity(rows, n_dev, slack)


# --- device_repartition against the JAX step ---

REPARTITION_CASES = [
    # (width, rows per lane, row bytes, capacity, partition ids)
    (2, 16, 8, None, 5),
    (4, 64, 16, None, 23),
    (4, 10, 3, 3, 4),          # tight capacity: no overflow by luck of the ids
    (8, 32, 5, None, 8),
    (8, 9, 1, 2, 17),
    (3, 11, 7, None, 1),       # every row to one partition: overflow
    (5, 6, 4, 40, 3),          # capacity above the lane
]


def _repartition_inputs(width, local, row_bytes, n_ids, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 256, (width * local, row_bytes), dtype=np.uint8)
    ids = rng.integers(0, n_ids, width * local).astype(np.int32)
    return rows, ids


@pytest.mark.parametrize("case", REPARTITION_CASES, ids=lambda c: "w{}-n{}-b{}-c{}-p{}".format(*c))
def test_device_repartition_equals_jax(case):
    width, local, row_bytes, capacity, n_ids = case
    rows, ids = _repartition_inputs(width, local, row_bytes, n_ids, sum(case[:3]))
    jmesh = jax_make_mesh({"data": width}, devices=jax.devices()[:width])
    pmesh = make_mesh({"data": width}, devices=[CPU] * width)
    try:
        want = [np.asarray(x) for x in jax_device_repartition(jmesh, rows, ids, capacity=capacity)]
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            device_repartition(pmesh, rows, ids, capacity=capacity)
        assert str(err.value) == str(e) and "repartition overflow" in str(e)
        return
    got = device_repartition(pmesh, rows, ids, capacity=capacity)
    for lane_outs, ref in zip(got, want):
        assert len(lane_outs) == width
        assert all(t.device == CPU for t in lane_outs)
        joined = torch.cat(lane_outs).numpy()
        assert joined.dtype == ref.dtype and joined.shape == ref.shape
        assert (joined == ref).all()


def test_device_repartition_overflow_message_is_jax():
    width = 4
    rows = np.zeros((width * 32, 8), dtype=np.uint8)
    ids = np.zeros(width * 32, dtype=np.int32)  # all to lane 0
    with pytest.raises(ValueError) as jax_err:
        jax_device_repartition(jax_make_mesh({"data": width}, devices=jax.devices()[:width]),
                               rows, ids, capacity=4)
    with pytest.raises(ValueError) as port_err:
        device_repartition(make_mesh({"data": width}, devices=[CPU] * width), rows, ids,
                           capacity=4)
    assert str(port_err.value) == str(jax_err.value)
    assert str(port_err.value) == ("repartition overflow: 112 rows exceeded capacity 4; "
                                   "increase capacity/slack or use the store path")


def test_device_repartition_routes_all_rows():
    width = 8
    mesh = make_mesh({"data": width}, devices=[CPU] * width)
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 256, (width * 64, 16), dtype=np.uint8)
    part_ids = rows[:, 0].astype(np.int32) % 23
    recv, recv_ids, valid = device_repartition(mesh, rows, part_ids, capacity=64)
    got = []
    for d in range(width):
        ok = valid[d].numpy()
        assert (recv_ids[d].numpy()[ok] % width == d).all()  # owner lane
        got.extend(map(bytes, recv[d].numpy()[ok]))
    assert sorted(got) == sorted(map(bytes, rows))


def test_device_repartition_takes_tensors_and_refuses_a_ragged_split():
    mesh = make_mesh({"data": 2}, devices=[CPU] * 2)
    rows = torch.arange(24, dtype=torch.uint8).reshape(6, 4)
    recv, _ids, valid = device_repartition(mesh, rows, torch.zeros(6, dtype=torch.int32))
    assert int(sum(v.sum() for v in valid)) == 6 and int(valid[1].sum()) == 0
    assert sorted(map(bytes, recv[0].numpy()[valid[0].numpy()])) == sorted(
        map(bytes, rows.numpy()))
    with pytest.raises(ValueError, match="must divide evenly over 2 devices"):
        device_repartition(mesh, rows[:5], torch.zeros(5, dtype=torch.int32))


# --- rows <-> batches ---

def _fixed_records(rng, n, kb, vb):
    return [(rng.randbytes(kb), rng.randbytes(vb)) for _ in range(n)]


def test_batch_to_rows_equals_jax_and_round_trips():
    recs = _fixed_records(random.Random(3), 40, 10, 22)
    rows = batch_to_rows(RecordBatch.from_records(recs), 10, 22)
    assert (rows == jax_batch_to_rows(JaxRecordBatch.from_records(recs), 10, 22)).all()
    assert list(rows_to_batch(rows, 10, 22).iter_records()) == recs
    assert batch_to_rows(RecordBatch.empty(), 10, 22).shape == (0, 33)
    with pytest.raises(ValueError, match="uniform key/value widths"):
        batch_to_rows(RecordBatch.from_records([(b"ab", b"c"), (b"abc", b"c")]), 2, 1)


# --- mesh_shuffle_to_store against the JAX function ---

def _objects(root) -> dict:
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            full = os.path.join(dirpath, fn)
            with open(full, "rb") as f:
                out[os.path.relpath(full, root)] = f.read()
    return out


def _batches(cls, seed, sizes, kb=10, vb=22):
    rng = random.Random(seed)
    return [cls.from_records(_fixed_records(rng, n, kb, vb)) for n in sizes]


@pytest.fixture
def jax_numpy_tlz(monkeypatch):
    """The JAX TLZ host encoder on its numpy branch: its C encoder picks
    other valid matches than the numpy and device encoders."""
    monkeypatch.setattr(jax_tlz, "_encode_block_native", lambda _data: None)


@pytest.mark.parametrize("codec", ["zlib", "tpu"])
@pytest.mark.parametrize("width,sizes,n_parts", [(2, (50, 17), 3), (4, (120, 0, 61, 9), 8)])
def test_mesh_shuffle_to_store_objects_equal_jax(tmp_path, jax_numpy_tlz, codec, width,
                                                 sizes, n_parts):
    knobs = dict(app_id="ici", codec=codec, codec_block_size=BS, codec_batch_blocks=BATCH,
                 checksum_algorithm="CRC32C", cleanup=False)
    JaxDispatcher.reset()
    jax_cfg = JaxConfig(root_dir=f"file://{tmp_path}/jax", tpu_host_fallback=False, **knobs)
    jax_mgr = JaxManager(jax_cfg)
    try:
        jh, jax_rows = jax_mesh_shuffle_to_store(
            jax_make_mesh({"data": width}, devices=jax.devices()[:width]),
            _batches(JaxRecordBatch, width, sizes), jax_mgr, JaxHashPartitioner(n_parts),
            key_bytes=10, value_bytes=22, shuffle_id=2,
        )
        jax_parts = [sorted(jax_mgr.get_reader(jh, p, p + 1).read()) for p in range(n_parts)]
    finally:
        jax_mgr.stop()
    mgr = ShuffleManager(ShuffleConfig(root_dir=f"file://{tmp_path}/port", **knobs),
                         device="cpu")
    try:
        handle, port_rows = mesh_shuffle_to_store(
            make_mesh({"data": width}, devices=[CPU] * width),
            _batches(RecordBatch, width, sizes), mgr, HashPartitioner(n_parts),
            key_bytes=10, value_bytes=22, shuffle_id=2,
        )
        port_parts = [sorted(mgr.get_reader(handle, p, p + 1).read()) for p in range(n_parts)]
    finally:
        mgr.stop()
    assert port_rows == jax_rows and sum(port_rows) == sum(sizes)
    assert port_parts == jax_parts
    port_objs, jax_objs = _objects(tmp_path / "port"), _objects(tmp_path / "jax")
    assert sorted(port_objs) == sorted(jax_objs)
    kinds = collections.Counter(os.path.basename(name).split(".")[1] for name in port_objs)
    assert kinds == {"data": width, "index": width, "checksum": width}
    for name, blob in port_objs.items():
        assert blob == jax_objs[name], name


def test_mesh_shuffle_to_store_lane_map_owns_its_partitions(tmp_path):
    width, n_parts = 4, 8
    mgr = ShuffleManager(ShuffleConfig(root_dir=f"file://{tmp_path}", codec="zlib"),
                         device="cpu")
    try:
        batches = _batches(RecordBatch, 7, (30, 31, 32, 33))
        handle, per_dev = mesh_shuffle_to_store(
            make_mesh({"data": width}, devices=[CPU] * width), batches, mgr,
            HashPartitioner(n_parts), 10, 22, shuffle_id=5,
        )
        assert sum(per_dev) == 126
        for p in range(n_parts):
            lengths = [np.diff(mgr.helper.get_partition_lengths(5, m))[p] for m in range(width)]
            owners = [m for m, n in enumerate(lengths) if n]
            assert owners in ([], [p % width])
    finally:
        mgr.stop()


# --- the fallback wrapper's contract ---

def test_mesh_shuffle_or_fallback_contract(tmp_path):
    mgr = ShuffleManager(ShuffleConfig(root_dir=f"file://{tmp_path}", codec="zlib"),
                         device="cpu")
    mesh = make_mesh({"data": 2}, devices=[CPU] * 2)
    prng = random.Random(7)
    ragged = [RecordBatch.from_records([(prng.randbytes(prng.randint(2, 9)), prng.randbytes(4))
                                        for _ in range(30)]) for _ in range(2)]
    try:
        handle, per_map, used_mesh = mesh_shuffle_or_fallback(
            mesh, ragged, mgr, HashPartitioner(4), key_bytes=8, value_bytes=4)
        assert used_mesh is False and per_map == [30, 30]
        got = sorted(kv for p in range(4) for kv in mgr.get_reader(handle, p, p + 1).read())
        assert got == sorted(kv for b in ragged for kv in b.iter_records())
        mgr.unregister_shuffle(handle.shuffle_id)
        # a batch-count mismatch is a caller bug, not a fallback trigger
        one = _batches(RecordBatch, 1, (8,), 8, 16)
        with pytest.raises(ValueError, match="one batch per device"):
            mesh_shuffle_or_fallback(mesh, one, mgr, HashPartitioner(4), 8, 16)
        # skew past the planned capacity (20 rows a peer at width 4) retries
        # once at the per-peer bound (40)
        mesh4 = make_mesh({"data": 4}, devices=[CPU] * 4)
        hot = (bytes(8), bytes(16))
        skewed = [RecordBatch.from_records([hot] * 40), RecordBatch.from_records([hot] * 3),
                  RecordBatch.empty(), RecordBatch.empty()]
        handle, per_dev, used_mesh = mesh_shuffle_or_fallback(
            mesh4, skewed, mgr, HashPartitioner(4), 8, 16, shuffle_id=1)
        assert used_mesh is True and sorted(per_dev) == [0, 0, 0, 43]
        # a pinned capacity opts out of the retry
        with pytest.raises(ValueError, match="repartition overflow"):
            mesh_shuffle_or_fallback(mesh4, skewed, mgr, HashPartitioner(4), 8, 16,
                                     shuffle_id=2, capacity=20)
    finally:
        mgr.stop()
