"""The port's epoch-stamped map-output snapshots (``metadata/snapshot.py``,
``ShuffleSnapshotBlockId`` and the server's snapshot cache) against the JAX
package's, on the CPU, exactly.

- ``MapOutputSnapshot.to_bytes`` is byte-equal to the JAX one's for the
  same tracker state (singles, composite members, coded maps, several
  attempts of one map, empty partitions), each package parses the other's
  blob (wire v3, and the older v1 and v2 rows), and both reject the same
  corrupt blobs with the same message.
- ``SnapshotBackedTracker`` answers a scan's lookups with no call to the
  tracker it wraps, drops its attachment on a registration routed through
  it, refuses an epoch its loader cannot produce and keeps at most
  ``MAX_ATTACHED`` tables, as the JAX facade does
  (``tests/test_control_plane.py:280-365``), with equal
  ``meta_lookup_source_total`` counts.
- The ``.snapmeta`` object each package writes through its dispatcher has
  the same path and bytes; listing mode and the orphan sweep leave it
  alone, ``remove_shuffle`` reclaims it.
- Both servers serve ``get_snapshot`` from their cache at the tracker's
  epoch; a port shuffle re-read from its published snapshot makes no
  lookup RPC.

Both packages' registries, stats collectors and tracers are reset around
each test; a module fixture checks them and the file's threads at the end.
"""

import contextlib
import os
import random
import threading
import time

import numpy as np
import pytest

from s3shuffle_tpu.block_ids import ShuffleSnapshotBlockId as JaxSnapshotBlockId
from s3shuffle_tpu.config import ShuffleConfig as JaxConfig
from s3shuffle_tpu.metadata import map_output as jax_map_output
from s3shuffle_tpu.metadata import service as jax_service
from s3shuffle_tpu.metadata import shard as jax_shard
from s3shuffle_tpu.metadata import snapshot as jax_snapshot
from s3shuffle_tpu.metrics import registry as jax_reg
from s3shuffle_tpu.metrics import stats as jax_stats
from s3shuffle_tpu.storage.dispatcher import Dispatcher as JaxDispatcher
from s3shuffle_tpu.utils import trace as jax_trace
from s3shuffle_tpu_torch import ShuffleConfig, ShuffleManager
from s3shuffle_tpu_torch.block_ids import ShuffleSnapshotBlockId, parse_index_name
from s3shuffle_tpu_torch.dependency import HashPartitioner, ShuffleDependency
from s3shuffle_tpu_torch.metadata import (
    MapOutputSnapshot,
    ShardedMapOutputTracker,
    SnapshotBackedTracker,
    async_client,
    build_snapshot,
    map_output,
    service,
    shard,
    snapshot,
)
from s3shuffle_tpu_torch.metrics import registry as reg
from s3shuffle_tpu_torch.metrics import stats
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
from s3shuffle_tpu_torch.utils import trace
from torch_jax_native import jax_native_library  # noqa: F401  (loads the JAX oracle's native library)
from torch_port_dispatcher import port_dispatcher_reset  # noqa: F401  (resets the port's process dispatcher)

TIMEOUT = 10.0
PUBLISHED = 1_700_000_123.456789
PROCESS_POOLS = ("s3shuffle-torch-encode", "s3shuffle-torch-decode", "s3shuffle-torch-fetch",
                 "s3shuffle-torch-speculate", "s3shuffle-encode", "s3shuffle-decode",
                 "s3shuffle-fetch", "s3shuffle-speculate")
TRACERS = (trace, jax_trace)
REGISTRIES = (reg, jax_reg)
COLLECTORS = (stats.COLLECTOR, jax_stats.COLLECTOR)
#: each package's (map_output, shard, snapshot, service) modules
PORT = (map_output, shard, snapshot, service)
JAX = (jax_map_output, jax_shard, jax_snapshot, jax_service)


def _reset_planes():
    for t in TRACERS:
        t.disable()
        t.reset()
    for r in REGISTRIES:
        r.disable()
        r.REGISTRY.reset_values()
    for c in COLLECTORS:
        c.reset()


@pytest.fixture(scope="module", autouse=True)
def file_hygiene():
    _reset_planes()
    env = {k: v for k, v in os.environ.items() if k.startswith("S3SHUFFLE_")}
    threads = set(threading.enumerate())
    yield
    for t in TRACERS:
        assert not t.enabled() and t.events_snapshot() == [] and t.counters() == {}
    for r in REGISTRIES:
        assert not r.enabled() and r.REGISTRY.snapshot(compact=True) == {}
    for c in COLLECTORS:
        assert c.shuffle_ids() == [] and len(c._outbox) == 0
    assert {k: v for k, v in os.environ.items() if k.startswith("S3SHUFFLE_")} == env
    deadline = time.monotonic() + 10.0
    while True:
        left = [t for t in threading.enumerate() if t not in threads and t.is_alive()
                and not t.name.startswith(PROCESS_POOLS)]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert not left, [t.name for t in left]


@pytest.fixture(autouse=True)
def clean_planes():
    _reset_planes()
    JaxDispatcher.reset()
    yield
    _reset_planes()
    JaxDispatcher.reset()


@pytest.fixture
def registries_on():
    for r in REGISTRIES:
        r.enable()
    yield


def _counter(r, name, **labels):
    metric = r.REGISTRY.get(name)
    series = metric._series.get(tuple(str(labels[n]) for n in metric.labelnames))
    return 0.0 if series is None else series.value


# --- tracker states ----------------------------------------------------------

def _fill(tracker, mods, layout, sid=4, parts=6, seed=0):
    """One tracker state per layout, registered in a seeded order."""
    status = mods[0].MapStatus
    rng = random.Random(seed)
    np_rng = np.random.default_rng(seed)
    tracker.register_shuffle(sid, parts)
    n = 12
    for idx in rng.sample(range(n), n):
        sizes = np_rng.integers(0, 1 << 40, parts)
        kw = {}
        if layout == "composite-coded":
            kw = dict(composite_group=idx // 4 if idx % 3 else -1,
                      base_offset=(idx % 4) * 1_000_003 if idx % 3 else 0,
                      parity_segments=idx % 3)
        elif layout == "attempts-and-empty":
            sizes[np_rng.random(parts) < 0.5] = 0
        tracker.register_map_output(sid, status(map_id=idx, location="object-store",
                                                sizes=sizes, map_index=idx, **kw))
        if layout == "attempts-and-empty" and idx % 2:
            tracker.register_map_outputs(sid, [status(
                map_id=idx + 1000, location="object-store",
                sizes=np_rng.integers(0, 9, parts), map_index=idx)])
    return sid


def _snapshot_of(mods, layout, sharded):
    tracker = (mods[1].ShardedMapOutputTracker(3) if sharded
               else mods[0].MapOutputTracker())
    sid = _fill(tracker, mods, layout)
    built = mods[2].build_snapshot(tracker, sid)
    return mods[2].MapOutputSnapshot(sid, built.epoch, built.num_partitions(), built.entries,
                                     published_unix=PUBLISHED)


@pytest.mark.parametrize("sharded", [False, True], ids=["flat", "sharded"])
@pytest.mark.parametrize("layout", ["singles", "composite-coded", "attempts-and-empty"])
def test_snapshot_bytes_equal_jax_and_each_parses_the_others(layout, sharded):
    port, jax = _snapshot_of(PORT, layout, sharded), _snapshot_of(JAX, layout, sharded)
    blob = port.to_bytes()
    assert blob == jax.to_bytes()
    assert len(blob) == 8 * (7 + len(port.entries) * (5 + 6))
    assert blob[:8] == (0x5333485348534E41).to_bytes(8, "big")
    for parsed in (MapOutputSnapshot.from_bytes(jax.to_bytes()),
                   jax_snapshot.MapOutputSnapshot.from_bytes(blob)):
        assert parsed.to_bytes() == blob
        assert (parsed.shuffle_id, parsed.epoch, parsed.num_partitions()) == (
            4, port.epoch, 6)
        assert parsed.published_unix == pytest.approx(PUBLISHED, abs=1e-6)
    theirs = MapOutputSnapshot.from_bytes(jax.to_bytes())
    for ranges in ([(0, 6)], [(1, 3), (5, 6)]):
        assert theirs.get_map_sizes_by_ranges(2, 9, ranges) == \
            jax.get_map_sizes_by_ranges(2, 9, ranges)
    assert theirs.get_map_sizes_by_range(0, None, 0, 6) == port.get_map_sizes_by_range(
        0, None, 0, 6)
    assert theirs.registered_map_ids() == jax.registered_map_ids()
    assert theirs.composite_locations() == jax.composite_locations()
    if layout == "attempts-and-empty":
        assert any(m >= 1000 for m in theirs.registered_map_ids())


def _old_blob(version):
    """A v1 (``[map_id, map_index]``) or v2 (+ group, base) blob by hand."""
    meta = {1: 2, 2: 4}[version]
    header = [0x5333485348534E41, version, 9, 3, 2, int(PUBLISHED * 1e6), 2]
    rows = [[5, 0] + ([1, 64] if meta == 4 else []) + [10, 20],
            [1006, 1] + ([-1, 0] if meta == 4 else []) + [30, 0]]
    return np.asarray(header + [w for r in rows for w in r], dtype=">i8").tobytes()


@pytest.mark.parametrize("version", [1, 2])
def test_older_snapshot_rows_parse_as_jax(version):
    blob = _old_blob(version)
    port, jax = MapOutputSnapshot.from_bytes(blob), jax_snapshot.MapOutputSnapshot.from_bytes(blob)
    assert port.to_bytes() == jax.to_bytes()  # re-serialized as v3
    assert port.get_map_sizes_by_range(0, None, 0, 2) == [(5, [(0, 10), (1, 20)]),
                                                          (1006, [(0, 30), (1, 0)])]
    assert port.composite_locations() == jax.composite_locations() == (
        [(5, 1, 64)] if version == 2 else [])


def _corrupt(kind):
    blob = _snapshot_of(PORT, "singles", False).to_bytes()
    if kind == "truncated":
        return blob[:-8]
    if kind == "not-words":
        return blob + b"\x00" * 3
    if kind == "short":
        return blob[:48]
    if kind == "magic":
        return b"\x00" * 8 + blob[8:]
    if kind == "version":
        return blob[:8] + (4).to_bytes(8, "big") + blob[16:]
    return blob[:48] + (13).to_bytes(8, "big") + blob[56:]  # entry count


@pytest.mark.parametrize("kind", ["truncated", "not-words", "short", "magic", "version",
                                  "count"])
def test_corrupt_snapshots_are_rejected_by_both(kind):
    blob = _corrupt(kind)
    with pytest.raises(ValueError) as port_err:
        MapOutputSnapshot.from_bytes(blob)
    with pytest.raises(ValueError) as jax_err:
        jax_snapshot.MapOutputSnapshot.from_bytes(blob)
    assert str(port_err.value) == str(jax_err.value)


def test_a_status_with_too_few_sizes_is_refused_by_both():
    for mods in (PORT, JAX):
        st = mods[0].MapStatus(map_id=1, location="object-store", sizes=np.arange(2))
        with pytest.raises(ValueError, match="has 2 sizes, shuffle has 3"):
            mods[2].MapOutputSnapshot(0, 1, 3, [(1, st)]).to_bytes()


# --- the facade --------------------------------------------------------------

def _counting(mods):
    class CountingTracker(mods[0].MapOutputTracker):
        def __init__(self):
            super().__init__()
            self.lookups = 0

        def get_map_sizes_by_ranges(self, *a, **k):
            self.lookups += 1
            return super().get_map_sizes_by_ranges(*a, **k)

        def num_partitions(self, *a):
            self.lookups += 1
            return super().num_partitions(*a)

    return CountingTracker()


def _facade_script(mods, r):
    """The JAX tests' facade sequence; every answer and lookup count."""
    inner = _counting(mods)
    _fill(inner, mods, "composite-coded", sid=6)
    facade = mods[2].SnapshotBackedTracker(inner)
    facade.attach(mods[2].build_snapshot(inner, 6))
    inner.lookups = 0
    out = [facade.get_map_sizes_by_range(6, 0, None, p, p + 1) for p in range(6)]
    out.append(facade.get_map_sizes_by_ranges(6, 0, None, [(0, 2), (2, 6)]))
    out += [facade.num_partitions(6), facade.contains(6), facade.registered_map_ids(6),
            facade.composite_locations(6)]
    facade.register_shuffle(6, 6)  # an idempotent re-registration: no round-trip
    out.append(("rpc lookups with a snapshot", inner.lookups))
    inner.register_shuffle(8, 4)
    inner.register_map_output(8, mods[0].MapStatus(map_id=0, location="object-store",
                                                   sizes=np.arange(4)))
    out.append(facade.get_map_sizes_by_range(8, 0, None, 0, 4))
    out.append(("rpc lookups without one", inner.lookups))
    # a registration routed through the facade makes the table stale
    facade.register_map_output(6, mods[0].MapStatus(map_id=99, location="object-store",
                                                    sizes=np.arange(6), map_index=99))
    out.append(facade.attached_epoch(6))
    out.append(facade.get_map_sizes_by_range(6, 90, None, 0, 2))
    out.append(("rpc lookups after the drop", inner.lookups))
    facade.unregister_shuffle(6)
    out.append(facade.contains(6))
    out.append(facade.shuffle_ids())
    out.append([_counter(r, "meta_lookup_source_total", source=s) for s in ("snapshot", "rpc")])
    return out


def test_the_facade_serves_lookups_from_its_snapshot_as_jax(registries_on):
    port, jax = _facade_script(PORT, reg), _facade_script(JAX, jax_reg)
    assert port == jax
    assert ("rpc lookups with a snapshot", 0) in port
    assert ("rpc lookups without one", 1) in port
    assert port[-1] == [11.0, 3.0]


def test_ensure_loads_once_and_drops_a_table_of_another_epoch():
    results = []
    for mods in (PORT, JAX):
        inner = mods[0].MapOutputTracker()
        _fill(inner, mods, "singles", sid=2)
        blob, epoch = mods[2].build_snapshot(inner, 2).to_bytes(), inner.epoch(2)
        loads = []

        def loader(sid, want, _blob=blob, _loads=loads):
            _loads.append((sid, want))
            return _blob

        facade = mods[2].SnapshotBackedTracker(inner, loader=loader)
        got = [facade.ensure(2, epoch), facade.ensure(2, epoch), list(loads),
               facade.attached_epoch(2), facade.ensure(2, epoch + 5),
               facade.attached_epoch(2), mods[2].SnapshotBackedTracker(inner).ensure(2, epoch)]
        # a loader with nothing to give leaves the shuffle on the RPC path
        empty = mods[2].SnapshotBackedTracker(inner, loader=lambda _s, _e: None)
        got.append(empty.ensure(2, epoch))
        results.append(got)
    assert results[0] == results[1]
    assert results[0][:2] == [True, True] and results[0][4] is False
    assert results[0][5] is None


def test_the_attachment_bound_evicts_the_oldest_as_jax():
    kept = []
    for mods in (PORT, JAX):
        inner = mods[0].MapOutputTracker()
        facade = mods[2].SnapshotBackedTracker(inner)
        n = mods[2].SnapshotBackedTracker.MAX_ATTACHED + 10
        for sid in range(n):
            inner.register_shuffle(sid, 2)
            inner.register_map_output(sid, mods[0].MapStatus(map_id=0, location="x",
                                                             sizes=np.arange(2)))
            facade.attach(mods[2].build_snapshot(inner, sid))
        facade.attach(mods[2].build_snapshot(inner, n - 1))  # re-attaching keeps one entry
        kept.append(sorted(facade._snapshots))
    assert kept[0] == kept[1] == list(range(10, SnapshotBackedTracker.MAX_ATTACHED + 10))


# --- the .snapmeta object ----------------------------------------------------

@pytest.mark.parametrize("fallback", [False, True])
def test_the_snapmeta_object_equals_jax_and_the_sweeps_leave_it(tmp_path, fallback):
    knobs = dict(root_dir=f"file://{tmp_path}", folder_prefixes=3, use_fallback_fetch=fallback,
                 codec="zlib")
    port_snap, jax_snap = _snapshot_of(PORT, "singles", False), _snapshot_of(JAX, "singles",
                                                                             False)
    jax_disp = JaxDispatcher(JaxConfig(**knobs))
    disp = Dispatcher(ShuffleConfig(**knobs))
    block = ShuffleSnapshotBlockId(4, port_snap.epoch)
    assert block.name == f"shuffle_4_snapshot_{port_snap.epoch}.snapmeta"
    path = disp.get_path(block)
    assert path == jax_disp.get_path(JaxSnapshotBlockId(4, jax_snap.epoch))
    with disp.backend.create(path) as sink:
        sink.write(port_snap.to_bytes())
    assert jax_disp.backend.read_all(path) == jax_snap.to_bytes()
    assert parse_index_name(path) is None
    assert disp.list_committed_outputs(4) == ([], [])
    assert disp.sweep_orphan_attempts(4, []) == []
    assert disp.backend.exists(path)
    disp.remove_shuffle(4)
    assert not disp.backend.exists(path)


@pytest.mark.parametrize("publish,fails", [(True, False), (False, False), (True, True)])
def test_publish_snapshot_writes_what_the_jax_coordinator_writes(tmp_path, monkeypatch,
                                                                 publish, fails):
    """``snapshot.publish_snapshot`` against the JAX package's
    ``cluster.publish_snapshot``: the same epoch (None with
    ``metadata_snapshots`` off or on a failed build) and the same object at
    the same path, or none."""
    from s3shuffle_tpu import cluster as jax_cluster

    for mod in (snapshot, jax_snapshot):  # the snapshot's publish stamp
        monkeypatch.setattr(mod.time, "time", lambda: PUBLISHED)
    knobs = dict(folder_prefixes=3, codec="zlib", metadata_snapshots=publish)
    got = []
    for mods, root in ((PORT, tmp_path / "port"), (JAX, tmp_path / "jax")):
        tracker = mods[0].MapOutputTracker()
        sid = 9 if fails else _fill(tracker, mods, "composite-coded")  # 9: not registered
        if mods is PORT:
            disp = Dispatcher(ShuffleConfig(root_dir=f"file://{root}", **knobs))
            epoch = snapshot.publish_snapshot(tracker, disp, sid)
        else:
            cfg = JaxConfig(root_dir=f"file://{root}", **knobs)
            epoch = jax_cluster.publish_snapshot(tracker, cfg, sid)
        objects = {}
        for d, _dirs, files in os.walk(root):
            for f in files:
                with open(os.path.join(d, f), "rb") as fh:
                    objects[os.path.relpath(os.path.join(d, f), root)] = fh.read()
        got.append((epoch, objects))
    assert got[0] == got[1]
    epoch, objects = got[0]
    if publish and not fails:
        assert epoch == 12 and len(objects) == 1
        (blob,) = objects.values()
        assert MapOutputSnapshot.from_bytes(blob).epoch == epoch
        assert MapOutputSnapshot.from_bytes(blob).published_unix == pytest.approx(PUBLISHED,
                                                                                  abs=1e-6)
    else:
        assert epoch is None and objects == {}


# --- the server's snapshot cache and a re-read from a published snapshot -----

@contextlib.contextmanager
def _server(mods, **kw):
    srv = mods[3].MetadataServer(host="127.0.0.1", port=0, **kw).start()
    try:
        yield srv
    finally:
        srv.stop()


@pytest.mark.parametrize("server", ["port", "jax"])
def test_the_server_serves_snapshots_at_the_trackers_epoch(server):
    mods = PORT if server == "port" else JAX
    with _server(mods, shards=3) as srv:
        client = service.RemoteMapOutputTracker(srv.address, timeout=TIMEOUT)
        try:
            sid = _fill(client, PORT, "composite-coded")
            epoch, blob = client.get_snapshot(sid)
            assert epoch == client.epoch(sid) == srv.tracker.epoch(sid)
            parsed = MapOutputSnapshot.from_bytes(blob)
            want = mods[2].build_snapshot(srv.tracker, sid)
            assert [(i, s.map_id) for i, s in parsed.entries] == [
                (i, s.map_id) for i, s in want.entries]
            assert parsed.get_map_sizes_by_range(0, None, 0, 6) == \
                client.get_map_sizes_by_range(sid, 0, None, 0, 6)
            assert client.get_snapshot(sid) == (epoch, blob)  # cached at this epoch
            client.register_map_output(sid, map_output.MapStatus(
                map_id=50, location="object-store", sizes=np.arange(6), map_index=50))
            epoch2, blob2 = client.get_snapshot(sid)
            assert epoch2 == epoch + 1 and blob2 != blob
            client.unregister_shuffle(sid)
            assert srv.snapshots._by_shuffle == {}
        finally:
            client.close()


def _write_maps(mgr, sid=0, maps=3, parts=3):
    dep = ShuffleDependency(shuffle_id=sid, partitioner=HashPartitioner(parts))
    handle = mgr.register_shuffle(sid, dep)
    rows = []
    for m in range(maps):
        rng = np.random.default_rng(m)
        recs = [(int(k), bytes(v)) for k, v in zip(rng.integers(0, 500, 400),
                                                    rng.integers(0, 256, (400, 12),
                                                                 dtype=np.uint8))]
        rows += recs
        writer = mgr.get_writer(handle, m)
        writer.write(recs)
        writer.stop(success=True)
    return dep, sorted(rows)


@pytest.mark.parametrize("server", ["port", "jax"])
def test_a_reread_from_the_published_snapshot_makes_no_lookup_rpc(tmp_path, registries_on,
                                                                  server):
    cfg = ShuffleConfig(root_dir=f"file://{tmp_path}", codec="zlib", cleanup=False)
    with _server(PORT if server == "port" else JAX, shards=4, shard_endpoints=2) as srv:
        client = async_client.AsyncTrackerClient(srv.address, timeout=TIMEOUT)
        try:
            writer_mgr = ShuffleManager(cfg, tracker=client, device="cpu")
            dep, want = _write_maps(writer_mgr)
            client.flush()
            snap = (build_snapshot if server == "port" else jax_snapshot.build_snapshot)(
                srv.tracker, 0)
            disp = writer_mgr.dispatcher
            with disp.backend.create(disp.get_path(ShuffleSnapshotBlockId(0, snap.epoch))) as s:
                s.write(snap.to_bytes())
            loads = []

            def loader(sid, epoch):
                loads.append((sid, epoch))
                return disp.backend.read_all(disp.get_path(ShuffleSnapshotBlockId(sid, epoch)))

            facade = SnapshotBackedTracker(client, loader)
            assert facade.ensure(0, snap.epoch)
            reader_mgr = ShuffleManager(cfg, tracker=facade, device="cpu")
            reg.REGISTRY.reset_values()
            handle = reader_mgr.register_shuffle(0, dep)
            got = sorted(r for p in range(3) for r in reader_mgr.get_reader(handle, p, p + 1)
                         .read())
            rpc = {k: s.value for k, s in reg.REGISTRY.get("meta_rpc_total")._series.items()
                   if s.value}
            assert got == want
            assert rpc == {}  # no lookup, no registration: not one RPC
            assert loads == [(0, snap.epoch)]
            assert _counter(reg, "meta_lookup_source_total", source="snapshot") == 3
            assert _counter(reg, "meta_lookup_source_total", source="rpc") == 0
        finally:
            client.close()


def test_the_metadata_package_exports_as_jax():
    import s3shuffle_tpu.metadata as jax_metadata

    import s3shuffle_tpu_torch.metadata as port_metadata

    assert port_metadata.__all__ == jax_metadata.__all__
    assert ShardedMapOutputTracker is shard.ShardedMapOutputTracker
