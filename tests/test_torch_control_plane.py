"""The port's control plane (``metadata/service.py``, ``shard.py``,
``async_client.py``, ``version.py``, the four ``metadata_*`` knobs and the
reader's batch lookup) against the JAX package's, on the CPU, exactly.

- RPC in both directions: one scripted call sequence (registrations with
  composite and parity fields, every lookup, snapshots, stats, the task
  queue, membership, trace shards and fleet telemetry) runs port client →
  JAX server, JAX client → port server and port → port beside JAX → JAX;
  the answers are equal and so are the request and reply frames, byte for
  byte, as a relay between client and server records them. Time-stamped
  fields come from a frozen clock in all four. A client of another format
  version is refused by both servers.
- The sharded tracker at 1, 2, 4 and 7 shards, the service's own pieces
  (stage ids, registry merges, the task queue, membership, the span-shard
  store, frames, retries, the ``meta.rpc`` span).
- The batched client: RPC counts by method and connection and flush
  points equal the JAX client's; a flush failure reaches the committing
  writer in both packages; advertised wildcard endpoints are rewritten.
- End to end: a port TeraSort through ``AsyncTrackerClient`` against a JAX
  server and against the port's writes objects byte-equal to a
  local-tracker run and to the JAX package's; the reader asks the tracker
  once per scan, in the batch form, as the JAX reader does.
- The config knobs, the servers and clients built ``from_config`` as the
  JAX coordinator and workers build theirs, and the build info.

Every server binds port 0 on 127.0.0.1 and is stopped in a ``finally``;
every client has a short timeout. Both packages' registries, stats
collectors and tracers are reset before and after each test, and a module
fixture checks them, the ``S3SHUFFLE_*`` variables and the file's threads
when the file ends.
"""

import contextlib
import dataclasses
import json
import logging
import os
import random
import socket
import struct
import threading
import time

import numpy as np
import pytest

from s3shuffle_tpu import version as jax_version
from s3shuffle_tpu.batch import RecordBatch as JaxRecordBatch
from s3shuffle_tpu.config import ShuffleConfig as JaxConfig
from s3shuffle_tpu.dependency import HashPartitioner as JaxHashPartitioner
from s3shuffle_tpu.dependency import ShuffleDependency as JaxDependency
from s3shuffle_tpu.manager import ShuffleManager as JaxManager
from s3shuffle_tpu.metadata import async_client as jax_async
from s3shuffle_tpu.metadata import map_output as jax_map_output
from s3shuffle_tpu.metadata import service as jax_service
from s3shuffle_tpu.metadata import shard as jax_shard
from s3shuffle_tpu.metadata import snapshot as jax_snapshot
from s3shuffle_tpu.metrics import registry as jax_reg
from s3shuffle_tpu.metrics import stats as jax_stats
from s3shuffle_tpu.ops import tlz as jax_tlz
from s3shuffle_tpu.serializer import ColumnarKVSerializer as JaxColumnarKV
from s3shuffle_tpu.shuffle import ShuffleContext as JaxContext
from s3shuffle_tpu.storage.dispatcher import Dispatcher as JaxDispatcher
from s3shuffle_tpu.utils import trace as jax_trace
from s3shuffle_tpu_torch import ShuffleConfig, ShuffleContext, ShuffleManager, version
from s3shuffle_tpu_torch.batch import RecordBatch
from s3shuffle_tpu_torch.dependency import HashPartitioner, ShuffleDependency
from s3shuffle_tpu_torch.metadata import async_client, map_output, service, shard, snapshot
from s3shuffle_tpu_torch.metrics import registry as reg
from s3shuffle_tpu_torch.metrics import stats
from s3shuffle_tpu_torch.serializer import ColumnarKVSerializer
from s3shuffle_tpu_torch.utils import trace
from torch_jax_native import jax_native_library  # noqa: F401  (loads the JAX oracle's native library)
from torch_port_dispatcher import port_dispatcher_reset  # noqa: F401  (resets the port's process dispatcher)

BS = 2048
BATCH = 4
MAPS = 3
PARTS = 3
#: a client's socket timeout: no test waits on a socket for longer
TIMEOUT = 10.0
PROCESS_POOLS = ("s3shuffle-torch-encode", "s3shuffle-torch-decode", "s3shuffle-torch-fetch",
                 "s3shuffle-torch-speculate", "s3shuffle-encode", "s3shuffle-decode",
                 "s3shuffle-fetch", "s3shuffle-speculate", "s3shuffle-tpu-encode",
                 "s3shuffle-tpu-decode")
TRACERS = (trace, jax_trace)
REGISTRIES = (reg, jax_reg)
COLLECTORS = (stats.COLLECTOR, jax_stats.COLLECTOR)


@dataclasses.dataclass(frozen=True)
class Pkg:
    """One package's control plane, so each test runs the same code twice."""

    name: str
    service: object
    shard: object
    snapshot: object
    async_client: object
    map_output: object
    version: object
    reg: object

    @property
    def MapStatus(self):
        return self.map_output.MapStatus


PORT = Pkg("port", service, shard, snapshot, async_client, map_output, version, reg)
JAX = Pkg("jax", jax_service, jax_shard, jax_snapshot, jax_async, jax_map_output,
          jax_version, jax_reg)
PKGS = {"port": PORT, "jax": JAX}


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
    """When the file ends: both packages' tracers, registries and stats
    collectors off and empty, no ``S3SHUFFLE_*`` variable changed, and no
    thread of this file alive but the process-wide pools' workers."""
    _reset_planes()
    env = _env_vars()
    threads = set(threading.enumerate())
    yield
    for t in TRACERS:
        assert not t.enabled() and t.events_snapshot() == [] and t.counters() == {}
        assert len(t._flight) == 0 and t._flight_dir is None
    for r in REGISTRIES:
        assert not r.enabled() and r.REGISTRY.snapshot(compact=True) == {}
    for c in COLLECTORS:
        assert c.shuffle_ids() == [] and len(c._outbox) == 0
    assert _env_vars() == env
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


class _FrozenClock:
    """The ``time`` module with a fixed wall clock and monotonic clock, so
    every time-stamped field of a reply (membership, fleet ages, a
    snapshot's publish stamp) is the same in every run."""

    def __getattr__(self, name):
        return getattr(time, name)

    @staticmethod
    def monotonic():
        return 1000.0

    @staticmethod
    def time():
        return 1_700_000_000.0


@pytest.fixture
def frozen_clock(monkeypatch):
    for pkg in PKGS.values():
        monkeypatch.setattr(pkg.service, "time", _FrozenClock())
        monkeypatch.setattr(pkg.snapshot, "time", _FrozenClock())


@contextlib.contextmanager
def _server(pkg, **kw):
    srv = pkg.service.MetadataServer(host=kw.pop("host", "127.0.0.1"), port=0, **kw).start()
    try:
        yield srv
    finally:
        srv.stop()


@contextlib.contextmanager
def _closing(client):
    try:
        yield client
    finally:
        client.close()


class _Relay:
    """A TCP relay between one client connection and a server that keeps
    every byte each way (``up``: requests, ``down``: replies)."""

    def __init__(self, target):
        self.target = target
        self._listener = socket.create_server(("127.0.0.1", 0))
        self.address = self._listener.getsockname()[:2]
        self.up, self.down = bytearray(), bytearray()
        self._sockets = []
        self._threads = [threading.Thread(target=self._accept, name="cp-relay", daemon=True)]
        self._threads[0].start()

    def _accept(self):
        try:
            conn, _addr = self._listener.accept()
        except OSError:
            return
        upstream = socket.create_connection(self.target, timeout=TIMEOUT)
        self._sockets = [conn, upstream]
        for src, dst, buf in ((conn, upstream, self.up), (upstream, conn, self.down)):
            t = threading.Thread(target=self._pump, args=(src, dst, buf),
                                 name="cp-relay-pump", daemon=True)
            t.start()
            self._threads.append(t)

    @staticmethod
    def _pump(src, dst, buf):
        try:
            while True:
                chunk = src.recv(1 << 16)
                if not chunk:
                    break
                buf.extend(chunk)
                dst.sendall(chunk)
        except OSError:
            pass
        finally:
            with contextlib.suppress(OSError):
                dst.shutdown(socket.SHUT_WR)

    def close(self):
        self._listener.close()
        for t in list(self._threads):
            t.join(timeout=TIMEOUT)
        for s in self._sockets:
            s.close()


def _frames(buf):
    out, i = [], 0
    while i < len(buf):
        (n,) = struct.unpack_from("<I", buf, i)
        out.append(bytes(buf[i + 4:i + 4 + n]))
        i += 4 + n
    assert i == len(buf)
    return out


# --- the scripted RPC sequence -----------------------------------------------

NP = 5


def _sizes(seed=0, n=8):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1 << 20, NP).astype(np.int64) for _ in range(n)]


def _script(client, pkg):
    """Every RPC of the service once or more, in one order; each answer (or
    the error a call raised) in a list."""
    sizes = _sizes()
    status = pkg.MapStatus
    out = []

    def call(name, *args):
        try:
            res = getattr(client, name)(*args)
        except (KeyError, RuntimeError) as e:
            res = (type(e).__name__, str(e))
        out.append((name, res))
        return res

    stage = pkg.service.stage_id_for(3, "map")
    call("ping")
    call("check_format")
    call("register_shuffle", 3, NP)
    call("register_map_output", 3, status(0, "object-store", sizes[0], map_index=0))
    # a second attempt of logical map 0 (attempt stride 1000), coded
    call("register_map_output", 3, status(1000, "object-store", sizes[1], map_index=0,
                                          parity_segments=2))
    call("register_map_outputs", 3, [
        status(1, "object-store", sizes[2], map_index=1, composite_group=0, base_offset=0),
        status(2, "object-store", sizes[3], map_index=2, composite_group=0, base_offset=4096),
        status(3, "object-store", sizes[4], map_index=3, parity_segments=1),
    ])
    call("get_map_sizes_by_range", 3, 0, None, 1, 4)
    call("get_map_sizes_by_ranges", 3, 1, 3, [(0, 2), (2, NP)])
    call("epoch", 3)
    call("registered_map_ids", 3)
    call("composite_locations", 3)
    call("shuffle_ids")
    call("contains", 3)
    call("contains", 4)
    call("num_partitions", 3)
    call("get_snapshot", 3)
    call("shard_addresses")
    call("epoch", 99)  # KeyError on the server, re-raised by the client
    call("report_task_stats", [{"kind": "map", "shuffle_id": 3, "task_id": 0, "bytes": 10}])
    call("get_shuffle_stats", 3)
    # the task queue: lease, commit authorization, the atomic registration
    tasks = [{"task_id": i, "kind": "map", "map_id": i} for i in range(3)]
    call("submit_stage", stage, tasks)
    call("submit_stage", stage, tasks)  # already submitted
    call("register_worker", "w0")
    call("take_task", "w0")
    call("can_commit", stage, 0, "w0")
    call("can_commit", stage, 0, "w1")
    call("complete_task", stage, 0, {"bytes": 10}, "w0",
         [3, 7, "object-store", sizes[5].tolist(), 7, -1, 0, 0])
    call("complete_task", stage, 0, {"bytes": 10}, "w0", None)  # no lease any more
    call("complete_task", stage, 5, {}, None, [3, 8, "object-store", [1, 2, 3, 4]])  # format 1
    call("take_task", "w1")
    call("fail_task", stage, 1, "boom", "w1")
    call("retry_failed", stage, 1, "recovery")
    call("retry_failed", stage, 2)
    call("heartbeat", "w1")
    call("reap_expired", stage, 30.0)
    call("reap_expired_all", 30.0)
    call("stage_status", stage)
    call("get_map_sizes_by_range", 3, 0, None, 0, NP)
    # membership: join, drain, leave
    call("request_drain", "w0")
    call("request_drain", "w9")
    call("take_task", "w0")
    call("deregister_worker", "w0", 1.5)
    call("membership")
    # trace shards and the fleet's telemetry
    call("report_trace_spans", [{"name": "read.tasks", "ph": "X", "ts": 1.0, "dur": 2.0}])
    call("report_trace_spans", [])
    call("get_trace_spans")
    sample = {"meta_rpc_total": {"kind": "counter", "labelnames": ["method", "shard"],
                                 "series": [{"labels": {"method": "epoch", "shard": "0"},
                                             "value": 3.0}]}}
    call("report_fleet_sample", "w1", sample, {"obj": 4})
    call("report_fleet_sample", "w2", sample, {"obj": 9})
    call("get_fleet_view")
    call("drop_stage", stage)
    call("stop_workers")
    call("take_task", "w3")
    call("unregister_shuffle", 3)
    call("contains", 3)
    call("shuffle_ids")
    return out


def _run_script(client_pkg, server_pkg):
    with _server(server_pkg, shards=4) as srv:
        relay = _Relay(srv.address)
        try:
            client = client_pkg.service.RemoteMapOutputTracker(relay.address, timeout=TIMEOUT)
            with _closing(client):
                answers = _script(client, client_pkg)
        finally:
            relay.close()
    return answers, _frames(relay.up), _frames(relay.down)


@pytest.mark.parametrize("pair", ["port-to-jax", "jax-to-port", "port-to-port"])
def test_rpc_answers_and_frames_equal_jax_to_jax(frozen_clock, pair):
    client, server = (PKGS[p] for p in pair.split("-to-"))
    want, want_up, want_down = _run_script(JAX, JAX)
    got, up, down = _run_script(client, server)
    assert got == want
    assert len(up) == len(down) == len(want)
    assert up == want_up  # requests, byte for byte
    assert down == want_down  # replies, byte for byte
    answers = dict(reversed(got))  # each method's first answer
    assert answers["check_format"] == 6
    # logical map 0's winner is its second attempt
    assert answers["get_map_sizes_by_range"][0] == (1000, [(r, int(_sizes()[1][r]))
                                                           for r in (1, 2, 3)])
    assert answers["epoch"] == 5  # the two singles and the three of the batch
    assert answers["composite_locations"] == [(1, 0, 0), (2, 0, 4096)]
    assert [a for m, a in got if m == "registered_map_ids"] == [[0, 1, 2, 3, 1000]]
    assert answers["take_task"]["task"] == {"task_id": 0, "kind": "map", "map_id": 0,
                                            "_attempt": 1}
    assert answers["get_fleet_view"]["object_gets_peaks"] == {"obj": 9}
    errors = [a for _m, a in got if isinstance(a, tuple) and a and a[0] in ("KeyError",
                                                                           "RuntimeError")]
    assert [e[0] for e in errors] == ["KeyError", "RuntimeError", "RuntimeError"]


@pytest.mark.parametrize("server", ["port", "jax"])
def test_a_client_of_another_format_version_is_refused(monkeypatch, server):
    srv_pkg = PKGS[server]
    other = JAX if server == "port" else PORT
    with _server(srv_pkg, shards=1) as srv:
        with _closing(other.service.RemoteMapOutputTracker(srv.address, timeout=TIMEOUT)) as c:
            assert c.check_format() == 6
            monkeypatch.setattr(other.version, "SHUFFLE_FORMAT_VERSION", 5)
            with pytest.raises(RuntimeError, match="shuffle format version mismatch: "
                               "worker speaks 5, coordinator speaks 6"):
                c.check_format()
            assert c.ping()  # a refused handshake leaves the connection serving
        # the same refusal as a raw frame, and the reply bytes of both servers
        with socket.create_connection(srv.address, timeout=TIMEOUT) as s:
            srv_pkg.service._send_frame(s, {"method": "check_format", "args": [5]})
            reply = srv_pkg.service._recv_frame(s)
    assert reply == {"ok": False, "error_type": "RuntimeError", "error": (
        "RuntimeError: shuffle format version mismatch: worker speaks 5, coordinator speaks "
        "6 — mixed framework versions mis-partition silently; deploy one version per job")}


def test_version_and_build_info_match_jax(caplog):
    assert version.SHUFFLE_FORMAT_VERSION == jax_version.SHUFFLE_FORMAT_VERSION == 6
    assert version.__version__ == jax_version.__version__
    import s3shuffle_tpu_torch

    assert s3shuffle_tpu_torch.__version__ == version.__version__
    assert set(version.BUILD_INFO) == set(jax_version.BUILD_INFO)
    assert version.BUILD_INFO["name"] == "s3shuffle_tpu_torch"
    assert version.BUILD_INFO["shuffle_format"] == 6
    with caplog.at_level(logging.INFO, logger="s3shuffle_tpu_torch.manager"):
        ShuffleManager(ShuffleConfig(root_dir="memory://cp-build-info"), device="cpu")
    assert str(version.BUILD_INFO) in caplog.text


# --- the sharded tracker -----------------------------------------------------

def _fill(tracker, pkg, sid, n_maps, parts=6, seed=0):
    """Registrations in a seeded order, a quarter of the maps with a second
    committed attempt (map ids strided by 1000), some composite, some coded,
    half of them batched."""
    rng = random.Random(seed)
    np_rng = np.random.default_rng(seed)
    tracker.register_shuffle(sid, parts)
    order = list(range(n_maps))
    rng.shuffle(order)
    batch = []
    for idx in order:
        for attempt in range(1 + (rng.random() < 0.25)):
            group = rng.choice([-1, -1, idx // 4])
            st = pkg.MapStatus(map_id=idx + 1000 * attempt, location="object-store",
                               sizes=np_rng.integers(0, 1 << 16, parts), map_index=idx,
                               composite_group=group, base_offset=64 * idx if group >= 0 else 0,
                               parity_segments=rng.choice([0, 0, 2]))
            if rng.random() < 0.5:
                batch.append(st)
            else:
                tracker.register_map_output(sid, st)
        if len(batch) >= 5:
            tracker.register_map_outputs(sid, batch)
            batch = []
    if batch:
        tracker.register_map_outputs(sid, batch)


@pytest.mark.parametrize("num_shards", [1, 2, 4, 7])
def test_the_sharded_tracker_answers_as_jax(num_shards):
    grid = [(s, m) for s in (0, 1, 9, 12345) for m in range(64)]
    assert [shard.shard_of(s, m, num_shards) for s, m in grid] == [
        jax_shard.shard_of(s, m, num_shards) for s, m in grid]
    port, jax = shard.ShardedMapOutputTracker(num_shards), jax_shard.ShardedMapOutputTracker(
        num_shards)
    for t, pkg in ((port, PORT), (jax, JAX)):
        _fill(t, pkg, 5, n_maps=40, seed=num_shards)
    assert [port.shard_index(5, m) for m in range(40)] == [jax.shard_index(5, m)
                                                           for m in range(40)]
    for smi, emi, sp, ep in [(0, None, 0, 6), (3, 17, 2, 5), (39, None, 0, 1), (0, 1, 5, 6)]:
        assert port.get_map_sizes_by_range(5, smi, emi, sp, ep) == \
            jax.get_map_sizes_by_range(5, smi, emi, sp, ep)
    assert port.get_map_sizes_by_ranges(5, 2, 30, [(0, 3), (3, 6)]) == \
        jax.get_map_sizes_by_ranges(5, 2, 30, [(0, 3), (3, 6)])
    for name in ("registered_map_ids", "composite_locations", "epoch", "num_partitions",
                 "contains"):
        assert getattr(port, name)(5) == getattr(jax, name)(5), name
    # one winner per logical index: the latest attempt
    winners = [m for m, _s in port.get_map_sizes_by_range(5, 0, None, 0, 1)]
    assert len(winners) == 40 and any(m >= 1000 for m in winners)
    assert [(i, s.map_id) for i, s in port.deduped_statuses(5)] == \
        [(i, s.map_id) for i, s in jax.deduped_statuses(5)]
    plain = map_output.MapOutputTracker()
    _fill(plain, PORT, 5, n_maps=40, seed=num_shards)
    assert plain.get_map_sizes_by_range(5, 0, None, 0, 6) == \
        port.get_map_sizes_by_range(5, 0, None, 0, 6)
    assert port.shuffle_ids() == jax.shuffle_ids() == [5]
    for t in (port, jax):
        t.unregister_shuffle(5)
        assert not t.contains(5)
        with pytest.raises(KeyError):
            t.get_map_sizes_by_range(5, 0, None, 0, 6)
        with pytest.raises(KeyError):
            t.epoch(5)
    with pytest.raises(ValueError):
        shard.ShardedMapOutputTracker(0)


def test_sharded_tracker_stats_fold_into_the_collector_and_drop_at_unregister(registries_on):
    entry = {"kind": "map", "shuffle_id": 4, "task_id": 1, "bytes": 100, "records": 5,
             "seconds": 0.5, "origin": "elsewhere"}
    reports = []
    for t in (shard.ShardedMapOutputTracker(2), jax_shard.ShardedMapOutputTracker(2)):
        t.register_shuffle(4, 2)
        t.report_task_stats([entry, dict(entry, task_id=2)])
        rep = t.get_shuffle_stats(4)
        reports.append({k: v for k, v in rep.items() if k != "metrics"})
        t.unregister_shuffle(4)
        assert t.get_shuffle_stats(4) is None
    assert reports[0] == reports[1]
    assert (reports[0]["map_tasks"], reports[0]["bytes_written"]) == (2, 200)


# --- the service's pieces ----------------------------------------------------

def test_stage_ids_and_frames_match_jax():
    assert service.stage_id_for(7, "reduce") == jax_service.stage_id_for(7, "reduce")
    a, b = socket.socketpair()
    with a, b:
        for obj in ({"method": "x", "args": [1, None, "é", [2.5]]}, [], "s"):
            service._send_frame(a, obj)
            jax_service._send_frame(a, obj)
            assert service._recv_frame(b) == jax_service._recv_frame(b) == obj
        for pkg in (service, jax_service):
            with pytest.raises(ValueError, match="exceeds"):
                pkg._send_frame(a, "x" * (pkg._MAX_FRAME + 1))
            a.sendall(struct.pack("<I", pkg._MAX_FRAME + 1))
            with pytest.raises(IOError, match="exceeds limit"):
                pkg._recv_frame(b)
        a.sendall(struct.pack("<I", 10) + b"{}")
        a.close()
        with pytest.raises(IOError, match="mid-frame"):
            service._recv_frame(b)
        assert service._recv_frame(b) is None  # a clean close between frames


def _registry_snapshots(seed):
    rng = random.Random(seed)
    snaps = []
    for _ in range(rng.randrange(2, 5)):
        snap = {}
        for name, kind in (("a_total", "counter"), ("b_depth", "gauge"), ("c_seconds",
                                                                          "histogram")):
            if rng.random() < 0.2:
                continue
            series = []
            for lab in rng.sample(["x", "y", "z"], rng.randrange(1, 4)):
                s = {"labels": {"k": lab}}
                if kind == "histogram":
                    s.update(buckets=[rng.randrange(9) for _ in range(4)],
                             sum=rng.random(), count=rng.randrange(9))
                else:
                    s["value"] = float(rng.randrange(100))
                series.append(s)
            snap[name] = {"kind": kind, "labelnames": ["k"], "series": series}
        snaps.append(snap)
    snaps.append("not a snapshot")
    return snaps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_snapshots_merge_as_jax(seed):
    snaps = _registry_snapshots(seed)
    assert service.merge_registry_snapshots(snaps) == jax_service.merge_registry_snapshots(snaps)


def _queue_ops(queue, seed, pkg):
    """A seeded mix of task-queue calls; every answer in a list."""
    rng = random.Random(seed)
    out = []
    stages = [pkg.stage_id_for(s, p) for s in (1, 2) for p in ("map", "reduce")]
    for st in stages[:3]:
        queue.submit_stage(st, [{"task_id": i, "kind": "t"} for i in range(4)])
    workers = ["w0", "w1", "w2"]
    for _ in range(60):
        op = rng.choice(["take", "take", "complete", "fail", "retry", "reap", "lost", "can",
                         "status", "beat"])
        w, st, tid = rng.choice(workers), rng.choice(stages[:3]), rng.randrange(4)
        if op == "take":
            out.append(queue.take_task(w))
        elif op == "complete":
            out.append(queue.complete_task(st, tid, {"r": tid}, w))
        elif op == "fail":
            out.append(queue.fail_task(st, tid, "e", w))
        elif op == "retry":
            out.append(queue.retry_failed(st, tid))
        elif op == "reap":
            out.append(queue.reap_expired(st, -1.0))  # every lease is past
        elif op == "lost":
            out.append(queue.requeue_lost_all(w))
        elif op == "can":
            out.append(queue.can_commit(st, tid, w))
        elif op == "status":
            out.append(queue.stage_status(st))
        else:
            queue.heartbeat(w)
    out.append(sorted(queue.tasks_done_by("w0")))
    out.append(queue.drop_shuffle(1))
    queue.stop_workers()
    out.append(queue.take_task("w0"))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_task_queue_decides_as_jax(frozen_clock, seed):
    assert _queue_ops(service.TaskQueue(), seed, service) == \
        _queue_ops(jax_service.TaskQueue(), seed, jax_service)


@pytest.mark.parametrize("seed", [0, 1])
def test_membership_transitions_as_jax(frozen_clock, registries_on, seed):
    outs = []
    for pkg in (PORT, JAX):
        rng = random.Random(seed)
        m = pkg.service.WorkerMembership()
        out = []
        for _ in range(80):
            w = f"w{rng.randrange(5)}"
            op = rng.choice(["observe", "refresh", "drain", "leave", "expire", "state"])
            if op == "observe":
                m.observe(w)
            elif op == "refresh":
                m.refresh(w)
            elif op == "drain":
                out.append(m.request_drain(w))
            elif op == "leave":
                m.deregister(w, rng.random())
            elif op == "expire":
                out.append(m.expire_silent(-1.0 if rng.random() < 0.2 else 5.0))
            else:
                out.append((m.state_of(w), m.is_draining(w), m.live_workers()))
        out.append(m.snapshot())
        events = pkg.reg.REGISTRY.get("worker_membership_events_total")
        out.append(sorted((k, s.value) for k, s in events._series.items()))
        outs.append(out)
    assert outs[0] == outs[1]


def test_span_shards_and_fleet_view_as_jax(frozen_clock, registries_on):
    outs = []
    for pkg in (PORT, JAX):
        store = pkg.service.TraceShardStore(bytes_max=200)
        span = {"name": "storage.op", "ph": "X", "ts": 1.0, "dur": 2.0, "args": {"op": "read"}}
        got = [store.report([span]), store.report([span] * 3), store.report([]),
               store.drain(), store.drain()]
        fleet = pkg.service.FleetTelemetry()
        fleet.report("w1", {"x_total": {"kind": "counter", "series": [{"labels": {},
                                                                       "value": 2.0}]}},
                     {"a": 1, "b": 5})
        fleet.report("w0", "junk", {"a": 3})
        got.append(fleet.view())
        r = pkg.reg.REGISTRY
        got.append([r.get(n).snapshot() for n in ("trace_shard_bytes_total",
                                                  "trace_shard_drops_total",
                                                  "fleet_snapshot_age_seconds")])
        outs.append(got)
    assert outs[0] == outs[1]
    assert outs[0][0] == 1 and outs[0][1] == 0


def test_client_retries_a_lost_coordinator_as_jax():
    """Nothing listens: one free reconnect, then ``retries`` backed-off
    attempts, in both packages; ``retries=0`` fails after the free one."""
    with socket.create_server(("127.0.0.1", 0)) as s:
        addr = s.getsockname()[:2]
    results = []
    for pkg in (PORT, JAX):
        for retries in (0, 3):
            c = pkg.service.RemoteMapOutputTracker(addr, timeout=TIMEOUT, retries=retries,
                                                   retry_base_ms=1.0, retry_deadline_s=30.0)
            sleeps, connects = [], []
            c._sleep = sleeps.append
            real = c._connect
            c._connect = lambda _r=real: (connects.append(1), _r())[1]
            with pytest.raises(OSError):
                c.epoch(1)
            c.close()
            results.append((retries, len(connects), len(sleeps)))
            assert all(0 <= d <= 0.008 for d in sleeps)
    assert results[:2] == results[2:] == [(0, 2, 0), (3, 5, 3)]


def test_meta_rpc_spans_and_counters_as_jax(tmp_path, registries_on):
    got = []
    for pkg, tracer in ((PORT, trace), (JAX, jax_trace)):
        tracer.enable(str(tmp_path / f"{pkg.name}.json"), **(
            {"torch_annotations": False} if pkg is PORT else {}))
        try:
            with _server(pkg, shards=2) as srv:
                with _closing(pkg.service.RemoteMapOutputTracker(srv.address,
                                                                 timeout=TIMEOUT)) as c:
                    c.register_shuffle(1, 2)
                    c.epoch(1)
                    with pytest.raises(KeyError):
                        c.epoch(2)
            spans = [(e["name"], e["args"].get("method")) for e in tracer.events_snapshot()
                     if e.get("name") == "meta.rpc"]
        finally:
            tracer.disable()
            tracer.reset()
        rpc = pkg.reg.REGISTRY.get("meta_rpc_total")
        got.append((spans, sorted((k, s.value) for k, s in rpc._series.items())))
    assert got[0] == got[1]
    assert got[0][0] == [("meta.rpc", "register_shuffle"), ("meta.rpc", "epoch"),
                         ("meta.rpc", "epoch")]


# --- the batched client ------------------------------------------------------

def _rpc_counts(pkg):
    rpc = pkg.reg.REGISTRY.get("meta_rpc_total")
    return {k: s.value for k, s in rpc._series.items() if s.value}


def _async_script(pkg, addr):
    sizes = _sizes(seed=3, n=12)
    steps = []
    client = pkg.async_client.AsyncTrackerClient(addr, batch_max=3, timeout=TIMEOUT)
    with _closing(client):
        def step(name, result=None):
            steps.append((name, result, client.pending_registrations(), _rpc_counts(pkg)))

        step("open", client.connections)
        client.register_shuffle(5, NP)
        step("register_shuffle")
        for i in range(7):
            client.register_map_output(5, pkg.MapStatus(i, "object-store", sizes[i],
                                                        map_index=i))
            step(f"register_map_output {i}")
        step("lookup", client.get_map_sizes_by_range(5, 0, None, 0, 2))
        step("lookups", client.get_map_sizes_by_ranges(5, 2, None, [(0, 1), (3, NP)]))
        futs = [client.get_map_sizes_by_range_async(5, i, i + 2, 1, 3) for i in range(3)]
        futs.append(client.get_map_sizes_by_ranges_async(5, 0, None, [(0, 1)]))
        step("futures", [f.result(timeout=TIMEOUT) for f in futs])
        client.register_map_outputs(5, [pkg.MapStatus(i, "object-store", sizes[i],
                                                      map_index=i) for i in (7, 8)])
        step("register_map_outputs")
        client.register_map_output(5, pkg.MapStatus(9, "object-store", sizes[9], map_index=9))
        for name, args in (("contains", (5,)), ("num_partitions", (5,)),
                           ("registered_map_ids", (5,)), ("composite_locations", (5,)),
                           ("epoch", (5,)), ("shuffle_ids", ()),
                           ("report_task_stats", ([],)), ("get_shuffle_stats", (5,))):
            step(name, getattr(client, name)(*args))
        client.register_map_output(5, pkg.MapStatus(10, "object-store", sizes[10],
                                                    map_index=10))
        step("before close")
    step("closed")
    return steps


@pytest.mark.parametrize("server", ["port", "jax"])
def test_async_client_batches_and_routes_as_jax(registries_on, server):
    """RPCs by method and connection after every step, and the buffered
    registrations (the flush points), equal between the packages' clients
    against a 4-shard server with 2 shard endpoints."""
    runs = []
    for pkg in (PORT, JAX):
        with _server(PKGS[server], shards=4, shard_endpoints=2) as srv:
            runs.append(_async_script(pkg, srv.address))
    assert runs[0] == runs[1]
    steps = {name: (res, pending, counts) for name, res, pending, counts in runs[0]}
    assert steps["open"][0] == 3
    assert steps["register_map_output 2"][1] == 0  # flushed at batch_max
    assert steps["register_map_output 6"][1] == 1
    assert steps["lookup"][1] == 0  # a read flushes first
    assert steps["closed"][1] == 0  # so does close
    flushes = sum(v for (m, _s), v in steps["closed"][2].items() if m == "register_map_outputs")
    assert flushes >= 5
    assert sum(v for (m, _s), v in steps["closed"][2].items() if m == "register_map_output") == 0


@pytest.mark.parametrize("pkg_name", ["port", "jax"])
def test_async_client_rewrites_wildcard_shard_endpoints(pkg_name):
    pkg = PKGS[pkg_name]
    with _server(pkg, host="0.0.0.0", shards=2, shard_endpoints=2) as srv:
        assert all(h == "0.0.0.0" for h, _p in srv.shard_addresses)
        client = pkg.async_client.AsyncTrackerClient(("127.0.0.1", srv.address[1]),
                                                     timeout=TIMEOUT)
        with _closing(client):
            assert [c.address for c in client._conns[1:]] == [
                ("127.0.0.1", p) for _h, p in srv.shard_addresses]
            assert [c.shard_label for c in client._conns] == ["0", "1", "2"]
            client.register_shuffle(1, 2)
            assert [client.contains(1) for _ in range(3)] == [True] * 3
    # a server without endpoints: extra connections to the primary on request
    with _server(pkg, shards=1) as srv:
        with _closing(pkg.async_client.AsyncTrackerClient(srv.address, connections=3,
                                                          timeout=TIMEOUT)) as client:
            assert [c.address for c in client._conns] == [tuple(srv.address)] * 3


def _write_one_map(mgr, pkg_name, sid=0):
    jax = pkg_name == "jax"
    dep = (JaxDependency if jax else ShuffleDependency)(
        shuffle_id=sid, partitioner=(JaxHashPartitioner if jax else HashPartitioner)(PARTS))
    handle = mgr.register_shuffle(sid, dep)
    writer = mgr.get_writer(handle, 0)
    writer.write([(i, bytes([i])) for i in range(20)])
    return writer


def test_a_flush_failure_reaches_the_committing_writer_in_both_packages(tmp_path):
    """The server forgets the shuffle before a map commits: the flush the
    commit triggers (``batch_max=1``) fails, and the writer's commit raises
    it, in both packages."""
    errors = []
    for pkg_name, pkg in (("port", PORT), ("jax", JAX)):
        with _server(pkg, shards=2) as srv:
            client = pkg.async_client.AsyncTrackerClient(srv.address, batch_max=1,
                                                         timeout=TIMEOUT, retries=0)
            with _closing(client):
                root = f"file://{tmp_path / pkg_name}"
                if pkg is PORT:
                    mgr = ShuffleManager(ShuffleConfig(root_dir=root, codec="zlib"),
                                         tracker=client, device="cpu")
                else:
                    mgr = JaxManager(JaxConfig(root_dir=root, codec="zlib"), tracker=client)
                writer = _write_one_map(mgr, pkg_name)
                srv.tracker.unregister_shuffle(0)
                with pytest.raises(KeyError) as exc:
                    writer.stop(success=True)
                errors.append(str(exc.value))
                assert client.pending_registrations() == 0
    assert errors[0] == errors[1] == "\"'Shuffle 0 not registered'\""


def test_a_read_waits_for_a_flush_another_thread_has_in_flight():
    """Thread A's flush is still sending when thread B reads: the port's B
    waits for it and sees A's registrations. The JAX client's B finds the
    buffer drained and answers without them (the departure documented in
    ``AsyncTrackerClient.flush``; the RPCs are the same)."""
    seen = {}
    for pkg in (PORT, JAX):
        with _server(pkg, shards=2) as srv:
            client = pkg.async_client.AsyncTrackerClient(srv.address, timeout=TIMEOUT)
            with _closing(client):
                client.register_shuffle(1, 2)
                sending, release = threading.Event(), threading.Event()
                conn = client._conns[0]
                real = conn.register_map_outputs

                def slow(*a, _real=real):
                    sending.set()
                    release.wait(TIMEOUT)
                    return _real(*a)

                conn.register_map_outputs = slow
                client.register_map_output(1, pkg.MapStatus(0, "object-store",
                                                            np.array([3, 4]), map_index=0))
                flusher = threading.Thread(target=client.flush, name="cp-flusher")
                flusher.start()
                assert sending.wait(TIMEOUT)
                got = []
                reader = threading.Thread(
                    target=lambda: got.append(client.get_map_sizes_by_range(1, 0, None, 0, 2)),
                    name="cp-reader")
                reader.start()
                # the JAX reader answers while the flush is held; the port's
                # waits for it (alive, whether started yet or blocked)
                reader.join(TIMEOUT if pkg is JAX else 0.5)
                assert reader.is_alive() == (pkg is PORT)
                release.set()
                flusher.join(TIMEOUT)
                reader.join(TIMEOUT)
                seen[pkg.name] = got[0]
    assert seen == {"port": [(0, [(0, 3), (1, 4)])], "jax": []}


# --- end to end --------------------------------------------------------------

def _terasort_arrays(seed, n=1500):
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (16, 90), dtype=np.uint8)
    out = []
    for _ in range(MAPS):
        keys = rng.integers(0, 256, (n, 10), dtype=np.uint8)
        out.append((keys.reshape(-1), pool[rng.integers(0, 16, n)].reshape(-1)))
    return out


def _batches(arrays, cls):
    return [cls(np.full(len(k) // 10, 10, np.int32), np.full(len(v) // 90, 90, np.int32),
                k.copy(), v.copy()) for k, v in arrays]


def _objects(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            full = os.path.join(dirpath, fn)
            with open(full, "rb") as f:
                out[os.path.relpath(full, root)] = f.read()
    return out


KNOBS = dict(checksum_algorithm="CRC32C", codec_block_size=BS, codec_batch_blocks=BATCH,
             cleanup=False, encode_inflight_batches=1)


@pytest.fixture
def numpy_jax_encoder(monkeypatch):
    """The JAX side's numpy TLZ host encoder (its C encoder picks other valid
    matches: tests/test_torch_record_slice.py)."""
    monkeypatch.setattr(jax_tlz, "_encode_block_native", lambda _data: None)


def _port_terasort(root, tracker=None):
    mgr = ShuffleManager(ShuffleConfig(root_dir=f"file://{root}", **KNOBS), tracker=tracker,
                         device="cpu")
    ctx = ShuffleContext(manager=mgr, num_workers=2)
    out = ctx.sort_by_key(_batches(_terasort_arrays(7), RecordBatch), PARTS,
                          serializer=ColumnarKVSerializer(), materialize="batches",
                          cleanup=False)
    rows = [[k + v for k, v in RecordBatch.concat(list(p)).iter_records()] for p in out]
    ctx.stop()
    return rows


def _jax_terasort(root, tracker=None):
    mgr = JaxManager(JaxConfig(root_dir=f"file://{root}", codec="tpu", tpu_host_fallback=False,
                               **KNOBS), tracker=tracker)
    ctx = JaxContext(manager=mgr, num_workers=2)
    out = ctx.sort_by_key(_batches(_terasort_arrays(7), JaxRecordBatch), PARTS,
                          serializer=JaxColumnarKV(), materialize="batches", cleanup=False)
    rows = [[k + v for k, v in JaxRecordBatch.concat(list(p)).iter_records()] for p in out]
    ctx.stop()
    return rows


@pytest.mark.parametrize("server", ["jax", "port"])
def test_a_terasort_through_the_service_writes_the_local_runs_objects(tmp_path, registries_on,
                                                                     numpy_jax_encoder, server):
    """A port TeraSort whose manager's tracker is an ``AsyncTrackerClient``
    on a 4-shard server with 4 shard endpoints: its objects equal a
    local-tracker run's and the JAX package's, its rows equal theirs, and
    every reduce scan asked the tracker once."""
    local_rows = _port_terasort(tmp_path / "local")
    jax_rows = _jax_terasort(tmp_path / "jax")
    with _server(PKGS[server], shards=4, shard_endpoints=4) as srv:
        client = async_client.AsyncTrackerClient(srv.address, batch_max=64, timeout=TIMEOUT)
        with _closing(client):
            rows = _port_terasort(tmp_path / "remote", tracker=client)
            assert srv.tracker.shuffle_ids() == []  # stop() unregistered it
    assert rows == local_rows == jax_rows
    assert sum(len(p) for p in rows) == MAPS * 1500
    remote, local = _objects(tmp_path / "remote"), _objects(tmp_path / "local")
    assert remote == local == _objects(tmp_path / "jax")
    assert any(n.endswith(".data") for n in remote)
    counts = _rpc_counts(PORT)
    by_method = {}
    for (method, _shard), v in counts.items():
        by_method[method] = by_method.get(method, 0) + v
    assert by_method["get_map_sizes_by_ranges"] == PARTS  # one lookup per reduce scan
    assert "get_map_sizes_by_range" not in by_method
    assert by_method["register_map_outputs"] >= 1 and "register_map_output" not in by_method


class _Counting:
    """Counts every call of a tracker method by name, in either package."""

    def __init__(self, inner):
        self._inner = inner
        self.calls = []

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if not callable(attr):
            return attr

        def counted(*a, **k):
            self.calls.append(name)
            return attr(*a, **k)

        return counted


def test_the_reader_asks_once_per_scan_in_the_batch_form_like_jax(tmp_path, numpy_jax_encoder):
    port = _Counting(map_output.MapOutputTracker())
    jax = _Counting(jax_map_output.MapOutputTracker())
    assert _port_terasort(tmp_path / "port", tracker=port) == _jax_terasort(tmp_path / "jax",
                                                                            tracker=jax)
    lookups = [[c for c in t.calls if c.startswith("get_map_sizes")] for t in (port, jax)]
    assert lookups[0] == lookups[1] == ["get_map_sizes_by_ranges"] * PARTS
    assert port.calls == jax.calls


# --- the config knobs ---------------------------------------------------------

KNOB_DEFAULTS = {"metadata_shards": 4, "metadata_shard_endpoints": 0,
                 "metadata_batch_max": 64, "metadata_snapshots": True}


def test_control_plane_knobs_default_as_jax():
    port, jax = ShuffleConfig(), JaxConfig()
    assert {k: getattr(port, k) for k in KNOB_DEFAULTS} == KNOB_DEFAULTS == \
        {k: getattr(jax, k) for k in KNOB_DEFAULTS}


@pytest.mark.parametrize("bad", [{"metadata_shards": 0}, {"metadata_batch_max": 0},
                                 {"metadata_shard_endpoints": -1},
                                 {"metadata_shards": -3, "metadata_batch_max": 2}])
def test_control_plane_knobs_validate_as_jax(bad):
    with pytest.raises(ValueError) as port_err:
        ShuffleConfig(**bad)
    with pytest.raises(ValueError) as jax_err:
        JaxConfig(**bad)
    assert str(port_err.value) == str(jax_err.value)


def test_control_plane_knobs_read_from_dict_and_env_as_jax():
    d = {"metadata_shards": "7", "metadata_shard_endpoints": "3", "metadata_batch_max": "1k",
         "metadata_snapshots": "false"}
    env = {"S3SHUFFLE_" + k.upper(): v for k, v in d.items()}
    for port, jax in ((ShuffleConfig.from_dict(d), JaxConfig.from_dict(d)),
                      (ShuffleConfig.from_env(env), JaxConfig.from_env(env))):
        got = {k: getattr(port, k) for k in KNOB_DEFAULTS}
        assert got == {k: getattr(jax, k) for k in KNOB_DEFAULTS}
        assert got == {"metadata_shards": 7, "metadata_shard_endpoints": 3,
                       "metadata_batch_max": 1024, "metadata_snapshots": False}


@pytest.mark.parametrize("knobs", [{}, {"metadata_shards": 1, "metadata_batch_max": 1},
                                   {"metadata_shards": 7, "metadata_shard_endpoints": 3,
                                    "metadata_batch_max": 5}])
def test_servers_and_clients_from_config_are_sized_as_jax_coordinators_size_theirs(knobs):
    """``MetadataServer.from_config`` and ``AsyncTrackerClient.from_config``
    read the knobs as the JAX package's coordinator and workers do
    (``cluster.py``: ``MetadataServer(shards=..., shard_endpoints=...)``,
    ``AsyncTrackerClient(addr, batch_max=...)``)."""
    cfg, jax_cfg = ShuffleConfig(**knobs), JaxConfig(**knobs)
    port_srv = service.MetadataServer.from_config(cfg).start()
    jax_srv = jax_service.MetadataServer(shards=jax_cfg.metadata_shards,
                                         shard_endpoints=jax_cfg.metadata_shard_endpoints).start()
    try:
        assert port_srv.tracker.num_shards == jax_srv.tracker.num_shards == cfg.metadata_shards
        assert len(port_srv.shard_addresses) == len(jax_srv.shard_addresses) == \
            cfg.metadata_shard_endpoints
        with _closing(async_client.AsyncTrackerClient.from_config(
                port_srv.address, cfg, timeout=TIMEOUT)) as port_client, \
                _closing(jax_async.AsyncTrackerClient(jax_srv.address,
                                                      batch_max=jax_cfg.metadata_batch_max,
                                                      timeout=TIMEOUT)) as jax_client:
            assert port_client.batch_max == jax_client.batch_max == cfg.metadata_batch_max
            assert port_client.connections == jax_client.connections == \
                1 + cfg.metadata_shard_endpoints
    finally:
        port_srv.stop()
        jax_srv.stop()
