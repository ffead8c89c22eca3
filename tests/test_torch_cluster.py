"""The port's worker agent, cluster driver and local cluster (``worker.py``,
``cluster.py``) and the process dispatcher (``Dispatcher.get`` /
``reset``) against the JAX package's, on the CPU.

- Descriptors and input objects: ``dep_to_descriptor`` gives the JAX JSON
  for each partitioner and serializer and each package reads the other's;
  ``write_input_object`` writes the JAX bytes.
- ``Dispatcher.get`` / ``reset``: the same sharing, private dispatchers and
  eviction as the JAX registry, step for step.
- Across packages: a JAX ``DistributedDriver`` served by one port
  ``WorkerAgent(device="cpu")``, a port driver served by one JAX agent and
  an all-port run each write the objects of an all-JAX run, byte for byte,
  under zlib and TLZ; the requests the agent sends, in order, are the JAX
  agent's, as a relay between agent and coordinator records them.
- The fleet: a hung worker's task reaped and run by a spawned live agent;
  ``LocalCluster.run_shuffle`` on spawned pools; the ``MetricsServer``
  text equal to the JAX worker's, colliding names included.
"""

import contextlib
import json
import socket
import struct
import threading
import time
import urllib.request

import pytest

from s3shuffle_tpu.ops import tlz as jax_tlz
from torch_fleet_support import (  # noqa: F401  (fixtures)
    JAX,
    JOIN_S,
    PKGS,
    PORT,
    batches,
    clean_planes,
    config,
    file_hygiene,
    make_agent,
    objects,
    records,
    registries_on,
    sorted_records,
    spawned_agents,
    wait_registered,
)
from torch_jax_native import jax_native_library  # noqa: F401  (loads the JAX oracle's native library)


# --- descriptors and input objects --------------------------------------------

def _dep(pkg, partitioner, serializer, sort, frames=None, batch_records=None):
    d = pkg.dependency
    part = (d.RangePartitioner([b"b", b"m\x00x", b"\xff\x01"]) if partitioner == "range"
            else d.HashPartitioner(5))
    ser = pkg.serializer.get_serializer(serializer)
    if frames is not None:
        ser.column_frames = frames
    if batch_records is not None:
        ser.batch_records = batch_records
    return d.ShuffleDependency(7, part, serializer=ser,
                               key_ordering=d.natural_key if sort else None)


DESCRIPTOR_CASES = [
    (part, ser, sort, frames, batch_records)
    for part in ("range", "hash")
    for ser in ("pickle", "bytes-kv", "bytes-kv-columnar")
    for sort in (False, True)
    for frames, batch_records in ((None, None), (False, 1024), (True, None))
    if ser == "bytes-kv-columnar" or (frames, batch_records) == (None, None)
]


@pytest.mark.parametrize("case", DESCRIPTOR_CASES, ids=lambda c: "-".join(map(str, c)))
def test_descriptors_are_the_jax_json_and_read_back_both_ways(case):
    port_desc = PORT.worker.dep_to_descriptor(_dep(PORT, *case))
    jax_desc = JAX.worker.dep_to_descriptor(_dep(JAX, *case))
    assert json.dumps(port_desc, sort_keys=True) == json.dumps(jax_desc, sort_keys=True)
    for reader in PKGS.values():
        for desc in (port_desc, jax_desc):
            dep = reader.worker.dep_from_descriptor(7, json.loads(json.dumps(desc)))
            assert dep.num_partitions == (4 if case[0] == "range" else 5)
            assert dep.serializer.name == desc["serializer"]
            assert (dep.key_ordering is reader.dependency.natural_key) == case[2]
            assert reader.worker.dep_to_descriptor(dep) == desc
            if case[0] == "range":
                assert dep.partitioner.bounds == [b"b", b"m\x00x", b"\xff\x01"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_input_objects_are_the_jax_bytes(tmp_path, seed):
    recs = records(seed, 300 + 100 * seed, key=10, value=90)
    paths = {}
    for name, pkg in PKGS.items():
        disp = pkg.Dispatcher(config(pkg, tmp_path / name))
        paths[name] = f"file://{tmp_path}/{name}/input"
        pkg.worker.write_input_object(disp.backend, paths[name],
                                      pkg.batch.RecordBatch.from_records(recs))
        back = pkg.worker.read_input_batches(disp.backend, paths[name])
        assert [kv for b in back for kv in b.to_records()] == recs
    blobs = {name: (tmp_path / name / "input").read_bytes() for name in PKGS}
    assert blobs["port"] == blobs["jax"]


def test_a_worker_rejects_a_partitioner_with_no_descriptor():
    dep = PORT.dependency.ShuffleDependency(1, PORT.dependency.HashPartitioner(2))
    dep.partitioner = object()
    with pytest.raises(ValueError, match="no JSON descriptor"):
        PORT.worker.dep_to_descriptor(dep)
    with pytest.raises(ValueError, match="unknown partitioner kind"):
        PORT.worker.dep_from_descriptor(1, {"partitioner": {"kind": "round-robin"}})


# --- the process dispatcher ---------------------------------------------------

def _registry_script(pkg, root, monkeypatch):
    """Ids of the dispatchers ``Dispatcher.get`` hands out over one script:
    first-wins, equal configs shared, others private and memoized (LRU 16),
    ``None`` from the environment, and ``reset``."""
    D = pkg.Dispatcher
    D.reset()
    monkeypatch.setenv("S3SHUFFLE_ROOT_DIR", f"file://{root}/env")
    cfgs = [pkg.Config(root_dir=f"file://{root}/c{i}") for i in range(20)]
    seen, names, kept = [], {}, []

    def name(d):
        kept.append(d)  # alive, so no later dispatcher takes its id
        names.setdefault(id(d), len(names))
        return names[id(d)]

    first = D.get(cfgs[0])
    seen.append(name(first))
    seen.append(name(D.get()))  # None: the singleton
    seen.append(name(D.get(pkg.Config(root_dir=f"file://{root}/c0"))))  # equal: shared
    seen += [name(D.get(c)) for c in cfgs[1:18]]  # 17 private: the oldest evicted
    seen.append(name(D.get(cfgs[1])))  # evicted: a new one
    seen.append(name(D.get(cfgs[17])))  # still there
    seen.append(D.get().config.root_dir == cfgs[0].root_dir)
    D.reset()
    env_first = D.get()  # None first: the environment's config
    seen.append(env_first.config.root_dir == f"file://{root}/env/")
    seen.append(name(D.get(cfgs[0])) != name(first))
    D.reset()
    return seen


def test_the_process_dispatcher_hands_out_what_jax_does(tmp_path, monkeypatch):
    assert _registry_script(PORT, tmp_path, monkeypatch) == \
        _registry_script(JAX, tmp_path, monkeypatch)


@pytest.mark.parametrize("explicit", [False, True])
def test_a_manager_takes_the_process_dispatcher_as_jax(tmp_path, explicit):
    from s3shuffle_tpu.manager import ShuffleManager as JaxManager
    from s3shuffle_tpu_torch import ShuffleManager

    cfg = config(PORT, tmp_path, codec="zlib")
    jcfg = config(JAX, tmp_path, codec="zlib")
    managers = {
        "port": [ShuffleManager(cfg, device="cpu"), ShuffleManager(cfg, device="cpu")],
        "jax": [JaxManager(jcfg), JaxManager(jcfg)],
    }
    if explicit:
        d = PORT.Dispatcher(cfg)
        managers["port"].append(ShuffleManager(dispatcher=d, device="cpu"))
        jd = JAX.Dispatcher(jcfg)
        managers["jax"].append(JaxManager(dispatcher=jd))
    shapes = {name: [ms[0].dispatcher is m.dispatcher for m in ms]
              for name, ms in managers.items()}
    assert shapes["port"] == shapes["jax"] == ([True, True, False] if explicit else [True, True])
    assert managers["port"][0].dispatcher is PORT.Dispatcher.get(cfg)


def test_get_reader_reads_through_the_tracker_it_is_given(tmp_path):
    from s3shuffle_tpu_torch import ShuffleManager
    from s3shuffle_tpu_torch.metadata.map_output import MapOutputTracker

    mgr = ShuffleManager(config(PORT, tmp_path, codec="zlib"), device="cpu")
    dep = PORT.dependency.ShuffleDependency(0, PORT.dependency.HashPartitioner(2))
    handle = mgr.register_shuffle(0, dep)
    w = mgr.get_writer(handle, 0)
    w.write(records(3, 50))
    w.stop(success=True)
    empty = MapOutputTracker()
    empty.register_shuffle(0, 2)
    assert mgr.get_reader(handle, 0, 2, tracker=empty).tracker is empty
    assert list(mgr.get_reader(handle, 0, 2, tracker=empty).read()) == []
    assert sorted(mgr.get_reader(handle, 0, 2).read()) == sorted(records(3, 50))


# --- one agent serving another package's driver -------------------------------

class _Relay:
    """A TCP relay for one agent connection that keeps the bytes each way."""

    def __init__(self, target):
        self.target = target
        self._listener = socket.create_server(("127.0.0.1", 0))
        self.address = self._listener.getsockname()[:2]
        self.up, self.down = bytearray(), bytearray()
        self._sockets = []
        self._threads = [threading.Thread(target=self._accept, name="fleet-relay", daemon=True)]
        self._threads[0].start()

    def _accept(self):
        try:
            conn, _addr = self._listener.accept()
        except OSError:
            return
        upstream = socket.create_connection(self.target, timeout=JOIN_S)
        self._sockets = [conn, upstream]
        for src, dst, buf in ((conn, upstream, self.up), (upstream, conn, self.down)):
            t = threading.Thread(target=self._pump, args=(src, dst, buf),
                                 name="fleet-relay-pump", daemon=True)
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
            t.join(JOIN_S)
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


def _requests(relay, root):
    """The agent's requests in order, without the polls answered "wait"
    (their number follows the clock), with this run's root made generic."""
    ups, downs = _frames(relay.up), _frames(relay.down)
    assert len(ups) == len(downs)
    kept = []
    for req, resp in zip(ups, downs):
        if json.loads(req)["method"] == "q_take_task" and \
                json.loads(resp).get("result", {}).get("action") == "wait":
            continue
        kept.append(req.decode().replace(str(root), "<root>"))
    return kept


def _fleet_job(tmp_path, run, driver_pkg, agent_pkg, codec):
    """One TeraSort-shaped job of ``driver_pkg``'s driver served by one
    ``agent_pkg`` agent polling through a relay; returns its objects (the
    snapshot aside), its sorted output records and the agent's requests."""
    root = tmp_path / run
    recs = records(11, 1200, key=10, value=90)
    driver_cfg = config(driver_pkg, root, codec=codec, cleanup=False,
                        encode_inflight_batches=1)
    agent_cfg = config(agent_pkg, root, codec=codec, cleanup=False, encode_inflight_batches=1)
    driver = driver_pkg.cluster.DistributedDriver(driver_cfg)
    relay = _Relay(driver.coordinator_address)
    agent = None
    try:
        agent = make_agent(agent_pkg, relay.address, agent_cfg, "w0")
        stop = threading.Event()

        def loop():
            while not stop.is_set():
                if agent.run_once() in ("stop", "drain"):
                    return
                time.sleep(0.005)

        thread = threading.Thread(target=loop, name="fleet-agent-loop", daemon=True)
        thread.start()
        try:
            out = driver.run_sort_shuffle(batches(driver_pkg, recs, 4), num_partitions=3)
        finally:
            driver.server.task_queue.stop_workers()
            thread.join(JOIN_S)
            stop.set()
        assert not thread.is_alive()
    finally:
        if agent is not None:
            agent.close()
        relay.close()
        driver.shutdown(remove_root=False)
    got = sorted_records(out)
    assert got == sorted(recs)
    objs = {k: v for k, v in objects(root).items() if not k.endswith(".snapmeta")}
    return objs, got, _requests(relay, root)


@pytest.fixture
def numpy_jax_encoder(monkeypatch):
    """The JAX side's numpy TLZ host encoder (its C encoder picks other valid
    matches: tests/test_torch_record_slice.py)."""
    monkeypatch.setattr(jax_tlz, "_encode_block_native", lambda _data: None)


@pytest.mark.parametrize("codec", ["zlib", "tpu"])
@pytest.mark.parametrize("pair", ["jax-driver-port-agent", "port-driver-jax-agent",
                                  "port-driver-port-agent"])
def test_an_agent_of_either_package_writes_the_all_jax_runs_objects(tmp_path, numpy_jax_encoder,
                                                                    pair, codec):
    driver_pkg, agent_pkg = PKGS[pair.split("-")[0]], PKGS[pair.split("-")[2]]
    base_objs, base_rows, base_reqs = _fleet_job(tmp_path, "jax-jax", JAX, JAX, codec)
    objs, rows, reqs = _fleet_job(tmp_path, pair, driver_pkg, agent_pkg, codec)
    assert rows == base_rows
    assert sorted(objs) == sorted(base_objs)
    for kind in (".data", ".index", ".checksum", "input_", "output_"):
        assert any(kind in name for name in objs), (kind, sorted(objs))
    assert objs == base_objs
    methods = [json.loads(r)["method"] for r in reqs]
    assert methods == [json.loads(r)["method"] for r in base_reqs]
    assert methods[:2] == ["check_format", "q_register_worker"]
    assert reqs == base_reqs


# --- the fleet ------------------------------------------------------------------

def test_the_driver_reaps_a_hung_workers_task_for_a_spawned_agent(tmp_path):
    """A worker takes a map task and never finishes it: the driver's stage
    wait reaps the lease and a live agent (a spawned process) runs the task
    again; the job completes with every record."""
    cfg = config(PORT, tmp_path, codec="zlib")
    recs = records(4, 2000)
    driver = PORT.cluster.DistributedDriver(cfg)
    driver.task_lease_s = 3.0
    thief = PORT.service.RemoteMapOutputTracker(driver.coordinator_address)
    stolen = []
    try:
        with spawned_agents(driver, cfg, ["live"]) as procs:
            wait_registered(driver, ["live"], procs)
            ready = threading.Event()

            def steal_once():
                deadline = time.monotonic() + JOIN_S
                while time.monotonic() < deadline:
                    t = thief.take_task("hung-worker")
                    if t["action"] == "run":
                        stolen.append(t["task"]["task_id"])
                        return  # never completed: a hang
                    ready.set()
                    time.sleep(0.005)

            # the thief polls first, so it takes the first map task
            stealer = threading.Thread(target=steal_once, name="fleet-thief", daemon=True)
            stealer.start()
            ready.wait(JOIN_S)
            out = driver.run_sort_shuffle(batches(PORT, recs, 2), num_partitions=3)
            stealer.join(JOIN_S)
            assert sorted_records(out) == sorted(recs)
            assert len(stolen) == 1
            events = [e["event"] for e in driver.server.membership.snapshot()["events"]
                      if e["worker"] == "hung-worker"]
            assert events[0] == "join" and "expire" in events, events
    finally:
        thief.close()
        driver.shutdown()


def make_sort_dep(shuffle_id: int):
    """The local cluster's dependency (module level: it is pickled)."""
    d = PORT.dependency
    return d.ShuffleDependency(shuffle_id=shuffle_id,
                               partitioner=d.RangePartitioner([bytes([64]), bytes([128]),
                                                               bytes([192])]),
                               serializer=PORT.serializer.ColumnarKVSerializer(),
                               key_ordering=d.natural_key)


def test_a_local_cluster_shuffles_on_spawned_pools_as_jax_in_process(tmp_path):
    """``LocalCluster.run_shuffle`` of 3 × 500 records on two spawned pools
    (the map workers are gone when the reducers read): each partition's
    records are the JAX package's, for the same range partitioner."""
    parts = [records(30 + i, 500, key=6, value=20) for i in range(3)]
    cluster = PORT.cluster.LocalCluster(config(PORT, tmp_path / "port", codec="zlib"),
                                        num_workers=2, device="cpu")
    try:
        out = cluster.run_shuffle(parts, make_sort_dep)
    finally:
        cluster.shutdown()
    j = JAX.dependency
    with JAX.Context(config=config(JAX, tmp_path / "jax", codec="zlib"),
                     num_workers=1) as ctx:
        expected = ctx.run_shuffle(
            parts, partitioner=j.RangePartitioner([bytes([64]), bytes([128]), bytes([192])]),
            key_ordering=j.natural_key, serializer=JAX.serializer.ColumnarKVSerializer())
    assert [len(p) for p in out] == [len(p) for p in expected]
    for got, want in zip(out, expected):
        assert [k for k, _v in got] == sorted(k for k, _v in want)
        assert sorted(got) == sorted(want)
    assert sum(len(p) for p in out) == 1500


# --- the metrics endpoint ---------------------------------------------------------

@pytest.mark.parametrize("worker_id", ["w-metrics", 'w"quoted\\', "w\nline"])
def test_the_metrics_text_is_the_jax_workers(tmp_path, registries_on, worker_id):
    srv = PORT.service.MetadataServer().start()
    servers, agents = [], []
    try:
        for pkg in (PORT, JAX):
            agent = make_agent(pkg, srv.address, config(pkg, tmp_path / pkg.name), worker_id)
            agents.append(agent)
            servers.append(pkg.worker.MetricsServer(agent, host="127.0.0.1", port=0))
        for pkg in (PORT, JAX):
            # the agents' joins counted in the server's registry only
            pkg.reg.REGISTRY.reset_values()
        for pkg in (PORT, JAX):
            kw = {"torch_annotations": False} if pkg is PORT else {"jax_annotations": False}
            pkg.trace.enable(str(tmp_path / f"{pkg.name}.json"), **kw)
            # names that sanitize alike merge, the tasks counter's included
            pkg.trace.count("dedup.check", 3)
            pkg.trace.count("dedup/check", 4)
            pkg.trace.count("tasks.run.total", 2)
            lost = pkg.recovery.LostMap(shuffle_id=0, map_id=0, map_index=0, lost_bytes=10,
                                        parity_segments=1, composite_group=-1,
                                        index_present=True)
            pkg.recovery.RecoveryPlanner(1).decide(lost)
        port_text, jax_text = (s.render() for s in servers)
        assert port_text == jax_text
        assert port_text.count("# TYPE s3shuffle_dedup_check counter") == 1
        assert "s3shuffle_recovery_decisions_total" in port_text
    finally:
        for s in servers:
            s.stop()
        for a in agents:
            a.close()
        srv.stop()


def test_the_metrics_endpoint_answers_scrapes(tmp_path):
    srv = PORT.service.MetadataServer().start()
    try:
        agent = make_agent(PORT, srv.address, config(PORT, tmp_path), "w-http")
        metrics = PORT.worker.MetricsServer(agent, host="127.0.0.1", port=0).start()
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{metrics.port}/metrics",
                                        timeout=JOIN_S) as resp:
                body = resp.read().decode()
            assert 's3shuffle_tasks_run_total{worker="w-http"} 0' in body
            with urllib.request.urlopen(f"http://127.0.0.1:{metrics.port}/healthz",
                                        timeout=JOIN_S) as resp:
                assert resp.status == 200
            with pytest.raises(urllib.error.HTTPError) as missing:
                urllib.request.urlopen(f"http://127.0.0.1:{metrics.port}/nope", timeout=JOIN_S)
            missing.value.close()
            assert missing.value.code == 404
        finally:
            metrics.stop()
            agent.close()
    finally:
        srv.stop()


def test_the_worker_knobs_default_validate_and_read_as_jax():
    for pkg in PKGS.values():
        cfg = pkg.Config()
        assert (cfg.worker_lease_s, cfg.drain_on_sigterm) == (30.0, True)
        with pytest.raises(ValueError, match="worker_lease_s"):
            pkg.Config(worker_lease_s=0)
        got = pkg.Config.from_dict({"worker_lease_s": "2.5", "drain_on_sigterm": "off"})
        assert (got.worker_lease_s, got.drain_on_sigterm) == (2.5, False)
        env = pkg.Config.from_env({"S3SHUFFLE_WORKER_LEASE_S": "7",
                                   "S3SHUFFLE_DRAIN_ON_SIGTERM": "0"})
        assert (env.worker_lease_s, env.drain_on_sigterm) == (7.0, False)
    driver = PORT.cluster.DistributedDriver(PORT.Config(worker_lease_s=2.0))
    try:
        assert driver.task_lease_s == 2.0
    finally:
        driver.shutdown(remove_root=False)


def test_a_worker_honours_the_connect_timeout(monkeypatch):
    """No coordinator: the agent retries its connect until
    ``S3SHUFFLE_WORKER_CONNECT_TIMEOUT_S`` runs out, then raises."""
    probe = socket.create_server(("127.0.0.1", 0))
    addr = probe.getsockname()[:2]
    probe.close()
    monkeypatch.setenv("S3SHUFFLE_WORKER_CONNECT_TIMEOUT_S", "0.5")
    t0 = time.monotonic()
    with pytest.raises(OSError):
        PORT.worker.WorkerAgent(addr, config=PORT.Config(), worker_id="nobody", device="cpu")
    assert time.monotonic() - t0 >= 0.5
