"""The port's elastic fleet against the JAX package's, on the CPU: the same
scenario runs in each package and the outcomes compare equal.

- Drain: an agent with an open composite group asked to drain seals it,
  sends the deferred report, deregisters; nothing is requeued. A local drain
  request (the SIGTERM handler) drains without another poll; a real SIGTERM
  to ``python -m s3shuffle_tpu_torch.worker`` drains and exits 0, or kills
  the worker when ``drain_on_sigterm`` is off.
- Zombies: an attempt reaped between its commit fence and its report is
  refused, and its objects (parity included) are deleted; a zombie
  composite member never registers and the shared object survives.
- Composite commits and the coded plane under a driver: reports deferred
  until the group seals, the driver compacting between the barriers,
  parity counts riding deferred registrations, and the sort-by-key race
  with a slow fat-index PUT.
- One merged trace: a traced driver and two spawned traced agents give one
  trace whose worker spans link to the driver's job across processes.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from torch_fleet_support import (  # noqa: F401  (fixtures)
    JAX,
    JOIN_S,
    PKGS,
    PORT,
    batches,
    clean_planes,
    config,
    counter_total,
    file_hygiene,
    make_agent,
    records,
    registries_on,
    sorted_records,
    spawned_agents,
    thread_agents,
    wait_registered,
)
from torch_jax_native import jax_native_library  # noqa: F401  (loads the JAX oracle's native library)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stage_map_inputs(pkg, server, disp, shuffle_id, parts, scratch):
    """Register a shuffle and stage its inputs; returns the map tasks."""
    dep = pkg.dependency.ShuffleDependency(
        shuffle_id=shuffle_id, partitioner=pkg.dependency.HashPartitioner(2),
        serializer=pkg.serializer.ColumnarKVSerializer())
    desc = pkg.worker.dep_to_descriptor(dep)
    server.tracker.register_shuffle(shuffle_id, dep.num_partitions)
    tasks = []
    for m, recs in enumerate(parts):
        path = f"{scratch}/input_{m}"
        pkg.worker.write_input_object(disp.backend, path,
                                      pkg.batch.RecordBatch.from_records(recs))
        tasks.append({"task_id": m, "kind": "map", "shuffle_id": shuffle_id, "map_id": m,
                      "dep": desc, "input_path": path})
    return tasks


def _both(scenario, tmp_path, *args):
    """``scenario(pkg, root, *args)`` in each package; the outcomes equal."""
    got = {name: scenario(pkg, tmp_path / name, *args) for name, pkg in PKGS.items()}
    assert got["port"] == got["jax"]
    return got["port"]


# --- drain ------------------------------------------------------------------------

def _drain_with_open_group(pkg, root):
    cfg = config(pkg, root / "store", codec="zlib", composite_commit_maps=4,
                 composite_flush_ms=0)
    server = pkg.service.MetadataServer().start()
    agent = None
    try:
        agent = make_agent(pkg, server.address, cfg, "w-drain")
        tasks = _stage_map_inputs(pkg, server, agent.manager.dispatcher, 0,
                                  [records(5, 50, 6, 12)], f"file://{root}/stage")
        stage = pkg.service.stage_id_for(0, "map")
        server.task_queue.submit_stage(stage, tasks)
        out = [agent.run_once()]
        st = server.task_queue.stage_status(stage)
        out.append((st["running"], bool(st["done"]), len(agent._pending_composite)))
        out.append(server.membership.request_drain("w-drain"))
        out.append(agent.run_once())
        st = server.task_queue.stage_status(stage)
        out.append((st["running"], sorted(st["done"]), bool(st["failed"]),
                    len(agent._pending_composite), server.tracker.registered_map_ids(0),
                    server.membership.state_of("w-drain")))
        snap = pkg.reg.REGISTRY.snapshot(compact=True)
        out.append((counter_total(pkg.reg.REGISTRY, "task_requeues_total"),
                    snap["worker_drain_seconds"]["series"][0]["count"]))
        return out
    finally:
        if agent is not None:
            agent.close()
        server.stop()


def test_a_drain_seals_the_open_group_and_reports_its_members(tmp_path, registries_on):
    out = _both(_drain_with_open_group, tmp_path)
    assert out[0] == "run" and out[1] == (1, False, 1)
    assert out[3] == "drain"
    assert out[4] == (0, [0], False, 0, [0], "left")
    assert out[5] == (0, 1)


def _local_drain_request(pkg, root):
    server = pkg.service.MetadataServer().start()
    agent = None
    try:
        agent = make_agent(pkg, server.address, config(pkg, root / "store"), "w-sig")
        server.task_queue.submit_stage("s", [{"task_id": 0, "kind": "noop"}])
        agent.request_drain()
        return [agent.run_once(), server.task_queue.stage_status("s")["pending"],
                server.membership.state_of("w-sig")]
    finally:
        if agent is not None:
            agent.close()
        server.stop()


def test_a_local_drain_request_drains_without_another_poll(tmp_path):
    assert _both(_local_drain_request, tmp_path) == ["drain", 1, "left"]


@pytest.mark.parametrize("drain_on_sigterm", [True, False], ids=["drains", "dies"])
def test_sigterm_to_a_worker_process(tmp_path, drain_on_sigterm):
    """``python -m s3shuffle_tpu_torch.worker --device cpu``: SIGTERM drains
    it at its next task boundary (it deregisters and exits 0), or, with
    ``drain_on_sigterm`` off, ends it there and then."""
    server = PORT.service.MetadataServer().start()
    env = dict(os.environ, S3SHUFFLE_ROOT_DIR=f"file://{tmp_path}/store",
               S3SHUFFLE_DRAIN_ON_SIGTERM="1" if drain_on_sigterm else "0",
               PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "s3shuffle_tpu_torch.worker", "--coordinator",
         "%s:%d" % server.address, "--device", "cpu", "--worker-id", "w-term",
         "--metrics-port", "0"],
        env=env, cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + JOIN_S
        while server.membership.state_of("w-term") != "active":
            assert proc.poll() is None, f"the worker exited: {proc.returncode}"
            assert time.monotonic() < deadline, "the worker never registered"
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(JOIN_S)
        events = [e["event"] for e in server.membership.snapshot()["events"]
                  if e["worker"] == "w-term"]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(JOIN_S)
        server.stop()
    if drain_on_sigterm:
        assert code == 0 and events == ["join", "leave"], (code, events)
    else:
        assert code == -signal.SIGTERM and events == ["join"], (code, events)


# --- zombies ------------------------------------------------------------------------

def _reap_between_fence_and_commit(agent, server):
    """The agent's commit fence passes, then its lease is reaped at once:
    objects get written and the report must be refused."""
    real = agent._commit_allowed

    def fence(stage_id, task):
        ok = real(stage_id, task)
        server.task_queue.reap_expired(stage_id, 0.0)
        return ok

    agent._commit_allowed = fence


def _zombie_singleton(pkg, root):
    cfg = config(pkg, root / "store", codec="zlib", parity_segments=1, parity_stripe_k=1,
                 parity_chunk_bytes=2048)
    server = pkg.service.MetadataServer().start()
    agents = []
    try:
        zombie = make_agent(pkg, server.address, cfg, "zombie")
        agents.append(zombie)
        live = make_agent(pkg, server.address, cfg, "live")
        agents.append(live)
        tasks = _stage_map_inputs(pkg, server, zombie.manager.dispatcher, 0,
                                  [records(9, 200, 6, 12)], f"file://{root}/stage")
        stage = pkg.service.stage_id_for(0, "map")
        server.task_queue.submit_stage(stage, tasks)
        _reap_between_fence_and_commit(zombie, server)
        out = [zombie.run_once(), server.tracker.registered_map_ids(0)]
        st = server.task_queue.stage_status(stage)
        out.append((bool(st["done"]), st["pending"],
                    server.task_queue.can_commit(stage, 0, "zombie")))
        d, b = zombie.manager.dispatcher, pkg.block_ids
        out.append([d.backend.exists(d.get_path(block)) for block in (
            b.ShuffleDataBlockId(0, 0), b.ShuffleIndexBlockId(0, 0),
            b.ShuffleChecksumBlockId(0, 0, algorithm=cfg.checksum_algorithm),
            b.ShuffleParityBlockId(0, 0, 0))])
        out += [live.run_once(), server.tracker.registered_map_ids(0),
                bool(server.task_queue.stage_status(stage)["done"])]
        return out
    finally:
        for a in agents:
            a.close()
        server.stop()


def test_a_zombie_singleton_attempt_is_refused_and_swept_with_its_parity(tmp_path,
                                                                        registries_on):
    assert _both(_zombie_singleton, tmp_path) == \
        ["run", [], (False, 1, False), [False] * 4, "run", [1], True]


def _zombie_composite(pkg, root):
    cfg = config(pkg, root / "store", codec="zlib", composite_commit_maps=4,
                 composite_flush_ms=0)
    server = pkg.service.MetadataServer().start()
    agents = []
    try:
        zombie = make_agent(pkg, server.address, cfg, "zombie")
        agents.append(zombie)
        live = make_agent(pkg, server.address, cfg, "live")
        agents.append(live)
        tasks = _stage_map_inputs(pkg, server, zombie.manager.dispatcher, 0,
                                  [records(10, 100, 6, 12)], f"file://{root}/stage")
        stage = pkg.service.stage_id_for(0, "map")
        server.task_queue.submit_stage(stage, tasks)
        _reap_between_fence_and_commit(zombie, server)
        out = [zombie.run_once()]
        zombie.drain()  # seals the group, then its report is refused
        out.append(server.tracker.registered_map_ids(0))
        out.append(zombie.manager.dispatcher.list_composite_groups(0))
        st = server.task_queue.stage_status(stage)
        out.append((bool(st["done"]), st["pending"]))
        out.append(live.run_once())
        live.drain()
        out += [server.tracker.registered_map_ids(0),
                bool(server.task_queue.stage_status(stage)["done"])]
        return out
    finally:
        for a in agents:
            a.close()
        server.stop()


def test_a_zombie_composite_member_never_registers_and_the_shared_object_survives(tmp_path):
    assert _both(_zombie_composite, tmp_path) == ["run", [], [0], (False, 1), "run", [1], True]


# --- composites and parity under a driver -----------------------------------------

def _driver_job(pkg, root, knobs, maps, n, parts=3, agents=2):
    cfg = config(pkg, root / "store", codec="zlib", **knobs)
    recs = records(7, n)
    driver = pkg.cluster.DistributedDriver(cfg)
    try:
        with thread_agents(pkg, driver, cfg, agents):
            out = driver.run_sort_shuffle(batches(pkg, recs, maps), num_partitions=parts)
        d = driver.dispatcher
        singles, groups = d.list_committed_outputs(0)
        tombs = [st.path for prefix in d._shuffle_prefixes(0)
                 for st in d.backend.list_prefix(prefix)
                 if pkg.block_ids.parse_tombstone_name(st.path)]
        statuses = driver.server.tracker.deduped_statuses(0)
        facts = {"rows_ok": sorted_records(out) == sorted(recs),
                 "groups": bool(d.list_composite_groups(0)),
                 "singles": len(singles), "composite_groups": bool(groups),
                 "tombstones": bool(tombs),
                 "parity": sorted({s.parity_segments for _i, s in statuses}),
                 "composite_members": sorted({s.composite_group >= 0 for _i, s in statuses})}
    finally:
        driver.shutdown(remove_root=True)
    return facts


def test_distributed_agents_defer_reports_until_the_group_seals(tmp_path):
    """Composite commits under a driver: a map's report (its registration)
    waits for its group's seal, and the empty queue seals the last group."""
    facts = _both(_driver_job, tmp_path, dict(composite_commit_maps=3, composite_flush_ms=0.0),
                  4, 800)
    assert facts["rows_ok"] and facts["groups"] and facts["composite_groups"]
    assert facts["singles"] == 0 and facts["composite_members"] == [True]


def test_the_driver_compacts_between_the_barriers_and_reducers_read_composites(tmp_path):
    facts = _both(_driver_job, tmp_path, dict(compact_below_bytes=1 << 20), 3, 600, 2)
    assert facts["rows_ok"] and facts["groups"] and facts["tombstones"]


def test_distributed_agents_with_parity_and_composites(tmp_path):
    """The coded plane with composite commits: the seal's parity count rides
    every deferred registration to the tracker."""
    facts = _both(_driver_job, tmp_path,
                  dict(composite_commit_maps=2, parity_segments=1, parity_stripe_k=1,
                       parity_chunk_bytes=4096), 3, 3000)
    assert facts["rows_ok"] and facts["parity"] == [1] and facts["composite_members"] == [True]


def test_sort_by_key_with_composites_loses_no_record_behind_a_slow_seal(tmp_path):
    """The JAX composite regression's shape: a reduce task must not scan
    while a sibling's barrier flush is still sealing (a 0.1 s fat-index
    PUT widens the window); every record comes back, in both packages."""
    from s3shuffle_tpu.storage import fault as jax_fault
    from s3shuffle_tpu.storage.local import LocalBackend as JaxLocal
    from s3shuffle_tpu_torch.storage import fault
    from s3shuffle_tpu_torch.storage.local import LocalBackend

    parts = [records(42 + m, 3000, 10, 90) for m in range(6)]
    counts = {}
    for name, pkg in PKGS.items():
        flaky_mod, local = (fault, LocalBackend) if pkg is PORT else (jax_fault, JaxLocal)
        cfg = config(pkg, tmp_path / name, codec="zlib", composite_commit_maps=4)
        kw = {"device": "cpu"} if pkg is PORT else {}
        with pkg.Context(config=cfg, num_workers=2, **kw) as ctx:
            flaky = flaky_mod.FlakyBackend(local())
            flaky.add_latency(flaky_mod.LatencyRule("create", match=".cindex", delay_s=0.1))
            ctx.manager.dispatcher.backend = flaky
            out = ctx.sort_by_key([pkg.batch.RecordBatch.from_records(p) for p in parts],
                                  num_partitions=4,
                                  serializer=pkg.serializer.ColumnarKVSerializer(),
                                  materialize="batches")
            merged = [pkg.batch.RecordBatch.concat(p) for p in out]
            counts[name] = [b.n for b in merged]
            got = sorted(kv for b in merged for kv in b.to_records())
            assert got == sorted(kv for p in parts for kv in p)
    assert counts["port"] == counts["jax"] and sum(counts["port"]) == 18000


# --- one merged trace ---------------------------------------------------------------

def _chain_to_root(event, by_id):
    names, seen = [event["name"]], set()
    parent_id = event["args"].get("parent_id")
    while parent_id and parent_id not in seen:
        seen.add(parent_id)
        parent = by_id.get(parent_id)
        if parent is None:
            break
        names.append(parent["name"])
        parent_id = parent["args"].get("parent_id")
    return names


def test_a_distributed_job_gives_one_merged_linked_trace(tmp_path):
    """A traced port driver and two spawned traced port agents: one trace
    file where driver.job → worker.task → storage.op link by trace and
    parent ids across processes, with flow events on the edges; the JAX
    critical-path tool explains the job's wall from it and the JAX trace
    report prices the fleet view in $/shuffle."""
    from tools.critical_path import analyze
    from tools.trace_report import render

    PORT.reg.enable()
    trace_file = str(tmp_path / "merged_trace.json")
    PORT.trace.enable(trace_file, torch_annotations=False)
    env = {"S3SHUFFLE_TRACE": str(tmp_path / "worker_residue.json"), "S3SHUFFLE_METRICS": "1"}
    cfg = config(PORT, tmp_path / "store", codec="zlib")
    recs = records(77, 3000)
    driver = PORT.cluster.DistributedDriver(cfg)
    try:
        with spawned_agents(driver, cfg, ["w0", "w1"], heartbeat_s=0.3, env=env) as procs:
            wait_registered(driver, ["w0", "w1"], procs)
            out = driver.run_sort_shuffle(batches(PORT, recs, 3), num_partitions=4)
            assert sorted_records(out) == sorted(recs)
            # drain the fleet so every span shard lands before assembly
            driver.drain_workers(["w0", "w1"])
            for wid, p in procs.items():
                p.join(JOIN_S)
                assert p.exitcode == 0, f"worker {wid} exited {p.exitcode}"
        assert driver.dump_trace() == trace_file
        with open(trace_file) as f:
            doc = json.load(f)
        events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
        by_id = {e["args"]["span_id"]: e for e in events if e["args"].get("span_id")}
        root = next(e for e in events if e["name"] == "driver.job")
        assert root["pid"] == os.getpid()
        trace_id = root["args"]["trace_id"]
        tasks = [e for e in events if e["name"] == "worker.task"]
        worker_pids = {e["pid"] for e in tasks}
        assert len(tasks) == 3 + 4 and os.getpid() not in worker_pids
        for task in tasks:
            assert task["args"]["trace_id"] == trace_id
            assert _chain_to_root(task, by_id)[-1] == "driver.job"
        ops = [e for e in events if e["name"] == "storage.op" and e["pid"] in worker_pids
               and e["args"]["trace_id"] == trace_id]
        assert ops
        for op in ops:
            chain = _chain_to_root(op, by_id)
            assert "worker.task" in chain and chain[-1] == "driver.job"
        flows = {e["ph"] for e in doc["traceEvents"] if e.get("ph") in ("s", "f")}
        assert flows == {"s", "f"}
        phases = {e["name"] for e in events if e["pid"] == os.getpid()}
        assert {"driver.stage_inputs", "driver.map_stage", "driver.publish_snapshot",
                "driver.reduce_stage", "driver.collect"} <= phases
        digest = analyze(doc)
        assert digest["trace_id"] == trace_id and digest["coverage"] >= 0.9
        fleet_file = str(tmp_path / "fleet.json")
        driver.dump_fleet(fleet_file)
        with open(fleet_file) as f:
            fleet_doc = json.load(f)
        assert sorted(fleet_doc["fleet_workers"]) == ["w0", "w1"]
        cost = fleet_doc["cost"]
        assert cost["dollars_total"] > 0
        assert cost["dollars_per_shuffle"] == pytest.approx(cost["dollars_total"] /
                                                            cost["shuffles"])
        assert "/shuffle" in render(fleet_doc)
    finally:
        driver.shutdown()
