"""The port's recovery plane (``recovery.py``) against the JAX package's, on
the CPU.

- The planner: every decision over a grid of stripe widths, surviving
  parity, index survival and observed evidence equals the JAX planner's,
  and so do the evidence it reads and ``recovery_decisions_total``.
- ``probe_lost_maps`` on one store, written by either package, finds what
  the JAX probe finds: singleton and composite losses, parity lost with the
  data, an index lost alone, a narrowed probe, and store errors read as
  "present".
- End to end, with spawned port agents: a worker killed after committing a
  map whose data object is then lost; uncoded, the driver recomputes the map
  from its staged input when the reducers report the loss; coded (k1m1), it
  decides to reconstruct and the reducers' degraded reads rebuild the
  object, with no recompute.
"""

import dataclasses
import time

import numpy as np
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
    records,
    registries_on,
    sorted_records,
    spawned_agents,
    wait_registered,
)
from torch_jax_native import jax_native_library  # noqa: F401  (loads the JAX oracle's native library)

MB = 1 << 20

EVIDENCE = {
    "none": None,
    "empty": {},
    # fast reads, slow map tasks: reconstruction is cheap
    "fast-reads": {"bytes_read": 100 * MB, "read_prefetch_seconds": 1.0,
                   "bytes_written": 10 * MB, "write_seconds": 10.0, "map_tasks": 2},
    # crawling reads, trivial map tasks: recompute wins
    "slow-reads": {"bytes_read": 1 * MB, "read_prefetch_seconds": 60.0,
                   "bytes_written": 100 * MB, "write_seconds": 0.5, "map_tasks": 100},
    # reads only: no write rate, no map wall
    "reads-only": {"bytes_read": 8 * MB, "read_prefetch_seconds": 2.0},
    # a write rate but no map tasks counted
    "writes-no-tasks": {"bytes_read": 8 * MB, "read_prefetch_seconds": 4.0,
                        "bytes_written": 4 * MB, "write_seconds": 8.0},
}


def _lost(pkg, nbytes, m, index, group=-1):
    return pkg.recovery.LostMap(shuffle_id=0, map_id=3001, map_index=3, lost_bytes=nbytes,
                                parity_segments=m, composite_group=group, index_present=index)


@pytest.mark.parametrize("evidence", sorted(EVIDENCE))
@pytest.mark.parametrize("index", [True, False], ids=["index", "no-index"])
@pytest.mark.parametrize("m", [0, 1, 2, 3])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_the_planner_decides_as_jax(registries_on, k, m, index, evidence):
    stats = EVIDENCE[evidence]
    decided = {}
    for name, pkg in PKGS.items():
        planner = pkg.recovery.RecoveryPlanner(stripe_k=k)
        decided[name] = [planner.decide(_lost(pkg, nbytes, m, index), stats)
                         for nbytes in (1, MB, 64 * MB)]
    assert decided["port"] == decided["jax"]
    # the structural gate: no parity cover or no index, no reconstruction
    if m < k or m == 0 or not index:
        assert set(decided["port"]) == {"recompute"}
    for choice in ("recompute", "reconstruct"):
        assert counter_total(PORT.reg.REGISTRY, "recovery_decisions_total", choice=choice) == \
            counter_total(JAX.reg.REGISTRY, "recovery_decisions_total", choice=choice)


@pytest.mark.parametrize("evidence", sorted(EVIDENCE))
def test_the_planner_reads_the_evidence_jax_reads(evidence):
    assert PORT.recovery.decision_evidence(EVIDENCE[evidence]) == \
        JAX.recovery.decision_evidence(EVIDENCE[evidence])


def test_the_planner_counts_only_while_the_registry_is_on():
    PORT.recovery.RecoveryPlanner(1).decide(_lost(PORT, MB, 1, True))
    assert counter_total(PORT.reg.REGISTRY, "recovery_decisions_total") == 0
    assert PORT.recovery.MAP_OUTPUT_LOST_MARKER == JAX.recovery.MAP_OUTPUT_LOST_MARKER
    assert PORT.recovery.RecoveryPlanner.RECONSTRUCT_OVERHEAD == \
        JAX.recovery.RecoveryPlanner.RECONSTRUCT_OVERHEAD
    assert PORT.recovery.RecoveryPlanner(0).stripe_k == 1


# --- probing a store ------------------------------------------------------------

def _write_shuffle(pkg, root, composite: bool):
    """Three maps of a coded (k1m1) shuffle written through ``pkg``'s
    manager; composite maps go into one group. Returns the manager."""
    knobs = dict(codec="zlib", cleanup=False, parity_segments=1, parity_stripe_k=1,
                 parity_chunk_bytes=2048)
    if composite:
        knobs.update(composite_commit_maps=3, composite_flush_ms=0.0)
    cfg = config(pkg, root, **knobs)
    kw = {"device": "cpu"} if pkg is PORT else {}
    ctx = pkg.Context(config=cfg, num_workers=1, **kw)
    dep = pkg.dependency.ShuffleDependency(0, pkg.dependency.HashPartitioner(2))
    handle = ctx.manager.register_shuffle(0, dep)
    recs = records(11, 600, key=6, value=18)
    for mid in range(3):
        w = ctx.manager.get_writer(handle, mid)
        w.write(recs[mid * 200:(mid + 1) * 200])
        w.stop(success=True)
    if composite:
        ctx.manager.composite.flush_all()
    return ctx


def _trackers(statuses):
    """Each package's tracker holding the same registrations."""
    out = {}
    for name, pkg in PKGS.items():
        tracker = pkg.map_output.MapOutputTracker()
        tracker.register_shuffle(0, 2)
        for map_index, s in statuses:
            tracker.register_map_output(0, pkg.map_output.MapStatus(
                map_id=int(s.map_id), location=s.location, sizes=np.asarray(s.sizes),
                map_index=int(map_index), composite_group=int(s.composite_group),
                base_offset=int(s.base_offset), parity_segments=int(s.parity_segments)))
        out[name] = tracker
    return out


def _lose(disp, pkg, case, composite):
    """Delete what ``case`` loses, through ``disp`` (the writer's)."""
    b = pkg.block_ids

    def rm(block):
        disp.backend.delete(disp.get_path(block))

    if case == "none":
        return
    if composite:
        data, index = b.ShuffleCompositeDataBlockId(0, 0), b.ShuffleFatIndexBlockId(0, 0)
        parity = b.ShuffleCompositeParityBlockId(0, 0, 0)
    else:
        data, index = b.ShuffleDataBlockId(0, 1), b.ShuffleIndexBlockId(0, 1)
        parity = b.ShuffleParityBlockId(0, 1, 0)
    if case in ("data", "data-narrowed", "data-store-errors"):
        rm(data)
    elif case == "data-and-parity":
        rm(data)
        rm(parity)
    elif case == "index-only":
        rm(index)
    elif case == "data-and-index":
        rm(data)
        rm(index)


PROBE_CASES = ["none", "data", "data-narrowed", "data-and-parity", "index-only",
               "data-and-index", "data-store-errors"]


@pytest.mark.parametrize("case", PROBE_CASES)
@pytest.mark.parametrize("layout", ["singleton", "composite"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_the_probe_finds_what_jax_finds(tmp_path, writer, layout, case):
    composite = layout == "composite"
    ctx = _write_shuffle(PKGS[writer], tmp_path, composite)
    try:
        statuses = ctx.manager.tracker.deduped_statuses(0)
        assert len(statuses) == 3
        _lose(ctx.manager.dispatcher, PKGS[writer], case, composite)
    finally:
        ctx.stop()
    trackers = _trackers(statuses)
    found = {}
    for name, pkg in PKGS.items():
        disp = pkg.Dispatcher(config(pkg, tmp_path, codec="zlib", cleanup=False))
        if case == "data-store-errors":
            def outage(_path):
                raise OSError("store outage")

            disp.backend.exists = outage
        narrowed = [2] if case == "data-narrowed" else None
        lost = pkg.recovery.probe_lost_maps(disp, trackers[name], 0, map_indices=narrowed)
        found[name] = [dataclasses.asdict(x) for x in lost]
    assert found["port"] == found["jax"]
    got = found["port"]
    if case in ("none", "data-store-errors"):
        expected = []
    elif case == "data-narrowed":  # the probe asks about map 2 only
        expected = [2] if composite else []
    else:
        expected = [0, 1, 2] if composite else [1]
    assert [x["map_index"] for x in got] == expected
    assert {x["composite_group"] for x in got} <= ({0} if composite else {-1})
    if got:
        assert all(x["lost_bytes"] > 0 for x in got)
        assert {x["parity_segments"] for x in got} == \
            ({0} if case == "data-and-parity" else {1})
        assert {x["index_present"] for x in got} == \
            ({False} if case in ("index-only", "data-and-index") else {True})


# --- end to end ---------------------------------------------------------------------

def _kill_and_lose(driver, procs, sabotaged, shuffle_id, tracker, dispatcher, wait_expiry):
    """At the map barrier: kill a worker that committed a map, delete that
    map's data object and, with ``wait_expiry``, let the driver see the
    death before the reducers run."""
    queue = driver.server.task_queue
    victim = next(w for w in sorted(procs) if queue.tasks_done_by(w))
    logical = int(queue.tasks_done_by(victim)[0][1])
    procs[victim].kill()
    procs[victim].join(JOIN_S)
    status = dict(tracker.deduped_statuses(shuffle_id))[logical]
    dispatcher.backend.delete(dispatcher.get_path(
        PORT.block_ids.ShuffleDataBlockId(shuffle_id, status.map_id)))
    sabotaged.update(worker=victim, map_index=logical, map_id=status.map_id)
    if wait_expiry:
        deadline = time.monotonic() + JOIN_S
        while driver.server.membership.state_of(victim) != "expired":
            assert time.monotonic() < deadline, f"{victim} never expired"
            driver._reap_fleet()
            time.sleep(0.05)


@pytest.mark.parametrize("coded", [False, True], ids=["uncoded-recompute", "k1m1-reconstruct"])
def test_an_output_lost_with_its_worker_is_recovered(tmp_path, monkeypatch, registries_on,
                                                     coded):
    knobs = dict(codec="zlib", worker_lease_s=2.0)
    if coded:
        knobs.update(parity_segments=1, parity_stripe_k=1, parity_chunk_bytes=4096)
    cfg = config(PORT, tmp_path, **knobs)
    recs = records(21, 2000)
    driver = PORT.cluster.DistributedDriver(cfg)
    assert driver.task_lease_s == 2.0
    sabotaged = {}
    real_publish = PORT.cluster.publish_snapshot
    try:
        with spawned_agents(driver, cfg, ["w0", "w1"]) as procs:
            wait_registered(driver, ["w0", "w1"], procs)

            def sabotage_then_publish(tracker, dispatcher, shuffle_id):
                if not sabotaged:
                    # uncoded: the reducers find the loss; coded: the
                    # driver sees the death first and plans the recovery
                    _kill_and_lose(driver, procs, sabotaged, shuffle_id, tracker, dispatcher,
                                   wait_expiry=coded)
                return real_publish(tracker, dispatcher, shuffle_id)

            monkeypatch.setattr(PORT.cluster, "publish_snapshot", sabotage_then_publish)
            out = driver.run_sort_shuffle(batches(PORT, recs, 2), num_partitions=3)
            assert sorted_records(out) == sorted(recs)
            assert sabotaged, "the loss was never staged"
            decisions = {c: counter_total(PORT.reg.REGISTRY, "recovery_decisions_total",
                                          choice=c) for c in ("recompute", "reconstruct")}
            if coded:
                assert decisions == {"recompute": 0, "reconstruct": 1}
                assert counter_total(PORT.reg.REGISTRY, "task_requeues_total",
                                     reason="map_output_lost") == 0
            else:
                assert decisions["recompute"] >= 1 and decisions["reconstruct"] == 0
            # the dead worker's membership expires at a fleet beat
            deadline = time.monotonic() + JOIN_S
            while driver.server.membership.state_of(sabotaged["worker"]) != "expired":
                assert time.monotonic() < deadline, "no expire event"
                driver._reap_fleet()
                time.sleep(0.1)
    finally:
        driver.shutdown()
