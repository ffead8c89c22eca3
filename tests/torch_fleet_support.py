"""What the port's fleet tests (``test_torch_{cluster,recovery,fleet}.py``)
share: both packages side by side, the reset of their process-wide state
around each test, seeded records, and agents run in threads or spawned.

Every agent a test starts is stopped, drained or killed and joined within
:data:`JOIN_S` in a ``finally``, and every socket it opened is closed
(``tests/conftest.py`` turns a ``ResourceWarning`` into an error). Spawned
agents run ``tests/torch_fleet_agent.py``, which imports the port alone.
"""

import contextlib
import dataclasses
import os
import random
import threading
import time
import types

import pytest

from s3shuffle_tpu import batch as jax_batch
from s3shuffle_tpu import block_ids as jax_block_ids
from s3shuffle_tpu import cluster as jax_cluster
from s3shuffle_tpu import dependency as jax_dependency
from s3shuffle_tpu import recovery as jax_recovery
from s3shuffle_tpu import serializer as jax_serializer
from s3shuffle_tpu import worker as jax_worker
from s3shuffle_tpu.config import ShuffleConfig as JaxConfig
from s3shuffle_tpu.metadata import map_output as jax_map_output
from s3shuffle_tpu.metadata import service as jax_service
from s3shuffle_tpu.metrics import registry as jax_reg
from s3shuffle_tpu.metrics import stats as jax_stats
from s3shuffle_tpu.shuffle import ShuffleContext as JaxContext
from s3shuffle_tpu.storage import dispatcher as jax_dispatcher
from s3shuffle_tpu.utils import trace as jax_trace
from s3shuffle_tpu_torch import batch, block_ids, cluster, dependency, recovery, serializer, worker
from s3shuffle_tpu_torch.config import ShuffleConfig
from s3shuffle_tpu_torch.metadata import map_output, service
from s3shuffle_tpu_torch.metrics import registry as reg
from s3shuffle_tpu_torch.metrics import stats
from s3shuffle_tpu_torch.shuffle import ShuffleContext
from s3shuffle_tpu_torch.storage import dispatcher
from s3shuffle_tpu_torch.utils import trace

#: the longest any test waits for a worker, a thread or a job
JOIN_S = 60.0
#: TLZ block and batch of the tests' configs (2048-byte blocks)
BS = 2048
BATCH = 4
PROCESS_POOLS = ("s3shuffle-torch-encode", "s3shuffle-torch-decode", "s3shuffle-torch-fetch",
                 "s3shuffle-torch-speculate", "s3shuffle-encode", "s3shuffle-decode",
                 "s3shuffle-fetch", "s3shuffle-speculate", "s3shuffle-tpu-encode",
                 "s3shuffle-tpu-decode")


def _pkg(name, **mods):
    return types.SimpleNamespace(name=name, **mods)


PORT = _pkg("port", Config=ShuffleConfig, batch=batch, block_ids=block_ids, cluster=cluster,
            dependency=dependency, recovery=recovery, serializer=serializer, worker=worker,
            map_output=map_output, service=service, reg=reg, trace=trace,
            Dispatcher=dispatcher.Dispatcher, Context=ShuffleContext)
JAX = _pkg("jax", Config=JaxConfig, batch=jax_batch, block_ids=jax_block_ids,
           cluster=jax_cluster, dependency=jax_dependency, recovery=jax_recovery,
           serializer=jax_serializer, worker=jax_worker, map_output=jax_map_output,
           service=jax_service, reg=jax_reg, trace=jax_trace,
           Dispatcher=jax_dispatcher.Dispatcher, Context=JaxContext)
PKGS = {"port": PORT, "jax": JAX}


def reset_planes():
    for t in (trace, jax_trace):
        t.disable()
        t.reset()
        t.configure_flight(dir="", ring=t.FLIGHT_RING_DEFAULT, worker_id="")
        t._flight.clear()
        t._flight_error = False
    for r in (reg, jax_reg):
        r.disable()
        r.REGISTRY.reset_values()
    for c in (stats.COLLECTOR, jax_stats.COLLECTOR):
        c.reset()
    for p in PKGS.values():
        p.Dispatcher.reset()


@pytest.fixture(autouse=True)
def clean_planes():
    """Both packages' tracers, flight rings, registries, stats collectors and
    process dispatchers reset before and after each test."""
    reset_planes()
    yield
    reset_planes()


@pytest.fixture(scope="module", autouse=True)
def file_hygiene():
    """When the file ends: no thread of its tests alive but the process-wide
    pools' workers, and no ``S3SHUFFLE_*`` variable changed."""
    env = {k: v for k, v in os.environ.items() if k.startswith("S3SHUFFLE_")}
    threads = set(threading.enumerate())
    yield
    assert {k: v for k, v in os.environ.items() if k.startswith("S3SHUFFLE_")} == env
    deadline = time.monotonic() + JOIN_S
    while True:
        left = [t.name for t in threading.enumerate() if t not in threads and t.is_alive()
                and not t.name.startswith(PROCESS_POOLS)]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert not left, left


@pytest.fixture
def registries_on():
    for r in (reg, jax_reg):
        r.enable()
    yield


def counter_total(registry, name, **labels) -> float:
    snap = registry.snapshot(compact=True)
    return sum(float(s.get("value", 0)) for s in snap.get(name, {}).get("series", [])
               if all(s.get("labels", {}).get(k) == v for k, v in labels.items()))


def records(seed: int, n: int, key: int = 8, value: int = 24):
    """``n`` (key, value) records of random bytes, from ``seed``."""
    rng = random.Random(seed)
    return [(rng.randbytes(key), rng.randbytes(value)) for _ in range(n)]


def batches(pkg, recs, maps: int):
    return [pkg.batch.RecordBatch.from_records(recs[i::maps]) for i in range(maps)]


def objects(root) -> dict:
    """Every file under ``root`` by its path relative to ``root``."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            full = os.path.join(dirpath, fn)
            with open(full, "rb") as f:
                out[os.path.relpath(full, root)] = f.read()
    return out


def config(pkg, root, **knobs):
    """``pkg``'s config over ``root`` at the tests' TLZ geometry; the JAX
    side's TLZ stays on its device path (no host reroute)."""
    kw = dict(root_dir=f"file://{root}", app_id="fleet", codec_block_size=BS,
              codec_batch_blocks=BATCH, checksum_algorithm="CRC32C", **knobs)
    if pkg is JAX and kw.get("codec") == "tpu":
        kw["tpu_host_fallback"] = False
    return pkg.Config(**kw)


def make_agent(pkg, address, cfg, worker_id):
    if pkg is PORT:
        return worker.WorkerAgent(address, config=cfg, worker_id=worker_id, device="cpu")
    return jax_worker.WorkerAgent(address, config=cfg, worker_id=worker_id)


@contextlib.contextmanager
def thread_agents(pkg, driver, cfg, n=1, prefix="w"):
    """``n`` agents of ``pkg`` on ``run_forever`` threads; on exit the
    driver's queue tells them to stop, each is joined and closed."""
    agents = [make_agent(pkg, driver.coordinator_address, cfg, f"{prefix}{i}")
              for i in range(n)]
    threads = [threading.Thread(target=a.run_forever, kwargs={"poll_interval": 0.01},
                                name=f"fleet-agent-{i}", daemon=True)
               for i, a in enumerate(agents)]
    for t in threads:
        t.start()
    try:
        yield agents
    finally:
        driver.server.task_queue.stop_workers()
        for t in threads:
            t.join(JOIN_S)
        for a in agents:
            a.close()
        assert not any(t.is_alive() for t in threads), "an agent thread did not stop"


@contextlib.contextmanager
def spawned_agents(driver, cfg, ids, heartbeat_s=0.5, env=None):
    """Port agents (``device="cpu"``) in processes started with ``spawn``;
    on exit the live ones are drained, joined, then killed if still alive."""
    import multiprocessing as mp

    from torch_fleet_agent import agent_main

    ctx = mp.get_context("spawn")
    procs = {wid: ctx.Process(target=agent_main, daemon=True,
                              args=(list(driver.coordinator_address), dataclasses.asdict(cfg),
                                    wid, heartbeat_s, "cpu", env))
             for wid in ids}
    for p in procs.values():
        p.start()
    try:
        yield procs
    finally:
        live = [w for w, p in procs.items() if p.is_alive()]
        with contextlib.suppress(Exception):
            driver.drain_workers(live)
        for p in procs.values():
            p.join(JOIN_S)
            if p.is_alive():
                p.kill()
                p.join(JOIN_S)


def wait_registered(driver, ids, procs=None):
    """Wait (at most JOIN_S) until every id in ``ids`` is a live member."""
    deadline = time.monotonic() + JOIN_S
    while not set(ids) <= set(driver.server.membership.live_workers()):
        if procs is not None:
            dead = {w: p.exitcode for w, p in procs.items() if p.exitcode is not None}
            assert not dead, f"agents exited before registering: {dead}"
        assert time.monotonic() < deadline, "agents did not register"
        time.sleep(0.02)


def sorted_records(out):
    return sorted(kv for b in out for kv in b.to_records())


