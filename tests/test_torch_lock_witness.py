"""The port's lock-order witness (``s3shuffle_tpu_torch/utils/lockwitness.py``):
the counterparts of ``tests/test_lock_witness.py``, each scenario of
``tests/torch_witness_scenarios.py`` under both packages' witnesses (the
same edges and cycles), a witnessed CPU TeraSort through the port under
store weather, and the fresh-process idiom that installs the witnesses
before the port is imported.

The JAX and port witnesses both replace ``threading``'s factories, so no
test installs both at once: each is scoped and uninstalled in ``finally``,
and the JAX tests on the same worker see the raw primitives.
"""

import os
import subprocess
import sys
import textwrap
import threading

import pytest

import torch_witness_scenarios
from s3shuffle_tpu_torch.utils import lockwitness
from s3shuffle_tpu_torch.utils.lockwitness import LockWitness, _WitnessedLock
from torch_port_dispatcher import port_dispatcher_reset  # noqa: F401  (resets the port's process dispatcher)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIO_FILE = os.path.abspath(torch_witness_scenarios.__file__)


@pytest.fixture(autouse=True)
def raw_threading_after():
    """Every test leaves ``threading``'s factories as it found them."""
    saved = (threading.Lock, threading.RLock, threading.Condition, threading.Event,
             threading.Barrier)
    yield
    lockwitness.uninstall()
    assert (threading.Lock, threading.RLock, threading.Condition, threading.Event,
            threading.Barrier) == saved


def _make_pair(witness):
    a = _WitnessedLock(witness, threading.Lock(), "mod_a.py:10")
    b = _WitnessedLock(witness, threading.Lock(), "mod_b.py:20")
    return a, b


def _in_threads(*targets):
    for target in targets:
        t = threading.Thread(target=target, daemon=True)
        t.start()
        t.join()


# ---------------------------------------------------------------------------
# Graph core
# ---------------------------------------------------------------------------


def test_abba_ordering_detected():
    w = LockWitness()
    a, b = _make_pair(w)

    def ab():
        with a:
            with b:
                pass

    def ba():
        with b:
            with a:
                pass

    _in_threads(ab, ba)
    cycles = w.find_cycles()
    assert cycles, "ABBA ordering not detected"
    assert {"mod_a.py:10", "mod_b.py:20"} <= {s for cyc in cycles for s in cyc}
    report = w.format_report()
    assert "mod_a.py:10" in report and "held while acquiring" in report


def test_consistent_order_is_clean():
    w = LockWitness()
    a, b = _make_pair(w)
    for _ in range(3):
        _in_threads(lambda: [a.acquire(), b.acquire(), b.release(), a.release()])
    assert w.find_cycles() == []
    assert w.edges() == {"mod_a.py:10": {"mod_b.py:20"}}


def test_same_site_pairs_are_ignored():
    w = LockWitness()
    x = _WitnessedLock(w, threading.Lock(), "mod_a.py:10")
    y = _WitnessedLock(w, threading.Lock(), "mod_a.py:10")
    with x:
        with y:
            pass
    assert w.find_cycles() == []


def test_three_lock_cycle_detected():
    w = LockWitness()
    a, b = _make_pair(w)
    c = _WitnessedLock(w, threading.Lock(), "mod_c.py:30")
    _in_threads(*[
        (lambda f=first, s=second: [f.acquire(), s.acquire(), s.release(), f.release()])
        for first, second in ((a, b), (b, c), (c, a))
    ])
    cycles = w.find_cycles()
    assert cycles and any(len(set(cyc)) == 3 for cyc in cycles)


# ---------------------------------------------------------------------------
# Patch layer: constructor interception, scoping, Condition.wait modelling
# ---------------------------------------------------------------------------


def _write_module(tmp_path, name, body):
    (tmp_path / f"{name}.py").write_text(textwrap.dedent(body))
    return str(tmp_path)


def test_installed_factories_witness_watched_code_only(tmp_path):
    root = _write_module(tmp_path, "port_watched_mod", """
        import threading

        def nested_pair():
            a = threading.Lock()
            b = threading.RLock()
            with a:
                with b:
                    pass
        """)
    sys.path.insert(0, root)
    try:
        with lockwitness.watching(extra_paths=(root,)) as w:
            import port_watched_mod

            port_watched_mod.nested_pair()
            # a lock built by this (unwatched) test file stays raw
            assert not isinstance(threading.Lock(), _WitnessedLock)
            edges = {k: v for k, v in w.edges().items() if "port_watched_mod" in k}
            assert edges and all("port_watched_mod" in s for v in edges.values() for s in v)
        assert not isinstance(threading.Lock(), _WitnessedLock)
    finally:
        sys.path.remove(root)
        sys.modules.pop("port_watched_mod", None)


def test_port_package_locks_are_witnessed_by_default():
    """Without ``extra_paths`` the watch scope is the port's own package:
    a lock a port constructor builds is witnessed, and its site is relative
    to the package root."""
    from s3shuffle_tpu_torch.utils.concurrent_map import ConcurrentObjectMap

    with lockwitness.watching():
        cmap = ConcurrentObjectMap()
        lock = next(v for v in vars(cmap).values() if isinstance(v, _WitnessedLock))
    assert lock._site.startswith("utils/concurrent_map.py:")


def test_condition_wait_releases_held_stack(tmp_path):
    root = _write_module(tmp_path, "port_cond_mod", """
        import threading
        import time

        def run():
            cond = threading.Condition()
            other = threading.Lock()
            done = []

            def consumer():
                with cond:
                    while not done:
                        cond.wait(timeout=2.0)

            t = threading.Thread(target=consumer, daemon=True)
            t.start()
            time.sleep(0.05)
            with other:
                with cond:
                    done.append(1)
                    cond.notify_all()
            t.join(timeout=5)
            assert not t.is_alive()
        """)
    sys.path.insert(0, root)
    try:
        with lockwitness.watching(extra_paths=(root,)) as w:
            import port_cond_mod

            port_cond_mod.run()
            assert w.find_cycles() == []
    finally:
        sys.path.remove(root)
        sys.modules.pop("port_cond_mod", None)


def test_reentrant_condition_wait_keeps_stack_balanced(tmp_path):
    root = _write_module(tmp_path, "port_reent_mod", """
        import threading
        import time

        def run():
            cond = threading.Condition()
            other = threading.Lock()
            done = []

            def consumer():
                with cond:
                    with cond:
                        while not done:
                            cond.wait(timeout=2.0)
                    with other:
                        pass

            t = threading.Thread(target=consumer, daemon=True)
            t.start()
            time.sleep(0.05)
            with cond:
                done.append(1)
                cond.notify_all()
            t.join(timeout=5)
            assert not t.is_alive()
        """)
    sys.path.insert(0, root)
    try:
        with lockwitness.watching(extra_paths=(root,)) as w:
            import port_reent_mod

            port_reent_mod.run()
            edges = {k: v for k, v in w.edges().items() if "port_reent_mod" in k}
            assert any("port_reent_mod" in dst for dsts in edges.values() for dst in dsts), edges
    finally:
        sys.path.remove(root)
        sys.modules.pop("port_reent_mod", None)


def test_install_from_env_falsy_values_disable(monkeypatch):
    assert lockwitness.active_witness() is None
    for value in ("0", "false", "no", "off", ""):
        monkeypatch.setenv("S3SHUFFLE_LOCK_WITNESS", value)
        assert lockwitness.install_from_env() is None, value
        assert lockwitness.active_witness() is None
    monkeypatch.setenv("S3SHUFFLE_LOCK_WITNESS", "1")
    try:
        assert lockwitness.install_from_env() is not None
        assert threading.Lock is not lockwitness._installed.orig_lock
    finally:
        lockwitness.uninstall()


# ---------------------------------------------------------------------------
# Both packages' witnesses over one scenario: the same graph
# ---------------------------------------------------------------------------


def _graph_under(module, scenario):
    """Edges and cycles of ``scenario`` under ``module``'s witness, watching
    the scenario file only; uninstalled before it returns."""
    assert module.active_witness() is None
    try:
        with module.watching(extra_paths=(SCENARIO_FILE,)) as w:
            scenario()
        return w.edges(), w.find_cycles()
    finally:
        module.uninstall()


@pytest.mark.parametrize("name", sorted(torch_witness_scenarios.SCENARIOS))
def test_scenario_gives_the_same_graph_under_both_witnesses(name):
    from s3shuffle_tpu.utils import lockwitness as jax_lockwitness

    scenario = torch_witness_scenarios.SCENARIOS[name]
    jax_edges, jax_cycles = _graph_under(jax_lockwitness, scenario)
    port_edges, port_cycles = _graph_under(lockwitness, scenario)
    assert port_edges == jax_edges
    assert port_cycles == jax_cycles
    assert all(site.startswith("../tests/torch_witness_scenarios.py:")
               for site in port_edges)
    expect_cycle = name in ("abba", "three-lock-cycle", "lost-wakeup")
    assert bool(port_cycles) is expect_cycle, (name, port_edges, port_cycles)
    if name != "condition-handoff":
        assert port_edges, name


# ---------------------------------------------------------------------------
# The port's own workload
# ---------------------------------------------------------------------------


def _soak_rules():
    from s3shuffle_tpu_torch.storage.fault import (
        FaultRule,
        transient_connection_reset,
        transient_http_503,
        transient_timeout,
    )

    return [
        FaultRule("read", prob=0.05, rng_seed=11, times=None, exc=transient_connection_reset),
        FaultRule("open", prob=0.05, rng_seed=22, times=None, exc=transient_http_503),
        FaultRule("status", prob=0.05, rng_seed=33, times=None, exc=transient_timeout),
        FaultRule("create", times=1, exc=transient_timeout),
    ]


def _records(n=800, seed=7):
    import random

    rng = random.Random(seed)
    return [(rng.randbytes(8), rng.randbytes(16)) for _ in range(n)]


def _run_port_shuffle(ctx, n_maps=3, n_parts=4):
    from s3shuffle_tpu_torch.dependency import HashPartitioner, ShuffleDependency

    records = _records()
    sid = next(ctx._next_shuffle_id)
    handle = ctx.manager.register_shuffle(sid, ShuffleDependency(sid, HashPartitioner(n_parts)))
    per_map = len(records) // n_maps
    for map_id in range(n_maps):
        hi = (map_id + 1) * per_map if map_id < n_maps - 1 else len(records)
        w = ctx.manager.get_writer(handle, map_id)
        w.write(records[map_id * per_map:hi])
        w.stop(success=True)
    out = []
    for rid in range(n_parts):
        out.extend(ctx.manager.get_reader(handle, rid, rid + 1).read())
    return sorted(records), sorted(out)


def test_port_workload_under_store_weather_is_witness_clean(tmp_path):
    """Write, commit and read on 2 task threads through the port's
    ``ShuffleContext(device="cpu")`` under seeded transient faults beneath
    the retry layer: prefetch threads, the encode thread and decode pool,
    the pipelined upload and the re-drives take their locks in one global
    order."""
    from s3shuffle_tpu_torch import ShuffleConfig, ShuffleContext
    from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
    from s3shuffle_tpu_torch.storage.fault import FlakyBackend

    with lockwitness.watching() as w:
        Dispatcher.reset()
        cfg = ShuffleConfig(root_dir=f"file://{tmp_path}/soak", app_id="witness-soak",
                            storage_retries=8, storage_retry_base_ms=1.0,
                            storage_op_deadline_s=20.0, codec_block_size=2048,
                            codec_batch_blocks=4)
        with ShuffleContext(config=cfg, num_workers=2, device="cpu") as ctx:
            retry = ctx.manager.dispatcher.backend
            flaky = FlakyBackend(retry.inner, rules=_soak_rules())
            retry.inner = flaky
            expected, out = _run_port_shuffle(ctx)
            assert out == expected
            assert sum(r.hits for r in flaky.rules) >= 1, "no fault fired"
        edges = w.edges()
        assert edges, "the workload recorded no lock-order edge"
        assert w.find_cycles() == [], w.format_report()


#: a fresh interpreter: the witnesses are loaded by file spec under their
#: canonical names, installed from the environment, and only then is the
#: port imported; a CPU TeraSort of 4 maps follows, through ShuffleContext
WITNESSED_TERASORT = r'''
import importlib.util, os, sys
repo = sys.argv[1]
for name in ("lockwitness", "racewitness"):
    full = "s3shuffle_tpu_torch.utils." + name
    spec = importlib.util.spec_from_file_location(
        full, os.path.join(repo, "s3shuffle_tpu_torch", "utils", name + ".py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules[full] = module
    spec.loader.exec_module(module)
lw = sys.modules["s3shuffle_tpu_torch.utils.lockwitness"].install_from_env()
rw = sys.modules["s3shuffle_tpu_torch.utils.racewitness"].install_from_env()
sys.path.insert(0, repo)
import numpy as np
from s3shuffle_tpu_torch import ShuffleConfig, ShuffleContext
from s3shuffle_tpu_torch.batch import RecordBatch
from s3shuffle_tpu_torch.serializer import ColumnarKVSerializer
from s3shuffle_tpu_torch.utils import gc_paused, lockwitness, protowitness
assert lockwitness.active_witness() is lw and lw is not None and rw is not None
assert type(gc_paused._lock).__name__ == "_WitnessedLock"  # built at import, witnessed
rng = np.random.default_rng(0)
parts = [RecordBatch(np.full(2000, 10, np.int32), np.full(2000, 90, np.int32),
                     rng.integers(0, 256, 20000, dtype=np.uint8),
                     rng.integers(0, 256, 180000, dtype=np.uint8)) for _ in range(4)]
cfg = ShuffleConfig(root_dir="file://" + sys.argv[2], codec_block_size=2048,
                    codec_batch_blocks=4, checksum_algorithm="CRC32C")
ctx = ShuffleContext(cfg, num_workers=4, device="cpu")
assert ctx.manager.protocol_witness is not None
out = ctx.sort_by_key(parts, 4, serializer=ColumnarKVSerializer(), materialize="batches")
ctx.stop()
keys = np.concatenate([RecordBatch.concat(p).key_strings(width=10) for p in out])
assert len(keys) == 8000 and (keys[:-1] <= keys[1:]).all()
print(lw.format_report())
print(rw.format_report())
for w in protowitness.drain_installed():
    w.assert_clean()
print("protocol witness: clean")
'''


def test_fresh_process_witnessed_terasort_is_clean(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(S3SHUFFLE_LOCK_WITNESS="1", S3SHUFFLE_RACE_WITNESS="1",
               S3SHUFFLE_PROTOCOL_WITNESS="1")
    res = subprocess.run([sys.executable, "-c", WITNESSED_TERASORT, REPO_ROOT, str(tmp_path)],
                         cwd=str(tmp_path), env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    assert "lock witness: no ordering cycles" in res.stdout
    assert "race witness: no unsynchronized access pairs" in res.stdout
    assert "(0 checks)" not in res.stdout
    assert "protocol witness: clean" in res.stdout
