"""The port's protocol witness (``s3shuffle_tpu_torch/utils/protowitness.py``):
the counterparts of ``tests/test_proto_witness.py`` over the port, the
object-name classification held against the JAX witness's, and a port
worker process whose clean exit vouches for its commit protocol.

The revert test takes out the composite seal barrier
(``CompositeCommitAggregator._await_seals``) and replays the record-loss
interleaving: the witness catches the reduce lookup inside the window.
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from s3shuffle_tpu_torch import ShuffleConfig, ShuffleContext
from s3shuffle_tpu_torch.dependency import HashPartitioner, ShuffleDependency
from s3shuffle_tpu_torch.metadata.fat_index import FatIndex, FatIndexMember
from s3shuffle_tpu_torch.storage.backend import MemoryBackend
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
from s3shuffle_tpu_torch.utils import protowitness
from s3shuffle_tpu_torch.utils.protowitness import (
    ProtocolViolationError,
    ProtocolWitness,
    WitnessedBackend,
    classify,
)
from torch_port_dispatcher import port_dispatcher_reset  # noqa: F401  (resets the port's process dispatcher)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PARTS = 4
N_RECORDS = 800


@pytest.fixture(autouse=True)
def no_env_witness(monkeypatch):
    monkeypatch.delenv("S3SHUFFLE_PROTOCOL_WITNESS", raising=False)
    yield
    protowitness.drain_installed()


def _records():
    import random

    rng = random.Random(7)
    return [(rng.randbytes(8), rng.randbytes(16)) for _ in range(N_RECORDS)]


def _config(root, **knobs):
    return ShuffleConfig(root_dir=f"file://{root}", app_id="pw", codec_block_size=2048,
                         codec_batch_blocks=4, **knobs)


def _run_shuffle(ctx, n_maps=3):
    records = _records()
    sid = next(ctx._next_shuffle_id)
    handle = ctx.manager.register_shuffle(sid, ShuffleDependency(sid, HashPartitioner(N_PARTS)))
    per_map = len(records) // n_maps
    for map_id in range(n_maps):
        hi = (map_id + 1) * per_map if map_id < n_maps - 1 else len(records)
        w = ctx.manager.get_writer(handle, map_id)
        w.write(records[map_id * per_map:hi])
        w.stop(success=True)
    out = []
    for rid in range(N_PARTS):
        out.extend(ctx.manager.get_reader(handle, rid, rid + 1).read())
    return handle, sorted(records), sorted(out)


# ---------------------------------------------------------------------------
# Object-name classification (the witness's event grammar)
# ---------------------------------------------------------------------------


def test_classify_grammar():
    assert classify("root/7/shuffle_3_7_0.data") == ("data", ("map", 3, 7))
    assert classify("shuffle_3_7_0.index") == ("index", ("map", 3, 7))
    assert classify("shuffle_3_7_0.checksum.CRC32C") == ("checksum", ("map", 3, 7))
    assert classify("shuffle_3_7_par1.parity") == ("parity", ("map", 3, 7))
    assert classify("shuffle_3_comp_9.data") == ("data", ("comp", 3, 9))
    assert classify("shuffle_3_comp_9.cindex") == ("index", ("comp", 3, 9))
    assert classify("shuffle_3_comp_9_par0.parity") == ("parity", ("comp", 3, 9))
    assert classify("shuffle_3_snapshot_2.snapmeta") is None
    assert classify("shuffle_3_gen_5.tomb") is None
    assert classify("some/other/file.txt") is None


def _object_names(pkg):
    """Every object name ``pkg``'s block ids give, over a few ids."""
    b = pkg
    names = []
    for sid, mid in ((0, 0), (3, 7), (12, 123456)):
        names += [b.ShuffleDataBlockId(sid, mid).name, b.ShuffleIndexBlockId(sid, mid).name,
                  b.ShuffleChecksumBlockId(sid, mid, algorithm="CRC32C").name,
                  b.ShuffleChecksumBlockId(sid, mid, algorithm="ADLER32").name,
                  b.ShuffleParityBlockId(sid, mid, 0).name,
                  b.ShuffleParityBlockId(sid, mid, 3).name,
                  b.ShuffleCompositeDataBlockId(sid, mid).name,
                  b.ShuffleFatIndexBlockId(sid, mid).name,
                  b.ShuffleCompositeParityBlockId(sid, mid, 1).name,
                  b.ShuffleSnapshotBlockId(sid, mid).name,
                  b.ShuffleTombstoneBlockId(sid, mid).name,
                  f"shuffle_{sid}_{mid}_1.data", f"shuffle_{sid}_{mid}_0.tmp"]
    return names


def test_classify_equals_the_jax_witness_over_both_packages_names():
    from s3shuffle_tpu import block_ids as jax_block_ids
    from s3shuffle_tpu.utils import protowitness as jax_protowitness
    from s3shuffle_tpu_torch import block_ids

    port_names = _object_names(block_ids)
    assert port_names == _object_names(jax_block_ids)
    names = port_names + ["root/app/7/" + n for n in port_names] + ["x.txt", "shuffle_1.data"]
    got = [classify(n) for n in names]
    assert got == [jax_protowitness.classify(n) for n in names]
    assert sum(g is not None for g in got) >= 24


# ---------------------------------------------------------------------------
# Commit-op ordering over a wrapped backend
# ---------------------------------------------------------------------------


def _put(backend, path, payload=b"x"):
    with backend.create(path) as s:
        s.write(payload)


def test_post_commit_sidecar_put_flagged():
    w = ProtocolWitness()
    backend = WitnessedBackend(MemoryBackend(), w)
    _put(backend, "memory:///r/shuffle_1_2_0.data")
    _put(backend, "memory:///r/shuffle_1_2_0.index")
    assert w.violations == []
    _put(backend, "memory:///r/shuffle_1_2_par0.parity")
    assert any("AFTER the commit point" in v for v in w.violations)


def test_index_put_while_data_stream_open_flagged():
    w = ProtocolWitness()
    backend = WitnessedBackend(MemoryBackend(), w)
    data = backend.create("memory:///r/shuffle_1_2_0.data")
    data.write(b"payload")
    _put(backend, "memory:///r/shuffle_1_2_0.index")
    data.close()
    assert any("still open" in v for v in w.violations)


def test_index_reput_is_allowed():
    w = ProtocolWitness()
    backend = WitnessedBackend(MemoryBackend(), w)
    _put(backend, "memory:///r/shuffle_1_2_0.data")
    _put(backend, "memory:///r/shuffle_1_2_0.index")
    _put(backend, "memory:///r/shuffle_1_2_0.index")
    assert w.violations == []


def test_rename_counts_as_data_commit():
    w = ProtocolWitness()
    backend = WitnessedBackend(MemoryBackend(), w)
    _put(backend, "memory:///r/spill.tmp")
    assert backend.rename("memory:///r/spill.tmp", "memory:///r/shuffle_1_2_0.data")
    _put(backend, "memory:///r/shuffle_1_2_0.index")
    assert w.violations == []


def test_failed_create_retry_is_not_a_double_put():
    class _Flaky(MemoryBackend):
        def __init__(self):
            super().__init__()
            self.fail_next = True

        def create(self, path):
            if self.fail_next:
                self.fail_next = False
                raise TimeoutError("transient")
            return super().create(path)

    w = ProtocolWitness()
    backend = WitnessedBackend(_Flaky(), w)
    with pytest.raises(TimeoutError):
        backend.create("memory:///r/shuffle_1_2_0.data")
    _put(backend, "memory:///r/shuffle_1_2_0.data")
    _put(backend, "memory:///r/shuffle_1_2_0.index")
    assert w.violations == []


def test_assert_clean_raises_with_details():
    w = ProtocolWitness()
    backend = WitnessedBackend(MemoryBackend(), w)
    _put(backend, "memory:///r/shuffle_1_2_0.index")
    _put(backend, "memory:///r/shuffle_1_2_0.checksum.CRC32C")
    with pytest.raises(ProtocolViolationError, match="commit point"):
        w.assert_clean()


def test_a_violation_is_flight_recorded(tmp_path):
    """The violation lands in the flight ring as ``witness.violation`` and
    the ring is dumped."""
    from s3shuffle_tpu_torch.utils import trace

    trace.configure_flight(dir=str(tmp_path), ring=64, worker_id="pw")
    try:
        w = ProtocolWitness()
        backend = WitnessedBackend(MemoryBackend(), w)
        _put(backend, "memory:///r/shuffle_1_2_0.index")
        _put(backend, "memory:///r/shuffle_1_2_0.data")
        assert w.violations
        assert any(e.get("name") == "witness.violation" for e in list(trace._flight))
        assert any("witness_violation" in f for f in os.listdir(tmp_path))
    finally:
        trace.configure_flight(dir="", ring=trace.FLIGHT_RING_DEFAULT, worker_id="")
        trace._flight.clear()
        trace._flight_error = False


# ---------------------------------------------------------------------------
# Seal barrier: fat-index membership against tracker registration
# ---------------------------------------------------------------------------


def _fat_blob(sid=5, gid=11, mids=(20, 21)):
    members = [
        FatIndexMember(map_id=m, map_index=i, base_offset=i * 64,
                       offsets=np.array([0, 16, 32, 48, 64], dtype=np.int64))
        for i, m in enumerate(mids)
    ]
    return FatIndex(sid, gid, 4, members).to_bytes()


def test_lookup_inside_seal_window_flagged():
    w = ProtocolWitness()
    backend = WitnessedBackend(MemoryBackend(), w)
    _put(backend, "memory:///r/shuffle_5_comp_11.data")
    _put(backend, "memory:///r/shuffle_5_comp_11.cindex", _fat_blob())
    w.note_lookup(5)
    assert any("seal-barrier breach" in v for v in w.violations)


def test_lookup_after_registration_clean():
    from s3shuffle_tpu_torch.metadata.map_output import STORE_LOCATION, MapStatus

    w = ProtocolWitness()
    backend = WitnessedBackend(MemoryBackend(), w)
    _put(backend, "memory:///r/shuffle_5_comp_11.data")
    _put(backend, "memory:///r/shuffle_5_comp_11.cindex", _fat_blob())
    w.note_registered(5, [20, 21])
    w.note_lookup(5)
    w.note_read("memory:///r/shuffle_5_comp_11.data")
    assert w.violations == []
    assert MapStatus(map_id=1, location=STORE_LOCATION, sizes=[1]).map_id == 1


# ---------------------------------------------------------------------------
# End to end through the port's ShuffleContext on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("composite_maps", [0, 2], ids=["per-map-layout", "composite-commits"])
def test_witnessed_shuffle_run_is_clean(tmp_path, composite_maps):
    cfg = _config(tmp_path / "w", composite_commit_maps=composite_maps)
    with ShuffleContext(config=cfg, num_workers=2, device="cpu") as ctx:
        with protowitness.watching(ctx.manager) as w:
            _handle, expected, out = _run_shuffle(ctx)
            assert out == expected
        w.assert_clean()


def test_witnessed_coded_run_is_clean(tmp_path):
    cfg = _config(tmp_path / "coded", parity_segments=1, parity_stripe_k=2,
                  parity_chunk_bytes=1024)
    with ShuffleContext(config=cfg, num_workers=2, device="cpu") as ctx:
        with protowitness.watching(ctx.manager) as w:
            _handle, expected, out = _run_shuffle(ctx)
            assert out == expected
        w.assert_clean()


def test_env_var_installs_witness_last(tmp_path, monkeypatch):
    """The witness wraps the manager's backend above the retry layer, and
    the manager's dispatcher is the process one for its config."""
    from s3shuffle_tpu_torch.storage.retrying import RetryingBackend

    monkeypatch.setenv("S3SHUFFLE_PROTOCOL_WITNESS", "1")
    cfg = _config(tmp_path / "env")
    with ShuffleContext(config=cfg, num_workers=1, device="cpu") as ctx:
        witness = ctx.manager.protocol_witness
        assert witness is not None
        backend = ctx.manager.dispatcher.backend
        assert isinstance(backend, WitnessedBackend)
        assert isinstance(backend._inner, RetryingBackend)
        assert ctx.manager.dispatcher is Dispatcher.get(cfg)
        _handle, expected, out = _run_shuffle(ctx, n_maps=2)
        assert out == expected
        witness.assert_clean()
    assert protowitness.drain_installed() == [witness]


def test_env_var_off_means_nothing_wrapped(tmp_path, monkeypatch):
    for value in ("", "0", "false", "off"):
        monkeypatch.setenv("S3SHUFFLE_PROTOCOL_WITNESS", value)
        Dispatcher.reset()
        cfg = _config(tmp_path / f"off{value}")
        with ShuffleContext(config=cfg, num_workers=1, device="cpu") as ctx:
            assert ctx.manager.protocol_witness is None
            assert not isinstance(ctx.manager.dispatcher.backend, WitnessedBackend)
            assert not isinstance(ctx.manager.tracker, protowitness.WitnessedTracker)
    assert protowitness.drain_installed() == []


# ---------------------------------------------------------------------------
# The seal barrier taken out: the witness catches the record-loss race
# ---------------------------------------------------------------------------


def test_seal_barrier_revert_caught_by_witness(tmp_path, monkeypatch):
    """Without ``_await_seals``, thread B's seal lands the fat index and
    parks before the registration callback; the main thread's reader, whose
    barrier flush now returns at once, looks the map outputs up inside the
    window. The witness flags it."""
    from s3shuffle_tpu_torch.write.composite_commit import CompositeCommitAggregator

    cfg = _config(tmp_path / "revert", composite_commit_maps=8)
    monkeypatch.setattr(CompositeCommitAggregator, "_await_seals",
                        lambda self, shuffle_id: None)
    with ShuffleContext(config=cfg, num_workers=2, device="cpu") as ctx:
        with protowitness.watching(ctx.manager) as w:
            records = _records()
            sid = next(ctx._next_shuffle_id)
            handle = ctx.manager.register_shuffle(
                sid, ShuffleDependency(sid, HashPartitioner(N_PARTS)))
            for map_id in range(2):
                wtr = ctx.manager.get_writer(handle, map_id)
                wtr.write(records[map_id * 400:(map_id + 1) * 400])
                wtr.stop(success=True)
            agg = ctx.manager.composite
            committed_evt, resume_evt = threading.Event(), threading.Event()
            original_commit = agg.on_group_commit

            def parked_commit(shuffle_id, members):
                committed_evt.set()
                assert resume_evt.wait(10)
                original_commit(shuffle_id, members)

            agg.on_group_commit = parked_commit
            sealer = threading.Thread(target=agg.flush_shuffle, args=(sid,), daemon=True)
            sealer.start()
            assert committed_evt.wait(10)
            try:
                # the port's read() is a generator: the scan (and its
                # lookup) starts when it is consumed
                list(ctx.manager.get_reader(handle, 0, 1).read())
            finally:
                resume_evt.set()
                sealer.join(timeout=10)
            assert any("seal-barrier breach" in v for v in w.violations), \
                "witness missed the record-loss race:\n" + "\n".join(w.violations)


def test_seal_barrier_kept_the_same_interleaving_is_clean(tmp_path):
    """The same parked seal with the barrier in place: the reader waits the
    seal out, and the witness sees no breach."""
    cfg = _config(tmp_path / "kept", composite_commit_maps=8)
    with ShuffleContext(config=cfg, num_workers=2, device="cpu") as ctx:
        with protowitness.watching(ctx.manager) as w:
            records = _records()
            sid = next(ctx._next_shuffle_id)
            handle = ctx.manager.register_shuffle(
                sid, ShuffleDependency(sid, HashPartitioner(N_PARTS)))
            for map_id in range(2):
                wtr = ctx.manager.get_writer(handle, map_id)
                wtr.write(records[map_id * 400:(map_id + 1) * 400])
                wtr.stop(success=True)
            agg = ctx.manager.composite
            committed_evt = threading.Event()
            original_commit = agg.on_group_commit

            def parked_commit(shuffle_id, members):
                committed_evt.set()
                time.sleep(0.2)
                original_commit(shuffle_id, members)

            agg.on_group_commit = parked_commit
            sealer = threading.Thread(target=agg.flush_shuffle, args=(sid,), daemon=True)
            sealer.start()
            assert committed_evt.wait(10)
            got = []
            for rid in range(N_PARTS):
                got.extend(ctx.manager.get_reader(handle, rid, rid + 1).read())
            sealer.join(timeout=10)
            assert sorted(got) == sorted(records)
        w.assert_clean()


# ---------------------------------------------------------------------------
# A worker process vouches for its commit protocol
# ---------------------------------------------------------------------------

#: ``worker.main`` in a fresh interpreter; with ``inject`` the agent, once
#: drained, PUTs an object of a unit after that unit's index through its
#: manager's (witnessed) backend
WORKER_MAIN = r'''
import sys
from s3shuffle_tpu_torch import worker
if sys.argv[1] == "inject":
    real = worker.WorkerAgent.run_forever

    def run_forever(self, *args, **kwargs):
        real(self, *args, **kwargs)
        backend = self.manager.dispatcher.backend
        root = self.manager.dispatcher.config.root_dir
        for name in ("shuffle_99_0_0.index", "shuffle_99_0_0.data"):
            with backend.create(root + name) as s:
                s.write(b"x")

    worker.WorkerAgent.run_forever = run_forever
sys.exit(worker.main(sys.argv[2:]))
'''


@pytest.mark.parametrize("mode", ["clean", "inject"])
def test_worker_exit_code_vouches_for_its_commit_protocol(tmp_path, mode):
    from torch_fleet_support import JOIN_S, PORT, batches, config, records, sorted_records

    cfg = config(PORT, tmp_path / "store", codec="zlib")
    driver = PORT.cluster.DistributedDriver(cfg)
    env = {k: v for k, v in os.environ.items()
           if k != "PYTHONPATH" and not k.startswith("S3SHUFFLE_")}
    env.update(PYTHONPATH=REPO, S3SHUFFLE_PROTOCOL_WITNESS="1",
               S3SHUFFLE_ROOT_DIR=cfg.root_dir, S3SHUFFLE_APP_ID=cfg.app_id,
               S3SHUFFLE_CODEC="zlib", S3SHUFFLE_CHECKSUM_ALGORITHM="CRC32C")
    proc = subprocess.Popen(
        [sys.executable, "-c", WORKER_MAIN, mode, "--coordinator",
         "%s:%d" % driver.coordinator_address, "--device", "cpu", "--worker-id", "w-pw",
         "--metrics-port", "0", "--poll-interval", "0.01"],
        env=env, cwd=str(tmp_path), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    try:
        deadline = time.monotonic() + JOIN_S
        while driver.server.membership.state_of("w-pw") != "active":
            assert proc.poll() is None, f"the worker exited: {proc.returncode}"
            assert time.monotonic() < deadline, "the worker never registered"
            time.sleep(0.05)
        recs = records(19, 600)
        out = driver.run_sort_shuffle(batches(PORT, recs, 3), num_partitions=4)
        assert sorted_records(out) == sorted(recs)
        driver.drain_workers(["w-pw"])
        _out, err = proc.communicate(timeout=JOIN_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=JOIN_S)
        driver.shutdown()
    if mode == "clean":
        assert proc.returncode == 0, err[-4000:]
    else:
        assert proc.returncode != 0
        assert "ProtocolViolationError" in err and "AFTER the commit point" in err, err[-4000:]
