"""The port's fault injector (``storage/fault.py``) and its fail-fast
contracts against the JAX package, on the CPU.

The fail-fast cases of the JAX suite (tests/test_fault_injection.py) run
through both packages' ``ShuffleContext`` under ``storage_retries`` 0 and
3: their rules inject the generic ``injected fault`` OSError, which the
retry layer classifies terminal, so both settings behave alike. The
injector's own pieces (seeded rules, latency and bandwidth rules, the
transient factories, the flaky streams) are held against the JAX copies.
Tolerance 0; every assertion is deterministic.
"""

import io
import random

import pytest

from s3shuffle_tpu.config import ShuffleConfig as JaxConfig
from s3shuffle_tpu.dependency import HashPartitioner as JaxHashPartitioner
from s3shuffle_tpu.dependency import ShuffleDependency as JaxDependency
from s3shuffle_tpu.read.checksum_stream import ChecksumError as JaxChecksumError
from s3shuffle_tpu.shuffle import ShuffleContext as JaxContext
from s3shuffle_tpu.storage import backend as jax_backend
from s3shuffle_tpu.storage import fault as jax_fault
from s3shuffle_tpu.storage.dispatcher import Dispatcher as JaxDispatcher
from s3shuffle_tpu_torch import ShuffleConfig, ShuffleContext
from s3shuffle_tpu_torch.dependency import HashPartitioner, ShuffleDependency
from s3shuffle_tpu_torch.read.checksum_stream import ChecksumError
from s3shuffle_tpu_torch.storage import backend as port_backend
from s3shuffle_tpu_torch.storage import fault as port_fault
from torch_jax_native import jax_native_library  # noqa: F401  (loads the JAX oracle's native library)
from torch_port_dispatcher import port_dispatcher_reset  # noqa: F401  (resets the port's process dispatcher)

FAULT = {"port": port_fault, "jax": jax_fault}
LOGGERS = {"port": "s3shuffle_tpu_torch", "jax": "s3shuffle_tpu"}
RETRY_SETTINGS = [0, 3]


def make_flaky_ctx(pkg, tmp_path, **overrides):
    knobs = dict(root_dir=f"file://{tmp_path}/{pkg}", app_id="fault-app", cleanup=True,
                 codec_block_size=2048, codec_batch_blocks=4, max_concurrency_task=4)
    knobs.update(overrides)
    if pkg == "jax":
        JaxDispatcher.reset()
        ctx = JaxContext(config=JaxConfig(**knobs), num_workers=2)
    else:
        ctx = ShuffleContext(config=ShuffleConfig(**knobs), num_workers=2, device="cpu")
    disp = ctx.manager.dispatcher
    flaky = FAULT[pkg].FlakyBackend(disp.backend)
    disp.backend = flaky
    return ctx, flaky


def write_one_shuffle(pkg, ctx, n_records=2000, n_parts=3):
    dep_cls, part_cls = ((JaxDependency, JaxHashPartitioner) if pkg == "jax"
                         else (ShuffleDependency, HashPartitioner))
    rng = random.Random(0)
    records = [(rng.randbytes(8), rng.randbytes(16)) for _ in range(n_records)]
    sid = next(ctx._next_shuffle_id)
    handle = ctx.manager.register_shuffle(sid, dep_cls(sid, part_cls(n_parts)))
    w = ctx.manager.get_writer(handle, 0)
    w.write(records)
    w.stop(success=True)
    return handle, records, n_parts


def read_all(ctx, handle, n_parts):
    out = []
    for rid in range(n_parts):
        out.extend(ctx.manager.get_reader(handle, rid, rid + 1).read())
    return out


@pytest.mark.parametrize("storage_retries", RETRY_SETTINGS)
def test_persistent_read_fault_surfaces_as_eof(tmp_path, caplog, storage_retries):
    for pkg in FAULT:
        ctx, flaky = make_flaky_ctx(pkg, tmp_path, checksum_enabled=False,
                                    storage_retries=storage_retries)
        handle, _records, n_parts = write_one_shuffle(pkg, ctx)
        flaky.add_rule(FAULT[pkg].FaultRule("read", match=".data", times=None))
        caplog.clear()
        with caplog.at_level("ERROR", logger=LOGGERS[pkg] + ".read"):
            assert read_all(ctx, handle, n_parts) == [], pkg  # every data read EOFs
        assert any("injected fault" in r.message for r in caplog.records), pkg
        ctx.stop()


@pytest.mark.parametrize("storage_retries", RETRY_SETTINGS)
def test_read_fault_with_checksum_is_detected(tmp_path, storage_retries):
    for pkg, error in (("port", ChecksumError), ("jax", JaxChecksumError)):
        ctx, flaky = make_flaky_ctx(pkg, tmp_path, checksum_enabled=True,
                                    storage_retries=storage_retries)
        handle, _records, n_parts = write_one_shuffle(pkg, ctx)
        # fail from the second read on: the stream EOFs mid-partition
        flaky.add_rule(FAULT[pkg].FaultRule("read", match=".data", times=None, skip=1))
        with pytest.raises(error):
            read_all(ctx, handle, n_parts)
        ctx.stop()


@pytest.mark.parametrize("storage_retries", RETRY_SETTINGS)
def test_an_open_fault_fails_the_task_and_a_rerun_reads_everything(tmp_path, storage_retries):
    outs = {}
    for pkg in FAULT:
        ctx, flaky = make_flaky_ctx(pkg, tmp_path, checksum_enabled=True,
                                    storage_retries=storage_retries)
        handle, records, n_parts = write_one_shuffle(pkg, ctx)
        rule = flaky.add_rule(FAULT[pkg].FaultRule("open", match=".data", times=2))
        for _ in range(2):
            with pytest.raises(OSError):
                read_all(ctx, handle, n_parts)
        outs[pkg] = sorted(read_all(ctx, handle, n_parts))  # the rule is spent
        assert outs[pkg] == sorted(records) and rule.hits == 2, pkg
        ctx.stop()
    assert outs["port"] == outs["jax"]


@pytest.mark.parametrize("storage_retries", RETRY_SETTINGS)
def test_delete_faults_are_swallowed_per_prefix(tmp_path, caplog, storage_retries):
    for pkg in FAULT:
        ctx, flaky = make_flaky_ctx(pkg, tmp_path, storage_retries=storage_retries)
        handle, _records, _n = write_one_shuffle(pkg, ctx)
        flaky.add_rule(FAULT[pkg].FaultRule("delete", times=None))
        caplog.clear()
        with caplog.at_level("WARNING", logger=LOGGERS[pkg] + ".dispatcher"):
            ctx.manager.unregister_shuffle(handle.shuffle_id)  # must not raise
        assert any("delete of" in r.message for r in caplog.records), pkg
        ctx.stop()


@pytest.mark.parametrize("storage_retries", RETRY_SETTINGS)
def test_index_fault_fails_enumeration_in_metadata_mode(tmp_path, storage_retries):
    for pkg in FAULT:
        ctx, flaky = make_flaky_ctx(pkg, tmp_path, storage_retries=storage_retries)
        handle, _records, n_parts = write_one_shuffle(pkg, ctx)
        ctx.manager.helper.purge_cached_data_for_shuffle(handle.shuffle_id)
        flaky.add_rule(FAULT[pkg].FaultRule("open", match=".index", times=None))
        with pytest.raises(OSError):
            read_all(ctx, handle, n_parts)
        ctx.stop()


@pytest.mark.parametrize("storage_retries", RETRY_SETTINGS)
def test_write_fault_aborts_commit_and_leaves_no_index(tmp_path, storage_retries):
    for pkg in FAULT:
        ctx, flaky = make_flaky_ctx(pkg, tmp_path, storage_retries=storage_retries)
        dep_cls, part_cls = ((JaxDependency, JaxHashPartitioner) if pkg == "jax"
                             else (ShuffleDependency, HashPartitioner))
        sid = next(ctx._next_shuffle_id)
        handle = ctx.manager.register_shuffle(sid, dep_cls(sid, part_cls(2)))
        flaky.add_rule(FAULT[pkg].FaultRule("write", times=None))
        w = ctx.manager.get_writer(handle, 0)
        with pytest.raises(OSError):
            w.write([(b"k", b"v")] * 10)
            w.stop(success=True)
        w.stop(success=False)
        assert not [st for st in flaky.list_prefix(f"file://{tmp_path}/{pkg}")
                    if ".index" in st.path], pkg
        ctx.stop()


@pytest.mark.parametrize("storage_retries", RETRY_SETTINGS)
def test_a_transient_open_fault_above_the_retry_layer_fails_the_task(tmp_path,
                                                                    storage_retries):
    """A transient-shaped open fault injected ABOVE the retry layer. At 0 no
    retry path exists: each of two reads fails, the rerun reads everything.
    At 3 the layer that re-drives opens sits below the fault, but
    ``BlockStream`` makes its one fresh open after the failed first one, so
    one read spends both faults; the packages fail the same reads."""
    failed = {}
    for pkg in FAULT:
        ctx, flaky = make_flaky_ctx(pkg, tmp_path, checksum_enabled=True,
                                    storage_retries=storage_retries)
        handle, records, n_parts = write_one_shuffle(pkg, ctx)
        rule = flaky.add_rule(FAULT[pkg].FaultRule(
            "open", match=".data", times=2, exc=FAULT[pkg].transient_connection_reset))
        failures = 0
        for _ in range(3):
            try:
                out = read_all(ctx, handle, n_parts)
            except OSError:
                failures += 1
        assert rule.hits == 2 and sorted(out) == sorted(records), pkg
        failed[pkg] = failures
        ctx.stop()
    assert failed["port"] == failed["jax"] == (2 if storage_retries == 0 else 1)


@pytest.mark.parametrize("storage_retries", RETRY_SETTINGS)
def test_parallel_delete_fault_warns_and_continues(tmp_path, caplog, storage_retries):
    from s3shuffle_tpu.block_ids import ShuffleDataBlockId as JaxData
    from s3shuffle_tpu.block_ids import ShuffleIndexBlockId as JaxIndex
    from s3shuffle_tpu_torch.block_ids import ShuffleDataBlockId, ShuffleIndexBlockId
    from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher

    left = {}
    for pkg in FAULT:
        root = f"file://{tmp_path}/{pkg}"
        if pkg == "jax":
            JaxDispatcher.reset()
            disp = JaxDispatcher(JaxConfig(root_dir=root, app_id="sweep-app",
                                           storage_retries=storage_retries))
            blocks = (JaxData, JaxIndex)
        else:
            disp = Dispatcher(ShuffleConfig(root_dir=root, app_id="sweep-app",
                                            storage_retries=storage_retries))
            blocks = (ShuffleDataBlockId, ShuffleIndexBlockId)
        flaky = FAULT[pkg].FlakyBackend(disp.backend)
        disp.backend = flaky
        for mid in (0, 1, 2):
            for block in blocks:
                with disp.backend.create(disp.get_path(block(3, mid))) as s:
                    s.write(b"payload")
        flaky.add_rule(FAULT[pkg].FaultRule("delete", match="/1/sweep-app", times=None))
        caplog.clear()
        with caplog.at_level("WARNING", logger=LOGGERS[pkg] + ".dispatcher"):
            disp.remove_shuffle(3)  # must not raise
        assert any("delete of" in r.message and "failed" in r.message
                   for r in caplog.records), pkg
        left[pkg] = sorted(st.path.rsplit(f"{pkg}/", 1)[1] for st in flaky.list_prefix(root))
    assert left["port"] == left["jax"]
    assert len(left["port"]) == 2 and all(p.startswith("1/sweep-app/") for p in left["port"])


# --- the injector itself ---

def test_rule_matching_and_counters():
    for pkg, backend in (("port", port_backend), ("jax", jax_backend)):
        flaky = FAULT[pkg].FlakyBackend(backend.MemoryBackend())
        rule = flaky.add_rule(FAULT[pkg].FaultRule("open", match="a/b", times=1, skip=1))
        with flaky.create("memory:///a/b/x") as s:
            s.write(b"data")
        flaky.open_ranged("memory:///a/b/x")  # skip=1: passes
        with pytest.raises(OSError, match="injected fault"):
            flaky.open_ranged("memory:///a/b/x")
        flaky.open_ranged("memory:///a/b/x")  # spent: passes
        assert rule.hits == 1 and flaky.calls["open"] == 3, pkg
        with pytest.raises(ValueError):
            FAULT[pkg].FaultRule("frobnicate")
        with pytest.raises(ValueError):
            FAULT[pkg].FaultRule("read", prob=1.5)
        with pytest.raises(ValueError):
            FAULT[pkg].LatencyRule("frobnicate")
        with pytest.raises(ValueError):
            FAULT[pkg].BandwidthRule("read", mib_s=0)
    assert port_fault.OPS == jax_fault.OPS


@pytest.mark.parametrize("prob,seed,times", [(0.05, 11, None), (0.3, 22, None), (0.5, 33, 4)])
def test_seeded_rule_fires_on_the_same_calls_as_jax(prob, seed, times):
    fired = {}
    for pkg in FAULT:
        rule = FAULT[pkg].FaultRule("read", prob=prob, rng_seed=seed, times=times,
                                    exc=FAULT[pkg].transient_connection_reset)
        fired[pkg] = []
        for call in range(400):
            try:
                rule.maybe_raise("read", f"x/obj{call % 7}.data")
                rule.maybe_raise("open", "x/obj.data")  # another op: no draw
            except ConnectionResetError:
                fired[pkg].append(call)
        assert rule.hits == len(fired[pkg])
    assert fired["port"] == fired["jax"] and fired["port"]
    if times is not None:
        assert len(fired["port"]) == times


@pytest.mark.parametrize("name", ["reset", "timeout", "503"])
def test_transient_factories_equal_jax(name):
    assert sorted(port_fault.TRANSIENT_FACTORIES) == sorted(jax_fault.TRANSIENT_FACTORIES)
    port = port_fault.TRANSIENT_FACTORIES[name]("s3://b/shuffle_1_2_0.data")
    jax = jax_fault.TRANSIENT_FACTORIES[name]("s3://b/shuffle_1_2_0.data")
    assert (type(port), port.errno, str(port)) == (type(jax), jax.errno, str(jax))


def test_latency_and_bandwidth_rules_count_like_jax():
    counts = {}
    for pkg, backend in (("port", port_backend), ("jax", jax_backend)):
        fault = FAULT[pkg]
        flaky = fault.FlakyBackend(backend.MemoryBackend())
        lat = flaky.add_latency(fault.LatencyRule("open", match=".data", delay_s=0.0, times=2))
        bw = flaky.add_latency(fault.BandwidthRule("read", match=".data", mib_s=1e9))
        wbw = flaky.add_latency(fault.BandwidthRule("write", mib_s=1e9))
        with flaky.create("memory:///a/x.data") as s:
            s.write(b"0123456789")
            s.write(memoryview(b"abc"))
        for _ in range(3):
            with flaky.open_ranged("memory:///a/x.data") as r:
                assert r.read_fully(2, 5) == b"23456"
                assert r.read_fully(0, 0) == b""  # no bytes: free
        flaky.status("memory:///a/x.data")
        flaky.list_prefix("memory:///a")
        assert flaky.rename("memory:///a/x.data", "memory:///a/y.data")
        flaky.delete("memory:///a/y.data")
        flaky.delete_prefix("memory:///a")
        counts[pkg] = (lat.hits, bw.hits, bw.bytes, wbw.hits, wbw.bytes, dict(flaky.calls))
    assert counts["port"] == counts["jax"]
    assert counts["port"][:5] == (2, 3, 15, 2, 13)


def test_flaky_write_stream_close_and_flush_like_jax():
    for pkg in FAULT:
        sink = io.BytesIO()
        stream = FAULT[pkg]._FlakyWriteStream(sink, "p", lambda *a, **k: None)
        stream.write(b"abc")
        stream.flush()
        assert sink.getvalue() == b"abc" and stream.writable()
        stream.close()
        stream.close()  # idempotent
        assert sink.closed and stream.closed
