"""The port's resilient storage plane against the JAX package, on the CPU:
exception classification, full-jitter backoff, ``retry_call`` and
``RetryingBackend``, the commit re-drives of the index, checksum and parity
PUTs, ``BlockStream``'s reopen of a poisoned handle, the dispatcher's
FileStatus cache, the fsspec backend, and a seeded fault soak through both
packages' ``ShuffleContext``.

Tolerance 0: every comparison is exact. Oracles are deterministic: backoff
sleeps are injected (or the soak's 1 ms base), request sequences are
compared at one prefetch thread, and concurrent runs assert outputs and
rule hits, never which call a seeded rule failed.
"""

import errno
import os
import random
import sys
import threading

import numpy as np
import pytest

from s3shuffle_tpu.block_ids import ShuffleDataBlockId as JaxDataBlockId
from s3shuffle_tpu.config import ShuffleConfig as JaxConfig
from s3shuffle_tpu.dependency import HashPartitioner as JaxHashPartitioner
from s3shuffle_tpu.dependency import ShuffleDependency as JaxDependency
from s3shuffle_tpu.dependency import natural_key as jax_natural_key
from s3shuffle_tpu.manager import ShuffleManager as JaxManager
from s3shuffle_tpu.metadata.helper import ShuffleHelper as JaxHelper
from s3shuffle_tpu.metadata.map_output import MapStatus as JaxMapStatus
from s3shuffle_tpu.read.checksum_stream import ChecksumError as JaxChecksumError
from s3shuffle_tpu.serializer import ColumnarKVSerializer as JaxColumnarKV
from s3shuffle_tpu.shuffle import ShuffleContext as JaxContext
from s3shuffle_tpu.storage import backend as jax_backend
from s3shuffle_tpu.storage import fault as jax_fault
from s3shuffle_tpu.storage import fsspec_backend as jax_fsspec
from s3shuffle_tpu.storage import retrying as jax_retrying
from s3shuffle_tpu.storage.dispatcher import Dispatcher as JaxDispatcher
from s3shuffle_tpu.storage.local import LocalBackend as JaxLocalBackend
from s3shuffle_tpu.write.map_output_writer import MapOutputWriter as JaxMapOutputWriter
from s3shuffle_tpu_torch import ShuffleConfig, ShuffleContext, ShuffleManager
from s3shuffle_tpu_torch.batch import RecordBatch
from s3shuffle_tpu_torch.block_ids import ShuffleDataBlockId
from s3shuffle_tpu_torch.dependency import HashPartitioner, ShuffleDependency, natural_key
from s3shuffle_tpu_torch.metadata.helper import ShuffleHelper
from s3shuffle_tpu_torch.metadata.map_output import STORE_LOCATION, MapStatus
from s3shuffle_tpu_torch.read.checksum_stream import ChecksumError
from s3shuffle_tpu_torch.serializer import ColumnarKVSerializer
from s3shuffle_tpu_torch.storage import backend as port_backend
from s3shuffle_tpu_torch.storage import fault as port_fault
from s3shuffle_tpu_torch.storage import fsspec_backend as port_fsspec
from s3shuffle_tpu_torch.storage import retrying as port_retrying
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
from s3shuffle_tpu_torch.storage.local import LocalBackend
from s3shuffle_tpu_torch.write.map_output_writer import MapOutputWriter
from torch_jax_native import jax_native_library  # noqa: F401  (loads the JAX oracle's native library)
from torch_port_dispatcher import port_dispatcher_reset  # noqa: F401  (resets the port's process dispatcher)

#: each package's storage plane, so one scenario runs through both
PACKAGES = {
    "port": dict(retrying=port_retrying, fault=port_fault, backend=port_backend,
                 fsspec=port_fsspec, checksum_error=ChecksumError, dispatcher=Dispatcher,
                 config=ShuffleConfig),
    "jax": dict(retrying=jax_retrying, fault=jax_fault, backend=jax_backend,
                fsspec=jax_fsspec, checksum_error=JaxChecksumError,
                dispatcher=JaxDispatcher, config=JaxConfig),
}


def _no_sleep(_s):
    pass


def _stack(pkg, rules, policy=None, **kw):
    """Retrying over Flaky over Memory: the faults land under the retry
    layer, as in a deployment."""
    mods = PACKAGES[pkg]
    flaky = mods["fault"].FlakyBackend(mods["backend"].MemoryBackend(), rules=rules)
    policy = policy or mods["retrying"].RetryPolicy(retries=3, base_ms=0.01)
    backend = mods["retrying"].RetryingBackend(flaky, policy, sleep=_no_sleep, **kw)
    return backend, flaky


def _both(scenario):
    """Run ``scenario(pkg)`` through both packages; the observations must be
    equal. Returns the port's."""
    port, jax = scenario("port"), scenario("jax")
    assert port == jax
    return port


# --- classification ---

#: (exception for a package, expected): the JAX suite's table
#: (tests/test_retry_backend.py) and more edges
CLASSIFY = {
    "file-not-found": (lambda m: FileNotFoundError("gone"), False),
    "permission": (lambda m: PermissionError("no"), False),
    "is-a-directory": (lambda m: IsADirectoryError("d"), False),
    "checksum-error": (lambda m: m["checksum_error"]("Invalid checksum for shuffle_1_0_0"), False),
    "generic-injected": (lambda m: OSError("injected fault: x"), False),
    "403-access-denied": (lambda m: OSError("403 AccessDenied on GET"), False),
    "not-an-oserror": (lambda m: ValueError("not even an OSError"), False),
    "runtime-503": (lambda m: RuntimeError("HTTP 503"), False),
    "credential": (lambda m: OSError("Unable to locate credentials"), False),
    "conn-reset": (lambda m: ConnectionResetError(errno.ECONNRESET, "reset by peer"), True),
    "conn-aborted": (lambda m: ConnectionAbortedError(errno.ECONNABORTED, "aborted"), True),
    "broken-pipe": (lambda m: BrokenPipeError(errno.EPIPE, "pipe"), True),
    "timeout-error": (lambda m: TimeoutError("timed out"), True),
    "etimedout": (lambda m: OSError(errno.ETIMEDOUT, "timed out"), True),
    "eagain": (lambda m: OSError(errno.EAGAIN, "try again"), True),
    "http-503-slowdown": (lambda m: OSError("HTTP 503 Service Unavailable (SlowDown)"), True),
    "500-internal": (lambda m: OSError("500 Internal Server Error"), True),
    "429": (lambda m: OSError("429 Too Many Requests"), True),
    "gateway-timeout": (lambda m: OSError("Gateway Timeout from proxy"), True),
    "503-with-403-in-path": (lambda m: OSError(
        "HTTP 503 Service Unavailable (SlowDown): s3://b/shuffle_3_403_0.data"), True),
    "paren-503": (lambda m: OSError("An error occurred (503) on GET"), True),
    "503-in-tmp-path": (lambda m: OSError(
        "injected fault: /tmp/pytest-of-root/pytest-503/x.data"), False),
    "500-in-object-name": (lambda m: OSError("read failed on shuffle_1_500_0.data"), False),
    "paren-403-forbidden": (lambda m: OSError("An error occurred (403): Forbidden"), False),
    "factory-reset": (lambda m: m["fault"].transient_connection_reset("some/path"), True),
    "factory-timeout": (lambda m: m["fault"].transient_timeout("some/path"), True),
    "factory-503": (lambda m: m["fault"].transient_http_503("some/path"), True),
}


@pytest.mark.parametrize("case", sorted(CLASSIFY))
def test_is_retriable_agrees_with_jax(case):
    make, expected = CLASSIFY[case]
    got = {pkg: mods["retrying"].is_retriable(make(mods)) for pkg, mods in PACKAGES.items()}
    assert got == {"port": expected, "jax": expected}


def test_classification_tables_equal_jax():
    for name in ("RETRIABLE_ERRNOS", "TRANSIENT_MARKERS", "TERMINAL_MARKERS"):
        assert getattr(port_retrying, name) == getattr(jax_retrying, name), name
    for name in ("_TRANSIENT_CODE_RE", "_TERMINAL_CODE_RE"):
        assert getattr(port_retrying, name).pattern == getattr(jax_retrying, name).pattern


@pytest.mark.parametrize("policy", [(3, 50.0, 30.0, 5.0), (6, 1.0, 0.0, 5.0),
                                    (8, 400.0, 30.0, 1.5)], ids=["defaults", "1ms", "capped"])
@pytest.mark.parametrize("seed", [0, 7])
def test_backoff_draws_equal_jax(policy, seed):
    draws = {}
    for pkg, mods in PACKAGES.items():
        p = mods["retrying"].RetryPolicy(*policy)
        rng = random.Random(seed)
        draws[pkg] = [p.backoff_s(a, rng) for a in range(policy[0] + 4)]
    assert draws["port"] == draws["jax"]
    for a, d in enumerate(draws["port"]):
        assert 0.0 <= d <= min(policy[3], policy[1] / 1000.0 * 2.0 ** a)


def test_policy_from_config_equals_jax():
    for knobs in ({}, {"storage_retries": 0}, {"storage_retries": 5, "storage_retry_base_ms": 2.5,
                                                "storage_op_deadline_s": 0.0}):
        port = port_retrying.RetryPolicy.from_config(ShuffleConfig(**knobs))
        jax = jax_retrying.RetryPolicy.from_config(JaxConfig(**knobs))
        assert (port is None) == (jax is None)
        if port is not None:
            assert (port.retries, port.base_ms, port.deadline_s, port.max_backoff_s) == \
                (jax.retries, jax.base_ms, jax.deadline_s, jax.max_backoff_s)


# --- retry_call and RetryingBackend: the JAX suite's cases, both packages ---

def test_retriable_fault_heals_within_budget():
    def scenario(pkg):
        f = PACKAGES[pkg]["fault"]
        backend, flaky = _stack(pkg, [f.FaultRule("open", times=2,
                                                  exc=f.transient_connection_reset)])
        with backend.create("memory:///a/x") as s:
            s.write(b"payload")
        with backend.open_ranged("memory:///a/x") as r:
            data = r.read_fully(0, r.size)
        return data, flaky.calls["open"]

    assert _both(scenario) == (b"payload", 3)


def test_retries_exhausted_raise_the_last_error():
    def scenario(pkg):
        mods = PACKAGES[pkg]
        backend, flaky = _stack(
            pkg, [mods["fault"].FaultRule("status", times=None,
                                          exc=mods["fault"].transient_http_503)],
            policy=mods["retrying"].RetryPolicy(retries=2, base_ms=0.01))
        with pytest.raises(OSError, match="503") as info:
            backend.status("memory:///a/x")
        return str(info.value), flaky.calls["status"]

    assert _both(scenario)[1] == 3


def test_terminal_error_is_never_retried():
    def scenario(pkg):
        f = PACKAGES[pkg]["fault"]
        backend, flaky = _stack(pkg, [f.FaultRule("open", times=None,
                                                  exc=lambda p: FileNotFoundError(p))])
        with pytest.raises(FileNotFoundError):
            backend.open_ranged("memory:///a/missing")
        return flaky.calls["open"]

    assert _both(scenario) == 1


@pytest.mark.parametrize("seed", [3, 7])
def test_backoff_sleeps_equal_jax_for_a_seeded_rng(seed):
    def scenario(pkg):
        mods = PACKAGES[pkg]
        sleeps = []
        backend, _flaky = _stack(
            pkg, [mods["fault"].FaultRule("status", times=None,
                                          exc=mods["fault"].transient_timeout)],
            policy=mods["retrying"].RetryPolicy(retries=4, base_ms=100.0, deadline_s=0,
                                                max_backoff_s=60.0),
            rng=random.Random(seed))
        object.__setattr__(backend, "_sleep", sleeps.append)
        with pytest.raises(OSError):
            backend.status("memory:///a/x")
        return sleeps

    sleeps = _both(scenario)
    assert len(sleeps) == 4 and any(s > 0 for s in sleeps)
    for attempt, slept in enumerate(sleeps):
        assert 0.0 <= slept <= 0.1 * 2.0 ** attempt


def test_deadline_bounds_the_op_on_a_fake_clock():
    def scenario(pkg):
        mods = PACKAGES[pkg]
        clock = {"now": 0.0}

        def fake_sleep(s):
            clock["now"] += s

        flaky = mods["fault"].FlakyBackend(
            mods["backend"].MemoryBackend(),
            rules=[mods["fault"].FaultRule("status", times=None,
                                           exc=mods["fault"].transient_timeout)])
        backend = mods["retrying"].RetryingBackend(
            flaky, mods["retrying"].RetryPolicy(retries=1000, base_ms=200.0, deadline_s=0.5,
                                                max_backoff_s=60.0),
            sleep=fake_sleep, clock=lambda: clock["now"], rng=random.Random(11))
        with pytest.raises(OSError):
            backend.status("memory:///a/x")
        return clock["now"], flaky.calls["status"]

    now, calls = _both(scenario)
    assert now <= 0.5 and 1 < calls < 1000


def test_read_retries_on_a_fresh_reader():
    def scenario(pkg):
        f = PACKAGES[pkg]["fault"]
        backend, flaky = _stack(pkg, [])
        with backend.create("memory:///a/x") as s:
            s.write(b"0123456789")
        reader = backend.open_ranged("memory:///a/x")
        opens = flaky.calls["open"]
        flaky.add_rule(f.FaultRule("read", times=2, exc=f.transient_connection_reset))
        data = reader.read_fully(2, 4)
        stale = len(reader._stale)
        reader.close()
        return data, flaky.calls["open"] - opens, stale

    # each failed read re-opened a fresh handle; the stale ones wait for close
    assert _both(scenario) == (b"2345", 2, 2)


def test_a_terminal_read_is_not_retried():
    def scenario(pkg):
        f = PACKAGES[pkg]["fault"]
        backend, flaky = _stack(pkg, [])
        with backend.create("memory:///a/x") as s:
            s.write(b"0123456789")
        reader = backend.open_ranged("memory:///a/x")
        reads = flaky.calls["read"]
        flaky.add_rule(f.FaultRule("read", times=None, exc=lambda p: OSError(f"injected fault: {p}")))
        with pytest.raises(OSError, match="injected fault"):
            reader.read_fully(0, 4)
        reader.close()
        return flaky.calls["read"] - reads

    assert _both(scenario) == 1


class _HandleCount:
    """Counts the handles a backend opens and closes (a duck-typed wrapper
    beneath the fault injector)."""

    def __init__(self, inner):
        self._inner = inner
        self.opened = self.closed = 0
        self._lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def open_ranged(self, path, size_hint=None):
        inner = self._inner.open_ranged(path, size_hint)
        with self._lock:
            self.opened += 1
        owner = self

        class Handle:
            size = inner.size
            read_fully = inner.read_fully

            def close(self):
                with owner._lock:
                    owner.closed += 1
                inner.close()

        return Handle()


def test_concurrent_reads_on_one_retrying_reader_heal_and_close_every_handle():
    """Eight threads share one ranged reader under 30 % seeded read faults
    and a short switch interval: every read returns its bytes, siblings
    swap in fresh handles at most once per failed handle, and closing the
    reader closes every handle it opened."""
    payload = bytes(range(256)) * 64
    for pkg, mods in PACKAGES.items():
        f = mods["fault"]
        counted = _HandleCount(mods["backend"].MemoryBackend())
        flaky = f.FlakyBackend(counted)
        backend = mods["retrying"].RetryingBackend(
            flaky, mods["retrying"].RetryPolicy(retries=50, base_ms=0.0, deadline_s=0),
            sleep=_no_sleep)
        with backend.create("memory:///a/x") as s:
            s.write(payload)
        reader = backend.open_ranged("memory:///a/x")
        rule = flaky.add_rule(f.FaultRule("read", prob=0.3, rng_seed=5, times=None,
                                          exc=f.transient_connection_reset))
        errors = []

        def worker(seed):
            rng = random.Random(seed)
            try:
                for _ in range(100):
                    pos = rng.randrange(len(payload))
                    n = rng.randrange(1, 512)
                    assert reader.read_fully(pos, n) == payload[pos:pos + n]
            except Exception as e:  # reported below, after every join
                errors.append(e)

        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads) and not errors, (pkg, errors)
        assert rule.hits > 100, pkg
        assert counted.opened == 1 + len(reader._stale), pkg
        reader.close()
        assert counted.closed == counted.opened, pkg


@pytest.mark.parametrize("reopen", ["transient", "terminal"])
def test_retry_call_on_retry_hook_equals_jax(reopen):
    def scenario(pkg):
        retrying = PACKAGES[pkg]["retrying"]
        calls, hooks = [], []

        def fn():
            calls.append(1)
            if len(calls) < 4:
                raise ConnectionResetError(errno.ECONNRESET, "reset")
            return "done"

        def on_retry(attempt, exc):
            hooks.append(attempt)
            if attempt == 0:
                raise (TimeoutError("reopen timed out") if reopen == "transient"
                       else FileNotFoundError("reopen: gone"))

        policy = retrying.RetryPolicy(retries=5, base_ms=1.0)
        try:
            result = retrying.retry_call(fn, policy, sleep=_no_sleep, rng=random.Random(1),
                                         on_retry=on_retry)
        except FileNotFoundError as e:
            result = f"raised {e}"
        return result, len(calls), hooks

    got = _both(scenario)
    if reopen == "transient":  # a transient reopen failure burns its attempt
        assert got == ("done", 4, [0, 1, 2])
    else:  # a terminal one ends the op
        assert got == ("raised reopen: gone", 1, [0])


def test_retry_call_without_a_policy_is_one_plain_call():
    def scenario(pkg):
        calls = []

        def boom():
            calls.append(1)
            raise ConnectionResetError(errno.ECONNRESET, "reset")

        with pytest.raises(ConnectionResetError):
            PACKAGES[pkg]["retrying"].retry_call(boom, None)
        return len(calls)

    assert _both(scenario) == 1


def _chain(backend):
    chain = [type(backend).__name__]
    while hasattr(backend, "inner"):
        backend = backend.inner
        chain.append(type(backend).__name__)
    return chain


@pytest.mark.parametrize("scheme", ["file", "memory", "local"])
def test_retry_layer_is_stacked_by_default_and_bypassed_at_zero(tmp_path, scheme):
    root = {"file": f"file://{tmp_path}/s", "memory": f"memory://stack-{tmp_path.name}",
            "local": f"local://{tmp_path}/s"}[scheme]
    for pkg, mods in PACKAGES.items():
        if pkg == "jax":
            JaxDispatcher.reset()
        disp = mods["dispatcher"](mods["config"](root_dir=root))
        chain = _chain(disp.backend)
        assert chain[0] == "RetryingBackend" and len(chain) == 2, (pkg, chain)
        assert disp.retry_policy.retries == 3 and disp.backend.scheme == scheme
        assert disp.supports_rename == (scheme != "local")
        if pkg == "jax":
            JaxDispatcher.reset()
        bare = mods["dispatcher"](mods["config"](root_dir=root, storage_retries=0))
        assert "RetryingBackend" not in _chain(bare.backend) and bare.retry_policy is None
        assert mods["retrying"].RetryPolicy.from_config(bare.config) is None


def test_retry_knobs_parse_and_validate_like_jax():
    env = {"S3SHUFFLE_STORAGE_RETRIES": "5", "S3SHUFFLE_STORAGE_RETRY_BASE_MS": "12.5",
           "S3SHUFFLE_STORAGE_OP_DEADLINE_S": "7.5"}
    knobs = ("storage_retries", "storage_retry_base_ms", "storage_op_deadline_s")
    for port, jax in ((ShuffleConfig.from_env(env), JaxConfig.from_env(env)),
                      (ShuffleConfig.from_dict({"storage_retries": "0"}),
                       JaxConfig.from_dict({"storage_retries": "0"})),
                      (ShuffleConfig(), JaxConfig())):
        assert [getattr(port, k) for k in knobs] == [getattr(jax, k) for k in knobs]
    assert [getattr(ShuffleConfig.from_env(env), k) for k in knobs] == [5, 12.5, 7.5]
    assert [getattr(ShuffleConfig(), k) for k in knobs] == [3, 50.0, 30.0]
    for bad in ({"storage_retries": -1}, {"storage_retry_base_ms": -1.0},
                {"storage_op_deadline_s": -0.5}):
        for cls in (ShuffleConfig, JaxConfig):
            with pytest.raises(ValueError, match="storage retry knobs"):
                cls(**bad)


def test_test_hooks_delegate_through_the_retry_layer():
    def scenario(pkg):
        mods = PACKAGES[pkg]
        if pkg == "jax":
            JaxDispatcher.reset()
        root = f"memory://hooks-{pkg}"
        disp = mods["dispatcher"](mods["config"](root_dir=root))
        seen = []
        disp.backend.open_interceptor = lambda path: seen.append(path.rsplit("/", 1)[-1])
        with disp.backend.create(f"{root}/a") as s:
            s.write(b"x")
        disp.backend.open_ranged(f"{root}/a").close()
        hook_on_inner = disp.backend.inner.open_interceptor is not None
        # a name the wrapper's class defines is set on the wrapper itself
        disp.backend.create = lambda path: "replaced"
        replaced = (disp.backend.create("x"), "create" in vars(disp.backend.inner))
        return seen, hook_on_inner, replaced

    assert _both(scenario) == (["a"], True, ("replaced", False))


# --- commit re-drives: index, checksum and parity PUTs ---

SID = 0
PARTS = 3
CODED = {"parity_segments": 2, "parity_stripe_k": 2, "parity_chunk_bytes": 1024}


def _stored(m, p):
    return random.Random(100 * m + p).randbytes([2500, 0, 4100][p])


def _objects(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            with open(os.path.join(dirpath, fn), "rb") as f:
                out[os.path.relpath(os.path.join(dirpath, fn), root)] = f.read()
    return out


def _commit_maps(pkg, root, rules=(), maps=2, **knobs):
    """Write ``maps`` map outputs of raw stored bytes through either
    package's MapOutputWriter, with a FlakyBackend ABOVE the storage stack
    (the recovery under test is the writer's, not the retry layer's)."""
    mods = PACKAGES[pkg]
    cfg = mods["config"](root_dir=f"file://{root}", checksum_algorithm="CRC32C",
                         storage_retry_base_ms=0.01, **CODED, **knobs)
    if pkg == "jax":
        JaxDispatcher.reset()
        disp = JaxDispatcher(cfg)
        helper = JaxHelper(disp)
    else:
        disp = Dispatcher(cfg)
        helper = ShuffleHelper(disp)
    flaky = mods["fault"].FlakyBackend(disp.backend, rules=list(rules))
    disp.backend = flaky
    for m in range(maps):
        if pkg == "jax":
            writer = JaxMapOutputWriter(disp, helper, SID, m, PARTS)
        else:
            writer = MapOutputWriter(disp, helper, SID, m, PARTS, codec=None, device="cpu")
        try:
            for p in range(PARTS):
                pw = writer.get_partition_writer(p)
                pw.write(_stored(m, p))
                pw.close()
            writer.commit_all_partitions()
        except Exception as e:
            writer.abort(e)
            raise
    return flaky


@pytest.mark.parametrize("kind", [".index", ".checksum", ".parity"])
def test_commit_re_drives_a_transient_put_to_objects_equal_to_jax(tmp_path, kind):
    _commit_maps("port", tmp_path / "clean")
    clean = _objects(tmp_path / "clean")
    got = {}
    for pkg in PACKAGES:
        f = PACKAGES[pkg]["fault"]
        rule = f.FaultRule("create", match=kind, times=1, exc=f.transient_connection_reset)
        _commit_maps(pkg, tmp_path / pkg, [rule])
        assert rule.hits == 1, pkg
        got[pkg] = _objects(tmp_path / pkg)
    assert got["port"] == got["jax"] == clean
    kinds = sorted({name.rsplit(".", 1)[-1] for name in clean})
    assert kinds == ["CRC32C", "data", "index", "parity"] and len(clean) == 2 * 5


@pytest.mark.parametrize("kind", [".index", ".parity"])
def test_commit_fails_fast_at_zero_retries_and_leaves_no_object(tmp_path, kind):
    for pkg in PACKAGES:
        f = PACKAGES[pkg]["fault"]
        rule = f.FaultRule("create", match=kind, times=1, exc=f.transient_connection_reset)
        with pytest.raises(ConnectionResetError):
            _commit_maps(pkg, tmp_path / pkg, [rule], maps=1, storage_retries=0)
        assert rule.hits == 1, pkg
        # the abort path deletes the data object and the parity sidecars PUT
        # so far; only a checksum object written before a failed index stays
        left = sorted(name.rsplit(".", 1)[-1] for name in _objects(tmp_path / pkg))
        assert left == (["CRC32C"] if kind == ".index" else []), (pkg, left)


# --- the record path: poisoned handles, the FileStatus cache ---

BS = 2048
BATCH = 4
MAPS = 4


def _terasort(seed, n=300):
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (16, 90), dtype=np.uint8)
    out = []
    for _ in range(MAPS):
        keys = rng.integers(0, 256, (n, 10), dtype=np.uint8).reshape(-1)
        vals = pool[rng.integers(0, 16, n)].reshape(-1)
        out.append(RecordBatch(np.full(n, 10, np.int32), np.full(n, 90, np.int32), keys, vals))
    return out


def _sorted_store(root):
    """A TeraSort shuffle 0 written by the port (objects kept); returns the
    whole rows, sorted."""
    ctx = ShuffleContext(ShuffleConfig(root_dir=f"file://{root}", checksum_algorithm="CRC32C",
                                       codec_block_size=BS, codec_batch_blocks=BATCH,
                                       max_concurrency_task=4),
                         num_workers=2, device="cpu")
    ctx.sort_by_key(_terasort(5), PARTS, serializer=ColumnarKVSerializer(), cleanup=False)
    rows = sorted(k + v for b in _terasort(5) for k, v in b.iter_records())
    return rows


def _reader_manager(root, pkg, **knobs):
    """A fresh manager of either package with the store's map outputs
    registered (its caches start empty)."""
    base = dict(checksum_algorithm="CRC32C", codec_block_size=BS, codec_batch_blocks=BATCH,
                cleanup=False, storage_retry_base_ms=0.01, max_concurrency_task=4)
    base.update(knobs)
    if pkg == "jax":
        JaxDispatcher.reset()
        mgr = JaxManager(JaxConfig(root_dir=f"file://{root}", codec="tpu",
                                   speculative_read_quantile=0.0, **base))
        dep = JaxDependency(0, JaxHashPartitioner(PARTS), serializer=JaxColumnarKV(),
                            key_ordering=jax_natural_key)
        status = JaxMapStatus
    else:
        mgr = ShuffleManager(ShuffleConfig(root_dir=f"file://{root}", **base), device="cpu")
        dep = ShuffleDependency(0, HashPartitioner(PARTS), serializer=ColumnarKVSerializer(),
                                key_ordering=natural_key)
        status = MapStatus
    handle = mgr.register_shuffle(0, dep)
    helper = ShuffleHelper(Dispatcher(ShuffleConfig(root_dir=f"file://{root}")))
    for m in range(MAPS):
        sizes = np.diff(helper.get_partition_lengths(0, m))
        mgr.tracker.register_map_output(0, status(map_id=m, location=STORE_LOCATION, sizes=sizes))
    return mgr, handle


def _read_rows(mgr, handle, ranges=((0, PARTS),)):
    rows = []
    for lo, hi in ranges:
        for batch in mgr.get_reader(handle, lo, hi).read_result_batches():
            rows.extend(k + v for k, v in batch.iter_records())
    return sorted(rows)


@pytest.mark.parametrize("retries", [3, 0])
def test_a_poisoned_handle_heals_in_both_packages_and_fails_at_zero(tmp_path, retries):
    """A transient fault injected ABOVE the retry layer reaches BlockStream:
    it reopens the object once and re-reads (``storage_retries > 0``), or
    surfaces EOF and the checksum layer a ChecksumError (0)."""
    want = _sorted_store(tmp_path)
    for pkg in PACKAGES:
        f = PACKAGES[pkg]["fault"]
        opens = []
        for faulted in (False, True):
            mgr, handle = _reader_manager(tmp_path, pkg, storage_retries=retries)
            flaky = f.FlakyBackend(mgr.dispatcher.backend)
            mgr.dispatcher.backend = flaky
            if not faulted:
                assert _read_rows(mgr, handle) == want, pkg
                opens.append(flaky.calls["open"])
                continue
            rule = flaky.add_rule(f.FaultRule("read", match=".data", times=1,
                                              exc=f.transient_connection_reset))
            if retries:
                assert _read_rows(mgr, handle) == want, pkg
                # exactly one fresh open of the poisoned object
                assert flaky.calls["open"] == opens[0] + 1, pkg
            else:
                with pytest.raises(PACKAGES[pkg]["checksum_error"]):
                    _read_rows(mgr, handle)
            assert rule.hits == 1, pkg


class _OpRecorder:
    """Wraps either package's backend stack; ``ops`` lists every status,
    open (with its size hint) and positioned read by object name."""

    def __init__(self, inner):
        self._inner = inner
        self.ops = []
        self._lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _add(self, *op):
        with self._lock:
            self.ops.append(op)

    def status(self, path):
        self._add("status", path.rsplit("/", 1)[-1])
        return self._inner.status(path)

    def open_ranged(self, path, size_hint=None):
        name = path.rsplit("/", 1)[-1]
        self._add("open", name, size_hint)
        inner = self._inner.open_ranged(path, size_hint)
        rec = self

        class Reader:
            size = inner.size

            def read_fully(self, position, length):
                rec._add("read", name, position, length)
                return inner.read_fully(position, length)

            def close(self):
                inner.close()

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                self.close()

        return Reader()

    def read_all(self, path):
        with self.open_ranged(path) as r:
            return r.read_fully(0, r.size)


@pytest.mark.parametrize("setting", ["gap0", "defaults"])
def test_record_read_store_ops_equal_jax_at_one_prefetch_thread(tmp_path, setting):
    want = _sorted_store(tmp_path)
    knobs = dict(max_concurrency_task=1, encode_inflight_batches=1, decode_inflight_batches=1)
    if setting == "gap0":
        knobs["coalesce_gap_bytes"] = 0
    ops = {}
    for pkg in PACKAGES:
        mgr, handle = _reader_manager(tmp_path, pkg, **knobs)
        rec = _OpRecorder(mgr.dispatcher.backend)
        mgr.dispatcher.backend = rec
        # two reads of every partition: the second takes every size from
        # the FileStatus cache
        for _ in range(2):
            assert _read_rows(mgr, handle, [(p, p + 1) for p in range(PARTS)]) == want
        ops[pkg] = rec.ops
    port, jax = ops["port"], ops["jax"]
    data = [op for op in port if ".data" in op[1]]
    assert data == [op for op in jax if ".data" in op[1]]
    assert sorted(port) == sorted(jax)
    statuses = [op[1] for op in port if op[0] == "status"]
    # one status per data object opened, however many reads opened it
    assert sorted(statuses) == sorted({op[1] for op in data}) and len(statuses) == MAPS
    assert all(op[2] is not None for op in port if op[0] == "open" and ".data" in op[1])


def test_purge_caches_drops_only_its_shuffle(tmp_path):
    for pkg in PACKAGES:
        mods = PACKAGES[pkg]
        root = tmp_path / pkg
        if pkg == "jax":
            JaxDispatcher.reset()
            mgr = JaxManager(JaxConfig(root_dir=f"file://{root}", cleanup=False))
            block = JaxDataBlockId
        else:
            mgr = ShuffleManager(ShuffleConfig(root_dir=f"file://{root}", cleanup=False),
                                 device="cpu")
            block = ShuffleDataBlockId
        disp = mgr.dispatcher
        for sid in (1, 2, 12):
            with disp.create_block(block(sid, 0)) as s:
                s.write(b"x" * sid)
        counter = mods["fault"].FlakyBackend(disp.backend)
        disp.backend = counter
        for _ in range(2):
            for sid in (1, 2, 12):
                with disp.open_block(block(sid, 0)) as r:
                    assert r.size == sid
        assert counter.calls["status"] == 3, pkg
        mgr.purge_caches(1)
        for sid in (1, 2, 12):
            disp.open_block(block(sid, 0)).close()
        assert counter.calls["status"] == 4, pkg  # only shuffle 1 asked again
        disp.reinitialize("app2")
        assert len(disp._status_cache) == 0, pkg
        disp.clear_status_cache()


# --- the fsspec backend ---

@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_fsspec_backend_over_fsspec_memory_fs(pkg):
    b = PACKAGES[pkg]["fsspec"].FsspecBackend("memory")
    root = f"memory://fsspec-adaptor-{pkg}-{id(b)}"
    payload = bytes(range(256)) * 64
    with b.create(f"{root}/a/obj1.bin") as f:
        f.write(payload)
    with b.create(f"{root}/a/obj2.bin") as f:
        f.write(b"tiny")
    st = b.status(f"{root}/a/obj1.bin")
    assert st.size == len(payload)
    r = b.open_ranged(f"{root}/a/obj1.bin", size_hint=st.size)
    assert r.read_fully(0, 16) == payload[:16]
    assert r.read_fully(1000, 32) == payload[1000:1032]
    assert r.read_fully(len(payload) - 3, 64) == payload[-3:]  # clamped
    assert b.open_ranged(f"{root}/a/obj2.bin").size == 4  # no hint: one info call
    sizes = {s.path.split("/")[-1]: s.size for s in b.list_prefix(f"{root}/a")}
    assert sizes == {"obj1.bin": len(payload), "obj2.bin": 4}
    assert b.list_prefix(f"{root}/nothing") == []
    with pytest.raises(FileNotFoundError):
        b.status(f"{root}/a/missing")
    b.delete(f"{root}/a/obj2.bin")
    b.delete(f"{root}/a/obj2.bin")  # a missing object is fine
    assert len(b.list_prefix(f"{root}/a")) == 1
    b.delete_prefix(root)
    assert b.list_prefix(f"{root}/a") == []
    assert b.supports_rename is False and b.rename("x", "y") is False


def test_storage_options_reach_the_fsspec_driver(monkeypatch):
    captured = {}
    for pkg in PACKAGES:
        fb = PACKAGES[pkg]["fsspec"]
        orig = fb.FsspecBackend.__init__

        def spy(self, scheme, _orig=orig, _pkg=pkg, **opts):
            captured[_pkg] = dict(opts, scheme=scheme)
            _orig(self, scheme, **opts)

        monkeypatch.setattr(fb.FsspecBackend, "__init__", spy)
        PACKAGES[pkg]["backend"].get_backend("local:///tmp/x", {"auto_mkdir": True, "marker": 7})
    assert captured["port"] == captured["jax"] == {"auto_mkdir": True, "marker": 7,
                                                   "scheme": "local"}


def test_a_scheme_without_a_driver_raises_a_clear_error():
    for pkg in PACKAGES:
        with pytest.raises(RuntimeError, match="No fsspec driver for scheme 'nosuchfs'"):
            PACKAGES[pkg]["backend"].get_backend("nosuchfs://bucket/root")


def test_a_shuffle_through_local_fsspec_is_byte_equal_and_cross_readable(tmp_path):
    """Raw stored partitions through ``local://`` (fsspec's LocalFileSystem
    under each package's FsspecBackend): byte-equal objects, and each
    package reads the other's."""
    opts = {"storage_options": {"auto_mkdir": True}}
    got = {}
    for pkg in PACKAGES:
        root = tmp_path / pkg
        mods = PACKAGES[pkg]
        cfg = mods["config"](root_dir=f"local://{root}", checksum_algorithm="CRC32C", **opts)
        if pkg == "jax":
            JaxDispatcher.reset()
            disp = JaxDispatcher(cfg)
            helper = JaxHelper(disp)
        else:
            disp = Dispatcher(cfg)
            helper = ShuffleHelper(disp)
        assert type(disp.backend.inner).__name__ == "FsspecBackend"
        for m in range(2):
            writer = (JaxMapOutputWriter(disp, helper, SID, m, PARTS) if pkg == "jax" else
                      MapOutputWriter(disp, helper, SID, m, PARTS, codec=None, device="cpu"))
            for p in range(PARTS):
                pw = writer.get_partition_writer(p)
                pw.write(_stored(m, p))
                pw.close()
            writer.commit_all_partitions()
        got[pkg] = _objects(root)
        listed = disp.list_shuffle_indices(SID)
        assert [b.map_id for b in listed] == [0, 1], pkg
    assert got["port"] == got["jax"] and len(got["port"]) == 2 * 3
    for writer_pkg in PACKAGES:
        root = f"local://{tmp_path / writer_pkg}"
        JaxDispatcher.reset()
        jdisp = JaxDispatcher(JaxConfig(root_dir=root, checksum_algorithm="CRC32C", **opts))
        pdisp = Dispatcher(ShuffleConfig(root_dir=root, checksum_algorithm="CRC32C", **opts))
        sums = {}
        for name, disp, helper, block in (
                ("jax", jdisp, JaxHelper(jdisp), JaxDataBlockId),
                ("port", pdisp, ShuffleHelper(pdisp), ShuffleDataBlockId)):
            sums[name] = []
            for m in range(2):
                offsets = helper.get_partition_lengths(SID, m)
                with disp.open_block(block(SID, m)) as r:
                    for p in range(PARTS):
                        lo, hi = int(offsets[p]), int(offsets[p + 1])
                        assert r.read_fully(lo, hi - lo) == _stored(m, p), (writer_pkg, name)
                sums[name].append(list(helper.get_checksums(SID, m)))
        assert sums["port"] == sums["jax"]
        pdisp.remove_root()
        assert not _objects(tmp_path / writer_pkg), writer_pkg


# --- the fault soak (tests/test_fault_soak.py, per-map layout) ---

N_MAPS = 3
N_PARTS = 4
N_RECORDS = 6000
#: small codec blocks keep the port's plain CPU codec quick; at most four
#: prefetch threads per reduce task
SMALL_BLOCKS = {"codec_block_size": BS, "codec_batch_blocks": BATCH, "max_concurrency_task": 4}


def _records():
    rng = random.Random(42)
    return [(rng.randbytes(8), rng.randbytes(24)) for _ in range(N_RECORDS)]


def _run_shuffle(ctx, pkg):
    deps = {"port": (ShuffleDependency, HashPartitioner),
            "jax": (JaxDependency, JaxHashPartitioner)}[pkg]
    records = _records()
    sid = next(ctx._next_shuffle_id)
    handle = ctx.manager.register_shuffle(sid, deps[0](sid, deps[1](N_PARTS)))
    per_map = len(records) // N_MAPS
    for map_id in range(N_MAPS):
        w = ctx.manager.get_writer(handle, map_id)
        w.write(records[map_id * per_map: (map_id + 1) * per_map])
        w.stop(success=True)
    out = []
    for rid in range(N_PARTS):
        out.extend(ctx.manager.get_reader(handle, rid, rid + 1).read())
    return handle, sorted(records), sorted(out)


def _soak_rules(fault):
    return [
        fault.FaultRule("read", prob=0.05, rng_seed=11, times=None,
                        exc=fault.transient_connection_reset),
        fault.FaultRule("open", prob=0.05, rng_seed=22, times=None,
                        exc=fault.transient_http_503),
        fault.FaultRule("status", prob=0.05, rng_seed=33, times=None,
                        exc=fault.transient_timeout),
        fault.FaultRule("create", times=1, exc=fault.transient_timeout),
    ]


def _context(pkg, cfg_kwargs):
    if pkg == "jax":
        JaxDispatcher.reset()
        return JaxContext(config=JaxConfig(**cfg_kwargs), num_workers=2)
    return ShuffleContext(config=ShuffleConfig(**cfg_kwargs), num_workers=2, device="cpu")


def test_fault_soak_through_both_packages(tmp_path):
    outs = {}
    for pkg in PACKAGES:
        mods = PACKAGES[pkg]
        with _context(pkg, dict(root_dir=f"file://{tmp_path}/{pkg}-clean", app_id="soak",
                                cleanup=True, **SMALL_BLOCKS)) as ctx:
            _h, expected, clean_out = _run_shuffle(ctx, pkg)
        assert clean_out == expected
        soak = dict(root_dir=f"file://{tmp_path}/{pkg}-soak", app_id="soak", cleanup=True,
                    **SMALL_BLOCKS,
                    storage_retries=8, storage_retry_base_ms=1.0, storage_op_deadline_s=20.0)
        with _context(pkg, soak) as ctx:
            disp = ctx.manager.dispatcher
            raw = LocalBackend() if pkg == "port" else JaxLocalBackend()
            flaky = mods["fault"].FlakyBackend(raw, rules=_soak_rules(mods["fault"]))
            disp.backend = mods["retrying"].RetryingBackend(flaky, disp.retry_policy)
            handle, _e, soak_out = _run_shuffle(ctx, pkg)
            assert soak_out == clean_out, pkg
            assert sum(rule.hits for rule in flaky.rules) >= 1, pkg
            assert flaky.rules[-1].hits == 1, pkg  # the transient create fired
            ctx.manager.unregister_shuffle(handle.shuffle_id)
            assert raw.list_prefix(f"file://{tmp_path}/{pkg}-soak") == [], pkg
        outs[pkg] = soak_out
    assert outs["port"] == outs["jax"]
