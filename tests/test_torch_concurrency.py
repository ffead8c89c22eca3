"""The port's happens-before race witness (``utils/racewitness.py``) and
deterministic schedule explorer (``utils/sched.py``): the counterparts of
``tests/test_concurrency_plane.py``.

- the witness: fork and join edges from thread start and join, lock,
  ``Event``, ``Barrier`` and queue edges, and ``quarantine``;
- the explorer: a deterministic catch and token replay (in this process and
  in a fresh one), deadlock detection, and its composition with the
  witness; a seeded exploration of a generic scenario gives the same token
  under both packages' explorers;
- the teeth, over the port's real objects: the group-budget claim of
  ``read/prefetch.py`` with a ``read/scan_plan.SplitGroup`` (the claim
  without its re-check reserves twice; the explorer finds it, the witness
  flags an unlocked check) and the composite seal barrier of
  ``write/composite_commit.py`` (without ``_await_seals`` a reader scans
  before the in-flight seal registered; the explorer finds it, the witness
  flags the missing edge). The protocols as they are stay clean across 200
  schedules each.
"""

import os
import subprocess
import sys
import threading
import _thread

import pytest

from s3shuffle_tpu_torch.block_ids import ShuffleBlockId
from s3shuffle_tpu_torch.utils import racewitness, sched
from s3shuffle_tpu_torch.utils.sched import SchedDeadlock

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def witnesses_uninstalled():
    """No test leaves a witness or a scheduler installed, or ``threading``
    patched."""
    saved = (threading.Lock, threading.RLock, threading.Condition, threading.Event,
             threading.Barrier, threading.Thread.start)
    yield
    racewitness.uninstall()
    assert sched._ACTIVE is None
    assert (threading.Lock, threading.RLock, threading.Condition, threading.Event,
            threading.Barrier, threading.Thread.start) == saved


def _gate():
    """A raw rendezvous below the interposition: it orders execution
    without a happens-before edge."""
    g = _thread.allocate_lock()
    g.acquire()
    return g


class Box:
    pass


def _watched_box(**fields):
    box = Box()
    for k, v in fields.items():
        setattr(box, k, v)
    return racewitness.watch_shared(box, tuple(fields))


def _run_threads(*targets):
    threads = [threading.Thread(target=t) for t in targets]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


# ---------------------------------------------------------------------------
# The race witness: vector clocks
# ---------------------------------------------------------------------------


def test_witness_flags_unordered_sibling_writes():
    with racewitness.quarantine() as q:
        box = _watched_box(x=0)
        done = _gate()

        def first():
            box.x = 1
            done.release()

        def second():
            done.acquire()
            box.x = 2

        _run_threads(first, second)
        reports = q.new_reports()
        assert reports and any("Box.x" in r for r in reports)


def test_witness_lock_protected_accesses_clean():
    with racewitness.quarantine() as q:
        lock = threading.Lock()
        box = _watched_box(x=0)

        def bump():
            with lock:
                box.x += 1

        _run_threads(bump, bump, bump, bump)
        assert box.x == 4
        assert not q.new_reports(), "\n".join(q.new_reports())


def test_witness_event_set_wait_edge():
    with racewitness.quarantine() as q:
        evt = threading.Event()
        box = _watched_box(x=0)

        def producer():
            box.x = 41
            evt.set()

        def consumer():
            assert evt.wait(10)
            box.x += 1

        _run_threads(producer, consumer)
        assert box.x == 42
        assert not q.new_reports(), "\n".join(q.new_reports())
        box2 = _watched_box(x=0)
        handoff = _gate()

        def producer_raw():
            box2.x = 41
            handoff.release()

        def consumer_raw():
            handoff.acquire()
            box2.x += 1

        _run_threads(producer_raw, consumer_raw)
        assert q.new_reports(), "a raw gate is not a happens-before edge"


def test_witness_barrier_trip_orders_all_parties():
    with racewitness.quarantine() as q:
        barrier = threading.Barrier(2)
        box = _watched_box(a=0, b=0)
        seen = []

        def left():
            box.a = 1
            barrier.wait(10)
            seen.append(box.b)

        def right():
            box.b = 2
            barrier.wait(10)
            seen.append(box.a)

        _run_threads(left, right)
        assert sorted(seen) == [1, 2]
        assert not q.new_reports(), "\n".join(q.new_reports())


def test_witness_queue_put_get_edge():
    import queue

    with racewitness.quarantine() as q:
        ch = queue.Queue()
        box = _watched_box(x=0)

        def producer():
            box.x = 7
            ch.put("ready")

        def consumer():
            assert ch.get(timeout=10) == "ready"
            box.x += 1

        _run_threads(producer, consumer)
        assert box.x == 8
        assert not q.new_reports(), "\n".join(q.new_reports())


def test_witness_executor_submit_and_result_edges():
    """``ThreadPoolExecutor.submit`` forks the submitter's clock into the
    task and ``Future.result`` joins it back: the executors of the port's
    codec windows order their handoffs."""
    from concurrent.futures import ThreadPoolExecutor

    with racewitness.quarantine() as q:
        box = _watched_box(x=0)
        with ThreadPoolExecutor(max_workers=2) as pool:
            box.x = 1

            def task():
                box.x += 1
                return box.x

            assert pool.submit(task).result(10) == 2
            box.x += 1
        assert box.x == 3
        assert not q.new_reports(), "\n".join(q.new_reports())


def test_quarantine_restores_the_installed_witness_verdict():
    assert racewitness.active_witness() is None
    with racewitness.watching() as outer:
        base_reports, base_checks = list(outer.reports), outer.checks
        with racewitness.quarantine() as q:
            assert q.witness is outer
            box = _watched_box(x=0)
            done = _gate()

            def first():
                box.x = 1
                done.release()

            def second():
                done.acquire()
                box.x = 2

            _run_threads(first, second)
            assert q.new_reports()
        assert outer.reports == base_reports
        assert outer.checks == base_checks
    assert racewitness.active_witness() is None


def test_watch_shared_is_a_no_op_when_uninstalled():
    box = Box()
    box.x = 0
    assert racewitness.watch_shared(box, ("x",)) is box
    assert type(box) is Box


# ---------------------------------------------------------------------------
# The schedule explorer: catch, replay, deadlock, composition
# ---------------------------------------------------------------------------


def scenario_lost_update(s):
    """Unsynchronized read-modify-write: two bumpers, one counter."""
    state = {"n": 0}

    def bump():
        v = state["n"]
        s.checkpoint()
        state["n"] = v + 1

    s.spawn(bump, "bump-a")
    s.spawn(bump, "bump-b")

    def check():
        assert state["n"] == 2, f"lost update: n={state['n']} (expected 2)"

    return check


def scenario_locked_update(s):
    state = {"n": 0}
    mu = threading.Lock()

    def bump():
        with mu:
            v = state["n"]
            s.checkpoint()
            state["n"] = v + 1

    s.spawn(bump, "bump-a")
    s.spawn(bump, "bump-b")

    def check():
        assert state["n"] == 2, f"lost update under a lock: n={state['n']}"

    return check


def scenario_lock_inversion(s):
    l1, l2 = threading.Lock(), threading.Lock()

    def fwd():
        with l1:
            s.checkpoint()
            with l2:
                pass

    def rev():
        with l2:
            s.checkpoint()
            with l1:
                pass

    s.spawn(fwd, "fwd")
    s.spawn(rev, "rev")
    return None


def test_explorer_catches_lost_update_and_replays():
    result = sched.explore(scenario_lost_update, schedules=200, seed=11)
    assert result.failed and result.token.startswith("s3sched:1:")
    again = sched.replay(scenario_lost_update, result.token)
    assert again.failed and type(again.error) is type(result.error)


def test_explorer_locked_scenario_clean():
    result = sched.explore(scenario_locked_update, schedules=100, seed=11)
    assert not result.failed, repr(result.error)


def test_explorer_detects_lock_inversion_deadlock():
    result = sched.explore(scenario_lock_inversion, schedules=200, seed=5)
    assert result.failed and isinstance(result.error, SchedDeadlock), repr(result.error)
    again = sched.replay(scenario_lock_inversion, result.token)
    assert isinstance(again.error, SchedDeadlock)


def test_explorer_composes_with_race_witness():
    with racewitness.quarantine() as q:

        def locked(s):
            lock = threading.Lock()
            box = _watched_box(val=0)

            def bump():
                with lock:
                    box.val += 1

            s.spawn(bump, "bump-a")
            s.spawn(bump, "bump-b")

        res = sched.explore(locked, schedules=50, seed=3)
        assert not res.failed, repr(res.error)
        assert not q.new_reports(), "\n".join(q.new_reports())

        def unlocked(s):
            box = _watched_box(val=0)

            def bump():
                v = box.val
                box.val = v + 1

            s.spawn(bump, "bump-a")
            s.spawn(bump, "bump-b")

        sched.explore(unlocked, schedules=50, seed=3)
        assert q.new_reports(), "unlocked accesses must be flagged in a schedule"


@pytest.mark.parametrize("name, seed", [("lost-update", 11), ("lock-inversion", 5),
                                        ("lost-notify", 2), ("locked-update", 11)])
def test_seeded_exploration_gives_the_jax_token(name, seed):
    """The same scenario under both explorers takes the same decisions: the
    same token, or clean in both after the same number of schedules."""
    from s3shuffle_tpu.utils import sched as jax_sched
    from tools.schedule_explore import SCENARIOS

    scenario = SCENARIOS[name]
    theirs = jax_sched.explore(scenario, schedules=100, seed=seed)
    ours = sched.explore(scenario, schedules=100, seed=seed)
    assert (ours.failed, ours.token, ours.schedules_run) == \
        (theirs.failed, theirs.token, theirs.schedules_run)
    assert type(ours.error).__name__ == type(theirs.error).__name__
    if ours.failed:
        assert jax_sched.replay(scenario, ours.token).failed


#: the port's explorer in a fresh interpreter: ``explore`` prints its token
#: and exits 1 on a caught schedule; ``replay`` exits 1 when the token
#: reproduces the failure
EXPLORE_MAIN = r'''
import sys
sys.path.insert(0, sys.argv[1])
from s3shuffle_tpu_torch.utils import sched
from test_torch_concurrency import scenario_lost_update
if sys.argv[2] == "explore":
    result = sched.explore(scenario_lost_update, schedules=200, seed=11)
else:
    result = sched.replay(scenario_lost_update, sys.argv[3])
print(result.token)
sys.exit(1 if result.failed else 0)
'''


def _explore_process(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO_ROOT
    return subprocess.run([sys.executable, "-c", EXPLORE_MAIN,
                           os.path.join(REPO_ROOT, "tests"), *args],
                          capture_output=True, text=True, cwd=REPO_ROOT, env=env, timeout=300)


def test_a_fresh_process_finds_the_same_token():
    proc = _explore_process("explore")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    token = proc.stdout.split()[-1]
    assert token == sched.explore(scenario_lost_update, schedules=200, seed=11).token


def test_a_fresh_process_replays_a_token():
    token = sched.explore(scenario_lost_update, schedules=200, seed=11).token
    proc = _explore_process("replay", token)
    assert proc.returncode == 1, "the replay must reproduce the failure"
    with pytest.raises(ValueError):
        sched.Scheduler.from_token("s3sched:2:1:1:0")


# ---------------------------------------------------------------------------
# The group-budget claim of the prefetcher (split blocks)
# ---------------------------------------------------------------------------
#
# The first split part past the budget wait claims the whole block's bytes,
# its siblings piggyback. The load-bearing line is the re-check of
# ``group.reserved`` after ``_await_budget_locked(..., satisfied=...)``
# returns: the wait can end because a sibling's claim satisfied it, and a
# second claim charges the budget twice. The scenarios drive the port's
# real ``_await_budget_locked`` / ``release_reserved`` / ``try_reserve`` on
# a real iterator and ``SplitGroup``; the claim body (inline in the fill
# loop) is written out with and without the re-check.


def _claim_scenario(with_recheck: bool):
    from s3shuffle_tpu_torch.read.prefetch import BufferedPrefetchIterator
    from s3shuffle_tpu_torch.read.scan_plan import SplitGroup

    def scenario(s):
        it = BufferedPrefetchIterator(iter([]), max_buffer_size=100)
        grp = SplitGroup(ShuffleBlockId(0, 0, 0), 0, 80, 2)
        assert it.try_reserve(60)

        def claimant():
            with it._lock:
                it._await_budget_locked(80, satisfied=lambda: grp.reserved)
                if not with_recheck or not grp.reserved:
                    grp.reserved = True
                    grp.reserved_bytes = 80
                    it._buffers_in_flight += 80
                    it._lock.notify_all()

        def releaser():
            it.release_reserved(60)

        s.spawn(claimant, "claimant-a")
        s.spawn(claimant, "claimant-b")
        s.spawn(releaser, "releaser")

        def check():
            with it._lock:
                in_flight = it._buffers_in_flight
            it.close()
            assert in_flight == 80, f"group budget reserved more than once: {in_flight} != 80"

        return check

    return scenario


def test_double_reserve_revert_caught_by_explorer():
    result = sched.explore(_claim_scenario(with_recheck=False), schedules=200, seed=7)
    assert result.failed and "reserved more than once" in str(result.error)
    again = sched.replay(_claim_scenario(with_recheck=False), result.token)
    assert again.failed and "reserved more than once" in str(again.error)


def test_group_claim_protocol_clean_across_schedules():
    result = sched.explore(_claim_scenario(with_recheck=True), schedules=200, seed=7)
    assert not result.failed, f"{result.token}: {result.error!r}"
    assert result.schedules_run == 200


def _claim_then_check(locked_check: bool):
    """A sibling claims under the prefetcher's lock; the main thread then
    reads ``grp.reserved`` with or without the lock (gate-sequenced)."""
    from s3shuffle_tpu_torch.read.prefetch import BufferedPrefetchIterator
    from s3shuffle_tpu_torch.read.scan_plan import SplitGroup

    with racewitness.quarantine() as q:
        it = BufferedPrefetchIterator(iter([]), max_buffer_size=100)
        grp = SplitGroup(ShuffleBlockId(0, 0, 0), 0, 80, 2)
        claimed = _gate()

        def claimant():
            with it._lock:
                grp.reserved = True
                grp.reserved_bytes = 80
                it._buffers_in_flight += 80
            claimed.release()

        t = threading.Thread(target=claimant)
        t.start()
        claimed.acquire()
        if locked_check:
            with it._lock:
                saw = grp.reserved
        else:
            saw = grp.reserved
        t.join()
        it.close()
        assert saw is True
        return q.new_reports()


def test_unlocked_claim_check_caught_by_racewitness():
    reports = _claim_then_check(locked_check=False)
    assert any("SplitGroup.reserved" in r for r in reports), "\n".join(reports)


def test_locked_claim_check_is_witness_clean():
    reports = _claim_then_check(locked_check=True)
    assert not reports, "\n".join(reports)


# ---------------------------------------------------------------------------
# The composite seal barrier
# ---------------------------------------------------------------------------
#
# ``flush_shuffle``'s contract: when it returns, every member committed
# before is registered, which ``_await_seals`` enforces by draining the
# in-flight seal count under ``_seal_cv``. The scenarios drive the port's
# real ``_note_seal_begin`` / ``_note_seal_end`` / ``_await_seals`` on an
# aggregator whose seal state is built as ``__init__`` builds it.


def _seal_window_agg(watch: bool = False):
    from s3shuffle_tpu_torch.write.composite_commit import CompositeCommitAggregator

    agg = object.__new__(CompositeCommitAggregator)
    agg._lock = threading.Lock()
    agg._groups = {}
    agg._seal_cv = threading.Condition()
    agg._sealing = {}
    if watch:
        agg = racewitness.watch_shared(agg, ("_groups", "_sealing"))
    return agg


def _seal_scenario():
    def scenario(s):
        agg = _seal_window_agg()
        sid = 7
        registered = []
        agg._note_seal_begin(sid)

        def sealer():
            s.checkpoint()  # the registration window
            registered.append("m0")
            agg._note_seal_end(sid)

        def barrier_flush():
            with agg._lock:
                group = agg._groups.pop(sid, None)
            assert group is None
            agg._await_seals(sid)
            assert registered == ["m0"], (
                "record loss: the barrier returned before the in-flight seal "
                "registered its members")

        s.spawn(sealer, "sealer")
        s.spawn(barrier_flush, "barrier")

    return scenario


def test_seal_barrier_revert_caught_by_explorer(monkeypatch):
    from s3shuffle_tpu_torch.write.composite_commit import CompositeCommitAggregator

    monkeypatch.setattr(CompositeCommitAggregator, "_await_seals",
                        lambda self, shuffle_id: None)
    result = sched.explore(_seal_scenario(), schedules=200, seed=13)
    assert result.failed and "record loss" in str(result.error)
    again = sched.replay(_seal_scenario(), result.token)
    assert again.failed and "record loss" in str(again.error)


def test_seal_barrier_protocol_clean_across_schedules():
    result = sched.explore(_seal_scenario(), schedules=200, seed=13)
    assert not result.failed, f"{result.token}: {result.error!r}"
    assert result.schedules_run == 200


def _sealed_then_read():
    agg = _seal_window_agg(watch=True)
    sid = 7
    with agg._lock:
        agg._groups[sid] = "open-group"
    agg._note_seal_begin(sid)
    sealed = _gate()

    def sealer():
        with agg._lock:
            agg._groups.pop(sid, None)
        agg._note_seal_end(sid)
        sealed.release()

    t = threading.Thread(target=sealer)
    t.start()
    sealed.acquire()
    agg._await_seals(sid)
    saw = sid in agg._groups
    t.join()
    assert saw is False


def test_await_seals_revert_caught_by_racewitness(monkeypatch):
    from s3shuffle_tpu_torch.write.composite_commit import CompositeCommitAggregator

    monkeypatch.setattr(CompositeCommitAggregator, "_await_seals",
                        lambda self, shuffle_id: None)
    with racewitness.quarantine() as q:
        _sealed_then_read()
        reports = q.new_reports()
    assert any("CompositeCommitAggregator._groups" in r for r in reports), "\n".join(reports)


def test_await_seals_orders_the_reader():
    with racewitness.quarantine() as q:
        _sealed_then_read()
        assert not q.new_reports(), "\n".join(q.new_reports())


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


def test_witness_and_explorer_publish_metrics():
    from s3shuffle_tpu_torch.metrics import registry as mreg

    mreg.REGISTRY.reset_values()
    mreg.enable()
    try:
        with racewitness.quarantine() as q:
            box = _watched_box(x=0)
            box.x = 1
            racewitness.publish_metrics(q.witness)

        def scenario(s):
            s.spawn(lambda: None, "noop")

        res = sched.explore(scenario, schedules=3, seed=1)
        assert not res.failed
        snap = mreg.REGISTRY.snapshot(compact=True)

        def total(name):
            return sum(s["value"] for s in snap.get(name, {}).get("series", []))

        assert total("race_witness_checks_total") >= 1
        assert total("sched_schedules_explored_total") >= 3
    finally:
        mreg.disable()
        mreg.REGISTRY.reset_values()
