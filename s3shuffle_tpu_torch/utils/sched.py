"""Deterministic cooperative scheduler of the port (the JAX package's
``utils/sched.py``): the interleaving-exploration half of the concurrency
checks.

A data race or an atomicity violation bites only on some interleavings,
and the OS scheduler samples a thin slice of them. This module makes the
schedule an input:

- :class:`Scheduler` is a context manager that patches
  ``threading.{Lock,RLock,Condition,Event}`` with cooperative primitives.
  Threads spawned through :meth:`Scheduler.spawn` become *tasks*: one task
  runs at a time, and every instrumented operation (lock acquire and
  release, condition wait and notify, event set and wait) is a point where
  the driver may switch tasks;
- the driver (:meth:`Scheduler.run`, on the caller's thread) picks the next
  task by a **seeded random walk** with **bounded preemption** (iterative
  context bounding: schedules with at most *c* forced switches away from a
  runnable task, budgets 0, 1, 2, ... in rounds);
- every decision is recorded; a failing schedule is summarized as a
  **replay token** (``s3sched:1:<seed>:<budget>:<d0.d1...>``, the JAX
  package's format) that :func:`replay` re-executes decision for decision;
- a timed wait (``Condition.wait(timeout)``, ``Event.wait(timeout)``) only
  times out when nothing else can run, the cooperative form of "the
  notify was lost". Every task blocked with no timed waiter is a deadlock,
  reported with each task's block site.

Threads not spawned through the scheduler fall back to real blocking on
the same primitives: correct, but their timing is not explored.

A CPU tool: a task blocked in ``torch.cuda.synchronize()`` or any C++ wait
is not a yield point, so scenarios run on ``device="cpu"``.
:func:`explore` is the library entry. Stdlib-only, like the witnesses it
composes with.
"""

from __future__ import annotations

import logging
import os
import random
import sys
import threading
import time
import _thread
from typing import Callable, Dict, List, Optional

_allocate_lock = _thread.allocate_lock

#: the active scheduler (at most one; scenarios are single-process affairs)
_ACTIVE: Optional["Scheduler"] = None

#: schedules completed by explore()/replay() since process start (the
#: sched_schedules_explored_total feed; published lazily, see
#: publish_metrics: this module imports the stdlib only)
_SCHEDULES_EXPLORED = 0
_PUBLISHED_EXPLORED = 0


class _TaskLocal(threading.local):
    def __init__(self) -> None:
        self.task: Optional["_Task"] = None


_TLS = _TaskLocal()


def current_task() -> Optional["_Task"]:
    return _TLS.task


class SchedDeadlock(Exception):
    """Every task is blocked and none holds a timed wait."""


class SchedStuck(Exception):
    """The schedule exceeded the step budget without completing (a
    livelock: e.g. a timed wait re-arming forever with no progress)."""


class _TaskAbort(BaseException):
    """Raised inside a task when its scheduler tears down abnormally (a
    deadlock/livelock verdict already stands; the task just unwinds).
    BaseException so ordinary ``except Exception`` cleanup can't eat it."""


class _Task:
    __slots__ = (
        "sched", "index", "name", "thread", "state", "gate",
        "block_key", "timed", "wake_reason", "exc", "block_site",
    )

    def __init__(self, sched: "Scheduler", index: int, name: str):
        self.sched = sched
        self.index = index
        self.name = name
        self.thread: Optional[threading.Thread] = None
        #: 'runnable' | 'blocked' | 'done'
        self.state = "runnable"
        #: binary semaphore: driver releases to run the task; task blocks
        #: on acquire while off-schedule
        self.gate = _allocate_lock()
        self.gate.acquire()
        self.block_key = None
        self.timed = False
        self.wake_reason: Optional[str] = None
        self.exc: Optional[BaseException] = None
        self.block_site = ""

    # -- task-side protocol (only ever called from this task's thread) --
    def yield_to_driver(self) -> None:
        if self.sched._aborted:
            raise _TaskAbort()
        self.sched._driver_gate.release()
        self.gate.acquire()
        if self.sched._aborted:
            raise _TaskAbort()

    def block(self, key, timed: bool) -> None:
        self.state = "blocked"
        self.block_key = key
        self.timed = timed
        self.wake_reason = None
        frame = sys._getframe(2)
        self.block_site = f"{os.path.basename(frame.f_code.co_filename)}:{frame.f_lineno}"
        self.yield_to_driver()


class Scheduler:
    """One controlled execution of a multi-task scenario. Use as a context
    manager; spawn tasks inside; then :meth:`run` to completion."""

    MAX_STEPS = 20000

    def __init__(
        self,
        seed: int = 0,
        max_preemptions: int = 2,
        decisions: Optional[List[int]] = None,
    ):
        self.seed = int(seed)
        self.max_preemptions = int(max_preemptions)
        self._rng = random.Random(self.seed)
        self._replay: Optional[List[int]] = list(decisions) if decisions else None
        self._replay_pos = 0
        self.decisions: List[int] = []
        self.tasks: List[_Task] = []
        self._driver_gate = _allocate_lock()
        self._driver_gate.acquire()
        self._current: Optional[_Task] = None
        self._preemptions = 0
        self.steps = 0
        #: wakes posted by non-task threads (real-fallback lock releases),
        #: drained by the driver; the one mutable structure shared with
        #: uncontrolled threads, hence its own raw lock
        self._external: List[object] = []
        self._external_mu = _allocate_lock()
        self._entered = False
        self._aborted = False
        self._saved: Dict[str, object] = {}

    # -- patching ------------------------------------------------------
    def __enter__(self) -> "Scheduler":
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("a Scheduler is already active")
        self._saved = {
            "Lock": threading.Lock,
            "RLock": threading.RLock,
            "Condition": threading.Condition,
            "Event": threading.Event,
        }
        threading.Lock = _CoopLock  # type: ignore[assignment]
        threading.RLock = _CoopRLock  # type: ignore[assignment]
        threading.Condition = _CoopCondition  # type: ignore[assignment]
        threading.Event = _CoopEvent  # type: ignore[assignment]
        _ACTIVE = self
        self._entered = True
        return self

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        # abort FIRST, while patches and _ACTIVE are still in place: woken
        # tasks unwind via _TaskAbort (their coop-lock releases see
        # _aborted and skip scheduler bookkeeping) instead of blocking for
        # real on half-torn-down primitives
        self._aborted = True
        for t in self.tasks:
            if t.state != "done" and t.thread is not None and t.thread.is_alive():
                try:
                    t.gate.release()
                except RuntimeError:
                    pass
        for t in self.tasks:
            if t.thread is not None and t.thread.is_alive():
                t.thread.join(timeout=2.0)
        threading.Lock = self._saved["Lock"]  # type: ignore[assignment]
        threading.RLock = self._saved["RLock"]  # type: ignore[assignment]
        threading.Condition = self._saved["Condition"]  # type: ignore[assignment]
        threading.Event = self._saved["Event"]  # type: ignore[assignment]
        _ACTIVE = None
        self._entered = False

    # -- spawning ------------------------------------------------------
    def spawn(self, fn: Callable[[], object], name: Optional[str] = None) -> _Task:
        task = _Task(self, len(self.tasks), name or f"task{len(self.tasks)}")
        self.tasks.append(task)

        def _bootstrap():
            _TLS.task = task
            task.gate.acquire()  # wait to be scheduled the first time
            if self._aborted:  # torn down before first slice
                task.state = "done"
                return
            try:
                fn()
            except _TaskAbort:
                task.state = "done"
                return  # driver already gone; unwind silently
            except BaseException as e:  # noqa: BLE001 - surfaced via run()
                task.exc = e
            task.state = "done"
            try:
                self._driver_gate.release()
            except RuntimeError:
                pass  # abort raced the final handoff

        # a REAL thread, but created from the saved (pre-patch) machinery's
        # perspective it is ordinary; it parks on the gate immediately
        task.thread = threading.Thread(
            target=_bootstrap, name=task.name, daemon=True
        )
        task.thread.start()
        return task

    # -- decision stream ----------------------------------------------
    def _decide(self, n: int) -> int:
        if n <= 1:
            return 0
        if self._replay is not None and self._replay_pos < len(self._replay):
            d = self._replay[self._replay_pos] % n
            self._replay_pos += 1
        else:
            d = self._rng.randrange(n)
        self.decisions.append(d)
        return d

    def token(self) -> str:
        body = ".".join(str(d) for d in self.decisions)
        return f"s3sched:1:{self.seed}:{self.max_preemptions}:{body}"

    @classmethod
    def from_token(cls, token: str) -> "Scheduler":
        parts = token.split(":")
        if len(parts) != 5 or parts[0] != "s3sched" or parts[1] != "1":
            raise ValueError(f"not a v1 replay token: {token!r}")
        seed, budget = int(parts[2]), int(parts[3])
        decisions = [int(x) for x in parts[4].split(".") if x != ""]
        return cls(seed=seed, max_preemptions=budget, decisions=decisions)

    # -- driver --------------------------------------------------------
    def run(self) -> None:
        """Drive tasks to completion; re-raise the first task exception."""
        if not self._entered:
            raise RuntimeError("run() outside the scheduler context")
        while True:
            self._drain_external()
            live = [t for t in self.tasks if t.state != "done"]
            if not live:
                break
            self.steps += 1
            if self.steps > self.MAX_STEPS:
                raise SchedStuck(
                    f"no completion after {self.MAX_STEPS} scheduling steps "
                    f"(seed={self.seed} budget={self.max_preemptions})"
                )
            runnable = [t for t in live if t.state == "runnable"]
            if not runnable:
                chosen = self._wake_or_deadlock(live)
            else:
                chosen = self._pick(runnable)
            self._current = chosen
            chosen.gate.release()
            self._driver_gate.acquire()
            # whoever yielded may have died with an exception: fail fast —
            # its siblings may now block forever waiting on it
            for t in self.tasks:
                if t.exc is not None:
                    raise t.exc

    def _pick(self, runnable: List[_Task]) -> _Task:
        runnable = sorted(runnable, key=lambda t: t.index)
        cur = self._current
        if cur is not None and cur.state == "runnable" and cur in runnable:
            if len(runnable) > 1 and self._preemptions < self.max_preemptions:
                ordered = [cur] + [t for t in runnable if t is not cur]
                j = self._decide(len(ordered))
                if j != 0:
                    self._preemptions += 1
                return ordered[j]
            return cur
        j = self._decide(len(runnable))
        return runnable[j]

    def _wake_or_deadlock(self, live: List[_Task]) -> _Task:
        timed = sorted(
            (t for t in live if t.state == "blocked" and t.timed),
            key=lambda t: t.index,
        )
        if timed:
            j = self._decide(len(timed))
            t = timed[j]
            t.state = "runnable"
            t.wake_reason = "timeout"
            t.block_key = None
            return t
        # maybe an uncontrolled (non-task) thread will unblock us: poll the
        # external queue briefly before declaring deadlock
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            self._drain_external()
            runnable = [t for t in live if t.state == "runnable"]
            if runnable:
                return self._pick(runnable)
            time.sleep(0.001)
        dump = "; ".join(
            f"{t.name}: blocked on {t.block_key!r} at {t.block_site}"
            for t in live
        )
        raise SchedDeadlock(f"all tasks blocked, none timed: {dump}")

    # -- wakes (called from the RUNNING task or from the driver) --------
    def notify_key(self, key, n: Optional[int] = None) -> int:
        """Wake up to ``n`` (default: all) tasks blocked on ``key``. Only
        the single running task or the driver calls this — scheduler state
        needs no lock."""
        woken = 0
        for t in sorted(self.tasks, key=lambda t: t.index):
            if n is not None and woken >= n:
                break
            if t.state == "blocked" and t.block_key == key:
                t.state = "runnable"
                t.wake_reason = "notified"
                t.block_key = None
                woken += 1
        return woken

    def post_external(self, key) -> None:
        """Thread-safe wake posting for non-task threads."""
        with self._external_mu:
            self._external.append(key)

    def _drain_external(self) -> None:
        with self._external_mu:
            keys, self._external = self._external, []
        for key in keys:
            self.notify_key(key)

    # -- choice points --------------------------------------------------
    def checkpoint(self) -> None:
        """Explicit yield point (scenario code may call between ordinary
        statements to widen the explored interleaving set)."""
        t = current_task()
        if t is not None and t.sched is self:
            t.yield_to_driver()


def _choice_point() -> None:
    t = current_task()
    if t is not None and _ACTIVE is t.sched:
        t.yield_to_driver()


def _race_witness():
    """The active race witness, if ``racewitness`` is loaded AND installed.

    Lazy ``sys.modules`` lookup (never an import): this module stays
    stdlib-only, but when an exploration runs under the happens-before
    witness the cooperative primitives below must publish the same
    acquire/release clock edges the real ones do — otherwise every
    lock-protected access pair explored here would be reported as racy."""
    rw = sys.modules.get("s3shuffle_tpu_torch.utils.racewitness")
    return rw.active_witness() if rw is not None else None


def _witnessed_creation() -> bool:
    """False when the primitive under construction is one of threading.py's
    OWN internals (``Thread._started`` and friends — they exist because the
    scheduler patches the factories wholesale). Those must never emit race
    witness clock edges: witness thread registration calls
    ``current_thread()``, whose ``_DummyThread`` construction creates and
    sets an Event, which would recurse straight back into the witness.
    Mirrors lockwitness's creation-site scoping."""
    return sys._getframe(2).f_code.co_filename != threading.__file__


# ---------------------------------------------------------------------------
# Cooperative primitives (installed over threading.* inside the context)
# ---------------------------------------------------------------------------


class _CoopLock:
    """Cooperative ``threading.Lock``. Task threads yield instead of
    blocking; non-task threads fall back to real blocking on the raw
    primitive underneath (correct, but unexplored timing)."""

    _reentrant = False

    def __init__(self) -> None:
        self._raw = _allocate_lock()
        self._owner: Optional[int] = None
        self._count = 0
        self._witnessed = _witnessed_creation()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = threading.get_ident()
        if self._reentrant and self._owner == me:
            self._count += 1
            return True
        t = current_task()
        if t is None or _ACTIVE is not t.sched:
            if timeout is not None and timeout >= 0:
                ok = self._raw.acquire(blocking, timeout)
            else:
                ok = self._raw.acquire(blocking)
            if ok:
                self._owner = me
                self._count = 1
                w = _race_witness() if self._witnessed else None
                if w is not None:
                    w.on_acquire(self)
            return ok
        _choice_point()
        while True:
            if self._raw.acquire(False):
                self._owner = me
                self._count = 1
                w = _race_witness() if self._witnessed else None
                if w is not None:
                    w.on_acquire(self)
                return True
            if not blocking:
                return False
            t.block(("lock", id(self)), timed=bool(timeout is not None and timeout >= 0))
            if t.wake_reason == "timeout":
                return False

    def release(self) -> None:
        if self._reentrant:
            if self._owner != threading.get_ident():
                raise RuntimeError("cannot release un-acquired lock")
            self._count -= 1
            if self._count > 0:
                return
        self._owner = None
        self._count = 0
        w = _race_witness() if self._witnessed else None
        if w is not None:
            w.on_release(self)  # publish the clock BEFORE the next acquirer can win
        self._raw.release()
        t = current_task()
        sched = _ACTIVE
        if sched is None or sched._aborted:
            return
        if t is not None and sched is t.sched:
            sched.notify_key(("lock", id(self)))
            _choice_point()
        else:
            sched.post_external(("lock", id(self)))

    def locked(self) -> bool:
        return self._raw.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


class _CoopRLock(_CoopLock):
    _reentrant = True

    def _is_owned(self) -> bool:
        return self._owner == threading.get_ident()

    # Condition binds these when built over an RLock
    def _release_save(self):
        count = self._count
        self._count = 1  # force the next release() to fully release
        self.release()
        return count

    def _acquire_restore(self, count) -> None:
        self.acquire()
        self._count = count


class _CoopCondition:
    """Cooperative ``threading.Condition`` (RLock-backed by default)."""

    def __init__(self, lock=None):
        self._lock = lock if lock is not None else _CoopRLock()
        # the Condition's HB edges ride on its lock's acquire/release (the
        # wait/notify handoff re-acquires it) — scope them to the
        # CONDITION's creation site, not this module's
        if isinstance(self._lock, _CoopLock):
            self._lock._witnessed = _witnessed_creation()
        #: raw waiter locks for non-task threads (stdlib's own algorithm)
        self._real_waiters: List[object] = []

    # lock interface delegation
    def acquire(self, *args, **kwargs):
        return self._lock.acquire(*args, **kwargs)

    def release(self) -> None:
        self._lock.release()

    def __enter__(self):
        return self._lock.__enter__()

    def __exit__(self, *exc) -> None:
        self._lock.__exit__(*exc)

    def _is_owned(self) -> bool:
        if isinstance(self._lock, _CoopRLock):
            return self._lock._is_owned()
        return self._lock.locked()

    def wait(self, timeout: Optional[float] = None) -> bool:
        if not self._is_owned():
            raise RuntimeError("cannot wait on un-acquired lock")
        t = current_task()
        if t is None or _ACTIVE is not t.sched:
            waiter = _allocate_lock()
            waiter.acquire()
            self._real_waiters.append(waiter)
            saved = self._save_release()
            try:
                if timeout is None:
                    waiter.acquire()
                    return True
                return waiter.acquire(True, timeout)
            finally:
                self._restore(saved)
        sched = t.sched
        saved = self._save_release()
        sched.notify_key(("lock", id(self._lock)))
        t.block(("cond", id(self)), timed=timeout is not None)
        notified = t.wake_reason != "timeout"
        self._restore(saved)
        return notified

    def _save_release(self):
        if isinstance(self._lock, _CoopRLock):
            return self._lock._release_save()
        self._lock.release()
        return None

    def _restore(self, saved) -> None:
        if isinstance(self._lock, _CoopRLock):
            self._lock._acquire_restore(saved)
        else:
            self._lock.acquire()

    def wait_for(self, predicate, timeout: Optional[float] = None):
        endtime = None
        result = predicate()
        while not result:
            if timeout is not None:
                if endtime is None:
                    endtime = time.monotonic() + timeout
                remaining = endtime - time.monotonic()
                # cooperative time: a timed wait only fires at idle, so the
                # remaining-budget bookkeeping is advisory
                if remaining <= 0 and current_task() is None:
                    break
                self.wait(remaining if current_task() is None else timeout)
            else:
                self.wait(None)
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        if not self._is_owned():
            raise RuntimeError("cannot notify on un-acquired lock")
        sched = _ACTIVE
        woken = 0
        t = current_task()
        if sched is not None and not sched._aborted and t is not None and sched is t.sched:
            woken = sched.notify_key(("cond", id(self)), n)
            _choice_point()
        elif sched is not None and not sched._aborted:
            # non-task thread notifying task waiters (e.g. a helper thread of
            # the port the scenario did not spawn): route through the external
            # wake queue the driver drains
            sched.post_external(("cond", id(self)))
        while woken < n and self._real_waiters:
            self._real_waiters.pop(0).release()
            woken += 1

    def notify_all(self) -> None:
        self.notify(n=len(self._real_waiters) + 1_000_000)


class _CoopEvent:
    """Cooperative ``threading.Event``."""

    def __init__(self) -> None:
        self._flag = False
        self._witnessed = _witnessed_creation()

    def is_set(self) -> bool:
        return self._flag

    def set(self) -> None:
        w = _race_witness() if self._witnessed else None
        if w is not None:
            w.on_release(self)  # publish BEFORE the flag becomes observable
        self._flag = True
        t = current_task()
        sched = _ACTIVE
        if sched is None or sched._aborted:
            return
        if t is not None and sched is t.sched:
            sched.notify_key(("event", id(self)))
            _choice_point()
        else:
            sched.post_external(("event", id(self)))

    def clear(self) -> None:
        self._flag = False

    def wait(self, timeout: Optional[float] = None) -> bool:
        t = current_task()
        if t is None or _ACTIVE is not t.sched:
            # non-task fallback: bounded poll against the flag
            deadline = None if timeout is None else time.monotonic() + timeout
            while not self._flag:
                if deadline is not None and time.monotonic() >= deadline:
                    return False
                time.sleep(0.001)
            w = _race_witness() if self._witnessed else None
            if w is not None:
                w.on_acquire(self)
            return True
        _choice_point()
        while not self._flag:
            t.block(("event", id(self)), timed=timeout is not None)
            if t.wake_reason == "timeout":
                if self._flag:
                    w = _race_witness() if self._witnessed else None
                    if w is not None:
                        w.on_acquire(self)
                return self._flag
        w = _race_witness() if self._witnessed else None
        if w is not None:
            w.on_acquire(self)
        return True


# ---------------------------------------------------------------------------
# Exploration driver
# ---------------------------------------------------------------------------


class ExploreResult:
    __slots__ = ("failed", "token", "error", "schedules_run")

    def __init__(
        self,
        failed: bool,
        token: Optional[str],
        error: Optional[BaseException],
        schedules_run: int,
    ):
        self.failed = failed
        self.token = token
        self.error = error
        self.schedules_run = schedules_run

    def __repr__(self) -> str:
        state = f"FAILED token={self.token!r}" if self.failed else "clean"
        return f"<ExploreResult {state} after {self.schedules_run} schedule(s)>"


def _derive_seed(seed: int, i: int) -> int:
    return (seed * 1000003 + i * 7919 + 0x9E3779B9) & 0x7FFFFFFF


def _count_schedule() -> None:
    global _SCHEDULES_EXPLORED
    _SCHEDULES_EXPLORED += 1


def _run_one(scenario, sched: Scheduler) -> None:
    with sched:
        check = scenario(sched)
        sched.run()
    if check is not None:
        check()


def explore(
    scenario: Callable[[Scheduler], Optional[Callable[[], None]]],
    *,
    schedules: int = 200,
    seed: int = 0,
    max_preemptions: int = 3,
) -> ExploreResult:
    """Run ``scenario`` under ``schedules`` distinct seeded schedules,
    cycling preemption budgets 0..max_preemptions (iterative context
    bounding). ``scenario(sched)`` spawns tasks and may return a check
    callable executed after the schedule completes; any exception —
    scenario, check, deadlock, livelock — fails the exploration and yields
    a replay token. Clean = every schedule ran to completion."""
    for i in range(schedules):
        budget = i % (max_preemptions + 1)
        sched = Scheduler(seed=_derive_seed(seed, i), max_preemptions=budget)
        try:
            _run_one(scenario, sched)
        except BaseException as e:  # noqa: BLE001 - the finding, not a crash
            _count_schedule()
            publish_metrics()
            return ExploreResult(True, sched.token(), e, i + 1)
        _count_schedule()
    publish_metrics()
    return ExploreResult(False, None, None, schedules)


def replay(
    scenario: Callable[[Scheduler], Optional[Callable[[], None]]],
    token: str,
) -> ExploreResult:
    """Re-execute one schedule decision-for-decision from a replay token."""
    sched = Scheduler.from_token(token)
    try:
        _run_one(scenario, sched)
    except BaseException as e:  # noqa: BLE001
        _count_schedule()
        publish_metrics()
        return ExploreResult(True, sched.token(), e, 1)
    _count_schedule()
    publish_metrics()
    return ExploreResult(False, None, None, 1)


def schedules_explored() -> int:
    return _SCHEDULES_EXPLORED


def publish_metrics() -> None:
    """Fold the explored-schedule tally into the package registry
    (``sched_schedules_explored_total``) as a delta. Lazy import — this
    module stays stdlib-only at import time; best-effort standalone."""
    global _PUBLISHED_EXPLORED
    try:
        from s3shuffle_tpu_torch.metrics import registry as _metrics
    except Exception:
        logging.getLogger(__name__).debug(
            "explorer metrics not published: package registry unavailable",
            exc_info=True,
        )
        return
    counter = _metrics.REGISTRY.counter(
        "sched_schedules_explored_total",
        "Schedules executed by the deterministic cooperative explorer",
    )
    delta = _SCHEDULES_EXPLORED - _PUBLISHED_EXPLORED
    _PUBLISHED_EXPLORED = _SCHEDULES_EXPLORED
    if delta:
        counter.inc(delta)
