"""Runtime lock-order witness of the port (the JAX package's
``utils/lockwitness.py``): the dynamic check that no two call stacks take
the same pair of locks in opposite orders.

- :func:`install` replaces ``threading.Lock`` / ``RLock`` / ``Condition`` /
  ``Event`` / ``Barrier`` with witnessed factories. Only primitives
  constructed by *watched code* (by default: files under the
  ``s3shuffle_tpu_torch`` package, this file's own package; extendable with
  ``extra_paths``) are wrapped; the stdlib's and torch's machinery keeps
  the raw primitives;
- every witnessed lock is keyed by its **allocation site** (``file:line`` of
  the constructor call, relative to the package root), so every instance of
  one class's lock is one graph node and the graph describes the design,
  not one run's objects;
- an acquisition made while the thread already holds witnessed locks
  records the directed edges ``held-site -> new-site``;
- :func:`find_cycles` reports the graph's cycles: a cycle is a lock-order
  inversion that can deadlock under some interleaving, even when this run
  did not. Same-site self-loops are ignored (two instances of one class's
  lock are ordered by address, not by design).

``Condition.wait`` is modelled: the witnessed RLock's ``_release_save`` /
``_acquire_restore`` hooks take the lock off the holder's stack for the
wait and put it back on wakeup, so waiting does not fabricate edges.

``Event`` and ``Barrier`` add no hold edges, but they order threads: a
thread that waits on an event while holding witnessed locks records
``held-site -> event-site``, and ``set()`` records ``event-site ->
held-site`` for the locks the setter holds, so the lost-wakeup deadlock (A
holds L and waits on E; B needs L before it can set E) shows as the cycle
``L -> E -> L``. A barrier wait records the wait-side edges only. The
sync-listener interface forwards every witnessed acquire, release, set,
satisfied wait and barrier trip to one listener:
:mod:`s3shuffle_tpu_torch.utils.racewitness` builds its vector clocks
there.

Opt-in: ``S3SHUFFLE_LOCK_WITNESS=1`` with :func:`install_from_env` called
before the port is imported (module-level locks are built at import; the
module is stdlib-only so that a process can load it by file spec first,
under its canonical ``sys.modules`` name). Scoped use::

    with lockwitness.watching() as w:
        ... run a workload ...
    assert w.find_cycles() == []

Uninstalled, it costs nothing: nothing is patched. Host ordering through
CUDA (stream waits, ``torch.cuda.Event.synchronize()``) is not a Python
primitive and is not seen.
"""

from __future__ import annotations

import os
import sys
import threading
import _thread
from typing import Dict, List, Optional, Set, Tuple

#: the raw primitive, captured before any patching can occur
_allocate_lock = _thread.allocate_lock

#: optional sync-event listener (duck-typed): ``on_acquire(obj)`` after a
#: witnessed primitive establishes an ordering INTO the calling thread
#: (lock acquired, Event.wait satisfied, Barrier.wait passed) and
#: ``on_release(obj)`` just BEFORE it publishes an ordering OUT of the
#: calling thread (lock about to be released, Event.set, Barrier.wait
#: entered). racewitness installs itself here; None costs one global read.
_sync_listener = None


def set_sync_listener(listener) -> None:
    """Register/clear (``None``) the happens-before listener. At most one:
    the race witness owns the slot; the cooperative scheduler
    (``utils/sched.py``) patches the factories wholesale instead."""
    global _sync_listener
    _sync_listener = listener

_THIS_FILE = os.path.abspath(__file__)
_PKG_ROOT = os.path.dirname(os.path.dirname(_THIS_FILE))


class _Holder(threading.local):
    """Per-thread stack of (lock-object, site) currently held."""

    def __init__(self) -> None:
        self.stack: List[Tuple[object, str]] = []


class LockWitness:
    """Order-graph recorder shared by every witnessed lock."""

    def __init__(self) -> None:
        self._mu = _allocate_lock()
        # site -> set of sites acquired while this one was held
        self._edges: Dict[str, Set[str]] = {}
        # (from, to) -> one example (thread name) for diagnostics
        self._examples: Dict[Tuple[str, str], str] = {}
        self._holder = _Holder()

    # -- recording -----------------------------------------------------
    def on_acquired(self, lock: object, site: str) -> None:
        stack = self._holder.stack
        if any(obj is lock for obj, _ in stack):
            # re-entrant acquire of the same object (RLock): no new edges —
            # mark the reentry so release bookkeeping stays balanced
            stack.append((lock, site))
            return
        if stack:
            tname = threading.current_thread().name
            with self._mu:
                for _obj, held_site in stack:
                    if held_site == site:
                        continue  # same-design-site pair: address-ordered
                    self._edges.setdefault(held_site, set()).add(site)
                    self._examples.setdefault((held_site, site), tname)
        stack.append((lock, site))

    def on_released(self, lock: object) -> None:
        stack = self._holder.stack
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] is lock:
                del stack[i]
                return

    def on_ordered(self, from_site: str, to_site: str) -> None:
        """Record a directed ordering edge between two sites that is NOT a
        hold-while-acquiring pair (Event/Barrier rendezvous edges)."""
        if from_site == to_site:
            return
        tname = threading.current_thread().name
        with self._mu:
            self._edges.setdefault(from_site, set()).add(to_site)
            self._examples.setdefault((from_site, to_site), tname)

    def on_wait_point(self, site: str) -> None:
        """The calling thread blocks at rendezvous ``site`` while holding
        witnessed locks: record ``held -> site`` for each."""
        for _obj, held_site in self._holder.stack:
            self.on_ordered(held_site, site)

    def on_signal_point(self, site: str) -> None:
        """The rendezvous at ``site`` completes only after the signalling
        thread — which currently holds these locks — makes progress:
        record ``site -> held``. With the wait-side edges this closes the
        lost-wakeup cycle ``L -> E -> L`` (A holds L waiting on E; B needs
        L before it can set E)."""
        for _obj, held_site in self._holder.stack:
            self.on_ordered(site, held_site)

    def on_released_all(self, lock: object) -> int:
        """Condition.wait released the lock completely (every reentry).
        Returns how many stack entries were removed so the wakeup can
        re-push the same number — a reentrantly-held condition lock must
        not leave the holder's stack short after the wait."""
        stack = self._holder.stack
        kept = [(obj, site) for obj, site in stack if obj is not lock]
        removed = len(stack) - len(kept)
        self._holder.stack = kept
        return removed

    # -- reporting -----------------------------------------------------
    def edges(self) -> Dict[str, Set[str]]:
        with self._mu:
            return {k: set(v) for k, v in self._edges.items()}

    def find_cycles(self) -> List[List[str]]:
        """Cycles in the site order graph (each returned as the site list
        around the loop). Empty list = every observed acquisition order is
        consistent with a global partial order = no ABBA deadlock among the
        exercised paths."""
        graph = self.edges()
        color: Dict[str, int] = {}  # 0/absent=white 1=grey 2=black
        path: List[str] = []
        cycles: List[List[str]] = []

        def dfs(node: str) -> None:
            color[node] = 1
            path.append(node)
            for nxt in sorted(graph.get(node, ())):
                c = color.get(nxt, 0)
                if c == 0:
                    dfs(nxt)
                elif c == 1:
                    cycles.append(path[path.index(nxt):] + [nxt])
            path.pop()
            color[node] = 2

        for node in sorted(graph):
            if color.get(node, 0) == 0:
                dfs(node)
        return cycles

    def format_report(self) -> str:
        cycles = self.find_cycles()
        if not cycles:
            return "lock witness: no ordering cycles"
        lines = [f"lock witness: {len(cycles)} ordering cycle(s) detected:"]
        with self._mu:
            for cyc in cycles:
                lines.append("  " + " -> ".join(cyc))
                for a, b in zip(cyc, cyc[1:]):
                    who = self._examples.get((a, b), "?")
                    lines.append(f"    {a} held while acquiring {b} (thread {who})")
        return "\n".join(lines)

    def reset(self) -> None:
        with self._mu:
            self._edges.clear()
            self._examples.clear()


class _WitnessedLock:
    """Wrapper over a raw lock that reports to the witness."""

    def __init__(self, witness: LockWitness, inner, site: str):
        self._witness = witness
        self._inner = inner
        self._site = site

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._witness.on_acquired(self, self._site)
            listener = _sync_listener
            if listener is not None:
                listener.on_acquire(self)
        return ok

    def release(self) -> None:
        # publish BEFORE dropping the inner lock: a racing acquirer must
        # observe the releasing thread's full clock, not a stale one
        listener = _sync_listener
        if listener is not None:
            listener.on_release(self)
        self._inner.release()
        self._witness.on_released(self)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<witnessed {self._inner!r} from {self._site}>"


class _WitnessedRLock(_WitnessedLock):
    """RLock wrapper exposing the private hooks ``threading.Condition``
    binds at construction (``_release_save`` / ``_acquire_restore`` /
    ``_is_owned``), so a Condition built on this wrapper models its wait
    protocol faithfully in the witness."""

    def locked(self) -> bool:  # RLock in 3.12+; best-effort before
        locked = getattr(self._inner, "locked", None)
        return locked() if callable(locked) else self._inner._is_owned()

    def _release_save(self):
        listener = _sync_listener
        if listener is not None:
            listener.on_release(self)
        state = self._inner._release_save()
        removed = self._witness.on_released_all(self)
        return (state, removed)

    def _acquire_restore(self, state) -> None:
        inner_state, removed = state
        self._inner._acquire_restore(inner_state)
        # restore the SAME stack depth the wait released (reentrant holds
        # push one entry per acquire); the first push records edges, the
        # rest are reentries
        for _ in range(max(1, removed)):
            self._witness.on_acquired(self, self._site)
        listener = _sync_listener
        if listener is not None:
            listener.on_acquire(self)

    def _is_owned(self) -> bool:
        return self._inner._is_owned()


class _WitnessedEvent:
    """``threading.Event`` wrapper: ``set -> wait`` is an ordering edge.

    Order-graph model (see module docstring): ``wait`` records
    ``held -> event-site``; ``set`` records ``event-site -> held``.
    Happens-before: ``set`` publishes to the listener, a satisfied ``wait``
    joins — an Event-guarded handoff is synchronization, not a race."""

    def __init__(self, witness: LockWitness, inner, site: str):
        self._witness = witness
        self._inner = inner
        self._site = site

    def is_set(self) -> bool:
        return self._inner.is_set()

    def set(self) -> None:
        listener = _sync_listener
        if listener is not None:
            listener.on_release(self)
        self._witness.on_signal_point(self._site)
        self._inner.set()

    def clear(self) -> None:
        self._inner.clear()

    def wait(self, timeout: Optional[float] = None) -> bool:
        self._witness.on_wait_point(self._site)
        ok = self._inner.wait(timeout)
        if ok:
            listener = _sync_listener
            if listener is not None:
                listener.on_acquire(self)
        return ok

    def __repr__(self) -> str:
        return f"<witnessed {self._inner!r} from {self._site}>"


class _WitnessedBarrier:
    """``threading.Barrier`` wrapper: the trip is an all-to-all ordering
    edge. Each party publishes its clock on entry and joins the barrier's
    merged clock on exit; the order graph gets the wait-side
    ``held -> barrier-site`` hazard edges (holding a witnessed lock across
    a barrier wait is the deadlock shape worth surfacing)."""

    def __init__(self, witness: LockWitness, inner, site: str):
        self._witness = witness
        self._inner = inner
        self._site = site

    def wait(self, timeout: Optional[float] = None) -> int:
        listener = _sync_listener
        if listener is not None:
            listener.on_release(self)
        self._witness.on_wait_point(self._site)
        idx = self._inner.wait(timeout)
        listener = _sync_listener
        if listener is not None:
            listener.on_acquire(self)
        return idx

    def reset(self) -> None:
        self._inner.reset()

    def abort(self) -> None:
        self._inner.abort()

    @property
    def parties(self) -> int:
        return self._inner.parties

    @property
    def n_waiting(self) -> int:
        return self._inner.n_waiting

    @property
    def broken(self) -> bool:
        return self._inner.broken

    def __repr__(self) -> str:
        return f"<witnessed {self._inner!r} from {self._site}>"


# ---------------------------------------------------------------------------
# Installation
# ---------------------------------------------------------------------------

_installed: Optional["_Install"] = None


class _Install:
    def __init__(self, witness: LockWitness, watch_paths: Tuple[str, ...]):
        self.witness = witness
        self.watch_paths = watch_paths
        self.orig_lock = threading.Lock
        self.orig_rlock = threading.RLock
        self.orig_condition = threading.Condition
        self.orig_event = threading.Event
        self.orig_barrier = threading.Barrier


def _caller_site(depth: int = 2) -> Optional[str]:
    """``file:line`` of the first frame outside this module, or None when the
    constructor ran from unwatched code."""
    inst = _installed
    if inst is None:
        return None
    frame = sys._getframe(depth)
    while frame is not None:
        fn = os.path.abspath(frame.f_code.co_filename)
        if fn != _THIS_FILE:
            if any(
                fn == p or fn.startswith(p + os.sep) for p in inst.watch_paths
            ):
                return f"{os.path.relpath(fn, _PKG_ROOT)}:{frame.f_lineno}"
            return None
        frame = frame.f_back
    return None


def _make_lock(*args, **kwargs):
    site = _caller_site()
    inner = _installed.orig_lock(*args, **kwargs) if _installed else _allocate_lock()
    if site is None or _installed is None:
        return inner
    return _WitnessedLock(_installed.witness, inner, site)


def _make_rlock(*args, **kwargs):
    site = _caller_site()
    inner = (
        _installed.orig_rlock(*args, **kwargs)
        if _installed
        else threading.RLock(*args, **kwargs)
    )
    if site is None or _installed is None:
        return inner
    return _WitnessedRLock(_installed.witness, inner, site)


def _make_condition(lock=None):
    orig_condition = _installed.orig_condition if _installed else threading.Condition
    if lock is None and _installed is not None:
        site = _caller_site()
        if site is not None:
            inner = _installed.orig_rlock()
            lock = _WitnessedRLock(_installed.witness, inner, site)
    return orig_condition(lock)


def _make_event():
    site = _caller_site()
    inner = _installed.orig_event() if _installed else threading.Event()
    if site is None or _installed is None:
        return inner
    return _WitnessedEvent(_installed.witness, inner, site)


def _make_barrier(parties, action=None, timeout=None):
    orig_barrier = _installed.orig_barrier if _installed else threading.Barrier
    site = _caller_site()
    inner = orig_barrier(parties, action, timeout)
    if site is None or _installed is None:
        return inner
    return _WitnessedBarrier(_installed.witness, inner, site)


def install(extra_paths: Tuple[str, ...] = ()) -> LockWitness:
    """Patch ``threading.{Lock,RLock,Condition,Event,Barrier}`` with witnessed
    factories. Primitives constructed by code under ``s3shuffle_tpu_torch``
    (plus ``extra_paths``)
    are recorded; everything else gets the raw primitive. Idempotent — a
    second install returns the existing witness, EXTENDING its watch set
    with any new ``extra_paths`` (silently dropping them would make a
    caller's cycle check vacuous)."""
    global _installed
    if _installed is not None:
        if extra_paths:
            merged = _installed.watch_paths + tuple(
                os.path.abspath(p) for p in extra_paths
            )
            _installed.watch_paths = tuple(dict.fromkeys(merged))
        return _installed.witness
    watch = (_PKG_ROOT,) + tuple(os.path.abspath(p) for p in extra_paths)
    _installed = _Install(LockWitness(), watch)
    threading.Lock = _make_lock  # type: ignore[assignment]
    threading.RLock = _make_rlock  # type: ignore[assignment]
    threading.Condition = _make_condition  # type: ignore[assignment]
    threading.Event = _make_event  # type: ignore[assignment]
    threading.Barrier = _make_barrier  # type: ignore[assignment]
    return _installed.witness


def uninstall() -> None:
    global _installed
    if _installed is None:
        return
    threading.Lock = _installed.orig_lock  # type: ignore[assignment]
    threading.RLock = _installed.orig_rlock  # type: ignore[assignment]
    threading.Condition = _installed.orig_condition  # type: ignore[assignment]
    threading.Event = _installed.orig_event  # type: ignore[assignment]
    threading.Barrier = _installed.orig_barrier  # type: ignore[assignment]
    _installed = None


def active_witness() -> Optional[LockWitness]:
    return _installed.witness if _installed is not None else None


class watching:
    """Context manager: install on enter, uninstall on exit, expose the
    witness. Locks created inside keep working after exit (they hold their
    own inner primitives) — only NEW constructions stop being witnessed."""

    def __init__(self, extra_paths: Tuple[str, ...] = ()):
        self._extra = extra_paths
        self.witness: Optional[LockWitness] = None
        self._preinstalled = False
        self._saved_watch: Optional[Tuple[str, ...]] = None

    def __enter__(self) -> LockWitness:
        self._preinstalled = _installed is not None
        if self._preinstalled:
            self._saved_watch = _installed.watch_paths
        self.witness = install(self._extra)
        return self.witness

    def __exit__(self, *exc) -> None:
        if not self._preinstalled:  # an env-level install outlives us
            uninstall()
        elif self._saved_watch is not None:
            # restore the installed witness's watch scope — our extra_paths
            # were for this block only
            _installed.watch_paths = self._saved_watch


def install_from_env() -> Optional[LockWitness]:
    """Install iff ``S3SHUFFLE_LOCK_WITNESS`` is set truthy. ``0`` /
    ``false`` / ``no`` / ``off`` disable, like every other boolean knob."""
    value = os.environ.get("S3SHUFFLE_LOCK_WITNESS", "").strip().lower()
    if value and value not in ("0", "false", "no", "off"):
        return install()
    return None
