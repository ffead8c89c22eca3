"""Vector-clock happens-before race witness of the port (the JAX
package's ``utils/racewitness.py``): the data-race half of the concurrency
checks, on the interposition of :mod:`.lockwitness`.

It is the FastTrack/TSan analysis:

- every thread carries a vector clock, every synchronization object a
  message clock;
- a **release-like** operation (lock release, ``Condition`` wait entry,
  ``Event.set``, ``Barrier`` entry, ``queue.Queue.put``,
  ``Future.set_result`` / ``set_exception``) joins the thread's clock into
  the object's and advances the thread;
- an **acquire-like** operation (lock acquire, wait wakeup, satisfied
  ``Event.wait``, barrier exit, ``queue.Queue.get``, ``Future.result``)
  joins the object's clock into the thread's;
- a fork carries the parent's clock to the child
  (``threading.Thread.start`` -> ``run``, ``ThreadPoolExecutor.submit`` ->
  the submitted function, which covers ``GrowReapExecutor`` and the codec's
  encode thread and decode pool) and ``Thread.join`` carries the child's
  final clock back.

Shared state is registered with :func:`watch_shared(obj, fields)`. The
instance moves onto a generated subclass whose ``__getattribute__`` /
``__setattr__`` report reads and writes of the named fields; dict and list
values are wrapped in tracked containers, so element mutation counts as a
write of the field. Two accesses to one (object, field), at least one a
write, with no happens-before edge between them, are reported with both
access stacks and the watch site.

The queue model is one channel clock (every put happens-before any later
get): it can miss a race, never invent one. Host ordering through CUDA
(stream waits, ``torch.cuda.Event.synchronize()``) is not an edge here:
the watched fields are host state ordered by Python locks.

Opt-in: ``S3SHUFFLE_RACE_WITNESS=1`` with :func:`install_from_env` called
before the port is imported, or scoped::

    with racewitness.watching() as w:
        ... run a workload ...
    w.assert_clean()

Off, :func:`watch_shared` returns its argument untouched and nothing is
patched. This module stays stdlib-only: a process loads it by file spec,
under its canonical ``sys.modules`` name, before any import of the port, so
locks built at import are witnessed.
"""

from __future__ import annotations

import logging
import os
import queue as _queue_mod
import sys
import threading
import _thread
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

#: raw primitive, captured before any patching
_allocate_lock = _thread.allocate_lock

_THIS_FILE = os.path.abspath(__file__)
_PKG_ROOT = os.path.dirname(os.path.dirname(_THIS_FILE))
_REPO_ROOT = os.path.dirname(_PKG_ROOT)

#: the active witness, or None (the zero-overhead-off gate)
_WITNESS: Optional["RaceWitness"] = None


def _lockwitness():
    """The port's lockwitness module without importing the package (a
    process that loads both by file spec registers it in ``sys.modules``
    first; the normal import serves every other caller)."""
    mod = sys.modules.get("s3shuffle_tpu_torch.utils.lockwitness")
    if mod is None:
        from s3shuffle_tpu_torch.utils import lockwitness as mod  # type: ignore
    return mod


# ---------------------------------------------------------------------------
# Vector clocks (plain dicts: tid -> counter)
# ---------------------------------------------------------------------------


def _join(dst: Dict[int, int], src: Dict[int, int]) -> None:
    for k, v in src.items():
        if dst.get(k, 0) < v:
            dst[k] = v


class _TLS(threading.local):
    def __init__(self) -> None:
        self.tid: Optional[int] = None
        self.clock: Optional[Dict[int, int]] = None


def _access_stack(limit: int = 8) -> Tuple[str, ...]:
    """Repo-internal frames of the current call, innermost first, skipping
    this module (the interposition layer is never the interesting frame)."""
    out: List[str] = []
    frame = sys._getframe(2)
    while frame is not None and len(out) < limit:
        fn = os.path.abspath(frame.f_code.co_filename)
        if fn != _THIS_FILE and (
            fn == _REPO_ROOT or fn.startswith(_REPO_ROOT + os.sep)
        ):
            out.append(
                f"{os.path.relpath(fn, _REPO_ROOT)}:{frame.f_lineno} "
                f"({frame.f_code.co_name})"
            )
        frame = frame.f_back
    return tuple(out)


class _Access:
    """One side of a potential race: who, when (epoch), from where."""

    __slots__ = ("tid", "clk", "thread", "stack")

    def __init__(self, tid: int, clk: int, thread: str, stack: Tuple[str, ...]):
        self.tid = tid
        self.clk = clk
        self.thread = thread
        self.stack = stack


class _VarState:
    """Per (object, field) access metadata: last write epoch + read vector."""

    __slots__ = ("write", "reads")

    def __init__(self) -> None:
        self.write: Optional[_Access] = None
        self.reads: Dict[int, _Access] = {}


class _WatchEntry:
    __slots__ = ("obj", "fields", "site", "clsname")

    def __init__(self, obj: object, fields: FrozenSet[str], site: str, clsname: str):
        self.obj = obj  # strong ref: id() keys must not be reused
        self.fields = fields
        self.site = site
        self.clsname = clsname


# ---------------------------------------------------------------------------
# The witness
# ---------------------------------------------------------------------------


class RaceWitness:
    def __init__(self) -> None:
        self._mu = _allocate_lock()
        self._tls = _TLS()
        self._next_tid = 0
        self._tid_names: Dict[int, str] = {}
        #: sync object id -> message clock (object kept alive by its owner;
        #: id collisions after GC would only merge clocks = extra HB edges,
        #: i.e. at worst a missed race, never a false one)
        self._obj_clocks: Dict[int, Dict[int, int]] = {}
        self._vars: Dict[Tuple[int, str], _VarState] = {}
        self._watched: Dict[int, _WatchEntry] = {}
        self.checks = 0
        self.reports: List[str] = []
        self._report_keys: Set[Tuple[str, str, str, str, str]] = set()
        self._published_checks = 0
        self._published_reports = 0

    # -- thread identity ----------------------------------------------
    def _me(self) -> Tuple[int, Dict[int, int]]:
        tls = self._tls
        if tls.tid is None:
            # resolve the name BEFORE taking _mu: current_thread() can
            # construct a _DummyThread (whose Event plumbing may re-enter
            # witness hooks), and _mu is not reentrant
            name = threading.current_thread().name
            with self._mu:
                tid = self._next_tid
                self._next_tid += 1
                self._tid_names[tid] = name
            tls.tid = tid
            tls.clock = {tid: 1}
            snap = getattr(threading.current_thread(), "_race_fork", None)
            if snap:
                _join(tls.clock, snap)
        return tls.tid, tls.clock  # type: ignore[return-value]

    # -- synchronization edges (lockwitness sync-listener protocol) ----
    def on_acquire(self, obj: object) -> None:
        _tid, clock = self._me()
        with self._mu:
            oc = self._obj_clocks.get(id(obj))
            if oc:
                _join(clock, oc)

    def on_release(self, obj: object) -> None:
        tid, clock = self._me()
        with self._mu:
            oc = self._obj_clocks.setdefault(id(obj), {})
            _join(oc, clock)
        clock[tid] = clock.get(tid, 0) + 1

    # -- fork/join edges ----------------------------------------------
    def fork(self) -> Dict[int, int]:
        """Snapshot the caller's clock for a child (then advance the
        caller so the child's view is a strict prefix)."""
        tid, clock = self._me()
        snap = dict(clock)
        clock[tid] = clock.get(tid, 0) + 1
        return snap

    def adopt_fork(self, snap: Dict[int, int]) -> None:
        _tid, clock = self._me()
        _join(clock, snap)

    def fork_wrap(self, fn):
        """Wrap a callable so the submitter's clock at wrap time
        happens-before the callable's body (executor submit -> run)."""
        snap = self.fork()

        def _forked(*args, **kwargs):
            w = _WITNESS
            if w is not None:
                w.adopt_fork(snap)
            return fn(*args, **kwargs)

        return _forked

    # -- shared-state watching ----------------------------------------
    def watch(self, obj: object, fields: Tuple[str, ...]) -> object:
        cls = type(obj)
        base = getattr(cls, "_race_watched_base", None)
        if base is None:
            obj.__class__ = _watched_class_for(cls)  # type: ignore[assignment]
            base = cls
        site = self._watch_site()
        with self._mu:
            entry = self._watched.get(id(obj))
            if entry is not None:
                fieldset = entry.fields | frozenset(fields)
            else:
                fieldset = frozenset(fields)
            self._watched[id(obj)] = _WatchEntry(
                obj, fieldset, site, base.__name__
            )
        # container fields: element mutation must count as field access —
        # re-assigning routes through the watched __setattr__, which wraps
        # plain dict/list values in tracked containers (and keeps doing so
        # on every later rebind, e.g. the drain()-style swap idiom)
        for f in fields:
            try:
                value = getattr(obj, f)
            except AttributeError:
                continue
            if type(value) in (dict, list):
                setattr(obj, f, value)
        return obj

    @staticmethod
    def _watch_site() -> str:
        frame = sys._getframe(2)
        while frame is not None:
            fn = os.path.abspath(frame.f_code.co_filename)
            if fn != _THIS_FILE:
                return f"{os.path.relpath(fn, _REPO_ROOT)}:{frame.f_lineno}"
            frame = frame.f_back
        return "?"

    def _entry_for(self, obj: object) -> Optional[_WatchEntry]:
        return self._watched.get(id(obj))

    # -- access checks (FastTrack-style) ------------------------------
    def on_read(self, obj: object, field: str) -> None:
        tid, clock = self._me()
        acc = _Access(
            tid, clock.get(tid, 0), threading.current_thread().name,
            _access_stack(),
        )
        with self._mu:
            self.checks += 1
            st = self._vars.setdefault((id(obj), field), _VarState())
            w = st.write
            if w is not None and w.tid != tid and w.clk > clock.get(w.tid, 0):
                self._record(obj, field, "write/read", w, acc)
            st.reads[tid] = acc

    def on_write(self, obj: object, field: str) -> None:
        tid, clock = self._me()
        acc = _Access(
            tid, clock.get(tid, 0), threading.current_thread().name,
            _access_stack(),
        )
        with self._mu:
            self.checks += 1
            st = self._vars.setdefault((id(obj), field), _VarState())
            w = st.write
            if w is not None and w.tid != tid and w.clk > clock.get(w.tid, 0):
                self._record(obj, field, "write/write", w, acc)
            for rtid, racc in st.reads.items():
                if rtid != tid and racc.clk > clock.get(rtid, 0):
                    self._record(obj, field, "read/write", racc, acc)
            st.write = acc
            st.reads.clear()

    def _record(
        self, obj: object, field: str, kind: str, a: _Access, b: _Access
    ) -> None:
        """Under self._mu: format and dedupe one report."""
        entry = self._watched.get(id(obj))
        clsname = entry.clsname if entry else type(obj).__name__
        site = entry.site if entry else "?"
        a_top = a.stack[0] if a.stack else "?"
        b_top = b.stack[0] if b.stack else "?"
        key = (kind, f"{clsname}.{field}", site, a_top, b_top)
        if key in self._report_keys:
            return
        self._report_keys.add(key)
        lines = [
            f"race witness: {kind} race on {clsname}.{field} "
            f"(watched at {site}) — no happens-before edge between:",
            f"  [{kind.split('/')[0]}] thread {a.thread!r} (T{a.tid}@{a.clk}):",
        ]
        lines += [f"    {fr}" for fr in (a.stack or ("<no repo frames>",))]
        lines.append(
            f"  [{kind.split('/')[1]}] thread {b.thread!r} (T{b.tid}@{b.clk}):"
        )
        lines += [f"    {fr}" for fr in (b.stack or ("<no repo frames>",))]
        self.reports.append("\n".join(lines))

    # -- reporting -----------------------------------------------------
    def format_report(self) -> str:
        if not self.reports:
            return (
                f"race witness: no unsynchronized access pairs "
                f"({self.checks} checks)"
            )
        head = (
            f"race witness: {len(self.reports)} unsynchronized access "
            f"pair(s) ({self.checks} checks):"
        )
        return "\n".join([head] + self.reports)

    def assert_clean(self) -> None:
        publish_metrics(self)
        if self.reports:
            raise AssertionError(self.format_report())

    def reset(self) -> None:
        with self._mu:
            self._vars.clear()
            self._watched.clear()
            self._obj_clocks.clear()
            self.reports.clear()
            self._report_keys.clear()
            self.checks = 0
            self._published_checks = 0
            self._published_reports = 0


# ---------------------------------------------------------------------------
# Watched-class generation + tracked containers
# ---------------------------------------------------------------------------

_watched_classes: Dict[type, type] = {}


def _watched_class_for(cls: type) -> type:
    sub = _watched_classes.get(cls)
    if sub is not None:
        return sub

    def __getattribute__(self, name):
        w = _WITNESS
        if w is not None:
            entry = w._entry_for(self)
            if entry is not None and name in entry.fields:
                w.on_read(self, name)
        return cls.__getattribute__(self, name)

    def __setattr__(self, name, value):
        w = _WITNESS
        if w is not None:
            entry = w._entry_for(self)
            if entry is not None and name in entry.fields:
                w.on_write(self, name)
                # keep container tracking across rebinds (exact-type check:
                # a _Tracked* value stays as-is)
                if type(value) is dict:
                    value = _TrackedDict(self, name, value)
                elif type(value) is list:
                    value = _TrackedList(self, name, value)
        cls.__setattr__(self, name, value)

    sub = type(
        cls.__name__,
        (cls,),
        {
            "__getattribute__": __getattribute__,
            "__setattr__": __setattr__,
            "__slots__": (),
            "_race_watched_base": cls,
            "__module__": cls.__module__,
            "__qualname__": getattr(cls, "__qualname__", cls.__name__),
        },
    )
    _watched_classes[cls] = sub
    return sub


def _container_access(owner: object, field: str, write: bool) -> None:
    w = _WITNESS
    if w is None:
        return
    if write:
        w.on_write(owner, field)
    else:
        w.on_read(owner, field)


class _TrackedDict(dict):
    """dict whose element ops count as accesses of (owner, field)."""

    __slots__ = ("_race_owner", "_race_field")

    def __init__(self, owner: object, field: str, src: dict):
        super().__init__(src)
        self._race_owner = owner
        self._race_field = field

    # writes
    def __setitem__(self, k, v):
        _container_access(self._race_owner, self._race_field, True)
        dict.__setitem__(self, k, v)

    def __delitem__(self, k):
        _container_access(self._race_owner, self._race_field, True)
        dict.__delitem__(self, k)

    def pop(self, *a):
        _container_access(self._race_owner, self._race_field, True)
        return dict.pop(self, *a)

    def popitem(self):
        _container_access(self._race_owner, self._race_field, True)
        return dict.popitem(self)

    def clear(self):
        _container_access(self._race_owner, self._race_field, True)
        dict.clear(self)

    def update(self, *a, **k):
        _container_access(self._race_owner, self._race_field, True)
        dict.update(self, *a, **k)

    def setdefault(self, *a):
        _container_access(self._race_owner, self._race_field, True)
        return dict.setdefault(self, *a)

    # reads
    def __getitem__(self, k):
        _container_access(self._race_owner, self._race_field, False)
        return dict.__getitem__(self, k)

    def get(self, *a):
        _container_access(self._race_owner, self._race_field, False)
        return dict.get(self, *a)

    def __contains__(self, k):
        _container_access(self._race_owner, self._race_field, False)
        return dict.__contains__(self, k)

    def __iter__(self):
        _container_access(self._race_owner, self._race_field, False)
        return dict.__iter__(self)

    def __len__(self):
        _container_access(self._race_owner, self._race_field, False)
        return dict.__len__(self)

    def keys(self):
        _container_access(self._race_owner, self._race_field, False)
        return dict.keys(self)

    def values(self):
        _container_access(self._race_owner, self._race_field, False)
        return dict.values(self)

    def items(self):
        _container_access(self._race_owner, self._race_field, False)
        return dict.items(self)


class _TrackedList(list):
    """list whose element ops count as accesses of (owner, field)."""

    __slots__ = ("_race_owner", "_race_field")

    def __init__(self, owner: object, field: str, src: list):
        super().__init__(src)
        self._race_owner = owner
        self._race_field = field

    # writes
    def append(self, v):
        _container_access(self._race_owner, self._race_field, True)
        list.append(self, v)

    def extend(self, it):
        _container_access(self._race_owner, self._race_field, True)
        list.extend(self, it)

    def insert(self, i, v):
        _container_access(self._race_owner, self._race_field, True)
        list.insert(self, i, v)

    def remove(self, v):
        _container_access(self._race_owner, self._race_field, True)
        list.remove(self, v)

    def pop(self, *a):
        _container_access(self._race_owner, self._race_field, True)
        return list.pop(self, *a)

    def clear(self):
        _container_access(self._race_owner, self._race_field, True)
        list.clear(self)

    def sort(self, **k):
        _container_access(self._race_owner, self._race_field, True)
        list.sort(self, **k)

    def reverse(self):
        _container_access(self._race_owner, self._race_field, True)
        list.reverse(self)

    def __setitem__(self, i, v):
        _container_access(self._race_owner, self._race_field, True)
        list.__setitem__(self, i, v)

    def __delitem__(self, i):
        _container_access(self._race_owner, self._race_field, True)
        list.__delitem__(self, i)

    def __iadd__(self, it):
        _container_access(self._race_owner, self._race_field, True)
        list.extend(self, it)
        return self

    # reads
    def __getitem__(self, i):
        _container_access(self._race_owner, self._race_field, False)
        return list.__getitem__(self, i)

    def __iter__(self):
        _container_access(self._race_owner, self._race_field, False)
        return list.__iter__(self)

    def __len__(self):
        _container_access(self._race_owner, self._race_field, False)
        return list.__len__(self)

    def __contains__(self, v):
        _container_access(self._race_owner, self._race_field, False)
        return list.__contains__(self, v)

    def index(self, *a):
        _container_access(self._race_owner, self._race_field, False)
        return list.index(self, *a)

    def count(self, v):
        _container_access(self._race_owner, self._race_field, False)
        return list.count(self, v)


# ---------------------------------------------------------------------------
# Public watch API (the port's call sites go through this)
# ---------------------------------------------------------------------------


def watch_shared(obj, fields):
    """Register ``obj``'s named fields for race checking. With the witness
    off this returns ``obj`` untouched at the cost of one global read: the
    port's constructors call it unconditionally."""
    w = _WITNESS
    if w is None:
        return obj
    return w.watch(obj, tuple(fields))


def active_witness() -> Optional[RaceWitness]:
    return _WITNESS


# ---------------------------------------------------------------------------
# Installation: sync-listener + Thread/queue/Future/executor patches
# ---------------------------------------------------------------------------


class _Patches:
    def __init__(self) -> None:
        self.thread_start = threading.Thread.start
        self.thread_join = threading.Thread.join
        self.queue_put = _queue_mod.Queue.put
        self.queue_get = _queue_mod.Queue.get
        self.fut_set_result = Future.set_result
        self.fut_set_exception = Future.set_exception
        self.fut_result = Future.result
        self.tpe_submit = ThreadPoolExecutor.submit


_patches: Optional[_Patches] = None
_installed_lockwitness = False


def _patched_thread_start(self):
    w = _WITNESS
    if w is not None:
        self._race_fork = w.fork()
        orig_run = self.run

        def _race_run():
            try:
                orig_run()
            finally:
                w2 = _WITNESS
                if w2 is not None:
                    # final-clock snapshot for the join edge
                    self._race_final = w2.fork()

        self.run = _race_run
    return _patches.thread_start(self)


def _patched_thread_join(self, timeout=None):
    r = _patches.thread_join(self, timeout)
    w = _WITNESS
    if w is not None and not self.is_alive():
        final = getattr(self, "_race_final", None)
        if final:
            w.adopt_fork(final)
    return r


def _patched_queue_put(self, item, *args, **kwargs):
    w = _WITNESS
    if w is not None:
        w.on_release(self)
    return _patches.queue_put(self, item, *args, **kwargs)


def _patched_queue_get(self, *args, **kwargs):
    item = _patches.queue_get(self, *args, **kwargs)
    w = _WITNESS
    if w is not None:
        w.on_acquire(self)
    return item


def _patched_fut_set_result(self, result):
    w = _WITNESS
    if w is not None:
        w.on_release(self)
    return _patches.fut_set_result(self, result)


def _patched_fut_set_exception(self, exc):
    w = _WITNESS
    if w is not None:
        w.on_release(self)
    return _patches.fut_set_exception(self, exc)


def _patched_fut_result(self, timeout=None):
    r = _patches.fut_result(self, timeout)
    w = _WITNESS
    if w is not None:
        w.on_acquire(self)
    return r


def _patched_tpe_submit(self, fn, /, *args, **kwargs):
    w = _WITNESS
    if w is not None:
        fn = w.fork_wrap(fn)
    return _patches.tpe_submit(self, fn, *args, **kwargs)


def install() -> RaceWitness:
    """Activate the race witness. Installs the lock witness too (it owns
    the lock/Condition/Event/Barrier interposition the clocks ride on) with
    the whole repository as its watch scope, so sync objects built by tests
    and scripts order their accesses like the port's own. Idempotent."""
    global _WITNESS, _patches, _installed_lockwitness
    if _WITNESS is not None:
        return _WITNESS
    lw = _lockwitness()
    _installed_lockwitness = lw.active_witness() is None
    lw.install((_REPO_ROOT,))
    w = RaceWitness()
    lw.set_sync_listener(w)
    _patches = _Patches()
    threading.Thread.start = _patched_thread_start  # type: ignore[method-assign]
    threading.Thread.join = _patched_thread_join  # type: ignore[method-assign]
    _queue_mod.Queue.put = _patched_queue_put  # type: ignore[method-assign]
    _queue_mod.Queue.get = _patched_queue_get  # type: ignore[method-assign]
    Future.set_result = _patched_fut_set_result  # type: ignore[method-assign]
    Future.set_exception = _patched_fut_set_exception  # type: ignore[method-assign]
    Future.result = _patched_fut_result  # type: ignore[method-assign]
    ThreadPoolExecutor.submit = _patched_tpe_submit  # type: ignore[method-assign]
    _WITNESS = w
    return w


def uninstall() -> None:
    global _WITNESS, _patches, _installed_lockwitness
    if _WITNESS is None:
        return
    lw = _lockwitness()
    lw.set_sync_listener(None)
    if _installed_lockwitness:
        lw.uninstall()
    p = _patches
    threading.Thread.start = p.thread_start  # type: ignore[method-assign]
    threading.Thread.join = p.thread_join  # type: ignore[method-assign]
    _queue_mod.Queue.put = p.queue_put  # type: ignore[method-assign]
    _queue_mod.Queue.get = p.queue_get  # type: ignore[method-assign]
    Future.set_result = p.fut_set_result  # type: ignore[method-assign]
    Future.set_exception = p.fut_set_exception  # type: ignore[method-assign]
    Future.result = p.fut_result  # type: ignore[method-assign]
    ThreadPoolExecutor.submit = p.tpe_submit  # type: ignore[method-assign]
    _patches = None
    _installed_lockwitness = False
    _WITNESS = None


class watching:
    """Context manager: install on enter, uninstall on exit (unless an
    env-level install outlives the block), expose the witness."""

    def __init__(self) -> None:
        self.witness: Optional[RaceWitness] = None
        self._preinstalled = False

    def __enter__(self) -> RaceWitness:
        self._preinstalled = _WITNESS is not None
        self.witness = install()
        return self.witness

    def __exit__(self, *exc) -> None:
        if not self._preinstalled:
            uninstall()


class quarantine:
    """Context manager for code that provokes races on purpose (the
    revert-mutation checks): snapshot the installed witness's verdict state
    on enter and restore it on exit, so reports produced inside the block
    never leak into the surrounding run's ``assert_clean``. Without an
    installed witness it installs a fresh one for the block and uninstalls
    it afterwards; either way the block observes a live witness and the
    surrounding run's verdict is untouched.

    ``new_reports()`` returns only the reports produced inside the block."""

    def __init__(self) -> None:
        self.witness: Optional[RaceWitness] = None
        self._preinstalled = False
        self._snap: Optional[tuple] = None

    def __enter__(self) -> "quarantine":
        self._preinstalled = _WITNESS is not None
        w = install()
        self.witness = w
        with w._mu:
            self._snap = (
                w.checks,
                list(w.reports),
                set(w._report_keys),
                w._published_checks,
                w._published_reports,
            )
        return self

    def new_reports(self) -> List[str]:
        """Reports recorded since the block was entered."""
        assert self.witness is not None and self._snap is not None
        base = len(self._snap[1])
        with self.witness._mu:
            return list(self.witness.reports[base:])

    def __exit__(self, *exc) -> None:
        w = self.witness
        assert w is not None and self._snap is not None
        if self._preinstalled:
            checks, reports, keys, pub_checks, pub_reports = self._snap
            with w._mu:
                w.checks = checks
                w.reports[:] = reports
                w._report_keys.clear()
                w._report_keys.update(keys)
                w._published_checks = pub_checks
                w._published_reports = pub_reports
        else:
            uninstall()


def install_from_env() -> Optional[RaceWitness]:
    """Install iff ``S3SHUFFLE_RACE_WITNESS`` is set truthy (``0`` /
    ``false`` / ``no`` / ``off`` disable)."""
    value = os.environ.get("S3SHUFFLE_RACE_WITNESS", "").strip().lower()
    if value and value not in ("0", "false", "no", "off"):
        return install()
    return None


def publish_metrics(witness: Optional[RaceWitness] = None) -> None:
    """Fold the witness's check/report tallies into the package metric
    registry (``race_witness_checks_total`` / ``race_witness_reports_total``)
    as deltas since the last publish. Lazy import: this module stays
    stdlib-only at import time; best-effort if the registry is unavailable
    (standalone spec-loaded use)."""
    w = witness if witness is not None else _WITNESS
    if w is None:
        return
    try:
        from s3shuffle_tpu_torch.metrics import registry as _metrics
    except Exception:
        logging.getLogger(__name__).debug(
            "race witness metrics not published: package registry "
            "unavailable in this (standalone spec-loaded) context",
            exc_info=True,
        )
        return
    checks = _metrics.REGISTRY.counter(
        "race_witness_checks_total",
        "Happens-before access checks performed by the race witness",
    )
    reports = _metrics.REGISTRY.counter(
        "race_witness_reports_total",
        "Unsynchronized access pairs reported by the race witness",
    )
    with w._mu:
        d_checks = w.checks - w._published_checks
        d_reports = len(w.reports) - w._published_reports
        w._published_checks = w.checks
        w._published_reports = len(w.reports)
    if d_checks:
        checks.inc(d_checks)
    if d_reports:
        reports.inc(d_reports)
