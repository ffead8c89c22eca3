"""Runtime protocol witness of the port (the JAX package's
``utils/protowitness.py``): the commit protocol and the seal barrier,
checked while they run.

Two invariants:

- **commit order**: a unit's index (or fat-index) PUT is its commit
  point. When it completes, every other write stream of the unit (data,
  parity, checksum) must be closed, and no later non-index create of the
  unit may follow (an index re-PUT is allowed: the sidecars are idempotent
  by overwrite and the retry layer re-drives them whole). A unit is one
  per-map output ``(shuffle, map)`` or one composite group ``(shuffle,
  group)``;
- **the seal barrier**: a reduce read of a shuffle must never start while
  one of its composite groups is committed (fat index landed) but its
  members are not yet registered with the tracker. A read inside that
  window misses the unregistered members' records without an error.

:func:`wrap` interposes on one manager's storage backend and tracker.
Every store PUT, GET, rename and delete is classified by the object-name
grammar of :mod:`s3shuffle_tpu_torch.block_ids` (names are wire surface)
into per-unit events; each fat index is decoded as its bytes stream
through the PUT, so the witness knows every committed group's members.
Violations are recorded, logged at ERROR and flight-recorded
(``witness.violation``, then a flight dump);
:meth:`ProtocolWitness.assert_clean` raises. Nothing is patched
globally: wrapping is per manager.

Opt-in: ``S3SHUFFLE_PROTOCOL_WITNESS=1`` makes every ``ShuffleManager``
wrap itself at construction (:func:`maybe_install`), and a worker started
through ``worker.main`` checks its witnesses before it exits 0. Scoped::

    with protowitness.watching(ctx.manager) as w:
        ... run a workload ...
    # wrapping is undone; w.violations holds anything caught

Off, it costs one environment read per manager construction.
"""

from __future__ import annotations

import collections
import io
import logging
import os
import threading
from typing import Dict, List, Optional, Set, Tuple

from s3shuffle_tpu_torch.block_ids import (
    parse_composite_name,
    parse_index_name,
    parse_shuffle_object_name,
)

logger = logging.getLogger("s3shuffle_tpu_torch.protowitness")

#: a commit unit: ("map", shuffle_id, map_id) or ("comp", shuffle_id, group_id)
Unit = Tuple[str, int, int]


class ProtocolViolationError(AssertionError):
    """Raised by :meth:`ProtocolWitness.assert_clean` when the run broke a
    commit-protocol invariant."""


def classify(path: str) -> Optional[Tuple[str, Unit]]:
    """``(kind, unit)`` of one store object path, or None for non-shuffle
    objects (snapshots, tombstones, temp files). Kinds: ``data`` /
    ``index`` / ``checksum`` / ``parity``; composite fat indexes classify
    as ``index`` of a ``comp`` unit — the commit point either way."""
    name = path.rsplit("/", 1)[-1]
    comp = parse_composite_name(name)
    if comp is not None:
        sid, gid, kind = comp
        return (
            "index" if kind == "cindex" else kind,
            ("comp", sid, gid),
        )
    if parse_index_name(name) is not None:
        idx = parse_index_name(name)
        return "index", ("map", idx.shuffle_id, idx.map_id)
    per_map = parse_shuffle_object_name(name)
    if per_map is None:
        return None
    sid, mid = per_map
    if name.endswith(".data"):
        kind = "data"
    elif ".checksum." in name:
        kind = "checksum"
    elif name.endswith(".parity"):
        kind = "parity"
    else:  # .index matched above; anything else is outside the grammar
        return None
    return kind, ("map", sid, mid)


class _UnitState:
    __slots__ = ("open_streams", "committed")

    def __init__(self) -> None:
        #: path -> kind of every write stream created but not yet closed
        self.open_streams: Dict[str, str] = {}
        self.committed = False


class ProtocolWitness:
    """Event recorder + invariant checker shared by the wrapped backend and
    tracker of one manager. Thread-safe (one lock; every check is O(small))."""

    def __init__(self, check_seal_barrier: bool = True) -> None:
        self._mu = threading.Lock()
        self.violations: List[str] = []
        self._units: Dict[Unit, _UnitState] = {}
        #: the seal barrier is an IN-PROCESS contract (commit and
        #: registration flow through the same manager). A worker whose
        #: tracker is a remote proxy registers via the coordinator's
        #: completion RPC — invisible here — so membership checking would
        #: be pure false positives; wrap() disables it for those managers
        #: and keeps commit-op ordering, which is backend-local and sound.
        self.check_seal_barrier = check_seal_barrier
        #: (shuffle_id, map_id) pairs the tracker has accepted
        self._registered: Set[Tuple[int, int]] = set()
        #: committed composite group -> member map_ids not yet registered.
        #: Non-empty entries are the seal-barrier window: a read of the
        #: shuffle during one is the composite record-loss race.
        self._pending_groups: Dict[Tuple[int, int], Set[int]] = {}

    # -- internals -----------------------------------------------------
    def _violate(self, msg: str) -> None:
        logger.error("protocol witness: %s", msg)
        self.violations.append(msg)
        # a witness violation is exactly the moment the flight recorder
        # exists for: the ring holds the ops that led here, and the state
        # that produced the breach is about to be torn down by the caller or
        # the failing job. Best-effort — the witness must stay usable even
        # if the trace plane is broken.
        try:
            from s3shuffle_tpu_torch.utils import trace as _trace

            _trace.flight_record("witness.violation", "i", message=msg)
            _trace.flight_note_error()
            _trace.flight_dump("witness_violation")
        except Exception:  # pragma: no cover - trace plane must never veto
            logger.debug("flight dump on witness violation failed", exc_info=True)

    def _state(self, unit: Unit) -> _UnitState:
        state = self._units.get(unit)
        if state is None:
            state = self._units[unit] = _UnitState()
        return state

    # -- storage events (called by WitnessedBackend) -------------------
    def note_create(self, path: str) -> bool:
        """A write stream opened for ``path``. Returns True when the close
        event should capture the written bytes (fat indexes — the witness
        decodes them to learn group membership)."""
        cls = classify(path)
        if cls is None:
            return False
        kind, unit = cls
        with self._mu:
            state = self._state(unit)
            if state.committed and kind != "index":
                self._violate(
                    f"{kind} PUT of {path} AFTER the commit point of "
                    f"{unit[0]} unit shuffle={unit[1]} id={unit[2]} — the "
                    "index write must be the LAST store op of a commit"
                )
            state.open_streams[path] = kind
        return kind == "index" and unit[0] == "comp"

    def note_close(self, path: str, data: Optional[bytes] = None) -> None:
        """A write stream for ``path`` closed successfully (the object is
        now visible). ``data`` carries the written bytes for fat indexes."""
        cls = classify(path)
        if cls is None:
            return
        kind, unit = cls
        with self._mu:
            state = self._state(unit)
            state.open_streams.pop(path, None)
            if kind != "index":
                return
            for open_path, open_kind in state.open_streams.items():
                self._violate(
                    f"index PUT {path} completed while {open_kind} stream "
                    f"{open_path} of the same commit was still open — "
                    "parity/checksum/data must all land BEFORE the commit "
                    "point"
                )
            state.committed = True
            if unit[0] == "comp" and data is not None:
                self._note_group_committed(unit[1], unit[2], data)

    def _note_group_committed(self, sid: int, gid: int, blob: bytes) -> None:
        """Decode the fat index (mu held) to learn the group's members; any
        not yet registered open the seal-barrier window."""
        if not self.check_seal_barrier:
            return
        try:
            from s3shuffle_tpu_torch.metadata.fat_index import FatIndex

            members = FatIndex.from_bytes(blob).members
        except Exception:
            logger.warning(
                "protocol witness could not decode fat index for shuffle %d "
                "group %d; membership check skipped", sid, gid, exc_info=True,
            )
            return
        missing = {
            mid for mid in members if (sid, mid) not in self._registered
        }
        if missing:
            self._pending_groups[(sid, gid)] = missing
        else:
            self._pending_groups.pop((sid, gid), None)

    def note_rename(self, dst: str) -> None:
        """Rename commits the destination object whole (the single-spill
        fast path renames the local spill into the data object slot)."""
        self.note_create(dst)
        self.note_close(dst)

    def note_read(self, path: str) -> None:
        """A GET (ranged open / read_all) of a store object. If any
        committed composite group of the same shuffle still has
        unregistered members, this read raced the seal barrier."""
        cls = classify(path)
        if cls is None:
            return
        _kind, unit = cls
        self._check_seal_barrier(unit[1], f"store read of {path}")

    def note_lookup(self, shuffle_id: int) -> None:
        """A reduce-side map-output enumeration on the tracker. This is
        where the record-loss race actually manifests: a lookup inside the
        seal-barrier window silently misses the unregistered members, so
        the reduce reads NOTHING of theirs — no store GET ever happens for
        the lost records."""
        self._check_seal_barrier(
            int(shuffle_id), f"map-output lookup for shuffle {shuffle_id}"
        )

    def _check_seal_barrier(self, sid: int, what: str) -> None:
        if not self.check_seal_barrier:
            return
        with self._mu:
            for (g_sid, gid), missing in self._pending_groups.items():
                if g_sid == sid and missing:
                    self._violate(
                        f"{what} before composite group {gid} "
                        f"(shuffle {sid}) registered members "
                        f"{sorted(missing)} — the commit barrier must drain "
                        "in-flight seals before any reduce read "
                        "(seal-barrier breach, the composite record-loss "
                        "race)"
                    )

    def note_delete(self, path: str) -> None:
        """Objects may be deleted at any point (aborts, loss injection,
        lifecycle sweeps) — deletion only clears write-stream bookkeeping."""
        cls = classify(path)
        if cls is None:
            return
        _kind, unit = cls
        with self._mu:
            state = self._units.get(unit)
            if state is not None:
                state.open_streams.pop(path, None)

    # -- tracker events (called by WitnessedTracker) -------------------
    def note_registered(self, shuffle_id: int, map_ids) -> None:
        with self._mu:
            for mid in map_ids:
                self._registered.add((int(shuffle_id), int(mid)))
            for key in list(self._pending_groups):
                if key[0] == int(shuffle_id):
                    self._pending_groups[key] -= set(int(m) for m in map_ids)
                    if not self._pending_groups[key]:
                        del self._pending_groups[key]

    def note_unregister_shuffle(self, shuffle_id: int) -> None:
        sid = int(shuffle_id)
        with self._mu:
            self._units = {
                u: s for u, s in self._units.items() if u[1] != sid
            }
            self._registered = {
                (s, m) for (s, m) in self._registered if s != sid
            }
            for key in list(self._pending_groups):
                if key[0] == sid:
                    del self._pending_groups[key]

    # -- reporting -----------------------------------------------------
    def assert_clean(self) -> None:
        if self.violations:
            raise ProtocolViolationError(
                f"protocol witness caught {len(self.violations)} "
                "violation(s):\n  " + "\n  ".join(self.violations)
            )


class _WitnessedWriteStream:
    """Write-stream wrapper: reports a successful close (with the bytes,
    when the witness asked to capture them) to the witness. Deliberately
    NOT an io.RawIOBase subclass — the base class shadows seek/tell with
    raising defaults, and the writers use tell() to record index offsets;
    everything but write/close must reach the inner stream untouched."""

    def __init__(self, inner, witness: ProtocolWitness, path: str, capture: bool):
        self._inner = inner
        self._witness = witness
        self._path = path
        self._buf = io.BytesIO() if capture else None
        self._closed = False

    @property
    def closed(self) -> bool:
        return self._closed

    def write(self, b) -> int:
        n = self._inner.write(b)
        if self._buf is not None:
            self._buf.write(b)
        return n

    def close(self) -> None:
        if self._closed:
            return
        self._inner.close()
        self._closed = True
        # only a SUCCESSFUL close makes the object visible — a raising
        # close (pipelined-upload failure) leaves the stream "open" in the
        # witness, and the writer's abort-path delete clears it
        self._witness.note_close(
            self._path, self._buf.getvalue() if self._buf is not None else None
        )

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __getattr__(self, name):
        return getattr(self._inner, name)


class WitnessedBackend:
    """StorageBackend interposer: classifies every op for the witness and
    delegates everything (including attributes like ``scheme`` and
    ``supports_rename``) to the wrapped backend."""

    def __init__(self, inner, witness: ProtocolWitness):
        self._inner = inner
        self._witness = witness

    def create(self, path: str):
        capture = self._witness.note_create(path)
        try:
            stream = self._inner.create(path)
        except Exception:
            # the object never opened: clear the open-stream entry so a
            # retried create does not look like a double PUT
            self._witness.note_delete(path)
            raise
        return _WitnessedWriteStream(stream, self._witness, path, capture)

    def open_ranged(self, path: str, size_hint=None):
        self._witness.note_read(path)
        return self._inner.open_ranged(path, size_hint)

    def read_all(self, path: str) -> bytes:
        self._witness.note_read(path)
        return self._inner.read_all(path)

    def rename(self, src: str, dst: str) -> bool:
        ok = self._inner.rename(src, dst)
        if ok:
            self._witness.note_rename(dst)
        return ok

    def delete(self, path: str) -> None:
        self._inner.delete(path)
        self._witness.note_delete(path)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class WitnessedTracker:
    """Tracker interposer: reports accepted registrations to the witness
    AFTER the wrapped call returns (a refused registration registers
    nothing), and forwards everything else untouched."""

    def __init__(self, inner, witness: ProtocolWitness):
        self._inner = inner
        self._witness = witness

    def register_map_output(self, shuffle_id: int, status) -> None:
        self._inner.register_map_output(shuffle_id, status)
        self._witness.note_registered(shuffle_id, [status.map_id])

    def register_map_outputs(self, shuffle_id: int, statuses) -> None:
        self._inner.register_map_outputs(shuffle_id, statuses)
        self._witness.note_registered(
            shuffle_id, [s.map_id for s in statuses]
        )

    def get_map_sizes_by_range(self, shuffle_id: int, *args, **kwargs):
        self._witness.note_lookup(shuffle_id)
        return self._inner.get_map_sizes_by_range(shuffle_id, *args, **kwargs)

    def get_map_sizes_by_ranges(self, shuffle_id: int, *args, **kwargs):
        self._witness.note_lookup(shuffle_id)
        return self._inner.get_map_sizes_by_ranges(shuffle_id, *args, **kwargs)

    def unregister_shuffle(self, shuffle_id: int) -> None:
        self._inner.unregister_shuffle(shuffle_id)
        self._witness.note_unregister_shuffle(shuffle_id)

    def __getattr__(self, name):
        return getattr(self._inner, name)


# ---------------------------------------------------------------------------
# Installation
# ---------------------------------------------------------------------------


def wrap(manager) -> ProtocolWitness:
    """Interpose a fresh witness on one manager's storage backend and
    tracker. Wrap LAST — above the retry and instrumented layers and any
    fault layer a caller stacked — so the witness sees the ops the port
    actually issues. The manager's dispatcher is ``Dispatcher.get(config)``,
    shared by equal configs: its backend is wrapped in place.

    Membership (seal-barrier) checking needs the full registration stream,
    which only the in-process authoritative tracker carries
    (``deduped_statuses`` is its distinguishing surface). A worker whose
    tracker proxies a remote coordinator registers via the completion RPC —
    invisible to this wrapper — so there only commit-op ordering is
    checked."""
    witness = ProtocolWitness(
        check_seal_barrier=hasattr(manager.tracker, "deduped_statuses")
    )
    manager.dispatcher.backend = WitnessedBackend(
        manager.dispatcher.backend, witness
    )
    manager.tracker = WitnessedTracker(manager.tracker, witness)
    return witness


class watching:
    """Context manager: wrap on enter, restore the original backend and
    tracker on exit, expose the witness (``violations`` stays readable
    after exit)."""

    def __init__(self, manager):
        self._manager = manager
        self.witness: Optional[ProtocolWitness] = None
        self._saved_backend = None
        self._saved_tracker = None

    def __enter__(self) -> ProtocolWitness:
        self._saved_backend = self._manager.dispatcher.backend
        self._saved_tracker = self._manager.tracker
        self.witness = wrap(self._manager)
        return self.witness

    def __exit__(self, *exc) -> None:
        self._manager.dispatcher.backend = self._saved_backend
        self._manager.tracker = self._saved_tracker


#: witnesses installed via the env var, in install order — a worker's
#: ``main`` (and a caller's teardown) drains this to assert that every
#: manager it constructed, including ones built inside the agent, ran clean.
#: Bounded: a long-lived process running with the env var set constructs
#: managers indefinitely and only an exit drains, so
#: without a cap every witness (and its per-unit state) would be pinned
#: for the process lifetime. Oldest entries fall off; each manager still
#: holds ITS witness via ``manager.protocol_witness`` regardless.
_INSTALLED_MAX = 64
_installed: "collections.deque" = collections.deque(maxlen=_INSTALLED_MAX)


def maybe_install(manager) -> Optional[ProtocolWitness]:
    """Wrap iff ``S3SHUFFLE_PROTOCOL_WITNESS`` is set truthy (``0`` /
    ``false`` / ``off`` disable, like every other boolean knob). Called by
    ShuffleManager at construction; costs one env read when off."""
    value = os.environ.get("S3SHUFFLE_PROTOCOL_WITNESS", "").strip().lower()
    if value and value not in ("0", "false", "no", "off"):
        witness = wrap(manager)
        _installed.append(witness)
        return witness
    return None


def drain_installed() -> List[ProtocolWitness]:
    """Pop and return every env-var-installed witness (a clean exit
    checks them: ``for w in drain_installed(): w.assert_clean()``)."""
    out = list(_installed)
    _installed.clear()
    return out
