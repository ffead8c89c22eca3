"""Networked map-output metadata service (the JAX package's
``metadata/service.py``): the distributed control plane.

Parity: the reference's control plane is the Spark driver's RPC endpoint:
``MapOutputTracker.getMapSizesByExecutorId`` answers the block-enumeration
RPCs of reduce tasks (S3ShuffleReader.scala:169-176), and map tasks push
``MapStatus`` back with their results (S3ShuffleWriter.scala:7-21). Here a
threaded TCP server wraps a (sharded) map-output tracker, a stage/task
queue, the fleet's membership table, a span-shard store and the fleet's
telemetry, and :class:`RemoteMapOutputTracker` is a client with the
tracker's interface, so managers and readers do not care whether tracking
is local or remote. A deployment runs one server on its coordinator host.

Wire protocol: length-prefixed JSON (``[u32le len][utf-8 json]``) over a
persistent connection, the JAX package's byte for byte, so a port client
talks to a JAX server and a JAX client to a port server. JSON, not pickle:
the control plane must not be a code-execution channel. The server's
``check_format`` refuses a client of another
:data:`~s3shuffle_tpu_torch.version.SHUFFLE_FORMAT_VERSION`.
"""

from __future__ import annotations

import base64
import json
import logging
import random
import socket
import socketserver
import struct
import threading
import time
from typing import Any, List, Optional, Tuple

import numpy as np

from s3shuffle_tpu_torch.metadata.map_output import MapOutputTracker, MapStatus
from s3shuffle_tpu_torch.metrics import registry as _metrics
from s3shuffle_tpu_torch.utils import racewitness
from s3shuffle_tpu_torch.utils import trace as _trace

logger = logging.getLogger("s3shuffle_tpu_torch.metadata.service")

_C_RPC = _metrics.REGISTRY.counter(
    "meta_rpc_total",
    "Control-plane RPC round-trips issued by this process, by method and "
    "client shard connection",
    labelnames=("method", "shard"),
)
_C_MEMBERSHIP = _metrics.REGISTRY.counter(
    "worker_membership_events_total",
    "Fleet membership transitions recorded by the control plane "
    "(join / drain / leave / expire)",
    labelnames=("event",),
)
_C_REQUEUE = _metrics.REGISTRY.counter(
    "task_requeues_total",
    "Tasks returned to the pending queue after their attempt was "
    "invalidated, by trigger",
    labelnames=("reason",),
)
_H_DRAIN = _metrics.REGISTRY.histogram(
    "worker_drain_seconds",
    "Wall clock a departing worker spent in its graceful drain (seal + "
    "flush + deregister), as reported at deregistration",
)
_C_SHARD_BYTES = _metrics.REGISTRY.counter(
    "trace_shard_bytes_total",
    "Serialized span-shard bytes accepted into the coordinator's trace store",
)
_C_SHARD_DROPS = _metrics.REGISTRY.counter(
    "trace_shard_drops_total",
    "Span shards the coordinator's trace store refused, by reason",
    labelnames=("reason",),
)
_G_FLEET_AGE = _metrics.REGISTRY.gauge(
    "fleet_snapshot_age_seconds",
    "Seconds since each worker's last fleet-telemetry sample, refreshed "
    "whenever the fleet view is merged",
    labelnames=("worker",),
)

_LEN = struct.Struct("<I")
_MAX_FRAME = 64 << 20

#: wire-schema binding (wire/schema.py): the registration payloads; WIRE01
#: holds the field counts below against the registry
_WIRE_STRUCTS = ("rpc_register",)

# Growing a registration payload means bumping
# version.SHUFFLE_FORMAT_VERSION; older payloads keep parsing through the
# defaulted tail fields (the MIN counts below).

#: ``register_map_output`` args ``[shuffle_id, map_id, location, sizes,
#: map_index, composite_group, base_offset, parity_segments]`` — the full
#: format-4 width, and the minimum the server accepts (format 2+: a payload
#: without map_index is rejected loudly, never mis-defaulted).
REGISTER_FIELDS = 8
REGISTER_MIN_FIELDS = 5
#: batched ``register_map_outputs`` entries drop the leading shuffle_id
BATCH_ENTRY_FIELDS = 7
BATCH_ENTRY_MIN_FIELDS = 4


def stage_id_for(shuffle_id: int, phase: str) -> str:
    """Canonical stage-id convention (``shuffle<id>-<phase>``) — shared by
    the driver's stage submission and :meth:`TaskQueue.drop_shuffle`, so
    shuffle teardown can find every stage that belongs to it."""
    return f"shuffle{int(shuffle_id)}-{phase}"


_STAGE_PREFIX_OF = "shuffle{}-"


def _send_frame(sock: socket.socket, obj: Any) -> None:
    payload = json.dumps(obj).encode("utf-8")
    if len(payload) > _MAX_FRAME:
        # enforced on send too: a deterministic oversize must fail loudly,
        # not surface as a bogus connection error on the peer
        raise ValueError(f"Frame of {len(payload)} bytes exceeds {_MAX_FRAME} limit")
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_frame(sock: socket.socket) -> Optional[Any]:
    header = _recv_exact(sock, _LEN.size)
    if header is None:
        return None
    (n,) = _LEN.unpack(header)
    if n > _MAX_FRAME:
        raise IOError(f"Frame of {n} bytes exceeds limit")
    payload = _recv_exact(sock, n)
    if payload is None:
        raise IOError("Connection closed mid-frame")
    return json.loads(payload.decode("utf-8"))


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if not buf:
                return None  # clean close between frames
            raise IOError("Connection closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


class WorkerMembership:
    """First-class fleet membership table — the control plane's view of
    which workers exist, which are draining, and which went silent.

    Before this table, worker liveness lived only implicitly in the
    TaskQueue's heartbeat timestamps and was consulted one stage at a time.
    Membership promotes it to join / drain / leave / expire EVENTS so the
    driver can react to fleet changes (requeue a dead worker's tasks across
    every live stage, plan lost-output recovery) and operators can watch
    churn (``worker_membership_events_total{event}``).

    States: ``active`` → (``draining`` →) ``left`` on a graceful
    deregistration, or → ``expired`` when :meth:`expire_silent` finds the
    worker past the ``worker_lease_s`` silence lease. A worker that shows
    up again after leaving/expiring simply re-joins (autoscaling restarts
    reuse ids). All timestamps are ``time.monotonic()``.
    """

    #: bounded event log (ring) — enough for dashboards/tests, never a leak
    EVENTS_MAX = 1024
    #: table cap: unique-id churn (autoscaling replacements get fresh ids)
    #: leaves one departed entry per worker, so a long-lived coordinator
    #: would otherwise grow the table — and every expire_silent beat plus
    #: every q_membership payload — without bound. Past the cap, departed
    #: entries are pruned oldest-first; live workers are never pruned.
    WORKERS_MAX = 4096

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._workers: dict = {}  # worker_id -> {state, joined_at, last_seen}
        self._events: List[dict] = []
        # race witness (no-op unless installed): every RPC handler thread
        # reads and mutates the table and the event ring, under self._lock
        racewitness.watch_shared(self, ("_workers", "_events"))

    def _prune_departed(self) -> None:
        """Under the lock: drop oldest departed entries beyond the cap."""
        excess = len(self._workers) - self.WORKERS_MAX
        if excess <= 0:
            return
        departed = sorted(
            (
                w for w, e in self._workers.items()
                if e["state"] in ("left", "expired")
            ),
            key=lambda w: self._workers[w]["last_seen"],
        )
        for w in departed[:excess]:
            del self._workers[w]

    def _emit(self, worker_id: str, event: str) -> None:
        """Under the lock: record one membership transition."""
        self._events.append(
            {"worker": worker_id, "event": event, "at": time.monotonic()}
        )
        if len(self._events) > self.EVENTS_MAX:
            del self._events[: len(self._events) - self.EVENTS_MAX]
        if _metrics.enabled():
            _C_MEMBERSHIP.labels(event=event).inc()

    def observe(self, worker_id: str) -> None:
        """A liveness signal (poll/heartbeat/explicit registration): joins
        unknown or previously departed workers, refreshes the lease of
        known ones. Draining workers stay draining — a drain request is
        sticky until the worker deregisters."""
        now = time.monotonic()
        with self._lock:
            entry = self._workers.get(worker_id)
            if entry is None or entry["state"] in ("left", "expired"):
                self._workers[worker_id] = {
                    "state": "active", "joined_at": now, "last_seen": now,
                }
                self._emit(worker_id, "join")
                self._prune_departed()
            else:
                entry["last_seen"] = now

    def refresh(self, worker_id: str) -> None:
        """Lease refresh ONLY — a heartbeat proves an existing member is
        alive but must never resurrect one that already left or expired:
        a drained worker's last in-flight heartbeat can land AFTER its
        deregistration, and re-joining it would strand a phantom 'active'
        entry until the lease reaps it (spurious join+expire events plus a
        needless lost-output probe). Re-joins ride the active paths
        (``q_register_worker`` / ``q_take_task``) instead."""
        now = time.monotonic()
        with self._lock:
            entry = self._workers.get(worker_id)
            if entry is not None and entry["state"] in ("active", "draining"):
                entry["last_seen"] = now

    def request_drain(self, worker_id: str) -> bool:
        """Flag a worker for graceful drain: its next ``take_task`` poll
        answers ``{"action": "drain"}`` instead of a task. True iff the
        worker is live and was not already draining."""
        with self._lock:
            entry = self._workers.get(worker_id)
            if entry is None or entry["state"] != "active":
                return False
            entry["state"] = "draining"
            self._emit(worker_id, "drain")
            return True

    def is_draining(self, worker_id: str) -> bool:
        with self._lock:
            entry = self._workers.get(worker_id)
            return entry is not None and entry["state"] == "draining"

    def deregister(self, worker_id: str, drain_seconds: Optional[float] = None) -> None:
        """Graceful departure (the drain protocol's last step). The worker
        reports how long its drain took; the coordinator owns the
        histogram so fleet-wide drain latency aggregates in one place."""
        with self._lock:
            entry = self._workers.get(worker_id)
            if entry is None or entry["state"] in ("left", "expired"):
                return
            entry["state"] = "left"
            self._emit(worker_id, "leave")
        if drain_seconds is not None and _metrics.enabled():
            _H_DRAIN.observe(max(0.0, float(drain_seconds)))

    def expire_silent(self, lease_s: float) -> List[str]:
        """Expire every live worker silent past ``lease_s``; returns the
        NEWLY expired ids so the caller (the driver's fleet reap) can
        requeue their tasks and plan recovery exactly once per death."""
        now = time.monotonic()
        expired: List[str] = []
        with self._lock:
            for worker_id, entry in self._workers.items():
                if entry["state"] in ("active", "draining") and (
                    now - entry["last_seen"] > lease_s
                ):
                    entry["state"] = "expired"
                    self._emit(worker_id, "expire")
                    expired.append(worker_id)
        return expired

    def live_workers(self) -> List[str]:
        with self._lock:
            return sorted(
                w for w, e in self._workers.items()
                if e["state"] in ("active", "draining")
            )

    def state_of(self, worker_id: str) -> Optional[str]:
        with self._lock:
            entry = self._workers.get(worker_id)
            return None if entry is None else entry["state"]

    def snapshot(self) -> dict:
        """JSON-safe table + event log (the ``q_membership`` RPC)."""
        with self._lock:
            return {
                "workers": {
                    w: {"state": e["state"], "joined_at": e["joined_at"],
                        "last_seen": e["last_seen"]}
                    for w, e in self._workers.items()
                },
                "events": [dict(ev) for ev in self._events],
            }


class TaskQueue:
    """Coordinator-side stage/task queue for distributed execution.

    Tasks are JSON dicts (``{"task_id": ..., "kind": ..., ...params}``) — the
    control plane stays a data channel, never a code channel (workers dispatch
    on registered kinds). One stage at a time is typical (map barrier, then
    reduce), but multiple stages may be live.

    Failure handling: workers HEARTBEAT while alive (a worker agent runs a
    daemon heartbeat thread; take_task also counts); :meth:`reap_expired` —
    driven by the driver's stage-wait loop — re-queues running tasks whose
    worker went silent for the lease duration (process crash/kill), up to
    ``MAX_ATTEMPTS`` total attempts, after which the task is failed. A task
    that runs long on a HEALTHY worker is never reaped — liveness is the
    worker's heartbeat, not task runtime (Spark's executor-heartbeat model).
    Re-execution is safe because tasks are idempotent: map and reduce
    outputs are store objects keyed by task identity, and the index write is
    the commit point (write/map_output_writer.py) — Spark's speculative-
    execution contract. Completion/failure reports are accepted only from
    the CURRENT lease holder, so a reaped-but-alive zombie attempt can
    neither release the stage barrier early nor crash on a dropped stage.
    :meth:`requeue_lost` remains the explicit per-worker variant for callers
    that *observe* a death; it honors the same attempts cap.
    """

    #: total attempts per task before the stage is failed (first + retries)
    MAX_ATTEMPTS = 3

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._stages: dict = {}
        self._stopping = False
        self._heartbeats: dict = {}  # worker_id -> monotonic timestamp

    def submit_stage(self, stage_id: str, tasks: List[dict]) -> None:
        with self._lock:
            if stage_id in self._stages:
                raise RuntimeError(f"stage {stage_id} already submitted")
            ids = [t["task_id"] for t in tasks]
            if len(set(ids)) != len(ids):
                raise RuntimeError("duplicate task_id in stage")
            self._stages[stage_id] = {
                "pending": list(reversed(tasks)),  # pop() serves FIFO
                "running": {},  # task_id -> {worker, task, taken_at}
                "done": {},  # task_id -> result
                "done_by": {},  # task_id -> worker_id that committed it
                "failed": {},  # task_id -> error string
                "attempts": {},  # task_id -> count handed out
                "tasks": {t["task_id"]: t for t in tasks},  # for retry_failed
            }

    def heartbeat(self, worker_id: str) -> None:
        with self._lock:
            self._heartbeats[worker_id] = time.monotonic()

    def take_task(self, worker_id: str):
        with self._lock:
            self._heartbeats[worker_id] = time.monotonic()
            if self._stopping:
                return {"action": "stop"}
            for stage_id, st in self._stages.items():
                if st["pending"]:
                    task = st["pending"].pop()
                    tid = task["task_id"]
                    st["attempts"][tid] = st["attempts"].get(tid, 0) + 1
                    st["running"][tid] = {
                        "worker": worker_id,
                        "task": task,
                        "taken_at": time.monotonic(),
                    }
                    # the attempt number rides along so workers can write
                    # attempt-unique output objects (Spark-3 semantics: the
                    # shuffle mapId IS the attempt-unique task id) — a
                    # zombie attempt then cannot clobber the winner's bytes
                    return {
                        "action": "run",
                        "stage_id": stage_id,
                        "task": {**task, "_attempt": st["attempts"][tid]},
                    }
            return {"action": "wait"}

    def _holds_lease(self, stage_id: str, task_id, worker_id) -> bool:
        """Under the lock: is ``worker_id`` the current lease holder? A
        report from a reaped (zombie) attempt or for a dropped stage is
        stale and must be ignored — accepting it would release the stage
        barrier while the replacement attempt is mid-write."""
        st = self._stages.get(stage_id)
        if st is None:
            return False
        entry = st["running"].get(task_id)
        # legacy callers (worker_id None) keep the old unguarded behavior
        return entry is not None and (worker_id is None or entry["worker"] == worker_id)

    def can_commit(self, stage_id: str, task_id, worker_id: str) -> bool:
        """Commit authorization (Spark's OutputCommitCoordinator analog):
        granted only to the current lease holder, so a reaped zombie attempt
        is refused BEFORE it writes the index / output object — the commit
        point — and walks away. Combined with attempt-unique output object
        names (the worker's attempt stride; take_task attaches ``_attempt``),
        a zombie can neither commit nor clobber the winner's bytes: its
        writes land on its own attempt's paths, which no reader ever
        resolves."""
        with self._lock:
            return self._holds_lease(stage_id, task_id, worker_id)

    def complete_task(
        self, stage_id: str, task_id, result, worker_id=None, on_accept=None
    ) -> bool:
        """``on_accept`` runs UNDER the queue lock iff the report is
        accepted — side effects that must be atomic with acceptance (the
        winning attempt's MapStatus registration) go here, so a zombie whose
        report is refused can never register its outputs either."""
        with self._lock:
            if not self._holds_lease(stage_id, task_id, worker_id):
                return False  # stale attempt / dropped stage: quietly ignored
            if on_accept is not None:
                on_accept()
            st = self._stages[stage_id]
            st["running"].pop(task_id, None)
            st["done"][task_id] = result
            st["done_by"][task_id] = worker_id
            return True

    def fail_task(self, stage_id: str, task_id, error: str, worker_id=None) -> bool:
        with self._lock:
            if not self._holds_lease(stage_id, task_id, worker_id):
                return False
            st = self._stages[stage_id]
            st["running"].pop(task_id, None)
            st["failed"][task_id] = error
            return True

    def stage_status(self, stage_id: str) -> dict:
        with self._lock:
            st = self._stages[stage_id]
            return {
                "pending": len(st["pending"]),
                "running": len(st["running"]),
                "done": dict(st["done"]),
                "failed": dict(st["failed"]),
            }

    def _requeue_or_fail(self, st, tid, entry, why: str, reason: str) -> bool:
        """Under the lock: return a reaped task to pending, or fail it once
        it has exhausted MAX_ATTEMPTS. True = requeued. ``reason`` labels
        ``task_requeues_total`` — the drain protocol's zero-requeue claim
        is asserted against this counter."""
        attempts = st["attempts"].get(tid, 1)
        if attempts >= self.MAX_ATTEMPTS:
            st["failed"][tid] = (
                f"{why} after {attempts} attempts (worker {entry['worker']})"
            )
            requeued = False
        else:
            st["pending"].append(entry["task"])
            requeued = True
            if _metrics.enabled():
                _C_REQUEUE.labels(reason=reason).inc()
        logger.warning(
            "task %s %s on worker %s (attempt %d) — %s",
            tid, why, entry["worker"], attempts,
            "requeued" if requeued else "FAILED",
        )
        return requeued

    def _requeue_lost_locked(self, st, worker_id: str) -> int:
        lost = [
            tid for tid, r in st["running"].items() if r["worker"] == worker_id
        ]
        n = 0
        for tid in lost:
            entry = st["running"].pop(tid)
            if self._requeue_or_fail(
                st, tid, entry, "worker reported lost", reason="worker_lost"
            ):
                n += 1
        return n

    def requeue_lost(self, stage_id: str, worker_id: str) -> int:
        """Re-queue tasks a dead worker was running (explicit observation of
        a death). Honors the MAX_ATTEMPTS cap. Returns the count requeued."""
        with self._lock:
            return self._requeue_lost_locked(self._stages[stage_id], worker_id)

    def requeue_lost_all(self, worker_id: str) -> int:
        """Fleet-level death handling: re-queue the dead worker's in-flight
        tasks across EVERY live stage in one pass — the membership-expiry
        hook. The per-stage ``reap_expired`` only ever ran for the stage
        the driver was actively waiting on, so a worker dying while
        holding a task of any OTHER stage went undetected until that
        stage was next waited (or forever)."""
        with self._lock:
            return sum(
                self._requeue_lost_locked(st, worker_id)
                for st in self._stages.values()
            )

    def reap_expired(self, stage_id: str, lease_s: float) -> int:
        """Re-queue running tasks whose WORKER went silent for ``lease_s``
        (no heartbeat and no poll since then) — crash/kill detection, driven
        by the driver's stage-wait loop. A long task on a heartbeat-healthy
        worker is never reaped. Tasks past MAX_ATTEMPTS are failed instead.
        Returns the number re-queued."""
        now = time.monotonic()
        reaped = 0
        with self._lock:
            st = self._stages[stage_id]
            reaped = self._reap_expired_locked(st, lease_s, now)
        return reaped

    def _reap_expired_locked(self, st, lease_s: float, now: float) -> int:
        reaped = 0
        for tid in [
            t for t, r in st["running"].items()
            if now - max(
                r["taken_at"], self._heartbeats.get(r["worker"], 0.0)
            ) > lease_s
        ]:
            entry = st["running"].pop(tid)
            if self._requeue_or_fail(
                st, tid, entry, "lease expired", reason="lease_expired"
            ):
                reaped += 1
        return reaped

    def reap_expired_all(self, lease_s: float) -> int:
        """Reap silent-worker leases across EVERY live stage (the fleet-reap
        cadence fix): the driver's wait loop used to reap only the stage it
        was waiting on, so a worker dying after its last poll of some
        OTHER live stage left that stage's task running forever."""
        now = time.monotonic()
        with self._lock:
            return sum(
                self._reap_expired_locked(st, lease_s, now)
                for st in self._stages.values()
            )

    def retry_failed(self, stage_id: str, task_id, reason: str = "recovery") -> bool:
        """Move one FAILED task back to pending — the driver's recovery
        path (a reduce task that failed on a lost map output gets another
        attempt once the map is recomputed or its parity coverage is
        confirmed). Bounded by the same MAX_ATTEMPTS budget as lease
        reaping; False when the task is not failed or out of attempts."""
        with self._lock:
            st = self._stages.get(stage_id)
            if st is None or task_id not in st["failed"]:
                return False
            if st["attempts"].get(task_id, 0) >= self.MAX_ATTEMPTS:
                return False
            task = st["tasks"].get(task_id)
            if task is None:
                return False
            st["failed"].pop(task_id)
            st["pending"].append(task)
            if _metrics.enabled():
                _C_REQUEUE.labels(reason=reason).inc()
            return True

    def tasks_done_by(self, worker_id: str) -> List[Tuple[str, Any]]:
        """``(stage_id, task_id)`` of every task this worker COMMITTED —
        the recovery planner's starting point when a worker dies: these
        are the outputs that may have died with it (fallback/local
        storage modes) and need a recompute-vs-reconstruct decision."""
        with self._lock:
            return [
                (stage_id, tid)
                for stage_id, st in self._stages.items()
                for tid, w in st["done_by"].items()
                if w == worker_id
            ]

    @property
    def stopping(self) -> bool:
        with self._lock:
            return self._stopping

    def drop_stage(self, stage_id: str) -> None:
        with self._lock:
            self._stages.pop(stage_id, None)

    def drop_shuffle(self, shuffle_id: int) -> int:
        """Drop every stage belonging to one shuffle (the ``stage_id_for``
        convention) — wired into ``unregister_shuffle`` dispatch so a
        long-lived coordinator doesn't accumulate dead stage state (done/
        failed tables, attempt counters) for shuffles that no longer exist.
        Returns the number of stages dropped."""
        prefix = _STAGE_PREFIX_OF.format(int(shuffle_id))
        with self._lock:
            doomed = [s for s in self._stages if s.startswith(prefix)]
            for stage_id in doomed:
                self._stages.pop(stage_id, None)
            return len(doomed)

    def stop_workers(self) -> None:
        with self._lock:
            self._stopping = True


def merge_registry_snapshots(snapshots: List[dict]) -> dict:
    """Merge per-process metric-registry snapshots into one fleet view.

    Series identity is (metric name, label values). Counters and histogram
    buckets/sum/count ADD across processes (each process counted disjoint
    events); gauges keep the MAX (a level, not a flow — summing N workers'
    queue depths is meaningful but summing their snapshot ages is not, and
    max is the conservative read for both alerting uses). The result has the
    same shape as ``MetricRegistry.snapshot()``, so every digest renderer
    (:func:`s3shuffle_tpu_torch.costs.cost_digest`) prices a
    fleet exactly like a single process."""
    merged: dict = {}
    for snap in snapshots:
        if not isinstance(snap, dict):
            continue
        for name, metric in snap.items():
            if not isinstance(metric, dict) or "series" not in metric:
                continue
            entry = merged.get(name)
            if entry is None:
                entry = {"kind": metric.get("kind", "counter"), "_series": {}}
                if "labelnames" in metric:
                    entry["labelnames"] = list(metric["labelnames"])
                merged[name] = entry
            kind = entry["kind"]
            for series in metric["series"]:
                key = json.dumps(series.get("labels", {}), sort_keys=True)
                cur = entry["_series"].get(key)
                if cur is None:
                    # deep-copy through JSON: series came off the wire or a
                    # live registry; the merge must never alias either
                    entry["_series"][key] = json.loads(json.dumps(series))
                elif kind == "histogram":
                    cur["buckets"] = [
                        a + b
                        for a, b in zip(
                            cur.get("buckets", []), series.get("buckets", [])
                        )
                    ]
                    cur["sum"] = cur.get("sum", 0.0) + series.get("sum", 0.0)
                    cur["count"] = cur.get("count", 0) + series.get("count", 0)
                elif kind == "gauge":
                    cur["value"] = max(
                        cur.get("value", 0.0), series.get("value", 0.0)
                    )
                else:
                    cur["value"] = cur.get("value", 0.0) + series.get("value", 0.0)
    out = {}
    for name, entry in merged.items():
        final = {k: v for k, v in entry.items() if k != "_series"}
        final["series"] = list(entry["_series"].values())
        out[name] = final
    return out


class TraceShardStore:
    """Coordinator-side buffer of span shards shipped by workers.

    Workers drain their local span buffer after every task and push it here
    (``report_trace_spans``); the driver pulls everything at trace-assembly
    time (``get_trace_spans``) and merges it with its own spans into ONE
    Chrome-trace file. Byte-capped so a misbehaving fleet cannot balloon the
    coordinator: a shard that would cross the cap is refused whole (the
    worker discards it — tracing is best-effort observability, never
    backpressure on the data plane) and counted in
    ``trace_shard_drops_total{reason="capacity"}``.
    """

    #: default in-memory cap on buffered serialized span bytes
    BYTES_MAX = 64 << 20

    def __init__(self, bytes_max: int = BYTES_MAX) -> None:
        self._lock = threading.Lock()
        self._spans: List[dict] = []
        self._bytes = 0
        self.bytes_max = int(bytes_max)
        # race witness (no-op unless installed): the workers' report threads
        # and the driver's drain share the span ring and its byte count
        racewitness.watch_shared(self, ("_spans", "_bytes"))

    def report(self, spans: List[dict]) -> int:
        """Accept one shard (a list of span event dicts). Returns the count
        accepted — 0 means the shard was refused at the byte cap."""
        if not spans:
            return 0
        size = len(json.dumps(spans).encode("utf-8"))
        with self._lock:
            if self._bytes + size > self.bytes_max:
                if _metrics.enabled():
                    _C_SHARD_DROPS.labels(reason="capacity").inc()
                return 0
            self._spans.extend(spans)
            self._bytes += size
        if _metrics.enabled():
            _C_SHARD_BYTES.inc(size)
        return len(spans)

    def drain(self) -> List[dict]:
        """Return-and-clear every buffered span (driver trace assembly)."""
        with self._lock:
            out, self._spans = self._spans, []
            self._bytes = 0
        return out


class FleetTelemetry:
    """Per-worker registry snapshots merged into one fleet view.

    Each worker periodically pushes its compact metrics snapshot plus its
    local ``ObjectGetTracker`` per-key peaks (``report_fleet_sample``);
    :meth:`view` merges them — counters/histograms summed, gauges maxed,
    peaks maxed per key — and stamps ``fleet_snapshot_age_seconds{worker}``
    so staleness is itself observable. Latest-sample-wins per worker: the
    table is bounded by fleet size, not run length.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._samples: dict = {}  # worker_id -> {snapshot, peaks, received_at, wall_time}

    def report(self, worker_id: str, snapshot: dict, peaks: Optional[dict] = None) -> None:
        with self._lock:
            self._samples[str(worker_id)] = {
                "snapshot": snapshot if isinstance(snapshot, dict) else {},
                "peaks": {
                    str(k): int(v) for k, v in (peaks or {}).items()
                },
                "received_at": time.monotonic(),
                "wall_time": time.time(),
            }

    def view(self) -> dict:
        """JSON-safe fleet view: per-worker ages and peaks, the cross-worker
        OBJECT_GETS peak merge, and the merged metrics snapshot."""
        now = time.monotonic()
        with self._lock:
            samples = {w: dict(s) for w, s in self._samples.items()}
        workers = {}
        merged_peaks: dict = {}
        for worker_id in sorted(samples):
            sample = samples[worker_id]
            age = max(0.0, now - sample["received_at"])
            if _metrics.enabled():
                _G_FLEET_AGE.labels(worker=worker_id).set(age)
            workers[worker_id] = {
                "age_seconds": age,
                "wall_time": sample["wall_time"],
                "peaks": sample["peaks"],
            }
            for key, peak in sample["peaks"].items():
                merged_peaks[key] = max(merged_peaks.get(key, 0), peak)
        return {
            "workers": workers,
            "object_gets_peaks": merged_peaks,
            "metrics": merge_registry_snapshots(
                [s["snapshot"] for s in samples.values()]
            ),
        }


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        tracker: MapOutputTracker = self.server.tracker  # type: ignore[attr-defined]
        while True:
            try:
                req = _recv_frame(self.request)
            except ConnectionResetError as e:
                # a normal teardown race: a client process exited without
                # a clean close (a killed worker, a shut-down run); logged
                # at DEBUG so it stays out of the run's output
                logger.debug("metadata client disconnected: %s", e)
                return
            except (IOError, json.JSONDecodeError) as e:
                logger.warning("metadata connection error: %s", e)
                return
            if req is None:
                return
            try:
                result = self._dispatch_queue(req) if req.get("method", "").startswith("q_") \
                    else self._dispatch(tracker, req)
                resp = {"ok": True, "result": result}
            except KeyError as e:
                resp = {"ok": False, "error": str(e), "error_type": "KeyError"}
            except Exception as e:  # keep the server alive on bad requests
                resp = {"ok": False, "error": f"{type(e).__name__}: {e}", "error_type": "RuntimeError"}
            try:
                _send_frame(self.request, resp)
            except ValueError as e:  # response over the frame cap: report, don't die
                _send_frame(
                    self.request,
                    {"ok": False, "error": f"{e} (narrow the requested range)",
                     "error_type": "RuntimeError"},
                )

    def _dispatch_queue(self, req: Any):
        queue: TaskQueue = self.server.task_queue  # type: ignore[attr-defined]
        membership: WorkerMembership = self.server.membership  # type: ignore[attr-defined]
        method = req.get("method")
        a = req.get("args", [])
        if method == "q_submit_stage":
            return queue.submit_stage(str(a[0]), list(a[1]))
        if method == "q_take_task":
            worker_id = str(a[0])
            membership.observe(worker_id)
            # a drain-flagged worker gets no new work — but fleet shutdown
            # (stop_workers) still wins, so a drained-but-lingering agent
            # can never outlive the job
            if membership.is_draining(worker_id) and not queue.stopping:
                queue.heartbeat(worker_id)  # drain is liveness too
                return {"action": "drain"}
            return queue.take_task(worker_id)
        if method == "q_complete_task":
            w = a[3] if len(a) > 3 and a[3] is not None else None
            on_accept = None
            if len(a) > 4 and a[4] is not None:
                # map-output registration rides the completion atomically:
                # accepted ⇒ registered; refused (zombie) ⇒ never registered
                if len(a[4]) < REGISTER_MIN_FIELDS:
                    # pre-format-2 client: its strided map_ids would default
                    # map_index wrong and silently mis-filter range reads —
                    # the exact failure SHUFFLE_FORMAT_VERSION exists to stop
                    raise RuntimeError(
                        "map_output registration without map_index: client "
                        "speaks an older shuffle format; deploy one version "
                        "per job (see version.SHUFFLE_FORMAT_VERSION)"
                    )
                m_shuffle, m_map, m_loc, m_sizes, m_idx = a[4][:5]
                m_idx = int(m_idx)
                # format-3 composite coordinates; older payloads default to
                # the classic one-object-per-map layout. format-4 appends
                # the coded plane's parity-segment count (default uncoded).
                m_group = int(a[4][5]) if len(a[4]) > 5 else -1
                m_base = int(a[4][6]) if len(a[4]) > 6 else 0
                m_parity = int(a[4][7]) if len(a[4]) >= REGISTER_FIELDS else 0
                tracker = self.server.tracker  # type: ignore[attr-defined]
                status = MapStatus(
                    map_id=int(m_map),
                    location=str(m_loc),
                    sizes=np.asarray(m_sizes, dtype=np.int64),
                    map_index=m_idx,
                    composite_group=m_group,
                    base_offset=m_base,
                    parity_segments=m_parity,
                )

                def on_accept(s=status, sid=int(m_shuffle), t=tracker):
                    t.register_map_output(sid, s)

            return queue.complete_task(str(a[0]), a[1], a[2], w, on_accept)
        if method == "q_fail_task":
            w = a[3] if len(a) > 3 and a[3] is not None else None
            return queue.fail_task(str(a[0]), a[1], str(a[2]), w)
        if method == "q_heartbeat":
            # refresh, never (re-)join: a departed worker's in-flight
            # heartbeat must not resurrect its membership entry
            membership.refresh(str(a[0]))
            return queue.heartbeat(str(a[0]))
        if method == "q_register_worker":
            # explicit join (a worker agent's start-up): the membership event
            # fires even before the first poll, so joins are observable
            membership.observe(str(a[0]))
            return queue.heartbeat(str(a[0]))
        if method == "q_request_drain":
            return membership.request_drain(str(a[0]))
        if method == "q_deregister_worker":
            drain_s = float(a[1]) if len(a) > 1 and a[1] is not None else None
            return membership.deregister(str(a[0]), drain_s)
        if method == "q_membership":
            return membership.snapshot()
        if method == "q_reap_expired_all":
            return queue.reap_expired_all(float(a[0]))
        if method == "q_retry_failed":
            reason = str(a[2]) if len(a) > 2 else "recovery"
            return queue.retry_failed(str(a[0]), a[1], reason)
        if method == "q_can_commit":
            return queue.can_commit(str(a[0]), a[1], str(a[2]))
        if method == "q_stage_status":
            return queue.stage_status(str(a[0]))
        if method == "q_drop_stage":
            return queue.drop_stage(str(a[0]))
        if method == "q_reap_expired":
            return queue.reap_expired(str(a[0]), float(a[1]))
        if method == "q_stop_workers":
            return queue.stop_workers()
        raise RuntimeError(f"Unknown method: {method}")

    def _dispatch(self, tracker: MapOutputTracker, req: Any):
        method = req.get("method")
        a = req.get("args", [])
        if method == "ping":
            return "pong"
        if method == "check_format":
            from s3shuffle_tpu_torch.version import SHUFFLE_FORMAT_VERSION

            if int(a[0]) != SHUFFLE_FORMAT_VERSION:
                raise RuntimeError(
                    f"shuffle format version mismatch: worker speaks {a[0]}, "
                    f"coordinator speaks {SHUFFLE_FORMAT_VERSION} — mixed "
                    "framework versions mis-partition silently; deploy one "
                    "version per job"
                )
            return SHUFFLE_FORMAT_VERSION
        if method == "register_shuffle":
            return tracker.register_shuffle(int(a[0]), int(a[1]))
        if method == "register_map_output":
            if len(a) < REGISTER_MIN_FIELDS:
                raise RuntimeError(
                    "register_map_output without map_index: client speaks an "
                    "older shuffle format; deploy one version per job "
                    "(see version.SHUFFLE_FORMAT_VERSION)"
                )
            shuffle_id, map_id, location, sizes, map_index = a[:5]
            status = MapStatus(
                map_id=int(map_id),
                location=str(location),
                sizes=np.asarray(sizes, dtype=np.int64),
                map_index=int(map_index),
                composite_group=int(a[5]) if len(a) > 5 else -1,
                base_offset=int(a[6]) if len(a) > 6 else 0,
                parity_segments=int(a[7]) if len(a) > 7 else 0,
            )
            return tracker.register_map_output(int(shuffle_id), status)
        if method == "register_map_outputs":
            # batched form: ONE RPC for a whole commit's outputs. Every entry
            # must carry map_index (format-2) — same contract as the single
            # registration path.
            shuffle_id, entries = int(a[0]), list(a[1])
            statuses = []
            for entry in entries:
                if len(entry) < BATCH_ENTRY_MIN_FIELDS:
                    raise RuntimeError(
                        "register_map_outputs entry without map_index: client "
                        "speaks an older shuffle format; deploy one version "
                        "per job (see version.SHUFFLE_FORMAT_VERSION)"
                    )
                map_id, location, sizes, map_index = entry[:4]
                statuses.append(
                    MapStatus(
                        map_id=int(map_id),
                        location=str(location),
                        sizes=np.asarray(sizes, dtype=np.int64),
                        map_index=int(map_index),
                        composite_group=int(entry[4]) if len(entry) > 4 else -1,
                        base_offset=int(entry[5]) if len(entry) > 5 else 0,
                        parity_segments=(
                            int(entry[6]) if len(entry) >= BATCH_ENTRY_FIELDS else 0
                        ),
                    )
                )
            return tracker.register_map_outputs(shuffle_id, statuses)
        if method == "get_map_sizes_by_range":
            shuffle_id, smi, emi, sp, ep = a
            return tracker.get_map_sizes_by_range(
                int(shuffle_id), int(smi), None if emi is None else int(emi), int(sp), int(ep)
            )
        if method == "get_map_sizes_by_ranges":
            shuffle_id, smi, emi, ranges = a
            return tracker.get_map_sizes_by_ranges(
                int(shuffle_id), int(smi), None if emi is None else int(emi),
                [(int(sp), int(ep)) for sp, ep in ranges],
            )
        if method == "epoch":
            return tracker.epoch(int(a[0]))
        if method == "get_snapshot":
            return self.server.snapshots.get_wire(tracker, int(a[0]))  # type: ignore[attr-defined]
        if method == "shard_addresses":
            return [list(addr) for addr in self.server.shard_addresses]  # type: ignore[attr-defined]
        if method == "contains":
            return tracker.contains(int(a[0]))
        if method == "num_partitions":
            return tracker.num_partitions(int(a[0]))
        if method == "unregister_shuffle":
            sid = int(a[0])
            # full teardown: tracker state (which drops ShuffleStats), this
            # shuffle's dead TaskQueue stages, and any cached snapshot — a
            # long-lived coordinator session must stay bounded across
            # millions of shuffles
            queue: TaskQueue = self.server.task_queue  # type: ignore[attr-defined]
            queue.drop_shuffle(sid)
            self.server.snapshots.drop(sid)  # type: ignore[attr-defined]
            from s3shuffle_tpu_torch.metrics.stats import COLLECTOR

            COLLECTOR.drop(sid)  # idempotent with the sharded tracker's drop
            return tracker.unregister_shuffle(sid)
        if method == "registered_map_ids":
            return tracker.registered_map_ids(int(a[0]))
        if method == "composite_locations":
            return [list(row) for row in tracker.composite_locations(int(a[0]))]
        if method == "shuffle_ids":
            return tracker.shuffle_ids()
        if method == "report_task_stats":
            return tracker.report_task_stats(list(a[0]))
        if method == "get_shuffle_stats":
            return tracker.get_shuffle_stats(int(a[0]))
        if method == "report_trace_spans":
            return self.server.trace_store.report(list(a[0]))  # type: ignore[attr-defined]
        if method == "get_trace_spans":
            return self.server.trace_store.drain()  # type: ignore[attr-defined]
        if method == "report_fleet_sample":
            peaks = a[2] if len(a) > 2 else {}
            return self.server.fleet.report(str(a[0]), a[1], peaks)  # type: ignore[attr-defined]
        if method == "get_fleet_view":
            return self.server.fleet.view()  # type: ignore[attr-defined]
        raise RuntimeError(f"Unknown method: {method}")


class _Server(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


class SnapshotCache:
    """Coordinator-side cache of serialized map-output snapshots, keyed by
    (shuffle, epoch) — ``get_snapshot`` is served from here when the
    tracker's epoch hasn't moved, so N workers asking for the same sealed
    shuffle cost one serialization, not N."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._by_shuffle: dict = {}  # shuffle_id -> (epoch, bytes)

    def get_wire(self, tracker, shuffle_id: int) -> dict:
        """``{"epoch": int, "data_b64": str}`` at the tracker's CURRENT
        epoch (re-serialized only when the epoch moved)."""
        from s3shuffle_tpu_torch.metadata.snapshot import build_snapshot

        epoch = tracker.epoch(shuffle_id)
        with self._lock:
            cached = self._by_shuffle.get(shuffle_id)
            if cached is not None and cached[0] == epoch:
                data = cached[1]
            else:
                data = build_snapshot(tracker, shuffle_id).to_bytes()
                self._by_shuffle[shuffle_id] = (epoch, data)
        return {"epoch": epoch, "data_b64": base64.b64encode(data).decode("ascii")}

    def drop(self, shuffle_id: int) -> None:
        with self._lock:
            self._by_shuffle.pop(shuffle_id, None)


class MetadataServer:
    """Hosts a (sharded) map-output tracker over TCP. Start on the
    coordinator process; workers connect with
    :class:`RemoteMapOutputTracker` (or the batched
    :class:`~s3shuffle_tpu_torch.metadata.async_client.AsyncTrackerClient`).

    ``shards`` partitions the tracker keyspace across independent lock
    domains (see :mod:`s3shuffle_tpu_torch.metadata.shard`); ``shard_endpoints``
    additionally binds that many EXTRA listener sockets — each with its own
    accept loop — sharing the same tracker/queue, so clients can spread
    connections instead of queueing on one accept loop. Endpoints are
    advertised via the ``shard_addresses`` RPC. ``shards=1`` with no extra
    endpoints reproduces the pre-sharding topology exactly (a plain tracker
    is still accepted via ``tracker=``).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 tracker=None, shards: int = 4, shard_endpoints: int = 0):
        from s3shuffle_tpu_torch.metadata.shard import ShardedMapOutputTracker

        self.tracker = tracker or ShardedMapOutputTracker(max(1, int(shards)))
        self.task_queue = TaskQueue()
        self.membership = WorkerMembership()
        self.snapshots = SnapshotCache()
        self.trace_store = TraceShardStore()
        self.fleet = FleetTelemetry()
        self._server = _Server((host, port), _Handler)
        self._shard_servers = [
            _Server((host, 0), _Handler) for _ in range(max(0, int(shard_endpoints)))
        ]
        for srv in self._all_servers():
            srv.tracker = self.tracker  # type: ignore[attr-defined]
            srv.task_queue = self.task_queue  # type: ignore[attr-defined]
            srv.membership = self.membership  # type: ignore[attr-defined]
            srv.snapshots = self.snapshots  # type: ignore[attr-defined]
            srv.trace_store = self.trace_store  # type: ignore[attr-defined]
            srv.fleet = self.fleet  # type: ignore[attr-defined]
            srv.shard_addresses = []  # type: ignore[attr-defined]
        addrs = [srv.server_address[:2] for srv in self._shard_servers]
        for srv in self._all_servers():
            srv.shard_addresses = addrs  # type: ignore[attr-defined]
        self._threads: List[threading.Thread] = []

    @classmethod
    def from_config(cls, config, host: str = "127.0.0.1", port: int = 0,
                    tracker=None) -> "MetadataServer":
        """A server sized by ``config.metadata_shards`` and
        ``config.metadata_shard_endpoints``, as the JAX package's
        coordinators build theirs (``cluster.py``: ``LocalCluster``,
        ``DistributedDriver``)."""
        return cls(host=host, port=port, tracker=tracker, shards=config.metadata_shards,
                   shard_endpoints=config.metadata_shard_endpoints)

    def _all_servers(self) -> List[_Server]:
        return [self._server, *self._shard_servers]

    @property
    def address(self) -> Tuple[str, int]:
        return self._server.server_address[:2]

    @property
    def shard_addresses(self) -> List[Tuple[str, int]]:
        return [srv.server_address[:2] for srv in self._shard_servers]

    def start(self) -> "MetadataServer":
        for i, srv in enumerate(self._all_servers()):
            thread = threading.Thread(
                target=srv.serve_forever,
                name=f"s3shuffle-metadata-{i}" if i else "s3shuffle-metadata",
                daemon=True,
            )
            thread.start()
            self._threads.append(thread)
        logger.info(
            "Metadata service listening on %s:%d (+%d shard endpoints)",
            *self.address, len(self._shard_servers),
        )
        return self

    def stop(self) -> None:
        for srv in self._all_servers():
            srv.shutdown()
            srv.server_close()
        for thread in self._threads:
            thread.join(timeout=5)
        self._threads = []


class RemoteMapOutputTracker:
    """Client with MapOutputTracker's interface; safe for concurrent use
    (one socket, per-call lock, transparent reconnect).

    Transport resilience: a connection-level failure (coordinator restart,
    reset, refused) gets one FREE immediate reconnect (the legacy behavior),
    then up to ``retries`` further attempts with full-jitter exponential
    backoff bounded by ``retry_deadline_s`` — so a brief coordinator outage
    delays in-flight worker RPCs instead of failing every one of them.
    ``retries=0`` restores the legacy single-silent-reconnect behavior
    exactly. Server-REPORTED errors (``ok: false``) are never retried; the
    resend-on-reconnect idempotency contract is the same one the legacy
    reconnect already relied on."""

    def __init__(
        self,
        address: Tuple[str, int],
        timeout: float = 30.0,
        retries: int = 4,
        retry_base_ms: float = 100.0,
        retry_deadline_s: float = 10.0,
        shard_label: str = "0",
    ):
        self.address = (address[0], int(address[1]))
        self.timeout = timeout
        #: which client connection this is (``meta_rpc_total``'s shard label)
        self.shard_label = str(shard_label)
        self.retries = int(retries)
        self.retry_base_ms = float(retry_base_ms)
        self.retry_deadline_s = float(retry_deadline_s)
        # one backoff implementation for the whole framework: the storage
        # plane's RetryPolicy provides the full-jitter formula; sleep is a
        # seam so tests don't pay real backoff wall time
        from s3shuffle_tpu_torch.storage.retrying import RetryPolicy

        self._retry_policy = (
            RetryPolicy(
                retries=self.retries,
                base_ms=self.retry_base_ms,
                deadline_s=self.retry_deadline_s,
                max_backoff_s=2.0,
            )
            if self.retries > 0
            else None
        )
        self._sleep = time.sleep
        self._rng = random.Random()
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None

    # -- wire ----------------------------------------------------------
    def _connect(self) -> socket.socket:
        sock = socket.create_connection(self.address, timeout=self.timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def _call(self, method: str, *args):
        # the span is the tracker-RPC leaf of the distributed trace — a
        # shared no-op unless tracing is on (same contract as the metric)
        with _trace.span("meta.rpc", method=method):
            return self._call_inner(method, *args)

    def _call_inner(self, method: str, *args):
        if _metrics.enabled():
            _C_RPC.labels(method=method, shard=self.shard_label).inc()
        policy = self._retry_policy
        with self._lock:
            deadline = (
                time.monotonic() + policy.deadline_s
                if policy is not None and policy.deadline_s > 0
                else None
            )
            attempt = 0
            while True:
                try:
                    if self._sock is None:
                        self._sock = self._connect()
                    _send_frame(self._sock, {"method": method, "args": list(args)})
                    resp = _recv_frame(self._sock)
                    if resp is None:
                        raise IOError("Server closed connection")
                    break
                except (OSError, IOError) as e:
                    if self._sock is not None:
                        try:
                            self._sock.close()
                        except OSError:
                            pass
                        self._sock = None
                    attempt += 1
                    if attempt == 1:
                        continue  # free immediate reconnect (legacy behavior)
                    # attempt 2..retries+1 back off under the deadline
                    if policy is None or attempt > policy.retries + 1:
                        raise
                    delay = policy.backoff_s(attempt - 2, self._rng)
                    if deadline is not None and time.monotonic() + delay > deadline:
                        raise
                    logger.warning(
                        "metadata RPC %s failed (%s); retrying in %.0f ms "
                        "(attempt %d/%d)",
                        method, e, delay * 1e3, attempt, policy.retries + 1,
                    )
                    self._sleep(delay)
        if not resp["ok"]:
            if resp.get("error_type") == "KeyError":
                raise KeyError(resp["error"])
            raise RuntimeError(resp["error"])
        return resp["result"]

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None

    # -- MapOutputTracker interface ------------------------------------
    def ping(self) -> bool:
        return self._call("ping") == "pong"

    def check_format(self) -> int:
        """Raises if this client's SHUFFLE_FORMAT_VERSION differs from the
        coordinator's — called once at worker startup."""
        from s3shuffle_tpu_torch.version import SHUFFLE_FORMAT_VERSION

        return int(self._call("check_format", SHUFFLE_FORMAT_VERSION))

    def register_shuffle(self, shuffle_id: int, num_partitions: int) -> None:
        self._call("register_shuffle", shuffle_id, num_partitions)

    def register_map_output(self, shuffle_id: int, status: MapStatus) -> None:
        self._call(
            "register_map_output",
            shuffle_id,
            status.map_id,
            status.location,
            np.asarray(status.sizes).tolist(),
            status.map_index,
            status.composite_group,
            status.base_offset,
            status.parity_segments,
        )

    def register_map_outputs(self, shuffle_id: int, statuses: List[MapStatus]) -> None:
        """Batched registration: ONE RPC for a whole commit's outputs."""
        self._call(
            "register_map_outputs",
            shuffle_id,
            [
                [s.map_id, s.location, np.asarray(s.sizes).tolist(), s.map_index,
                 s.composite_group, s.base_offset, s.parity_segments]
                for s in statuses
            ],
        )

    def get_map_sizes_by_range(
        self,
        shuffle_id: int,
        start_map_index: int,
        end_map_index: Optional[int],
        start_partition: int,
        end_partition: int,
    ) -> List[Tuple[int, List[Tuple[int, int]]]]:
        raw = self._call(
            "get_map_sizes_by_range",
            shuffle_id, start_map_index, end_map_index, start_partition, end_partition,
        )
        # JSON turns tuples into lists; restore the documented shape
        return [(int(m), [(int(r), int(n)) for r, n in sizes]) for m, sizes in raw]

    def get_map_sizes_by_ranges(
        self,
        shuffle_id: int,
        start_map_index: int,
        end_map_index: Optional[int],
        partition_ranges: List[Tuple[int, int]],
    ) -> List[List[Tuple[int, List[Tuple[int, int]]]]]:
        """Batch form: one RPC answers several partition ranges at once —
        a reduce task spanning multiple ranges asks once, not once per
        range."""
        raw = self._call(
            "get_map_sizes_by_ranges",
            shuffle_id, start_map_index, end_map_index,
            [[int(sp), int(ep)] for sp, ep in partition_ranges],
        )
        return [
            [(int(m), [(int(r), int(n)) for r, n in sizes]) for m, sizes in one]
            for one in raw
        ]

    def epoch(self, shuffle_id: int) -> int:
        return int(self._call("epoch", shuffle_id))

    def get_snapshot(self, shuffle_id: int) -> Tuple[int, bytes]:
        """``(epoch, serialized snapshot bytes)`` at the coordinator's
        current epoch — the RPC fallback when the storage-plane snapshot
        object isn't reachable."""
        resp = self._call("get_snapshot", shuffle_id)
        return int(resp["epoch"]), base64.b64decode(resp["data_b64"])

    def shard_addresses(self) -> List[Tuple[str, int]]:
        """Extra coordinator listener endpoints (empty when the server
        binds only the primary socket)."""
        return [(str(h), int(p)) for h, p in self._call("shard_addresses")]

    def contains(self, shuffle_id: int) -> bool:
        return bool(self._call("contains", shuffle_id))

    def num_partitions(self, shuffle_id: int) -> int:
        return int(self._call("num_partitions", shuffle_id))

    def unregister_shuffle(self, shuffle_id: int) -> None:
        self._call("unregister_shuffle", shuffle_id)

    def registered_map_ids(self, shuffle_id: int) -> List[int]:
        return [int(x) for x in self._call("registered_map_ids", shuffle_id)]

    def composite_locations(self, shuffle_id: int) -> List[Tuple[int, int, int]]:
        return [
            (int(m), int(g), int(b))
            for m, g, b in self._call("composite_locations", shuffle_id)
        ]

    def shuffle_ids(self) -> List[int]:
        return [int(x) for x in self._call("shuffle_ids")]

    # -- shuffle-stats aggregation (metrics subsystem) -----------------
    def report_task_stats(self, entries: List[dict]) -> None:
        """Push task-stats entries (TaskStats dicts) to the coordinator's
        aggregate — the worker outbox drain path."""
        self._call("report_task_stats", entries)

    def get_shuffle_stats(self, shuffle_id: int) -> Optional[dict]:
        return self._call("get_shuffle_stats", shuffle_id)

    # -- task-queue interface (coordinator-hosted TaskQueue) -----------
    def submit_stage(self, stage_id: str, tasks: List[dict]) -> None:
        self._call("q_submit_stage", stage_id, tasks)

    def take_task(self, worker_id: str) -> dict:
        return self._call("q_take_task", worker_id)

    def complete_task(
        self, stage_id: str, task_id, result, worker_id=None, map_output=None
    ) -> bool:
        """``map_output``: optional ``[shuffle_id, map_id, location, sizes,
        map_index, composite_group, base_offset]`` registered atomically
        with acceptance (see TaskQueue.complete_task). The first five
        elements are required — the server rejects 4-element payloads
        (pre-format-2 clients); the composite coordinates default to the
        one-object-per-map layout when absent."""
        return self._call(
            "q_complete_task", stage_id, task_id, result, worker_id, map_output
        )

    def fail_task(self, stage_id: str, task_id, error: str, worker_id=None) -> bool:
        return self._call("q_fail_task", stage_id, task_id, error, worker_id)

    def heartbeat(self, worker_id: str) -> None:
        self._call("q_heartbeat", worker_id)

    def can_commit(self, stage_id: str, task_id, worker_id: str) -> bool:
        return self._call("q_can_commit", stage_id, task_id, worker_id)

    def stage_status(self, stage_id: str) -> dict:
        return self._call("q_stage_status", stage_id)

    def drop_stage(self, stage_id: str) -> None:
        self._call("q_drop_stage", stage_id)

    def reap_expired(self, stage_id: str, lease_s: float) -> int:
        return self._call("q_reap_expired", stage_id, lease_s)

    def reap_expired_all(self, lease_s: float) -> int:
        return self._call("q_reap_expired_all", lease_s)

    def retry_failed(self, stage_id: str, task_id, reason: str = "recovery") -> bool:
        return bool(self._call("q_retry_failed", stage_id, task_id, reason))

    def stop_workers(self) -> None:
        self._call("q_stop_workers")

    # -- fleet membership (elastic worker fleet) -----------------------
    def register_worker(self, worker_id: str) -> None:
        """Explicit membership join (a worker agent's start-up)."""
        self._call("q_register_worker", worker_id)

    def request_drain(self, worker_id: str) -> bool:
        """Flag one worker for graceful drain; it learns at its next poll."""
        return bool(self._call("q_request_drain", worker_id))

    def deregister_worker(
        self, worker_id: str, drain_seconds: Optional[float] = None
    ) -> None:
        """Graceful leave, reporting how long the drain took."""
        self._call("q_deregister_worker", worker_id, drain_seconds)

    def membership(self) -> dict:
        """The coordinator's membership table + bounded event log."""
        return self._call("q_membership")

    # -- distributed trace + fleet telemetry ---------------------------
    def report_trace_spans(self, spans: List[dict]) -> int:
        """Ship one span shard to the coordinator's trace store. Returns
        the count accepted (0 = refused at the byte cap; the caller
        discards — tracing never backpressures the data plane)."""
        return int(self._call("report_trace_spans", spans))

    def get_trace_spans(self) -> List[dict]:
        """Drain every buffered worker span (driver trace assembly)."""
        return list(self._call("get_trace_spans"))

    def report_fleet_sample(
        self, worker_id: str, snapshot: dict, peaks: Optional[dict] = None
    ) -> None:
        """Push this worker's compact metrics snapshot + OBJECT_GETS peaks
        into the coordinator's fleet-telemetry table."""
        self._call("report_fleet_sample", worker_id, snapshot, peaks or {})

    def get_fleet_view(self) -> dict:
        """Merged fleet view (per-worker ages/peaks + merged metrics)."""
        return self._call("get_fleet_view")
