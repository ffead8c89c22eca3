"""Tracing subsystem (the JAX package's ``utils/trace.py``).

An in-process tracer that records **spans** (name, thread, start, duration,
attributes) and **counters**, exports them as Chrome trace-event JSON
(loadable in chrome://tracing or Perfetto, and read by
``tools/critical_path.py`` and ``tools/trace_report.py``), and opens a
``torch.profiler.record_function`` around each span, so host spans land on
the same ``torch.profiler`` timeline as the kernels they launch. That is
the one departure from the JAX package, whose spans open JAX profiler
annotations instead: :func:`enable` takes ``torch_annotations`` where the
JAX one takes its own annotation flag, with the same default.

Distributed semantics (the trace *plane*):

- every span carries **causal identity** (``trace_id`` / ``span_id`` /
  ``parent_id`` in its ``args``) kept on a per-thread context stack;
- timestamps are **wall-clock anchored**: ``perf_counter`` keeps spans
  monotonic in-process, and a per-process offset maps them onto wall time,
  so events from several processes land on one timeline;
- a remote parent is adopted with :class:`context`, and
  :func:`current_context` gives the injectable form;
- :func:`drain_spans` pops completed events for shard shipping, and
  :func:`assemble` merges shards into one Chrome-trace document with flow
  events on the edges that cross processes;
- :func:`flush` / :func:`write_trace_doc` write a temporary file and rename
  it, and the ``atexit`` hook flushes what is buffered.

Free when disabled: ``span()`` returns a shared no-op context manager
unless tracing was enabled with :func:`enable` or the ``S3SHUFFLE_TRACE``
environment variable (the output path, or ``1`` for
``s3shuffle_trace.json``), or ``torch.profiler`` is recording. While the
profiler records and tracing is off, a span is only a profiler range of
its name (``torch._C._profiler._RecordFunctionFast``): it records no event
and stacks no instrumented store, so the port's spans sit on any profiler
timeline with the kernels and copies they launch. The range is of
function scope, as an operator's is, not of ``record_function``'s user
scope: a user-scope range is mirrored onto the device's timeline as an
annotation around the kernels launched inside it, which a reader of the
device's events would count as device time.

**Stages** (:func:`stage`): a span whose wall seconds also add into a
sink's ``timings`` dict (a codec's, or a task's :class:`Tally`), looked up
as the stage ends; the job stages, the tasks, the record layer and the
codec's batch stages are timed so.

**Flight recorder** (always on, apart from the enable flag): a bounded ring
of recent records, the explicit :func:`flight_record` milestones and, while
tracing is on, every completed span. :func:`flight_dump` writes the ring
atomically as a postmortem JSONL (a header line, then one record per line)
when a dump directory was configured (:func:`configure_flight`); the
``atexit`` hook dumps only after :func:`flight_note_error`, so a clean run
writes nothing.
"""

from __future__ import annotations

import atexit
import collections
import itertools
import json
import logging
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional

import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

from s3shuffle_tpu_torch.metrics import registry as _metrics

logger = logging.getLogger("s3shuffle_tpu_torch.trace")

_C_FLIGHT_DUMPS = _metrics.REGISTRY.counter(
    "flight_dumps_total",
    "Flight-recorder postmortem dumps written, by trigger reason",
    labelnames=("reason",),
)

_lock = threading.Lock()
_events: List[dict] = []
_counters: Dict[str, float] = {}
_enabled = False
_path: Optional[str] = None
_use_torch_annotations = False

#: wall-clock anchor: spans time with ``perf_counter`` (monotonic — a span
#: can never have negative duration under clock steps) and this per-process
#: offset maps those readings onto the epoch, so traces from different
#: processes align on one timeline.
_WALL_OFFSET_NS = time.time_ns() - time.perf_counter_ns()

_tls = threading.local()


def _wall_us(perf_ns: Optional[int] = None) -> float:
    if perf_ns is None:
        perf_ns = time.perf_counter_ns()
    return (perf_ns + _WALL_OFFSET_NS) / 1e3


def _frames() -> list:
    frames = getattr(_tls, "frames", None)
    if frames is None:
        frames = _tls.frames = []
    return frames


def new_trace_id() -> str:
    return os.urandom(8).hex()


def current_context() -> Optional[Dict[str, str]]:
    """The injectable causal context of the innermost open span on this
    thread (``{"trace_id", "parent_id"}``), or None outside any span. The
    driver stamps this into task descriptors; the worker adopts it with
    :class:`context`."""
    frames = _frames()
    if not frames:
        return None
    trace_id, span_id = frames[-1]
    return {"trace_id": trace_id, "parent_id": span_id}


class context:
    """Adopt a remote parent context on this thread: spans opened inside
    ``with trace.context(ctx): ...`` become children of the remote span that
    produced ``ctx`` (via :func:`current_context`). A falsy/incomplete ctx
    adopts nothing — the block is then a plain no-op."""

    __slots__ = ("_ctx", "_pushed")

    def __init__(self, ctx: Optional[Dict[str, Any]]):
        self._ctx = ctx if isinstance(ctx, dict) else None
        self._pushed = False

    def __enter__(self):
        ctx = self._ctx
        if ctx and ctx.get("trace_id") and ctx.get("parent_id"):
            _frames().append((str(ctx["trace_id"]), str(ctx["parent_id"])))
            self._pushed = True
        return self

    def __exit__(self, *exc) -> None:
        if self._pushed:
            _frames().pop()


def _maybe_enable_from_env() -> None:
    val = os.environ.get("S3SHUFFLE_TRACE")
    if val:
        enable("s3shuffle_trace.json" if val == "1" else val)


def enable(path: str, torch_annotations: bool = True) -> None:
    """Start recording; the trace file is written at :func:`flush` (also
    registered atexit). With ``torch_annotations`` each span also opens a
    ``torch.profiler.record_function`` of its name."""
    global _enabled, _path, _use_torch_annotations
    with _lock:
        _enabled = True
        _path = path
        _use_torch_annotations = torch_annotations


def disable() -> None:
    global _enabled
    with _lock:
        _enabled = False


def enabled() -> bool:
    return _enabled


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        pass

    def discard(self) -> None:
        pass


_NOOP = _NoopSpan()


class _Span:
    __slots__ = (
        "name", "args", "trace_id", "span_id", "parent_id", "_start", "_annotation",
    )

    def __init__(self, name: str, args: Dict[str, Any]):
        self.name = name
        self.args = args
        self.trace_id = ""
        self.span_id = ""
        self.parent_id: Optional[str] = None
        self._start = 0
        self._annotation = None

    def __enter__(self):
        frames = _frames()
        if frames:
            self.trace_id, self.parent_id = frames[-1]
        else:
            self.trace_id = new_trace_id()
            self.parent_id = None
        self.span_id = os.urandom(8).hex()
        frames.append((self.trace_id, self.span_id))
        self._start = time.perf_counter_ns()
        if _use_torch_annotations:
            try:
                import torch

                annotation = torch.profiler.record_function(self.name)
                annotation.__enter__()
                self._annotation = annotation
            except Exception:
                logger.debug("torch profiler annotation unavailable", exc_info=True)
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter_ns()
        if self._annotation is not None:
            annotation, self._annotation = self._annotation, None
            annotation.__exit__(*exc)
        frames = _frames()
        if frames and frames[-1][1] == self.span_id:
            frames.pop()
        args = dict(self.args) if self.args else {}
        args["trace_id"] = self.trace_id
        args["span_id"] = self.span_id
        if self.parent_id:
            args["parent_id"] = self.parent_id
        event = {
            "name": self.name,
            "ph": "X",  # complete event
            "ts": _wall_us(self._start),  # µs, wall-anchored
            "dur": (end - self._start) / 1e3,
            "pid": os.getpid(),
            "tid": threading.get_ident() & 0xFFFFFFFF,
            "args": args,
        }
        with _lock:
            _events.append(event)
        if _flight_enabled:
            _flight.append(event)  # ring mirror (GIL-atomic append)


def span(name: str, **args: Any):
    """``with trace.span("read.prefetch", bytes=n): ...`` — a recorded span
    while tracing is enabled; else, while ``torch.profiler`` records, a
    function-scope profiler range of ``name`` alone (``args`` dropped);
    else the shared no-op."""
    if _enabled:
        return _Span(name, args)
    if _autograd_profiler._is_profiler_enabled:
        return _RecordFunctionFast(name)
    return _NOOP


#: guards every add into a shared sink's ``timings`` dict: one codec's dict
#: is shared by the map and reduce tasks running on its threads
_timings_lock = threading.Lock()


def timings_of(sink: Any) -> Optional[Dict[str, float]]:
    """The dict a sink adds into: ``sink`` itself when it is a dict, else
    its ``timings`` attribute (a codec's, a :class:`Tally`'s), or None."""
    return sink if type(sink) is dict else getattr(sink, "timings", None)


def add_timings(sink: Any, seconds: Dict[str, float]) -> None:
    """Add ``seconds`` (key -> value) into the sink's dict in one locked
    add; nothing while it has none."""
    timings = timings_of(sink)
    if timings is None or not seconds:
        return
    with _timings_lock:
        for key, value in seconds.items():
            timings[key] = timings.get(key, 0.0) + value


class Tally:
    """A sink of its own for the stages of one task or one call, so they
    take no lock each: ``timings`` is a local dict while ``owner.timings``
    is a dict (or with ``keep``), else None; :meth:`flush` adds it into
    ``owner.timings`` in one locked add."""

    __slots__ = ("owner", "timings")

    def __init__(self, owner: Any, keep: bool = False):
        self.owner = owner
        self.timings: Optional[Dict[str, float]] = (
            {} if keep or timings_of(owner) is not None else None
        )

    def add(self, key: str, seconds: float, count: Optional[str]) -> None:
        timings = self.timings
        if timings is not None:
            timings[key] = timings.get(key, 0.0) + seconds
            if count is not None:
                timings[count] = timings.get(count, 0.0) + 1

    def flush(self) -> None:
        if self.timings:
            add_timings(self.owner, self.timings)
            self.timings = {}


def add_count(sink: Any, key: str, n: float) -> None:
    """Add the count ``n`` to the sink's ``[key]`` beside its stage seconds
    (a :class:`Tally`'s local dict, else one locked add); nothing while the
    sink has no dict."""
    if type(sink) is Tally:
        sink.add(key, n, None)
    else:
        add_timings(sink, {key: n})


class _Stage:
    __slots__ = ("_span", "_sink", "_key", "_count", "_start", "_kept")

    def __init__(self, name: str, sink: Any, key: str, count: Optional[str],
                 args: Dict[str, Any]):
        self._span = span(name, **args)
        self._sink = sink
        self._key = key
        self._count = count
        self._kept = True

    def __enter__(self):
        self._span.__enter__()
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        seconds = time.perf_counter() - self._start
        self._span.__exit__(*exc)
        if not self._kept:
            return
        sink = self._sink
        if type(sink) is Tally:
            sink.add(self._key, seconds, self._count)
            return
        add = {self._key: seconds}
        if self._count is not None:
            add[self._count] = 1
        add_timings(sink, add)

    def discard(self) -> None:
        """Close the span as usual but add no seconds."""
        self._kept = False


def stage(name: str, sink: Any, key: str, count: Optional[str] = None, **args: Any):
    """``with trace.stage("codec.crc_host", codec, "crc_host_s"): ...`` — a
    :func:`span` of ``name`` whose wall seconds also add to the sink's
    ``[key]`` (and 1 to its ``[count]``), the sink's dict being looked up
    as the stage ends (:func:`timings_of`: a dict, or anything with a
    ``timings`` attribute, such as a codec or a :class:`Tally`; or None).
    The shared no-op while tracing, the profiler and the sink are all
    off."""
    if (not _enabled and not _autograd_profiler._is_profiler_enabled
            and timings_of(sink) is None):
        return _NOOP
    return _Stage(name, sink, key, count, args)


def count(name: str, value: float = 1.0) -> None:
    """Accumulate a named counter (exported in the trace metadata and
    readable via :func:`counters`)."""
    if not _enabled:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0.0) + value


def counters() -> Dict[str, float]:
    with _lock:
        return dict(_counters)


def events_snapshot() -> List[dict]:
    with _lock:
        return list(_events)


def drain_spans() -> List[dict]:
    """Pop and return every completed span event (the worker's span-shard
    shipping path — events drained here ride an RPC to the coordinator
    instead of this process's local flush)."""
    global _events
    with _lock:
        out = _events
        _events = []
    return out


def write_trace_doc(path: str, doc: dict) -> str:
    """Crash-safe trace write: serialize to a sibling tmp file, then rename
    atomically — a crash mid-write can never leave a torn/unparseable trace
    at the advertised path."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path


def assemble(
    event_lists: Iterable[List[dict]],
    counters: Optional[Dict[str, float]] = None,
) -> dict:
    """Merge per-process span-event shards into ONE Chrome-trace document.

    Adds Perfetto flow events (``ph: "s"`` at the parent span, ``ph: "f"``
    at each child) for every parent→child edge that crosses a process
    boundary, so the driver→worker→storage causality renders as arrows on
    the merged timeline."""
    events: List[dict] = []
    for shard in event_lists:
        events.extend(shard)
    by_span: Dict[str, dict] = {}
    for e in events:
        sid = e.get("args", {}).get("span_id")
        if sid:
            by_span[sid] = e
    flows: List[dict] = []
    started: set = set()
    for e in events:
        parent_id = e.get("args", {}).get("parent_id")
        if not parent_id:
            continue
        parent = by_span.get(parent_id)
        if parent is None or parent.get("pid") == e.get("pid"):
            continue
        if parent_id not in started:
            started.add(parent_id)
            flows.append(
                {
                    "name": "causal", "cat": "trace", "ph": "s",
                    "id": parent_id, "pid": parent["pid"],
                    "tid": parent["tid"], "ts": parent["ts"],
                }
            )
        flows.append(
            {
                "name": "causal", "cat": "trace", "ph": "f", "bp": "e",
                "id": parent_id, "pid": e["pid"], "tid": e["tid"],
                "ts": e["ts"],
            }
        )
    return {
        "traceEvents": events + flows,
        "otherData": {"counters": dict(counters or {})},
        "displayTimeUnit": "ms",
    }


def trace_path() -> Optional[str]:
    """The output path :func:`enable` was given (None when tracing is off
    or was enabled without one) — the driver's default assembly target."""
    return _path


def flush(path: Optional[str] = None) -> Optional[str]:
    """Write the Chrome trace-event file (atomically — see
    :func:`write_trace_doc`). Returns the path written (None when nothing
    was recorded)."""
    target = path or _path
    with _lock:
        if target is None or (not _events and not _counters):
            return None
        doc = {
            "traceEvents": list(_events),
            "otherData": {"counters": dict(_counters)},
            "displayTimeUnit": "ms",
        }
    return write_trace_doc(target, doc)


def reset() -> None:
    global _events, _counters
    with _lock:
        _events = []
        _counters = {}
    _flight.clear()


# ---------------------------------------------------------------------------
# Flight recorder
# ---------------------------------------------------------------------------

FLIGHT_RING_DEFAULT = 512

_flight: collections.deque = collections.deque(maxlen=FLIGHT_RING_DEFAULT)
_flight_lock = threading.Lock()  # configure/dump only; appends stay lock-free
_flight_enabled = True
_flight_dir: Optional[str] = None
_flight_worker: Optional[str] = None
_flight_seq = itertools.count(1)
_flight_error = False


def configure_flight(
    dir: Optional[str] = None,
    ring: Optional[int] = None,
    worker_id: Optional[str] = None,
) -> None:
    """Configure the flight recorder: ``dir`` is the postmortem dump
    directory (empty string disables dumping — the ring still records),
    ``ring`` resizes the bounded ring (0 disables recording entirely — the
    overhead-probe baseline), ``worker_id`` names dump files. Any argument
    left None is unchanged."""
    global _flight, _flight_dir, _flight_worker, _flight_enabled
    with _flight_lock:
        if ring is not None:
            _flight_enabled = int(ring) > 0
            if _flight_enabled and int(ring) != _flight.maxlen:
                _flight = collections.deque(_flight, maxlen=int(ring))
        if dir is not None:
            _flight_dir = dir or None
        if worker_id is not None:
            _flight_worker = worker_id or None


def flight_record(name: str, phase: str = "i", **fields: Any) -> None:
    """Append one milestone record to the always-on ring (task begin/end,
    drain, failure, ...). Near-zero cost: a dict build plus a GIL-atomic
    deque append; no locks, no I/O. The current causal context (if any) is
    stamped on so a postmortem dump links to the distributed trace."""
    if not _flight_enabled:
        return
    rec: Dict[str, Any] = {
        "name": name,
        "ph": phase,
        "ts": _wall_us(),
        "pid": os.getpid(),
        "tid": threading.get_ident() & 0xFFFFFFFF,
    }
    args: Dict[str, Any] = dict(fields) if fields else {}
    frames = getattr(_tls, "frames", None)
    if frames:
        args.setdefault("trace_id", frames[-1][0])
        args.setdefault("parent_id", frames[-1][1])
    if args:
        rec["args"] = args
    _flight.append(rec)


def flight_note_error() -> None:
    """Mark that something went wrong; if no explicit dump happens before
    process exit, the atexit hook writes an ``atexit_after_error`` dump."""
    global _flight_error
    _flight_error = True


def flight_dump(reason: str) -> Optional[str]:
    """Atomically write the ring to ``<flight_dir>/flight-<id>-<seq>-
    <reason>.jsonl`` (header line, then one JSON record per line). Returns
    the path, or None when no dump directory is configured or the write
    failed — dumping is postmortem best-effort and never raises into the
    failure path that triggered it."""
    global _flight_error
    with _flight_lock:
        directory = _flight_dir
        if directory is None:
            return None
        records = list(_flight)
        seq = next(_flight_seq)
        ident = _flight_worker or f"pid{os.getpid()}"
    final = os.path.join(directory, f"flight-{ident}-{seq:03d}-{reason}.jsonl")
    tmp = f"{final}.tmp"
    header = {
        "flight_recorder": 1,
        "reason": reason,
        "worker": _flight_worker,
        "pid": os.getpid(),
        "wall_time": time.time(),
        "events": len(records),
    }
    try:
        os.makedirs(directory, exist_ok=True)
        with open(tmp, "w") as f:
            f.write(json.dumps(header) + "\n")
            for rec in records:
                f.write(json.dumps(rec) + "\n")
        os.replace(tmp, final)
    except OSError:
        logger.exception("flight-recorder dump to %s failed", directory)
        return None
    _flight_error = False
    _C_FLIGHT_DUMPS.labels(reason=reason).inc()
    return final


def _atexit_hook() -> None:
    if _flight_error:
        flight_dump("atexit_after_error")
    flush()


atexit.register(_atexit_hook)
_maybe_enable_from_env()
