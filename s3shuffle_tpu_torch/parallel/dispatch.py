"""Device dispatcher: spread the batch launches over every local device (the
JAX package's ``parallel/dispatch.py``).

Without it the batch executors (``ops/tlz.py`` ``encode_batch_device`` /
``decode_batch_device``, ``coding/gf.py`` ``encode_groups``) launch every
batch on the caller's device. The dispatcher is the placement layer under
them:

- **least-outstanding placement**: :meth:`DeviceDispatcher.acquire` picks
  the lane with the fewest launches in flight (ties go to the lowest index,
  so a single-stream caller walks the lanes round-robin);
- **one stream per lane**: a lane's launches run on its own CUDA stream, so
  lanes overlap even when they share a device;
- **per-lane accounting**: ``mesh_batches_dispatched_total{device}``, the
  ``mesh_device_outstanding{device}`` gauge and ``mesh_dispatch_wait_seconds``
  (time a full in-flight window spent draining its oldest launch).

Arming follows the JAX contract: ``mesh_devices`` 0 or 1 (the default)
means :func:`get_dispatcher` returns None and every caller keeps the
single-device op pattern. The width arrives through
``ShuffleConfig.mesh_devices`` (:func:`configure`, called where a manager
binds its codec) or the ``S3SHUFFLE_MESH_DEVICES`` override. With fewer
than two local devices of the caller's type the plane stays off, as in the
JAX package on a one-chip host.

Departures from the JAX package, each on purpose:

- **no class gate**: JAX excludes device classes whose measured rates lose
  to the host (``_eligible_for`` through ``ops/rates.py``). The port has no
  measured-rate gate, so every lane is eligible.
- **enumeration errors raise**: JAX treats a failed device enumeration as
  "plane off", which would hide the device; here the error propagates.
- **lanes may repeat a device**: :func:`local_devices` is the one seam that
  tests and ``chip_smoke.py`` patch to run the armed paths on one device
  (``[cuda:0] * 4`` on one GPU, ``[cpu] * 4`` in the CPU tests). A lane's
  label stays unique: a device that appears more than once is labelled
  ``cuda:0/0``, ``cuda:0/1``, ... by occurrence.
- **placement keeps the device type**: a dispatcher is built for one device
  type, and a caller takes it only for a call on that type, so a
  ``device="cpu"`` call never moves to a card and a card call never moves
  to the CPU.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from s3shuffle_tpu_torch.metrics import registry as _metrics

logger = logging.getLogger("s3shuffle_tpu_torch.parallel")

_C_DISPATCHED = _metrics.REGISTRY.counter(
    "mesh_batches_dispatched_total",
    "Device batches placed by the mesh dispatcher, by target device "
    "(encode/decode/GF-parity launches riding the multi-chip plane)",
    labelnames=("device",),
)
_H_WAIT = _metrics.REGISTRY.histogram(
    "mesh_dispatch_wait_seconds",
    "Seconds a full dispatch window spent draining its oldest in-flight "
    "launch before the next batch could be placed",
)
_G_OUTSTANDING = _metrics.REGISTRY.gauge(
    "mesh_device_outstanding",
    "Launches currently in flight per device under the mesh dispatcher",
    labelnames=("device",),
)

#: operator/bench override of the configured width (takes precedence over
#: :func:`configure`); unset or empty defers to the configured value
_MESH_ENV = "S3SHUFFLE_MESH_DEVICES"

_lock = threading.Lock()
_configured = 0
#: (width, device type) → the dispatcher built for it
_dispatchers: Dict[Tuple[int, str], "DeviceDispatcher"] = {}


def local_devices(device_type: str = "cuda") -> List[torch.device]:
    """The local devices of ``device_type``: every CUDA device (none when
    CUDA is unavailable), or the one CPU. Tests and ``chip_smoke.py``
    replace this function to emulate lanes (see the module docstring)."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            return []
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if device_type == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"unsupported device type {device_type!r}: expected cuda or cpu")


# ---------------------------------------------------------------------------
# Lanes: one stream each (None on the CPU, where work is synchronous)
# ---------------------------------------------------------------------------


def lane_streams(devices: Sequence[torch.device]) -> List[Optional["torch.cuda.Stream"]]:
    """A new stream per CUDA lane, None per CPU lane."""
    return [torch.cuda.Stream(device=d) if d.type == "cuda" else None for d in devices]


def on_lane(stream) -> contextlib.AbstractContextManager:
    """Make ``stream`` (and its device) current for the block; no-op for a
    CPU lane."""
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def record_event(stream):
    """An event recorded on ``stream`` now (None for a CPU lane)."""
    return stream.record_event() if stream is not None else None


def wait_event(stream, event) -> None:
    """Make ``stream``'s later work wait for ``event``."""
    if stream is not None and event is not None:
        stream.wait_event(event)


def synchronize(stream) -> None:
    if stream is not None:
        stream.synchronize()


class DeviceDispatcher:
    """Least-outstanding placement over a fixed tuple of lanes (torch
    devices of one type, a device may repeat).

    Thread-safe: the per-lane outstanding counters and the lazily created
    streams are only touched under ``_lock``."""

    def __init__(self, devices: Sequence):
        if not devices:
            raise ValueError("dispatcher needs at least one device")
        self.devices = tuple(torch.device(d) for d in devices)
        types = {d.type for d in self.devices}
        if len(types) != 1:
            raise ValueError(f"dispatcher lanes mix device types {sorted(types)}")
        self.device_type = types.pop()
        names = [str(d) for d in self.devices]
        seen: Dict[str, int] = {}
        labels = []
        for name in names:
            k = seen.get(name, 0)
            seen[name] = k + 1
            labels.append(f"{name}/{k}" if names.count(name) > 1 else name)
        self._labels = tuple(labels)
        self._lock = threading.Lock()
        self._outstanding: List[int] = [0] * len(self.devices)
        self._streams: List = [None] * len(self.devices)

    # ------------------------------------------------------------------
    @property
    def n_devices(self) -> int:
        return len(self.devices)

    def device(self, idx: int) -> torch.device:
        return self.devices[idx]

    def label(self, idx: int) -> str:
        return self._labels[idx]

    def stream(self, idx: int):
        """Lane ``idx``'s own stream (created on first use; None on the
        CPU)."""
        if self.device_type != "cuda":
            return None
        with self._lock:
            if self._streams[idx] is None:
                self._streams[idx] = torch.cuda.Stream(device=self.devices[idx])
            return self._streams[idx]

    def lane(self, idx: int) -> contextlib.AbstractContextManager:
        """Run a block on lane ``idx``'s stream (and device)."""
        return on_lane(self.stream(idx))

    def max_inflight(self) -> int:
        """Launches a caller keeps in flight before draining: one per lane
        keeps every lane busy without unbounded staging memory."""
        return len(self.devices)

    # ------------------------------------------------------------------
    def acquire(self) -> int:
        """Pick the lane with the fewest launches in flight (ties to the
        lowest index) and claim one slot on it. Returns the lane index
        (pair every acquire with a :meth:`release`)."""
        with self._lock:
            idx = min(range(len(self.devices)), key=lambda i: (self._outstanding[i], i))
            self._outstanding[idx] += 1
            now = self._outstanding[idx]
        if _metrics.enabled():
            _C_DISPATCHED.labels(device=self._labels[idx]).inc()
            _G_OUTSTANDING.labels(device=self._labels[idx]).set(now)
        return idx

    def release(self, idx: int) -> None:
        with self._lock:
            self._outstanding[idx] -= 1
            now = self._outstanding[idx]
        if _metrics.enabled():
            _G_OUTSTANDING.labels(device=self._labels[idx]).set(now)

    def observe_wait(self, seconds: float) -> None:
        """Record one full-window drain wait."""
        if _metrics.enabled():
            _H_WAIT.observe(seconds)

    def outstanding_snapshot(self) -> List[int]:
        with self._lock:
            return list(self._outstanding)


# ---------------------------------------------------------------------------
# Module-level arming (config plumbing + env override)
# ---------------------------------------------------------------------------


def configure(mesh_devices: int) -> None:
    """Record the configured width (``ShuffleConfig.mesh_devices``). 0 or 1
    disarms: :func:`get_dispatcher` answers None."""
    global _configured
    with _lock:
        width = max(0, int(mesh_devices))
        if width != _configured:
            _configured = width
            _dispatchers.clear()


def requested_devices() -> int:
    """The effective requested width: the env override when set, else the
    configured value."""
    raw = os.environ.get(_MESH_ENV, "").strip()
    if raw:
        try:
            return max(0, int(raw))
        except ValueError:
            logger.warning("ignoring malformed %s=%r", _MESH_ENV, raw)
    return _configured


def reset_for_testing() -> None:
    """Drop the configured width and every built dispatcher."""
    global _configured
    with _lock:
        _configured = 0
        _dispatchers.clear()


def get_dispatcher(device_type: str = "cuda") -> Optional[DeviceDispatcher]:
    """The armed dispatcher over the local devices of ``device_type``, or
    None when the plane is off: an effective width <= 1, fewer than two
    local devices, or lanes of another type than ``device_type``. An
    enumeration error propagates."""
    n = requested_devices()
    if n <= 1:
        return None
    key = (n, device_type)
    with _lock:
        built = _dispatchers.get(key)
    if built is not None:
        return built
    devices = [torch.device(d) for d in local_devices(device_type)]
    if len(devices) < 2 or any(d.type != device_type for d in devices):
        return None
    built = DeviceDispatcher(devices[:n])
    with _lock:
        return _dispatchers.setdefault(key, built)
