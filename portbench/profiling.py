"""The traced window: ``torch.profiler`` over every thread of the process,
and what the benchmark reads from its device events.

``union_seconds`` is a frozen copy of the busy-share union of
``chip_smoke.py``'s ``profiled_run`` (13c): device intervals clipped to a
window, sorted, merged where they overlap, and summed.
"""

from __future__ import annotations

import contextlib

WINDOW_SPAN = "portbench.window"
#: device events that move bytes rather than run a kernel
COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")


def union_seconds(intervals, lo: int, hi: int) -> float:
    """Seconds covered by the union of ``intervals`` ((start_ns, end_ns)
    pairs) inside [lo, hi]."""
    clipped = sorted((max(lo, a), min(hi, b)) for a, b in intervals if b > lo and a < hi)
    busy, cur_lo, cur_hi = 0, None, None
    for a, b in clipped:
        if cur_hi is None or a > cur_hi:
            if cur_hi is not None:
                busy += cur_hi - cur_lo
            cur_lo, cur_hi = a, b
        else:
            cur_hi = max(cur_hi, b)
    if cur_hi is not None:
        busy += cur_hi - cur_lo
    return busy / 1e9


def gaps(intervals, lo: int, hi: int):
    """The idle stretches of [lo, hi] between the merged ``intervals``, as
    (start_ns, end_ns) pairs."""
    out, cursor = [], lo
    for a, b in sorted((max(lo, a), min(hi, b)) for a, b in intervals if b > lo and a < hi):
        if a > cursor:
            out.append((cursor, a))
        cursor = max(cursor, b)
    if hi > cursor:
        out.append((cursor, hi))
    return out


@contextlib.contextmanager
def profiled(enabled: bool):
    """``torch.profiler`` (CPU and CUDA activities, every thread) around
    the block when ``enabled``; yields the profiler or None."""
    if not enabled:
        yield None
        return
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        yield prof


def read_trace(prof) -> dict:
    """From the profiler's events: the traced window, the union of kernel
    intervals, the union of kernel and copy intervals, the device
    operations that took most time and the longest idle gaps, each named
    by the innermost host event that covers its middle."""
    import torch

    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    window = [e for e in events if e.name() == WINDOW_SPAN]
    if len(window) != 1:
        raise RuntimeError(f"expected one {WINDOW_SPAN} span, found {len(window)}")
    lo, hi = window[0].start_ns(), window[0].end_ns()
    device, host = [], []
    for e in events:
        (device if e.device_type() == cuda else host).append(e)
    kernels = [(e.start_ns(), e.end_ns()) for e in device
               if not e.name().startswith(COPY_PREFIXES)]
    everything = [(e.start_ns(), e.end_ns()) for e in device]
    by_name: dict = {}
    for e in device:
        if e.end_ns() > lo and e.start_ns() < hi:
            inside = min(hi, e.end_ns()) - max(lo, e.start_ns())
            by_name[e.name()] = by_name.get(e.name(), 0) + inside
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    longest = sorted(gaps(everything, lo, hi), key=lambda g: g[0] - g[1])[:10]
    named = []
    for a, b in longest:
        mid = (a + b) // 2
        covering = [e for e in host if e.start_ns() <= mid <= e.end_ns()
                    and e.name() != WINDOW_SPAN]
        inner = min(covering, key=lambda e: e.duration_ns()).name() if covering else \
            "no host event"
        named.append([inner, (b - a) / 1e9])
    return {
        "window_s": (hi - lo) / 1e9,
        "kernel_s": union_seconds(kernels, lo, hi),
        "busy_s": union_seconds(everything, lo, hi),
        "kernels": len(kernels),
        "breakdown": {"device_ops": [[name, ns / 1e9] for name, ns in device_ops],
                      "idle_gaps": named},
    }
