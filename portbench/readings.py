"""What the metric readers under ``portbench/metrics/`` share: each reads
one number from the ``obs`` dict the harness fills, or None where the run
has nothing for it to read."""

from __future__ import annotations

GiB = 1 << 30
MiB = 1 << 20


def per_user_gib(obs, seconds):
    if seconds is None or not obs["user_bytes"]:
        return None
    return seconds / (obs["user_bytes"] / GiB)


def fetch_wait_s_per_gib(obs):
    """Reduce tasks' summed ``ShuffleReadMetrics.wait_ns`` per user GiB."""
    return per_user_gib(obs, obs["read_wait_ns"] / 1e9 if obs["units"] else None)


def codec_host_s_per_gib(obs):
    """The codec batch layer's host seconds (encode assembly, decode parse
    and emit, summed over threads) per user GiB."""
    t = obs["codec_timings"]
    keys = ("encode_assembly_s", "decode_parse_s", "decode_emit_s")
    if not any(k in t for k in keys):
        return None
    return per_user_gib(obs, sum(t.get(k, 0.0) for k in keys))


def codec_bytes(obs):
    """The bytes the codec's device work needs, each read once and written
    once: every frame encoded (its raw bytes read, its stored payload
    written) and every TLZ frame decoded (its payload read, its raw bytes
    written). Each frame written is read back once by its reduce task."""
    f = obs["frame_bytes"]
    if not f.get("frames"):
        return None
    return f["raw"] + f["stored"] + f.get("tlz_raw", 0) + f.get("tlz_stored", 0)


def codec_roofline(obs):
    """The least time of the codec's bytes at the card's memory bandwidth,
    as a share of the union of every kernel's intervals in the window."""
    trace, nbytes, bandwidth = obs["trace"], codec_bytes(obs), obs["bandwidth"]
    if not trace or not nbytes or not bandwidth or trace["kernel_s"] <= 0:
        return None
    return 100.0 * (nbytes / bandwidth) / trace["kernel_s"]


def device_idle_pct(obs):
    """The share of the traced window in which neither a kernel nor a copy
    ran on the card."""
    trace = obs["trace"]
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def wire_ratio(obs):
    """Raw bytes of the frames written per user byte: the width of the
    record or typed wire format before the codec."""
    f = obs["frame_bytes"]
    if not f.get("frames") or not obs["user_bytes"]:
        return None
    return f["raw"] / obs["user_bytes"]


def codec_stored_ratio(obs):
    """Stored payload bytes of the frames written per raw byte."""
    f = obs["frame_bytes"]
    if not f.get("raw"):
        return None
    return f["stored"] / f["raw"]
