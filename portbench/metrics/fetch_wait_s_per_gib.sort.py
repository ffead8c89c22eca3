"""Reduce tasks' summed ShuffleReadMetrics.wait_ns per user GiB."""

from portbench.readings import fetch_wait_s_per_gib as read  # noqa: F401
