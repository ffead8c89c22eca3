"""Encode assembly, decode parse and decode emit seconds (the codec's
stage timings, summed over threads) per user GiB."""

from portbench.readings import codec_host_s_per_gib as read  # noqa: F401
