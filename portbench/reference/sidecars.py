"""Judges the checksum sidecars the port wrote: each map output's
``shuffle_<s>_<m>_0.checksum.CRC32C`` (one CRC per reduce partition, each
a uint32 in a big-endian int64) against a plain CRC32C of that
partition's stored bytes in ``shuffle_<s>_<m>_0.data``, cut at the
cumulative offsets of ``shuffle_<s>_<m>_0.index`` (big-endian int64, one
more entry than partitions; trailer words after them are not offsets).

It reads the store's files as plain files and knows only their names and
the two sidecar layouts (Spark's ``DataOutputStream`` longs).
"""

from __future__ import annotations

import os
import re

import numpy as np

from portbench.reference.crc32c import crc32c

NAME = re.compile(r"^shuffle_(\d+)_(\d+)_0\.(data|index|checksum\.CRC32C)$")


def objects_by_map(root: str, shuffle_ids) -> dict:
    """``{(shuffle, map): {"data" | "index" | "checksum.CRC32C": path}}``
    of the shuffles ``shuffle_ids`` under ``root``."""
    wanted = set(shuffle_ids)
    found: dict = {}
    for directory, _dirs, files in os.walk(root):
        for name in files:
            m = NAME.match(name)
            if m and int(m.group(1)) in wanted:
                key = (int(m.group(1)), int(m.group(2)))
                found.setdefault(key, {})[m.group(3)] = os.path.join(directory, name)
    return found


def _words(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        blob = f.read()
    return np.frombuffer(blob[: len(blob) // 8 * 8], dtype=">i8").astype(np.int64)


def check_sidecars(root: str, shuffle_ids) -> dict:
    """``{"maps", "entries", "wrong"}``: the map outputs found, the
    partition checksums compared, and those that differ from the plain
    CRC32C (a map output without its data, index or checksum object counts
    one wrong, as does a shuffle of ``shuffle_ids`` with no map output)."""
    found = objects_by_map(root, shuffle_ids)
    wrong = len(set(shuffle_ids) - {sid for sid, _m in found})
    entries = 0
    for paths in found.values():
        if set(paths) != {"data", "index", "checksum.CRC32C"}:
            wrong += 1
            continue
        sums = _words(paths["checksum.CRC32C"]) & 0xFFFFFFFF
        offsets = _words(paths["index"])[: len(sums) + 1]
        with open(paths["data"], "rb") as f:
            data = f.read()
        if len(offsets) != len(sums) + 1 or offsets[-1] > len(data):
            wrong += 1
            continue
        for p, want in enumerate(sums.tolist()):
            entries += 1
            wrong += crc32c(memoryview(data)[offsets[p]: offsets[p + 1]]) != want
    return {"maps": len(found), "entries": entries, "wrong": int(wrong)}
