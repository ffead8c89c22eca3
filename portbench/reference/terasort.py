"""TeraSort's plain reference: the input rows ordered by their whole
bytes, and the judge of one job's output partitions against them.

The order check is TeraValidate's (keys non-decreasing within and across
partitions, as the port's and the JAX package's ``examples/terasort.py``
check it); the row check is the one ``chip_smoke.py``'s ``teravalidate``
makes (output rows, ordered by the whole row, equal to the input's), made
cheap here by trying the output order first: with random 10-byte keys equal
keys are rare, so the key-ordered output is already in whole-row order but
where keys tie.
"""

from __future__ import annotations

import numpy as np

KEY_BYTES = 10


def sort_rows(rows: np.ndarray) -> np.ndarray:
    """``rows`` ((n, width) uint8) ordered by their whole bytes."""
    width = rows.shape[1]
    flat = np.ascontiguousarray(rows).view(f"S{width}").ravel()
    return np.sort(flat).view(np.uint8).reshape(-1, width)


def judge_job(partitions, expected_sorted: np.ndarray) -> int:
    """Rows wrong in one job's output: ``partitions`` are its output
    partitions in order, each an (n, width) uint8 array of rows. Counts the
    rows missing or extra, the adjacent pairs out of key order (within and
    across partitions), and the rows that differ from the input's once both
    are ordered by the whole row; 0 for a correct job."""
    parts = [p for p in partitions if len(p)]
    width = expected_sorted.shape[1]
    out = np.concatenate(parts) if parts else np.zeros((0, width), dtype=np.uint8)
    wrong = abs(len(out) - len(expected_sorted))
    keys = np.ascontiguousarray(out[:, :KEY_BYTES]).view(f"S{KEY_BYTES}").ravel()
    wrong += int(np.count_nonzero(keys[1:] < keys[:-1]))
    n = min(len(out), len(expected_sorted))
    if len(out) != len(expected_sorted) or not np.array_equal(out, expected_sorted):
        ordered = sort_rows(out) if len(out) else out
        wrong += int(np.count_nonzero((ordered[:n] != expected_sorted[:n]).any(axis=1)))
    return wrong


def control_job(rows: np.ndarray, reducers: int) -> list:
    """The control: the reference in the program's place, sorting on the
    first four key bytes only (a 32-bit key, as a device sort on one word
    would), cut into ``reducers`` equal partitions. At a TeraSort job's
    millions of random keys, many pairs share their first four bytes and
    half of them land out of order."""
    prefix = rows[:, :4].astype(np.uint32)
    key = (prefix[:, 0] << 24) | (prefix[:, 1] << 16) | (prefix[:, 2] << 8) | prefix[:, 3]
    ordered = rows[np.argsort(key, kind="stable")]
    return np.array_split(ordered, reducers)
