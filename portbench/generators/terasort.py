"""TeraSort jobs through ``ShuffleContext.sort_by_key`` on the bypass-merge
handle: one job at a time (a closed loop), ``maps`` map tasks of columnar
batches to ``reducers`` range partitions.

The records are TeraGen's, in GenSort's public layout (Hadoop's
``GenSort.generateRecord``, which spark-terasort's ``TeraGen`` calls):

    [10-byte key][00 11][32 ASCII hex digits of the record number]
    [88 99 AA BB][48 filler bytes][CC DD EE FF]

The key is the high 10 bytes of a 128-bit random number and the filler is
its low 48 bits as 12 upper-case hex digits, each written four times.
Here the 128-bit numbers are drawn from the seed (not from GenSort's own
generator), and map ``m`` holds the records numbered ``m * per_map`` to
``(m + 1) * per_map - 1``, ``per_map = job_bytes // 100 // maps``.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import terasort as reference

KEY_BYTES, VALUE_BYTES = 10, 90
RECORD_BYTES = KEY_BYTES + VALUE_BYTES
HEX = np.frombuffer(b"0123456789ABCDEF", dtype=np.uint8)


def gensort_records(first: int, n: int, rng) -> np.ndarray:
    """Records ``first`` to ``first + n - 1`` as an (n, 100) uint8 array."""
    rand = rng.integers(0, 256, (n, 16), dtype=np.uint8)
    rec = np.empty((n, RECORD_BYTES), dtype=np.uint8)
    rec[:, :10] = rand[:, :10]
    rec[:, 10:12] = (0x00, 0x11)
    # the record number's 32 hex digits: the high 16 are 0 below 2**64
    rec[:, 12:28] = ord("0")
    number = np.arange(first, first + n, dtype=np.uint64)
    shifts = np.arange(60, -1, -4, dtype=np.uint64)
    rec[:, 28:44] = HEX[(number[:, None] >> shifts) & np.uint64(0xF)]
    rec[:, 44:48] = (0x88, 0x99, 0xAA, 0xBB)
    low = rand[:, 10:]
    digits = np.empty((n, 12), dtype=np.uint8)
    digits[:, 0::2] = low >> 4
    digits[:, 1::2] = low & 0xF
    rec[:, 48:96] = np.repeat(HEX[digits], 4, axis=1)
    rec[:, 96:100] = (0xCC, 0xDD, 0xEE, 0xFF)
    return rec


def make_terasort(total_bytes: int, n_maps: int, seed: int):
    """Per map, its records as an (n, 100) uint8 array."""
    per_map = total_bytes // RECORD_BYTES // n_maps
    rng = np.random.default_rng(seed)
    return [gensort_records(m * per_map, per_map, rng) for m in range(n_maps)]


def make_inputs(config, traffic, seed):
    from s3shuffle_tpu_torch.batch import RecordBatch

    maps = make_terasort(config["job_bytes"], config["maps"], seed)
    parts = [RecordBatch(np.full(len(r), KEY_BYTES, np.int32),
                         np.full(len(r), VALUE_BYTES, np.int32),
                         np.ascontiguousarray(r[:, :KEY_BYTES]).reshape(-1),
                         np.ascontiguousarray(r[:, KEY_BYTES:]).reshape(-1)) for r in maps]
    rows = np.concatenate(maps)
    return {"parts": parts, "rows": rows}


def unit_work(config, traffic, inputs):
    return {"user_bytes": len(inputs["rows"]) * RECORD_BYTES}


def run_unit(ctx, config, traffic, inputs):
    from s3shuffle_tpu_torch.serializer import ColumnarKVSerializer

    out = ctx.sort_by_key(inputs["parts"], config["reducers"],
                          serializer=ColumnarKVSerializer(), materialize="batches")
    return [[(b.keys, b.values) for b in partition if b.n] for partition in out]


def _partition_rows(partition):
    if not partition:
        return np.zeros((0, RECORD_BYTES), dtype=np.uint8)
    return np.concatenate([np.hstack([np.asarray(k).reshape(-1, KEY_BYTES),
                                      np.asarray(v).reshape(-1, VALUE_BYTES)])
                           for k, v in partition])


def judge(config, traffic, inputs, answers):
    expected = reference.sort_rows(inputs["rows"])
    return sum(reference.judge_job([_partition_rows(p) for p in answer], expected)
               for answer in answers)


def control(config, traffic, inputs):
    return [[(p[:, :KEY_BYTES], p[:, KEY_BYTES:])]
            for p in reference.control_job(inputs["rows"], config["reducers"])]
