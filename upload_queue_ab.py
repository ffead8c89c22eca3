#!/usr/bin/env python3
"""Time the port's map-output writer with its upload queue on and off, in
alternation, in one process on one GPU.

    python3 upload_queue_ab.py [--rounds 3] [--seed 0] [--total-mib 1024] [--terasort]

Each round runs ``chip_smoke.py``'s phase 3 (``MapOutputWriter`` and
``ShuffleReader.read_partition`` over 8 maps x 8 partitions of TeraSort
bytes, one thread, CRC32C, a ``file://`` root) once with
``upload_queue_bytes`` at its default (32 MiB: a background thread writes
the data object) and once at 0 (the serial buffered writer of
``buffer_size`` bytes), the order swapping from round to round. With
``--terasort`` each round also runs phase 5a (the TeraSort through
``ShuffleContext.sort_by_key``, 4 worker threads) both ways. Every run
checks its output and launches as ``chip_smoke.py`` does. A phase 3 run of
at most 64 MiB first warms the kernels and caches and is not kept.

Prints each run's lines, then the card's name and power limit, then one
JSON object: per setting and path the seconds of every run and their
median.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile

import chip_smoke

SETTINGS = {"queue": {}, "serial": {"upload_queue_bytes": 0}}


def run(args) -> dict:
    import torch

    from s3shuffle_tpu_torch.device import resolve_device
    from s3shuffle_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("upload_queue_ab: no CUDA device available")
    dev = resolve_device("cuda")
    _build.library()
    part_bytes = args.total_mib * chip_smoke.MiB // (chip_smoke.MAPS * chip_smoke.PARTS)
    data = chip_smoke.make_partitions(args.seed, part_bytes)
    parts = input_rows = None
    if args.terasort:
        parts = chip_smoke.terasort_parts(args.seed, args.total_mib * chip_smoke.MiB)
        input_rows = chip_smoke.sort_rows(chip_smoke.rows_of(parts))
    times = {s: {"write_s": [], "read_s": [], "terasort_s": []} for s in SETTINGS}
    tmp = tempfile.mkdtemp(prefix="upload_queue_ab_")
    try:
        warm = chip_smoke.make_partitions(args.seed, min(part_bytes, chip_smoke.MiB))
        chip_smoke.main_path(warm, dev, os.path.join(tmp, "warm"))
        del warm
        for r in range(args.rounds):
            order = list(SETTINGS) if r % 2 == 0 else list(SETTINGS)[::-1]
            for setting in order:
                knobs = SETTINGS[setting]
                root = os.path.join(tmp, f"{setting}-{r}")
                print(f"== round {r}, {setting}: phase 3")
                _launches, t_write, t_read = chip_smoke.main_path(data, dev, root + "-p3", **knobs)
                times[setting]["write_s"].append(t_write)
                times[setting]["read_s"].append(t_read)
                shutil.rmtree(root + "-p3", ignore_errors=True)
                if args.terasort:
                    print(f"== round {r}, {setting}: phase 5a")
                    _launches, wall, _read = chip_smoke.record_path(
                        f"5a {setting}", parts, input_rows, dev, root + "-5a", bypass=200, **knobs)
                    times[setting]["terasort_s"].append(wall)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for per in times.values():
        for key in list(per):
            if per[key]:
                per[key.replace("_s", "_median_s")] = statistics.median(per[key])
            else:
                del per[key]
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--total-mib", type=int, default=1024)
    ap.add_argument("--terasort", action="store_true")
    args = ap.parse_args(argv)
    times = run(args)
    print(chip_smoke.card_line())
    print(json.dumps({"upload_queue_ab": times, "total_mib": args.total_mib}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
