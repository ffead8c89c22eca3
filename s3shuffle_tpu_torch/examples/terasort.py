"""TeraSort over the port (the JAX package's ``examples/terasort.py``): the
framework analog of the reference's ``examples/terasort/run.sh``
(spark-submit of ehiggs/spark-terasort + TeraValidate against an S3A root).

Generates TeraSort-shaped records (10-byte keys, 90-byte values), runs a
range-partitioned key-ordered shuffle (``ShuffleContext.sort_by_key``)
through the full write and read planes against any storage root (file://,
memory://, s3:// via fsspec), then validates global order and record count
(the TeraValidate step).

Usage:
    python -m s3shuffle_tpu_torch.examples.terasort --size 1g --workers 8 --codec tpu
    python -m s3shuffle_tpu_torch.examples.terasort --size 2m --codec zlib --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

from s3shuffle_tpu_torch.examples import card_fields, config_codec

KEY_BYTES, VALUE_BYTES = 10, 90  # the terasort record shape


def generate(total_bytes: int, n_maps: int, seed: int = 42):
    """TeraSort input: random 10-byte keys, semi-compressible 90-byte values
    (drawn from a small pool, like text-like real data). Partitions are
    columnar RecordBatches built vectorized."""
    import numpy as np

    from s3shuffle_tpu_torch.batch import RecordBatch

    per_map = total_bytes // (KEY_BYTES + VALUE_BYTES) // n_maps
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (64, VALUE_BYTES), dtype=np.uint8)
    parts = []
    for _ in range(n_maps):
        keys = rng.integers(0, 256, (per_map, KEY_BYTES), dtype=np.uint8)
        values = pool[rng.integers(0, 64, per_map)]
        parts.append(RecordBatch(
            np.full(per_map, KEY_BYTES, np.int32),
            np.full(per_map, VALUE_BYTES, np.int32),
            np.ascontiguousarray(keys).reshape(-1),
            np.ascontiguousarray(values).reshape(-1),
        ))
    return parts


def teravalidate(out_batches, expected_records: int) -> None:
    """Global-order + count validation (the reference's TeraValidate step)."""
    from s3shuffle_tpu_torch.batch import RecordBatch

    merged = [RecordBatch.concat(p) for p in out_batches]
    n = sum(b.n for b in merged)
    assert n == expected_records, f"record count {n} != {expected_records}"
    prev_last = None
    for b in merged:
        if b.n == 0:
            continue
        sk = b.key_strings(width=KEY_BYTES)
        assert (sk[:-1] <= sk[1:]).all(), "order violated within partition"
        if prev_last is not None:
            assert prev_last <= sk[0], "order violated across partitions"
        prev_last = sk[-1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", default="100m", help="bytes, with optional k/m/g suffix")
    ap.add_argument("--maps", type=int, default=8)
    ap.add_argument("--reducers", type=int, default=8)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--codec", default="native",
                    help="none | zlib | zstd | native | lz4 | auto | tpu")
    ap.add_argument("--checksum", default="CRC32C", help="ADLER32|CRC32|CRC32C|off")
    ap.add_argument("--root", default=None, help="storage root URI (default: temp dir)")
    ap.add_argument("--block-size", type=int, default=None, help="codec block size")
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device of the kernels (default: the CUDA device; "
                         "'cpu' runs their plain versions)")
    args = ap.parse_args(argv)

    from s3shuffle_tpu_torch.config import ShuffleConfig
    from s3shuffle_tpu_torch.device import resolve_device
    from s3shuffle_tpu_torch.serializer import ColumnarKVSerializer
    from s3shuffle_tpu_torch.shuffle import ShuffleContext
    from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
    from s3shuffle_tpu_torch.utils import parse_size

    dev = resolve_device(args.device)
    cfg_codec = config_codec(args.codec)
    total_bytes = parse_size(args.size)
    tmp = None
    root = args.root
    if root is None:
        tmp = tempfile.mkdtemp(prefix="terasort-")
        root = f"file://{tmp}"

    print(f"generating {total_bytes / 1e6:.0f} MB over {args.maps} map partitions...",
          file=sys.stderr)
    parts = generate(total_bytes, args.maps)
    n_records = sum(p.n for p in parts)

    results = []
    try:
        for rep in range(args.repeat):
            Dispatcher.reset()
            checksum_on = args.checksum.lower() != "off"
            cfg = ShuffleConfig(
                root_dir=root,
                app_id=f"terasort-{rep}",
                codec=cfg_codec,
                codec_block_size=args.block_size,
                checksum_enabled=checksum_on,
                checksum_algorithm=args.checksum if checksum_on else "ADLER32",
            )
            ctx = ShuffleContext(config=cfg, num_workers=args.workers, device=dev)
            cpu0 = time.process_time()
            t0 = time.perf_counter()
            out = ctx.sort_by_key(
                parts,
                num_partitions=args.reducers,
                serializer=ColumnarKVSerializer(),
                materialize="batches",
            )
            dt = time.perf_counter() - t0
            cpu = time.process_time() - cpu0
            teravalidate(out, n_records)
            ctx.stop()
            raw = n_records * (KEY_BYTES + VALUE_BYTES)
            results.append({
                "rep": rep,
                "wall_s": round(dt, 3),
                "records": n_records,
                "records_per_s": round(n_records / dt),
                "mb": round(raw / 1e6, 1),
                "mb_per_s": round(raw / 1e6 / dt, 1),
                # the task threads run in this process: its CPU time covers
                # them all; cpu_utilization = cpu / wall (<= cores)
                "process_cpu_s": round(cpu, 3),
                "cpu_utilization": round(cpu / dt, 2),
            })
            print(json.dumps(results[-1]), file=sys.stderr)
    finally:
        if tmp:
            shutil.rmtree(tmp, ignore_errors=True)

    rates = sorted(r["mb_per_s"] for r in results)
    median = rates[len(rates) // 2] if len(rates) % 2 else round(
        (rates[len(rates) // 2 - 1] + rates[len(rates) // 2]) / 2, 1
    )
    print(json.dumps({
        "bench": "terasort",
        "size": args.size,
        "codec": args.codec,
        "checksum": args.checksum,
        "workers": args.workers,
        # the median is the headline; best/min show the spread
        "median_mb_per_s": median,
        "best_mb_per_s": rates[-1],
        "min_mb_per_s": rates[0],
        "host_cores": os.cpu_count() or 1,
        **card_fields(dev),
        "runs": results,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
