"""Query-shaped shuffles over the port (the JAX package's
``examples/query_shuffles.py``): the framework analog of the reference's
TPC-DS harness (``examples/sql/run_benchmark.sh``, queries
q5/q49/q75/q67).

What the shuffle plugin sees of a query is its shuffle profile: total
shuffle volume, key cardinality, record size, and whether the stage
aggregates or sorts. These profiles (volumes from the reference's
``examples/run_tests.sh``, scaled down by ``--scale``) let shuffle-layer
changes be compared on workloads of the reference's shapes without a Spark
cluster:

  q5-like   aggregation-heavy, mid cardinality    (SF1000: 9.6 GB)
  q49-like  small shuffle, high fan-in            (SF1000: 1.1 GB)
  q75-like  wide join keys, large records         (SF1000: 20 GB)
  q67-like  rank/sort over big groups (the whale) (SF1000: 66 GB)

Usage:
    python -m s3shuffle_tpu_torch.examples.query_shuffles --query q5 --scale 1000   # == SF1
    python -m s3shuffle_tpu_torch.examples.query_shuffles --query all --scale 100 --codec tpu
"""

from __future__ import annotations

import argparse
import json
import random
import shutil
import sys
import tempfile
import time

# (volume @ SF1000 in bytes, record bytes, key bytes, distinct-key divisor, op)
PROFILES = {
    "q5": (9_600_000_000, 96, 12, 1_000, "aggregate"),
    "q49": (1_100_000_000, 72, 16, 10_000, "aggregate"),
    "q75": (20_000_000_000, 160, 24, 500, "aggregate"),
    "q67": (66_000_000_000, 120, 20, 100, "sort"),
}


def run_query(name: str, scale: float, codec: str, workers: int, maps: int,
              reducers: int, root: str, device=None) -> dict:
    from s3shuffle_tpu_torch.config import ShuffleConfig
    from s3shuffle_tpu_torch.serializer import ColumnarKVSerializer
    from s3shuffle_tpu_torch.shuffle import ShuffleContext
    from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher

    volume, rec_bytes, key_bytes, key_div, op = PROFILES[name]
    volume = int(volume / scale)
    n_records = max(1, volume // rec_bytes)
    per_map = max(1, n_records // maps)
    n_keys = max(1, n_records // key_div)
    val_bytes = rec_bytes - key_bytes

    rng = random.Random(hash(name) & 0xFFFF)
    filler = [rng.randbytes(val_bytes) for _ in range(64)]
    key_pool = [rng.randrange(10**9).to_bytes(8, "big").rjust(key_bytes, b"0")
                for _ in range(min(n_keys, 1_000_000))]
    parts = [
        [(key_pool[rng.randrange(len(key_pool))], filler[rng.randrange(64)])
         for _ in range(per_map)]
        for _ in range(maps)
    ]

    Dispatcher.reset()
    cfg = ShuffleConfig(root_dir=root, app_id=f"tpcds-{name}", codec=codec,
                        checksum_algorithm="CRC32C" if codec in ("native", "tpu") else "ADLER32")
    ctx = ShuffleContext(config=cfg, num_workers=workers, device=device)
    t0 = time.perf_counter()
    if op == "sort":
        out = ctx.sort_by_key(parts, num_partitions=reducers,
                              serializer=ColumnarKVSerializer(), materialize="batches")
        n_out = sum(b.n for p in out for b in p)
    else:
        # aggregation profile: count per key (the shuffle sees the bytes a
        # hash-aggregate exchange would)
        out = ctx.fold_by_key(
            [[(k, 1) for k, _v in p] for p in parts], 0, lambda a, b: a + b,
            num_partitions=reducers)
        n_out = len(out)
    dt = time.perf_counter() - t0
    ctx.stop()
    shuffled = per_map * maps * rec_bytes
    return {
        "query": name, "op": op, "records": per_map * maps, "out_records": n_out,
        "mb": round(shuffled / 1e6, 1), "wall_s": round(dt, 3),
        "mb_per_s": round(shuffled / 1e6 / dt, 1),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--query", default="all", choices=[*PROFILES, "all"])
    ap.add_argument("--scale", type=float, default=1000.0,
                    help="divide SF1000 volumes by this (1000 == SF1)")
    ap.add_argument("--codec", default="native")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--maps", type=int, default=8)
    ap.add_argument("--reducers", type=int, default=8)
    ap.add_argument("--root", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device of the kernels (default: the CUDA device; "
                         "'cpu' runs their plain versions)")
    args = ap.parse_args(argv)

    from s3shuffle_tpu_torch.device import resolve_device
    from s3shuffle_tpu_torch.examples import config_codec

    dev = resolve_device(args.device)
    codec = config_codec(args.codec)
    tmp = None
    root = args.root
    if root is None:
        tmp = tempfile.mkdtemp(prefix="query-shuffles-")
        root = f"file://{tmp}"
    queries = list(PROFILES) if args.query == "all" else [args.query]
    results = []
    try:
        for q in queries:
            r = run_query(q, args.scale, codec, args.workers, args.maps, args.reducers,
                          root, device=dev)
            results.append(r)
            print(json.dumps(r), file=sys.stderr)
    finally:
        if tmp:
            shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"bench": "query_shuffles", "scale": args.scale,
                      "codec": args.codec, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
