"""Distributed TeraSort across worker agents over the port (the JAX
package's ``examples/multihost_terasort.py``).

One process drives (metadata service, task queue, input staging); workers
pull tasks from anywhere that reaches the coordinator's address and the
store:

    # coordinator (this module)
    python -m s3shuffle_tpu_torch.examples.multihost_terasort --serve 0.0.0.0:7777 \\
        --size 100m --local-workers 0

    # on each worker host
    S3SHUFFLE_ROOT_DIR=s3://bucket/shuffle/ S3SHUFFLE_APP_ID=multihost-terasort \\
        python -m s3shuffle_tpu_torch.worker --coordinator COORD_HOST:7777

``--local-workers N`` starts N agents on this host instead, each with that
same command (``--device`` passed on), its configuration in ``S3SHUFFLE_*``
variables. With ``S3SHUFFLE_LAUNCHES_DIR`` set, every agent writes its
kernel launches there as it leaves. Prints one JSON line with wall times
and the validation result.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import subprocess
import sys
import tempfile
import time

KEY_BYTES, VALUE_BYTES = 10, 90

#: the repository root, put on the agents' PYTHONPATH
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def start_agents(address, n: int, overrides: dict, device=None) -> list:
    """Start ``n`` local ``python -m s3shuffle_tpu_torch.worker`` agents of
    the coordinator at ``address``, the driver's config ``overrides`` passed
    as ``S3SHUFFLE_*`` variables."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    for key, value in overrides.items():
        env[f"S3SHUFFLE_{key.upper()}"] = str(value)
    cmd = [sys.executable, "-m", "s3shuffle_tpu_torch.worker",
           "--coordinator", f"{address[0]}:{address[1]}", "--poll-interval", "0.02",
           "--metrics-port", "0"]
    if device is not None:
        cmd += ["--device", str(device)]
    return [subprocess.Popen(cmd + ["--worker-id", f"local-{i}"], env=env) for i in range(n)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--serve", default="127.0.0.1:0", help="coordinator bind HOST:PORT")
    ap.add_argument("--size", default="20m", help="total dataset size (e.g. 100m, 1g)")
    ap.add_argument("--maps", type=int, default=8)
    ap.add_argument("--partitions", type=int, default=8)
    ap.add_argument("--root", default=None, help="store root (default: temp dir)")
    ap.add_argument("--codec", default=None,
                    help="codec override (default: S3SHUFFLE_CODEC, else the "
                         "port's default, tpu)")
    ap.add_argument("--local-workers", type=int, default=2,
                    help="start N local worker agents (one-host demo); pass 0 "
                         "to wait for external workers (multi-host mode)")
    ap.add_argument("--device", default=None,
                    help="torch device of the local agents' kernels (default: the "
                         "CUDA device; 'cpu' runs their plain versions)")
    args = ap.parse_args(argv)

    from s3shuffle_tpu_torch.batch import RecordBatch
    from s3shuffle_tpu_torch.cluster import DistributedDriver
    from s3shuffle_tpu_torch.config import ShuffleConfig
    from s3shuffle_tpu_torch.device import resolve_device
    from s3shuffle_tpu_torch.examples import config_codec
    from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
    from s3shuffle_tpu_torch.utils import parse_size

    # the coordinator launches nothing; the device is checked here so that
    # no agent starts where its kernels cannot run
    resolve_device(args.device)
    # S3SHUFFLE_* variables first (how a deployment configures root and
    # codec), the flags over them, a temporary directory for the local demo.
    # The coordinator and every worker must agree on root_dir: all data
    # moves through the store.
    overrides = {"app_id": "multihost-terasort"}
    tmp = None
    if args.root:
        overrides["root_dir"] = args.root
    elif not os.environ.get("S3SHUFFLE_ROOT_DIR"):
        tmp = tempfile.mkdtemp(prefix="s3shuffle-multihost-")
        overrides["root_dir"] = f"file://{tmp}"
    if args.codec:
        overrides["codec"] = config_codec(args.codec)
    host, port = args.serve.rsplit(":", 1)
    Dispatcher.reset()
    cfg = ShuffleConfig.from_env(**overrides)

    n_records = max(args.maps, parse_size(args.size) // (KEY_BYTES + VALUE_BYTES))
    per_map = n_records // args.maps
    rng = random.Random(42)
    fillers = [rng.randbytes(VALUE_BYTES) for _ in range(64)]
    t0 = time.perf_counter()
    batches = [
        RecordBatch.from_records(
            [(rng.randbytes(KEY_BYTES), fillers[rng.randrange(64)]) for _ in range(per_map)]
        )
        for _ in range(args.maps)
    ]
    gen_s = time.perf_counter() - t0

    driver = DistributedDriver(cfg, host=host, port=int(port))
    address = driver.coordinator_address
    print(f"coordinator at {address[0]}:{address[1]}", file=sys.stderr)
    agents = []
    if args.local_workers:
        agents = start_agents(address, args.local_workers, overrides, args.device)
    else:
        print("waiting for external workers (start them with: "
              f"python -m s3shuffle_tpu_torch.worker --coordinator HOST:{address[1]})",
              file=sys.stderr)
    try:
        t0 = time.perf_counter()
        out = driver.run_sort_shuffle(batches, num_partitions=args.partitions)
        shuffle_s = time.perf_counter() - t0

        total = sum(b.n for b in out)
        prev = None
        ordered = True
        for b in out:
            if b.n == 0:
                continue
            sk = b.key_strings(width=KEY_BYTES)
            ordered &= bool((sk[:-1] <= sk[1:]).all())
            if prev is not None:
                ordered &= bool(prev <= sk[0])
            prev = sk[-1]
        raw_bytes = total * (KEY_BYTES + VALUE_BYTES + 8)
        print(json.dumps({
            "workload": "multihost-terasort",
            "records": total,
            "valid": bool(total == args.maps * per_map and ordered),
            "maps": args.maps,
            "partitions": args.partitions,
            "workers": args.local_workers or "external",
            "gen_s": round(gen_s, 2),
            "shuffle_s": round(shuffle_s, 2),
            "mb_per_s": round(raw_bytes / shuffle_s / 1e6, 1),
        }))
        return 0
    finally:
        # drain first: each agent deregisters and exits by itself (a worker
        # still polling when the server stops dies on a connection error).
        # An agent that registers only after a drain request is drained on
        # the next round; one still running at the deadline gets SIGTERM,
        # which drains it too.
        driver.drain_workers()
        deadline = time.monotonic() + 60
        while any(a.poll() is None for a in agents) and time.monotonic() < deadline:
            time.sleep(0.1)
            driver.drain_workers()
        for agent in agents:
            if agent.poll() is None:
                agent.terminate()
                agent.wait(timeout=30)
        driver.shutdown()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    raise SystemExit(main())
