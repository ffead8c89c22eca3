"""Mesh-routed shuffle landing in the store over the port (the JAX package's
``examples/ici_to_store.py``).

Routes a TeraSort-shaped dataset to its owner devices with one exchange
over a ``parallel.make_mesh`` mesh (peer copies between the lanes), then
commits each device's partitions through the ordinary write plane and
validates by reading every partition back with the standard read plane:
collectives where durability is not wanted, the store where it is (see
``s3shuffle_tpu_torch/parallel/ici_shuffle.py``).

    python -m s3shuffle_tpu_torch.examples.ici_to_store --devices 8 --size 20m --partitions 16

``--devices N`` takes the first N local devices of the ``--device`` type
(``parallel.dispatch.local_devices``) and raises when fewer are present:
it never shrinks N. With ``--device cpu`` the mesh repeats the CPU N times
(the lanes the port's tests run on). The config comes from ``S3SHUFFLE_*``
variables, the flags over them. Prints one JSON line: routing/write and
read wall times and the validation result.
"""

from __future__ import annotations

import argparse
import collections
import json
import random
import shutil
import sys
import tempfile
import time

KEY_BYTES, VALUE_BYTES = 10, 90


def mesh_devices(device, n: int) -> list:
    """The first ``n`` local devices of ``device``'s type: ``n`` repeats of
    the CPU, or the first ``n`` CUDA devices (raising when fewer exist)."""
    from s3shuffle_tpu_torch.parallel import dispatch

    if device.type == "cpu":
        return [device] * n
    devices = dispatch.local_devices(device.type)
    if len(devices) < n:
        raise RuntimeError(f"--devices {n} asks for {n} {device.type} devices; "
                           f"{len(devices)} are present")
    return devices[:n]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--size", default="20m")
    ap.add_argument("--partitions", type=int, default=16)
    ap.add_argument("--codec", default="auto")
    ap.add_argument("--root", default=None)
    ap.add_argument("--device", default=None,
                    help="device type of the mesh and the kernels (default: CUDA; "
                         "'cpu' runs the plain versions on repeated CPU lanes)")
    args = ap.parse_args(argv)

    from s3shuffle_tpu_torch.batch import RecordBatch
    from s3shuffle_tpu_torch.config import ShuffleConfig
    from s3shuffle_tpu_torch.dependency import HashPartitioner
    from s3shuffle_tpu_torch.device import resolve_device
    from s3shuffle_tpu_torch.examples import config_codec
    from s3shuffle_tpu_torch.manager import ShuffleManager
    from s3shuffle_tpu_torch.parallel import make_mesh, mesh_shuffle_to_store
    from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
    from s3shuffle_tpu_torch.utils import parse_size

    dev = resolve_device(args.device)
    n_dev = args.devices
    mesh = make_mesh({"data": n_dev}, devices=mesh_devices(dev, n_dev))

    n_records = max(n_dev, parse_size(args.size) // (KEY_BYTES + VALUE_BYTES))
    per_dev = n_records // n_dev
    rng = random.Random(42)
    fillers = [rng.randbytes(VALUE_BYTES) for _ in range(64)]
    batches = [
        RecordBatch.from_records(
            [(rng.randbytes(KEY_BYTES), fillers[rng.randrange(64)])
             for _ in range(per_dev)]
        )
        for _ in range(n_dev)
    ]

    root = args.root or tempfile.mkdtemp(prefix="s3shuffle-ici-")
    Dispatcher.reset()
    manager = ShuffleManager(
        ShuffleConfig.from_env(root_dir=f"file://{root}", app_id="ici-demo",
                               codec=config_codec(args.codec)),
        device=dev,
    )
    partitioner = HashPartitioner(args.partitions)
    try:
        t0 = time.perf_counter()
        handle, per_dev_rows = mesh_shuffle_to_store(
            mesh, batches, manager, partitioner,
            key_bytes=KEY_BYTES, value_bytes=VALUE_BYTES,
        )
        route_write_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        got = collections.Counter()
        for p in range(args.partitions):
            got.update(manager.get_reader(handle, p, p + 1).read())
        read_s = time.perf_counter() - t0
        expected = collections.Counter(
            kv for b in batches for kv in b.iter_records()
        )
        raw = n_dev * per_dev * (KEY_BYTES + VALUE_BYTES + 8)
        print(json.dumps({
            "workload": "ici-to-store",
            "devices": n_dev,
            "records": sum(per_dev_rows),
            "valid": got == expected,
            "route_write_s": round(route_write_s, 3),
            "read_s": round(read_s, 3),
            "mb_s_route_write": round(raw / route_write_s / 1e6, 1),
        }))
        manager.unregister_shuffle(handle.shuffle_id)
        manager.stop()
        return 0 if got == expected else 1
    finally:
        if args.root is None:
            shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
