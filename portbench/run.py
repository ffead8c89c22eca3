"""One run of one cell of ``BENCHMARK.json`` on the card:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (inputs from the seed, one ``ShuffleManager`` / ``ShuffleContext``
for the run, one warm-up unit), then units back to back until ``--seconds``
have passed (the unit in flight finishes; the window ends with it), then
the check against the plain reference. The last line of standard output is
the result as one JSON object; the numbers compared, each beside its
limit, are the last lines of standard error. Before anything else starts a
thread, the process binds itself to the first ``executor_cores`` CPUs it
may run on (the configuration's executor, as its container would hold
it). With ``--trace 1`` the window
runs under ``torch.profiler`` and the metrics are the cell's per-layer
ones. Without a CUDA device, or with fewer than the cell asks for, it
exits 2 and prints no result; with ``jax``, ``jaxlib``, ``flax`` or
``s3shuffle_tpu`` loaded after the window, it exits 3 and prints none.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def bind_executor_cpus(workload: str, root: Path = ROOT) -> list:
    """Binds the process to the first ``executor_cores`` of the CPUs it may
    run on, before numpy or torch start their threads, which inherit it.
    Returns the CPUs, or [] where the cell is not found (the harness then
    names the fault)."""
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        return []
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(root / entry["file"]) as f:
        cores = json.load(f)["executor_cores"]
    cpus = sorted(os.sched_getaffinity(0))[:cores]
    os.sched_setaffinity(0, cpus)
    return cpus


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bind_executor_cpus(args.workload)
    from portbench import harness

    spec = harness.load_cell(args.workload)
    import torch

    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell asks for {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: the process loaded {', '.join(loaded)}; no result",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']} limit {check['limit']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
