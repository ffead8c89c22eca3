"""The control of a cell: the plain reference put in the program's place
with one guarantee of the configuration broken, at the cell's own size,
judged by the comparison that decides ``correct``. It must come out wrong
on every seed:

    python3 -m portbench.control --workload <cell> --seeds 11 12 13

Prints, per seed, the rows wrong of one control unit (limit 0). The
benchmark's runs do not run it; it needs no card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import harness


def control_reading(name: str, seed: int, overrides: dict | None = None,
                    root=harness.ROOT) -> int:
    """Rows wrong of the control's answer for ``seed``."""
    spec = harness.load_cell(name, root)
    config = dict(spec["config"], **(overrides or {}))
    gen, traffic = spec["generator"], spec["traffic"]
    inputs = gen.make_inputs(config, traffic, seed)
    return gen.judge(config, traffic, inputs, [gen.control(config, traffic, inputs)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    readings = {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        readings[seed] = control_reading(args.workload, seed)
        print(f"control {args.workload} seed {seed}: rows_wrong {readings[seed]} limit 0 "
              f"({time.perf_counter() - t0:.1f} s)", file=sys.stderr)
    print(json.dumps({"workload": args.workload, "control_rows_wrong": readings}))
    return 0 if all(v > 0 for v in readings.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
