"""The harness: finds a cell's configuration, traffic mix, generator and
metric readers by name, runs its set-up, its measured window and its
check, and builds the result line.

A cell of ``BENCHMARK.json`` joins a configuration
(``portbench/configs/<config>.json``: the deployment, the port's knobs and
the guarantees) and a traffic mix (``portbench/traffic/<traffic>.json``:
the generator it names, ``portbench/generators/<generator>.py``, and its
parameters). Every metric is read by ``portbench/metrics/<metric>.py``,
whose ``read(obs)`` returns a number, or None where it finds nothing to
read; ``obs`` is the dict this module fills.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from portbench import profiling
from portbench.peaks import bandwidth_for
from portbench.reference.sidecars import check_sidecars
from portbench.store import count_store

ROOT = Path(__file__).resolve().parent.parent
#: units whose store objects stay until the window has closed, for the
#: sidecar check: the first, and one more drawn from the seed among the next
#: SIDECAR_DRAW
SIDECAR_DRAW = 3
#: modules whose presence in the process after the window refuses the run,
#: compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "s3shuffle_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` with its configuration, traffic, generator and
    the metric entries that apply to it."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[cell["config"]]["file"])
    traffic = load_json(root / "portbench" / "traffic" / f"{cell['traffic']}.json")
    generator = importlib.import_module(f"portbench.generators.{traffic['generator']}")
    end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in reported else [])]
    return {"cell": cell, "config": config, "traffic": traffic, "generator": generator,
            "end_to_end": end_to_end, "per_layer": per_layer,
            "run_seconds": bench["run_seconds"], "root": root}


def reader(metric: str, root: Path = ROOT):
    """``read`` of ``portbench/metrics/<metric>.py``."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list:
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(FORBIDDEN))


def store_root(cell: str) -> str:
    """The store's root for this cell's runs: a fixed path under the
    run's temporary directory, emptied before and after each run."""
    return os.path.join(tempfile.gettempdir(), "portbench-store", cell)


def run_window(one_unit, seconds: float, clock=time.perf_counter) -> float:
    """Runs ``one_unit(i)`` for i = 0, 1, ... until ``seconds`` have passed
    on ``clock``; the unit in flight then finishes, and the window ends
    with it. Returns the window's length: every unit's work is counted
    over all of it."""
    t0 = clock()
    i = 0
    while True:
        one_unit(i)
        i += 1
        if clock() - t0 >= seconds:
            return clock() - t0


def _sync(dev) -> None:
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)


def run_cell(name: str, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", overrides: dict | None = None, root: Path = ROOT,
             store: str | None = None, log=print) -> dict:
    """One run of the cell ``name``: set-up, the window of ``seconds``, the
    check. Returns the result dict (the last line's keys); ``t_start`` is
    the process's start on the host clock. ``overrides`` replaces keys of
    the configuration (the tests' small sizes); ``device="cpu"`` runs the
    kernels' plain versions (tests only: the command refuses a run without
    a card before it gets here); ``store`` is the store's root directory
    (by default :func:`store_root`)."""
    import torch

    from s3shuffle_tpu_torch import ShuffleConfig, ShuffleContext, ShuffleManager
    from s3shuffle_tpu_torch.device import resolve_device
    from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher

    spec = load_cell(name, root)
    config = dict(spec["config"], **(overrides or {}))
    traffic, gen = spec["traffic"], spec["generator"]
    readers = {m["name"]: reader(m["name"], root)
               for m in (spec["per_layer"] if trace else spec["end_to_end"])}
    dev = resolve_device(device)
    # the executor's cores bound the process's own compute threads, as its
    # container would
    torch.set_num_threads(config["executor_cores"])
    rng = np.random.default_rng(seed)
    kept_units = {0, int(rng.integers(1, SIDECAR_DRAW + 1))}

    inputs = gen.make_inputs(config, traffic, seed)
    work = gen.unit_work(config, traffic, inputs)
    store = store or store_root(name)
    shutil.rmtree(store, ignore_errors=True)
    os.makedirs(store)
    Dispatcher.reset()
    cfg = ShuffleConfig(root_dir=f"file://{store}", app_id=f"portbench-{name}",
                        **config["knobs"])
    manager = ShuffleManager(cfg, device=dev)
    counting = count_store(manager.dispatcher, frames=trace)
    ctx = ShuffleContext(manager=manager, num_workers=config["task_threads"])

    state = {"keep": False, "deferred": [], "readers": [], "wait_ns": 0}
    unregister = manager.unregister_shuffle

    def deferring_unregister(shuffle_id):
        if state["keep"]:
            state["deferred"].append(shuffle_id)
        else:
            unregister(shuffle_id)

    manager.unregister_shuffle = deferring_unregister
    get_reader = manager.get_reader

    def tracked_reader(*args, **kwargs):
        r = get_reader(*args, **kwargs)
        state["readers"].append(r)
        return r

    if trace:
        manager.get_reader = tracked_reader
    created_total = 0
    try:
        # warm-up: one unit of the cell's own shape (a failure is counted
        # as the window's are)
        warmup_failed = 0
        try:
            gen.run_unit(ctx, config, traffic, inputs)
            _sync(dev)
        except Exception as e:
            warmup_failed = 1
            log(f"warm-up unit failed: {e!r}", file=sys.stderr)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        created_total += sum(counting.created_bytes.values())
        counting.reset()
        state["readers"].clear()
        manager.codec.timings = {} if trace else None
        answers, failures, unit_s = [], [], []
        setup_s = time.perf_counter() - t_start
        with profiling.profiled(trace) as prof:
            from torch.profiler import record_function

            def one_unit(i):
                state["keep"] = i in kept_units
                t_unit = time.perf_counter()
                try:
                    with record_function(f"portbench.{name}"):
                        answers.append(gen.run_unit(ctx, config, traffic, inputs))
                        _sync(dev)
                except Exception as e:  # a unit that fails is counted, and the window goes on
                    failures.append(repr(e))
                    log(f"unit {i} failed: {e!r}", file=sys.stderr)
                unit_s.append(time.perf_counter() - t_unit)
                state["wait_ns"] += sum(r.metrics.wait_ns for r in state["readers"])
                state["readers"].clear()

            with record_function(profiling.WINDOW_SPAN):
                window_s = run_window(one_unit, seconds)
        state["keep"] = False
        units = len(answers)
        memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        t_read = time.perf_counter()
        traced = profiling.read_trace(prof) if trace else None
        if traced is not None:
            log(f"trace: {traced['kernels']} kernel intervals read in "
                f"{time.perf_counter() - t_read:.1f} s")
        timings = dict(manager.codec.timings or {})
        requests = counting.requests()
        created = sum(counting.created_bytes.values())
        created_total += created
        obs = {
            "setup_s": setup_s, "window_s": window_s, "units": units,
            "user_bytes": units * work["user_bytes"],
            "created_bytes": created, "requests": requests,
            "data_gets": counting.gets["data"],
            "read_wait_ns": state["wait_ns"], "codec_timings": timings,
            "frame_bytes": dict(counting.frame_bytes), "trace": traced,
            "bandwidth": bandwidth_for(torch.cuda.get_device_name(dev))
            if dev.type == "cuda" else None,
        }
        sidecars = check_sidecars(store, state["deferred"])
        for shuffle_id in state["deferred"]:
            unregister(shuffle_id)
        objects_left = sum(len(files) for _d, _s, files in os.walk(store))
    finally:
        ctx.stop()
        shutil.rmtree(store, ignore_errors=True)
    log(f"store: {created_total} bytes created during the run (warm-up included), "
        f"{created} in the window; {requests} requests in the window")
    log(f"units (s): {' '.join(f'{t:.3f}' for t in unit_s)}")
    log(f"window: {units} units in {window_s:.3f} s, {len(failures)} failed; "
        f"sidecars checked: {sidecars['maps']} map outputs, {sidecars['entries']} "
        f"partition CRCs")
    checks = {
        "units_failed": {"value": len(failures) + warmup_failed, "limit": 0},
        "rows_wrong": {"value": gen.judge(config, traffic, inputs, answers), "limit": 0},
        "crc_wrong": {"value": sidecars["wrong"], "limit": 0},
        "objects_left": {"value": objects_left, "limit": 0},
    }
    correct = units > 0 and all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    for m in (spec["per_layer"] if trace else spec["end_to_end"]):
        value = readers[m["name"]](obs)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": units + len(failures), "failed": len(failures),
              "metrics": metrics}
    result["device"] = {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": 1, "memory_peak_bytes": memory_peak,
    }
    if traced is not None:
        result["device"].update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        result["breakdown"] = traced["breakdown"]
    result["checks"] = checks
    return result
