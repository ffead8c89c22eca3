"""Each cell's run at a small size on the CPU (the kernels' plain
versions): correct against the plain reference, the result's keys, and the
command's refusal without a card."""

import json
import os
import time

import numpy as np
import pytest

from portbench import harness
from portbench.tests.small import CELLS, SMALL

SEED = 2**31 + 977  # more than 32 signed bits hold


def _store():
    import tempfile

    return tempfile.mkdtemp(prefix="portbench-test-store-")


def run(cell, trace=False, seconds=0.5, seed=SEED, **kw):
    return harness.run_cell(cell, seed, seconds, trace, time.perf_counter(), device="cpu",
                            overrides=SMALL[cell], store=_store(), log=lambda *a, **k: None, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_a_small_run_of_each_cell_is_correct(cell):
    result = run(cell)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert all(c["value"] == 0 and c["limit"] == 0 for c in result["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_result_has_the_contract_keys_and_the_checks_last(cell):
    spec = harness.load_cell(cell)
    result = run(cell)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(result["metrics"]) == {m["name"] for m in spec["end_to_end"]}
    for name, metric in result["metrics"].items():
        assert metric["value"] > 0, name
    json.dumps(result)


def test_a_traced_run_reports_the_window_and_a_breakdown():
    result = run("terasort-256m", trace=True)
    assert result["correct"] is True
    assert list(result)[-1] == "checks"
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_same_seed_same_inputs_other_seed_other_inputs():
    spec = harness.load_cell("terasort-256m")
    config = dict(spec["config"], **SMALL["terasort-256m"])
    gen = spec["generator"]
    a, b, c = (gen.make_inputs(config, spec["traffic"], s)["rows"] for s in (SEED, SEED, 5))
    assert (a == b).all() and not (a == c).all()


def test_the_command_refuses_a_machine_without_a_card(capsys):
    import torch

    from portbench import run as command

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    cpus = os.sched_getaffinity(0)
    try:
        assert command.main(["--workload", "terasort-256m", "--seed", "1", "--seconds", "1"]) == 2
    finally:
        os.sched_setaffinity(0, cpus)
    assert capsys.readouterr().out == ""


def test_a_traced_sort_run_reads_all_but_the_roofline_on_the_cpu():
    spec = harness.load_cell("terasort-256m")
    result = run("terasort-256m", trace=True)
    assert result["correct"] is True
    # the CPU is no card: the roofline reads nothing, the rest read
    assert set(result["metrics"]) == {m["name"] for m in spec["per_layer"]} - \
        {"codec_roofline.sort"}


def test_the_records_are_in_gensort_layout():
    from portbench.generators.terasort import gensort_records, make_terasort

    rows = gensort_records(0x12345, 4, np.random.default_rng(SEED))
    for i, row in enumerate(rows):
        rec = bytes(row)
        assert rec[10:12] == b"\x00\x11" and rec[44:48] == b"\x88\x99\xaa\xbb"
        assert rec[96:] == b"\xcc\xdd\xee\xff"
        assert rec[12:44] == f"{0x12345 + i:032X}".encode()
        filler = rec[48:96]
        digits = filler[::4]
        assert all(filler[4 * j: 4 * j + 4] == bytes([d]) * 4 for j, d in enumerate(digits))
        assert set(digits) <= set(b"0123456789ABCDEF")
    maps = make_terasort(2 * 100 * 5, 2, SEED)
    numbers = [int(bytes(r[12:44]), 16) for m in maps for r in m]
    assert numbers == list(range(10))


def test_the_command_binds_its_process_to_the_executors_cpus():
    import subprocess
    import sys

    code = ("import os; from portbench import run; cpus = run.bind_executor_cpus('terasort-256m');"
            " print(len(cpus), sorted(os.sched_getaffinity(0)) == cpus)")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, check=True,
                         capture_output=True, text=True).stdout.split()
    assert out == [str(min(4, len(os.sched_getaffinity(0)))), "True"]
