"""A configuration, a traffic mix and a metric are added as new files and
entries, in a temporary copy of the benchmark, and the harness finds them
by name: no file that was there is edited."""

import hashlib
import json
import shutil
import time
from pathlib import Path

from portbench import harness
from portbench.tests.small import SMALL_KNOBS

REPO = harness.ROOT


def _store():
    import tempfile

    return tempfile.mkdtemp(prefix="portbench-test-store-")


def digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "portbench").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts} | {
        "BENCHMARK.json": hashlib.sha256((root / "BENCHMARK.json").read_bytes()).hexdigest()}


def test_a_config_a_mix_and_a_metric_added_as_files_are_found_by_name(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(tmp_path)
    # the new files
    config = json.loads((tmp_path / "portbench/configs/terasort-1g-4exec.json").read_text())
    config.update(name="terasort-1g-4exec-16red", reducers=16, job_bytes=200_000,
                  knobs=SMALL_KNOBS)
    (tmp_path / "portbench/configs/terasort-1g-4exec-16red.json").write_text(json.dumps(config))
    (tmp_path / "portbench/traffic/terasort-closed-16red.json").write_text(json.dumps(
        {"generator": "terasort", "description": "the same jobs, 16 reduce partitions"}))
    (tmp_path / "portbench/metrics/data_gets_per_job.py").write_text(
        "def read(obs):\n    return obs['data_gets'] / obs['units'] if obs['units'] else None\n")
    # the new entries
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "terasort-1g-4exec-16red", "source": "https://x",
                             "file": "portbench/configs/terasort-1g-4exec-16red.json",
                             "reduced": [], "why": "16 reducers"})
    bench["workloads"].append({"name": "terasort-16red", "config": "terasort-1g-4exec-16red",
                               "traffic": "terasort-closed-16red", "chips": 1, "why": "16"})
    bench["per_layer"].append({"name": "data_gets_per_job", "unit": "req", "better": "lower",
                               "source": "program_counter", "layer": "read plane",
                               "moves": "store_req_per_gib",
                               "workloads": ["terasort-16red"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before and k != "BENCHMARK.json"} == \
        {k: v for k, v in before.items() if k != "BENCHMARK.json"}

    spec = harness.load_cell("terasort-16red", tmp_path)
    assert spec["config"]["reducers"] == 16
    assert spec["traffic"]["description"].endswith("16 reduce partitions")
    assert [m["name"] for m in spec["per_layer"]] == ["data_gets_per_job"]
    result = harness.run_cell("terasort-16red", 7, 0.2, True, time.perf_counter(),
                              device="cpu", root=tmp_path, store=_store(), log=lambda *a, **k: None)
    assert result["correct"] is True, result["checks"]
    assert result["metrics"]["data_gets_per_job"]["value"] > 0
    result = harness.run_cell("terasort-16red", 7, 0.2, False, time.perf_counter(),
                              device="cpu", root=tmp_path, store=_store(), log=lambda *a, **k: None)
    # shuffle_mib_s lists its cells; the new one is not among them
    assert {"stored_ratio", "store_req_per_gib", "setup_s"} == set(result["metrics"])
