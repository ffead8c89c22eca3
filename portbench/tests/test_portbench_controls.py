"""The controls (the plain reference in the program's place with one
guarantee broken) come out wrong, and the faults planted beneath a run's
timed path make ``correct`` false."""

import time

import numpy as np
import pytest

from portbench import control, harness
from portbench.tests.small import CELLS, SMALL


@pytest.mark.parametrize("cell,overrides", [
    # a 32-bit sort key errs once millions of random keys share their first
    # four bytes: 1,000,000 records, about 116 such pairs
    ("terasort-256m", {"job_bytes": 100_000_000}),
])
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_the_control_comes_out_wrong(cell, overrides, seed):
    assert control.control_reading(cell, seed, overrides) > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_reference_judges_its_own_answer_right(cell):
    spec = harness.load_cell(cell)
    config = dict(spec["config"], **SMALL[cell])
    gen, traffic = spec["generator"], spec["traffic"]
    inputs = gen.make_inputs(config, traffic, 3)
    rows = np.array_split(inputs["rows"][np.lexsort(inputs["rows"][:, ::-1].T)],
                          config["reducers"])
    answer = [[(p[:, :10], p[:, 10:])] for p in rows]
    assert gen.judge(config, traffic, inputs, [answer, answer]) == 0


def _store():
    import tempfile

    return tempfile.mkdtemp(prefix="portbench-test-store-")


def run(cell):
    return harness.run_cell(cell, 21, 0.2, False, time.perf_counter(), device="cpu",
                            overrides=SMALL[cell], store=_store(), log=lambda *a, **k: None)


def _every_other_partition_emptied(real):
    def run_shuffle(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        return [[] if i % 2 else part for i, part in enumerate(out)]
    return run_shuffle


def _input_returned_unchanged(real):
    def run_shuffle(self, input_partitions, *args, **kwargs):
        real(self, input_partitions, *args, **kwargs)
        return [[p] for p in input_partitions]
    return run_shuffle


def _one_value_altered(real):
    def run_shuffle(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        for part in out:
            for b in part:
                if b.n:
                    b.values[0] ^= 1
                    return out
        return out
    return run_shuffle


FAULTS = {
    "half of the output left out": _every_other_partition_emptied,
    "the input returned unchanged": _input_returned_unchanged,
    "an answer altered where it is produced": _one_value_altered,
}


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_in_the_timed_path_makes_the_run_incorrect(cell, fault, monkeypatch):
    from s3shuffle_tpu_torch.shuffle import ShuffleContext

    monkeypatch.setattr(ShuffleContext, "run_shuffle", FAULTS[fault](ShuffleContext.run_shuffle))
    result = run(cell)
    assert result["correct"] is False
    assert result["checks"]["rows_wrong"]["value"] > 0 or result["failed"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_an_altered_checksum_sidecar_makes_the_run_incorrect(cell, monkeypatch):
    from s3shuffle_tpu_torch.metadata.helper import ShuffleHelper

    real = ShuffleHelper.write_checksums

    def write_checksums(self, shuffle_id, map_id, checksums):
        altered = np.array(checksums, dtype=np.int64)
        altered[0] ^= 1
        return real(self, shuffle_id, map_id, altered)

    monkeypatch.setattr(ShuffleHelper, "write_checksums", write_checksums)
    result = run(cell)
    assert result["correct"] is False
    # the port's reader validates the sidecar too and fails the unit
    assert result["checks"]["crc_wrong"]["value"] > 0 or \
        result["checks"]["units_failed"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_objects_left_behind_make_the_run_incorrect(cell, monkeypatch):
    from s3shuffle_tpu_torch.manager import ShuffleManager

    monkeypatch.setattr(ShuffleManager, "unregister_shuffle", lambda self, shuffle_id: None)
    result = run(cell)
    assert result["correct"] is False
    assert result["checks"]["objects_left"]["value"] > 0
