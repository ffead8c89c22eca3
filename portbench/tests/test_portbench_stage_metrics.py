"""The readers of the program's stage spans (the codec's ``timings`` keys
that ``utils.trace.stage`` fills) on hand-made observations: seconds per
user GiB, and nothing where a run has no such key (a program without the
spans, or an untraced run)."""

import json

import pytest

from portbench import harness
from portbench.harness import reader

GiB = 1 << 30
STAGE_METRICS = {
    "map_stage_s_per_gib.sort": ("map_stage_s",),
    "reduce_stage_s_per_gib.sort": ("reduce_stage_s",),
    "record_host_s_per_gib.sort": ("record_host_s",),
    "decode_validate_s_per_gib.sort": ("decode_validate_s",),
    "codec_crc_host_s_per_gib.sort": ("crc_host_s",),
    "device_wait_s_per_gib.sort": ("encode_device_wait_s", "decode_device_wait_s"),
}


def obs(timings, user_bytes=2 * GiB):
    return {"setup_s": 10.0, "window_s": 50.0, "units": 8, "user_bytes": user_bytes,
            "created_bytes": 0, "requests": 0, "read_wait_ns": 0, "data_gets": 0,
            "codec_timings": timings, "frame_bytes": {}, "trace": None, "bandwidth": None}


@pytest.mark.parametrize("name", sorted(STAGE_METRICS))
def test_each_stage_reader_is_its_seconds_per_user_gib(name):
    keys = STAGE_METRICS[name]
    timings = {k: 3.0 + i for i, k in enumerate(keys)}
    # keys the reader does not read leave it unmoved
    timings.update(other_s=100.0, encode_device_s=50.0)
    want = sum(3.0 + i for i in range(len(keys))) / 2
    assert reader(name)(obs(timings)) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(STAGE_METRICS))
def test_a_stage_reader_reads_nothing_without_its_keys(name):
    assert reader(name)(obs({})) is None
    # the parent's keys alone: a program without the stage spans
    parent = {"encode_assembly_s": 1.0, "decode_parse_s": 2.0, "decode_emit_s": 0.5,
              "encode_device_s": 4.0, "decode_device_s": 3.0}
    assert reader(name)(obs(parent)) is None
    keys = STAGE_METRICS[name]
    assert reader(name)(obs({k: 1.0 for k in keys}, user_bytes=0)) is None


def test_device_wait_reads_either_side_alone():
    read = reader("device_wait_s_per_gib.sort")
    assert read(obs({"encode_device_wait_s": 1.0})) == pytest.approx(0.5)
    assert read(obs({"decode_device_wait_s": 3.0})) == pytest.approx(1.5)


def test_the_stage_metrics_are_entries_of_the_sort_cell():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in STAGE_METRICS:
        m = entries[name]
        assert (m["unit"], m["better"], m["source"], m["moves"], m["workloads"]) == (
            "s/GiB", "lower", "program_span", "shuffle_mib_s", ["terasort-256m"])
    assert [m["name"] for m in bench["per_layer"][-len(STAGE_METRICS):]] == \
        list(STAGE_METRICS)
    spec = harness.load_cell("terasort-256m")
    assert set(STAGE_METRICS) <= {m["name"] for m in spec["per_layer"]}
