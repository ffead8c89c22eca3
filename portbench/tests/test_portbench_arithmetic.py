"""The window's arithmetic and the metric readers on synthetic counts and
profiler intervals."""

import pytest

from portbench import harness, profiling, readings
from portbench.harness import reader

GiB = 1 << 30


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("unit_s,seconds,units,window", [
    (0.3, 1.0, 4, 1.2),   # the unit in flight at 1.0 s finishes: 4 units over 1.2 s
    (2.5, 1.0, 1, 2.5),   # one unit longer than the window
    (0.25, 1.0, 4, 1.0),  # a unit that ends on the mark closes the window
])
def test_the_window_runs_units_until_the_mark_and_finishes_the_last(unit_s, seconds, units,
                                                                    window):
    clock = FakeClock()
    ran = []

    def one_unit(i):
        ran.append(i)
        clock.t += unit_s

    window_s = harness.run_window(one_unit, seconds, clock)
    assert ran == list(range(units))
    assert window_s == pytest.approx(window)


def obs(**kw):
    base = {"setup_s": 12.5, "window_s": 1.2, "units": 4, "user_bytes": 4 * 256 << 20,
            "created_bytes": 170 << 20, "requests": 448,
            "read_wait_ns": 3e9, "codec_timings": {},
            "data_gets": 0,
            "frame_bytes": {}, "trace": None, "bandwidth": 3.35e12}
    base.update(kw)
    return base


def test_rates_are_taken_over_the_whole_window():
    o = obs()
    assert reader("shuffle_mib_s")(o) == pytest.approx(4 * 256 / 1.2)
    assert reader("setup_s")(o) == 12.5


def test_store_costs_are_per_user_byte():
    o = obs()
    assert reader("stored_ratio")(o) == pytest.approx(170 / 1024)
    assert reader("store_req_per_gib")(o) == pytest.approx(448.0)


def test_nothing_is_read_from_an_empty_window():
    o = obs(units=0, user_bytes=0)
    for name in ("shuffle_mib_s", "stored_ratio", "store_req_per_gib", "data_gets_per_gib",
                 "fetch_wait_s_per_gib.sort", "wire_ratio"):
        assert reader(name)(o) is None


def test_layer_readings_per_user_gib():
    o = obs(codec_timings={"encode_assembly_s": 1.0, "decode_parse_s": 2.0,
                           "decode_emit_s": 0.5, "encode_device_s": 9.0},
            data_gets=512)
    assert reader("fetch_wait_s_per_gib.sort")(o) == pytest.approx(3.0)
    assert reader("codec_host_s_per_gib.sort")(o) == pytest.approx(3.5)
    assert reader("data_gets_per_gib")(o) == pytest.approx(512.0)  # over 1 GiB
    assert reader("codec_host_s_per_gib.sort")(obs()) is None


def test_union_and_gaps_of_intervals():
    intervals = [(10, 20), (15, 30), (40, 50), (45, 47), (90, 200)]
    assert profiling.union_seconds(intervals, 0, 100) == pytest.approx(40e-9)
    assert profiling.union_seconds(intervals, 12, 42) == pytest.approx(20e-9)
    assert profiling.gaps(intervals, 0, 100) == [(0, 10), (30, 40), (50, 90)]
    assert profiling.gaps([], 0, 100) == [(0, 100)]


def test_roofline_share_is_the_least_time_over_the_kernel_union():
    f = {"frames": 10, "raw": 6_000_000, "stored": 1_000_000, "tlz_raw": 5_000_000,
         "tlz_stored": 900_000}
    trace = {"kernel_s": 0.01, "busy_s": 0.02, "window_s": 1.0}
    o = obs(frame_bytes=f, trace=trace)
    nbytes = 6_000_000 + 1_000_000 + 5_000_000 + 900_000
    assert readings.codec_bytes(o) == nbytes
    assert reader("codec_roofline.sort")(o) == pytest.approx(100 * nbytes / 3.35e12 / 0.01)
    assert reader("device_idle_pct.sort")(o) == pytest.approx(98.0)
    assert reader("wire_ratio")(o) == pytest.approx(6_000_000 / (1024 << 20))
    assert reader("codec_stored_ratio")(o) == pytest.approx(1 / 6)
    # nothing to read: no frames, no trace, a card the table lacks
    assert reader("codec_roofline.sort")(obs(trace=trace)) is None
    assert reader("codec_roofline.sort")(obs(frame_bytes=f)) is None
    assert reader("codec_roofline.sort")(obs(frame_bytes=f, trace=trace, bandwidth=None)) is None
    assert reader("device_idle_pct.sort")(obs()) is None


def test_the_peak_table():
    from portbench.peaks import bandwidth_for

    assert bandwidth_for("NVIDIA H100 80GB HBM3") == 3.35e12
    assert bandwidth_for("NVIDIA H100 PCIe") == 2.0e12
    assert bandwidth_for("Some other card") is None
