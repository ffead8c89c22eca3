"""The plain reference's pieces: CRC32C, the sidecar judge and the
TeraSort judge."""

import os

import numpy as np
import pytest

from portbench.reference import crc32c as crc
from portbench.reference import sidecars, terasort


@pytest.mark.parametrize("n", [0, 1, 9, 255, 256, 257, 4096, 65_537, 1_000_003])
def test_crc32c_equals_the_byte_serial_loop_and_the_port(n):
    from s3shuffle_tpu_torch.utils.checksums import crc32c as port_crc32c

    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    assert crc.crc32c(data) == port_crc32c(data)
    if n <= 4096:
        assert crc.crc32c(data) == crc.crc32c_serial(data)


def test_crc32c_check_value():
    assert crc.crc32c(b"123456789") == 0xE3069283


def _write_map(root, sid, mid, parts, sums=None):
    data = b"".join(parts)
    offsets = np.cumsum([0] + [len(p) for p in parts]).astype(">i8")
    sums = [crc.crc32c(p) for p in parts] if sums is None else sums
    d = os.path.join(root, "app", str(sid))
    os.makedirs(d, exist_ok=True)
    open(os.path.join(d, f"shuffle_{sid}_{mid}_0.data"), "wb").write(data)
    open(os.path.join(d, f"shuffle_{sid}_{mid}_0.index"), "wb").write(offsets.tobytes())
    open(os.path.join(d, f"shuffle_{sid}_{mid}_0.checksum.CRC32C"), "wb").write(
        np.array(sums, dtype=">i8").tobytes())


def test_the_sidecar_judge(tmp_path):
    parts = [b"a" * 1000, b"", b"xyz" * 500]
    _write_map(str(tmp_path), 3, 0, parts)
    _write_map(str(tmp_path), 3, 1, parts, sums=[crc.crc32c(parts[0]), 0, 7])
    _write_map(str(tmp_path), 4, 0, parts)
    assert sidecars.check_sidecars(str(tmp_path), [3]) == {"maps": 2, "entries": 6, "wrong": 1}
    assert sidecars.check_sidecars(str(tmp_path), [4]) == {"maps": 1, "entries": 3, "wrong": 0}
    # a shuffle with no objects, and a map output without its sidecar
    assert sidecars.check_sidecars(str(tmp_path), [5])["wrong"] == 1
    os.remove(tmp_path / "app" / "4" / "shuffle_4_0_0.checksum.CRC32C")
    assert sidecars.check_sidecars(str(tmp_path), [4])["wrong"] == 1


def test_the_terasort_judge():
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 256, (1000, 100), dtype=np.uint8)
    expected = terasort.sort_rows(rows)
    good = np.array_split(expected, 8)
    assert terasort.judge_job(good, expected) == 0
    # equal keys in another order of their values are still right
    tied = expected.copy()
    tied[10, :10] = tied[11, :10]
    tied_expected = terasort.sort_rows(tied)
    swapped = tied_expected.copy()
    swapped[[10, 11]] = swapped[[11, 10]]
    assert terasort.judge_job([swapped], tied_expected) == 0
    assert terasort.judge_job(np.array_split(expected[:-3], 8), expected) > 0
    assert terasort.judge_job([expected[::-1]], expected) > 0
    altered = expected.copy()
    altered[5, 50] ^= 1
    assert terasort.judge_job([altered], expected) == 1
