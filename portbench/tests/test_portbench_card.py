"""On the card: each cell's run at a short window and a small size through
the kernels, correct against the plain reference and launching K1-K3."""

import tempfile
import time

import pytest

from portbench import harness

#: the cells at sizes whose partitions still span several 256 KiB blocks,
#: so the batched kernels run
CARD_SIZES = {
    "terasort-256m": {"job_bytes": 32 << 20},
}


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CARD_SIZES))
def test_a_short_run_on_the_card_is_correct_and_launches_the_kernels(cell, cuda_device):
    from s3shuffle_tpu_torch.ops import _build

    _build.reset_launches()
    result = harness.run_cell(cell, 2**31 + 5, 1.0, False, time.perf_counter(),
                              device=cuda_device, overrides=CARD_SIZES[cell],
                              store=tempfile.mkdtemp(prefix="portbench-card-"),
                              log=lambda *a, **k: None)
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
    for kernel in ("crc_fold", "tlz_planes", "tlz_decode_fused"):
        assert _build.LAUNCHES.get(kernel, 0) > 0, kernel
