"""Tests of the benchmark harness. Run from the repository's root:

    python3 -m pytest portbench/tests -q            # here, on the CPU
    python3 -m pytest portbench/tests -q -m card    # on the card

Tests marked ``card`` need a CUDA device; each decides inside the test
whether one is there and skips without it.
"""

import pytest

def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
