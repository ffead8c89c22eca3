"""Kernel K4's plain version (``coding/gf_cuda.py::encode_groups_plain``)
against the JAX package's Pallas kernel ``gf_pallas.encode_groups_pallas``
in interpret mode, exactly (bytes). A file of its own: interpreting the
unrolled (8, 64) kernel takes over a minute on a CPU, and test workers
take whole files."""

import numpy as np
import pytest
import torch

from s3shuffle_tpu.coding import gf_pallas
from s3shuffle_tpu_torch.coding import gf, gf_cuda


@pytest.mark.parametrize("m,k,length", [(2, 4, 100), (4, 16, 100), (8, 64, 128)])
def test_k4_plain_equals_the_pallas_kernel_in_interpret_mode(m, k, length):
    rng = np.random.default_rng(7 * m + k)
    chunks = rng.integers(0, 256, (2, k, length), dtype=np.uint8)
    coefs = gf.parity_coefficients(m, k)
    want = gf_pallas.encode_groups_pallas(chunks, coefs, interpret=True)
    consts = torch.from_numpy(gf.bit_constants(coefs))
    got = gf_cuda.encode_groups_plain(torch.from_numpy(chunks), consts).numpy()
    assert np.array_equal(got, want)
