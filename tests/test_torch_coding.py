"""The port's coded plane modules against the JAX package's, exactly (bytes):
the GF(2^8) tables and Vandermonde coefficients, kernel K4's plain version
(``coding/gf_cuda.py::encode_groups_plain``) against the JAX host encoder
(against the Pallas kernel in interpret mode: ``test_torch_gf_pallas.py``),
loss recovery over every erasure pattern, the streaming parity
accumulator, and the parity wire format.
Inputs come from numpy seeds; the port runs with ``device="cpu"``."""

import itertools

import numpy as np
import pytest
import torch

from s3shuffle_tpu.block_ids import ShuffleDataBlockId as JaxDataBlockId
from s3shuffle_tpu.coding import gf as jgf
from s3shuffle_tpu.coding import gf_pallas
from s3shuffle_tpu.coding import parity as jparity
from s3shuffle_tpu_torch import ShuffleConfig, ShuffleDataBlockId, ShuffleParityBlockId
from s3shuffle_tpu_torch.coding import gf, gf_cuda, parity
from s3shuffle_tpu_torch.ops import _build


def test_tables_equal_the_jax_package():
    assert np.array_equal(gf._EXP, jgf._EXP)
    assert np.array_equal(gf._LOG, jgf._LOG)
    for m, k in itertools.product([1, 2, 3, 5, 8], [1, 2, 4, 7, 16, 33, 64]):
        assert np.array_equal(gf.parity_coefficients(m, k), jgf.parity_coefficients(m, k))
    rng = np.random.default_rng(1)
    for a, b in rng.integers(0, 256, (200, 2)):
        assert gf.gf_mul(int(a), int(b)) == jgf.gf_mul(int(a), int(b))
    for a in range(1, 256):
        assert gf.gf_inv(a) == jgf.gf_inv(a)
    data = rng.integers(0, 256, 300, dtype=np.uint8)
    for coef in (0, 1, 2, 0x1D, 255):
        assert np.array_equal(gf.gf_mul_bytes(coef, data), jgf.gf_mul_bytes(coef, data))
    with pytest.raises(ValueError):
        gf.parity_coefficients(200, 100)


def test_bit_constants_equal_the_pallas_kernel_constants():
    for m, k in [(1, 1), (2, 4), (8, 64)]:
        coefs = gf.parity_coefficients(m, k)
        assert gf.bit_constants(coefs).tolist() == [
            [list(row) for row in per_i] for per_i in gf_pallas._bit_constants(coefs)
        ]


def _plain(chunks: np.ndarray, coefs: np.ndarray) -> np.ndarray:
    consts = torch.from_numpy(gf.bit_constants(coefs))
    return gf_cuda.encode_groups_plain(torch.from_numpy(chunks), consts).numpy()


@pytest.mark.parametrize("m,k", [(1, 1), (1, 2), (2, 2), (2, 4), (3, 5), (4, 16)])
def test_k4_plain_equals_the_host_encoder(m, k):
    rng = np.random.default_rng(m * 100 + k)
    chunks = rng.integers(0, 256, (3, k, 100), dtype=np.uint8)  # odd G and L
    chunks[1, 0, :40] = 0  # zero bytes take no table entry
    coefs = gf.parity_coefficients(m, k)
    want = jgf._encode_host(chunks, coefs)
    got = _plain(chunks, coefs)
    assert got.shape == (3, m, 100) and got.dtype == np.uint8
    assert np.array_equal(got, want)
    # the batched entry point on the CPU takes the same plain version
    assert np.array_equal(gf.encode_groups(chunks, coefs, device="cpu"), want)


def test_encode_on_cpu_counts_no_launch_at_any_shape():
    before = dict(_build.LAUNCHES)
    rng = np.random.default_rng(3)
    coefs = gf.parity_coefficients(3, 2)
    for shape in [(1, 2, 1), (5, 2, 17), (0, 2, 8)]:
        chunks = rng.integers(0, 256, shape, dtype=np.uint8)
        out = gf.encode_groups(chunks, coefs, device="cpu")
        assert out.shape == (shape[0], 3, shape[2])
        assert np.array_equal(out, jgf._encode_host(chunks, coefs))
    # a read-only buffer (np.frombuffer of bytes) is accepted
    ro = np.frombuffer(bytes(range(64)), dtype=np.uint8).reshape(1, 2, 32)
    assert np.array_equal(gf.encode_groups(ro, coefs, device="cpu"), jgf._encode_host(ro, coefs))
    assert _build.LAUNCHES == before
    assert "gf_encode" in _build.LAUNCHES


def _erasure_cases():
    for k, m in [(2, 1), (2, 2), (4, 2)]:
        n = k + m
        for lost in range(0, n + 1):
            for erased in itertools.combinations(range(n), lost):
                yield k, m, erased


@pytest.mark.parametrize("k,m,erased", list(_erasure_cases()),
                         ids=lambda v: str(v).replace(" ", ""))
def test_recover_group_equals_the_jax_package(k, m, erased):
    rng = np.random.default_rng(hash((k, m, erased)) % (1 << 32))
    length = 37
    chunks = rng.integers(0, 256, (1, k, length), dtype=np.uint8)
    coefs = gf.parity_coefficients(m, k)
    par = jgf._encode_host(chunks, coefs)[0]
    data_present = {j: chunks[0, j] for j in range(k) if j not in erased}
    parity_present = {i: par[i] for i in range(m) if k + i not in erased}
    want = list(range(k))
    got = gf.recover_group(k, coefs, dict(data_present), dict(parity_present), want,
                           device="cpu")
    ref = jgf.recover_group(k, coefs, dict(data_present), dict(parity_present), want)
    if ref is None:
        assert got is None
        assert len(erased) > m  # too few survivors
        return
    assert got is not None and sorted(got) == sorted(ref)
    for j in want:
        assert np.array_equal(got[j], ref[j])
        assert np.array_equal(got[j], chunks[0, j])


def _feed(acc, payload: bytes, rng) -> None:
    pos = 0
    while pos < len(payload):
        step = int(rng.integers(1, 3000))
        acc.update(payload[pos : pos + step])
        pos += step


@pytest.mark.parametrize(
    "m,k,chunk,size",
    [
        (2, 2, 256, 16 * 2 * 256 + 3 * 256 + 100),  # a full batch of 16 groups + tail
        (1, 3, 512, 2 * 3 * 512 + 700),  # a partial group (a chunk and a bit)
        (2, 2, 1024, 700),  # shorter than one chunk
        (3, 4, 128, 40 * 4 * 128),  # more than two batches, no tail
    ],
)
def test_streaming_accumulator_equals_the_jax_package(m, k, chunk, size):
    payload = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes()
    ours = parity.ParityAccumulator(m, k, chunk, device="cpu")
    ref = jparity.ParityAccumulator(m, k, chunk)
    _feed(ours, payload, np.random.default_rng(1))
    _feed(ref, payload, np.random.default_rng(2))
    got, want = ours.finish(), ref.finish()
    assert ours.finish() == got  # idempotent
    assert got == want
    assert (ours.geometry.segments, ours.geometry.stripe_k, ours.geometry.chunk_bytes,
            ours.geometry.payload_len) == (m, k, chunk, size)
    assert ours.geometry.n_groups == ref.geometry.n_groups


def test_parity_wire_format_and_names_equal_the_jax_package():
    geom = parity.ParityGeometry(2, 3, 4096, 1_000_001)
    jgeom = jparity.ParityGeometry(2, 3, 4096, 1_000_001)
    for seg in range(2):
        hdr = parity.parity_header(ShuffleDataBlockId(7, 5), geom, seg)
        assert hdr == jparity.parity_header(JaxDataBlockId(7, 5), jgeom, seg)
        assert parity.parse_parity_header(hdr) == geom
    assert [b.name for b in parity.parity_blocks_for(ShuffleDataBlockId(7, 5), 2)] == [
        "shuffle_7_5_par0.parity", "shuffle_7_5_par1.parity",
    ]
    assert ShuffleParityBlockId(7, 5, 1).name == "shuffle_7_5_par1.parity"
    assert np.array_equal(parity.geometry_trailer_words(geom),
                          jparity.geometry_trailer_words(jgeom))
    for g in range(geom.n_groups):
        assert geom.group_parity_len(g) == jgeom.group_parity_len(g)
        assert geom.parity_chunk_offset(g) == jgeom.parity_chunk_offset(g)
    with pytest.raises(ValueError):
        parity.parse_parity_header(b"\0" * 64)
    with pytest.raises(ValueError):
        parity.parse_parity_header(b"short")


def test_config_validates_parity_knobs_as_the_jax_package():
    assert ShuffleConfig().parity_segments == 0
    assert ShuffleConfig().parity_stripe_k == 1
    assert ShuffleConfig().parity_chunk_bytes == 1 << 20
    for bad in ({"parity_segments": -1}, {"parity_stripe_k": 0},
                {"parity_segments": 200, "parity_stripe_k": 56},
                {"parity_chunk_bytes": 0}):
        with pytest.raises(ValueError):
            ShuffleConfig(**bad)
    cfg = ShuffleConfig(parity_segments=2, parity_stripe_k=2)
    assert parity.accumulator_from_config(cfg, "cpu").geometry.segments == 2
    assert parity.accumulator_from_config(ShuffleConfig(), "cpu") is None
