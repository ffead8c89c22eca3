"""The port's TLZ stages held exactly against the JAX package on the same
seeded inputs: candidate search, kernel K2's plain plane decisions (vs the
XLA math and the Pallas plane kernel in interpret mode), compaction, kernel
K3's plain fused decode + CRC (vs the XLA fused math and the Pallas fused
kernel), and the whole batched encode and decode entry points. Every
comparison is exact: the outputs are bytes and integer planes."""

import jax
import numpy as np
import pytest
import torch

from s3shuffle_tpu.ops import checksum as jax_checksum
from s3shuffle_tpu.ops import tlz as jax_tlz
from s3shuffle_tpu.ops import tlz_pallas
from s3shuffle_tpu_torch.ops import checksum, tlz, tlz_cuda

POLY = checksum.POLY_CRC32C
KINDS = ["text", "random", "zeros", "mixed"]


@pytest.fixture
def force_pallas(monkeypatch):
    monkeypatch.setenv("S3SHUFFLE_TLZ_PALLAS", "1")


def _make_block(kind: str, size: int, rng) -> bytes:
    if kind == "text":
        return (b"the quick brown fox jumps over the lazy dog " * size)[:size]
    if kind == "zeros":
        return bytes(size)
    if kind == "random":
        return bytes(rng.integers(0, 256, size, dtype=np.uint8))
    run = (b"columnar shuffle row payload " * size)[: size // 3]
    noise = bytes(rng.integers(0, 256, size - 2 * len(run), dtype=np.uint8))
    return (run + noise + run)[:size]


def _batch(bs: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([
        np.frombuffer(_make_block(KINDS[i % 4], bs, rng), dtype=np.uint8)
        for i in range(n)
    ])


@pytest.mark.parametrize("bs", [512, 2048])
def test_candidate_math_matches_xla(bs):
    batch = _batch(bs, 4, bs)
    n_groups = bs // tlz.GROUP
    got = tlz.candidate_math(torch.from_numpy(batch), n_groups).numpy()
    want = np.asarray(jax_tlz._candidate_math(jax.device_put(batch), n_groups))
    assert got.dtype == np.int32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("bs", [512, 2048])
@pytest.mark.parametrize("kind", KINDS)
def test_plane_decisions_plain_matches_xla_and_pallas(bs, kind):
    rng = np.random.default_rng(bs + len(kind))
    batch = np.stack([
        np.frombuffer(_make_block(kind, bs, rng), dtype=np.uint8) for _ in range(2)
    ])
    n_groups = bs // tlz.GROUP
    blocks = torch.from_numpy(batch)
    cand = tlz.candidate_math(blocks, n_groups)
    got = tlz_cuda.plane_decisions(blocks, cand, n_groups)  # CPU → plain
    dev_blocks = jax.device_put(batch)
    dev_cand = jax.device_put(cand.numpy())
    xla = jax_tlz._plane_decisions_math(dev_blocks, dev_cand, n_groups)
    pallas = tlz_pallas.plane_decisions(dev_blocks, dev_cand, n_groups, interpret=True)
    for g, x, p in zip(got, xla, pallas):
        g = g.numpy()
        assert np.array_equal(g, np.asarray(x))
        assert np.array_equal(g, np.asarray(p))


@pytest.mark.parametrize("bs", [512, 2048])
def test_compaction_matches_xla(bs):
    batch = _batch(bs, 4, bs + 1)
    n_groups = bs // tlz.GROUP
    got = tlz.encode_planes(torch.from_numpy(batch), n_groups)
    want = jax_tlz._encode_math(jax.device_put(batch), n_groups)
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.array_equal(g.numpy().astype(w.dtype), w)


def _staged_planes(payloads, bs):
    """The decode staging of a batch of device-shaped payloads (the port's
    and the JAX package's parse are the same code)."""
    n_groups = bs // tlz.GROUP
    rows, fallback = tlz._parse_batch_v2(payloads, [bs] * len(payloads), n_groups)
    assert not fallback
    st = tlz._new_decode_staging(len(payloads), n_groups)
    for j, row in enumerate(rows):
        m, c, sp, dist_vals, kv, lit, nl, _ = row
        st[0][j], st[1][j], st[2][j] = m, c, sp
        st[3][j, : len(dist_vals)] = dist_vals
        st[4][j, : len(kv)] = kv
        st[5][j, : nl * tlz.GROUP] = lit
        st[6][j] = nl
    return st


@pytest.mark.parametrize("bs", [512, 2048])
def test_fused_decode_plain_matches_xla_and_pallas(bs):
    rng = np.random.default_rng(bs * 3)
    blocks = [_make_block(KINDS[i % 4], bs, rng) for i in range(4)]
    payloads = [jax_tlz._assemble_payload_numpy(b) for b in blocks]
    st = _staged_planes(payloads, bs)
    n_groups = bs // tlz.GROUP
    dec, raw = tlz_cuda.decode_fused(*[torch.from_numpy(a) for a in st], n_groups, POLY)
    m, c, s, offs, ks, lits, nl = st
    lits3 = lits.reshape(len(blocks), n_groups, tlz.GROUP)
    crc_fn = jax_checksum.raw_crc_graph_fn(POLY, bs, len(blocks))
    x_dec, x_raw = jax_tlz._decode_fused_math(m, c, s, offs, ks, lits3, nl, n_groups, crc_fn)
    p_dec, p_raw = tlz_pallas.decode_fused_math_fn(n_groups, POLY)(
        m, c, s, offs, ks, lits3, nl
    )
    assert np.array_equal(dec.numpy(), np.asarray(x_dec))
    assert np.array_equal(dec.numpy(), np.asarray(p_dec))
    assert [int(v) for v in raw] == [int(v) for v in np.asarray(x_raw)]
    assert [int(v) for v in raw] == [int(v) for v in np.asarray(p_raw)]
    assert [bytes(r) for r in dec.numpy()] == blocks


def test_fused_decode_plain_clamps_corrupt_planes_like_xla():
    """Unvalidated planes (distances past the row start, split points out of
    range, pointer cycles): the plain decode clamps exactly as the XLA
    formulation does."""
    rng = np.random.default_rng(11)
    n_groups, b = 32, 6
    m = rng.random((b, n_groups)) < 0.5
    c = m & (rng.random((b, n_groups)) < 0.5)
    s = ~m & (rng.random((b, n_groups)) < 0.3)
    offs = rng.integers(0, 300, (b, n_groups)).astype(np.int32)
    ks = rng.integers(0, 9, (b, n_groups)).astype(np.int32)
    lits = rng.integers(0, 256, (b, n_groups * tlz.GROUP), dtype=np.uint8)
    nl = (n_groups - m.sum(1) - s.sum(1)).astype(np.int32)
    dec, raw = tlz.decode_fused_plain(
        *[torch.from_numpy(a) for a in (m, c, s, offs, ks, lits, nl)], n_groups, POLY
    )
    crc_fn = jax_checksum.raw_crc_graph_fn(POLY, n_groups * tlz.GROUP, b)
    x_dec, x_raw = jax_tlz._decode_fused_math(
        m, c, s, offs, ks, lits.reshape(b, n_groups, tlz.GROUP), nl, n_groups, crc_fn
    )
    assert np.array_equal(dec.numpy(), np.asarray(x_dec))
    assert [int(v) for v in raw] == [int(v) for v in np.asarray(x_raw)]


@pytest.mark.parametrize("bs", [512, 2048])
@pytest.mark.parametrize("n_blocks", [1, 3, 4])  # 3 = padded tail bucket
def test_encode_batch_matches_jax_and_host(force_pallas, bs, n_blocks):
    rng = np.random.default_rng(bs * 31 + n_blocks)
    blocks = [_make_block(KINDS[i % 4], bs, rng) for i in range(n_blocks)]
    blob = b"".join(blocks)
    got, crcs = tlz.encode_batch_device(
        blob, n_blocks, bs, batch_blocks=4, poly=POLY, device="cpu"
    )
    want, want_crcs = jax_tlz.encode_batch_device(
        blob, n_blocks, bs, batch_blocks=4, poly=POLY
    )
    assert [bytes(p) for p in got] == [bytes(p) for p in want]
    assert [bytes(p) for p in got] == [jax_tlz._assemble_payload_numpy(b) for b in blocks]
    for g, w in zip(crcs, want_crcs):
        assert [int(v) for v in g] == [int(v) for v in w]
    plain, none = tlz.encode_batch_device(blob, n_blocks, bs, batch_blocks=4, device="cpu")
    assert none is None and plain == got


def test_host_codec_copies_match_reference():
    rng = np.random.default_rng(5)
    for size in (1, 7, 100, 513, 2048, 5000):
        data = _make_block("mixed", size, rng)
        payload = tlz._assemble_payload_numpy(data)
        assert payload == jax_tlz._assemble_payload_numpy(data)
        assert tlz.decode_payload_numpy(payload, size) == data
        assert jax_tlz.decode_payload_numpy(payload, size, use_native=False) == data
    with pytest.raises(IOError):
        tlz.decode_payload_numpy(b"\x01", 64)


@pytest.mark.parametrize("bs", [512, 2048])
def test_decode_batch_matches_jax(force_pallas, bs):
    """Full, short (host fallback) and padded-bucket rows through the
    batched decode: decoded bytes and stored-payload CRCs equal the JAX
    package's fused decode."""
    rng = np.random.default_rng(bs + 9)
    blocks = [_make_block(KINDS[i % 4], bs, rng) for i in range(5)]
    blocks.append(_make_block("text", bs // 2 + 3, rng))  # short tail block
    payloads = [jax_tlz._assemble_payload_numpy(b) for b in blocks]
    ulens = [len(b) for b in blocks]
    got, crcs = tlz.decode_batch_device(
        payloads, ulens, bs, batch_rows=4, poly=POLY, device="cpu"
    )
    want, want_crcs = jax_tlz.decode_batch_device(
        payloads, ulens, bs, batch_rows=4, poly=POLY
    )
    assert got == [bytes(w) for w in want] == blocks
    assert crcs == [None if w is None else int(w) for w in want_crcs]
    assert crcs[-1] is None  # short rows are certified by the caller
    for p, c in zip(payloads[:-1], crcs[:-1]):
        assert c == checksum.host_crc(p, POLY)
