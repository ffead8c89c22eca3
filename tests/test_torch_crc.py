"""Kernel K1's plain PyTorch version and the host CRC helpers of the port,
held exactly against the JAX package: the tiled Pallas CRC fold in
interpret mode, the XLA bit-matmul ``crc32_batch``, ``google_crc32c`` and
the byte-serial remainder, over the shapes of the JAX package's own Pallas
CRC suite (right-aligned tails included)."""

import zlib

import numpy as np
import pytest
import torch

from s3shuffle_tpu.ops import checksum as jax_checksum
from s3shuffle_tpu.ops import crc_pallas
from s3shuffle_tpu_torch.ops import checksum, crc_cuda
from s3shuffle_tpu_torch.utils import checksums as port_checksums

POLY = checksum.POLY_CRC32C


def _raw_ref(row: bytes) -> int:
    return jax_checksum._crc_raw_bytes(row, POLY, 0) & 0xFFFFFFFF


@pytest.mark.parametrize("b,length", [(8, 128), (8, 512), (16, 1280), (24, 256)])
def test_plain_crc_matches_pallas_and_xla(b, length):
    rng = np.random.default_rng(b * length)
    data = rng.integers(0, 256, (b, length), dtype=np.uint8)
    got = crc_cuda.crc_raw(torch.from_numpy(data), POLY).numpy()
    pallas = np.asarray(crc_pallas.crc_raw_batch(data, POLY, interpret=True))
    assert [int(c) for c in got] == [int(c) for c in pallas]
    assert [int(c) for c in got] == [_raw_ref(bytes(r)) for r in data]
    # full-algorithm CRCs: the host fixup over the port's raw remainders
    zero = checksum.zero_run_crcs(POLY, length)
    lengths = np.full(b, length)
    want = jax_checksum.crc32_batch(data, lengths, poly=POLY)
    assert [int(c) for c in (got.astype(np.uint32) ^ zero[lengths])] == [
        int(c) for c in want
    ]


@pytest.mark.parametrize("tail", [0, 1, 37, 127, 128, 300])
def test_plain_crc_right_aligned_rows(tail):
    """Right-aligned rows with zero front padding, and the same messages
    front-aligned with explicit lengths: both give the suffix's remainder,
    equal to the Pallas fold and to google_crc32c after the fixup."""
    import google_crc32c

    length = 512
    rng = np.random.default_rng(tail)
    rows = np.zeros((8, length), dtype=np.uint8)
    front = np.zeros((8, length), dtype=np.uint8)
    ns = [min(length, tail + i) for i in range(8)]
    for i, n in enumerate(ns):
        if n:
            msg = rng.integers(0, 256, n, dtype=np.uint8)
            rows[i, length - n:] = msg
            front[i, :n] = msg
    got = crc_cuda.crc_raw(torch.from_numpy(rows), POLY).numpy()
    got_front = crc_cuda.crc_raw(
        torch.from_numpy(front), POLY, torch.tensor(ns, dtype=torch.int32)
    ).numpy()
    pallas = np.asarray(crc_pallas.crc_raw_batch(rows, POLY, interpret=True))
    assert [int(c) for c in got] == [int(c) for c in pallas]
    assert [int(c) for c in got_front] == [int(c) for c in pallas]
    zero = checksum.zero_run_crcs(POLY, length)
    for i, n in enumerate(ns):
        msg = bytes(rows[i, length - n:])
        assert int(got[i]) ^ int(zero[n]) == google_crc32c.value(msg)


@pytest.mark.parametrize("poly", [checksum.POLY_CRC32, checksum.POLY_CRC32C])
@pytest.mark.parametrize("length", [8, 136, 1000, 4096])
def test_plain_crc_odd_widths_both_polys(poly, length):
    rng = np.random.default_rng(length)
    data = rng.integers(0, 256, (3, length), dtype=np.uint8)
    got = crc_cuda.crc_raw(torch.from_numpy(data), poly).numpy()
    want = [jax_checksum._crc_raw_bytes(bytes(r), poly, 0) for r in data]
    assert [int(c) for c in got] == want


def test_host_gf2_helpers_match_reference():
    rng = np.random.default_rng(7)
    for poly in (checksum.POLY_CRC32, checksum.POLY_CRC32C):
        for n in (0, 1, 9, 128, 1000, 262144):
            assert checksum._zero_op_power(poly, n) == jax_checksum._zero_op_power(poly, n)
        a = bytes(rng.integers(0, 256, 333, dtype=np.uint8))
        b = bytes(rng.integers(0, 256, 1234, dtype=np.uint8))
        ca, cb = checksum.host_crc(a, poly), checksum.host_crc(b, poly)
        assert checksum.crc_combine(ca, cb, len(b), poly) == jax_checksum.crc_combine(
            ca, cb, len(b), poly
        )
        assert checksum.crc_combine(ca, cb, len(b), poly) == checksum.host_crc(a + b, poly)
        assert np.array_equal(
            checksum.zero_run_crcs(poly, 4096), jax_checksum.zero_run_crcs(poly, 4096)
        )
    chunks = [b"abc", b"", bytes(range(40))]
    got = checksum.stage_right_aligned(chunks, 64)
    want = jax_checksum.stage_right_aligned(chunks, 64)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.mark.parametrize("n", [0, 1, 5, 63, 64, 65, 1000, 8191, 70000])
def test_host_crc32c_matches_reference(n):
    import google_crc32c

    from s3shuffle_tpu.utils.checksums import crc32c_py as jax_crc32c_py

    rng = np.random.default_rng(n)
    data = bytes(rng.integers(0, 256, n, dtype=np.uint8))
    assert port_checksums.crc32c(data) == google_crc32c.value(data)
    for value in (0, 0xDEADBEEF):
        assert port_checksums.crc32c(data, value) == jax_crc32c_py(data, value)
    stream = port_checksums.create_checksum("crc32c")
    stream.update(data[: n // 3])
    stream.update(data[n // 3 :])
    assert stream.value == google_crc32c.value(data)


def test_device_tables_are_the_reference_operators():
    """The CUDA kernels' inputs: slicing-by-8 tables, the chunk tree's
    operators and the segment fold's operators."""
    t = checksum.slice8_tables(POLY)
    rng = np.random.default_rng(3)
    word = rng.integers(0, 256, 8, dtype=np.uint8)
    crc = 0x12345678
    lo = int(word[:4].view("<u4")[0]) ^ crc
    hi = int(word[4:].view("<u4")[0])
    sliced = 0
    for k in range(4):
        sliced ^= int(t[7 - k][(lo >> (8 * k)) & 0xFF]) ^ int(t[3 - k][(hi >> (8 * k)) & 0xFF])
    assert sliced == jax_checksum._crc_raw_bytes(bytes(word), POLY, crc)
    tab8, nib = crc_cuda.device_tables(POLY, torch.device("cpu"))
    assert np.array_equal(tab8.numpy().view(np.uint32), t)
    assert crc_cuda.THREADS * crc_cuda.CHUNK == crc_cuda.SEG_BYTES
    assert 1 << crc_cuda.LEVELS == crc_cuda.THREADS
    nib = nib.numpy().view(np.uint32)
    for lvl in range(crc_cuda.LEVELS):
        want = jax_checksum._zero_op_power(POLY, crc_cuda.CHUNK << lvl)
        for v in (1, 0x80000000, 0xDEADBEEF, int(rng.integers(0, 2**32))):
            applied = 0
            for k in range(8):
                applied ^= int(nib[lvl, k, (v >> (4 * k)) & 15])
            assert applied == jax_checksum._mat_apply(want, v)
    seg = crc_cuda.segment_columns(POLY, crc_cuda.SEG_BYTES, 3, torch.device("cpu"))
    for j in range(3):
        want = jax_checksum._zero_op_power(POLY, crc_cuda.SEG_BYTES * j)
        assert tuple(int(c) for c in seg[j].numpy().view(np.uint32)) == want
    assert crc_cuda.segment_count(262144) == 16
    assert crc_cuda.segment_count(8) == crc_cuda.segment_count(0) == 1
    assert crc_cuda.segment_count(crc_cuda.SEG_BYTES + 8) == 2


S = crc_cuda.SEG_BYTES
#: K1's segment cut: 4 segments a row, the last one partly outside
WIDTH = 3 * S + 128
LENGTHS = [0, 1, 7, 8, S - 1, S, S + 1, 2 * S + 5, WIDTH]


def _fold(rows: np.ndarray, lengths, poly: int):
    from test_torch_tlz import fold_segments

    return fold_segments(rows, lengths, S, crc_cuda.segment_count(rows.shape[1]), poly)


def test_segment_layout_covers_each_message_once():
    """K1's (row, segment) cut: the active segments of a message are the
    last ceil(len / S) of its row (the last one alone for an empty message),
    and their spans tile [0, len) in order."""
    n_seg = crc_cuda.segment_count(WIDTH)
    assert n_seg == 4
    lo, hi, active = crc_cuda.segment_spans(torch.tensor(LENGTHS), n_seg)
    for r, n in enumerate(LENGTHS):
        spans = [(int(lo[r, j]), int(hi[r, j])) for j in range(n_seg) if active[r, j]]
        assert len(spans) == max(1, -(-n // S))
        assert all(b - a <= S for a, b in spans)
        covered = [(a, b) for a, b in spans if b > a]
        assert [a for a, _ in covered] == sorted(a for a, _ in covered)
        assert sum(b - a for a, b in covered) == n
        assert all(covered[i][1] == covered[i + 1][0] for i in range(len(covered) - 1))
        if covered:
            assert covered[0][0] == 0 and covered[-1][1] == n
        inactive = ~active[r]
        assert (hi[r][inactive] <= lo[r][inactive]).all()


@pytest.mark.parametrize("poly", [checksum.POLY_CRC32, checksum.POLY_CRC32C])
def test_segment_fold_equals_the_plain_and_pallas_crc(poly):
    """Folding K1's segment remainders with its fold columns gives the raw
    CRC of every message, at lengths 0, 1, 7, 8, S - 1, S, S + 1, 2S + 5 and
    the full width: equal to the plain version and to the Pallas fold in
    interpret mode (on the right-aligned rows, 16 of them as its tiles
    need)."""
    rng = np.random.default_rng(poly & 0xFFFF)
    lengths = LENGTHS + [int(v) for v in rng.integers(0, WIDTH + 1, 16 - len(LENGTHS))]
    rows = rng.integers(0, 256, (16, WIDTH), dtype=np.uint8)
    folded = _fold(rows, lengths, poly)
    plain = checksum.crc_raw_plain(torch.from_numpy(rows), poly,
                                   torch.tensor(lengths, dtype=torch.int32))
    assert folded == [int(v) for v in plain]
    right = checksum.right_align(torch.from_numpy(rows), torch.tensor(lengths)).numpy()
    pallas = np.asarray(crc_pallas.crc_raw_batch(right, poly, interpret=True))
    assert folded == [int(v) for v in pallas]


@pytest.mark.parametrize("poly", [checksum.POLY_CRC32, checksum.POLY_CRC32C])
def test_crc_raw_pair_equals_the_concatenated_rows(poly):
    """The two-row-set form (the main path's raw blocks and literal planes
    in one launch) against the one-set form over the concatenation and the
    segment fold, with lengths on either set or both."""
    rng = np.random.default_rng(poly & 0xFFF)
    first = rng.integers(0, 256, (3, WIDTH), dtype=np.uint8)
    more = rng.integers(0, 256, (len(LENGTHS), WIDTH), dtype=np.uint8)
    first_len = torch.tensor([WIDTH, 5, S + 3], dtype=torch.int32)
    more_len = torch.tensor(LENGTHS, dtype=torch.int32)
    both = torch.from_numpy(np.concatenate([first, more]))
    for a_len in (None, first_len):
        for b_len in (None, more_len):
            got = crc_cuda.crc_raw_pair(torch.from_numpy(first), torch.from_numpy(more), poly,
                                        lengths=a_len, more_lengths=b_len)
            lengths = torch.cat([
                a_len if a_len is not None else torch.full((3,), WIDTH, dtype=torch.int32),
                b_len if b_len is not None else torch.full((len(LENGTHS),), WIDTH,
                                                           dtype=torch.int32),
            ])
            assert torch.equal(got, crc_cuda.crc_raw(both, poly, lengths))
            assert [int(v) for v in got] == _fold(both.numpy(), lengths.tolist(), poly)


# --- the codec batch layer's stored-byte CRC stitch, native and numpy ---

STITCH_BS = 256 * 1024


def _frames(framed: bytes):
    """(header, payload) of each frame of a framed buffer."""
    from s3shuffle_tpu_torch.codec.framing import HEADER, HEADER_SIZE

    out, off = [], 0
    while off < len(framed):
        _cid, _ulen, clen = HEADER.unpack_from(framed, off)
        out.append((framed[off : off + HEADER_SIZE], framed[off + HEADER_SIZE :
                                                          off + HEADER_SIZE + clen]))
        off += HEADER_SIZE + clen
    return out


def _stitch_case(case):
    """The stitched CRCs of one case and the stored bytes each covers."""
    from s3shuffle_tpu_torch.codec.cuda import CudaCodec
    from s3shuffle_tpu_torch.ops import tlz
    from torch_gensort import gensort_blocks

    if case in ("gensort-encode", "raw-escape"):
        blocks = (gensort_blocks(2, STITCH_BS, 3) if case == "gensort-encode" else
                  np.random.default_rng(4).integers(0, 256, (2, STITCH_BS), dtype=np.uint8))
        codec = CudaCodec(block_size=STITCH_BS, batch_blocks=2, device="cpu")
        framed, crcs = codec.compress_framed_fused(blocks.tobytes(), 2, STITCH_BS)
        frames = _frames(framed)
        assert [len(h) + len(p) for h, p in frames] == [n for _c, n in crcs]
        assert (case == "raw-escape") == all(h[0] == 0 for h, _p in frames)
        return [c for c, _n in crcs], [h + p for h, p in frames]
    if case in ("gensort-decode", "short-block"):
        blocks = [bytes(b) for b in gensort_blocks(2, STITCH_BS, 6)]
        if case == "short-block":  # a short tail: decoded and certified on the host
            blocks.append(blocks[0][:5000])
        payloads = [tlz._assemble_payload_numpy(b) for b in blocks]
        out, crcs = tlz.decode_batch_device(payloads, [len(b) for b in blocks], STITCH_BS,
                                            batch_rows=2, poly=POLY, device="cpu")
        assert out == blocks
        if case == "short-block":
            assert crcs[-1] is None
            return crcs[:-1], payloads[:-1]
        return crcs, payloads
    # the stitch alone, frame-header heads over prefix lengths 0, 1, 9 and
    # >= 30 KB, the tails of a kernel known only by CRC and length
    rng = np.random.default_rng(8)
    lens = [0, 1, 9, 30 * 1024, 40000]
    heads = rng.integers(0, 256, 9 * len(lens), dtype=np.uint8).tobytes()
    prefixes = [rng.integers(0, 256, n + 3, dtype=np.uint8).tobytes() for n in lens]
    tails = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (7, 0, 64, 5000, 1)]
    got = checksum.stitch_crcs(POLY, [port_checksums.crc32c(t) for t in tails],
                               [len(t) for t in tails], heads=heads, head_len=9,
                               prefixes=prefixes, prefix_lens=lens)
    return got.tolist(), [heads[9 * i : 9 * i + 9] + p[:n] + t
                          for i, (p, n, t) in enumerate(zip(prefixes, lens, tails))]


@pytest.mark.parametrize("case", ["gensort-encode", "raw-escape", "gensort-decode",
                                  "short-block", "prefix-lengths"])
def test_stitched_crcs_are_the_stored_bytes_crc_with_and_without_the_library(case,
                                                                              monkeypatch):
    """``CudaCodec.compress_framed_fused``, ``decode_batch_device(poly=
    CRC32C)`` and the stitch itself give the same CRCs with the native
    library loaded and with it forced off, each a plain CRC32C of the
    stored bytes it covers."""
    import google_crc32c

    from s3shuffle_tpu_torch.codec import native

    assert native.native_available(), "the port's native library must build here"
    loaded, stored = _stitch_case(case)
    monkeypatch.setattr(native, "native_available", lambda: False)
    forced_off, stored_off = _stitch_case(case)
    assert stored_off == stored
    assert loaded == forced_off == [google_crc32c.value(s) for s in stored]
    assert all(type(c) is int for c in loaded)


@pytest.mark.parametrize("n", [0, 1, 9, 63, 64, 30 * 1024])
def test_host_crc32c_takes_the_library_and_equals_the_numpy_crc(n, monkeypatch):
    from s3shuffle_tpu_torch.codec import native

    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    value = 0x1234ABCD
    called = []
    real = native.native_crc32c
    monkeypatch.setattr(native, "native_crc32c", lambda *a: called.append(1) or real(*a))
    got = checksum.host_crc(data, POLY, value)
    assert called and got == port_checksums.crc32c(data, value)
    monkeypatch.setattr(native, "native_available", lambda: False)
    called.clear()
    assert checksum.host_crc(data, POLY, value) == got and not called
    assert checksum.host_crc(data, checksum.POLY_CRC32, value) == zlib.crc32(data, value)
