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

from chip_smoke import k2_edge_blocks, wrapping_planes
from s3shuffle_tpu.ops import checksum as jax_checksum
from s3shuffle_tpu.ops import tlz as jax_tlz
from s3shuffle_tpu.ops import tlz_pallas
from s3shuffle_tpu_torch.ops import checksum, crc_cuda, tlz, tlz_cuda
from torch_jax_native import jax_native_library  # noqa: F401  (loads the JAX oracle's native library)

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


@pytest.mark.parametrize("bs,kind", [
    pytest.param(bs, kind, id=f"{kind}-{bs}") for bs in (512, 2048) for kind in KINDS
] + [
    # kernel K2's special cases (chip_smoke.k2_edge_blocks): sources at the
    # row's first bytes, forward sources clamped at its last byte, split
    # groups, distances 65535 and 65536 (8256 groups), and a width that is
    # not a multiple of K2's 124-group warp tile (300 groups)
    pytest.param(bs, "edges", id=f"edges-{bs}") for bs in (512, 2400, 66048)
])
def test_plane_decisions_plain_matches_xla_and_pallas(bs, kind):
    rng = np.random.default_rng(bs + len(kind))
    n_groups = bs // tlz.GROUP
    if kind == "edges":
        batch, cand_np = k2_edge_blocks(n_groups, bs)
        blocks, cand = torch.from_numpy(batch), torch.from_numpy(cand_np)
    else:
        batch = np.stack([
            np.frombuffer(_make_block(kind, bs, rng), dtype=np.uint8) for _ in range(2)
        ])
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


@pytest.mark.parametrize("dist_range", [(0, 300), (-300, 300)])
def test_fused_decode_plain_clamps_corrupt_planes_like_xla(dist_range):
    """Unvalidated planes (distances past the row start, split points out of
    range; with negative distances also forward pointers and pointer cycles
    longer than one): the plain decode clamps exactly as the XLA formulation
    does."""
    rng = np.random.default_rng(11)
    n_groups, b = 32, 6
    m = rng.random((b, n_groups)) < 0.5
    c = m & (rng.random((b, n_groups)) < 0.5)
    s = ~m & (rng.random((b, n_groups)) < 0.3)
    offs = rng.integers(*dist_range, (b, n_groups)).astype(np.int32)
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


def test_fused_decode_plain_wraps_int32_like_xla():
    """The reference computes source offsets in int32: a distance near -2**31
    wraps there before the clamp into the row. The plain decode equals the
    XLA math and the Pallas fused kernel (interpret mode) byte for byte and
    CRC for CRC on such planes."""
    n_groups = 64
    m, c, s, offs, ks, lits, nl = wrapping_planes(n_groups, 13)
    b = len(m)
    dec, raw = tlz.decode_fused_plain(
        *[torch.from_numpy(a) for a in (m, c, s, offs, ks, lits, nl)], n_groups, POLY
    )
    lits3 = lits.reshape(b, n_groups, tlz.GROUP)
    crc_fn = jax_checksum.raw_crc_graph_fn(POLY, n_groups * tlz.GROUP, b)
    x_dec, x_raw = jax_tlz._decode_fused_math(m, c, s, offs, ks, lits3, nl, n_groups, crc_fn)
    p_dec, p_raw = tlz_pallas.decode_fused_math_fn(n_groups, POLY)(m, c, s, offs, ks, lits3, nl)
    assert np.array_equal(dec.numpy(), np.asarray(x_dec))
    assert np.array_equal(dec.numpy(), np.asarray(p_dec))
    assert [int(v) for v in raw] == [int(v) for v in np.asarray(x_raw)]
    assert [int(v) for v in raw] == [int(v) for v in np.asarray(p_raw)]
    # row 0's match bytes wrap to offset 0 (the first literal byte), not n_bytes - 1
    first_lit = lits[0, 0]
    assert (dec.numpy()[0].reshape(n_groups, tlz.GROUP)[1::2, 3:] == first_lit).all()


@pytest.mark.parametrize("bs", [512, 2048])
@pytest.mark.parametrize("encoder", ["port", "jax"])
def test_validated_rows_take_the_segmented_route(encoder, bs):
    """Every row the parser stages (blocks of every kind and all-zero blocks,
    encoded by either package's batched encoder) holds no negative stored
    distance, so kernel K3 decodes it by its segmented route, and every byte
    source lies at most 65535 + 8 bytes before its position and never after
    it — the property the segmented route's look-back rests on."""
    rng = np.random.default_rng(bs + 17)
    blocks = [_make_block(k, bs, rng) for k in KINDS] + [bytes(bs)]
    blob = b"".join(blocks)
    enc = tlz if encoder == "port" else jax_tlz
    kwargs = {"device": "cpu"} if encoder == "port" else {}
    payloads, _ = enc.encode_batch_device(blob, len(blocks), bs, batch_blocks=8, **kwargs)
    st = _staged_planes([bytes(p) for p in payloads], bs)
    m, c, s, offs, ks, _lits, _nl = [torch.from_numpy(a) for a in st]
    assert not tlz.general_route_plain(offs).any()
    src = tlz.source_map_plain(m, c, s, offs, ks, bs // tlz.GROUP)
    pos = torch.arange(bs)[None, :]
    assert (src <= pos).all()
    assert (src >= pos - (tlz.MAX_DIST + tlz.GROUP)).all()
    assert (src < pos).any()  # the blocks do copy


def test_negative_distance_rows_take_the_general_route():
    """Planes with negative or extreme distances go to K3's general route;
    they hold forward pointers and cycles longer than one, which the
    segmented route could not resolve. Corrupt planes whose distances are
    all non-negative keep every source at or before its position, so the
    segmented route stays exact for them."""
    n_groups = 64
    m, c, s, offs, ks, _lits, _nl = [torch.from_numpy(a) for a in wrapping_planes(n_groups, 13)]
    assert tlz.general_route_plain(offs).all()
    src = tlz.source_map_plain(m, c, s, offs, ks, n_groups)
    pos = torch.arange(n_groups * tlz.GROUP)[None, :]
    forward = (src > pos).any(dim=1)
    assert forward[1] and forward[2]
    # row 2: bytes of group 0 point into group 1 and back — a 2-cycle
    assert torch.equal(src[2, src[2, :8]], pos[0, :8])
    rng = np.random.default_rng(3)
    offs_pos = torch.from_numpy(rng.integers(0, 2**31 - 1, offs.shape).astype(np.int32))
    assert not tlz.general_route_plain(offs_pos).any()
    assert (tlz.source_map_plain(m, c, s, offs_pos, ks, n_groups) <= pos).all()


def fold_segments(rows: np.ndarray, lengths, seg_bytes: int, n_seg: int, poly: int):
    """The raw CRC of each row's first ``lengths[r]`` bytes as kernels K1
    and K3 take it: the zero-init remainders of the segments
    ``crc_cuda.segment_spans`` gives (right-aligned in ``n_seg`` segments of
    ``seg_bytes``), folded with ``A^(seg_bytes * (n_seg - 1 - j))``."""
    lo, hi, active = crc_cuda.segment_spans(torch.tensor(lengths), n_seg, seg_bytes)
    cols = checksum.power_columns(poly, seg_bytes, n_seg)
    out = []
    for r, n in enumerate(lengths):
        assert int(active[r].sum()) == max(1, -(-n // seg_bytes))
        folded = 0
        for j in range(n_seg):
            a, b = int(lo[r, j]), int(hi[r, j])
            assert bool(active[r, j]) == (b > a or (n == 0 and j == n_seg - 1))
            if b <= a:
                continue
            part = int(checksum.crc_raw_plain(torch.from_numpy(rows[r : r + 1, a:b]), poly)[0])
            folded ^= int(np.bitwise_xor.reduce(
                np.where((part >> np.arange(32)) & 1, cols[n_seg - 1 - j], 0).astype(np.uint32)
            ))
        out.append(folded)
    return out


@pytest.mark.parametrize("caller,n_groups", [
    pytest.param("K3", n, id=str(n)) for n in (64, 300, 4096, 32768)
] + [pytest.param("K1", n, id=f"K1-{n}") for n in (64, 300, 4096, 32768)])
def test_segment_crc_fold_equals_the_literal_plane_crc(caller, n_groups):
    """K3 cuts each row's literal plane, right-aligned in a window of whole
    segments, into per-segment slices and folds their zero-init remainders
    with ``A^(seg_bytes * j)``, with the segment CRC of kernel K1, which cuts
    every row so: the fold equals the plane's raw CRC, for K3's segments
    (2048 groups, fewer in a short row) and K1's (16 KiB in every row, any
    length)."""
    n_bytes = n_groups * tlz.GROUP
    rng = np.random.default_rng(n_groups)
    lits = rng.integers(0, 256, (3, n_bytes), dtype=np.uint8)
    lit_len = [0, tlz.GROUP * int(rng.integers(1, n_groups)), n_bytes]
    if caller == "K3":
        seg_groups, n_seg, words = tlz_cuda.decode_layout(3, n_groups)
        assert seg_groups == min(tlz_cuda.SEG_GROUPS, n_groups)
        assert n_seg * seg_groups >= n_groups > (n_seg - 1) * seg_groups
        assert words == 4 + 2 * 3 + 8 * 3 * n_seg
        seg_bytes = seg_groups * tlz.GROUP
    else:
        lit_len[1] += 3  # K1 takes any length
        seg_bytes, n_seg = crc_cuda.SEG_BYTES, crc_cuda.segment_count(n_bytes)
    want = checksum.crc_raw_plain(
        torch.from_numpy(lits), POLY, torch.tensor(lit_len, dtype=torch.int32)
    )
    assert fold_segments(lits, lit_len, seg_bytes, n_seg, POLY) == [int(v) for v in want]


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


# --- the native plane validator, row for row against _validate_planes_v2 ---

LIT, NEW, CONT, SPLIT = 0, 1, 2, 3
VALIDATOR_BS = 4096
#: the raise branch each corruption aims at, one per branch of the
#: validator, as the JAX package's ``_validate_planes_v2`` words it (the
#: test asserts that the JAX validator raises it on the corrupt row)
CORRUPTIONS = {
    "no-leader": "TLZ continuation run has no leader",
    "distance-0": "TLZ v2 source distance out of range",
    "before-start": "TLZ v2 source distance out of range",
    "split-at-edge": "TLZ split group at block edge",
    "split-at-last-group": "TLZ split group at block edge",
    "split-no-neighbours": "TLZ split group without match neighbors",
    "k-0": "TLZ split point out of range",
    "k-8": "TLZ split point out of range",
    "negative-suffix": "TLZ split suffix distance out of range",
}
#: rows numpy accepts that tlz_decode_block's rules would not
ACCEPTED = ("gensort", "zeros", "cont-across-literals", "split-before-cont")
FLIP_SEEDS = range(8)


def _groups_of(payload, bs):
    """A valid v2 payload as per-group kinds, distances (a match's expanded
    distance) and split points."""
    _v, n_groups, m, c, s, dists, ks, _lits = tlz._parse_payload(payload, bs)
    kind = np.full(n_groups, LIT, np.int64)
    kind[m], kind[m & c], kind[s] = NEW, CONT, SPLIT
    dist = tlz._expand_dists_numpy(m, c, dists, n_groups) if m.any() else np.zeros(n_groups)
    k = np.zeros(n_groups, np.int64)
    k[s] = ks
    return kind, dist.astype(np.int64), k


def _planes(kind, dist, k):
    m = (kind == NEW) | (kind == CONT)
    c, s = kind == CONT, kind == SPLIT
    return m, c, s, dist[m & ~c].astype(np.int64), k[s].astype(np.uint8)


def _payload(kind, dist, k, block):
    m, c, s, d, ks = _planes(kind, dist, k)

    def pack(bits):
        return np.packbits(bits.astype(np.uint8), bitorder="little").tobytes()

    lits = block.reshape(len(kind), tlz.GROUP)[~m & ~s]
    return tlz._pack_meta(pack(m), pack(c), pack(s), d.astype("<u2").tobytes(), ks.tobytes(),
                          len(kind), level=0) + lits.tobytes()


def _base_row():
    """A valid hand-made row: new matches at groups 4, 7 and 13, their
    continuations at 5 and 8, a split at 6 between them, literals
    elsewhere."""
    n_groups = VALIDATOR_BS // tlz.GROUP
    kind = np.full(n_groups, LIT, np.int64)
    dist = np.zeros(n_groups, np.int64)
    k = np.zeros(n_groups, np.int64)
    kind[[4, 5, 6, 7, 8, 13]] = NEW, CONT, SPLIT, NEW, CONT, NEW
    dist[[4, 5, 7, 8, 13]] = 16, 16, 24, 24, 40
    k[6] = 3
    return kind, dist, k


def _corrupt(name, kind, dist, k):
    kind, dist, k = kind.copy(), dist.copy(), k.copy()
    last = len(kind) - 1
    edits = {
        "cont-across-literals": lambda: kind.__setitem__(10, CONT),
        "split-before-cont": lambda: (kind.__setitem__(14, SPLIT), kind.__setitem__(15, CONT),
                                      k.__setitem__(14, 5)),
        "no-leader": lambda: kind.__setitem__(4, CONT),
        "distance-0": lambda: dist.__setitem__(4, 0),
        "before-start": lambda: dist.__setitem__(4, 40),
        "split-at-edge": lambda: (kind.__setitem__(0, SPLIT), k.__setitem__(0, 3)),
        "split-at-last-group": lambda: (kind.__setitem__(last, SPLIT), k.__setitem__(last, 3)),
        "split-no-neighbours": lambda: (kind.__setitem__(10, SPLIT), k.__setitem__(10, 3)),
        "k-0": lambda: k.__setitem__(6, 0),
        "k-8": lambda: k.__setitem__(6, 8),
        "negative-suffix": lambda: dist.__setitem__(7, 56),
    }
    edits[name]()
    return kind, dist, k


def _flip(row, rng):
    """One to four random bit flips in the three planes, kept past the
    batch parse's cross-plane checks (continuations on matches, splits off
    them); a group that becomes a new match or a split gets a random
    distance or split point where it had none."""
    kind, dist, k = (a.copy() for a in row)
    m, c, s = (kind == NEW) | (kind == CONT), kind == CONT, kind == SPLIT
    for _ in range(int(rng.integers(1, 5))):
        plane, g = (m, c, s)[int(rng.integers(0, 3))], int(rng.integers(0, len(kind)))
        plane[g] = not plane[g]
    c &= m
    s &= ~m
    kind[:] = LIT
    kind[m], kind[c], kind[s] = NEW, CONT, SPLIT
    fresh = dist == 0
    dist[fresh] = rng.integers(0, 700, int(fresh.sum()))
    k[s & (k == 0)] = rng.integers(0, 9, int((s & (k == 0)).sum()))
    return kind, dist, k


def _validator_case(case):
    """(rows as (kind, dist, k), their blocks) of one case."""
    bs = VALIDATOR_BS
    from torch_gensort import gensort_blocks

    gensort = gensort_blocks(2, bs, 5)
    zeros = np.zeros((1, bs), np.uint8)
    noise = np.random.default_rng(9).integers(0, 256, (1, bs), dtype=np.uint8)
    if case in ("gensort", "zeros"):
        blocks = gensort if case == "gensort" else zeros
        payloads, _ = tlz.encode_batch_device(blocks.tobytes(), len(blocks), bs, device="cpu")
        return [_groups_of(p, bs) for p in payloads], list(blocks)
    if case.startswith("flips-"):
        rng = np.random.default_rng(int(case.split("-")[1]))
        blocks = np.concatenate([gensort, zeros, noise])
        payloads, _ = tlz.encode_batch_device(blocks[:3].tobytes(), 3, bs, device="cpu")
        rows = [_groups_of(p, bs) for p in payloads] + [_base_row()]
        return [_flip(r, rng) for r in rows], list(blocks)
    payloads, _ = tlz.encode_batch_device(gensort[:1].tobytes(), 1, bs, device="cpu")
    return ([_groups_of(payloads[0], bs), _base_row(), _corrupt(case, *_base_row())],
            [gensort[0], noise[0], noise[0]])


def _validator_message(validate, n_groups, planes):
    """None where ``validate`` accepts the row's planes, else its message."""
    m, c, s, d, ks = planes
    try:
        validate(n_groups, m, c, s, d, ks.astype(np.int64))
    except IOError as e:
        return str(e)
    return None


def _jax_decode(payload, bs):
    """The JAX package's numpy decode of one payload: its bytes, or its
    ``IOError`` message."""
    try:
        return jax_tlz.decode_payload_numpy(payload, bs, use_native=False), None
    except IOError as e:
        return None, str(e)


@pytest.mark.parametrize("case", list(ACCEPTED) + list(CORRUPTIONS)
                         + [f"flips-{s}" for s in FLIP_SEEDS])
def test_native_validator_accepts_and_rejects_as_numpy(case, monkeypatch):
    """The native batch validator and the port's numpy
    ``_validate_planes_v2`` accept or reject each row, with the same
    message, as the JAX package's ``_validate_planes_v2`` does: planes of
    real encodes (GenSort and zero blocks), one corruption per raise branch
    beside valid rows, and seeded random bit flips in the three planes.
    ``decode_batch_device``, with the library loaded and with it forced
    off, decodes each row to the JAX package's numpy decode of the same
    payload, or raises its ``IOError`` message."""
    from s3shuffle_tpu_torch.codec import native

    assert native.native_available(), "the port's native library must build here"
    bs = VALIDATOR_BS
    n_groups = bs // tlz.GROUP
    rows, blocks = _validator_case(case)
    planes = [_planes(*r) for r in rows]
    got = native.tlz_validate_v2(*(np.stack([p[i] for p in planes]) for i in range(3)),
                                 [p[3] for p in planes], [p[4] for p in planes])
    messages = []
    for row_planes, ok in zip(planes, got):
        want = _validator_message(jax_tlz._validate_planes_v2, n_groups, row_planes)
        assert _validator_message(tlz._validate_planes_v2, n_groups, row_planes) == want, case
        assert bool(ok) == (want is None), (case, want)
        messages.append(want)
    if case in ACCEPTED:
        assert all(msg is None for msg in messages)
    elif case in CORRUPTIONS:
        assert messages == [None, None, CORRUPTIONS[case]]
    for row, block, msg in zip(rows, blocks, messages):
        payload = _payload(*row, block)
        want, want_err = _jax_decode(payload, bs)
        assert want_err == msg, case
        for available in (True, False):
            monkeypatch.setattr(native, "native_available", lambda a=available: a)
            if want_err is None:
                out, _ = tlz.decode_batch_device([payload], [bs], bs, device="cpu")
                assert out == [want]
                if case in ("gensort", "zeros"):
                    assert out == [block.tobytes()]
            else:
                with pytest.raises(IOError) as err:
                    tlz.decode_batch_device([payload], [bs], bs, device="cpu")
                assert str(err.value) == want_err
