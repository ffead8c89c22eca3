"""GF(2^8) arithmetic for the coded shuffle plane (the JAX package's
``coding/gf.py``).

Parity segment *i* over the k data chunks of one stripe group is
``P_i = XOR_j gfmul(C[i][j], D_j)`` with the Vandermonde rows
``C[i][j] = alpha^(i*j)``: row 0 is all ones (plain XOR, the RAID-5 P
parity), row 1 the RAID-6 Q polynomial. Any k of the ``k + m`` segments
reconstruct a group by solving a small linear system over the field;
for m >= 3 the decoder tries the other parity subsets when one is singular.

Encode is batched: :func:`encode_groups` takes every pending stripe group
as one ``[G, k, L]`` array and runs kernel K4 (``coding/gf_cuda.py``) on
the CUDA device for every batch, or its plain PyTorch version when the
caller passes ``device="cpu"``. Decode (:func:`recover_group`) solves on
the host; the survivors' contribution to the parity is again a batched
:func:`encode_groups` on the same device.
"""

from __future__ import annotations

import functools
from itertools import combinations
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from s3shuffle_tpu_torch.coding import gf_cuda
from s3shuffle_tpu_torch.device import resolve_device

#: primitive polynomial x^8+x^4+x^3+x^2+1, the standard Reed-Solomon choice
_POLY = 0x11D

# exp table doubled so exp[log a + log b] never needs a mod in multiply
_EXP = np.zeros(512, dtype=np.uint8)
_LOG = np.zeros(256, dtype=np.int32)
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= _POLY
_EXP[255:510] = _EXP[:255]
del _x, _i


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(_EXP[int(_LOG[a]) + int(_LOG[b])])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(256) inverse of 0")
    return int(_EXP[255 - int(_LOG[a])])


def gf_mul_bytes(coef: int, data: np.ndarray) -> np.ndarray:
    """``gfmul(coef, byte)`` over a uint8 array (any shape), vectorized."""
    if coef == 0:
        return np.zeros_like(data)
    if coef == 1:
        return data.copy()
    out = _EXP[_LOG[data] + int(_LOG[coef])]
    out[data == 0] = 0
    return out


def parity_coefficients(segments: int, stripe_k: int) -> np.ndarray:
    """The ``[m, k]`` Vandermonde coefficient matrix ``alpha^(i*j)``.
    Row 0 is all ones (XOR parity)."""
    if segments < 1 or stripe_k < 1:
        raise ValueError("parity needs m >= 1, k >= 1")
    if segments + stripe_k > 255:
        raise ValueError("GF(256) coding supports k + m <= 255")
    i = np.arange(segments).reshape(-1, 1)
    j = np.arange(stripe_k).reshape(1, -1)
    return _EXP[(i * j) % 255].astype(np.uint8)


def bit_constants(coefs: np.ndarray) -> np.ndarray:
    """``consts[i, j, a] = gfmul(coefs[i, j], 1 << a)`` as ``[m, k, 8]``
    uint8: what K4 multiplies by."""
    m, k = coefs.shape
    return np.array(
        [[[gf_mul(int(coefs[i, j]), 1 << a) for a in range(8)] for j in range(k)]
         for i in range(m)],
        dtype=np.uint8,
    ).reshape(m, k, 8)


@functools.lru_cache(maxsize=32)
def _device_constants(coef_bytes: bytes, m: int, k: int, device: torch.device) -> torch.Tensor:
    coefs = np.frombuffer(coef_bytes, dtype=np.uint8).reshape(m, k)
    return torch.from_numpy(bit_constants(coefs)).to(device)


def _mesh_dispatcher(device: torch.device):
    """The armed dispatcher (``parallel/dispatch.py``) for a call on
    ``device``, or None for single-device placement."""
    from s3shuffle_tpu_torch.parallel import dispatch

    return dispatch.get_dispatcher(device.type)


def _encode_striped(chunks: np.ndarray, coefs: np.ndarray, disp) -> np.ndarray:
    """Parity placement over the dispatcher's lanes (the JAX package's
    ``_encode_striped``): the group axis splits at ``np.linspace`` bounds
    into one slice per lane, each slice launches K4 on the least-loaded
    lane's stream, and the slices gather in order once every lane has
    launched. Byte-identical to the unstriped encode (per-group math)."""
    m, k = coefs.shape
    groups = chunks.shape[0]
    n_lanes = max(1, min(disp.n_devices, groups))
    bounds = np.linspace(0, groups, n_lanes + 1).astype(np.int64)
    launched = []
    try:
        for i in range(n_lanes):
            lo, hi = int(bounds[i]), int(bounds[i + 1])
            if lo == hi:
                continue
            slot = disp.acquire()
            launched.append((slot, None))
            dev = disp.device(slot)
            with disp.lane(slot):
                consts = _device_constants(coefs.tobytes(), m, k, dev)
                parity = gf_cuda.encode(
                    torch.from_numpy(chunks[lo:hi]).to(dev, non_blocking=True), consts
                )
            launched[-1] = (slot, parity)
        # drain AFTER every lane launched, in order
        parts = []
        for slot, parity in launched:
            with disp.lane(slot):
                parts.append(parity.cpu().numpy())
    finally:
        for slot, _parity in launched:
            disp.release(slot)
    return np.concatenate(parts, axis=0)


def encode_groups(chunks: np.ndarray, coefs: np.ndarray, device=None) -> np.ndarray:
    """Encode a batch of stripe groups: ``chunks[G, k, L]`` uint8 ×
    ``coefs[m, k]`` → ``parity[G, m, L]`` uint8. Kernel K4 on the CUDA
    device (the default) for every batch; its plain PyTorch version with
    ``device="cpu"``. With the mesh dispatcher armed the groups stripe over
    its lanes (:func:`_encode_striped`)."""
    dev = resolve_device(device)
    chunks = np.ascontiguousarray(chunks, dtype=np.uint8)
    if not chunks.flags.writeable:
        chunks = chunks.copy()  # torch.from_numpy wants a writable buffer
    coefs = np.ascontiguousarray(coefs, dtype=np.uint8)
    disp = _mesh_dispatcher(dev)
    if disp is not None:
        return _encode_striped(chunks, coefs, disp)
    consts = _device_constants(coefs.tobytes(), coefs.shape[0], coefs.shape[1], dev)
    parity = gf_cuda.encode(torch.from_numpy(chunks).to(dev), consts)
    return parity.cpu().numpy()


# ---------------------------------------------------------------------------
# Decode: recover erased data chunks of one stripe group
# ---------------------------------------------------------------------------


def _gauss_solve(
    matrix: List[List[int]], rhs: List[np.ndarray]
) -> Optional[List[np.ndarray]]:
    """Solve ``A x = b`` over GF(256); A is a small list-of-ints matrix, b a
    list of equal-length uint8 arrays. Returns the solution arrays or None
    when A is singular."""
    n = len(matrix)
    a = [row[:] for row in matrix]
    b = [v.copy() for v in rhs]
    for col in range(n):
        pivot = next((r for r in range(col, n) if a[r][col] != 0), None)
        if pivot is None:
            return None
        if pivot != col:
            a[col], a[pivot] = a[pivot], a[col]
            b[col], b[pivot] = b[pivot], b[col]
        inv = gf_inv(a[col][col])
        if inv != 1:
            a[col] = [gf_mul(inv, v) for v in a[col]]
            b[col] = gf_mul_bytes(inv, b[col])
        for r in range(n):
            if r == col or a[r][col] == 0:
                continue
            f = a[r][col]
            a[r] = [a[r][c] ^ gf_mul(f, a[col][c]) for c in range(n)]
            b[r] = b[r] ^ gf_mul_bytes(f, b[col])
    return b


def recover_group(
    stripe_k: int,
    coefs: np.ndarray,
    data_present: Dict[int, np.ndarray],
    parity_present: Dict[int, np.ndarray],
    want: Sequence[int],
    device=None,
) -> Optional[Dict[int, np.ndarray]]:
    """Recover the ``want`` data chunks of one stripe group from any
    sufficient subset of surviving segments.

    ``data_present`` maps data-chunk position -> uint8 array (all the same
    length L, already zero-padded); ``parity_present`` maps parity index ->
    its group chunk. Returns ``{position: chunk}`` for every requested
    position, or None when the survivors cannot determine them (fewer than
    k segments, or every parity subset singular). The survivors'
    contribution is encoded on ``device`` (K4 on the CUDA device).
    """
    unknown = sorted(set(range(stripe_k)) - set(data_present))
    missing_wanted = [w for w in want if w not in data_present]
    if not missing_wanted:
        return {w: data_present[w] for w in want}
    need = len(unknown)
    if need > len(parity_present):
        return None
    present_pos = sorted(data_present)
    stacked = (
        np.stack([data_present[j] for j in present_pos])
        if present_pos
        else None
    )
    for combo in combinations(sorted(parity_present), need):
        a = [[int(coefs[i][j]) for j in unknown] for i in combo]
        if stacked is None:
            b = [parity_present[i].copy() for i in combo]
        else:
            sub = np.array(
                [[int(coefs[i][j]) for j in present_pos] for i in combo],
                dtype=np.uint8,
            )
            contrib = encode_groups(stacked[None, :, :], sub, device)[0]
            b = [parity_present[i] ^ contrib[r] for r, i in enumerate(combo)]
        sol = _gauss_solve(a, b)
        if sol is not None:
            solved = dict(zip(unknown, sol))
            solved.update(data_present)
            return {w: solved[w] for w in want}
    return None
