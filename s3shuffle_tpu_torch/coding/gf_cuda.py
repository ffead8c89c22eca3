"""Kernel K4: batched GF(2^8) parity encode on the GPU.

Replaces the JAX package's Pallas kernel ``_make_kernel``
(``s3shuffle_tpu/coding/gf_pallas.py:76``). ``gfmul(c, .)`` with a fixed
coefficient is GF(2)-linear over the bits of its argument, so with the bit
constants ``consts[i, j, a] = gfmul(C[i][j], 1 << a)`` one parity byte is

    P[g, i] = XOR_j XOR_a  where(bit_a(D[g, j]), consts[i, j, a], 0)

over ``chunks[G, k, L]`` uint8 → ``parity[G, m, L]`` uint8: no table
gathers, only selects and XORs.

Bound on an H100: the bytes at the coded path's shapes (``[16, 2, 1 MiB]``
at m = 2: 32 MiB in, 32 MiB out), the integer operations for large m·k.
``csrc/gf_encode.cu`` gives each thread 16 contiguous bytes of one group's
rows, reads each data byte once for all parity rows of its CTA, and keeps
the parity in registers (see the source for the design). It takes any G, L,
m and k: the kernel masks the ragged edges itself.
"""

from __future__ import annotations

import torch

from s3shuffle_tpu_torch.ops import _build


def encode_groups_plain(chunks: torch.Tensor, consts: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``chunks[G, k, L]`` uint8 and bit
    constants ``consts[m, k, 8]`` uint8 → ``[G, m, L]`` uint8, one
    select-and-XOR per (data chunk, bit) over every parity row at once."""
    groups, k, length = chunks.shape
    m = consts.shape[0]
    out = torch.zeros((groups, m, length), dtype=torch.uint8, device=chunks.device)
    for j in range(k):
        d = chunks[:, j, :].unsqueeze(1)  # [G, 1, L]
        for a in range(8):
            out ^= ((d >> a) & 1) * consts[:, j, a].view(1, m, 1)
    return out


def encode(chunks: torch.Tensor, consts: torch.Tensor) -> torch.Tensor:
    """``chunks[G, k, L]`` × bit constants ``consts[m, k, 8]`` → parity
    ``[G, m, L]`` (all uint8).

    A CPU tensor takes :func:`encode_groups_plain`; a CUDA tensor launches
    kernel K4 or raises."""
    if chunks.device.type == "cpu":
        return encode_groups_plain(chunks, consts)
    groups, k, length = chunks.shape
    m = consts.shape[0]
    _build.require_cuda("chunks", chunks, torch.uint8)
    _build.require_cuda("consts", consts, torch.uint8, (m, k, 8))
    if consts.device != chunks.device:
        raise ValueError(f"consts on {consts.device}, chunks on {chunks.device}")
    out = torch.empty((groups, m, length), dtype=torch.uint8, device=chunks.device)
    if out.numel():
        lib = _build.library()
        rc = lib.gf_encode_launch(
            chunks.data_ptr(), consts.data_ptr(), groups, k, m, length,
            out.data_ptr(), _build.stream_ptr(chunks.device),
        )
        _build.check(rc, "gf_encode")
        _build.count_launch("gf_encode")
    return out
