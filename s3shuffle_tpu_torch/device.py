"""Device resolution for the port's entry points.

Every entry point takes ``device=``: ``None`` (the default) and ``"cuda"``
mean the CUDA device; ``"cpu"`` selects the plain PyTorch versions of the
kernels and is only ever taken when asked for. A missing CUDA device is an
error, never a silent fall back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None``/``"cuda"``/``"cuda:N"``/``"cpu"`` (or a ``torch.device``)
    → a ``torch.device``. Raises RuntimeError when a CUDA device is asked
    for (explicitly or by default) and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: expected cuda or cpu")
    return dev
