"""Device resolution for the port's entry points.

Every entry point takes ``device=``: ``None`` (the default) and ``"cuda"``
mean the CUDA device; ``"cpu"`` selects the plain PyTorch versions of the
kernels and is only ever taken when asked for. A missing CUDA device is an
error, never a silent fall back to the CPU.
"""

from __future__ import annotations

import contextlib

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


@contextlib.contextmanager
def on_device(device):
    """Run a block of device work from any thread: for a CUDA device, make
    it the thread's current device and synchronise its current stream on
    exit, so host bytes taken from its results are final. A CPU device (or
    None) needs neither."""
    dev = None if device is None else torch.device(device)
    if dev is None or dev.type != "cuda":
        yield
        return
    with torch.cuda.device(dev):
        try:
            yield
        finally:
            torch.cuda.current_stream(dev).synchronize()
