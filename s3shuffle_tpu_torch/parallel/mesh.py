"""Device mesh helper (the JAX package's ``parallel/mesh.py``).

A :class:`Mesh` is a grid of torch devices with named axes, the shape of
``jax.sharding.Mesh``: ``mesh.shape`` maps each axis name to its size and
``mesh.devices`` holds the grid. The repartition (``parallel/repartition.py``)
runs one lane per device along an axis.

One departure from the JAX package: a device may appear more than once.
JAX builds a mesh of distinct devices only; here a grid such as
``[cuda:0] * 4`` is four lanes on one card, each with its own stream, which
is how one GPU (or the CPU in the tests) runs the plane's armed paths. The
JAX ``get_shard_map`` has no counterpart: the port's collective is peer
copies, not a ``shard_map``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """Named axes over a grid of torch devices."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D device grid for axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names: Tuple[str, ...] = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name → size, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def lanes(self, axis: str) -> Tuple[torch.device, ...]:
        """The devices along ``axis`` of a mesh whose other axes have size 1
        (the repartition's 1-D view), in lane order."""
        if axis not in self.axis_names:
            raise ValueError(f"no axis {axis!r} in mesh axes {self.axis_names}")
        if self.size != self.shape[axis]:
            raise ValueError(f"mesh {self.shape} is not one-dimensional along {axis!r}")
        return tuple(self.devices.reshape(-1))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.reshape(-1)]})"


def make_mesh(axes: Optional[Mapping[str, int]] = None, devices=None) -> Mesh:
    """Build a :class:`Mesh`.

    ``axes`` maps axis name → size (e.g. ``{"data": 4, "block": 2}``); by
    default a 1-D ``{"data": n_devices}`` mesh over every local CUDA device
    (``dispatch.local_devices("cuda")``). Sizes must multiply to the device
    count used; a device may repeat (see the module docstring)."""
    from s3shuffle_tpu_torch.parallel import dispatch

    devices = list(devices if devices is not None else dispatch.local_devices("cuda"))
    devices = [torch.device(d) for d in devices]
    if axes is None:
        axes = {"data": len(devices)}
    names = tuple(axes.keys())
    sizes = tuple(axes.values())
    total = int(np.prod(sizes))
    if total != len(devices):
        raise ValueError(f"mesh axes {dict(axes)} need {total} devices, have {len(devices)}")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(sizes), names)
