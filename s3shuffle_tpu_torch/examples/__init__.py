"""The user-facing drivers of the port: the JAX package's ``examples/``
drivers, run over ``s3shuffle_tpu_torch``.

Each driver has ``main(argv=None) -> int`` and runs as ``python -m
s3shuffle_tpu_torch.examples.<name>``:

- ``terasort``: TeraSort through ``ShuffleContext.sort_by_key`` and
  TeraValidate;
- ``sql_queries``: the six TPC-DS-shaped query pipelines (q5, q49, q75,
  q67, q64, q95) over the typed record paths, each verified against a
  plain-Python reference;
- ``query_shuffles``: the four shuffle profiles of the reference's TPC-DS
  harness;
- ``multihost_terasort``: a ``DistributedDriver`` coordinator with ``python
  -m s3shuffle_tpu_torch.worker`` agents;
- ``ici_to_store``: the mesh-routed shuffle (``parallel.make_mesh`` +
  ``mesh_shuffle_to_store``) landing in the store.

Every driver takes ``--device``: by default the CUDA device, ``cpu`` (the
plain PyTorch versions of the kernels) only when asked for; with no card
and no ``--device cpu`` it raises, as ``device.resolve_device`` does. Each
prints the JAX driver's JSON line with the same keys, except that the host
calibration of the JAX drivers (from its ``bench.py``) is replaced by the
card's ``name`` and ``power_limit`` as ``nvidia-smi`` gives them (null on
the CPU).
"""

from __future__ import annotations

import subprocess


def card_fields(device) -> dict:
    """``{"name", "power_limit"}`` of the card ``device`` (a resolved
    ``torch.device``) as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them; both None on the CPU."""
    if device.type != "cuda":
        return {"name": None, "power_limit": None}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={device.index or 0}"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    name, _sep, power = out.partition(",")
    return {"name": name.strip(), "power_limit": power.strip()}


def config_codec(label: str) -> str:
    """The ``ShuffleConfig.codec`` of a driver's ``--codec`` label. The JAX
    drivers' ``tpu-hostpath`` label selects the JAX codec's host fallback,
    which the port does not have (nothing hides the device), so it is
    refused; every other label is a codec name (``tpu`` included)."""
    if label == "tpu-hostpath":
        raise ValueError(
            "--codec tpu-hostpath selects the JAX codec's host fallback; the port has "
            "none (its kernels run on the device asked for, never rerouted to the "
            "host): use --codec tpu, with --device cpu for the plain versions"
        )
    return label
