"""The multi-GPU plane: lanes over local devices, the on-device
repartition and the mesh-routed shuffle (the JAX package's ``parallel/``).

The JAX package repartitions sharded record batches with ``shard_map`` +
``all_to_all`` over a ``jax.sharding.Mesh`` in one process. The port keeps
that single-controller shape: one process drives a tuple of CUDA devices
(its lanes), and the exchange is peer copies on each lane's stream, not
``torch.distributed``, which would turn a one-process call into a
multi-process one. ``dispatch.py`` places the batch kernels (K1-K4) on the
lanes; ``repartition.py`` and ``ici_shuffle.py`` route fixed-width rows to
their owner lanes and commit each lane's partitions through the store.
"""

from s3shuffle_tpu_torch.parallel.ici_shuffle import mesh_shuffle_to_store
from s3shuffle_tpu_torch.parallel.mesh import make_mesh
from s3shuffle_tpu_torch.parallel.repartition import device_repartition, plan_capacity

__all__ = [
    "make_mesh",
    "device_repartition",
    "plan_capacity",
    "mesh_shuffle_to_store",
]
