"""Mesh-routed shuffle that lands in the store (the JAX package's
``parallel/ici_shuffle.py``): the repartition for the data motion, the
write and read planes for durability.

Record rows route to their owner lanes through
:func:`~s3shuffle_tpu_torch.parallel.repartition.device_repartition` (peer
copies between the lanes' devices, no object store traffic for the
exchange), and each lane then commits ITS partitions through the ordinary
write plane (codec, index, checksum sidecars) as one map output whose map
id is the lane index. Readers, including hosts with no mesh, read the
result with the standard read plane; partition ``p`` lives in lane
``p % lanes``'s map output.

Fixed-shape contract (the JAX one): rows are fixed-width (uniform key and
value widths, the TeraSort/TPC-DS record shape) and every lane contributes
the same local row count, padded with flagged rows that receivers drop.
Variable-width or heavily skewed data stays on the store path
(:func:`mesh_shuffle_or_fallback`).
"""

from __future__ import annotations

import logging
from typing import List, Sequence, Tuple

import numpy as np

from s3shuffle_tpu_torch.metrics import registry as _metrics
from s3shuffle_tpu_torch.parallel.repartition import device_repartition, plan_capacity

logger = logging.getLogger("s3shuffle_tpu_torch.parallel")

_C_ROUTED = _metrics.REGISTRY.counter(
    "mesh_route_rows_total",
    "Real rows routed to their owner devices over the ICI mesh (padding "
    "rows excluded)",
)

#: leading row byte: 1 = real row, 0 = padding (dropped by receivers)
_FLAG_BYTES = 1


def batch_to_rows(batch, key_bytes: int, value_bytes: int) -> np.ndarray:
    """Pack a uniform-width RecordBatch into flagged fixed-width rows:
    ``(n, 1 + key_bytes + value_bytes)`` uint8 with the flag byte set."""
    if batch.n == 0:
        return np.zeros((0, _FLAG_BYTES + key_bytes + value_bytes), dtype=np.uint8)
    if not ((batch.klens == key_bytes).all() and (batch.vlens == value_bytes).all()):
        raise ValueError(
            "mesh routing needs uniform key/value widths "
            f"({key_bytes}/{value_bytes}); got ragged records"
        )
    rows = np.empty((batch.n, _FLAG_BYTES + key_bytes + value_bytes), dtype=np.uint8)
    rows[:, 0] = 1
    rows[:, _FLAG_BYTES : _FLAG_BYTES + key_bytes] = batch.keys.reshape(batch.n, key_bytes)
    rows[:, _FLAG_BYTES + key_bytes :] = batch.values.reshape(batch.n, value_bytes)
    return rows


def rows_to_batch(rows: np.ndarray, key_bytes: int, value_bytes: int):
    """Unpack flagged fixed-width rows (already filtered to real rows) into
    a RecordBatch."""
    from s3shuffle_tpu_torch.batch import RecordBatch

    n = rows.shape[0]
    return RecordBatch(
        klens=np.full(n, key_bytes, dtype=np.int32),
        vlens=np.full(n, value_bytes, dtype=np.int32),
        keys=np.ascontiguousarray(rows[:, _FLAG_BYTES : _FLAG_BYTES + key_bytes]).reshape(-1),
        values=np.ascontiguousarray(rows[:, _FLAG_BYTES + key_bytes :]).reshape(-1),
    )


def _write_map(manager, handle, map_id: int, batch) -> None:
    writer = manager.get_writer(handle, map_id=map_id)
    try:
        writer.write(batch)
        writer.stop(success=True)
    except BaseException:
        writer.stop(success=False)
        raise


def mesh_shuffle_to_store(
    mesh,
    batches: Sequence,
    manager,
    partitioner,
    key_bytes: int,
    value_bytes: int,
    shuffle_id: int | None = None,
    axis: str = "data",
    capacity: int | None = None,
) -> Tuple[object, List[int]]:
    """Route ``batches`` (one RecordBatch per lane along ``axis``) to their
    owner lanes, then commit each lane's received rows through the write
    plane as that lane's map output.

    Returns ``(handle, rows_per_device)``. Afterwards any reader
    (``manager.get_reader(handle, p, p + 1)``) serves partition ``p`` from
    the store with the standard read plane."""
    from s3shuffle_tpu_torch.dependency import ShuffleDependency

    n_dev = mesh.shape[axis]
    if len(batches) != n_dev:
        raise ValueError(f"need one batch per device: {len(batches)} != {n_dev}")
    row_bytes = _FLAG_BYTES + key_bytes + value_bytes

    # equal local counts (static shapes): pad every lane to the max with
    # flagged rows routed round-robin and dropped on receipt
    locals_ = [batch_to_rows(b, key_bytes, value_bytes) for b in batches]
    ids_ = [
        partitioner.partition_batch(b).astype(np.int32) if b.n else np.zeros(0, np.int32)
        for b in batches
    ]
    local_n = max((r.shape[0] for r in locals_), default=1) or 1
    rows = np.zeros((n_dev * local_n, row_bytes), dtype=np.uint8)
    part_ids = np.zeros(n_dev * local_n, dtype=np.int32)
    for d, (r, pid) in enumerate(zip(locals_, ids_)):
        rows[d * local_n : d * local_n + r.shape[0]] = r
        part_ids[d * local_n : d * local_n + r.shape[0]] = pid
        # padding rows carry flag 0 and round-robin destinations, so no
        # single lane absorbs a lane's whole pad count
        n_pad = local_n - r.shape[0]
        part_ids[d * local_n + r.shape[0] : (d + 1) * local_n] = (
            np.arange(n_pad, dtype=np.int32) % n_dev
        )

    if capacity is None:
        capacity = plan_capacity(local_n, n_dev)
    recv, _recv_ids, valid = device_repartition(mesh, rows, part_ids, axis=axis,
                                                capacity=capacity)

    # --- store leg: one map output per lane through the write plane ---
    if shuffle_id is None:
        shuffle_id = 0
    dep = ShuffleDependency(shuffle_id=shuffle_id, partitioner=partitioner)
    handle = manager.register_shuffle(shuffle_id, dep)
    rows_per_device: List[int] = []
    for d in range(n_dev):
        shard = recv[d].cpu().numpy()
        ok = valid[d].cpu().numpy() & (shard[:, 0] == 1)
        real = shard[ok]
        rows_per_device.append(int(real.shape[0]))
        _write_map(manager, handle, d, rows_to_batch(real, key_bytes, value_bytes))
    if _metrics.enabled():
        _C_ROUTED.inc(sum(rows_per_device))
    return handle, rows_per_device


def mesh_shuffle_or_fallback(
    mesh,
    batches: Sequence,
    manager,
    partitioner,
    key_bytes: int,
    value_bytes: int,
    shuffle_id: int | None = None,
    axis: str = "data",
    capacity: int | None = None,
) -> Tuple[object, List[int], bool]:
    """:func:`mesh_shuffle_to_store` with the fixed-shape contract made
    explicit: ragged inputs (the ValueError of :func:`batch_to_rows`) fall
    back to the store path (one writer per input batch, no mesh leg). Skew
    beyond :func:`plan_capacity`'s slack (the repartition-overflow
    ValueError) retries ONCE at the guaranteed per-peer bound (a sender's
    whole padded lane, the most any single peer can receive from it); a
    caller-pinned ``capacity`` opts out of the retry and sees the overflow.

    Returns ``(handle, rows_per_device, used_mesh)``; on fallback
    ``rows_per_device`` holds the per-map-output row counts."""
    attempts = [capacity]
    if capacity is None:
        attempts.append(max((int(b.n) for b in batches), default=1) or 1)
    for i, cap in enumerate(attempts):
        try:
            handle, per_dev = mesh_shuffle_to_store(
                mesh, batches, manager, partitioner, key_bytes, value_bytes,
                shuffle_id=shuffle_id, axis=axis, capacity=cap,
            )
            return handle, per_dev, True
        except ValueError as exc:
            msg = str(exc)
            if "repartition overflow" in msg and i + 1 < len(attempts):
                logger.warning(
                    "mesh route skewed past planned capacity (%s); retrying at the "
                    "guaranteed per-peer bound %d rows", exc, attempts[i + 1],
                )
                continue
            if "uniform key/value widths" not in msg:
                raise
            logger.warning("mesh route declined (%s); falling back to host path", exc)
            break

    from s3shuffle_tpu_torch.dependency import ShuffleDependency

    dep = ShuffleDependency(
        shuffle_id=shuffle_id if shuffle_id is not None else 0, partitioner=partitioner
    )
    handle = manager.register_shuffle(dep.shuffle_id, dep)
    rows_per_map: List[int] = []
    for d, batch in enumerate(batches):
        _write_map(manager, handle, d, batch)
        rows_per_map.append(int(batch.n))
    return handle, rows_per_map, False
