"""On-device shuffle repartition: rows on their lanes → owner lanes (the
JAX package's ``parallel/repartition.py``).

The device analog of the map-side partitioner and the reduce-side fetch:
each lane of a mesh axis holds a local batch of fixed-width records (uint8
rows) and a target partition id per row; the repartition routes every row to
the lane that owns its partition (``id % lanes``) without the object store.

In the JAX package this is one jitted ``shard_map`` step with
``all_to_all`` over the local mesh. Here it is one process driving its
lanes: each lane runs the JAX ``local_step`` as plain PyTorch on its own
device and stream (stable sort by destination, per-destination counts,
bucket offsets, a scatter into ``(lanes, capacity, row_bytes)`` that drops
rows past capacity, the overflow count), and the all-to-all is peer copies
(``Tensor.to(lane_device, non_blocking=True)`` on the receiving lane's
stream, after an event of each sending lane). The repartition is no Pallas
kernel in the JAX package, so plain PyTorch is its port.

Static-shape contract (the JAX one): each lane sends exactly ``capacity``
rows to every peer, padding short buckets; the counts travel beside the
rows so receivers mask the padding. Overflow beyond capacity raises at the
call boundary with the JAX message (callers size capacity with
:func:`plan_capacity`; the store path remains the fallback for skew).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from s3shuffle_tpu_torch.parallel import dispatch


def plan_capacity(local_rows: int, n_devices: int, slack: float = 2.0) -> int:
    """Rows-per-peer capacity for a balanced-ish shuffle with ``slack``×
    headroom over perfectly uniform routing."""
    return max(1, math.ceil(local_rows / max(1, n_devices) * slack))


def local_step(rows: torch.Tensor, part_ids: torch.Tensor, n_dev: int, capacity: int):
    """One lane's send side: ``rows`` (n_local, row_bytes) uint8 and
    ``part_ids`` (n_local,) int32 → ``send`` (n_dev, capacity, row_bytes),
    ``send_ids`` (n_dev, capacity), ``send_counts`` (n_dev,) and the
    overflow (rows dropped past capacity), on ``rows``' device."""
    n_local, row_bytes = rows.shape
    dev = rows.device
    dest = torch.remainder(part_ids.to(torch.int64), n_dev)
    # stable sort by destination so each peer's rows are contiguous
    order = torch.argsort(dest, stable=True)
    rows_sorted = rows[order]
    dest_sorted = dest[order]
    ids_sorted = part_ids[order]
    counts = torch.bincount(dest, minlength=n_dev)
    starts = torch.cumsum(counts, 0) - counts
    within = torch.arange(n_local, device=dev) - starts[dest_sorted]
    # rows past capacity land in one spare slot that is cut away (the JAX
    # scatter's mode="drop", without a mask that would wait for the
    # device), so they never clobber an in-capacity slot
    slot = torch.clamp(within, max=capacity)
    send = torch.zeros((n_dev, capacity + 1, row_bytes), dtype=rows.dtype, device=dev)
    send_ids = torch.zeros((n_dev, capacity + 1), dtype=part_ids.dtype, device=dev)
    send[dest_sorted, slot] = rows_sorted
    send_ids[dest_sorted, slot] = ids_sorted
    send, send_ids = send[:, :capacity], send_ids[:, :capacity]
    overflow = torch.clamp(counts - capacity, min=0).sum()
    send_counts = torch.clamp(counts, max=capacity)
    return send, send_ids, send_counts, overflow


def device_repartition(
    mesh, rows, part_ids, axis: str = "data", capacity: Optional[int] = None
) -> Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
    """Repartition records across the lanes of ``mesh`` along ``axis``.

    ``rows``: (N, row_bytes) uint8 (numpy or a tensor on any device), lane
    ``d`` holding rows ``[d * N / lanes, (d + 1) * N / lanes)``;
    ``part_ids``: (N,) int32 target partition ids (owner lane = id % lanes).
    Returns per-lane lists ``(received_rows, received_ids, valid_mask)``,
    each entry on its lane's device with ``lanes * capacity`` rows (the
    rows from lane 0 first); concatenated in lane order they equal the JAX
    function's outputs. Raises ValueError when rows overflowed ``capacity``
    (the JAX message)."""
    lanes = mesh.lanes(axis)
    n_dev = len(lanes)
    rows = torch.as_tensor(rows)
    part_ids = torch.as_tensor(part_ids)
    n, row_bytes = rows.shape
    if n % n_dev != 0:
        raise ValueError(f"row count {n} must divide evenly over {n_dev} devices")
    local_n = n // n_dev
    if capacity is None:
        capacity = plan_capacity(local_n, n_dev)
    streams = dispatch.lane_streams(lanes)

    sent = []
    for d, (dev, stream) in enumerate(zip(lanes, streams)):
        with dispatch.on_lane(stream):
            lo, hi = d * local_n, (d + 1) * local_n
            local = local_step(rows[lo:hi].to(dev, non_blocking=True),
                               part_ids[lo:hi].to(dev, non_blocking=True), n_dev, capacity)
            sent.append((local, dispatch.record_event(stream)))

    recv, recv_ids, valid, overflow = [], [], [], []
    for d, (dev, stream) in enumerate(zip(lanes, streams)):
        with dispatch.on_lane(stream):
            for _local, event in sent:
                dispatch.wait_event(stream, event)
            # the all-to-all: lane d takes chunk d of every sender
            recv.append(torch.cat([
                s[0][d].to(dev, non_blocking=True) for s, _e in sent
            ]).reshape(n_dev * capacity, row_bytes))
            recv_ids.append(torch.cat([s[1][d].to(dev, non_blocking=True) for s, _e in sent]))
            counts = torch.stack([s[2][d].to(dev, non_blocking=True) for s, _e in sent])
            valid.append((torch.arange(capacity, device=dev)[None, :] < counts[:, None])
                         .reshape(n_dev * capacity))
            overflow.append(sent[d][0][3])
    # every lane done before the senders' buffers are freed (they were read
    # on other lanes' streams); the overflow is read on the host anyway
    for stream in streams:
        dispatch.synchronize(stream)
    total_overflow = int(sum(int(o) for o in overflow))
    if total_overflow:
        raise ValueError(
            f"repartition overflow: {total_overflow} rows exceeded capacity "
            f"{capacity}; increase capacity/slack or use the store path"
        )
    return recv, recv_ids, valid
