"""Single-spill fast path (the JAX package's ``write/single_spill.py``).

Parity: ``S3SingleSpillShuffleMapOutputWriter`` (scala:18-65) — when the map
side already holds one fully merged spill file, move it into place: if the
store is the local filesystem and supports rename, rename it with a
bandwidth log (:31-52); otherwise stream-copy it through a measured stream
(:53-58). Then the checksum and index sidecars (:60-63), index last: the
same commit point as :class:`~s3shuffle_tpu_torch.write.map_output_writer.MapOutputWriter`.

With ``parity_segments > 0`` the spill file is striped into the parity
encoder (kernel K4 on ``device``) before it moves, and the parity sidecars
land before the index, as on the main writer. The JAX package's skew
trailer (a split stripe for hot partitions) is not written: the port has no
skew plane yet.
"""

from __future__ import annotations

import logging
import os
import shutil
import time

import numpy as np

from s3shuffle_tpu_torch.block_ids import ShuffleDataBlockId
from s3shuffle_tpu_torch.coding.parity import accumulator_from_config, put_parity_objects
from s3shuffle_tpu_torch.device import resolve_device
from s3shuffle_tpu_torch.metadata.helper import ShuffleHelper
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
from s3shuffle_tpu_torch.write.measure import MeasuredOutputStream

logger = logging.getLogger("s3shuffle_tpu_torch.write")


class SingleSpillMapOutputWriter:
    """``device``: where the parity encode runs (the CUDA device unless
    ``device="cpu"``)."""

    def __init__(self, dispatcher: Dispatcher, helper: ShuffleHelper, shuffle_id: int,
                 map_id: int, device=None):
        self.dispatcher = dispatcher
        self.helper = helper
        self.shuffle_id = shuffle_id
        self.map_id = map_id
        self.device = resolve_device(device)

    def transfer_map_spill_file(
        self,
        spill_path: str,
        partition_lengths: np.ndarray,
        checksums: np.ndarray | None = None,
    ) -> None:
        cfg = self.dispatcher.config
        block = ShuffleDataBlockId(self.shuffle_id, self.map_id)
        dst = self.dispatcher.get_path(block)
        size = os.path.getsize(spill_path)
        # coded plane tee: the spill is local, so stripe it before the move
        # (a rename makes the source vanish)
        acc = accumulator_from_config(cfg, self.device) if size else None
        if acc is not None:
            with open(spill_path, "rb") as src:
                while True:
                    piece = src.read(cfg.buffer_size)
                    if not piece:
                        break
                    acc.update(piece)
        # rename only works when the store IS the local filesystem, where
        # the spill file lives (the reference's condition is "root is
        # file://", S3SingleSpillShuffleMapOutputWriter.scala:31-52)
        if self.dispatcher.supports_rename and self.dispatcher.backend.scheme == "file":
            t0 = time.perf_counter_ns()
            if not self.dispatcher.backend.rename("file://" + spill_path, dst):
                raise IOError(f"rename of {spill_path} -> {dst} failed")
            dt = time.perf_counter_ns() - t0
            mib_s = (size / (1024 * 1024)) / (dt / 1e9) if dt else 0.0
            logger.info("Statistics: Renaming %s %d bytes took %.1f ms (%.1f MiB/s)",
                        block.name, size, dt / 1e6, mib_s)
        else:
            sink = MeasuredOutputStream(self.dispatcher.create_block(block), block.name)
            with open(spill_path, "rb") as src:
                shutil.copyfileobj(src, sink, length=cfg.buffer_size)
            sink.close()
            os.remove(spill_path)
        geometry = None
        if acc is not None:
            payloads = acc.finish()
            geometry = acc.geometry
            put_parity_objects(self.dispatcher, block, geometry, payloads)
        if checksums is not None and cfg.checksum_enabled:
            self.helper.write_checksums(self.shuffle_id, self.map_id, checksums)
        self.helper.write_partition_lengths(
            self.shuffle_id, self.map_id, partition_lengths, parity=geometry
        )
