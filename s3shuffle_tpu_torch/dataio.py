"""Driver and executor plugin components (the JAX package's ``dataio.py``).

Parity: ``S3ShuffleDataIO`` (S3ShuffleDataIO.scala:22-69), the second half
of the reference's plugin pair (the manager requires its companion io
plugin, sort/S3ShuffleManager.scala:190-195):

- the executor component re-initializes the dispatcher with the real
  application id once known (:30-32) and vends map-output writers (:34-43),
  on ``device`` (the CUDA device unless ``device="cpu"``);
- the driver component deletes the shuffle root at application end when
  cleanup is enabled (:54-59).
"""

from __future__ import annotations

import logging
from typing import Optional

from s3shuffle_tpu_torch.metadata.helper import ShuffleHelper
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
from s3shuffle_tpu_torch.write.map_output_writer import MapOutputWriter
from s3shuffle_tpu_torch.write.single_spill import SingleSpillMapOutputWriter

logger = logging.getLogger("s3shuffle_tpu_torch.dataio")


class ShuffleExecutorComponents:
    def __init__(self, dispatcher: Dispatcher, helper: Optional[ShuffleHelper] = None,
                 device=None):
        self.dispatcher = dispatcher
        self.helper = helper or ShuffleHelper(dispatcher)
        self.device = device

    def initialize_executor(self, app_id: str, executor_id: str = "0") -> None:
        logger.info("Initializing executor %s for app %s", executor_id, app_id)
        self.dispatcher.reinitialize(app_id)

    def create_map_output_writer(
        self, shuffle_id: int, map_id: int, num_partitions: int
    ) -> MapOutputWriter:
        return MapOutputWriter(self.dispatcher, self.helper, shuffle_id, map_id,
                               num_partitions, device=self.device)

    def create_single_file_map_output_writer(
        self, shuffle_id: int, map_id: int
    ) -> SingleSpillMapOutputWriter:
        return SingleSpillMapOutputWriter(self.dispatcher, self.helper, shuffle_id, map_id,
                                          device=self.device)


class ShuffleDriverComponents:
    def __init__(self, dispatcher: Dispatcher):
        self.dispatcher = dispatcher

    def initialize_application(self) -> None:
        logger.info("Driver components initialized (root=%s)", self.dispatcher.config.root_dir)

    def cleanup_application(self) -> None:
        if self.dispatcher.config.cleanup:
            logger.info("Application end: removing shuffle root")
            self.dispatcher.remove_root()

    def remove_shuffle(self, shuffle_id: int) -> None:
        if self.dispatcher.config.cleanup:
            self.dispatcher.remove_shuffle(shuffle_id)


class ShuffleDataIO:
    def __init__(self, dispatcher: Dispatcher, device=None):
        self.dispatcher = dispatcher
        self.device = device

    def driver(self) -> ShuffleDriverComponents:
        return ShuffleDriverComponents(self.dispatcher)

    def executor(self) -> ShuffleExecutorComponents:
        return ShuffleExecutorComponents(self.dispatcher, device=self.device)
