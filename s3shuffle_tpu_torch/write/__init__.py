"""Map side of the port: one data object + index + checksum sidecar per map."""

from s3shuffle_tpu_torch.write.composite_commit import CompositeCommitAggregator
from s3shuffle_tpu_torch.write.map_output_writer import MapOutputCommitMessage, MapOutputWriter
from s3shuffle_tpu_torch.write.measure import MeasuredOutputStream
from s3shuffle_tpu_torch.write.single_spill import SingleSpillMapOutputWriter

__all__ = [
    "CompositeCommitAggregator",
    "MapOutputWriter",
    "MapOutputCommitMessage",
    "MeasuredOutputStream",
    "SingleSpillMapOutputWriter",
]
