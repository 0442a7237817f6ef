"""Data parallelism over ``torch.distributed`` (counterpart of
``galaxy_deconv_tpu/parallel``): one process per device, each rank holding a
contiguous shard of every global batch, replicated parameters, one gradient
all-reduce a step, and BatchNorm statistics over the global batch."""

from galaxy_deconv_tpu_torch.parallel.batch import batch_mean, batch_sum, global_batch, in_global_batch
from galaxy_deconv_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_rows,
    barrier,
    broadcast_parameters,
    initialize_distributed,
    is_writer,
    make_mesh,
    shard_batch,
    shard_rows,
)

__all__ = ["Mesh", "all_gather_rows", "barrier", "batch_mean", "batch_sum", "broadcast_parameters", "global_batch",
           "in_global_batch", "initialize_distributed", "is_writer", "make_mesh", "shard_batch", "shard_rows"]
