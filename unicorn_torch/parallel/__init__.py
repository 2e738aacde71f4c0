"""Data parallelism over torch.distributed (port of unicorn_tpu/parallel/):
the process group (`multihost`) and what the Trainer and the training
losses need of it (`mesh`): the rank and world, the rank's slice of a
global batch, the state broadcast from rank 0, the gradient all-reduce and
the batch-wide sums of the losses' normalisers. The spatial partitioning
of one frame over cards (the JAX package's spatial.py) is not ported
(ROADMAP.md Queue 1 item 5e)."""
from .mesh import (local_batch_slice, rank, replicate_state, shard_batch,
                   world)
from .multihost import initialize_multihost, local_device

__all__ = ["initialize_multihost", "local_batch_slice", "local_device",
           "rank", "replicate_state", "shard_batch", "world"]
