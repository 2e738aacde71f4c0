"""Parallelism over torch.distributed (port of unicorn_tpu/parallel/):
the process group (`multihost`); what the Trainer and the training losses
need of it and the named 1-D process mesh of the serving and eval forms
(`mesh`: `make_mesh`, `ProcessMesh`); one frame split over the ranks by
rows (`spatial`: `spatial_detect_fn`, on the row plan, the exchanges and
the model's hooks of `rows`)."""
from .mesh import (ProcessMesh, local_batch_slice, make_mesh, rank,
                   replicate_state, shard_batch, world)
from .multihost import initialize_multihost, local_device

__all__ = ["ProcessMesh", "initialize_multihost", "local_batch_slice",
           "local_device", "make_mesh", "rank", "replicate_state",
           "shard_batch", "world"]
