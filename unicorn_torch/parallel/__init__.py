"""Parallelism over torch.distributed (port of unicorn_tpu/parallel/):
the process group and the (dcn, data) pod mesh (`multihost`); what the
Trainer and the training losses need of the group and the named process
mesh of the serving, eval and training forms (`mesh`: `make_mesh`,
`ProcessMesh`); one frame split over the ranks by rows (`spatial`:
`spatial_detect_fn`, on the row plan, the exchanges and the model's hooks
of `rows`)."""
from .mesh import (ProcessMesh, local_batch_slice, make_mesh, rank,
                   replicate_state, shard_batch, world)
from .multihost import initialize_multihost, local_device, make_pod_mesh

__all__ = ["ProcessMesh", "initialize_multihost", "local_batch_slice",
           "local_device", "make_mesh", "make_pod_mesh", "rank",
           "replicate_state", "shard_batch", "world"]
