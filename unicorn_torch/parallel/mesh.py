"""What data parallelism needs of the process group (port of
unicorn_tpu/parallel/mesh.py's data axis).

JAX computes the loss of the whole global batch as one program over a
"data" mesh, and XLA sums the gradients. Here each rank runs the step on
its slice of the global batch, so two things make W ranks give the step of
one process on the global batch:
  * the gradients are summed over the ranks (`all_reduce_grads`) before
    the optimizer;
  * every batch-wide sum of the losses is a sum over all ranks' slices.
    A count that normalises a loss (SimOTA's foreground count, the SOT and
    MOT sample counts of a mixed batch, the mask losses' slot counts, the
    batch size) is summed over the ranks before it divides
    (`global_sum`); a ratio of two differentiable sums (the correlation's
    batch-wide dice) goes through `global_ratio`. Each rank's loss is then
    its share of the global loss, and the shares' gradients sum to the
    global gradient. A value that every rank computes whole enters the
    loss dict as its share (`share`: value / W), so that the loss dicts
    summed over the ranks (`sum_over_ranks`) are the global one.
The sums run only inside `data_parallel_step`, which the train steps enter
when a process group is up; elsewhere every helper is the identity.

`make_mesh` is the counterpart of JAX's (unicorn_tpu/parallel/mesh.py:18):
named axes over the processes of the group, one process a card
(`ProcessMesh`), which the serving forms over several cards take, and,
with two axes, a process group for each axis. `all_reduce_grads` given a
mesh sums the gradients over its axes one after the other, the innermost
first: on the pod mesh (parallel/multihost.py `make_pod_mesh`) over one
node's ranks ("data"), then across the nodes ("dcn"), JAX's hierarchical
psum.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

_dp = {"on": False}


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    """Processes in the group (1 without a group)."""
    return dist.get_world_size() if _group_up() else 1


def rank() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if _group_up() else 0


def local_batch_slice(global_batch: int):
    """This process's share of the global batch, the reference's
    DistributedSampler role: (start, per), a contiguous slice by rank. A
    batch that does not divide over the processes raises: a floor would
    drop samples every step."""
    n = world()
    if global_batch % n:
        raise ValueError(
            f"global_batch={global_batch} must divide evenly over {n} "
            f"processes: a silent floor would drop samples every step")
    per = global_batch // n
    return per * rank(), per


def shard_batch(batch):
    """A global batch (a tuple of arrays or tensors, the batch leading) ->
    this rank's contiguous slice of each, the reference's
    DistributedSampler + DDP role."""
    start, per = local_batch_slice(len(batch[0]))
    return type(batch)(x[start:start + per] for x in batch)


def replicate_state(state):
    """The TrainState's model and EMA model, parameters and buffers, as rank
    0 holds them, on every rank (a broadcast at the start of training);
    the optimizer state then stays equal because every rank applies the
    same summed gradients."""
    if world() > 1:
        for module in (state.model, state.ema_model):
            if module is None:
                continue
            with torch.no_grad():
                for t in list(module.parameters()) + list(module.buffers()):
                    dist.broadcast(t.data, 0)
    return state


@contextlib.contextmanager
def data_parallel_step():
    """Inside, the losses' batch-wide sums cover every rank's slice (when a
    process group is up, of any size). Yields whether they do."""
    prev = _dp["on"]
    _dp["on"] = _group_up()
    try:
        yield _dp["on"]
    finally:
        _dp["on"] = prev


def global_sum(x, like: torch.Tensor | None = None):
    """x (a count, no gradient) summed over the ranks inside a data-parallel
    step, as a float32 tensor on `like`'s device when x is a number;
    outside, x unchanged."""
    if not _dp["on"]:
        return x
    if isinstance(x, torch.Tensor):
        t = x.detach().float().clone()
    else:
        t = torch.tensor(float(x), device=like.device)
    dist.all_reduce(t)
    return t


def share(x):
    """This rank's share of a value that every rank computes whole: x / W
    inside a data-parallel step, else x."""
    return x / world() if _dp["on"] else x


def global_ratio(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a / b for A / B, where a and b are this rank's parts of the sums A
    and B over the global batch (both may carry gradients). Inside a
    data-parallel step of W > 1 ranks: this rank's share R / W + (a - R b)
    / B with R = A / B, whose gradient (da - R db) / B sums over the ranks
    to that of A / B; else a / b."""
    if not _dp["on"] or world() == 1:
        return a / b
    ab = torch.stack([a.detach(), b.detach()]).float()
    dist.all_reduce(ab)
    r = ab[0] / ab[1]
    return r / world() + (a - r * b) / ab[1]


def all_reduce_grads(params, mesh: "ProcessMesh | None" = None):
    """Sum the gradients of `params` over the ranks, in one all-reduce of
    their concatenation (a parameter without a gradient adds zeros, as
    TrainState.apply_gradients counts it); with a mesh, one all-reduce of
    that buffer over each axis's group, the last axis first."""
    params = list(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    if mesh is None:
        dist.all_reduce(flat)
    else:
        for axis in reversed(mesh.axis_names):
            dist.all_reduce(flat, group=mesh.group_of(axis))
    offset = 0
    for p in params:
        n = p.numel()
        p.grad = flat[offset:offset + n].view_as(p).to(p.dtype)
        offset += n


def sum_over_ranks(values: dict) -> dict:
    """A loss dict of 0-d tensors summed over the ranks, in one
    all-reduce."""
    keys = list(values)
    stacked = torch.stack([values[k].detach().float() for k in keys])
    dist.all_reduce(stacked)
    return {k: stacked[i].to(values[k].dtype) for i, k in enumerate(keys)}


@dataclass(frozen=True)
class ProcessMesh:
    """A mesh of the group's processes: `shape[axis]` processes along each
    axis of `axis_names`, this process (global rank `rank`) at
    `coords[axis]` along each, on `device`. `group` is the whole mesh's
    process group and `groups[axis]` that of the processes that share
    every other coordinate with this one (all None: one process and no
    group). Without `coords` / `groups` the mesh is 1-D over the group in
    rank order."""

    axis_names: tuple
    shape: dict
    group: object
    rank: int
    device: torch.device
    coords: Optional[dict] = None
    groups: Optional[dict] = None

    def size(self, axis: str) -> int:
        if axis not in self.shape:
            raise ValueError(f"mesh has no axis {axis!r}: {self.axis_names}")
        return self.shape[axis]

    def coord(self, axis: str) -> int:
        """This process's index along `axis`."""
        self.size(axis)
        return self.rank if self.coords is None else self.coords[axis]

    def group_of(self, axis: str):
        """The process group along `axis` through this process."""
        self.size(axis)
        return self.group if self.groups is None else self.groups[axis]


def mesh_over(order: Sequence[int], axis_sizes: Sequence[int],
              axis_names: Sequence[str], device="cuda") -> ProcessMesh:
    """The mesh whose processes, in row-major order over `axis_sizes`, are
    the global ranks `order`. Every process calls it with the same
    arguments: it forms the group of each line of the mesh along each axis
    (`dist.new_group`, every group on every rank, in one order); a 1-D mesh
    in rank order takes the whole group's."""
    from .multihost import local_device

    axis_names, sizes = tuple(axis_names), tuple(int(n) for n in axis_sizes)
    if len(axis_names) != len(sizes):
        raise ValueError(f"mesh: {len(sizes)} sizes for axes {axis_names}")
    if math.prod(sizes) != world() or sorted(order) != list(range(world())):
        raise ValueError(f"make_mesh: mesh {sizes} of ranks {list(order)} != "
                         f"{world()} processes")
    grid = np.asarray(order).reshape(sizes)
    where = np.argwhere(grid == rank())[0]
    coords = {a: int(c) for a, c in zip(axis_names, where)}
    whole = dist.group.WORLD if _group_up() else None
    groups = {}
    for i, axis in enumerate(axis_names):
        if whole is None or (len(sizes) == 1
                             and list(order) == list(range(world()))):
            groups[axis] = whole
            continue
        for line in np.moveaxis(grid, i, -1).reshape(-1, sizes[i]):
            g = dist.new_group([int(r) for r in line])
            if rank() in line:
                groups[axis] = g
    return ProcessMesh(axis_names, dict(zip(axis_names, sizes)), whole,
                       rank(), local_device(device), coords, groups)


def make_mesh(axis_sizes: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data",), *,
              device="cuda") -> ProcessMesh:
    """A mesh over all processes of the group in rank order (default: a
    1-D "data" axis of world() processes); this process's device is
    `local_device(device)` (the card of its LOCAL_RANK). The sizes must
    multiply to world(), as JAX asserts of its devices."""
    sizes = (world(),) if axis_sizes is None else tuple(axis_sizes)
    return mesh_over(range(world()), sizes, axis_names, device)
