"""Process-group set-up for data parallelism (port of
unicorn_tpu/parallel/multihost.py; the reference's tools/train_dist.py and
launch_uni.py --nnodes).

JAX runs one controller per host and `jax.distributed` joins the hosts
into one device list. Here every card is a process of its own, as
`torchrun --nproc_per_node W` starts them, and `initialize_multihost`
joins them into a torch.distributed process group: NCCL between cards,
gloo between CPU processes. A single process stays ungrouped. A group
that fails to form raises; nothing falls back to one process.

`make_pod_mesh` is JAX's two-level (dcn, data) mesh with nodes in the
place of TPU slices: a row of the mesh holds one node's ranks, so that the
inner axis's reductions stay on the node's NVLink and only the outer
axis's cross between nodes.
"""
from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as dist

from ..device import resolve_device
from .mesh import ProcessMesh, _group_up, mesh_over, rank, world
from .mesh import local_batch_slice  # noqa: F401  (JAX's module has it)


_GROUPS_KEY = "unicorn_torch/process_groups"


def _env_world() -> int:
    return int(os.environ.get("WORLD_SIZE", "1"))


def local_device(device="cuda") -> torch.device:
    """The device of this process: on the card `cuda:LOCAL_RANK` (torchrun
    sets it; 0 without it) unless `device` names an index; else `device`.
    Raises when a card is asked for and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return resolve_device(dev)


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, *, device="cuda",
                         init_method: str | None = None,
                         backend: str | None = None,
                         timeout_s: float | None = None):
    """Call once at program start in every process; returns this process's
    device, or None in a single process, where it does nothing.

    The group is formed when any of these is given: more than one process
    (`num_processes`, else the environment's WORLD_SIZE, as torchrun sets
    it), a `coordinator_address` ("host:port", the rank-0 store) or an
    `init_method` (a torch.distributed URL, e.g. "file:///path" for a
    FileStore). The rank is `process_id`, else the environment's RANK; the
    address, without either argument, MASTER_ADDR / MASTER_PORT ("env://").
    The backend is NCCL on the card, where the process takes the card of
    its LOCAL_RANK, and gloo on the CPU, unless `backend` names one (gloo
    also takes CUDA tensors, so two processes may share one card, which
    NCCL refuses)."""
    world = num_processes if num_processes is not None else _env_world()
    if world == 1 and coordinator_address is None and init_method is None:
        return None
    if dist.is_initialized():
        raise RuntimeError("initialize_multihost: a process group exists "
                           "already")
    rank = (process_id if process_id is not None
            else int(os.environ.get("RANK", "0")))
    if init_method is None:
        init_method = (f"tcp://{coordinator_address}" if coordinator_address
                       else "env://")
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=timeout_s or 1800)
    store, rank, world = next(dist.rendezvous(
        init_method, rank=rank, world_size=world, timeout=timeout))
    # a prefix of this group's own in the store: the processes that one
    # torchrun agent starts one after another (launch_uni's stages) share
    # its store, and a later group must not read an earlier one's keys
    k = (store.add(_GROUPS_KEY, 1) - 1) // world
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        store=dist.PrefixStore(f"unicorn_torch/{k}/", store),
        world_size=world, rank=rank, timeout=timeout)
    return dev


def _nodes() -> list:
    """Every rank's node, in rank order: torchrun's GROUP_RANK (its node's
    index) where the environment has it with LOCAL_WORLD_SIZE, else the
    host's name, numbered in the order of each host's lowest rank."""
    if "GROUP_RANK" in os.environ and "LOCAL_WORLD_SIZE" in os.environ:
        mine = (int(os.environ["GROUP_RANK"]),
                int(os.environ["LOCAL_WORLD_SIZE"]))
    else:
        mine = (socket.gethostname(), None)
    every = [mine]
    if _group_up():
        every = [None] * world()
        dist.all_gather_object(every, mine)
    sizes = {n for _, n in every if n is not None}
    names = list(dict.fromkeys(node for node, _ in every))
    if all(isinstance(node, int) for node, _ in every):
        names.sort()
    counts = [sum(node == name for node, _ in every) for name in names]
    if len(set(counts)) != 1 or sizes - {counts[0]}:
        raise ValueError(f"make_pod_mesh: nodes of unequal sizes {counts} "
                         f"(LOCAL_WORLD_SIZE {sorted(sizes)})")
    return [names.index(node) for node, _ in every]


def make_pod_mesh(axis_names=("dcn", "data"), *, device="cuda"
                  ) -> ProcessMesh:
    """A (nodes, ranks a node) mesh over the group, the counterpart of JAX's
    make_pod_mesh (unicorn_tpu/parallel/multihost.py:51): the outer axis
    runs over the nodes (JAX: the slices, over DCN), the inner over one
    node's ranks (JAX: one slice's chips, over ICI). Each mesh row is one
    node's ranks in rank order, the nodes in the order of their torchrun
    GROUP_RANK (else of their lowest rank), as JAX sorts the devices by
    slice; a single node gives (1, world()). Every rank calls it (it
    forms the per-axis groups); nodes of unequal sizes raise. The batch of
    a data-parallel step shards over both axes: `shard_batch` by global
    rank, and the step given the mesh (core/train_step.py) sums the
    gradients over "data" first and then over "dcn"."""
    nodes = _nodes()
    n = max(nodes) + 1
    order = sorted(range(world()), key=lambda r: (nodes[r], r))
    return mesh_over(order, (n, world() // n), axis_names, device)
