"""Spatial partitioning: one frame split over processes by rows, for the
latency of one stream (port of unicorn_tpu/parallel/spatial.py).

JAX shards the H axis of a frame over an "sp" mesh axis of chips and XLA
inserts the halo exchanges, GroupNorm's sums and the gather of the decoded
candidates. Here each process of an "sp" mesh (`make_mesh`) holds a
contiguous block of whole 32-row units of the frame (`spatial_rows`), runs
the detection forward on it with the model's ops exchanging what they read
across the block's edges (parallel/rows.py), and gathers each level's raw
head outputs into full-height maps; every rank then decodes and runs the
NMS on the whole frame, so every rank returns the same detections, in the
anchor order of one card. Every trunk of the port splits: ConvNeXt,
CSPDarknet, ResNet-50 and Swin (whose window blocks take every row of the
window bands that meet a rank's rows, the shifted windows' wrap-around
band included). On a mesh of several axes the split runs along `axis`,
over the processes that share the other coordinates.
"""
from __future__ import annotations

import warnings

import torch
import torch.distributed as dist

from ..models.heads import decode_for_inference
from ..ops.nms import postprocess_device
from . import rows
from .mesh import ProcessMesh


def _plan(mesh: ProcessMesh, H: int, axis: str) -> rows.RowPlan:
    return rows.RowPlan(rows.split_units(H, mesh.size(axis)),
                        mesh.coord(axis), mesh.group_of(axis))


def _frame_rows(plan: rows.RowPlan) -> tuple:
    return plan.bounds(plan.units[plan.rank] * rows.UNIT)[plan.rank]


def spatial_rows(mesh: ProcessMesh, H: int, axis: str = "sp") -> tuple:
    """(start, stop): the rows of an H-row frame that this rank holds, the
    counterpart of JAX's `spatial_sharding`. The frame's H / 32 units split
    as evenly as possible over the ranks, the first ranks taking one more
    (800 rows over 4 ranks: 224 / 192 / 192 / 192). Raises when H is not a
    multiple of 32 or a rank would get no unit."""
    return _frame_rows(_plan(mesh, H, axis))


def spatial_detect_fn(model, mesh: ProcessMesh, axis: str = "sp",
                      num_classes: int = 1, strides=(8, 16, 32),
                      conf_thre: float = 0.1, nms_thre: float = 0.8,
                      n_cand: int = 128, max_out: int = 64):
    """The spatially partitioned detector of a Unicorn (moved to the mesh's
    device, in eval mode): fn(frames (N, 3, stop - start, W), this rank's
    rows of the frames on its device) -> (dets (N, max_out, 7), valid (N,
    max_out)), the same on every rank. The frame's height is the sum of the
    ranks' block heights."""
    model = model.to(mesh.device).eval()
    n_sp = mesh.size(axis)
    warned = set()

    @torch.inference_mode()
    def detect(frames):
        h = torch.tensor([frames.shape[2]], dtype=torch.int32,
                         device=frames.device)
        if mesh.group_of(axis) is not None:
            dist.all_reduce(h, group=mesh.group_of(axis))
        H = int(h.item())
        if H % (strides[-1] * n_sp) and H not in warned:
            warned.add(H)
            warnings.warn(
                f"spatial partitioning: H={H} is not a multiple of "
                f"{strides[-1]}*{n_sp} (deepest stride x sp ranks); the "
                f"first ranks hold one more {rows.UNIT}-row unit: correct "
                f"results, unbalanced per-card load", stacklevel=3)
        plan = _plan(mesh, H, axis)
        start, stop = _frame_rows(plan)
        if frames.shape[2] != stop - start:
            raise ValueError(f"spatial_detect_fn: rank {mesh.rank} holds "
                             f"rows [{start}, {stop}) of {H}, given "
                             f"{frames.shape[2]}")
        with rows.row_sharded(plan):
            raw, _ = model.forward_whole(frames)
        packed = rows.gather_rows(
            [t for out in raw for t in (out["_cls_packed"],
                                        out["_reg_packed"])], plan)
        full = [model.head.unpack(packed[2 * k], packed[2 * k + 1])
                for k in range(len(raw))]
        dec = decode_for_inference(full, strides, mode="mot")
        return postprocess_device(
            dec, num_classes=num_classes, conf_thre=conf_thre,
            nms_thre=nms_thre, class_agnostic=(num_classes == 1),
            n_cand=n_cand, max_out=max_out)

    return detect
