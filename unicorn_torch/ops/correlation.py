"""Pixel-correspondence correlation and label propagation, plain PyTorch
(port of unicorn_tpu/ops/correlation.py).

    out[b, k, j] = sum_i lbs0[b, k, i] * softmax_i(e0[b, i] . e1[b, j])

`correlation_propagate` streams over chunks of target columns, so the N x N
scores never exist at once; the CUDA kernel of the same function is in
ops/correlation_kernel.py.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.mesh import global_ratio, share


def correlation_propagate(embed0, embed1, lbs0, chunk: int = 1024):
    """Propagate frame-0 label maps to frame 1 through the embedding
    correlation. embed0, embed1 (B, N, C); lbs0 (B, K, N) -> (B, K, N) fp32.
    Scores, softmax and the weighted sum are fp32."""
    e0 = embed0.float()
    lbs = lbs0.float()
    outs = []
    for e1_c in embed1.float().split(chunk, dim=1):
        # targets by sources, (B, chunk, N): the softmax over the source
        # pixels runs along the contiguous axis
        att = torch.softmax(torch.einsum("bmc,bnc->bmn", e1_c, e0), dim=2)
        outs.append(torch.einsum("bkn,bmn->bkm", lbs, att))
    return torch.cat(outs, dim=2)


def correlation_propagate_dense(embed0, embed1, lbs0):
    """Dense form (holds the (B, N, N) scores); for tests on small shapes."""
    sim = torch.einsum("bnc,bmc->bnm", embed0.float(), embed1.float())
    return torch.einsum("bkn,bnm->bkm", lbs0.float(), torch.softmax(sim, 1))


def box_label_map(boxes_cxcywh, H: int, W: int):
    """Rasterise boxes (B, 4) cxcywh in image coords as binary maps
    (B, H, W) float32, with integer-rounded edges (round half to even)."""
    cx, cy, w, h = boxes_cxcywh.float().unbind(-1)
    x1 = torch.round(cx - 0.5 * w).to(torch.int32).clamp_min(0)
    y1 = torch.round(cy - 0.5 * h).to(torch.int32).clamp_min(0)
    x2 = torch.round(cx + 0.5 * w).to(torch.int32)
    y2 = torch.round(cy + 0.5 * h).to(torch.int32)
    xs = torch.arange(W, device=boxes_cxcywh.device)[None, None, :]
    ys = torch.arange(H, device=boxes_cxcywh.device)[None, :, None]
    inside = ((xs >= x1[:, None, None]) & (xs < x2[:, None, None])
              & (ys >= y1[:, None, None]) & (ys < y2[:, None, None]))
    return inside.float()


def resize_bilinear_torch(x, out_h: int, out_w: int):
    """Bilinear resize of an NCHW map with half-pixel sampling and no
    antialiasing (F.interpolate, align_corners=False), as the label maps
    are taken down by 2, 4 and 8."""
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=False, antialias=False)


def dice_loss(pred, gt, sample_mask=None):
    """Dice loss over flattened maps. pred, gt (B, ...); sample_mask:
    optional (B,) weights, giving the dice of the masked sub-batch. One
    dice of the whole batch: in a data-parallel step, of the global batch
    (this rank's share, parallel/mesh.py `global_ratio`)."""
    eps = 1e-5
    axes = tuple(range(1, pred.dim()))
    inter = (pred * gt).sum(axes)
    union = (pred ** 2).sum(axes) + (gt ** 2).sum(axes)
    if sample_mask is not None:
        inter, union = inter * sample_mask, union * sample_mask
    return share(1.0) - global_ratio(2.0 * inter.sum(),
                                     union.sum() + share(eps))


def grid_sample_at_points(feat, points_xy):
    """Bilinear samples of feat (H, W, C) at pixel points (P, 2) (x, y),
    border padding -> (P, C)."""
    H, W, _ = feat.shape
    x = points_xy[:, 0].clamp(0.0, W - 1.0)
    y = points_xy[:, 1].clamp(0.0, H - 1.0)
    x0, y0 = torch.floor(x).long(), torch.floor(y).long()
    x1, y1 = (x0 + 1).clamp(0, W - 1), (y0 + 1).clamp(0, H - 1)
    lx, ly = (x - x0)[:, None], (y - y0)[:, None]
    return (feat[y0, x0] * (1 - lx) * (1 - ly) + feat[y0, x1] * lx * (1 - ly)
            + feat[y1, x0] * (1 - lx) * ly + feat[y1, x1] * lx * ly)
