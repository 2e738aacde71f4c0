"""CondInst mask losses with a fixed per-image instance budget, PyTorch
(port of unicorn_tpu/losses/mask.py), batched over B where the JAX package
vmaps a single-image function.

Each image contributes K anchor slots: the top K foreground anchors by
matched IoU (validity-masked). The dynamic convs of all slots run as one
batched matmul (ops/dynamic_conv.py).

Where the frameworks part:
  * `jax.lax.top_k` puts the lowest index first among equal values, and
    every background anchor scores exactly 0; `torch.topk` promises no
    order, so the slots come from a stable descending sort.
  * `jax.image.resize` antialiases when it shrinks (a triangle filter
    widened by the scale factor); `resize_antialias` is F.interpolate with
    antialias=True, which computes the same filter.

Layout: mask features (B, 8, H8, W8) and the RAFT up-mask (B, 9*R*R, H8,
W8), NCHW as everywhere in the port; the semantic logits (B, C, H8, W8).

In a data-parallel step (parallel/mesh.py) the counts that normalise the
losses are those of the global batch, summed over the ranks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.mask_head import anchor_locations_and_levels
from ..parallel.mesh import global_sum
from ..ops.dynamic_conv import (aligned_bilinear, convex_upsample,
                                dynamic_mask_logits)


def resize_antialias(x, out_h: int, out_w: int):
    """Bilinear resize of an NCHW map with half-pixel sampling and, when it
    shrinks, the triangle filter widened by the scale (jax.image.resize's
    "bilinear")."""
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=False, antialias=True)


def dice_per_instance(scores, targets):
    """(..., H, W) sigmoid scores vs binary targets -> (...) dice loss."""
    eps = 1e-5
    x = scores.flatten(-2)
    t = targets.flatten(-2)
    inter = (x * t).sum(-1)
    union = (x ** 2).sum(-1) + (t ** 2).sum(-1) + eps
    return 1.0 - 2.0 * inter / union


def topk_slots(fg_mask, pred_iou, max_inst: int):
    """The K slots of each image: (valid (B, K) bool, topi (B, K) anchor
    index). Foreground anchors score matched IoU + 1 (so that IoU 0 still
    beats the background's 0); equal scores keep the lowest index first."""
    score = torch.where(fg_mask, pred_iou + 1.0, pred_iou.new_zeros(()))
    topv, topi = score.sort(dim=1, descending=True, stable=True)
    return topv[:, :max_inst] > 0.0, topi[:, :max_inst]


def select_topk_mask_logits(ctrl, mask_feats, fg_mask, pred_iou, locs, lvls,
                            max_inst, up_masks, up_rate, Hm, Wm):
    """Shared CondInst slot machinery of the dice and the BoxInst losses:
    the top-K slots, their dynamic-conv mask decode, RAFT or bilinear
    upsampling, and a resize to the target grid when it differs.

    ctrl (B, A, 169); mask_feats (B, 8, H8, W8); fg_mask, pred_iou (B, A);
    locs (A, 2), lvls (A,); up_masks (B, 9*R*R, H8, W8) or None. Returns
    (valid (B, K) bool, topi (B, K), logits (B, K, Hm, Wm) fp32)."""
    valid, topi = topk_slots(fg_mask, pred_iou, max_inst)
    ctrl_k = ctrl.gather(1, topi[..., None].expand(-1, -1, ctrl.shape[2]))
    logits = dynamic_mask_logits(mask_feats, ctrl_k, locs[topi], lvls[topi])
    if up_masks is not None:
        logits = convex_upsample(logits, up_masks, up_rate)
    else:
        logits = aligned_bilinear(logits, 2)        # stride 8 -> 4
    if logits.shape[2:] != (Hm, Wm):
        logits = resize_antialias(logits, Hm, Wm)
    return valid, topi, logits


def gather_rows(x, idx):
    """x (B, M, ...) at per-image indices idx (B, K) -> (B, K, ...)."""
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[b, idx]


def condinst_mask_loss(ctrl, mask_feats, fg_mask, matched_gt, pred_iou,
                       gt_masks, hw_list, strides, max_inst: int = 48,
                       up_masks=None, up_rate: int = 8, sample_mask=None):
    """The mask dice loss averaged over the selected instances (a scalar).

    ctrl (B, A, 169); mask_feats (B, 8, H8, W8); fg_mask (B, A) bool, the
    SimOTA assignment; matched_gt (B, A) int; pred_iou (B, A); gt_masks
    (B, M, Hm, Wm) binary instance masks at the mask grid; up_masks
    (B, 9*R*R, H8, W8) with RAFT; sample_mask (B,) weights of the images.
    An invalid slot adds exact zeros to the loss and its gradient."""
    locs, lvls = anchor_locations_and_levels(hw_list, strides,
                                             ctrl.device)
    Hm, Wm = gt_masks.shape[2:]
    valid, topi, logits = select_topk_mask_logits(
        ctrl, mask_feats, fg_mask, pred_iou, locs, lvls, max_inst, up_masks,
        up_rate, Hm, Wm)
    tgts = gather_rows(gt_masks, matched_gt.gather(1, topi))  # (B, K, Hm, Wm)
    d = dice_per_instance(torch.sigmoid(logits), tgts.float())
    valid = valid.float()
    losses = (d * valid).sum(1)
    counts = valid.sum(1)
    if sample_mask is not None:
        losses = losses * sample_mask
        counts = counts * sample_mask
    return losses.sum() / global_sum(counts.sum()).clamp_min(1.0)


def semantic_focal_loss(sem_logits, gt_masks, gt_classes, gt_valid,
                        num_classes: int, alpha: float = 0.25,
                        gamma: float = 2.0):
    """Auxiliary semantic-segmentation focal loss over per-pixel class
    targets, the union of each class's instance masks. sem_logits (B, C,
    H, W); gt_masks (B, M, Hm, Wm); gt_classes (B, M) int; gt_valid (B, M).
    The sigmoid and logarithms run in the logits' dtype, as JAX's do."""
    del num_classes  # the logits' channels
    B, C, H, W = sem_logits.shape
    masks = resize_antialias(gt_masks.float(), H, W)
    masks = (masks > 0.5).float() * gt_valid[..., None, None]
    # a class outside [0, C) gives a zero row, as jax.nn.one_hot does
    onehot = (gt_classes.long()[..., None]
              == torch.arange(C, device=sem_logits.device)).float()
    target = torch.einsum("bmhw,bmc->bchw", masks, onehot).clamp(0.0, 1.0)
    p = torch.sigmoid(sem_logits)
    ce = -(target * torch.log(p + 1e-8)
           + (1 - target) * torch.log(1 - p + 1e-8))
    p_t = p * target + (1 - p) * (1 - target)
    loss = ce * ((1 - p_t) ** gamma)
    loss = loss * (alpha * target + (1 - alpha) * (1 - target))
    return loss.sum() / global_sum(target.sum()).clamp_min(1.0)
