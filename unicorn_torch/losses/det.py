"""SimOTA label assignment + YOLOX detection losses, PyTorch (port of
unicorn_tpu/losses/det.py), batched over B where the JAX package vmaps a
single-image function.

gts are padded to a fixed M with a validity mask and the anchors A are
static. The (M, A, C) BCE class-cost tensor never exists: with p =
sqrt(cls_sig * obj_sig) and c_m the gt class,
    sum_c BCE(p_c, onehot_c) = -log(p_{c_m}) + log(1 - p_{c_m}) + S(a),
S(a) = -sum_c log(1 - p_c(a)), so only (B, M, A) matrices are needed.
Dynamic-k selection is a masked pick of the 10 cheapest anchors (k is at
most 10: it is the integer part of a sum of 10 IoUs).

Where the frameworks part: `jax.lax.top_k` returns the lowest index first
among equal values and `torch.topk` promises no order, and ties are real
here (every excluded entry is exactly BIG_COST, and adding 1e5 leaves fp32 a
step of 0.0078), so the 10 cheapest come from a stable sort.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..parallel.mesh import global_sum, share
from ..utils.profiling import spanned

BIG_COST = 1e9
CENTER_RADIUS = 2.5
N_CANDIDATE_K = 10


def iou_pairwise_cxcywh(gt, pred):
    """IoU between gt (..., M, 4) and pred (..., A, 4), both cxcywh ->
    (..., M, A)."""
    g, p = gt[..., :, None, :], pred[..., None, :, :]
    tl = torch.maximum(g[..., :2] - g[..., 2:4] / 2, p[..., :2] - p[..., 2:4] / 2)
    br = torch.minimum(g[..., :2] + g[..., 2:4] / 2, p[..., :2] + p[..., 2:4] / 2)
    area_g = gt[..., 2] * gt[..., 3]
    area_p = pred[..., 2] * pred[..., 3]
    en = (tl < br).all(-1)
    area_i = (br - tl).prod(-1) * en
    return area_i / (area_g[..., :, None] + area_p[..., None, :] - area_i + 1e-16)


def iou_elementwise_cxcywh(pred, target):
    """Element-wise IoU of aligned boxes (..., 4) cxcywh -> (...)."""
    tl = torch.maximum(pred[..., :2] - pred[..., 2:] / 2,
                       target[..., :2] - target[..., 2:] / 2)
    br = torch.minimum(pred[..., :2] + pred[..., 2:] / 2,
                       target[..., :2] + target[..., 2:] / 2)
    area_p = pred[..., 2] * pred[..., 3]
    area_g = target[..., 2] * target[..., 3]
    en = (tl < br).all(-1)
    area_i = (br - tl).prod(-1) * en
    return area_i / (area_p + area_g - area_i + 1e-16)


def l1_elementwise(pred, target):
    """|pred - target| element-wise."""
    return (pred - target).abs()


class OTAResult(NamedTuple):
    fg_mask: torch.Tensor         # (B, A) bool: assigned anchors
    matched_gt: torch.Tensor      # (B, A) int64: gt index per anchor (0 if bg)
    pred_iou: torch.Tensor        # (B, A) float: IoU with the matched gt
    num_fg: torch.Tensor          # (B,) float
    num_gt: torch.Tensor          # (B,) float


def get_geometry_constraints(gt_boxes, gt_valid, x_shifts, y_shifts, strides,
                             img_size):
    """In-box and in-centre masks. gt_boxes (B, M, 4) cxcywh; gt_valid
    (B, M) bool; shifts and strides (A,). Returns is_in_boxes (B, M, A),
    is_in_centers (B, M, A), fg_candidate (B, A)."""
    xc = ((x_shifts + 0.5) * strides)[None, None, :]
    yc = ((y_shifts + 0.5) * strides)[None, None, :]
    cx, cy, w, h = (gt_boxes[..., k, None] for k in range(4))
    in_boxes = ((xc > cx - 0.5 * w) & (xc < cx + 0.5 * w)
                & (yc > cy - 0.5 * h) & (yc < cy + 0.5 * h))
    ccx = cx.clamp(0.0, img_size[1])
    ccy = cy.clamp(0.0, img_size[0])
    r = (CENTER_RADIUS * strides)[None, None, :]
    in_centers = ((xc > ccx - r) & (xc < ccx + r)
                  & (yc > ccy - r) & (yc < ccy + r))
    in_boxes = in_boxes & gt_valid[..., None]
    in_centers = in_centers & gt_valid[..., None]
    return in_boxes, in_centers, (in_boxes | in_centers).any(1)


@torch.no_grad()
@spanned("loss.simota")
def simota_assign(gt_boxes, gt_classes, gt_valid, pred_boxes, obj_logits,
                  cls_logits, x_shifts, y_shifts, strides,
                  img_size) -> OTAResult:
    """SimOTA for a batch. gt_boxes (B, M, 4) cxcywh; gt_classes (B, M) int;
    gt_valid (B, M) bool; pred_boxes (B, A, 4) decoded cxcywh; obj_logits
    (B, A, 1); cls_logits (B, A, C). The whole assignment carries no
    gradient: pred_iou feeds the class target as a constant."""
    B, M = gt_valid.shape
    A, C = cls_logits.shape[1:]
    in_boxes, in_centers, fg_cand = get_geometry_constraints(
        gt_boxes, gt_valid, x_shifts, y_shifts, strides, img_size)
    in_boxes_and_center = in_boxes & in_centers             # (B, M, A)
    usable = gt_valid[:, :, None] & fg_cand[:, None, :]

    iou = iou_pairwise_cxcywh(gt_boxes, pred_boxes) * usable

    p = torch.sqrt(torch.sigmoid(cls_logits) * torch.sigmoid(obj_logits))
    p = p.clamp(1e-8, 1.0 - 1e-8)
    log_p, log_1mp = torch.log(p), torch.log1p(-p)          # (B, A, C)
    s_all = -log_1mp.sum(-1)                                # (B, A)
    gt_cls = gt_classes.long().clamp(0, C - 1)[:, :, None].expand(B, M, A)
    p_gt_log = log_p.transpose(1, 2).gather(1, gt_cls)      # (B, M, A)
    p_gt_log1m = log_1mp.transpose(1, 2).gather(1, gt_cls)
    cls_cost = -p_gt_log + p_gt_log1m + s_all[:, None, :]

    iou_cost = -torch.log(iou + 1e-8)
    cost = cls_cost + 3.0 * iou_cost + 1e5 * (~in_boxes_and_center)
    cost = torch.where(usable, cost, cost.new_tensor(BIG_COST))

    topk_ious = iou.topk(N_CANDIDATE_K, dim=2).values
    dynamic_ks = topk_ious.sum(2).to(torch.int32).clamp_min(1)      # (B, M)

    # the 10 cheapest anchors of each gt, the lowest index first among equals
    top_idx = cost.sort(dim=2, stable=True).indices[..., :N_CANDIDATE_K]
    rank = torch.arange(N_CANDIDATE_K, device=cost.device)
    sel = (rank < dynamic_ks[..., None]) & gt_valid[..., None]      # (B, M, 10)
    matching = torch.zeros_like(cost).scatter_(2, top_idx, sel.float())

    # an anchor claimed by more than one gt goes to its cheapest gt, over
    # all gt rows (argmin and argmax return the first occurrence)
    anchor_deg = matching.sum(1)                                    # (B, A)
    best_gt = cost.argmin(1)
    onehot_best = (torch.arange(M, device=cost.device)[None, :, None]
                   == best_gt[:, None, :]).float()
    matching = torch.where(anchor_deg[:, None, :] > 1, onehot_best, matching)

    fg_mask = matching.sum(1) > 0
    return OTAResult(fg_mask, matching.argmax(1), (matching * iou).sum(1),
                     fg_mask.float().sum(1), gt_valid.float().sum(1))


def yolox_terms(labels, pred_boxes, obj_logits, cls_logits, reg_raw,
                x_shifts, y_shifts, strides_vec, img_size,
                use_l1: bool = False):
    """SimOTA assignment and each image's sums of the YOLOX terms over its
    anchors. labels (B, M, 5) [cls, cx, cy, w, h] zero-padded; pred_boxes
    (B, A, 4) decoded cxcywh; obj_logits (B, A, 1); cls_logits (B, A, C);
    reg_raw (B, A, 4). Returns ((iou, obj, cls, l1) each (B,), OTAResult);
    l1 is None without use_l1."""
    gt_valid = labels.sum(2) > 0                      # padded rows are zero
    gt_boxes = labels[..., 1:5]
    gt_classes = labels[..., 0].long()
    assign = simota_assign(gt_boxes, gt_classes, gt_valid,
                           pred_boxes.detach(), obj_logits.detach(),
                           cls_logits.detach(), x_shifts, y_shifts,
                           strides_vec, img_size)

    B, A = assign.fg_mask.shape
    C = cls_logits.shape[-1]
    fg = assign.fg_mask.float()
    matched_cls = gt_classes.gather(1, assign.matched_gt)            # (B, A)
    reg_target = gt_boxes.gather(
        1, assign.matched_gt[..., None].expand(B, A, 4))
    # a class outside [0, C) gives a zero row, as jax.nn.one_hot does
    onehot = (matched_cls[..., None]
              == torch.arange(C, device=labels.device)).float()
    cls_target = onehot * assign.pred_iou[..., None]

    iou_ew = iou_elementwise_cxcywh(pred_boxes, reg_target)
    t_iou = ((1.0 - iou_ew ** 2) * fg).sum(1)
    t_obj = F.binary_cross_entropy_with_logits(
        obj_logits[..., 0], fg, reduction="none").sum(1)
    t_cls = (F.binary_cross_entropy_with_logits(
        cls_logits, cls_target, reduction="none").sum(-1) * fg).sum(1)
    t_l1 = None
    if use_l1:
        eps = 1e-8
        l1_t = torch.stack([
            reg_target[..., 0] / strides_vec - x_shifts,
            reg_target[..., 1] / strides_vec - y_shifts,
            torch.log(reg_target[..., 2] / strides_vec + eps),
            torch.log(reg_target[..., 3] / strides_vec + eps)], -1)
        t_l1 = (l1_elementwise(reg_raw, l1_t).sum(-1) * fg).sum(1)
    return (t_iou, t_obj, t_cls, t_l1), assign


def yolox_losses(labels, pred_boxes, obj_logits, cls_logits, reg_raw,
                 x_shifts, y_shifts, strides_vec, img_size,
                 use_l1: bool = False, reg_weight: float = 5.0,
                 sample_mask=None):
    """Batched YOLOX losses with SimOTA assignment (the arguments of
    `yolox_terms`), normalised by the batch's foreground count.

    With `sample_mask` (B,) the losses are those of the masked sub-batch
    (sums and num_fg restricted to it). In a data-parallel step the
    foreground and gt counts are those of the global batch (parallel/
    mesh.py), so each rank's losses are its share. Returns (loss_dict,
    OTAResult)."""
    (t_iou, t_obj, t_cls, t_l1), assign = yolox_terms(
        labels, pred_boxes, obj_logits, cls_logits, reg_raw, x_shifts,
        y_shifts, strides_vec, img_size, use_l1)
    if sample_mask is None:
        sample_mask = labels.new_ones((labels.shape[0],))
    sample_mask = sample_mask.float()
    num_fg = global_sum((assign.num_fg * sample_mask).sum()).clamp_min(1.0)
    num_gts = global_sum((assign.num_gt * sample_mask).sum()).clamp_min(1.0)

    def masked(t):
        return (t * sample_mask).sum() / num_fg

    loss_iou, loss_obj, loss_cls = masked(t_iou), masked(t_obj), masked(t_cls)
    loss_l1 = masked(t_l1) if use_l1 else labels.new_zeros(())
    total = reg_weight * loss_iou + loss_obj + loss_cls + loss_l1
    loss_dict = {
        "total_loss": total,
        "iou_loss": reg_weight * loss_iou,
        "conf_loss": loss_obj,
        "cls_loss": loss_cls,
        "l1_loss": loss_l1,
        "num_fg": share(num_fg / num_gts),
    }
    return loss_dict, assign
