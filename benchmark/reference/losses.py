"""The plain reference of the uni stage's losses: SimOTA assignment and the
YOLOX terms, the SOT and MOT head losses, the correlation dice, the
contrastive embedding loss and the MOT-helps-SOT labels. Frozen copies of
`unicorn_torch/losses/det.py`, `losses/uni.py` and `losses/vos.py`
(`match_instance_pairs`) for one process (the data-parallel counts are the
batch's own), with the correlation in its plain form.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .plain import (box_label_map, correlation_propagate, dice_loss,
                    resize_bilinear)


def level_grids(hw_list, strides, device=None):
    """Per-anchor x, y grid coordinates and strides (A,), levels stride 8
    first, row-major."""
    xs, ys, ss = [], [], []
    for (h, w), s in zip(hw_list, strides):
        yv, xv = torch.meshgrid(torch.arange(h, device=device),
                                torch.arange(w, device=device), indexing="ij")
        xs.append(xv.reshape(-1))
        ys.append(yv.reshape(-1))
        ss.append(torch.full((h * w,), s, device=device))
    return (torch.cat(xs).float(), torch.cat(ys).float(),
            torch.cat(ss).float())


def flatten_raw_outputs(outputs, mode: str):
    """Per-level raw head outputs -> reg_raw (B, A, 4), obj_logits (B, A, 1),
    cls_logits (B, A, C), hw; mode "mot" the shared branch, "sot" the SOT
    one."""
    sfx = "_sot" if mode == "sot" else ""
    flat = {"hw": [tuple(o["reg"].shape[2:]) for o in outputs]}
    for key, name in (("reg_raw", "reg"), ("obj_logits", "obj"),
                      ("cls_logits", "cls")):
        flat[key] = torch.cat([
            o[name + sfx].float().permute(0, 2, 3, 1).reshape(
                o[name + sfx].shape[0], -1, o[name + sfx].shape[1])
            for o in outputs], 1)
    return flat


def decode_boxes(reg_raw, hw_list, strides):
    x_shifts, y_shifts, s = level_grids(hw_list, strides, reg_raw.device)
    return torch.stack([(reg_raw[..., 0] + x_shifts) * s,
                        (reg_raw[..., 1] + y_shifts) * s,
                        torch.exp(reg_raw[..., 2]) * s,
                        torch.exp(reg_raw[..., 3]) * s], -1)

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
def simota_assign(gt_boxes, gt_classes, gt_valid, pred_boxes, obj_logits,
                  cls_logits, x_shifts, y_shifts, strides,
                  img_size, dtype=torch.float32) -> OTAResult:
    """SimOTA for a batch. gt_boxes (B, M, 4) cxcywh; gt_classes (B, M) int;
    gt_valid (B, M) bool; pred_boxes (B, A, 4) decoded cxcywh; obj_logits
    (B, A, 1); cls_logits (B, A, C). The whole assignment carries no
    gradient: pred_iou feeds the class target as a constant. `dtype` is the
    arithmetic's (fp32; lower for the control)."""
    gt_boxes, pred_boxes, obj_logits, cls_logits = (
        t.to(dtype) for t in (gt_boxes, pred_boxes, obj_logits, cls_logits))
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
    return OTAResult(fg_mask, matching.argmax(1),
                     (matching * iou).sum(1).float(),
                     fg_mask.float().sum(1), gt_valid.float().sum(1))


def following(fg_mask, matched_gt, gt_boxes, gt_valid, pred_boxes):
    """An OTAResult with a given assignment (fg_mask, matched_gt), whose
    pred_iou is that of these predicted boxes with their matched gts."""
    iou = iou_pairwise_cxcywh(gt_boxes, pred_boxes.float())     # (B, M, A)
    picked = iou.gather(1, matched_gt[:, None, :])[:, 0]
    return OTAResult(fg_mask, matched_gt, picked * fg_mask,
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
    num_fg = (assign.num_fg * sample_mask).sum().clamp_min(1.0)
    num_gts = (assign.num_gt * sample_mask).sum().clamp_min(1.0)

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
        "num_fg": num_fg / num_gts,
    }
    return loss_dict, assign


def match_instance_pairs(targets, max_pairs: int):
    """targets (B, 2, M, 6) -> (idx0 (B, K), idx1 (B, K), valid (B, K)): the
    first K (frame 0, frame 1) index pairs with equal nonzero track ids.

    Rows without a slot are all written into one scratch column, which is
    cut off; only that column depends on the order of the writes."""
    tid0 = targets[:, 0, :, 5]
    tid1 = targets[:, 1, :, 5]
    match = ((tid0[:, :, None] == tid1[:, None, :])
             & (tid0[:, :, None] != 0) & (tid1[:, None, :] != 0))   # (B, M, M)
    has = match.any(2)                              # the row has a match
    j_first = match.int().argmax(2)                 # its first matching column
    rank = has.int().cumsum(1) - 1
    valid = has & (rank < max_pairs)
    B, M = has.shape
    rows = torch.arange(M, device=targets.device).expand(B, M)
    slot = torch.where(valid, rank, torch.full_like(rank, max_pairs)).long()

    def scatter(src):
        buf = torch.zeros((B, max_pairs + 1), dtype=src.dtype,
                          device=targets.device)
        return buf.scatter_(1, slot, src)[:, :max_pairs]

    return scatter(rows), scatter(j_first), scatter(valid)



def sample_instance_embeddings(embed, centers_xy, stride: float = 8.0):
    """Per-instance embeddings at box centres, bilinear with border padding.
    embed (B, C, H_d, W_d); centers_xy (B, M, 2) in image coords ->
    (B, M, C). The coordinate chain is the reference's: c = clamp(cxy / s -
    0.5, 0, D - 1), then the align_corners=False grid mapping, pixel =
    c * D / (D - 1) - 0.5."""
    B, _, H_d, W_d = embed.shape
    cx = (centers_xy[..., 0] / stride - 0.5).clamp(0.0, W_d - 1.0)
    cy = (centers_xy[..., 1] / stride - 0.5).clamp(0.0, H_d - 1.0)
    x = (cx * W_d / (W_d - 1) - 0.5).clamp(0.0, W_d - 1.0)
    y = (cy * H_d / (H_d - 1) - 0.5).clamp(0.0, H_d - 1.0)
    x0, y0 = torch.floor(x).long(), torch.floor(y).long()
    x1, y1 = (x0 + 1).clamp(0, W_d - 1), (y0 + 1).clamp(0, H_d - 1)
    lx, ly = (x - x0)[..., None], (y - y0)[..., None]
    feat = embed.permute(0, 2, 3, 1)                       # (B, H, W, C) view
    b = torch.arange(B, device=embed.device)[:, None]
    return (feat[b, y0, x0] * (1 - lx) * (1 - ly) + feat[b, y0, x1] * lx * (1 - ly)
            + feat[b, y1, x0] * (1 - lx) * ly + feat[b, y1, x1] * lx * ly)


def _masked_ce(logits, labels, row_valid, col_valid):
    """Cross-entropy over the rows of logits (B, R, Cn) restricted to valid
    columns, averaged over valid rows -> (B,)."""
    masked = torch.where(col_valid[:, None, :], logits,
                         logits.new_tensor(-1e9))
    logz = torch.logsumexp(masked, dim=2)
    picked = masked.gather(2, labels[..., None])[..., 0]
    cnt = row_valid.float().sum(1).clamp_min(1.0)
    return ((logz - picked) * row_valid).sum(1) / cnt


def mot_contrastive_loss_single(embed0, embed1, targets,
                                bidirect: bool = True):
    """Contrastive embedding loss of each image pair. embed0, embed1
    (B, C, H_d, W_d); targets (B, 2, M, 6) [cls, cx, cy, w, h, tid] ->
    (B,)."""
    tid0, tid1 = targets[:, 0, :, 5], targets[:, 1, :, 5]
    v0, v1 = tid0 != 0, tid1 != 0
    e0 = sample_instance_embeddings(embed0, targets[:, 0, :, 1:3])  # (B, M, C)
    e1 = sample_instance_embeddings(embed1, targets[:, 1, :, 1:3])
    sim = e0 @ e1.transpose(1, 2)                                   # (B, M, M)
    match = ((tid0[:, :, None] == tid1[:, None, :])
             & v0[:, :, None] & v1[:, None, :])
    loss_row = _masked_ce(sim, match.int().argmax(2), match.any(2), v1)
    if not bidirect:
        return loss_row
    loss_col = _masked_ce(sim.transpose(1, 2), match.int().argmax(1),
                          match.any(1), v0)
    return 0.5 * (loss_row + loss_col)


def build_mhs_labels(targets):
    """MOT-helps-SOT: the first track-id-matched instance pair of each
    sample as a single-instance SOT label pair. targets (B, 2, M, 6) ->
    (mhs_targets (B, 2, M, 6) with one instance, has_pair (B,) bool)."""
    idx0, idx1, pv = match_instance_pairs(targets, 1)
    b = torch.arange(targets.shape[0], device=targets.device)
    out = torch.zeros_like(targets)
    out[:, 0, 0, 1:6] = targets[b, 0, idx0[:, 0], 1:6]
    out[:, 1, 0, 1:6] = targets[b, 1, idx1[:, 0], 1:6]
    has = pv[:, 0]
    return out * has[:, None, None, None], has


def unicorn_uni_loss(head_raw, embed_0, embed_1, pred_prior_s8, gt_lbs1_s8,
                     targets, task_ids, img_size, strides=(8, 16, 32),
                     num_classes: int = 8, mot_weight: float = 1.0,
                     sot_weight: float = 1.0, bidirect: bool = True,
                     use_l1: bool = False, sot_only: bool = False):
    """The combined loss. head_raw: per-level raw head outputs (both
    branches); embed_0, embed_1 (B, C, H8, W8); pred_prior_s8, gt_lbs1_s8
    (B, 1, H8, W8); targets (B, 2, M, 6); task_ids (B,) 1 = SOT, 2 = MOT.
    Returns a loss dict.

    sot_only=True skips the MOT branch (head losses and contrastive loss):
    for callers whose task_ids are never 2 it would be multiplied by a zero
    sample count."""
    del num_classes  # the class count is the head's
    B = targets.shape[0]
    sot_mask = (task_ids == 1).float()
    mot_mask = (task_ids == 2).float()
    hw = [(img_size[0] // s, img_size[1] // s) for s in strides]
    xs, ys, ss = level_grids(hw, strides, targets.device)

    def head_losses(mode, labels5, mask):
        flat = flatten_raw_outputs(head_raw, mode)
        boxes = decode_boxes(flat["reg_raw"], flat["hw"], strides)
        return yolox_losses(labels5, boxes, flat["obj_logits"],
                            flat["cls_logits"], flat["reg_raw"], xs, ys, ss,
                            img_size, use_l1=use_l1, sample_mask=mask)[0]

    labels1 = targets[:, 1, :, :5]                    # the current frame
    sot_dict = head_losses("sot", labels1, sot_mask)
    corr_sot = dice_loss(pred_prior_s8[:, 0], gt_lbs1_s8[:, 0],
                         sample_mask=sot_mask)
    total_sot = (sot_dict["total_loss"] + corr_sot) * sot_weight
    n_sot = sot_mask.sum()

    out = {"corr_loss_sot": corr_sot}
    out.update({k + "_sot": v for k, v in sot_dict.items()
                if k != "total_loss"})
    if sot_only:
        out["total_loss"] = n_sot * total_sot / B
        return out

    mot_dict = head_losses("mot", labels1, mot_mask)
    corr_mot_b = mot_contrastive_loss_single(embed_0, embed_1, targets,
                                             bidirect)
    n_mot = mot_mask.sum()
    corr_mot = (corr_mot_b * mot_mask).sum() / n_mot.clamp_min(1.0)
    total_mot = mot_dict["total_loss"] + corr_mot
    if mot_weight > 1.0:
        # extra objectness weight for MOT
        total_mot = total_mot + mot_dict["conf_loss"] * (mot_weight - 1.0)

    out["total_loss"] = (n_sot * total_sot + n_mot * total_mot) / B
    out["corr_loss_mot"] = corr_mot
    out.update({k + "_mot": v for k, v in mot_dict.items()
                if k != "total_loss"})
    return out


def build_sot_priors(embed_0, embed_1, targets, img_size, task_ids=None,
                     q=None):
    """Propagate the frame-0 target box label map to frame 1 through the
    fp32 embedding correlation. embed_0, embed_1 (B, C, H8, W8). Returns
    (pred_prior_s8 (B, 1, H8, W8), gt_lbs1_s8 (B, 1, H8, W8)); the prior is
    zeroed for non-SOT samples, so that the one head call sees zero priors
    for MOT samples."""
    B, C, H8, W8 = embed_0.shape
    H, W = img_size
    N = H8 * W8
    lbs0 = resize_bilinear(
        box_label_map(targets[:, 0, 0, 1:5], H, W)[:, None], H8, W8)
    gt1 = resize_bilinear(
        box_label_map(targets[:, 1, 0, 1:5], H, W)[:, None], H8, W8)

    def rows(e):
        return e.float().permute(0, 2, 3, 1).reshape(B, N, C).contiguous()

    pred = correlation_propagate(rows(embed_0), rows(embed_1),
                                 lbs0.reshape(B, 1, N), q)
    pred = pred.reshape(B, 1, H8, W8)
    if task_ids is not None:
        pred = pred * (task_ids == 1).to(pred.dtype)[:, None, None, None]
    return pred, gt1
