"""Unified SOT+MOT training losses, PyTorch (port of
unicorn_tpu/losses/uni.py), batched over B where the JAX package vmaps.

The per-sample task split is sample-mask weighting: the SOT and the MOT
losses are both computed over the whole batch and weighted by the task
masks; the head runs once with per-sample priors (the propagated label map
for SOT samples, zeros for MOT samples).

Layout: maps are NCHW here, as everywhere in the port: embeddings
(B, C, H8, W8), priors and label maps (B, 1, H8, W8). The JAX package keeps
them NHWC.

In a data-parallel step (parallel/mesh.py) the batch size, the task
counts and the correlation dice are those of the global batch.
"""
from __future__ import annotations

import torch

from ..models.heads import decode_boxes, flatten_raw_outputs, level_grids
from ..ops.correlation import box_label_map, dice_loss, resize_bilinear_torch
from ..ops.correlation_kernel import correlation_propagate_train
from ..parallel.mesh import global_sum
from ..utils.profiling import spanned
from .det import yolox_losses
from .vos import match_instance_pairs


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


@spanned("loss.uni")
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
    # batch-wide counts: those of the global batch in a data-parallel step
    B = global_sum(targets.shape[0], like=targets)
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
    n_sot = global_sum(sot_mask.sum())

    out = {"corr_loss_sot": corr_sot}
    out.update({k + "_sot": v for k, v in sot_dict.items()
                if k != "total_loss"})
    if sot_only:
        out["total_loss"] = n_sot * total_sot / B
        return out

    mot_dict = head_losses("mot", labels1, mot_mask)
    corr_mot_b = mot_contrastive_loss_single(embed_0, embed_1, targets,
                                             bidirect)
    n_mot = global_sum(mot_mask.sum())
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


@spanned("loss.sot_priors")
def build_sot_priors(embed_0, embed_1, targets, img_size, task_ids=None):
    """Propagate the frame-0 target box label map to frame 1 through the
    fp32 embedding correlation. embed_0, embed_1 (B, C, H8, W8). Returns
    (pred_prior_s8 (B, 1, H8, W8), gt_lbs1_s8 (B, 1, H8, W8)); the prior is
    zeroed for non-SOT samples, so that the one head call sees zero priors
    for MOT samples."""
    B, C, H8, W8 = embed_0.shape
    H, W = img_size
    N = H8 * W8
    lbs0 = resize_bilinear_torch(
        box_label_map(targets[:, 0, 0, 1:5], H, W)[:, None], H8, W8)
    gt1 = resize_bilinear_torch(
        box_label_map(targets[:, 1, 0, 1:5], H, W)[:, None], H8, W8)

    def rows(e):
        return e.float().permute(0, 2, 3, 1).reshape(B, N, C).contiguous()

    pred = correlation_propagate_train(rows(embed_0), rows(embed_1),
                                       lbs0.reshape(B, 1, N))
    pred = pred.reshape(B, 1, H8, W8)
    if task_ids is not None:
        pred = pred * (task_ids == 1).to(pred.dtype)[:, None, None, None]
    return pred, gt1
