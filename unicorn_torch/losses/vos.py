"""VOS training losses of the mask stage, PyTorch (port of
unicorn_tpu/losses/vos.py), batched over B where the JAX package vmaps.

Matched (frame 0, frame 1) instance pairs are packed into K slots per sample
(with a validity mask); the K frame-0 masks propagate through one training
correlation call, and the head runs once on the slots folded into the batch
(B*K, slot-major within a sample, as `jnp.repeat` orders them). Each slot's
YOLOX loss keeps its own num_fg normalisation, as the vmapped JAX function
does.

Where the port parts from JAX: the mask branch does not depend on the
priors, so `vos_loss` takes its outputs at batch B and repeats them per slot
(the same values and gradients) where JAX runs the branch on the B*K copies
of the FPN maps.

Layout: maps are NCHW as everywhere in the port: FPN maps (B, C, H, W),
embeddings (B, C, H8, W8), the mask branch's features (B, 8, H8, W8);
targets (B, 2, M, 6) and masks (B, 2, M, Hm, Wm) as in the JAX package.

In a data-parallel step (parallel/mesh.py) the slot count that
normalises the loss is the global batch's, summed over the ranks.
"""
from __future__ import annotations

import torch

from ..models.heads import decode_boxes, flatten_raw_outputs, level_grids
from ..ops.correlation import resize_bilinear_torch
from ..ops.correlation_kernel import correlation_propagate_train
from ..parallel.mesh import global_sum
from .det import yolox_terms
from .mask import (condinst_mask_loss, dice_per_instance, gather_rows,
                   resize_antialias)


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


def fold_slots(x, K: int):
    """(B, ...) -> (B*K, ...), each sample's K copies adjacent (slot-major
    within a sample), as `jnp.repeat(x, K, axis=0)`; `Tensor.repeat` would
    tile the batch instead."""
    return x.repeat_interleave(K, dim=0)


def single_image_yolox_loss(labels, pred_boxes, obj_logits, cls_logits,
                            reg_raw, xs, ys, ss, img_size, use_l1,
                            reg_weight: float = 5.0):
    """Each image's YOLOX loss with its own num_fg normalisation. labels
    (N, M, 5); the head's outputs (N, A, ...). Returns (total (N,),
    OTAResult)."""
    (t_iou, t_obj, t_cls, t_l1), assign = yolox_terms(
        labels, pred_boxes, obj_logits, cls_logits, reg_raw, xs, ys, ss,
        img_size, use_l1)
    total = reg_weight * t_iou + t_obj + t_cls
    if use_l1:
        total = total + t_l1
    return total / assign.num_fg.clamp_min(1.0), assign


def vos_loss(model, mask_branch_out, fpn_outs_1, embed_0, embed_1, targets,
             masks, img_size, max_pairs: int = 3, up_rate: int = 8,
             sample_mask=None, use_l1: bool = False, strides=(8, 16, 32)):
    """The VOS loss over K matched-instance slots, with mask
    initialisation. mask_branch_out: (mask_feats, up_mask or None, _) of
    the mask branch on fpn_outs_1; masks (B, 2, M, Hm, Wm) instance masks
    at the d_rate grid; sample_mask (B,) weights the samples. Returns the
    loss dict (total_loss, vos_head_loss, corr_loss, condinst_loss)."""
    B, _, M, Hm, Wm = masks.shape
    H, W = img_size
    H8, W8 = H // 8, W // 8
    K = max_pairs
    C = embed_0.shape[1]

    idx0, idx1, pv = match_instance_pairs(targets, K)

    # the frame-0 masks of the slots as stride-8 label maps, propagated in
    # one call
    lbs0 = resize_antialias(gather_rows(masks[:, 0], idx0), H8, W8)

    def rows(e):
        return e.float().permute(0, 2, 3, 1).reshape(B, -1, C).contiguous()

    pred = correlation_propagate_train(rows(embed_0), rows(embed_1),
                                       lbs0.reshape(B, K, H8 * W8))
    pred = pred.reshape(B, K, H8, W8)

    # slots folded into the batch for the head, slot-major per sample
    priors_s8 = pred.reshape(B * K, 1, H8, W8)
    fpn_folded = tuple(fold_slots(f, K) for f in fpn_outs_1)
    priors = tuple(p.to(f.dtype) for p, f in zip(
        (priors_s8, resize_bilinear_torch(priors_s8, H8 // 2, W8 // 2),
         resize_bilinear_torch(priors_s8, H8 // 4, W8 // 4)), fpn_folded))
    flat = flatten_raw_outputs(model.forward_head(fpn_folded, priors), "sot")
    hw = flat["hw"]
    xs, ys, ss = level_grids(hw, strides, targets.device)
    boxes = decode_boxes(flat["reg_raw"], hw, strides)          # (B*K, A, 4)

    # one single-instance label per slot from frame 1, class 0
    b_idx = torch.arange(B, device=targets.device)[:, None]
    labels = torch.zeros((B * K, 1, 5), device=targets.device)
    labels[:, 0, 1:5] = targets[b_idx, 1, idx1, 1:5].reshape(B * K, 4)
    per_total, assign = single_image_yolox_loss(
        labels, boxes, flat["obj_logits"], flat["cls_logits"],
        flat["reg_raw"], xs, ys, ss, img_size, use_l1)

    # the correlation dice of each slot against its frame-1 instance map
    gtm1 = gather_rows(masks[:, 1], idx1)                 # (B, K, Hm, Wm)
    corr_d = dice_per_instance(pred, resize_antialias(gtm1, H8, W8))

    # CondInst on the slot instance
    mask_feats, up_mask, _ = mask_branch_out
    slot_w = pv.float()
    if sample_mask is not None:
        slot_w = slot_w * sample_mask[:, None]
    mask_l = condinst_mask_loss(
        flat["ctrl"], fold_slots(mask_feats, K),
        assign.fg_mask, assign.matched_gt, assign.pred_iou,
        gtm1.reshape(B * K, 1, Hm, Wm), hw, strides, max_inst=8,
        up_masks=None if up_mask is None else fold_slots(up_mask, K),
        up_rate=up_rate, sample_mask=slot_w.reshape(B * K))

    n_slots = global_sum(slot_w.sum()).clamp_min(1.0)
    head_l = per_total.reshape(B, K)
    return {
        "total_loss": ((head_l + corr_d) * slot_w).sum() / n_slots + mask_l,
        "vos_head_loss": (head_l * slot_w).sum() / n_slots,
        "corr_loss": (corr_d * slot_w).sum() / n_slots,
        "condinst_loss": mask_l,
    }
