"""BoxInst box-supervised instance-segmentation losses, PyTorch (port of
unicorn_tpu/losses/boxinst.py), batched over B where the JAX package vmaps.

  * projection term: dice between the x / y max-projections of the
    predicted mask probability and of the gt box rectangle;
  * pairwise term: -log P(same label) over a dilated k x k neighbourhood,
    supervised only inside the gt box where the LAB colour similarity of
    the two pixels clears a threshold.

The instances ride the same top-K anchor slots as the fully supervised
CondInst loss (losses/mask.py `select_topk_mask_logits`).

Layout: images (B, 3, H, W) as the port's models take them; neighbourhoods
(..., k*k-1, H, W) as in the JAX package; `rgb_to_lab` takes the channels
last, as there.

In a data-parallel step (parallel/mesh.py) the counts that normalise the
terms are the global batch's, summed over the ranks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.mask_head import anchor_locations_and_levels
from ..parallel.mesh import global_sum
from .mask import (dice_per_instance, gather_rows, resize_antialias,
                   select_topk_mask_logits)


def unfold_wo_center(x, kernel_size: int, dilation: int):
    """(..., H, W) -> (..., k*k-1, H, W): the dilated k x k neighbourhood of
    every pixel, centre excluded, zero padding at the borders."""
    assert kernel_size % 2 == 1
    pad = dilation * (kernel_size // 2)
    xp = F.pad(x, (pad, pad, pad, pad))
    H, W = x.shape[-2:]
    c = kernel_size // 2
    return torch.stack([xp[..., dy * dilation:dy * dilation + H,
                           dx * dilation:dx * dilation + W]
                        for dy in range(kernel_size)
                        for dx in range(kernel_size)
                        if (dy, dx) != (c, c)], -3)


def compute_pairwise_term(mask_logits, kernel_size: int = 3,
                          dilation: int = 2):
    """(..., H, W) logits -> (..., k*k-1, H, W) pairwise loss -log P(y_i =
    y_j), P = p_i p_j + (1 - p_i)(1 - p_j), in log space."""
    log_fg = F.logsigmoid(mask_logits)
    log_bg = F.logsigmoid(-mask_logits)
    log_same_fg = log_fg[..., None, :, :] + unfold_wo_center(
        log_fg, kernel_size, dilation)
    log_same_bg = log_bg[..., None, :, :] + unfold_wo_center(
        log_bg, kernel_size, dilation)
    m = torch.maximum(log_same_fg, log_same_bg)
    log_same = torch.log(torch.exp(log_same_fg - m)
                         + torch.exp(log_same_bg - m)) + m
    return -log_same


def compute_project_term(mask_scores, gt_bitmasks):
    """(..., H, W) each -> (...): the dice of the max-projections onto both
    axes, summed."""
    def dice(a, b):       # over the one remaining axis
        return dice_per_instance(a[..., None], b[..., None])

    return (dice(mask_scores.amax(-2), gt_bitmasks.amax(-2))
            + dice(mask_scores.amax(-1), gt_bitmasks.amax(-1)))


def rgb_to_lab(rgb):
    """(..., 3) sRGB in [0, 255] -> CIELAB (L in [0, 100], a / b centred at
    0), D65 white."""
    x = rgb / 255.0
    x = torch.where(x > 0.04045, ((x + 0.055) / 1.055) ** 2.4, x / 12.92)
    r, g, b = x.unbind(-1)
    X = (0.412453 * r + 0.357580 * g + 0.180423 * b) / 0.950456
    Y = 0.212671 * r + 0.715160 * g + 0.072169 * b
    Z = (0.019334 * r + 0.119193 * g + 0.950227 * b) / 1.088754

    def f(t):
        return torch.where(t > 0.008856, _cbrt(t), 7.787 * t + 16.0 / 116.0)

    fX, fY, fZ = f(X), f(Y), f(Z)
    L = torch.where(Y > 0.008856, 116.0 * _cbrt(Y) - 16.0, 903.3 * Y)
    return torch.stack([L, 500.0 * (fX - fY), 200.0 * (fY - fZ)], -1)


def _cbrt(t):
    return torch.sign(t) * t.abs().pow(1.0 / 3.0)


def images_color_similarity(img_lab, kernel_size: int = 3,
                            dilation: int = 2):
    """(..., 3, H, W) LAB images -> (..., k*k-1, H, W) neighbour similarity
    exp(-||c_i - c_j|| / 2)."""
    neigh = unfold_wo_center(img_lab, kernel_size, dilation)  # (.., 3, K, H, W)
    diff = img_lab[..., None, :, :] - neigh
    dist = torch.sqrt((diff * diff).sum(-4) + 1e-12)
    return torch.exp(-dist * 0.5)


def boxes_to_bitmasks(boxes_cxcywh, valid, Hm: int, Wm: int, stride: float):
    """(..., 4) cxcywh at input scale -> (..., Hm, Wm) box rectangles on the
    mask grid, zero where not valid."""
    cx, cy, w, h = boxes_cxcywh.float().unbind(-1)
    x1, x2 = (cx - w / 2) / stride, (cx + w / 2) / stride
    y1, y2 = (cy - h / 2) / stride, (cy + h / 2) / stride
    dev = boxes_cxcywh.device
    xs = torch.arange(Wm, dtype=torch.float32, device=dev) + 0.5
    ys = torch.arange(Hm, dtype=torch.float32, device=dev) + 0.5
    ys = ys[:, None]
    in_x = (xs >= x1[..., None, None]) & (xs <= x2[..., None, None])
    in_y = (ys >= y1[..., None, None]) & (ys <= y2[..., None, None])
    return (in_x & in_y).float() * valid[..., None, None].float()


def boxinst_mask_loss(ctrl, mask_feats, fg_mask, matched_gt, pred_iou,
                      gt_boxes, gt_valid, images, hw_list, strides,
                      max_inst: int = 48, up_masks=None, up_rate: int = 8,
                      d_rate: int = 4, pairwise_size: int = 3,
                      pairwise_dilation: int = 2, color_thresh: float = 0.3,
                      warmup_factor=1.0, bgr: bool = True):
    """The box-supervised replacement of condinst_mask_loss -> (loss_prj,
    loss_pairwise * warmup_factor). gt_boxes (B, M, 4) cxcywh at input
    scale; gt_valid (B, M); images (B, 3, H, W), 0-255, BGR unless bgr is
    False (the channels are flipped before the LAB conversion)."""
    locs, lvls = anchor_locations_and_levels(hw_list, strides, ctrl.device)
    H, W = images.shape[2:]
    Hm, Wm = H // d_rate, W // d_rate

    # LAB colour similarity at the mask grid
    rgb = images.flip(1) if bgr else images
    small = resize_antialias(rgb.float(), Hm, Wm)
    lab = rgb_to_lab(small.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    sim = images_color_similarity(lab, pairwise_size, pairwise_dilation)

    valid_b, topi, logits = select_topk_mask_logits(
        ctrl, mask_feats, fg_mask, pred_iou, locs, lvls, max_inst, up_masks,
        up_rate, Hm, Wm)
    valid = valid_b.float()                                   # (B, K)
    gt_idx = matched_gt.gather(1, topi)
    tgts = boxes_to_bitmasks(gather_rows(gt_boxes, gt_idx),
                             gather_rows(gt_valid, gt_idx), Hm, Wm,
                             float(d_rate))                   # (B, K, Hm, Wm)
    prj = compute_project_term(torch.sigmoid(logits), tgts)  # (B, K)
    pw = compute_pairwise_term(logits, pairwise_size, pairwise_dilation)
    w = ((sim[:, None] >= color_thresh).float() * tgts[:, :, None]
         * valid[..., None, None, None])
    loss_prj = (prj * valid).sum() / global_sum(valid.sum()).clamp_min(1.0)
    loss_pw = (pw * w).sum() / global_sum(w.sum()).clamp_min(1.0)
    return loss_prj, loss_pw * warmup_factor
