"""The plain reference of the serving path around the model: the letterbox,
the head's decode and the fixed-shape NMS. Frozen copies of
`unicorn_torch/ops/letterbox.py` (`letterbox_batch_device`, here written
out as half-pixel bilinear sampling), `unicorn_torch/models/heads.py`
(`flatten_raw_outputs`, `decode_for_inference`) and `unicorn_torch/ops/
nms.py` (`postprocess_device`). `dtype` is the arithmetic's precision:
fp32 for the reference, lower for the control.
"""
from __future__ import annotations

import torch


def letterbox(frames_u8, dst_hw, dtype=torch.float64):
    """(B, H, W, 3) uint8 -> (B, dst_h, dst_w, 3) float32: the frames scaled
    by r = min(dst_h / H, dst_w / W) with half-pixel bilinear sampling (no
    antialiasing), rounded half to even and clipped to [0, 255], placed top
    left on a 114 background."""
    B, sh, sw = frames_u8.shape[:3]
    dh, dw = dst_hw
    r = min(dh / sh, dw / sw)
    rh, rw = int(sh * r), int(sw * r)
    x = frames_u8.to(dtype)
    if (rh, rw) != (sh, sw):
        dev = frames_u8.device

        def taps(n_out, n_in):
            c = ((torch.arange(n_out, device=dev, dtype=torch.float64) + 0.5)
                 * (n_in / n_out) - 0.5).clamp_min(0.0)
            i0 = c.floor().long().clamp(max=n_in - 1)
            i1 = (i0 + 1).clamp(max=n_in - 1)
            f = (c - i0).to(dtype)
            return i0, i1, f

        y0, y1, fy = taps(rh, sh)
        x0, x1, fx = taps(rw, sw)
        rows = (x[:, y0] * (1 - fy)[None, :, None, None]
                + x[:, y1] * fy[None, :, None, None])
        x = (rows[:, :, x0] * (1 - fx)[None, None, :, None]
             + rows[:, :, x1] * fx[None, None, :, None])
        x = x.round().clamp(0, 255)
    out = torch.full((B, dh, dw, 3), 114.0, dtype=torch.float32,
                     device=frames_u8.device)
    out[:, :rh, :rw] = x.float()
    return out


def decode(head_out, strides=(8, 16, 32), dtype=torch.float32):
    """Per-level raw head outputs (the MOT branch: reg, obj, cls) -> (B, A,
    5 + C) [cx, cy, w, h, obj, cls...] in input pixels, levels stride 8
    first, row-major."""
    parts = []
    for out, s in zip(head_out, strides):
        b, _, h, w = out["reg"].shape
        reg = out["reg"].to(dtype).permute(0, 2, 3, 1).reshape(b, h * w, 4)
        obj = out["obj"].to(dtype).permute(0, 2, 3, 1).reshape(b, h * w, 1)
        cls = out["cls"].to(dtype).permute(0, 2, 3, 1).reshape(b, h * w, -1)
        yv, xv = torch.meshgrid(torch.arange(h, device=reg.device),
                                torch.arange(w, device=reg.device),
                                indexing="ij")
        gx = xv.reshape(-1).to(dtype)
        gy = yv.reshape(-1).to(dtype)
        box = torch.stack([(reg[..., 0] + gx) * s, (reg[..., 1] + gy) * s,
                           torch.exp(reg[..., 2]) * s,
                           torch.exp(reg[..., 3]) * s], -1)
        parts.append(torch.cat([box, torch.sigmoid(obj), torch.sigmoid(cls)],
                               -1))
    return torch.cat(parts, 1)


def _iou_matrix_xyxy(boxes):
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = (x2 - x1) * (y2 - y1)
    ix1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    ix2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    iy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = (ix2 - ix1).clamp_min(0) * (iy2 - iy1).clamp_min(0)
    return inter / (areas[..., :, None] + areas[..., None, :] - inter + 1e-12)


def nms(prediction, num_classes, conf_thre, nms_thre, n_cand, max_out,
        cluster_iters, dtype=torch.float32):
    """prediction (B, A, 5 + C) -> (dets5 (B, max_out, 5) [x1, y1, x2, y2,
    obj * cls], valid (B, max_out)): scores obj * best class at least
    conf_thre, the n_cand best (ties to the lower index), class-aware
    Cluster-NMS for `cluster_iters` steps (a kept box suppresses a later one
    of IoU > nms_thre), kept rows first in score order, the rest zero."""
    p = prediction.to(dtype)
    B, A = p.shape[:2]
    n_cand = min(n_cand, A)
    max_out = min(max_out, n_cand)
    dev = p.device
    xy1 = p[..., :2] - p[..., 2:4] / 2
    xy2 = p[..., :2] + p[..., 2:4] / 2
    boxes = torch.cat([xy1, xy2], -1)
    obj = p[..., 4]
    cls_conf, cls_idx = p[..., 5:5 + num_classes].max(-1)
    cls_id = cls_idx.to(dtype)
    score = obj * cls_conf
    valid = score >= conf_thre
    score_m = torch.where(valid, score, torch.full_like(score, -torch.inf))
    if num_classes == 1:
        nms_boxes = boxes
    else:
        max_coord = torch.where(valid[..., None], boxes,
                                torch.zeros_like(boxes)).amax((1, 2))
        nms_boxes = boxes + cls_id[..., None] * (max_coord[:, None, None] + 1)
    top, order = torch.sort(score_m, dim=-1, descending=True, stable=True)
    top, order = top[..., :n_cand], order[..., :n_cand]
    cand = torch.gather(nms_boxes, 1, order[..., None].expand(B, n_cand, 4))
    upper = torch.ones(n_cand, n_cand, dtype=torch.bool, device=dev).triu(1)
    sup = (_iou_matrix_xyxy(cand) > nms_thre) & upper
    keep = torch.ones_like(top, dtype=torch.bool)
    for _ in range(cluster_iters):
        keep = ~(sup & keep[..., :, None]).any(-2)
    keep = keep & (top > -torch.inf)
    rank = torch.cumsum(keep.int(), 1) - 1
    dst = torch.where(keep, rank, torch.full_like(rank, n_cand))
    rows = torch.cat([
        torch.gather(boxes, 1, order[..., None].expand(B, n_cand, 4)),
        (torch.gather(obj, 1, order) * torch.gather(cls_conf, 1, order))[
            ..., None]], -1)
    out = torch.zeros(B, n_cand + 1, 5, dtype=rows.dtype, device=dev)
    out.scatter_(1, dst[..., None].expand(B, n_cand, 5), rows)
    valid_out = (torch.arange(max_out, device=dev)[None]
                 < keep.sum(1)[:, None])
    return out[:, :max_out].float(), valid_out
