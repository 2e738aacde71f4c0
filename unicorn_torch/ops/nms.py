"""Fixed-shape NMS and the detection postprocess on the device, PyTorch
(port of unicorn_tpu/ops/nms.py).

Semantics of the JAX version: scores pass at >= conf_thre; candidates are
the n_cand best scores in descending order, ties to the lower index (a
stable sort, as jax.lax.top_k orders them); a kept box suppresses a later
one whose IoU is strictly greater than the threshold; areas have no +1;
class-aware NMS offsets boxes by class id.
"""
from __future__ import annotations

import torch

from ..utils.profiling import spanned


def _iou_matrix_xyxy(boxes):
    """(..., N, 4) xyxy -> (..., N, N) IoU."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = (x2 - x1) * (y2 - y1)
    ix1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    ix2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    iy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = (ix2 - ix1).clamp_min(0) * (iy2 - iy1).clamp_min(0)
    return inter / (areas[..., :, None] + areas[..., None, :] - inter + 1e-12)


def nms_fixed(boxes, scores, iou_threshold: float, n_cand: int,
              cluster_iters: int = 0, approx_topk: bool = False):
    """NMS over the n_cand best-scoring boxes, batched over leading axes.

    boxes (..., A, 4) xyxy, scores (..., A). Returns (keep (..., n_cand)
    bool, order (..., n_cand) indices into A).

    cluster_iters == 0 gives exact greedy NMS. It runs the Cluster-NMS
    step (keep_j <- no kept higher-scored box suppresses j) until keep stops
    changing: the step fixes at least one more candidate, in score order,
    each time, and its only fixed point is the greedy result. That is a few
    batched steps on the device instead of n_cand sequential ones.
    cluster_iters > 0 runs exactly that many steps, as the JAX version does.
    """
    if approx_topk:
        raise NotImplementedError("approx_topk is a TPU-only candidate "
                                  "selection (jax.lax.approx_max_k)")
    top_scores, order = torch.sort(scores, dim=-1, descending=True,
                                   stable=True)
    top_scores, order = top_scores[..., :n_cand], order[..., :n_cand]
    cand = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    iou = _iou_matrix_xyxy(cand)
    upper = torch.ones(n_cand, n_cand, dtype=torch.bool,
                       device=boxes.device).triu(1)
    sup_mat = (iou > iou_threshold) & upper   # i suppresses j (i scored higher)

    def step(keep):
        # j survives iff no kept higher-scored i suppresses it
        return ~(sup_mat & keep[..., :, None]).any(-2)

    keep = torch.ones_like(top_scores, dtype=torch.bool)
    if cluster_iters > 0:
        for _ in range(cluster_iters):
            keep = step(keep)
    else:
        for _ in range(n_cand):
            new = step(keep)
            if torch.equal(new, keep):
                break
            keep = new
    keep = keep & (top_scores > -torch.inf)
    return keep, order


@spanned("postprocess.nms")
def postprocess_device(prediction, num_classes: int, conf_thre: float = 0.7,
                       nms_thre: float = 0.45, class_agnostic: bool = False,
                       n_cand: int = 512, max_out: int = 128,
                       cluster_iters: int = 0, approx_topk: bool = False,
                       return_idx: bool = False):
    """prediction (B, A, 5+C) [cxcywh, obj_sig, cls_sig...] -> dets
    (B, max_out, 7) [x1,y1,x2,y2,obj,cls_conf,cls_id] in score order and
    valid (B, max_out) bool; invalid rows are zero. return_idx adds the kept
    rows' anchor indices (B, max_out) int32."""
    B, A = prediction.shape[:2]
    n_cand = min(n_cand, A)
    max_out = min(max_out, n_cand)
    dev = prediction.device

    boxes = prediction[..., :4]
    xy1 = boxes[..., :2] - boxes[..., 2:4] / 2
    xy2 = boxes[..., :2] + boxes[..., 2:4] / 2
    boxes_xyxy = torch.cat([xy1, xy2], -1)
    obj = prediction[..., 4]
    cls_conf, cls_idx = prediction[..., 5:5 + num_classes].max(-1)
    cls_id = cls_idx.float()
    score = obj * cls_conf
    valid = score >= conf_thre
    score_m = torch.where(valid, score, torch.full_like(score, -torch.inf))

    if class_agnostic:
        nms_boxes = boxes_xyxy
    else:
        max_coord = torch.where(valid[..., None], boxes_xyxy,
                                torch.zeros_like(boxes_xyxy)).amax((1, 2))
        nms_boxes = boxes_xyxy + cls_id[..., None] * (max_coord[:, None, None]
                                                      + 1.0)

    keep, order = nms_fixed(nms_boxes, score_m, nms_thre, n_cand,
                            cluster_iters=cluster_iters,
                            approx_topk=approx_topk)
    keep = keep & (torch.gather(score_m, 1, order) > -torch.inf)
    # compact kept rows to the front, preserving score order
    rank = torch.cumsum(keep.int(), 1) - 1
    dst = torch.where(keep, rank, torch.full_like(rank, n_cand))
    rows = torch.cat([
        torch.gather(boxes_xyxy, 1, order[..., None].expand(B, n_cand, 4)),
        torch.gather(obj, 1, order)[..., None],
        torch.gather(cls_conf, 1, order)[..., None],
        torch.gather(cls_id, 1, order)[..., None]], -1)
    out = torch.zeros(B, n_cand + 1, 7, dtype=rows.dtype, device=dev)
    out.scatter_(1, dst[..., None].expand(B, n_cand, 7), rows)
    n_keep = keep.sum(1)
    valid_out = torch.arange(max_out, device=dev)[None] < n_keep[:, None]
    dets = out[:, :max_out]
    if return_idx:
        idx = torch.zeros(B, n_cand + 1, dtype=torch.int32, device=dev)
        idx.scatter_(1, dst, order.int())
        return dets, valid_out, idx[:, :max_out]
    return dets, valid_out
