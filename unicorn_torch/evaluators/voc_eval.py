"""Pascal VOC detection evaluation (port of
unicorn_tpu/evaluators/voc_eval.py): the VOC protocol's per-class AP with
difficult objects and the 07 11-point metric (the reference's
unicorn/evaluators/voc_eval.py).
"""
from __future__ import annotations

import numpy as np


def voc_ap(rec, prec, use_07_metric=False):
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.sum(rec >= t) else 0.0
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def voc_eval_class(dets, gts, iou_thr=0.5, use_07_metric=False):
    """dets: [(img_id, score, x1, y1, x2, y2)]; gts: {img_id: (boxes (N,4),
    difficult (N,))}. Returns (rec, prec, ap)."""
    npos = sum(int((~d).sum()) for _, d in gts.values())
    matched = {k: np.zeros(len(b), bool) for k, (b, _) in gts.items()}
    dets = sorted(dets, key=lambda d: -d[1])
    tp = np.zeros(len(dets))
    fp = np.zeros(len(dets))
    for i, (img_id, score, x1, y1, x2, y2) in enumerate(dets):
        if img_id not in gts:
            fp[i] = 1
            continue
        boxes, difficult = gts[img_id]
        if len(boxes) == 0:
            fp[i] = 1
            continue
        ixmin = np.maximum(boxes[:, 0], x1)
        iymin = np.maximum(boxes[:, 1], y1)
        ixmax = np.minimum(boxes[:, 2], x2)
        iymax = np.minimum(boxes[:, 3], y2)
        iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
        ih = np.maximum(iymax - iymin + 1.0, 0.0)
        inters = iw * ih
        uni = ((x2 - x1 + 1.0) * (y2 - y1 + 1.0)
               + (boxes[:, 2] - boxes[:, 0] + 1.0)
               * (boxes[:, 3] - boxes[:, 1] + 1.0) - inters)
        overlaps = inters / uni
        jmax = int(np.argmax(overlaps))
        if overlaps[jmax] > iou_thr:
            if difficult[jmax]:
                continue  # neither tp nor fp
            if not matched[img_id][jmax]:
                tp[i] = 1
                matched[img_id][jmax] = True
            else:
                fp[i] = 1
        else:
            fp[i] = 1
    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / max(npos, 1)
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)


def voc_map(all_dets, all_gts, iou_thr=0.5, use_07_metric=False):
    """all_dets: {cls: dets list}; all_gts: {cls: {img: (boxes, difficult)}}."""
    aps = {}
    for cls in all_gts:
        dets = all_dets.get(cls, [])
        _, _, ap = voc_eval_class(dets, all_gts[cls], iou_thr, use_07_metric)
        aps[cls] = ap
    return {"mAP": float(np.mean(list(aps.values()))) if aps else 0.0,
            "per_class": aps}
