"""COCO mAP without pycocotools (port of unicorn_tpu/evaluators/coco_map.py).

COCOeval's bbox / segm protocol: 101-point interpolated AP over IoU
0.5:0.95, the four area ranges, 100 detections an image; the role of the
reference's C++ fast COCOeval (unicorn/layers/csrc/cocoeval/cocoeval.cpp).
The per-(image, category) greedy matching runs on the native matcher
`csrc/cocoeval.cpp` (csrc/native.py); `match_plain` is the Python loop the
tests hold it against. Segm IoU runs on the native RLE codec.

Inputs are plain dicts: detections [{image_id, category_id, bbox [x, y, w,
h], score(, segmentation)}], ground truth as a COCO json dict.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

from ..csrc import native
from . import rle as rle_codec

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.00, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = 100


def _box_iou_xywh(d, g, iscrowd):
    """IoU between det boxes d (D, 4) and gt boxes g (G, 4), xywh; for a
    crowd gt, the intersection over the det's area (COCO's convention)."""
    if len(d) == 0 or len(g) == 0:
        return np.zeros((len(d), len(g)))
    dx1, dy1 = d[:, 0], d[:, 1]
    dx2, dy2 = d[:, 0] + d[:, 2], d[:, 1] + d[:, 3]
    gx1, gy1 = g[:, 0], g[:, 1]
    gx2, gy2 = g[:, 0] + g[:, 2], g[:, 1] + g[:, 3]
    ix1 = np.maximum(dx1[:, None], gx1[None, :])
    iy1 = np.maximum(dy1[:, None], gy1[None, :])
    ix2 = np.minimum(dx2[:, None], gx2[None, :])
    iy2 = np.minimum(dy2[:, None], gy2[None, :])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    d_area = (d[:, 2] * d[:, 3])[:, None]
    g_area = (g[:, 2] * g[:, 3])[None, :]
    union = np.where(iscrowd[None, :], d_area, d_area + g_area - inter)
    return inter / np.maximum(union, 1e-12)


def match_plain(ious, gt_ig, iscrowd, thresholds):
    """The Python form of native.evaluate_img: ious (D, G) with the gts
    sorted non-ignored first -> (dt_match (T, D) sorted gt index or -1,
    dt_ignore (T, D))."""
    D, G = ious.shape
    T = len(thresholds)
    dt_m = np.full((T, D), -1, np.int64)
    gt_m = np.full((T, G), -1, np.int64)
    dt_ig = np.zeros((T, D), bool)
    for t, thr in enumerate(thresholds):
        for di in range(D):
            iou = min(thr, 1 - 1e-10)
            m = -1
            for gi in range(G):
                if gt_m[t, gi] >= 0 and not iscrowd[gi]:
                    continue
                if m > -1 and not gt_ig[m] and gt_ig[gi]:
                    break  # best non-ignored match found; rest are ignored
                if ious[di, gi] < iou:
                    continue
                iou = ious[di, gi]
                m = gi
            if m == -1:
                continue
            dt_ig[t, di] = gt_ig[m]
            dt_m[t, di] = m
            gt_m[t, m] = di
    return dt_m, dt_ig


def _evaluate_img(dts, gts, ious, area_rng, match=native.evaluate_img):
    """Greedy matching of one (image, category) at every IoU threshold, as
    COCOeval.evaluateImg; dts sorted by score, descending. Returns
    (dt_matches (T, D) gt index or -1, dt_ignore (T, D), gt_ignore (G,))."""
    T, G, D = len(IOU_THRS), len(gts), len(dts)
    gt_ig = np.array([
        g.get("iscrowd", 0) == 1
        or g["area"] < area_rng[0] or g["area"] > area_rng[1]
        for g in gts
    ], bool)
    # gts sorted non-ignored first (stable)
    g_order = np.argsort(gt_ig, kind="stable")
    gt_ig = gt_ig[g_order]
    iscrowd_sorted = np.array(
        [gts[g_order[gi]].get("iscrowd", 0) == 1 for gi in range(G)], bool)
    if D and G:
        dt_m_sorted, dt_ig = match(ious[:, g_order], gt_ig, iscrowd_sorted,
                                   IOU_THRS)
        dt_m = np.where(dt_m_sorted >= 0,
                        g_order[np.clip(dt_m_sorted, 0, G - 1)], -1)
    else:
        dt_m = np.full((T, D), -1, np.int64)
        dt_ig = np.zeros((T, D), bool)
    # unmatched dets outside the area range are ignored
    d_areas = np.array([d["area"] for d in dts])
    d_out = (d_areas < area_rng[0]) | (d_areas > area_rng[1])
    dt_ig = dt_ig | ((dt_m == -1) & d_out[None, :])
    return dt_m, dt_ig, gt_ig


class COCOMeanAP:
    """Accumulates detections and computes COCO AP metrics. match: the
    matcher, native.evaluate_img (the default) or match_plain."""

    def __init__(self, gt_dataset: dict, iou_type: str = "bbox",
                 match=native.evaluate_img):
        """gt_dataset: COCO-format dict with images / annotations /
        categories."""
        self.iou_type = iou_type
        self.match = match
        self.imgs = {im["id"]: im for im in gt_dataset["images"]}
        self.cat_ids = sorted(c["id"] for c in gt_dataset["categories"])
        self.gt = defaultdict(list)  # (img_id, cat_id) -> [ann]
        for a in gt_dataset["annotations"]:
            if "area" not in a:
                a["area"] = a["bbox"][2] * a["bbox"][3]
            self.gt[(a["image_id"], a["category_id"])].append(a)

    def evaluate(self, detections: list[dict], img_ids=None):
        """detections: COCO results format. Returns a dict of AP metrics."""
        if img_ids is None:
            img_ids = sorted(self.imgs.keys())
        dt = defaultdict(list)
        for d in detections:
            if "area" not in d:
                if "bbox" in d:
                    d["area"] = d["bbox"][2] * d["bbox"][3]
                else:  # segm-only result: the area of its RLE
                    d["area"] = float(rle_codec.area(d["segmentation"]))
            dt[(d["image_id"], d["category_id"])].append(d)

        area_names = list(AREA_RNG.keys())
        T, R, K, A = (len(IOU_THRS), len(REC_THRS), len(self.cat_ids),
                      len(area_names))
        precision = -np.ones((T, R, K, A))
        recall = -np.ones((T, K, A))

        for k, cat_id in enumerate(self.cat_ids):
            # the per-image results of this category
            per_area = {a: {"scores": [], "m": [], "ig": [], "n_gt": 0}
                        for a in area_names}
            for img_id in img_ids:
                gts = self.gt.get((img_id, cat_id), [])
                dts = sorted(dt.get((img_id, cat_id), []),
                             key=lambda d: -d["score"])[:MAX_DETS]
                if len(gts) == 0 and len(dts) == 0:
                    continue
                iscrowd = np.array([g.get("iscrowd", 0) == 1 for g in gts],
                                   bool)
                if self.iou_type == "bbox":
                    d_boxes = np.array([d["bbox"] for d in dts],
                                       np.float64).reshape(-1, 4)
                    g_boxes = np.array([g["bbox"] for g in gts],
                                       np.float64).reshape(-1, 4)
                    ious = _box_iou_xywh(d_boxes, g_boxes, iscrowd)
                else:
                    ious = rle_codec.iou_rle(
                        [d["segmentation"] for d in dts],
                        [g["segmentation"] for g in gts], iscrowd)
                scores = np.array([d["score"] for d in dts])
                for a_name in area_names:
                    dt_m, dt_ig, gt_ig = _evaluate_img(
                        dts, gts, ious, AREA_RNG[a_name], self.match)
                    st = per_area[a_name]
                    st["scores"].append(scores)
                    st["m"].append(dt_m)
                    st["ig"].append(dt_ig)
                    st["n_gt"] += int((~gt_ig).sum())

            # accumulate across images
            for a, a_name in enumerate(area_names):
                st = per_area[a_name]
                if st["n_gt"] == 0 or not st["scores"]:
                    continue
                scores = np.concatenate(st["scores"])
                order = np.argsort(-scores, kind="mergesort")
                m = np.concatenate(st["m"], axis=1)[:, order]
                ig = np.concatenate(st["ig"], axis=1)[:, order]
                tps = (m >= 0) & ~ig
                fps = (m < 0) & ~ig
                tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                for t in range(T):
                    tp, fp = tp_sum[t], fp_sum[t]
                    rc = tp / st["n_gt"]
                    pr = tp / np.maximum(tp + fp, np.spacing(1))
                    recall[t, k, a] = rc[-1] if len(rc) else 0
                    # precision made monotonically decreasing
                    pr = pr.tolist()
                    for i in range(len(pr) - 1, 0, -1):
                        if pr[i] > pr[i - 1]:
                            pr[i - 1] = pr[i]
                    inds = np.searchsorted(rc, REC_THRS, side="left")
                    q = np.zeros(R)
                    for ri, pi in enumerate(inds):
                        if pi < len(pr):
                            q[ri] = pr[pi]
                    precision[t, :, k, a] = q

        def _ap(t_slice=slice(None), area="all"):
            a = area_names.index(area)
            p = precision[t_slice, :, :, a]
            p = p[p > -1]
            return float(np.mean(p)) if p.size else -1.0

        def _ar(area="all"):
            a = area_names.index(area)
            r = recall[:, :, a]
            r = r[r > -1]
            return float(np.mean(r)) if r.size else -1.0

        t50 = [i for i, t in enumerate(IOU_THRS) if abs(t - 0.5) < 1e-6]
        t75 = [i for i, t in enumerate(IOU_THRS) if abs(t - 0.75) < 1e-6]
        return {
            "AP": _ap(),
            "AP50": _ap(t50),
            "AP75": _ap(t75),
            "APs": _ap(area="small"),
            "APm": _ap(area="medium"),
            "APl": _ap(area="large"),
            "AR": _ar(),
        }
