"""BDD100K evaluator (port of unicorn_tpu/evaluators/bdd_evaluator.py):
detection-style inference, the scalabel-format dump, MOT / MOTS through
the port's MOTOmniDriver, and the scalabel protocol's mMOTA / mIDF1 and
mMOTSA scoring.

Reference: unicorn/evaluators/bdd_evaluator.py:30-165 (mmcv's bbox.pkl
dump) and the qdtrack harness (external/qdtrack + bdd100k's scalabel
eval). Results are written as scalabel json (BDD's own format) and the
seg_track bitmask PNGs, and scored with the CLEAR-MOT accumulators of
mot_metrics.py: per-class accumulation across videos, mMOTA / mIDF1 = the
mean over the classes with ground truth (scalabel's `evalMOT`), crowd boxes
and unscored categories as ignore regions.
"""
from __future__ import annotations

import json
import os
from collections import defaultdict

import numpy as np
import torch

from ..data.image_io import write_png
from ..device import images_to_device, resolve_device, to_host
from . import rle as rle_codec
from .mot_evaluator import merge_mots_masks
from .mot_metrics import MOTAccumulator, aggregate_metrics
from .mots_metrics import score_mots_per_class

BDD_CLASSES = ("pedestrian", "rider", "car", "truck", "bus", "train",
               "motorcycle", "bicycle")
_CLS_INDEX = {c: i for i, c in enumerate(BDD_CLASSES)}
_IGNORE_CATS = ("other person", "other vehicle", "trailer")


def _frame_key(frame):
    return (frame.get("videoName"), frame.get("frameIndex", 0))


def _split_gt(frame):
    """gt scalabel frame -> (per-class {cls: (ids, boxes)}, ignore_boxes)."""
    per_cls = defaultdict(lambda: ([], []))
    ignore = []
    for lab in frame.get("labels") or []:
        cat = lab.get("category")
        box = lab.get("box2d")
        if box is None:
            continue
        b = [box["x1"], box["y1"], box["x2"], box["y2"]]
        crowd = (lab.get("attributes") or {}).get("crowd", False)
        if cat in _IGNORE_CATS or crowd:
            ignore.append(b)
            continue
        if cat not in _CLS_INDEX:
            continue
        ids, boxes = per_cls[_CLS_INDEX[cat]]
        ids.append(int(lab["id"]))
        boxes.append(b)
    return per_cls, np.asarray(ignore, np.float32).reshape(-1, 4)


def _drop_ignored(ids, boxes, ignore, iof_thr=0.5):
    """Remove predictions mostly inside an ignore region (scalabel protocol:
    intersection-over-foreground > 0.5 vs crowd/unscored boxes)."""
    if len(boxes) == 0 or len(ignore) == 0:
        return ids, boxes
    b = np.asarray(boxes, np.float32).reshape(-1, 4)
    tl = np.maximum(b[:, None, :2], ignore[None, :, :2])
    br = np.minimum(b[:, None, 2:], ignore[None, :, 2:])
    inter = np.prod(np.clip(br - tl, 0, None), -1)
    area = np.prod(np.clip(b[:, 2:] - b[:, :2], 0, None), -1)
    iof = inter / np.maximum(area[:, None], 1e-9)
    keep = iof.max(axis=1) <= iof_thr
    return [i for i, k in zip(ids, keep) if k], [x for x, k in zip(boxes, keep) if k]


def score_scalabel(pred_frames, gt_frames, iou_thr=0.5):
    """Scalabel MOT scoring (bdd100k evalMOT protocol).

    pred_frames/gt_frames: lists of scalabel frame dicts (videoName,
    frameIndex, labels with id/category/box2d). Returns a dict with mMOTA,
    mIDF1, per-class metrics, and the all-class aggregate.
    """
    preds = {_frame_key(f): f for f in pred_frames}
    accs = defaultdict(dict)  # cls -> {video: MOTAccumulator}
    gt_by_video = defaultdict(list)
    for f in gt_frames:
        gt_by_video[f.get("videoName")].append(f)
    for v in gt_by_video.values():
        v.sort(key=lambda f: f.get("frameIndex", 0))

    cls_has_gt = set()
    for video, frames in gt_by_video.items():
        for frame in frames:
            gt_per_cls, ignore = _split_gt(frame)
            pf = preds.get(_frame_key(frame), {})
            hyp_per_cls = defaultdict(lambda: ([], []))
            for lab in pf.get("labels") or []:
                cat = lab.get("category")
                if cat not in _CLS_INDEX or lab.get("box2d") is None:
                    continue
                b = lab["box2d"]
                ids, boxes = hyp_per_cls[_CLS_INDEX[cat]]
                ids.append(int(lab["id"]))
                boxes.append([b["x1"], b["y1"], b["x2"], b["y2"]])
            for c in range(len(BDD_CLASSES)):
                g_ids, g_boxes = gt_per_cls.get(c, ([], []))
                h_ids, h_boxes = hyp_per_cls.get(c, ([], []))
                h_ids, h_boxes = _drop_ignored(h_ids, h_boxes, ignore)
                if g_ids:
                    cls_has_gt.add(c)
                if c not in accs or video not in accs[c]:
                    accs[c][video] = MOTAccumulator(iou_thr=iou_thr)
                accs[c][video].update(g_ids, g_boxes, h_ids, h_boxes)

    per_class = {}
    for c in sorted(cls_has_gt):
        per_class[BDD_CLASSES[c]] = aggregate_metrics(list(accs[c].values()))
    scored = list(per_class.values())
    all_acc = [a for c in cls_has_gt for a in accs[c].values()]
    out = {
        "mMOTA": float(np.mean([m["MOTA"] for m in scored])) if scored else 0.0,
        "mIDF1": float(np.mean([m["IDF1"] for m in scored])) if scored else 0.0,
        "per_class": per_class,
        "overall": aggregate_metrics(all_acc) if all_acc else {},
    }
    return out


def _frames_to_mots(frames):
    """Scalabel frames with rle-carrying labels ->
    {video: [(frameIndex, ids, class_indices, rles)]} for mots_metrics."""
    out = defaultdict(list)
    for f in frames:
        ids, clss, rles = [], [], []
        for lab in f.get("labels") or []:
            r = lab.get("rle")
            cat = lab.get("category")
            if r is None or cat not in _CLS_INDEX:
                continue
            ids.append(int(lab["id"]))
            clss.append(_CLS_INDEX[cat])
            rles.append(r)
        out[f.get("videoName")].append(
            (f.get("frameIndex", 0), ids, clss, rles))
    return dict(out)


def _split_gt_mots(gt_frames):
    """gt scalabel frames -> (scoreable frames dict for mots_metrics,
    {(video, frameIndex): [ignore rles]}). Crowd-attributed labels and
    unscored categories become mask ignore REGIONS instead of gt rows —
    the reference drops them from the annotations and suppresses matched
    predictions (eval_mots -> preprocessResult,
    qdtrack core/evaluation/mots.py:31-34 + mot_pcan.py:38-101)."""
    out = defaultdict(list)
    ignores = {}
    for f in gt_frames:
        ids, clss, rles, ign = [], [], [], []
        for lab in f.get("labels") or []:
            r = lab.get("rle")
            if r is None:
                continue
            cat = lab.get("category")
            crowd = (lab.get("attributes") or {}).get("crowd", False)
            if crowd or cat in _IGNORE_CATS or cat not in _CLS_INDEX:
                ign.append(r)
                continue
            ids.append(int(lab["id"]))
            clss.append(_CLS_INDEX[cat])
            rles.append(r)
        key = (f.get("videoName"), f.get("frameIndex", 0))
        out[f.get("videoName")].append(
            (f.get("frameIndex", 0), ids, clss, rles))
        if ign:
            ignores[key] = ign
    return dict(out), ignores


def score_scalabel_seg(pred_frames, gt_frames, iou_thr=0.5,
                       ignore_iof_thr=0.5):
    """BDD seg_track (MOTS) scoring: per-class mask-IoU CLEAR-MOT,
    class-averaged — the reference's eval_mots seg_track half
    (external/qdtrack/qdtrack/core/evaluation/mots.py:23-93 with
    class_average). Frames carry labels [{id, category, rle}]. Crowd and
    unscored-category gt masks act as ignore regions: predictions whose
    mask lies mostly inside one (intersection-over-prediction >
    ignore_iof_thr, the rle-domain form of the reference's crowd_ioa_thr)
    are suppressed rather than counted as FPs. Returns
    {mMOTSA, msMOTSA, mIDF1, per_class, overall}."""
    gts, ignores = _split_gt_mots(gt_frames)
    preds = _frames_to_mots(pred_frames)
    if ignores:
        filtered = {}
        for video, frames in preds.items():
            vid_frames = []
            for frame_id, ids, clss, rles in frames:
                ign = ignores.get((video, frame_id))
                if ign and rles:
                    iof = rle_codec.iou_rle(list(rles), list(ign),
                                            iscrowd=[1] * len(ign))
                    keep = np.asarray(iof).max(axis=1) <= ignore_iof_thr
                    ids = [i for i, k in zip(ids, keep) if k]
                    clss = [c for c, k in zip(clss, keep) if k]
                    rles = [r for r, k in zip(rles, keep) if k]
                vid_frames.append((frame_id, ids, clss, rles))
            filtered[video] = vid_frames
        preds = filtered
    return score_mots_per_class(preds, gts, iou_thr=iou_thr)


def write_bdd_bitmask(path, masks, ids, classes, scores):
    """One frame's instance masks -> the BDD100K seg_track bitmask PNG
    (reference external/qdtrack/qdtrack/core/to_bdd100k/utils.py:24-38):
    RGBA uint8 with R = category_id (1-based), G = attribute byte (0),
    B = id >> 8, A = id & 255; masks painted in ascending score so higher
    score wins contested pixels.

    masks: (N, H, W) binary at image resolution."""
    masks = np.asarray(masks, bool)
    n = len(masks)
    h, w = masks.shape[1:] if n else (1, 1)
    bitmask = np.zeros((h, w, 4), np.uint8)
    for k in np.argsort(np.asarray(scores, np.float64), kind="stable"):
        m = masks[k]
        tid = int(ids[k])
        color = (int(classes[k]) + 1, 0, (tid >> 8) & 255, tid & 255)
        bitmask[m] = color
    write_png(path, bitmask)


class BDDEvaluator:
    def __init__(self, dataset, img_size, conf_thre=0.01, nms_thre=0.65,
                 num_classes=8, device="cuda"):
        self.dataset = dataset
        self.img_size = img_size
        self.conf_thre = conf_thre
        self.nms_thre = nms_thre
        self.num_classes = num_classes
        self.device = resolve_device(device)

    def evaluate_det(self, step_fn, out_path=None, max_images=None):
        """step_fn(frame (1, 3, H, W) on the device, letterboxed) -> (dets
        (K, 7), valid). Writes the scalabel det json."""
        n = len(self.dataset) if max_images is None else min(
            max_images, len(self.dataset))
        frames_out = []
        for i in range(n):
            img, _, info, _ = self.dataset[i]
            h, w = info[0], info[1]
            name = info[4] if len(info) > 4 else str(i)
            with torch.inference_mode():
                dets, valid = step_fn(images_to_device(img[None],
                                                       self.device))
                dets = to_host(dets)[to_host(valid).astype(bool)]
            scale = min(self.img_size[0] / float(h), self.img_size[1] / float(w))
            labels = []
            for k, d in enumerate(dets):
                if not 0 <= int(d[6]) < len(BDD_CLASSES):
                    continue  # unscoreable class: skip, don't wrap
                x1, y1, x2, y2 = d[:4] / scale
                labels.append({
                    "id": k,
                    "category": BDD_CLASSES[int(d[6])],
                    "score": float(d[4] * d[5]),
                    "box2d": {"x1": float(x1), "y1": float(y1),
                              "x2": float(x2), "y2": float(y2)},
                })
            frames_out.append({"name": os.path.basename(name),
                               "videoName": name.split("/")[0],
                               "labels": labels})
        if out_path:
            os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
            with open(out_path, "w") as f:
                json.dump(frames_out, f)
        return frames_out

    def evaluate_seg_mot(self, driver, out_dir=None, max_frames=None,
                         mask_thres=0.3):
        """MOTS over BDD: streams frames through a with_mask MOTOmniDriver,
        realigns masks with the tracker output (driver contract), writes the
        BDD seg_track submission — per-frame bitmask PNGs
        (out_dir/seg_track/<video>/<name>.png) + seg_track.json — and
        returns (results, scalabel pred frames with rle labels) for
        score_scalabel_seg. Reference: seg_track_to_bdd100k
        (external/qdtrack/qdtrack/core/to_bdd100k/transforms.py:117-128)."""
        results = defaultdict(list)
        cur_video = None
        n = len(self.dataset) if max_frames is None else min(
            max_frames, len(self.dataset))
        frames_out = []
        for i in range(n):
            img, _, info, _ = self.dataset.pull_item(i)
            h, w, frame_id, video_id, file_name = info
            video = file_name.split("/")[0]
            name = os.path.basename(file_name)
            if video != cur_video:
                cur_video = video
                driver.reset()
            bboxes, labels, ids, masks = driver.update(img)
            out_ids, out_labels, out_scores, tlwhs, rles = merge_mots_masks(
                ids, labels, bboxes[:, 4] if len(bboxes) else np.zeros((0,)),
                bboxes, masks, mask_thres, driver.last_scale, (h, w),
                driver.input_size)
            results[video].append((frame_id, out_ids, tlwhs, out_scores,
                                   rles))
            frames_out.append({
                "name": name, "videoName": video,
                "frameIndex": int(frame_id),
                "labels": [{
                    "id": int(tid),
                    "category": BDD_CLASSES[int(c)],
                    "score": float(s),
                    "rle": r,
                } for tid, c, s, r in zip(out_ids, out_labels, out_scores,
                                          rles)
                    if 0 <= int(c) < len(BDD_CLASSES)],
            })
            if out_dir:
                dense = (np.stack([rle_codec.decode(r) for r in rles])
                         if rles else np.zeros((0, h, w), np.uint8))
                write_bdd_bitmask(
                    os.path.join(out_dir, "seg_track", video,
                                 os.path.splitext(name)[0] + ".png"),
                    dense, out_ids, out_labels, out_scores)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, "seg_track.json"), "w") as f:
                json.dump(frames_out, f, default=float)
        return dict(results), frames_out

    def evaluate_mot(self, driver, out_dir=None, max_frames=None):
        """Streams frames through a MOTOmniDriver; returns
        ({video: [(frame_id, ids, tlwhs, scores)]}, scalabel track frames).
        The scalabel frames feed score_scalabel for mMOTA/mIDF1."""
        results = defaultdict(list)
        cur_video = None
        n = len(self.dataset) if max_frames is None else min(
            max_frames, len(self.dataset))
        frames_out = []
        for i in range(n):
            img, _, info, _ = self.dataset.pull_item(i)
            h, w, frame_id, video_id, file_name = info
            video = file_name.split("/")[0]
            if video != cur_video:
                cur_video = video
                driver.reset()
            bboxes, labels, ids = driver.update(img)
            tlwhs = [(b[0], b[1], b[2] - b[0], b[3] - b[1]) for b in bboxes]
            results[video].append((frame_id, ids.tolist(), tlwhs,
                                   bboxes[:, 4].tolist() if len(bboxes) else []))
            frames_out.append({
                "name": os.path.basename(file_name), "videoName": video,
                "frameIndex": int(frame_id),
                "labels": [{
                    "id": int(tid),
                    "category": BDD_CLASSES[int(c)],
                    "box2d": {"x1": float(b[0]), "y1": float(b[1]),
                              "x2": float(b[2]), "y2": float(b[3])},
                } for b, c, tid in zip(bboxes, labels, ids)
                    if 0 <= int(c) < len(BDD_CLASSES)],
            })
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, "track.json"), "w") as f:
                json.dump(frames_out, f)
        return dict(results), frames_out
