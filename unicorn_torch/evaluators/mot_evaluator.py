"""MOT evaluator (port of unicorn_tpu/evaluators/mot_evaluator.py):
per-frame inference on the device, online association on the host.

Reference: unicorn/evaluators/mot_evaluator.py — `evaluate` (the ByteTrack
path, :100-245, with the MOT17 per-video threshold / buffer overrides
:160-181 and the per-video txt files :185-235), `evaluate_omni` (the
QDTrack embedding path, :924-1107: the interaction of each frame's
stride-16 feature with the previous frame's, embeddings sampled at the box
centres) and the MOTS path (:702-922). SORT (`evaluate(tracker="sort")`),
DeepSORT and MOTDT (`evaluate_omni(tracker=...)`) are the reference's
legacy branches (:247-615), on the model's own embeddings
(tracker/legacy.py).

The callables are torch callables that hold their weights (no params
argument) and take frames (1, 3, H, W) float32 on the evaluator's device,
letterboxed: `mot_step_fn(MOTDriver)` and `omni_fns(MOTOmniDriver)` build
them from the port's drivers. Results come back as numpy.
"""
from __future__ import annotations

import os
from collections import defaultdict

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from ..data.preproc import letterbox, resize_nearest
from ..device import images_to_device, resolve_device, to_host
from ..tracker.byte_tracker import ByteTracker
from ..tracker.legacy import DeepSort, OnlineTracker, Sort
from ..tracker.qd_tracker import QuasiDenseEmbedTracker
from . import rle as rle_codec
from .mot_metrics import MOTAccumulator, aggregate_metrics, hota
from .mots_metrics import score_mots as _score_mots
from .mots_metrics import write_mots_txt

# per-video tuning used on MOT17/MOT20, matching the reference's EFFECTIVE
# behavior (mot_evaluator.py:160-181): buffers 14 for 05+06 and 25 for
# 13+14; thresh overrides only for MOT20-06/08 — the reference's MOT17
# thresh branch (01/06->0.65, 12->0.7, 14->0.67) is dead code there, reset
# to ori_thresh by the MOT20 block's trailing else before any use
MOT17_VIDEO_THRESH = {
    "MOT20-06": 0.3, "MOT20-08": 0.3,
}
MOT17_VIDEO_BUFFER = {
    "MOT17-05-FRCNN": 14, "MOT17-06-FRCNN": 14,
    "MOT17-13-FRCNN": 25, "MOT17-14-FRCNN": 25,
}


def write_mot_results(path, results):
    """results: list of (frame_id, track_ids, tlwhs, scores) -> MOT txt."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for frame_id, tids, tlwhs, scores in results:
            for tid, tlwh, score in zip(tids, tlwhs, scores):
                x, y, w, h = tlwh
                f.write(f"{frame_id},{tid},{x:.1f},{y:.1f},{w:.1f},{h:.1f},"
                        f"{score:.2f},-1,-1,-1\n")


def merge_mots_masks(ids, labels, scores, boxes, masks, mask_thres, r,
                     orig_hw, img_size):
    """Shared MOTS mask tail (reference mot_evaluator.py:853-889): sort kept
    rows to ascending track id, threshold, merge overlap-free in that order
    (earlier = lower id wins each pixel), then resize each mask's letterbox
    content region to the original image resolution (cv2's INTER_NEAREST,
    data/preproc.py resize_nearest) and RLE-encode.

    ids/labels/scores: (N,); boxes: (N, >=4) xyxy in IMAGE coords; masks:
    (N, Hm, Wm) sigmoid scores on the mask grid covering the letterbox
    canvas. Returns (ids, labels, scores, tlwhs, rles) python lists in
    ascending-id order; rles are compressed full-resolution RLEs.
    """
    h, w = orig_hw
    order = np.argsort(np.asarray(ids), kind="stable")
    out_ids, out_labels, out_scores, tlwhs, rles = [], [], [], [], []
    occupied = None
    for k in order:
        m = masks[k] > mask_thres
        if occupied is None:
            occupied = np.zeros_like(m)
        m = m & ~occupied
        occupied |= m
        Hm, Wm = m.shape
        crop_h = int(round(h * r * Hm / img_size[0]))
        crop_w = int(round(w * r * Wm / img_size[1]))
        m_full = resize_nearest(
            m[:max(crop_h, 1), :max(crop_w, 1)].astype(np.uint8),
            (int(w), int(h)))
        rles.append(rle_codec.encode(m_full))
        out_ids.append(int(ids[k]))
        out_labels.append(int(labels[k]))
        out_scores.append(float(scores[k]))
        b = boxes[k]
        tlwhs.append((float(b[0]), float(b[1]),
                      float(b[2] - b[0]), float(b[3] - b[1])))
    return out_ids, out_labels, out_scores, tlwhs, rles


def mot_step_fn(driver):
    """MOTEvaluator.evaluate's step_fn from a MOTDriver: forward, decode and
    NMS on the card -> (dets (max_out, 7), valid (max_out,))."""
    def step(frame):
        dets, valid = driver.postprocess(driver.forward(frame))
        return dets[0], valid[0]
    return step


def omni_fns(driver):
    """(whole_fn, embed_fn) of evaluate_omni / evaluate_omni_mots from a
    MOTOmniDriver's stages. whole_fn(frame) -> (dets (max_out, 7), valid,
    the stride-16 feature), and with with_mask also the masks (max_out, Hm,
    Wm) float16; embed_fn(feat_prev, feat_cur, centers (M, 2)) -> (M,
    embed_dim): the interaction, the embedding upsample and the samples at
    the centres."""
    def whole(frame):
        fpn_outs, feat = driver.backbone(frame)
        flat, dets, valid, idx = driver.detect(driver.head(fpn_outs))
        if driver.with_mask:
            return (dets[0], valid[0], feat,
                    driver.mask_decode(fpn_outs, flat, idx))
        return dets[0], valid[0], feat

    def embed(feat_prev, feat_cur, centers):
        c = torch.as_tensor(centers, dtype=torch.float32,
                            device=feat_cur.device)
        # boxes whose centres are `centers`: (c + c) / 2 is c exactly
        return driver.embed(feat_prev, feat_cur, torch.cat([c, c], -1)[None])
    return whole, embed


class MOTEvaluator:
    def __init__(self, exp=None, dataset=None, track_thresh=0.6,
                 track_buffer=30, match_thresh=0.9, min_box_area=100,
                 device="cuda"):
        self.device = resolve_device(device)
        self.exp = exp
        self.dataset = dataset
        self.track_thresh = track_thresh
        self.track_buffer = track_buffer
        self.match_thresh = match_thresh
        self.min_box_area = min_box_area

    def _frame(self, img):
        """An (H, W, 3) letterboxed float32 frame -> (1, 3, H, W) on the
        device."""
        return images_to_device(img[None], self.device)

    # ------------------------------------------------------------------
    # ByteTrack path (MOT17): detection-only per frame
    # ------------------------------------------------------------------
    def evaluate(self, step_fn, dataset=None, result_dir=None,
                 max_frames=None, tracker="byte"):
        """step_fn(frame (1, 3, H, W)) -> (dets (max_out, 7), valid),
        postprocessed on the device (boxes in letterbox coords).

        tracker: "byte" (default) or "sort" (the reference's evaluate_sort
        branch, mot_evaluator.py:247-368 — SORT emits no per-box score, so
        scores are written as 1.0).

        Returns {video_name: [(frame_id, tids, tlwhs, scores)]} and writes
        MOT txt files if result_dir given.
        """
        dataset = dataset or self.dataset
        img_size = dataset.img_size
        all_results = defaultdict(list)
        trk = None
        cur_video = None
        n = len(dataset) if max_frames is None else min(max_frames, len(dataset))
        for i in range(n):
            img, _, info, _ = dataset[i]
            h, w, frame_id, video_id, file_name = info
            video_name = file_name.split("/")[0]
            if video_name != cur_video:
                cur_video = video_name
                thresh = MOT17_VIDEO_THRESH.get(video_name, self.track_thresh)
                buf = MOT17_VIDEO_BUFFER.get(video_name, self.track_buffer)
                trk = Sort(thresh, max_age=buf) if tracker == "sort" \
                    else ByteTracker(thresh, buf, self.match_thresh)
            with torch.inference_mode():
                dets, valid = step_fn(self._frame(img))
                dets = to_host(dets)[to_host(valid).astype(bool)]
            scale = min(img_size[0] / float(h), img_size[1] / float(w))
            boxes = dets[:, :4] / scale if len(dets) else np.zeros((0, 4))
            scrs = dets[:, 4] * dets[:, 5] if len(dets) else np.zeros((0,))
            if tracker == "sort":
                rows = trk.update(boxes, scrs)
                online = [(int(r[4]), 1.0,
                           np.array([r[0], r[1], r[2] - r[0], r[3] - r[1]]))
                          for r in rows]
            else:
                views = trk.update(boxes, scrs, dets[:, 6]) if len(dets) \
                    else trk.update(boxes, scrs)
                online = [(t.track_id, t.score, t.tlwh) for t in views]
            tlwhs, tids, scores = [], [], []
            for tid, score, tlwh in online:
                if tlwh[2] * tlwh[3] > self.min_box_area and \
                        tlwh[2] / max(tlwh[3], 1e-6) <= 1.6:
                    tlwhs.append(tuple(tlwh))
                    tids.append(tid)
                    scores.append(score)
            all_results[video_name].append((frame_id, tids, tlwhs, scores))
        if result_dir:
            for vname, res in all_results.items():
                write_mot_results(os.path.join(result_dir, f"{vname}.txt"), res)
        return dict(all_results)

    # ------------------------------------------------------------------
    # QDTrack embedding path (BDD / MOT17-omni)
    # ------------------------------------------------------------------
    def evaluate_omni(self, whole_fn, embed_fn, dataset=None,
                      qd_params=None, max_frames=None, tracker="qd"):
        """Embedding association (mot_evaluator.py:924-1107).

        whole_fn(frame) -> (dets (max_out, 7), valid, feat_s16)
        embed_fn(feat_prev, feat_cur, centers (M, 2)) -> (M, C)
          [interaction + upsample + samples at the box centres]

        tracker: "qd" (default, QDTrack), "deepsort", or "motdt" — the
        latter two are the reference's evaluate_deepsort / evaluate_motdt
        branches (mot_evaluator.py:369-615) with the model's own embedding
        head as the appearance network (tracker/legacy.py).
        """
        dataset = dataset or self.dataset
        img_size = dataset.img_size
        qd_params = qd_params or {}
        all_results = defaultdict(list)
        trk = None
        cur_video = None
        feat_prev = None
        n = len(dataset) if max_frames is None else min(max_frames, len(dataset))
        for i in range(n):
            img, _, info, _ = dataset[i]
            h, w, frame_id, video_id, file_name = info
            video_name = file_name.split("/")[0]
            if video_name != cur_video:
                cur_video = video_name
                if tracker == "deepsort":
                    trk = DeepSort(min_confidence=self.track_thresh)
                elif tracker == "motdt":
                    trk = OnlineTracker(min_cls_score=self.track_thresh,
                                        max_time_lost=self.track_buffer)
                else:
                    trk = QuasiDenseEmbedTracker(**qd_params)
                feat_prev = None
            with torch.inference_mode():
                dets, valid, feat_cur = whole_fn(self._frame(img))
                dets = to_host(dets)[to_host(valid).astype(bool)]
            if feat_prev is None:
                feat_prev = feat_cur
            scale = min(img_size[0] / float(h), img_size[1] / float(w))

            def embed_boxes(boxes_letterbox):
                centers = (boxes_letterbox[:, :2] + boxes_letterbox[:, 2:4]) / 2
                with torch.inference_mode():
                    return to_host(embed_fn(
                        feat_prev, feat_cur,
                        torch.from_numpy(np.ascontiguousarray(
                            centers, np.float32)).to(self.device)))

            if tracker in ("deepsort", "motdt"):
                boxes = dets[:, :4] / scale if len(dets) else np.zeros((0, 4))
                scrs = dets[:, 4] * dets[:, 5] if len(dets) \
                    else np.zeros((0,))
                if tracker == "deepsort":
                    feats = embed_boxes(dets[:, :4]) if len(dets) \
                        else np.zeros((0, 1))
                    views = trk.update(boxes, scrs, feats)
                else:
                    cb, cs, from_det = trk.propose(boxes, scrs)
                    feats = embed_boxes(cb * scale) if len(cb) \
                        else np.zeros((0, 1))
                    views = trk.update(cb, cs, from_det, feats)
                tlwhs, tids, scores = [], [], []
                for t in views:
                    if t.tlwh[2] * t.tlwh[3] > self.min_box_area and \
                            t.tlwh[2] / max(t.tlwh[3], 1e-6) <= 1.6:
                        tlwhs.append(tuple(t.tlwh))
                        tids.append(t.track_id)
                        scores.append(t.score)
                all_results[video_name].append(
                    (frame_id, tids, tlwhs, scores))
            elif len(dets):
                embeds = embed_boxes(dets[:, :4])
                bboxes5 = np.concatenate(
                    [dets[:, :4] / scale, (dets[:, 4] * dets[:, 5])[:, None]], 1
                )
                bboxes, labels, ids = trk.match(
                    bboxes5, dets[:, 6].astype(int), embeds, frame_id
                )
                keep = ids > -1
                tlwhs = [(b[0], b[1], b[2] - b[0], b[3] - b[1])
                         for b in bboxes[keep]]
                all_results[video_name].append(
                    (frame_id, ids[keep].tolist(), tlwhs,
                     bboxes[keep][:, 4].tolist())
                )
            else:
                all_results[video_name].append((frame_id, [], [], []))
            feat_prev = feat_cur
        return dict(all_results)

    # ------------------------------------------------------------------
    # QDTrack + CondInst masks (MOTS; mot_evaluator.py:702-922)
    # ------------------------------------------------------------------
    def evaluate_omni_mots(self, whole_mask_fn, embed_fn, dataset=None,
                           qd_params=None, mask_thres: float = 0.3,
                           result_dir=None, max_frames=None):
        """MOTS path: detection + embeddings + per-instance dynamic-conv
        masks. Masks are realigned to the tracker's score-sorted,
        duplicate-suppressed output via match(return_index=True) — the
        reference's ``masks = masks[indexs]`` (mot_evaluator.py:844-850) —
        then kept rows sort to ascending track id and merge overlap-free in
        that order (lower id wins a pixel, :853-869). Writes MOTS-Challenge
        txt (frame, 2000+id, class 2, h, w, RLE) when result_dir is given.

        whole_mask_fn(frame) -> (dets (K, 7), valid, feat_s16,
                                 masks (K, Hm, Wm) sigmoid scores)

        Returns {video: [(frame_id, ids, tlwhs, scores, rles)]} with rles the
        full-image-resolution compressed RLEs — feed MOTEvaluator.score_mots.
        """
        dataset = dataset or self.dataset
        img_size = dataset.img_size
        qd_params = qd_params or {}
        all_results = defaultdict(list)
        tracker = None
        cur_video = None
        feat_prev = None
        n = len(dataset) if max_frames is None else min(max_frames, len(dataset))
        txt_frames = defaultdict(list)
        for i in range(n):
            img, _, info, _ = dataset.pull_item(i) if hasattr(dataset, "pull_item") \
                else dataset[i]
            h, w, frame_id, video_id, file_name = info
            video_name = file_name.split("/")[0]
            if video_name != cur_video:
                cur_video = video_name
                tracker = QuasiDenseEmbedTracker(**qd_params)
                feat_prev = None
            padded, r = letterbox(img, img_size)
            with torch.inference_mode():
                dets, valid, feat_cur, masks = whole_mask_fn(
                    self._frame(padded))
                keep = to_host(valid).astype(bool)
                dets = to_host(dets)[keep]
                # only the valid rows' masks leave the device
                masks = (to_host(masks[torch.from_numpy(keep).to(
                    masks.device)]) if isinstance(masks, torch.Tensor)
                    else to_host(masks)[keep])
            if feat_prev is None:
                feat_prev = feat_cur
            if len(dets):
                centers = (dets[:, :2] + dets[:, 2:4]) / 2
                with torch.inference_mode():
                    embeds = to_host(embed_fn(
                        feat_prev, feat_cur,
                        torch.from_numpy(np.ascontiguousarray(
                            centers, np.float32)).to(self.device)))
                bboxes5 = np.concatenate(
                    [dets[:, :4] / r, (dets[:, 4] * dets[:, 5])[:, None]], 1)
                bboxes, labels, ids, index = tracker.match(
                    bboxes5, dets[:, 6].astype(int), embeds, frame_id,
                    return_index=True)
                masks = masks[index]  # realign with the tracker's output rows
                keep = ids > -1
                ids_k, boxes_k, labels_k, masks_k = (
                    ids[keep], bboxes[keep], labels[keep], masks[keep])
                scores_k = boxes_k[:, 4] if len(boxes_k) else np.zeros((0,))
                out_ids, out_labels, out_scores, tlwhs, rles = \
                    merge_mots_masks(ids_k, labels_k, scores_k, boxes_k,
                                     masks_k, mask_thres, r, (h, w), img_size)
                all_results[video_name].append(
                    (frame_id, out_ids, tlwhs, out_scores, rles))
                txt_frames[video_name].append(
                    (frame_id, [2000 + int(t) for t in out_ids],
                     [2] * len(out_ids), rles))
            else:
                all_results[video_name].append((frame_id, [], [], [], []))
            feat_prev = feat_cur
        if result_dir:
            os.makedirs(result_dir, exist_ok=True)
            for vname, frames in txt_frames.items():
                write_mots_txt(os.path.join(result_dir, f"{vname}.txt"),
                               frames)
        return dict(all_results)

    # ------------------------------------------------------------------
    @staticmethod
    def score_mots(results, gts, iou_thr: float = 0.5):
        """Mask-IoU CLEAR-MOT scoring (sMOTSA/MOTSA/MOTSP/IDF1) for
        evaluate_omni_mots results. gts: {video: [(frame_id, ids, rles)]}
        with full-image-resolution gt mask RLEs."""
        return _score_mots(
            {v: [(f[0], f[1], f[4]) for f in frames]
             for v, frames in results.items()},
            gts, iou_thr=iou_thr)

    # ------------------------------------------------------------------
    @staticmethod
    def score(results, gts):
        """CLEAR-MOT scoring: results/gts are {video: [(frame_id, ids,
        tlwhs(, ignore_tlwhs))]} with gt tlwhs in image coords.

        When a gt frame carries a 4th element of ignore-region tlwhs (MOT17
        distractor/reflection/static-person boxes), predictions Hungarian-
        matched to them at IoU >= 0.5 are removed before accumulation —
        the reference's evaluation.py:41-53 (each ignore box suppresses at
        most one prediction)."""
        accs = []
        # HOTA pools detections across sequences (TrackEval's combination),
        # so frames/ids are namespaced per video into one global pair
        gt_all, pr_all = {}, {}
        for video, frames in results.items():
            if video not in gts:
                continue
            gt_by_frame = {f[0]: f for f in gts[video]}
            acc = MOTAccumulator()
            for frame in frames:
                frame_id, tids, tlwhs = frame[0], frame[1], frame[2]
                g = gt_by_frame.get(frame_id, (frame_id, [], []))
                g_boxes = [(x, y, x + w, y + h) for x, y, w, h in g[2]]
                h_boxes = [(x, y, x + w, y + h) for x, y, w, h in tlwhs]
                ignore = g[3] if len(g) > 3 else ()
                if len(ignore) and len(h_boxes):
                    # plain rect IoU (motmetrics iou_matrix convention — no
                    # +1 inclusive pixels; the reference's ignore pass uses
                    # mm.distances.iou_matrix, evaluation.py:44)
                    i_boxes = np.asarray(
                        [(x, y, x + w, y + h) for x, y, w, h in ignore],
                        np.float32)
                    hb = np.asarray(h_boxes, np.float32)
                    tl = np.maximum(i_boxes[:, None, :2], hb[None, :, :2])
                    br = np.minimum(i_boxes[:, None, 2:], hb[None, :, 2:])
                    wh = np.clip(br - tl, 0, None)
                    inter = wh[..., 0] * wh[..., 1]
                    area_i = np.prod(i_boxes[:, 2:] - i_boxes[:, :2], axis=1)
                    area_h = np.prod(hb[:, 2:] - hb[:, :2], axis=1)
                    iou = inter / (area_i[:, None] + area_h[None, :]
                                   - inter + 1e-12)
                    # 1-iou where iou >= 0.5 else a large cost, matching
                    # mm.distances.iou_matrix(max_iou=0.5) + lap semantics
                    cost = np.where(iou >= 0.5, 1.0 - iou, 1e6)
                    ri, ci = linear_sum_assignment(cost)
                    drop = {int(c) for r, c in zip(ri, ci)
                            if cost[r, c] < 1e6}
                    h_boxes = [b for j, b in enumerate(h_boxes)
                               if j not in drop]
                    tids = [t for j, t in enumerate(tids) if j not in drop]
                acc.update(g[1], g_boxes, tids, h_boxes)
                key = (video, frame_id)
                gt_all[key] = ([(video, i) for i in g[1]], g_boxes)
                pr_all[key] = ([(video, i) for i in tids], h_boxes)
            accs.append(acc)
        if not accs:
            return {}
        out = aggregate_metrics(accs)
        out.update(hota(gt_all, pr_all))
        return out
