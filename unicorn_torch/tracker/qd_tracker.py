"""Quasi-Dense embedding tracker (host-side numpy): the port's copy of
unicorn_tpu/tracker/qd_tracker.py.

Reference: unicorn/tracker/quasi_dense_embed_tracker.py:9-230. Bi-softmax
embedding matching against a memo bank of tracklets + backdrops, per-class
gating, momentum embedding updates. Used for BDD100K MOT/MOTS and the
MOT17-omni path (drivers/mot.py MOTOmniDriver).
"""
from __future__ import annotations

import numpy as np

from ..utils.boxes import pairwise_iou_np


def _softmax(x, axis):
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


class QuasiDenseEmbedTracker:
    def __init__(self,
                 init_score_thr=0.8,
                 obj_score_thr=0.5,
                 match_score_thr=0.5,
                 memo_tracklet_frames=30,
                 memo_backdrop_frames=1,
                 memo_momentum=0.8,
                 nms_conf_thr=0.5,
                 nms_backdrop_iou_thr=0.3,
                 nms_class_iou_thr=0.7,
                 with_cats=True,
                 match_metric="bisoftmax"):
        assert 0 <= memo_momentum <= 1.0
        assert match_metric in ("bisoftmax", "softmax", "cosine")
        self.init_score_thr = init_score_thr
        self.obj_score_thr = obj_score_thr
        self.match_score_thr = match_score_thr
        self.memo_tracklet_frames = memo_tracklet_frames
        self.memo_backdrop_frames = memo_backdrop_frames
        self.memo_momentum = memo_momentum
        self.nms_conf_thr = nms_conf_thr
        self.nms_backdrop_iou_thr = nms_backdrop_iou_thr
        self.nms_class_iou_thr = nms_class_iou_thr
        self.with_cats = with_cats
        self.match_metric = match_metric

        self.num_tracklets = 0
        self.tracklets: dict[int, dict] = {}
        self.backdrops: list[dict] = []

    @property
    def empty(self):
        return not self.tracklets

    def reset(self):
        self.num_tracklets = 0
        self.tracklets = {}
        self.backdrops = []

    def update_memo(self, ids, bboxes, embeds, labels, frame_id):
        keep = ids > -1
        for tid, bbox, embed, label in zip(ids[keep], bboxes[keep],
                                           embeds[keep], labels[keep]):
            tid = int(tid)
            if tid in self.tracklets:
                t = self.tracklets[tid]
                velocity = (bbox - t["bbox"]) / (frame_id - t["last_frame"])
                t["bbox"] = bbox
                t["embed"] = (1 - self.memo_momentum) * t["embed"] \
                    + self.memo_momentum * embed
                t["last_frame"] = frame_id
                t["label"] = label
                t["velocity"] = (t["velocity"] * t["acc_frame"] + velocity) \
                    / (t["acc_frame"] + 1)
                t["acc_frame"] += 1
            else:
                self.tracklets[tid] = dict(
                    bbox=bbox, embed=embed, label=label, last_frame=frame_id,
                    velocity=np.zeros_like(bbox), acc_frame=0,
                )

        # backdrops: unmatched low-confidence dets, NMS'ed vs all dets
        backdrop_inds = np.flatnonzero(ids == -1)
        if len(bboxes):
            ious = pairwise_iou_np(bboxes[backdrop_inds, :4], bboxes[:, :4])
            sel = []
            for i, ind in enumerate(backdrop_inds):
                if not (ious[i, :ind] > self.nms_backdrop_iou_thr).any():
                    sel.append(ind)
            backdrop_inds = np.asarray(sel, int)
        self.backdrops.insert(0, dict(
            bboxes=bboxes[backdrop_inds],
            embeds=embeds[backdrop_inds],
            labels=labels[backdrop_inds],
        ))

        for k in [k for k, v in self.tracklets.items()
                  if frame_id - v["last_frame"] >= self.memo_tracklet_frames]:
            self.tracklets.pop(k)
        if len(self.backdrops) > self.memo_backdrop_frames:
            self.backdrops.pop()

    @property
    def memo(self):
        bxs, embs, ids, lbls, vs = [], [], [], [], []
        for k, v in self.tracklets.items():
            bxs.append(v["bbox"][None])
            embs.append(v["embed"][None])
            ids.append(k)
            lbls.append(v["label"])
            vs.append(v["velocity"][None])
        ids = list(ids)
        for bd in self.backdrops:
            n = len(bd["embeds"])
            bxs.append(bd["bboxes"])
            embs.append(bd["embeds"])
            ids.extend([-1] * n)
            lbls.extend(list(bd["labels"]))
            vs.append(np.zeros_like(bd["bboxes"]))
        return (np.concatenate(bxs, 0), np.asarray(lbls),
                np.concatenate(embs, 0), np.asarray(ids, int),
                np.concatenate(vs, 0))

    def match(self, bboxes, labels, track_feats, frame_id,
              return_index: bool = False):
        """bboxes: (N, 5) [x1,y1,x2,y2,score]; labels: (N,); track_feats (N,C).
        Returns (bboxes, labels, ids) sorted by score; id -1 = unmatched,
        -2 = suppressed-dup.

        return_index additionally returns the ORIGINAL-INPUT index of each
        output row (int array, len = #outputs), so callers can realign
        per-detection payloads — masks in the MOTS path — with the
        score-sorted, duplicate-suppressed output: ``masks[index]``.
        The reference's `return_index` returns the `valids` boolean over its
        internally score-sorted rows
        (unicorn/tracker/quasi_dense_embed_tracker.py:209-211), which is only
        sound because its postprocess emits score-descending detections; here
        the sort permutation is composed in, so any input order realigns
        correctly (used by drivers/mot.py MOTOmniDriver(with_mask=True),
        the counterpart of the reference's mot_evaluator.py:844-856)."""
        bboxes = np.asarray(bboxes, np.float32).reshape(-1, 5)
        labels = np.asarray(labels).reshape(-1)
        embeds = np.asarray(track_feats, np.float32).reshape(len(bboxes), -1)

        order = np.argsort(-bboxes[:, -1], kind="stable")
        bboxes, labels, embeds = bboxes[order], labels[order], embeds[order]

        # duplicate removal for backdrops / cross-class overlaps
        valids = np.ones(len(bboxes), bool)
        if len(bboxes):
            ious = pairwise_iou_np(bboxes[:, :4], bboxes[:, :4])
            for i in range(1, len(bboxes)):
                thr = (self.nms_backdrop_iou_thr
                       if bboxes[i, -1] < self.obj_score_thr
                       else self.nms_class_iou_thr)
                if (ious[i, :i] > thr).any():
                    valids[i] = False
        bboxes, labels, embeds = bboxes[valids], labels[valids], embeds[valids]
        index = order[valids]  # output row -> caller's original input row

        ids = np.full(len(bboxes), -1, dtype=np.int64)
        if len(bboxes) > 0 and not self.empty:
            memo_bboxes, memo_labels, memo_embeds, memo_ids, _ = self.memo
            if self.match_metric == "bisoftmax":
                feats = embeds @ memo_embeds.T
                scores = (_softmax(feats, 1) + _softmax(feats, 0)) / 2
            elif self.match_metric == "softmax":
                scores = _softmax(embeds @ memo_embeds.T, 1)
            else:  # cosine
                en = embeds / (np.linalg.norm(embeds, axis=1, keepdims=True) + 1e-12)
                mn = memo_embeds / (np.linalg.norm(memo_embeds, axis=1,
                                                   keepdims=True) + 1e-12)
                scores = en @ mn.T
            if self.with_cats:
                scores = scores * (labels[:, None] == memo_labels[None, :])

            for i in range(len(bboxes)):
                memo_ind = int(np.argmax(scores[i]))
                conf = scores[i, memo_ind]
                tid = memo_ids[memo_ind]
                if conf > self.match_score_thr:
                    if tid > -1:
                        if bboxes[i, -1] > self.obj_score_thr:
                            ids[i] = tid
                            scores[:i, memo_ind] = 0
                            scores[i + 1:, memo_ind] = 0
                        elif conf > self.nms_conf_thr:
                            ids[i] = -2
        new_inds = (ids == -1) & (bboxes[:, 4] > self.init_score_thr)
        num_news = int(new_inds.sum())
        ids[new_inds] = np.arange(self.num_tracklets,
                                  self.num_tracklets + num_news)
        self.num_tracklets += num_news

        self.update_memo(ids, bboxes, embeds, labels, frame_id)
        if return_index:
            return bboxes, labels, ids, index
        return bboxes, labels, ids
