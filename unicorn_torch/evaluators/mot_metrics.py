"""CLEAR-MOT, IDF1 and HOTA in numpy (port of
unicorn_tpu/evaluators/mot_metrics.py; the environment has no motmetrics).

The role of the reference's motmetrics accumulators
(unicorn/evaluators/evaluation.py:8-200). Per frame, consistent greedy
matching: a gt <-> hyp correspondence persists while its IoU stays >= 0.5,
new ones come from the Hungarian solve on IoU. MOTA, MOTP, IDF1, ID
switches, FP, FN, MT / ML fractions; HOTA as TrackEval computes it.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np
from scipy.optimize import linear_sum_assignment

from ..utils.boxes import pairwise_iou_np


class MOTAccumulator:
    """Accumulates one video's frames. Boxes are xyxy."""

    def __init__(self, iou_thr: float = 0.5):
        self.iou_thr = iou_thr
        self.last_match: dict = {}     # gt_id -> hyp_id from previous step
        self.num_gt = 0
        self.num_fp = 0
        self.num_fn = 0
        self.num_idsw = 0
        self.num_matches = 0
        self.sum_iou = 0.0
        self.gt_frames = defaultdict(int)      # gt_id -> #frames present
        self.gt_tracked = defaultdict(int)     # gt_id -> #frames matched
        # ID measures: co-occurrence counts for IDF1 (global bipartite)
        self.id_counts = defaultdict(int)      # (gt_id, hyp_id) -> matches
        self.gt_total = defaultdict(int)
        self.hyp_total = defaultdict(int)

    def update(self, gt_ids, gt_boxes, hyp_ids, hyp_boxes, iou=None,
               hyp_ignore=None):
        """iou: optional precomputed (G, H) similarity matrix replacing the
        box IoU — the mask-IoU MOTS path (mots_metrics.py) passes RLE-domain
        IoU here, mirroring the reference's mask_iou_matrix feeding the same
        motmetrics accumulator (qdtrack core/evaluation/mots.py:14-20,87-91).
        When given, gt_boxes/hyp_boxes may be None.

        hyp_ignore: optional (H,) bool — hypotheses mostly inside an ignore
        region. A flagged hypothesis that THIS accumulator's own matching
        (persistence + Hungarian) leaves unmatched is absorbed: it counts
        neither as an FP nor in the IDF1 denominator (official mots-tools
        order — match everything first, then absorb the unmatched)."""
        gt_ids = list(gt_ids)
        hyp_ids = list(hyp_ids)
        G, H = len(gt_ids), len(hyp_ids)
        self.num_gt += G
        for g in gt_ids:
            self.gt_frames[g] += 1
            self.gt_total[g] += 1

        if iou is None:
            iou = pairwise_iou_np(
                np.asarray(gt_boxes, np.float32).reshape(-1, 4),
                np.asarray(hyp_boxes, np.float32).reshape(-1, 4),
            ) if G and H else np.zeros((G, H), np.float32)
        else:
            iou = np.asarray(iou, np.float32).reshape(G, H)

        matched_g, matched_h = set(), set()
        matches = {}
        # 1) keep previous correspondences if still valid. Two gt ids can
        # point at the SAME hyp id here (the absent-gt carry-forward below
        # preserves stale pairs), so a hyp already claimed this pass is
        # skipped — motmetrics masks matched entries the same way; without
        # this, one hyp double-counts as two matches and FP goes negative
        for gi, g in enumerate(gt_ids):
            h_prev = self.last_match.get(g)
            if h_prev is not None and h_prev in hyp_ids:
                hi = hyp_ids.index(h_prev)
                if hi not in matched_h and iou[gi, hi] >= self.iou_thr:
                    matches[gi] = hi
                    matched_g.add(gi)
                    matched_h.add(hi)
        # 2) Hungarian on the rest (maximize IoU)
        rem_g = [gi for gi in range(G) if gi not in matched_g]
        rem_h = [hi for hi in range(H) if hi not in matched_h]
        if rem_g and rem_h:
            sub = iou[np.ix_(rem_g, rem_h)]
            cost = 1.0 - sub
            rows, cols = linear_sum_assignment(cost)
            for r, c in zip(rows, cols):
                if sub[r, c] >= self.iou_thr:
                    matches[rem_g[r]] = rem_h[c]
                    matched_g.add(rem_g[r])
                    matched_h.add(rem_h[c])

        new_last = {}
        for gi, hi in matches.items():
            g, h = gt_ids[gi], hyp_ids[hi]
            prev = self.last_match.get(g)
            if prev is not None and prev != h:
                self.num_idsw += 1
            new_last[g] = h
            self.num_matches += 1
            self.sum_iou += float(iou[gi, hi])
            self.gt_tracked[g] += 1
            self.id_counts[(g, h)] += 1
        # carry forward matches for gts absent this frame
        for g, h in self.last_match.items():
            if g not in new_last:
                new_last[g] = h
        self.last_match = new_last
        # ignore absorption AFTER matching: unmatched flagged hyps vanish
        absorbed = set()
        if hyp_ignore is not None:
            absorbed = {hi for hi in range(H)
                        if hi not in matched_h and hyp_ignore[hi]}
        for hi, h in enumerate(hyp_ids):
            if hi not in absorbed:
                self.hyp_total[h] += 1
        self.num_fn += G - len(matches)
        self.num_fp += H - len(matches) - len(absorbed)

    def metrics(self) -> dict:
        mota = 1.0 - (self.num_fn + self.num_fp + self.num_idsw) / max(self.num_gt, 1)
        motp = self.sum_iou / max(self.num_matches, 1)
        # IDF1 via optimal global gt<->hyp bipartite matching on id_counts
        gt_ids = sorted(self.gt_total.keys())
        hyp_ids = sorted(self.hyp_total.keys())
        idtp = 0
        if gt_ids and hyp_ids:
            g_index = {g: i for i, g in enumerate(gt_ids)}
            h_index = {h: i for i, h in enumerate(hyp_ids)}
            cnt = np.zeros((len(gt_ids), len(hyp_ids)))
            for (g, h), c in self.id_counts.items():
                cnt[g_index[g], h_index[h]] = c
            rows, cols = linear_sum_assignment(-cnt)
            idtp = int(cnt[rows, cols].sum())
        total_gt = sum(self.gt_total.values())
        total_hyp = sum(self.hyp_total.values())
        idf1 = 2.0 * idtp / max(total_gt + total_hyp, 1)
        # mostly tracked / lost
        mt = sum(1 for g, n in self.gt_frames.items()
                 if self.gt_tracked[g] / n >= 0.8)
        ml = sum(1 for g, n in self.gt_frames.items()
                 if self.gt_tracked[g] / n <= 0.2)
        n_traj = max(len(self.gt_frames), 1)
        return {
            "MOTA": mota, "MOTP": motp, "IDF1": idf1,
            "IDsw": self.num_idsw, "FP": self.num_fp, "FN": self.num_fn,
            "MT": mt / n_traj, "ML": ml / n_traj, "num_gt": self.num_gt,
        }


def aggregate_metrics(accumulators: list[MOTAccumulator]) -> dict:
    """Combine per-video accumulators into overall CLEAR-MOT numbers."""
    tot_gt = sum(a.num_gt for a in accumulators)
    tot_fn = sum(a.num_fn for a in accumulators)
    tot_fp = sum(a.num_fp for a in accumulators)
    tot_idsw = sum(a.num_idsw for a in accumulators)
    tot_iou = sum(a.sum_iou for a in accumulators)
    tot_m = sum(a.num_matches for a in accumulators)
    idf1s = [a.metrics() for a in accumulators]
    total_gt_f = sum(sum(a.gt_total.values()) for a in accumulators)
    total_hyp_f = sum(sum(a.hyp_total.values()) for a in accumulators)
    # recompute global IDF1 as count-weighted combination of per-video idtp
    idtp = sum(m["IDF1"] * (sum(a.gt_total.values()) + sum(a.hyp_total.values())) / 2
               for m, a in zip(idf1s, accumulators))
    return {
        "MOTA": 1.0 - (tot_fn + tot_fp + tot_idsw) / max(tot_gt, 1),
        "MOTP": tot_iou / max(tot_m, 1),
        "IDF1": 2.0 * idtp / max(total_gt_f + total_hyp_f, 1),
        "IDsw": tot_idsw, "FP": tot_fp, "FN": tot_fn, "num_gt": tot_gt,
    }


def hota(gt_frames: dict, pred_frames: dict,
         alphas=None) -> dict:
    """HOTA (Luiten et al., IJCV 2021) — Higher Order Tracking Accuracy.

    Beyond the reference's CLEAR-MOT/IDF1 surface: HOTA is the primary
    metric of modern MOT benchmarks and decomposes into detection (DetA)
    and association (AssA) accuracy, HOTA_a = sqrt(DetA_a * AssA_a)
    averaged over IoU thresholds a.

    Follows TrackEval's algorithm structure (hota.py): a first pass
    accumulates potential-match counts per (gt, pred) id pair; the frame
    matching is then ONE Hungarian solve per frame on
    global_alignment_score * similarity (so consistently-associated pairs
    win IoU near-ties, and the per-alpha loop only thresholds the matched
    pairs' similarities).

    gt_frames / pred_frames: {frame: (ids list, boxes (N, 4) xyxy)}.
    Frames missing from either dict count as empty. Returns
    {"HOTA", "DetA", "AssA"} (each averaged over the 19-point alpha grid).
    """
    if alphas is None:
        alphas = np.arange(0.05, 1.0, 0.05)
    alphas = np.asarray(alphas)
    frames = sorted(set(gt_frames) | set(pred_frames))
    # per-frame IoU matrices + id lists, computed once
    per_frame = []
    for f in frames:
        g_ids, g_boxes = gt_frames.get(f, ([], []))
        p_ids, p_boxes = pred_frames.get(f, ([], []))
        iou = pairwise_iou_np(
            np.asarray(g_boxes, np.float32).reshape(-1, 4),
            np.asarray(p_boxes, np.float32).reshape(-1, 4))
        per_frame.append((list(g_ids), list(p_ids), iou))

    # pass 1: global alignment accumulation (TrackEval potential_matches)
    gt_count = defaultdict(int)
    pr_count = defaultdict(int)
    potential = defaultdict(float)
    for g_ids, p_ids, iou in per_frame:
        for g in g_ids:
            gt_count[g] += 1
        for p in p_ids:
            pr_count[p] += 1
        if len(g_ids) and len(p_ids):
            denom = iou.sum(0)[None, :] + iou.sum(1)[:, None] - iou
            with np.errstate(divide="ignore", invalid="ignore"):
                sim_iou = np.where(iou > 1e-9, iou / np.maximum(denom, 1e-9),
                                   0.0)
            for r in range(len(g_ids)):
                for c in range(len(p_ids)):
                    if sim_iou[r, c] > 0:
                        potential[(g_ids[r], p_ids[c])] += sim_iou[r, c]

    def align(g, p):
        return potential[(g, p)] / max(
            gt_count[g] + pr_count[p] - potential[(g, p)], 1e-9)

    # pass 2: one Hungarian per frame on alignment * similarity; per-alpha
    # thresholding of the matched pairs
    A = len(alphas)
    tp = np.zeros(A)
    fn = np.zeros(A)
    fp = np.zeros(A)
    pair_tpa = [defaultdict(int) for _ in range(A)]
    for g_ids, p_ids, iou in per_frame:
        G, P = len(g_ids), len(p_ids)
        n_match = np.zeros(A, int)
        if G and P:
            score = np.array([[align(g_ids[r], p_ids[c]) for c in range(P)]
                              for r in range(G)]) * iou
            rows, cols = linear_sum_assignment(-score)
            for r, c in zip(rows, cols):
                ok = iou[r, c] >= alphas - 1e-9      # (A,) bool
                n_match += ok
                key = (g_ids[r], p_ids[c])
                for a in np.flatnonzero(ok):
                    pair_tpa[a][key] += 1
        tp += n_match
        fn += G - n_match
        fp += P - n_match

    detas, assas, hotas = [], [], []
    for a in range(A):
        deta = tp[a] / max(tp[a] + fn[a] + fp[a], 1)
        if tp[a] > 0:
            # AssA = TP-weighted mean of per-pair association scores
            num = sum(c * (c / max(gt_count[g] + pr_count[p] - c, 1))
                      for (g, p), c in pair_tpa[a].items())
            assa = num / tp[a]
        else:
            assa = 0.0
        detas.append(float(deta))
        assas.append(float(assa))
        hotas.append(float(np.sqrt(deta * assa)))
    return {"HOTA": float(np.mean(hotas)), "DetA": float(np.mean(detas)),
            "AssA": float(np.mean(assas))}
