"""Mask-based MOTS metrics: MOTSA / sMOTSA / MOTSP / mMOTSA and the
MOTS-Challenge txt format (port of unicorn_tpu/evaluators/mots_metrics.py).

The reference's surfaces:
  * BDD's mask-IoU CLEAR-MOT (external/qdtrack/qdtrack/core/evaluation/
    mots.py:14-93, `mask_iou_matrix` + `eval_mots`): per-category
    accumulators fed mask IoU instead of box IoU, class-averaged into
    mMOTSA / mIDF1;
  * MOTS-Challenge scoring (sMOTSA, Voigtlaender et al. CVPR 2019): soft TP
    credit, sMOTSA = (sum of matched-pair mask IoU - FP - IDSW) / num_gt;
  * the MOTS-Challenge txt format (one line per mask: ``frame_id obj_id
    class_id img_h img_w rle``), with a parser so that written results
    round-trip into scoring.

Mask IoU runs in the RLE domain on the native codec (evaluators/rle.py).
"""
from __future__ import annotations

import os
from collections import defaultdict

import numpy as np
from scipy.optimize import linear_sum_assignment

from . import rle as rle_codec
from .mot_metrics import MOTAccumulator


def mask_iou_matrix(gt_rles, pred_rles) -> np.ndarray:
    """(G, P) mask IoU between RLE lists (compressed or uncompressed).

    Counterpart of the reference's mask_iou_matrix
    (qdtrack core/evaluation/mots.py:14-20), which returns 1-IoU distances
    for motmetrics; MOTAccumulator.update takes similarities, so plain IoU.
    """
    return rle_codec.iou_rle(list(gt_rles), list(pred_rles))


def _accumulate_video(frames_gt, frames_pred, iou_thr):
    """One video's frames -> a mask-IoU MOTAccumulator.

    frames_gt: [(frame_id, ids, rles)] or [(frame_id, ids, rles,
    ignore_rles)] — the optional 4th element carries the frame's ignore
    regions (MOTS-Challenge class-10 annotations): a prediction whose
    intersection-over-prediction with an ignore region exceeds 0.5 AND
    that the accumulator's own matching leaves unmatched is absorbed
    (neither FP nor IDF1 denominator) — the official mots-tools order:
    match everything first, then absorb the unmatched. The absorption
    decision is made INSIDE MOTAccumulator.update so it sees the same
    persistence-aware matching that scores. frames_pred:
    [(frame_id, ids, rles)] (extra trailing elements ignored).
    """
    acc = MOTAccumulator(iou_thr=iou_thr)
    gt_by_frame = {f[0]: f for f in frames_gt}
    pred_by_frame = {f[0]: f for f in frames_pred}
    # every frame with gt OR predictions scores (official mots-tools
    # semantics: a hypothesis on a gt-empty frame is an FP, not free)
    for frame_id in sorted(set(gt_by_frame) | set(pred_by_frame)):
        g = gt_by_frame.get(frame_id, (frame_id, [], []))
        g_ids, g_rles = list(g[1]), list(g[2])
        ignore_rles = list(g[3]) if len(g) > 3 else []
        p = pred_by_frame.get(frame_id, (frame_id, [], []))
        p_ids, p_rles = list(p[1]), list(p[2])
        iou = mask_iou_matrix(g_rles, p_rles) if g_ids and p_ids \
            else np.zeros((len(g_ids), len(p_ids)), np.float32)
        hyp_ignore = None
        if ignore_rles and p_ids:
            iof = rle_codec.iou_rle(p_rles, ignore_rles,
                                    iscrowd=[1] * len(ignore_rles))
            hyp_ignore = np.asarray(iof).max(axis=1) > 0.5
        acc.update(g_ids, None, p_ids, None, iou=iou, hyp_ignore=hyp_ignore)
    return acc


def _summarize(accs: list[MOTAccumulator]) -> dict:
    """Pooled MOTS numbers over accumulators (sMOTSA's soft-TP credit uses
    the accumulators' summed matched IoU)."""
    num_gt = sum(a.num_gt for a in accs)
    fp = sum(a.num_fp for a in accs)
    fn = sum(a.num_fn for a in accs)
    idsw = sum(a.num_idsw for a in accs)
    soft_tp = sum(a.sum_iou for a in accs)
    n_match = sum(a.num_matches for a in accs)
    # IDF1 over the pooled id co-occurrence (ids are namespaced per video by
    # the callers below, so summing idtp from per-acc optimal matchings is
    # exact)
    idtp = 0
    total_gt_f = total_hyp_f = 0
    for a in accs:
        g_ids = sorted(a.gt_total)
        h_ids = sorted(a.hyp_total)
        total_gt_f += sum(a.gt_total.values())
        total_hyp_f += sum(a.hyp_total.values())
        if g_ids and h_ids:
            cnt = np.zeros((len(g_ids), len(h_ids)))
            gi = {g: i for i, g in enumerate(g_ids)}
            hi = {h: i for i, h in enumerate(h_ids)}
            for (g, h), c in a.id_counts.items():
                cnt[gi[g], hi[h]] = c
            rows, cols = linear_sum_assignment(-cnt)
            idtp += int(cnt[rows, cols].sum())
    return {
        "sMOTSA": (soft_tp - fp - idsw) / max(num_gt, 1),
        "MOTSA": 1.0 - (fn + fp + idsw) / max(num_gt, 1),
        "MOTSP": soft_tp / max(n_match, 1),
        "IDF1": 2.0 * idtp / max(total_gt_f + total_hyp_f, 1),
        "IDsw": idsw, "FP": fp, "FN": fn, "num_gt": num_gt,
    }


def score_mots(results, gts, iou_thr: float = 0.5) -> dict:
    """Mask-IoU CLEAR-MOT over {video: [(frame_id, ids, rles)]} dicts.

    Returns overall sMOTSA/MOTSA/MOTSP/IDF1 plus a per-video table. RLEs
    may be compressed ({"size", "counts": str}) or uncompressed; gt and
    prediction masks must share each frame's image size. Gt frames may
    carry a 4th element of ignore-region RLEs (see _accumulate_video).
    """
    accs, per_video = [], {}
    for video, frames_gt in gts.items():
        acc = _accumulate_video(frames_gt, results.get(video, []), iou_thr)
        accs.append(acc)
        per_video[video] = _summarize([acc])
    if not accs:
        return {}
    out = _summarize(accs)
    out["per_video"] = per_video
    return out


def score_mots_per_class(results, gts, iou_thr: float = 0.5) -> dict:
    """Class-averaged MOTS scoring (BDD protocol, eval_mots
    class_average=True): per-class accumulators across videos, mMOTSA /
    mIDF1 = mean over classes that have gt.

    results/gts: {video: [(frame_id, ids, class_ids, rles)]}.
    """
    by_class_gt = defaultdict(lambda: defaultdict(list))
    by_class_pred = defaultdict(lambda: defaultdict(list))

    def split(src, dst):
        for video, frames in src.items():
            for frame_id, ids, clss, rles in frames:
                rows = defaultdict(lambda: ([], []))
                for tid, c, r in zip(ids, clss, rles):
                    rows[int(c)][0].append(tid)
                    rows[int(c)][1].append(r)
                for c, (cids, crles) in rows.items():
                    dst[c][video].append((frame_id, cids, crles))

    split(gts, by_class_gt)
    split(results, by_class_pred)
    per_class = {}
    all_accs = []
    for c in sorted(by_class_gt):
        # union of videos: predictions of class c in a video with no
        # class-c gt are FPs, not free (the box sibling score_scalabel
        # updates every class on every frame, bdd_evaluator.py)
        preds_c = by_class_pred.get(c, {})
        accs = [
            _accumulate_video(
                by_class_gt[c].get(video, []), preds_c.get(video, []),
                iou_thr)
            for video in sorted(set(by_class_gt[c]) | set(preds_c))
        ]
        per_class[c] = _summarize(accs)
        all_accs.extend(accs)
    # classes predicted but absent from gt everywhere: excluded from the
    # class means (BDD averages over gt classes) but their FPs pool into
    # the overall row
    for c in sorted(set(by_class_pred) - set(by_class_gt)):
        all_accs.extend(
            _accumulate_video([], frames, iou_thr)
            for frames in by_class_pred[c].values())
    scored = list(per_class.values())
    return {
        "mMOTSA": float(np.mean([m["MOTSA"] for m in scored])) if scored else 0.0,
        "msMOTSA": float(np.mean([m["sMOTSA"] for m in scored])) if scored else 0.0,
        "mIDF1": float(np.mean([m["IDF1"] for m in scored])) if scored else 0.0,
        "per_class": per_class,
        "overall": _summarize(all_accs) if all_accs else {},
    }


# ----------------------------------------------------------------------
# MOTS-Challenge txt format
# ----------------------------------------------------------------------
def write_mots_txt(path: str, frames) -> None:
    """frames: [(frame_id, obj_ids, class_ids, rles)] — one line per mask:
    ``frame_id obj_id class_id img_h img_w rle_counts`` (obj_id already
    class-encoded by the caller, e.g. 2000 + track for pedestrians)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    rows = []
    for frame_id, ids, clss, rles in frames:
        for tid, c, r in zip(ids, clss, rles):
            comp = r if isinstance(r["counts"], (str, bytes)) \
                else rle_codec.compress(r)
            counts = comp["counts"]
            if isinstance(counts, bytes):
                counts = counts.decode("ascii")
            h, w = comp["size"]
            rows.append(f"{int(frame_id)} {int(tid)} {int(c)} {h} {w} {counts}")
    with open(path, "w") as f:
        f.write("\n".join(rows) + ("\n" if rows else ""))


def load_mots_txt(path: str):
    """Parse a MOTS-Challenge txt back into
    [(frame_id, obj_ids, class_ids, rles)] (compressed RLEs), sorted by
    frame — the round-trip inverse of write_mots_txt."""
    per_frame = defaultdict(lambda: ([], [], []))
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            frame_s, tid_s, cls_s, h_s, w_s, counts = line.split(" ", 5)
            ids, clss, rles = per_frame[int(frame_s)]
            ids.append(int(tid_s))
            clss.append(int(cls_s))
            rles.append({"size": [int(h_s), int(w_s)], "counts": counts})
    return [(fid,) + per_frame[fid] for fid in sorted(per_frame)]


def score_mots_txt(result_dir: str, gt_txts: dict, iou_thr: float = 0.5,
                   class_id: int | None = None) -> dict:
    """Score written MOTS-Challenge txt files against gt txt paths
    ({video: path}); class_id filters both sides (2 = pedestrian on
    MOT-Challenge). Gt class-10 rows (the MOTS-Challenge ignore regions,
    obj_id 10000) are carried as per-frame ignore masks: unmatched
    predictions mostly inside one are absorbed, not FPs (official
    mots-tools semantics; see _accumulate_video)."""
    def load_dir(get_path, videos, with_ignore=False):
        out = {}
        for v in videos:
            frames = load_mots_txt(get_path(v))
            vid_frames = []
            for fid, ids, clss, rles in frames:
                # class 10 is never a scoreable object — it is the
                # MOTS-Challenge ignore-region annotation (handled below)
                keep = [i for i, c in enumerate(clss)
                        if (c == class_id if class_id is not None
                            else c != 10)]
                row = (fid, [ids[i] for i in keep],
                       [rles[i] for i in keep])
                if with_ignore:
                    row += ([rles[i] for i, c in enumerate(clss)
                             if c == 10],)
                vid_frames.append(row)
            out[v] = vid_frames
        return out

    videos = list(gt_txts)
    gts = load_dir(lambda v: gt_txts[v], videos, with_ignore=True)
    results = load_dir(
        lambda v: os.path.join(result_dir, f"{v}.txt"),
        [v for v in videos
         if os.path.exists(os.path.join(result_dir, f"{v}.txt"))])
    return score_mots(results, gts, iou_thr=iou_thr)
