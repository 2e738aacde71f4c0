"""SOT result analysis: success / precision curves and AUC (port of
unicorn_tpu/harness/analysis.py; the reference's
lib/test/analysis/extract_results.py and tools/analysis_results.py).

`plot_results` imports matplotlib when it is called, and raises ImportError
where matplotlib is not installed; nothing else here needs it.
"""
from __future__ import annotations

import numpy as np


def _iou_xywh(a, b):
    ax1, ay1 = a[:, 0], a[:, 1]
    ax2, ay2 = a[:, 0] + a[:, 2], a[:, 1] + a[:, 3]
    bx1, by1 = b[:, 0], b[:, 1]
    bx2, by2 = b[:, 0] + b[:, 2], b[:, 1] + b[:, 3]
    ix1 = np.maximum(ax1, bx1)
    iy1 = np.maximum(ay1, by1)
    ix2 = np.minimum(ax2, bx2)
    iy2 = np.minimum(ay2, by2)
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    union = a[:, 2] * a[:, 3] + b[:, 2] * b[:, 3] - inter
    return inter / np.maximum(union, 1e-9)


def success_curve(pred_xywh, gt_xywh, n_thresholds: int = 21):
    """Fraction of frames with IoU > t for t in [0, 1]."""
    valid = (gt_xywh[:, 2] > 0) & (gt_xywh[:, 3] > 0)
    iou = _iou_xywh(pred_xywh[valid], gt_xywh[valid])
    thresholds = np.linspace(0, 1, n_thresholds)
    return np.array([(iou > t).mean() for t in thresholds]), thresholds


def precision_curve(pred_xywh, gt_xywh, max_dist: int = 51):
    valid = (gt_xywh[:, 2] > 0) & (gt_xywh[:, 3] > 0)
    pc = pred_xywh[valid, :2] + pred_xywh[valid, 2:] / 2
    gc = gt_xywh[valid, :2] + gt_xywh[valid, 2:] / 2
    dist = np.linalg.norm(pc - gc, axis=1)
    thresholds = np.arange(0, max_dist)
    return np.array([(dist < t).mean() for t in thresholds]), thresholds


def normalized_precision_curve(pred_xywh, gt_xywh, n_thresholds: int = 51):
    valid = (gt_xywh[:, 2] > 0) & (gt_xywh[:, 3] > 0)
    pc = pred_xywh[valid, :2] + pred_xywh[valid, 2:] / 2
    gc = gt_xywh[valid, :2] + gt_xywh[valid, 2:] / 2
    norm = np.maximum(gt_xywh[valid, 2:], 1e-9)
    dist = np.linalg.norm((pc - gc) / norm, axis=1)
    thresholds = np.linspace(0, 0.5, n_thresholds)
    return np.array([(dist < t).mean() for t in thresholds]), thresholds


def evaluate_sot(results: dict, gts: dict):
    """results/gts: {seq_name: (N, 4) xywh}. Returns AUC / precision /
    norm-precision averaged over sequences (OPE protocol)."""
    aucs, precs, nprecs = [], [], []
    for name, pred in results.items():
        if name not in gts:
            continue
        gt = np.asarray(gts[name], np.float64)
        pred = np.asarray(pred, np.float64)[: len(gt)]
        gt = gt[: len(pred)]
        sc, _ = success_curve(pred, gt)
        pc, _ = precision_curve(pred, gt)
        npc, _ = normalized_precision_curve(pred, gt)
        aucs.append(sc.mean())
        precs.append(pc[20])   # precision @ 20px
        nprecs.append(npc.mean())
    return {
        "AUC": float(np.mean(aucs)) if aucs else 0.0,
        "Precision@20": float(np.mean(precs)) if precs else 0.0,
        "NormPrecision": float(np.mean(nprecs)) if nprecs else 0.0,
        "n_sequences": len(aucs),
    }


def plot_results(tracker_results: dict, gts: dict, out_path: str,
                 title: str = "OPE"):
    """Success + precision plots for one or more trackers, saved as one PNG.

    Reference role: external/lib/test/analysis/plot_results.py.
    tracker_results: {tracker_name: {seq_name: (N, 4) xywh}}.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax_s, ax_p) = plt.subplots(1, 2, figsize=(11, 4.5))
    for tname, results in tracker_results.items():
        s_curves, p_curves = [], []
        for name, pred in results.items():
            if name not in gts:
                continue
            gt = np.asarray(gts[name], np.float64)
            pred = np.asarray(pred, np.float64)[: len(gt)]
            gt = gt[: len(pred)]
            sc, s_thr = success_curve(pred, gt)
            pc, p_thr = precision_curve(pred, gt)
            s_curves.append(sc)
            p_curves.append(pc)
        if not s_curves:
            continue
        s_mean = np.mean(s_curves, axis=0)
        p_mean = np.mean(p_curves, axis=0)
        ax_s.plot(s_thr, s_mean,
                  label=f"{tname} [AUC {s_mean.mean():.3f}]")
        ax_p.plot(p_thr, p_mean,
                  label=f"{tname} [P@20 {p_mean[20]:.3f}]")
    ax_s.set_xlabel("Overlap threshold")
    ax_s.set_ylabel("Success rate")
    ax_s.set_title(f"Success plot of {title}")
    ax_s.set_xlim(0, 1)
    ax_s.set_ylim(0, 1)
    ax_s.grid(True, alpha=0.3)
    ax_s.legend(loc="lower left", fontsize=8)
    ax_p.set_xlabel("Location error threshold (px)")
    ax_p.set_ylabel("Precision")
    ax_p.set_title(f"Precision plot of {title}")
    ax_p.set_ylim(0, 1)
    ax_p.grid(True, alpha=0.3)
    ax_p.legend(loc="lower right", fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
