"""SOT result analysis: success / precision curves and AUC (port of
unicorn_tpu/harness/analysis.py; the reference's
lib/test/analysis/extract_results.py and tools/analysis_results.py).

`plot_results` draws its plots with the port's own primitives
(utils/visualize.py) and writes them with data/image_io.py `write_png`:
no matplotlib, which the card's machine does not have.
"""
from __future__ import annotations

import numpy as np

from ..data.image_io import write_png
from ..utils.visualize import _COLORS, line, put_text, rectangle

# plot_results' canvas (matplotlib's 11 x 4.5 in at 120 dpi) and the plot
# area of each of its two panels, inside the panel: (left, top, right,
# bottom) px
PLOT_SIZE = (540, 1320)
PANEL_AREA = (70, 40, 640, 480)
_GRID = (225, 225, 225)


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


def plot_pixel(panel: int, x: float, y: float, x_max: float):
    """The pixel (column, row) of plot_results' canvas at which the point
    (x, y) of panel 0 (success, x in [0, 1]) or 1 (precision, x in [0,
    x_max] px) lies; y in [0, 1]."""
    left, top, right, bottom = PANEL_AREA
    off = panel * PLOT_SIZE[1] // 2
    return (off + left + int(round(x / x_max * (right - left))),
            bottom - int(round(y * (bottom - top))))


def plot_results(tracker_results: dict, gts: dict, out_path: str,
                 title: str = "OPE"):
    """Success + precision plots for one or more trackers, saved as one PNG
    of PLOT_SIZE: on the left the success rate over the overlap threshold,
    on the right the precision over the location error threshold (px),
    each tracker's mean curve a polyline through `plot_pixel` of its
    points, in colour _COLORS[k] of the k-th tracker, its AUC / precision
    @ 20 px in the legend text; grid lines every 0.2 (success) and 10 px
    (precision).

    Reference role: external/lib/test/analysis/plot_results.py.
    tracker_results: {tracker_name: {seq_name: (N, 4) xywh}}.
    """
    img = np.full(PLOT_SIZE + (3,), 255, np.uint8)
    left, top, right, bottom = PANEL_AREA
    black = (0, 0, 0)
    x_max = (1.0, 50.0)
    for panel, (name, xlabel, ylabel) in enumerate((
            (f"Success plot of {title}", "Overlap threshold",
             "Success rate"),
            (f"Precision plot of {title}",
             "Location error threshold (px)", "Precision"))):
        off = panel * PLOT_SIZE[1] // 2
        for k in range(6):
            gx, _ = plot_pixel(panel, k / 5 * x_max[panel], 0, x_max[panel])
            _, gy = plot_pixel(panel, 0, k / 5, x_max[panel])
            line(img, (gx, top), (gx, bottom), _GRID)
            line(img, (off + left, gy), (off + right, gy), _GRID)
            tick = (f"{k / 5:.1f}" if panel == 0
                    else f"{int(k / 5 * x_max[panel])}")
            put_text(img, tick, (gx - 8, bottom + 18), 0.4, black)
            put_text(img, f"{k / 5:.1f}", (off + left - 32, gy + 4), 0.4,
                     black)
        rectangle(img, (off + left, top), (off + right, bottom), black, 1)
        put_text(img, name, (off + left + 150, top - 12), 0.6, black, 1)
        put_text(img, xlabel, (off + left + 150, bottom + 45), 0.5, black)
        put_text(img, ylabel, (off + 4, top - 14), 0.4, black)
    n_drawn = 0
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
        color = tuple(int(c) for c in _COLORS[n_drawn % len(_COLORS)])
        s_mean = np.mean(s_curves, axis=0)
        p_mean = np.mean(p_curves, axis=0)
        for panel, thr, curve, label, corner in (
                (0, s_thr, s_mean, f"{tname} [AUC {s_mean.mean():.3f}]",
                 left + 10),
                (1, p_thr, p_mean, f"{tname} [P@20 {p_mean[20]:.3f}]",
                 right - 230)):
            pts = [plot_pixel(panel, x, y, x_max[panel])
                   for x, y in zip(thr, curve)]
            for a, b in zip(pts[:-1], pts[1:]):
                line(img, a, b, color)
            off = panel * PLOT_SIZE[1] // 2
            put_text(img, label, (off + corner, bottom - 12 - 18 * n_drawn),
                     0.45, color)
        n_drawn += 1
    write_png(out_path, img)
    return out_path
