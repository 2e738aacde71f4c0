"""DAVIS J&F: region Jaccard and boundary F-measure (port of
unicorn_tpu/harness/davis_metrics.py; the reference's
davis2017-evaluation/davis2017/metrics.py db_eval_iou and db_eval_boundary).

The boundary measure matches boundary pixels within an elliptic
neighbourhood. The JAX package dilates with OpenCV; the port computes the
same without it: `ellipse_kernel` builds OpenCV's MORPH_ELLIPSE structuring
element row by row and `dilate` takes the OR over the kernel's row spans
with prefix sums, pixels outside the image adding nothing, as `cv2.dilate`
does.
"""
from __future__ import annotations

import math

import numpy as np


def jaccard(pred: np.ndarray, gt: np.ndarray) -> float:
    """Region similarity J for binary masks."""
    pred = pred.astype(bool)
    gt = gt.astype(bool)
    union = (pred | gt).sum()
    if union == 0:
        return 1.0 if pred.sum() == gt.sum() else 0.0
    return float((pred & gt).sum() / union)


def _seg2bmap(seg: np.ndarray) -> np.ndarray:
    """Binary boundary map via XOR with 1-pixel shifts (metrics.py seg2bmap)."""
    seg = seg.astype(bool)
    e = np.zeros_like(seg)
    s = np.zeros_like(seg)
    se = np.zeros_like(seg)
    e[:, :-1] = seg[:, 1:]
    s[:-1, :] = seg[1:, :]
    se[:-1, :-1] = seg[1:, 1:]
    b = (seg ^ e) | (seg ^ s) | (seg ^ se)
    # the last row and column are ASSIGNED, not OR-ed (metrics.py:163-165):
    # the vertical and diagonal terms there compare against zero padding
    # and would mark every border-touching foreground pixel as boundary
    b[-1, :] = seg[-1, :] ^ e[-1, :]
    b[:, -1] = seg[:, -1] ^ s[:, -1]
    b[-1, -1] = 0
    return b


def ellipse_kernel(k: int) -> np.ndarray:
    """(k, k) uint8 0/1: OpenCV's getStructuringElement(MORPH_ELLIPSE,
    (k, k)). With r = c = k // 2, row i (dy = i - r) is 1 on columns
    max(c - dx, 0) .. min(c + dx, k - 1), dx = round-half-even of
    c * sqrt((r^2 - dy^2) / r^2)."""
    if k < 1:
        raise ValueError(f"ellipse_kernel needs k >= 1, got {k}")
    r = c = k // 2
    out = np.zeros((k, k), np.uint8)
    for i in range(k):
        dy = i - r
        if abs(dy) <= r:
            dx = round(c * math.sqrt((r * r - dy * dy) / (r * r))) if r else 0
            out[i, max(c - dx, 0):min(c + dx + 1, k)] = 1
    return out


def dilate(binary: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """(H, W) bool: cv2.dilate(binary.astype(uint8), kernel) > 0 with the
    kernel's anchor at its centre. out[y, x] is set where some kernel
    element (i, j) that is 1 finds binary[y + i - kh // 2, x + j - kw // 2]
    set inside the image. Each run of ones in a kernel row is a horizontal
    span, tested with one prefix-sum difference and shifted by its row."""
    src = np.asarray(binary).astype(bool)
    kernel = np.asarray(kernel).astype(bool)
    if src.ndim != 2 or kernel.ndim != 2:
        raise ValueError(f"dilate takes (H, W) arrays, got {src.shape} and "
                         f"{kernel.shape}")
    H, W = src.shape
    kh, kw = kernel.shape
    ay, ax = kh // 2, kw // 2
    # cs[y, P + x] = number of set pixels of row y left of column x, for x
    # in [-P, W + P]: 0 left of the image, the row's total right of it
    P = kw
    cs = np.zeros((H, W + 1 + 2 * P), np.int32)
    np.cumsum(src, axis=1, out=cs[:, P + 1:P + 1 + W])
    cs[:, P + 1 + W:] = cs[:, P + W:P + W + 1]
    spans = {}
    out = np.zeros((H, W), bool)
    for i in range(kh):
        edges = np.flatnonzero(np.diff(np.concatenate(
            ([False], kernel[i], [False])).astype(np.int8)))
        dy = i - ay
        lo_y, hi_y = max(0, -dy), min(H, H - dy)
        if lo_y >= hi_y:
            continue
        for j0, j1 in zip(edges[::2] - ax, edges[1::2] - ax):
            if (j0, j1) not in spans:
                # any set pixel of the row in columns [x + j0, x + j1)
                spans[j0, j1] = (cs[:, P + j1:P + j1 + W]
                                 > cs[:, P + j0:P + j0 + W])
            out[lo_y:hi_y] |= spans[j0, j1][lo_y + dy:hi_y + dy]
    return out


def boundary_f(pred: np.ndarray, gt: np.ndarray,
               bound_th: float = 0.008) -> float:
    """Boundary F-measure with dilation-based matching."""
    fg_boundary = _seg2bmap(pred)
    gt_boundary = _seg2bmap(gt)
    bound_pix = max(1, int(np.ceil(bound_th * np.linalg.norm(pred.shape))))
    kernel = ellipse_kernel(2 * bound_pix + 1)
    fg_dil = dilate(fg_boundary, kernel)
    gt_dil = dilate(gt_boundary, kernel)
    gt_match = gt_boundary & fg_dil
    fg_match = fg_boundary & gt_dil
    n_fg = fg_boundary.sum()
    n_gt = gt_boundary.sum()
    if n_fg == 0 and n_gt == 0:
        return 1.0
    if n_fg == 0 or n_gt == 0:
        return 0.0
    precision = fg_match.sum() / n_fg
    recall = gt_match.sum() / n_gt
    if precision + recall == 0:
        return 0.0
    return float(2 * precision * recall / (precision + recall))


def evaluate_davis(pred_masks: dict, gt_masks: dict, skip_first_last=True):
    """pred/gt: {seq: list of (H, W) indexed masks}. Per-object J and F,
    averaged DAVIS-style (the mean over objects of per-sequence means;
    frames 1..N-2 by convention).

    The two lists MUST be frame-aligned: entry t of preds and gts describe
    the same video frame. YouTube-VOS valid ships sparse annotations
    (first-appearance frames only), so the caller subsets its predictions
    to the annotated frame names first (tools/test.py does this by frame
    stem).

    Object ids are collected over ALL frames, not just frame 0: YouTube-VOS
    objects can enter mid-video. Each object is scored from the frame after
    its first ground-truth appearance (its reference frame is given, like
    DAVIS frame 0)."""
    j_means, f_means = [], []
    for seq, gts in gt_masks.items():
        if seq not in pred_masks:
            continue
        preds = pred_masks[seq]
        obj_first: dict = {}
        for t, g in enumerate(gts):
            for oid in np.unique(g):
                if oid != 0 and int(oid) not in obj_first:
                    obj_first[int(oid)] = t
        lo = 1 if skip_first_last else 0
        hi = len(gts) - 1 if skip_first_last else len(gts)
        for oid in sorted(obj_first):
            start = obj_first[oid] + (1 if skip_first_last else 0)
            js, fs = [], []
            for t in range(max(lo, start), hi):
                p = preds[t] == oid
                g = gts[t] == oid
                js.append(jaccard(p, g))
                fs.append(boundary_f(p, g))
            if js:
                j_means.append(np.mean(js))
                f_means.append(np.mean(fs))
    J = float(np.mean(j_means)) if j_means else 0.0
    F = float(np.mean(f_means)) if f_means else 0.0
    return {"J": J, "F": F, "J&F": (J + F) / 2,
            "n_objects": len(j_means)}
