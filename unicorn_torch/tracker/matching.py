"""Association cost matrices + linear assignment, numpy (copy of
unicorn_tpu/tracker/matching.py).

Reference: unicorn/tracker/matching.py:39-180. `lap.lapjv(cost, extend_cost,
cost_limit)` is replaced by scipy's Hungarian on the standard dummy-padded
square matrix: real->dummy edges cost cost_limit/2 and the dummy->dummy block
costs 0 (lapjv's extend_cost construction), so a real pair at cost c is kept
iff c < cost_limit — routing both nodes through dummies costs exactly
cost_limit with the spare dummies pairing up for free.
"""
from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

from ..utils.boxes import pairwise_iou_np


def linear_assignment(cost_matrix: np.ndarray, thresh: float):
    """Returns (matches (K,2), unmatched_a, unmatched_b)."""
    if cost_matrix.size == 0:
        return (np.empty((0, 2), int),
                tuple(range(cost_matrix.shape[0])),
                tuple(range(cost_matrix.shape[1])))
    n, m = cost_matrix.shape
    ext = np.full((n + m, n + m), thresh / 2.0, dtype=np.float64)
    ext[:n, :m] = cost_matrix
    ext[n:, m:] = 0.0  # dummy-dummy block is free (lapjv extend_cost)
    rows, cols = linear_sum_assignment(ext)
    matches = []
    matched_a, matched_b = set(), set()
    for r, c in zip(rows, cols):
        # strict < thresh: lapjv rejects pairs at exactly cost_limit, and
        # Hungarian may break the tie either way on the extended matrix.
        if r < n and c < m and cost_matrix[r, c] < thresh:
            matches.append([r, c])
            matched_a.add(r)
            matched_b.add(c)
    unmatched_a = tuple(i for i in range(n) if i not in matched_a)
    unmatched_b = tuple(j for j in range(m) if j not in matched_b)
    return np.asarray(matches, int).reshape(-1, 2), unmatched_a, unmatched_b


def inclusive_iou_np(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """IoU with the +1 inclusive-pixel convention of cython_bbox.bbox_overlaps,
    which the reference's iou_distance uses (unicorn/tracker/matching.py:58-66).
    """
    if len(boxes_a) == 0 or len(boxes_b) == 0:
        return np.zeros((len(boxes_a), len(boxes_b)), dtype=np.float32)
    tl = np.maximum(boxes_a[:, None, :2], boxes_b[None, :, :2])
    br = np.minimum(boxes_a[:, None, 2:4], boxes_b[None, :, 2:4])
    wh = np.clip(br - tl + 1.0, 0, None)
    area_i = wh[..., 0] * wh[..., 1]
    area_a = np.prod(boxes_a[:, 2:4] - boxes_a[:, :2] + 1.0, axis=1)
    area_b = np.prod(boxes_b[:, 2:4] - boxes_b[:, :2] + 1.0, axis=1)
    return area_i / (area_a[:, None] + area_b[None, :] - area_i + 1e-12)


# Plain (exclusive) IoU, no +1: the convention of the published SORT
# (Bewley sort.py iou_batch) and DeepSORT (iou_matching.iou). The +1
# inclusive form above belongs only to the cython_bbox-lineage trackers
# (BYTE, MOTDT); using it in SORT/DeepSORT inflates small-box IoU (~20% at
# 10x10 px) and flips near-threshold matches against the literature.
exclusive_iou_np = pairwise_iou_np
