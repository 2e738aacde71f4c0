"""Box helpers, numpy: the port's copy of pairwise_iou_np from
unicorn_tpu/utils/boxes.py (that module imports jax)."""
from __future__ import annotations

import numpy as np


def pairwise_iou_np(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Numpy IoU matrix for host-side association (xyxy, exclusive: no +1)."""
    if len(boxes_a) == 0 or len(boxes_b) == 0:
        return np.zeros((len(boxes_a), len(boxes_b)), dtype=np.float32)
    tl = np.maximum(boxes_a[:, None, :2], boxes_b[None, :, :2])
    br = np.minimum(boxes_a[:, None, 2:4], boxes_b[None, :, 2:4])
    wh = np.clip(br - tl, 0, None)
    area_i = wh[..., 0] * wh[..., 1]
    area_a = np.prod(boxes_a[:, 2:4] - boxes_a[:, :2], axis=1)
    area_b = np.prod(boxes_b[:, 2:4] - boxes_b[:, :2], axis=1)
    return area_i / (area_a[:, None] + area_b[None, :] - area_i + 1e-12)
