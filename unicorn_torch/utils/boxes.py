"""Box helpers, numpy: the port's copies of unicorn_tpu/utils/boxes.py's host
functions (that module imports jax): pairwise_iou_np for association, and
the host NMS behind COCOEvaluator(use_device_nms=False), nms_np,
batched_nms_np and postprocess."""
from __future__ import annotations

import numpy as np


def cxcywh2xyxy(boxes: np.ndarray) -> np.ndarray:
    cx, cy, w, h = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=-1)


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


def nms_np(boxes: np.ndarray, scores: np.ndarray,
           iou_threshold: float) -> np.ndarray:
    """Greedy NMS -> kept indices in descending score order (stable).
    torchvision.ops.nms's rule: a box is suppressed at IoU strictly above
    the threshold."""
    order = np.argsort(-scores, kind="stable")
    boxes = boxes[order]
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = (x2 - x1) * (y2 - y1)
    keep = []
    suppressed = np.zeros(len(boxes), dtype=bool)
    for i in range(len(boxes)):
        if suppressed[i]:
            continue
        keep.append(order[i])
        xx1 = np.maximum(x1[i], x1[i + 1:])
        yy1 = np.maximum(y1[i], y1[i + 1:])
        xx2 = np.minimum(x2[i], x2[i + 1:])
        yy2 = np.minimum(y2[i], y2[i + 1:])
        w = np.clip(xx2 - xx1, 0, None)
        h = np.clip(yy2 - yy1, 0, None)
        inter = w * h
        iou = inter / (areas[i] + areas[i + 1:] - inter + 1e-12)
        suppressed[i + 1:] |= iou > iou_threshold
    return np.asarray(keep, dtype=np.int64)


def batched_nms_np(boxes, scores, class_ids, iou_threshold):
    """Class-aware NMS by the coordinate offset (torchvision's)."""
    if len(boxes) == 0:
        return np.zeros((0,), dtype=np.int64)
    max_coord = boxes.max()
    offsets = class_ids.astype(np.float64) * (max_coord + 1.0)
    shifted = boxes + offsets[:, None]
    return nms_np(shifted, scores, iou_threshold)


def postprocess(prediction: np.ndarray, num_classes: int,
                conf_thre: float = 0.7, nms_thre: float = 0.45,
                class_agnostic: bool = False):
    """The reference's postprocess (unicorn/utils/boxes.py:33-79) on the
    host: prediction (B, A, 5 + num_classes), decoded cxcywh + sigmoided
    obj and class scores -> a list of per-image (N, 7) arrays [x1, y1, x2,
    y2, obj_conf, class_conf, class_id], or None for an image without
    detections."""
    prediction = np.asarray(prediction)
    boxes_xyxy = cxcywh2xyxy(prediction[..., :4])
    outputs = []
    for i in range(prediction.shape[0]):
        image_pred = prediction[i]
        cls_scores = image_pred[:, 5: 5 + num_classes]
        class_conf = cls_scores.max(axis=1)
        class_pred = cls_scores.argmax(axis=1)
        score = image_pred[:, 4] * class_conf
        conf_mask = score >= conf_thre
        if not conf_mask.any():
            outputs.append(None)
            continue
        dets = np.concatenate([
            boxes_xyxy[i][conf_mask],
            image_pred[conf_mask, 4:5],
            class_conf[conf_mask, None],
            class_pred[conf_mask, None].astype(np.float32),
        ], axis=1)
        if class_agnostic:
            keep = nms_np(dets[:, :4], dets[:, 4] * dets[:, 5], nms_thre)
        else:
            keep = batched_nms_np(dets[:, :4], dets[:, 4] * dets[:, 5],
                                  dets[:, 6], nms_thre)
        outputs.append(dets[keep] if len(keep) else None)
    return outputs
