"""VOC detection evaluator (port of unicorn_tpu/evaluators/voc_evaluator.py;
the reference's unicorn/evaluators/voc_evaluator.py:1-187): a detector
over data.datasets.voc.VOCDetection, scored with the VOC protocol
(voc_eval.py)."""
from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from ..data.preproc import letterbox
from ..device import images_to_device, resolve_device, to_host
from .voc_eval import voc_map


class VOCEvaluator:
    def __init__(self, dataset, img_size=(640, 640), conf_thre=0.01,
                 nms_thre=0.65, use_07_metric=False, iou_thr=0.5,
                 device="cuda"):
        self.dataset = dataset
        self.img_size = tuple(img_size)
        self.conf_thre = conf_thre
        self.nms_thre = nms_thre
        self.use_07_metric = use_07_metric
        self.iou_thr = iou_thr
        self.device = resolve_device(device)

    def evaluate(self, detect_fn, max_images=None):
        """detect_fn(img (1, 3, H, W) float32 on the device, letterboxed) ->
        (K, 7) [x1, y1, x2, y2, obj, cls_conf, cls] in letterbox
        coordinates (a tensor or an array; K may be 0).

        Returns {"mAP": float, "per_class": {cls_idx: ap}}.
        """
        n = len(self.dataset) if max_images is None else min(
            max_images, len(self.dataset))
        all_dets = defaultdict(list)   # cls -> [(img_id, score, box...)]
        all_gts = defaultdict(dict)    # cls -> {img_id: (boxes, difficult)}
        for i in range(n):
            img, gt, (h, w), _ = self.dataset.pull_item(i)
            # the gt per class (VOCDetection keeps difficult objects and
            # stores no flag: all are scored)
            for c in np.unique(gt[:, 4]).astype(int) if len(gt) else []:
                boxes = gt[gt[:, 4] == c, :4]
                all_gts[c][i] = (boxes, np.zeros(len(boxes), bool))
            lb, r = letterbox(img, self.img_size)
            with torch.inference_mode():
                dets = detect_fn(images_to_device(lb[None], self.device))
            for d in to_host(dets).reshape(-1, 7):
                score = float(d[4] * d[5])
                if score < self.conf_thre:
                    continue
                box = d[:4] / r
                all_dets[int(d[6])].append(
                    (i, score, box[0], box[1], box[2], box[3]))
        # the VOC protocol averages over the classes WITH ground truth: a
        # class with gt and no dets counts (AP 0); a detection of a class
        # without gt in the evaluated subset does not lower the mAP
        classes = sorted(all_gts)
        dets_by_cls = {c: all_dets.get(c, []) for c in classes}
        gts_by_cls = {c: all_gts.get(c, {}) for c in classes}
        return voc_map(dets_by_cls, gts_by_cls, iou_thr=self.iou_thr,
                       use_07_metric=self.use_07_metric)
