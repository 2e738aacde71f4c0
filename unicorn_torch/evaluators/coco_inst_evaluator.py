"""COCO instance-segmentation evaluator: box AP and mask AP on RLE masks
(port of unicorn_tpu/evaluators/coco_inst_evaluator.py; the reference's
unicorn/evaluators/coco_inst_evaluator.py:38-).

Per image, the forward (decode + NMS + the CondInst mask decode, on the
device) gives each detection's mask scores on the letterbox canvas at
1 / d_rate; only the valid rows come back. Each mask's content region is
resized to the image (data/preproc.py resize_linear, cv2.INTER_LINEAR on
float32: within 3e-5 of cv2), thresholded at mask_thres and encoded by the
native RLE codec.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..data.preproc import resize_linear
from ..device import images_to_device, resolve_device, to_host
from . import rle
from .coco_map import COCOMeanAP


def unletterbox_mask(m: np.ndarray, scale: float, img_size, hw,
                     mask_thres: float) -> np.ndarray:
    """One mask's scores (Hm, Wm) on the letterbox canvas -> the binary
    (h, w) uint8 mask of the image: its content region cropped, resized
    bilinearly to (h, w), thresholded (strictly above mask_thres)."""
    h, w = hw
    crop_h = int(round(h * scale * m.shape[0] / img_size[0]))
    crop_w = int(round(w * scale * m.shape[1] / img_size[1]))
    m_c = np.ascontiguousarray(m[:max(crop_h, 1), :max(crop_w, 1)],
                               np.float32)
    return (resize_linear(m_c, (w, h)) > mask_thres).astype(np.uint8)


class COCOInstEvaluator:
    def __init__(self, dataset, img_size, conf_thre, nms_thre, num_classes,
                 mask_thres: float = 0.3, d_rate: int = 4, device="cuda"):
        self.dataset = dataset
        self.img_size = img_size
        self.conf_thre = conf_thre
        self.nms_thre = nms_thre
        self.num_classes = num_classes
        self.mask_thres = mask_thres
        self.d_rate = d_rate
        self.device = resolve_device(device)

    def evaluate(self, forward_inst_fn, max_images=None):
        """forward_inst_fn(images (1, 3, H, W) on the device) -> (dets (K,
        7), valid (K,), masks (K, Hm, Wm) sigmoid scores). Returns box_* and
        (when the ground truth has segmentations) mask_* metrics,
        n_images and infer_time_s."""
        n = len(self.dataset) if max_images is None else min(
            max_images, len(self.dataset))
        box_results, mask_results = [], []
        t0 = time.time()
        for i in range(n):
            img, _, info, img_id = self.dataset[i]
            h, w = info[0], info[1]
            img_id = int(np.asarray(img_id).ravel()[0])
            with torch.inference_mode():
                dets, valid, masks = forward_inst_fn(
                    images_to_device(img[None], self.device))
                keep = to_host(valid).astype(bool)
                dets = to_host(dets)[keep]
                # only the valid rows' masks leave the device
                masks = (to_host(masks[torch.from_numpy(keep).to(
                    masks.device)]) if isinstance(masks, torch.Tensor)
                    else to_host(masks)[keep])
            scale = min(self.img_size[0] / float(h),
                        self.img_size[1] / float(w))
            for k in range(len(dets)):
                x1, y1, x2, y2 = dets[k, :4] / scale
                cls_idx = int(dets[k, 6])
                if cls_idx >= len(self.dataset.class_ids):
                    # more classes than the val json defines (as in
                    # COCOEvaluator): unscoreable
                    continue
                score = float(dets[k, 4] * dets[k, 5])
                box_results.append({
                    "image_id": img_id,
                    "category_id": self.dataset.class_ids[cls_idx],
                    "bbox": [float(x1), float(y1), float(x2 - x1),
                             float(y2 - y1)],
                    "score": score,
                })
                mask_results.append({
                    "image_id": img_id,
                    "category_id": self.dataset.class_ids[cls_idx],
                    "segmentation": rle.encode(unletterbox_mask(
                        masks[k], scale, self.img_size, (h, w),
                        self.mask_thres)),
                    "score": score,
                })
        infer_time = time.time() - t0
        gt = self.dataset.coco.dataset
        img_ids = [self.dataset.ids[i] for i in range(n)]
        box_m = COCOMeanAP(gt, "bbox").evaluate(box_results, img_ids)
        out = {"box_" + k: v for k, v in box_m.items()}
        if all("segmentation" in a for a in gt.get("annotations", [])[:1]):
            mask_m = COCOMeanAP(gt, "segm").evaluate(mask_results, img_ids)
            out.update({"mask_" + k: v for k, v in mask_m.items()})
        out["n_images"] = n
        out["infer_time_s"] = infer_time
        return out
