"""COCO detection evaluator (port of unicorn_tpu/evaluators/coco_evaluator.py):
batched inference on the device -> COCO-format results -> mAP
(evaluators/coco_map.py).

Reference: unicorn/evaluators/coco_evaluator.py:27-250 (the inference loop,
convert_to_coco_format's letterbox unmapping, COCOeval). On one card the
results accumulate in one process. With a ProcessMesh (parallel/mesh.py
`make_mesh`, one "data" axis), the reference's DistributedSampler and
rank gather: each rank forwards its contiguous share of the images (as
even as possible, the first ranks one more) in batches of batch_size / W
on its card, and every rank scores the detections of all ranks, gathered
in rank order, so every rank returns the same metrics. JAX shards each
batch over its mesh and pads the last one by repetition; the shares need
no padding.

The forward is a torch callable, forward_fn(images) -> decoded (B, A,
5 + C) [cxcywh, obj, cls scores], with images (B, 3, H, W) float32 on the
evaluator's device (a channels_last view of the letterboxed NHWC batch);
it holds its own weights, so there is no params argument. The stages of
`evaluate` are public so that a caller can time them.
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from ..device import images_to_device, resolve_device, to_host
from ..models.heads import decode_for_inference
from ..ops.nms import postprocess_device
from ..utils.boxes import postprocess
from .coco_map import COCOMeanAP


def decode_forward(model):
    """COCOEvaluator's forward_fn for a model (Unicorn or YOLOXDet): its
    head outputs (the first of a tuple) decoded,
    decode_for_inference(raw, (8, 16, 32), mode="mot")."""
    def forward(images):
        raw = model(images)
        if isinstance(raw, tuple):
            raw = raw[0]
        return decode_for_inference(raw, (8, 16, 32), mode="mot")
    return forward


class COCOEvaluator:
    def __init__(self, dataset, img_size, conf_thre, nms_thre, num_classes,
                 batch_size: int = 1, use_device_nms: bool = True,
                 device="cuda", mesh=None):
        self.dataset = dataset
        self.img_size = img_size
        self.conf_thre = conf_thre
        self.nms_thre = nms_thre
        self.num_classes = num_classes
        self.batch_size = batch_size
        self.use_device_nms = use_device_nms
        self.mesh = mesh
        if mesh is not None:
            w = mesh.size("data")
            if batch_size % w:
                raise ValueError(f"COCOEvaluator: batch_size {batch_size} "
                                 f"does not divide over the mesh's {w} "
                                 f"ranks")
            device = mesh.device
        self.device = resolve_device(device)

    def share(self, n):
        """(start, stop, batch size): the images of the first n that this
        process forwards, in batches of that size."""
        if self.mesh is None:
            return 0, n, self.batch_size
        w, r = self.mesh.size("data"), self.mesh.rank
        per, extra = divmod(n, w)
        start = r * per + min(r, extra)
        return start, start + per + (r < extra), self.batch_size // w

    def load(self, idxs):
        """dataset[i] for i in idxs -> (images (B, H, W, 3) float32, infos,
        image ids)."""
        imgs, infos, ids = [], [], []
        for i in idxs:
            img, _, info, img_id = self.dataset[i]
            imgs.append(img)
            infos.append(info)
            ids.append(int(np.asarray(img_id).ravel()[0]))
        return np.stack(imgs), infos, ids

    def nms(self, dec):
        """Decoded (B, A, 5 + C) -> per image an (N, 7) numpy array of
        [x1, y1, x2, y2, obj, cls_conf, cls] in letterbox coordinates, or
        None. On the device (n_cand 1024, max_out 256, one fetch), or on
        the host with use_device_nms=False."""
        if not self.use_device_nms:
            return postprocess(to_host(dec), self.num_classes,
                               self.conf_thre, self.nms_thre)
        dets, valid = postprocess_device(
            dec, num_classes=self.num_classes, conf_thre=self.conf_thre,
            nms_thre=self.nms_thre, n_cand=1024, max_out=256)
        packed = to_host(torch.cat([dets.float(), valid[..., None].float()],
                                   -1))
        return [p[p[:, 7] > 0.5, :7] if (p[:, 7] > 0.5).any() else None
                for p in packed]

    def evaluate(self, forward_fn, max_images=None):
        """The first max_images images (all by default) -> the metrics dict
        of COCOMeanAP (bbox) with n_images and infer_time_s."""
        n = len(self.dataset) if max_images is None else min(
            max_images, len(self.dataset))
        results = []
        t0 = time.time()
        first, stop, bs = self.share(n)
        with torch.inference_mode():
            for start in range(first, stop, bs):
                imgs, infos, ids = self.load(
                    range(start, min(start + bs, stop)))
                dec = forward_fn(images_to_device(imgs, self.device))
                results.extend(self.to_coco(self.nms(dec), infos, ids))
        infer_time = time.time() - t0
        if self.mesh is not None and self.mesh.group is not None:
            every = [None] * self.mesh.size("data")
            dist.all_gather_object(every, results, group=self.mesh.group)
            results = [r for part in every for r in part]
        metrics = self.score(results, n)
        metrics["infer_time_s"] = infer_time
        return metrics

    def score(self, results, n):
        """COCOMeanAP bbox over the first n images of the dataset."""
        metrics = COCOMeanAP(self.dataset.coco.dataset, "bbox").evaluate(
            results, img_ids=[self.dataset.ids[i] for i in range(n)])
        metrics["n_images"] = n
        return metrics

    def to_coco(self, outputs, infos, ids):
        """Letterbox scale unmapped (coco_evaluator.py
        convert_to_coco_format)."""
        out = []
        for det, info, img_id in zip(outputs, infos, ids):
            if det is None or len(det) == 0:
                continue
            h, w = info[0], info[1]
            scale = min(self.img_size[0] / float(h),
                        self.img_size[1] / float(w))
            boxes = det[:, :4] / scale
            for k in range(len(det)):
                x1, y1, x2, y2 = boxes[k]
                cls_idx = int(det[k, 6])
                if cls_idx >= len(self.dataset.class_ids):
                    # the model has more classes than the val json (the
                    # 8-class uni head on the 1-category MOT val): such
                    # detections cannot be scored
                    continue
                out.append({
                    "image_id": img_id,
                    "category_id": self.dataset.class_ids[cls_idx],
                    "bbox": [float(x1), float(y1), float(x2 - x1),
                             float(y2 - y1)],
                    "score": float(det[k, 4] * det[k, 5]),
                })
        return out
