"""Instance-segmentation inference: decode + NMS + the CondInst mask decode
of the kept detections (port of unicorn_tpu/drivers/inst.py
make_inst_forward).

Fixed max_out detection slots: the NMS returns each kept row's anchor
index, so the controllers' dynamic parameters, the anchor's location and
its FPN level are gathered in one shot and the 3-layer dynamic head runs
for all slots at once (models.mask_head.instance_mask_probs), then the
stride-8 logits go to stride 4 (aligned_bilinear x2, or RAFT convex
upsampling) and through a sigmoid. Rows past the valid ones carry slot 0's
anchor and are to be ignored, as in JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.heads import decode_flat, flatten_raw_outputs
from ..models.mask_head import instance_mask_probs
from ..ops.letterbox import letterbox_image
from ..ops.nms import postprocess_device


class InstForward:
    """forward_inst(images (1, 3, H, W)) -> (dets (K, 7), valid (K,), masks
    (K, H/4, W/4) sigmoid scores), on the model's device. The stages are
    public so that a caller can time them."""

    def __init__(self, model, num_classes: int, conf_thre: float = 0.01,
                 nms_thre: float = 0.65, max_out: int = 64,
                 n_cand: int = 512, use_raft: bool = False, up_rate: int = 8,
                 strides=(8, 16, 32), device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.num_classes = num_classes
        self.conf_thre = conf_thre
        self.nms_thre = nms_thre
        self.max_out = max_out
        self.n_cand = n_cand
        self.use_raft = use_raft
        self.up_rate = up_rate
        self.strides = tuple(strides)

    def preprocess(self, image: np.ndarray, input_size):
        """HWC uint8 frame -> ((1, 3, H, W) float32 letterboxed on the
        device to input_size, scale r). The frame goes up as uint8."""
        return letterbox_image(image, input_size, self.device)

    @torch.inference_mode()
    def forward(self, images):
        """-> (head_raw, (mask_feats, up_mask, sem_logits))."""
        return self.model(images.to(self.device))

    @torch.inference_mode()
    def detect(self, raw):
        """Decode + NMS -> (flat head outputs, dets (1, K, 7), valid (1, K),
        the kept rows' anchor indices (1, K))."""
        flat = flatten_raw_outputs(raw, "mot")
        dets, valid, idx = postprocess_device(
            decode_flat(flat, self.strides), num_classes=self.num_classes,
            conf_thre=self.conf_thre, nms_thre=self.nms_thre,
            n_cand=self.n_cand, max_out=self.max_out, return_idx=True)
        return flat, dets, valid, idx

    @torch.inference_mode()
    def masks(self, flat, idx, mask_out):
        """The K slots' mask scores (K, H/4, W/4) from the controllers of
        their anchors and the image's mask features."""
        mask_feats, up_mask, _ = mask_out
        return instance_mask_probs(mask_feats, up_mask, flat, 0, idx[0],
                                   self.strides, self.use_raft, self.up_rate)

    def __call__(self, images):
        raw, mask_out = self.forward(images)
        flat, dets, valid, idx = self.detect(raw)
        return dets[0], valid[0], self.masks(flat, idx, mask_out)


def make_inst_forward(model, num_classes: int, conf_thre: float = 0.01,
                      nms_thre: float = 0.65, max_out: int = 64,
                      n_cand: int = 512, use_raft: bool = False,
                      up_rate: int = 8, strides=(8, 16, 32), device="cuda"):
    """The port's make_inst_forward: an InstForward on `device` (the card
    unless the caller asks for the CPU)."""
    return InstForward(model, num_classes, conf_thre, nms_thre, max_out,
                       n_cand, use_raft, up_rate, strides, device)
