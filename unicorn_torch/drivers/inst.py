"""Instance-segmentation inference: decode + NMS + the CondInst mask decode
of the kept detections (port of unicorn_tpu/drivers/inst.py
make_inst_forward).

Fixed max_out detection slots: the NMS returns each kept row's anchor
index, so the controllers' dynamic parameters, the anchor's location and
its FPN level are gathered in one shot and the 3-layer dynamic head runs
for all slots at once (ops.dynamic_conv.dynamic_mask_logits), then the
stride-8 logits go to stride 4 (aligned_bilinear x2, or RAFT convex
upsampling) and through a sigmoid. Rows past the valid ones carry slot 0's
anchor and are to be ignored, as in JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.heads import decode_boxes, flatten_raw_outputs
from ..models.mask_head import anchor_locations_and_levels
from ..ops.dynamic_conv import (aligned_bilinear, convex_upsample,
                                dynamic_mask_logits)
from ..ops.letterbox import letterbox_device
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
        frame = torch.from_numpy(np.ascontiguousarray(image, np.uint8))
        img, r = letterbox_device(frame.to(self.device), input_size)
        return img.permute(2, 0, 1)[None], r

    @torch.inference_mode()
    def forward(self, images):
        """-> (head_raw, (mask_feats, up_mask, sem_logits))."""
        return self.model(images.to(self.device))

    @torch.inference_mode()
    def detect(self, raw):
        """Decode + NMS -> (flat head outputs, dets (1, K, 7), valid (1, K),
        the kept rows' anchor indices (1, K))."""
        flat = flatten_raw_outputs(raw, "mot")
        boxes = decode_boxes(flat["reg_raw"], flat["hw"], self.strides)
        dec = torch.cat([boxes, torch.sigmoid(flat["obj_logits"]),
                         torch.sigmoid(flat["cls_logits"])], -1)
        dets, valid, idx = postprocess_device(
            dec, num_classes=self.num_classes, conf_thre=self.conf_thre,
            nms_thre=self.nms_thre, n_cand=self.n_cand,
            max_out=self.max_out, return_idx=True)
        return flat, dets, valid, idx

    @torch.inference_mode()
    def masks(self, flat, idx, mask_out):
        """The K slots' mask scores (K, H/4, W/4) from the controllers of
        their anchors and the image's mask features."""
        mask_feats, up_mask, _ = mask_out
        locs, lvls = anchor_locations_and_levels(flat["hw"], self.strides,
                                                 idx.device)
        k_idx = idx[0].long()
        logits = dynamic_mask_logits(mask_feats[0], flat["ctrl"][0][k_idx],
                                     locs[k_idx], lvls[k_idx])
        if self.use_raft and up_mask is not None:
            masks = convex_upsample(logits, up_mask[0], self.up_rate)
        else:
            masks = aligned_bilinear(logits, 2)     # stride 8 -> 4
        return torch.sigmoid(masks)

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
