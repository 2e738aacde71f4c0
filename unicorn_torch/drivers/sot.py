"""SOT driver: reference-frame caching + per-frame propagation (port of
unicorn_tpu/drivers/sot.py SOTDriver).

`initialize` runs the trunk on frame 0 and keeps its stride-16 feature and
the stride-8 map of the initial box on the device. Every later frame: the
uint8 frame goes up and is letterboxed on the device -> backbone + PAFPN ->
deformable interaction with the cached reference feature -> embeddings ->
correlation label propagation -> SOT head with the propagated prior pyramid
-> decode -> NMS on the device. One fetch brings the packed (max_inst, 8)
detections back, and the best box becomes the state on the host.

A frame's computation reads only the fixed reference state, never the
frame before it, so `track_window` runs whole windows as one batch. The
stages take the references as arguments (the cached ones when none are
given), so that one code path also serves S sequences in lockstep, each
frame with its own sequence's references (drivers/seq_parallel.py).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.heads import decode_for_inference
from ..models.unicorn import Unicorn
from ..ops.correlation import box_label_map, resize_bilinear_torch
from ..ops.correlation_kernel import correlation_propagate_auto
from ..ops.letterbox import letterbox_image
from ..ops.nms import postprocess_device


class SOTDriver:
    """The stages of `track` are public so that a caller can time them."""

    def __init__(self, model: Unicorn, input_size=(800, 1280),
                 conf_thre: float = 0.001, nms_thre: float = 0.65,
                 max_inst: int = 3, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.input_size = tuple(input_size)
        self.conf_thre = conf_thre
        self.nms_thre = nms_thre
        self.max_inst = max_inst
        self.state = None
        self.feat_ref = None      # (1, C, H/16, W/16), the trunk's dtype
        self.lbs_ref = None       # (1, 1, H/8 * W/8) float32
        self.frame_id = 0

    def preprocess(self, image: np.ndarray):
        """HWC uint8 frame -> ((1, 3, H, W) float32 channels_last on the
        device, letterbox scale r). The frame goes up as uint8."""
        return letterbox_image(image, self.input_size, self.device)

    @torch.inference_mode()
    def init_refs(self, image, init_bbox_xywh):
        """image: HWC uint8; init_bbox: [x, y, w, h] in image coords ->
        (the stride-16 reference feature (1, C, H/16, W/16), the box's
        stride-8 label map (1, 1, H/8 * W/8) float32, letterbox scale r);
        the driver's state is left alone."""
        img, r = self.preprocess(image)
        x, y, w, h = init_bbox_xywh
        box = torch.tensor([[(x + w / 2) * r, (y + h / 2) * r, w * r, h * r]],
                           dtype=torch.float32, device=self.device)
        H, W = self.input_size
        feat_ref = self.model.forward_backbone(img, run_fpn=False)
        lbs = resize_bilinear_torch(box_label_map(box, H, W)[:, None],
                                    H // 8, W // 8)
        return feat_ref, lbs.reshape(1, 1, (H // 8) * (W // 8)), r

    def initialize(self, image, init_bbox_xywh):
        """image: HWC uint8; init_bbox: [x, y, w, h] in image coords."""
        self.frame_id = 0
        self.feat_ref, self.lbs_ref, _ = self.init_refs(image, init_bbox_xywh)
        self.state = list(init_bbox_xywh)

    @torch.inference_mode()
    def backbone(self, imgs):
        """imgs (B, 3, H, W) -> (fpn_outs, feat_cur)."""
        return self.model.forward_backbone(imgs)

    @torch.inference_mode()
    def embed(self, feat_cur, feat_ref=None):
        """Interaction of the reference features with feat_cur (B, C, H/16,
        W/16), then the embedding upsample of both -> (emb_ref, emb_cur),
        each (B, embed_dim, H/8, W/8). feat_ref: (B, C, H/16, W/16), one a
        frame, or (1, ...) for all; the cached one when None."""
        feat_ref = (self.feat_ref if feat_ref is None else feat_ref).expand(
            feat_cur.shape[0], -1, -1, -1)
        new_ref, new_cur = self.model.forward_interaction(
            feat_ref.float(), feat_cur.float())
        return (self.model.forward_upsample(new_ref),
                self.model.forward_upsample(new_cur))

    @torch.inference_mode()
    def propagate(self, emb_ref, emb_cur, fpn_outs, lbs_ref=None):
        """Correlation label propagation of the reference label maps, and the
        prior pyramid at strides 8/16/32 in each FPN level's dtype. lbs_ref:
        (B, 1, H/8 * W/8), one a frame, or (1, ...) for all; the cached one
        when None."""
        b, c, h8, w8 = emb_cur.shape

        def tokens(e):
            return e.permute(0, 2, 3, 1).reshape(b, h8 * w8, c).float()

        lbs = (self.lbs_ref if lbs_ref is None else lbs_ref).expand(
            b, -1, -1).contiguous()
        prior = correlation_propagate_auto(
            tokens(emb_ref).contiguous(), tokens(emb_cur).contiguous(), lbs
        ).reshape(b, 1, h8, w8)
        priors = (prior,
                  resize_bilinear_torch(prior, h8 // 2, w8 // 2),
                  resize_bilinear_torch(prior, h8 // 4, w8 // 4))
        return tuple(p.to(f.dtype) for p, f in zip(priors, fpn_outs))

    @torch.inference_mode()
    def head(self, fpn_outs, priors):
        return self.model.forward_head(fpn_outs, priors)

    def forward(self, imgs, feat_ref=None, lbs_ref=None):
        """imgs (B, 3, H, W) -> the head's raw outputs for the SOT decode;
        the references as `embed` and `propagate` take them."""
        fpn_outs, feat_cur = self.backbone(imgs)
        emb_ref, emb_cur = self.embed(feat_cur, feat_ref)
        return self.head(fpn_outs, self.propagate(emb_ref, emb_cur, fpn_outs,
                                                  lbs_ref))

    @torch.inference_mode()
    def postprocess(self, raw):
        """Raw head outputs -> packed (B, max_inst, 8): [x1, y1, x2, y2,
        obj, cls_conf, cls_id, valid], in score order, on the device."""
        dec = decode_for_inference(raw, (8, 16, 32), mode="sot")
        dets, valid = postprocess_device(
            dec, num_classes=1, conf_thre=self.conf_thre,
            nms_thre=self.nms_thre, class_agnostic=True, n_cand=256,
            max_out=self.max_inst)
        return torch.cat([dets, valid[..., None].to(dets.dtype)], -1)

    @staticmethod
    def update_state_from_packed(packed, r, state, input_size):
        """Host-side best-box state carry from one packed (max_inst, 8)
        result: clamp to the input, rescale, xywh; an empty frame carries
        the state."""
        dets = packed[packed[:, 7] > 0.5]
        if len(dets):
            boxes = dets[:, :4].copy()
            H, W = input_size
            boxes[:, 0::2] = boxes[:, 0::2].clip(0, W)
            boxes[:, 1::2] = boxes[:, 1::2].clip(0, H)
            best = boxes[0] / r
            state = [float(best[0]), float(best[1]),
                     float(best[2] - best[0]), float(best[3] - best[1])]
        return state

    def track(self, image):
        """Returns {"target_bbox": [x, y, w, h]} in original image coords."""
        self.frame_id += 1
        img, r = self.preprocess(image)
        packed = self.postprocess(self.forward(img))[0].cpu().numpy()
        self.state = self.update_state_from_packed(
            packed, r, self.state, self.input_size)
        return {"target_bbox": list(self.state)}

    def track_window(self, images, window: int = 8):
        """Batched tracking of a list of frames, one fetch per window; the
        same results as sequential `track` calls. A partial tail chunk is
        padded to the full window with its last frame (outputs discarded),
        so that every call runs one batch shape. Returns a list of
        {"target_bbox": ...} per frame."""
        outs = []
        for start in range(0, len(images), window):
            pre = [self.preprocess(im) for im in images[start:start + window]]
            frames = [img for img, _ in pre]
            frames += [frames[-1]] * (window - len(frames))
            packed = self.postprocess(self.forward(torch.cat(frames)))
            packed = packed.cpu().numpy()
            for k, (_, r) in enumerate(pre):
                self.frame_id += 1
                self.state = self.update_state_from_packed(
                    packed[k], r, self.state, self.input_size)
                outs.append({"target_bbox": list(self.state)})
        return outs
