"""MOT driver, ByteTrack path (port of unicorn_tpu/drivers/mot.py MOTDriver).

Per frame: the uint8 frame goes up to the card and is letterboxed there,
Unicorn.forward_whole -> decode_for_inference -> postprocess_device run on
the card, one fetch brings the (max_out, 7) detections and their validity
back, and the host ByteTracker associates them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.heads import decode_for_inference
from ..models.unicorn import Unicorn
from ..ops.letterbox import letterbox_image
from ..ops.nms import postprocess_device
from ..tracker.byte_tracker import ByteTracker


class MOTDriver:
    """ByteTrack path: detection per frame, motion-only association. The
    stages of `update` are public so that a caller can time them."""

    def __init__(self, model: Unicorn, input_size=(800, 1280),
                 num_classes: int = 1, conf_thre: float = 0.01,
                 nms_thre: float = 0.65, track_thresh: float = 0.6,
                 track_buffer: int = 30, match_thresh: float = 0.9,
                 max_out: int = 128, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.input_size = tuple(input_size)
        self.num_classes = num_classes
        self.conf_thre = conf_thre
        self.nms_thre = nms_thre
        self.max_out = max_out
        self.tracker = ByteTracker(track_thresh, track_buffer, match_thresh)

    def reset(self, **kw):
        self.tracker = ByteTracker(**{**dict(track_thresh=0.6,
                                             track_buffer=30,
                                             match_thresh=0.9), **kw})

    def preprocess(self, image: np.ndarray):
        """HWC uint8 frame -> ((1, 3, H, W) float32 channels_last on the
        device, letterbox scale r)."""
        return letterbox_image(image, self.input_size, self.device)

    @torch.inference_mode()
    def forward(self, img):
        return self.model.forward_whole(img)[0]

    @torch.inference_mode()
    def postprocess(self, raw):
        """Raw head outputs -> (dets (1, max_out, 7), valid (1, max_out))."""
        dec = decode_for_inference(raw, (8, 16, 32), mode="mot")
        return postprocess_device(
            dec, num_classes=self.num_classes, conf_thre=self.conf_thre,
            nms_thre=self.nms_thre, n_cand=512, max_out=self.max_out)

    def track(self, dets, valid, r):
        """One fetch of the detections, then the host tracker."""
        packed = torch.cat([dets[0], valid[0, :, None].to(dets.dtype)], 1)
        packed = packed.cpu().numpy()
        d = packed[packed[:, 7] > 0.5]
        if len(d) == 0:
            return self.tracker.update(np.zeros((0, 4)), np.zeros((0,)))
        return self.tracker.update(d[:, :4] / r, d[:, 4] * d[:, 5], d[:, 6])

    def update(self, image):
        """image: HWC uint8. Returns the list of active TrackViews."""
        img, r = self.preprocess(image)
        dets, valid = self.postprocess(self.forward(img))
        return self.track(dets, valid, r)
