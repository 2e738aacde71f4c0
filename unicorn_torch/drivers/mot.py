"""MOT drivers (port of unicorn_tpu/drivers/mot.py): ByteTrack
(detection-only) and the omni path, with QDTrack or DeepSORT association on
the model's instance embeddings and, for MOTS, a CondInst mask per track.

MOTDriver, per frame: the uint8 frame goes up to the card and is
letterboxed there, Unicorn.forward_whole -> decode_for_inference ->
postprocess_device run on the card, one fetch brings the (max_out, 7)
detections and their validity back, and the host ByteTracker associates
them.

MOTOmniDriver, per frame on the card: letterbox -> backbone + PAFPN -> the
head with zero priors -> decode + NMS with the kept rows' anchor indices ->
interaction of the previous frame's stride-16 feature with this frame's
(the first frame with itself; the deformable interaction runs the MSDA
kernel) -> embedding upsample -> the embeddings sampled at the box centres
-> with_mask: the mask branch and the controllers of the kept anchors
through the dynamic mask head, stride 4 (stride 8 / up_rate through the
RAFT up-mask), sigmoid, float16. Then one fetch of dets | valid | embeds,
the host tracker on the valid rows, and a second fetch of only the mask
rows the tracker returns (float32, into page-locked memory).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..losses.uni import sample_instance_embeddings
from ..models.heads import (decode_flat, decode_for_inference,
                            flatten_raw_outputs)
from ..models.mask_head import instance_mask_probs
from ..models.unicorn import Unicorn
from ..ops.letterbox import letterbox_image
from ..ops.nms import postprocess_device
from ..tracker.byte_tracker import ByteTracker
from ..tracker.legacy import DeepSort
from ..tracker.qd_tracker import QuasiDenseEmbedTracker

STRIDES = (8, 16, 32)


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


class MOTOmniDriver:
    """Detection + embedding association (the JAX MOTOmniDriver, the
    reference's mot_evaluator.py:702-1107 omni path). tracker: "qd"
    (QuasiDenseEmbedTracker with qd_params) or "deepsort" (DeepSort on the
    same embeddings). with_mask: update also returns each track's CondInst
    mask probabilities on the stride-4 grid (MOTS); use_raft upsamples them
    with the model's RAFT up-mask to stride 8 / up_rate, else
    aligned_bilinear x2 (JAX's default, which tools/track_omni.py keeps).
    The stages of `update` are public so that a caller can time them."""

    def __init__(self, model: Unicorn, input_size=(800, 1280),
                 num_classes: int = 1, conf_thre: float = 0.01,
                 nms_thre: float = 0.65, max_out: int = 128,
                 qd_params: dict | None = None, with_mask: bool = False,
                 tracker: str = "qd", use_raft: bool = False,
                 up_rate: int = 8, device="cuda"):
        if tracker not in ("qd", "deepsort"):
            raise ValueError(f"tracker must be 'qd' or 'deepsort', got "
                             f"{tracker!r}")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.input_size = tuple(input_size)
        self.num_classes = num_classes
        self.conf_thre = conf_thre
        self.nms_thre = nms_thre
        self.max_out = max_out
        self.with_mask = with_mask
        self.use_raft = use_raft
        self.up_rate = up_rate
        self.qd_params = qd_params or {}
        self.tracker_kind = tracker
        self.tracker = self._make_tracker()
        self.feat_prev = None   # the previous frame's stride-16 feature
        self.frame_id = 0
        self.last_scale = None

    def _make_tracker(self):
        if self.tracker_kind == "deepsort":
            return DeepSort()
        return QuasiDenseEmbedTracker(**self.qd_params)

    def reset(self):
        self.tracker = self._make_tracker()
        self.feat_prev = None
        self.frame_id = 0

    # ---------------------------------------------------------- device side
    def preprocess(self, image: np.ndarray):
        """HWC uint8 frame -> ((1, 3, H, W) float32 channels_last on the
        device, letterbox scale r). The frame goes up as uint8."""
        return letterbox_image(image, self.input_size, self.device)

    @torch.inference_mode()
    def backbone(self, img):
        """img (1, 3, H, W) -> (fpn_outs, feat_cur: the raw stride-16
        feature)."""
        return self.model.forward_backbone(img)

    @torch.inference_mode()
    def head(self, fpn_outs):
        """The head with zero priors -> its raw per-level outputs."""
        priors = tuple(f.new_zeros((f.shape[0], 1) + tuple(f.shape[2:]))
                       for f in fpn_outs)
        return self.model.forward_head(fpn_outs, priors)

    @torch.inference_mode()
    def detect(self, raw):
        """Decode + NMS -> (flat head outputs, dets (1, max_out, 7), valid
        (1, max_out), the kept rows' anchor indices (1, max_out); invalid
        rows are zero and carry anchor 0)."""
        flat = flatten_raw_outputs(raw, "mot")
        dets, valid, idx = postprocess_device(
            decode_flat(flat, STRIDES), num_classes=self.num_classes,
            conf_thre=self.conf_thre, nms_thre=self.nms_thre, n_cand=512,
            max_out=self.max_out, return_idx=True)
        return flat, dets, valid, idx

    @torch.inference_mode()
    def embed(self, feat_prev, feat_cur, dets):
        """Interaction of feat_prev with feat_cur (both cast to fp32, as
        JAX casts them; a bf16 interaction casts back inside the module),
        the embedding upsample of the current side, and its embeddings at
        the box centres -> (max_out, embed_dim) fp32. Invalid rows have
        zero boxes and are sampled at (0, 0); the caller drops them."""
        _, new_cur = self.model.forward_interaction(feat_prev.float(),
                                                    feat_cur.float())
        emb = self.model.forward_upsample(new_cur).float()
        centers = (dets[:, :, :2] + dets[:, :, 2:4]) / 2.0
        return sample_instance_embeddings(emb, centers)[0]

    @torch.inference_mode()
    def mask_decode(self, fpn_outs, flat, idx):
        """Every slot's mask probabilities (max_out, Hm, Wm) float16 on the
        mask grid (H/4 x W/4, or H/8 x W/8 times up_rate with use_raft), from
        the controllers of its anchor (anchor 0 for invalid rows, as in
        JAX) and the frame's mask features."""
        mask_feats, up_mask, _ = self.model.forward_mask_branch(fpn_outs)
        return instance_mask_probs(mask_feats, up_mask, flat, 0, idx[0],
                                   STRIDES, self.use_raft,
                                   self.up_rate).half()

    # ------------------------------------------------------------ host side
    @torch.inference_mode()
    def fetch(self, dets, valid, embeds):
        """One fetch: (max_out, 7 + 1 + embed_dim) float32 numpy of dets |
        valid | embeds."""
        return torch.cat([dets[0].float(), valid[0, :, None].float(),
                          embeds], 1).cpu().numpy()

    def associate(self, packed, r):
        """The host tracker on the valid rows of one fetched frame ->
        ((bboxes (N, 5) image coords + score, labels (N,), track ids (N,)),
        mask rows (N,): the max_out slot behind each output row, -1 for a
        DeepSORT track coasting without a detection)."""
        slots = np.flatnonzero(packed[:, 7] > 0.5)
        d, embeds = packed[slots, :7], packed[slots, 8:]
        if self.tracker_kind == "deepsort":
            # empty frames still step the tracker: the Kalman table must
            # predict and ages must advance
            views = self.tracker.update(d[:, :4] / r, d[:, 4] * d[:, 5],
                                        embeds, d[:, 6].astype(int))
            rows = np.asarray([slots[i] if i >= 0 else -1
                               for i in self.tracker.last_det_indices], int)
            out = np.asarray([[*t.tlbr, t.score] for t in views]).reshape(
                -1, 5)
            ids = np.asarray([t.track_id for t in views], int)
            labels = np.asarray([t.cls for t in views], int)
            return (out, labels, ids), rows
        if len(slots) == 0:     # QDTrack is not stepped on an empty frame
            return (np.zeros((0, 5)), np.zeros((0,), int),
                    np.zeros((0,), int)), np.zeros((0,), int)
        bboxes5 = np.concatenate(
            [d[:, :4] / r, (d[:, 4] * d[:, 5])[:, None]], axis=1)
        bboxes, labels, ids, index = self.tracker.match(
            bboxes5, d[:, 6].astype(int), embeds, self.frame_id,
            return_index=True)
        keep = ids > -1
        return (bboxes[keep], labels[keep], ids[keep]), slots[index][keep]

    @torch.inference_mode()
    def fetch_masks(self, masks, rows):
        """The mask rows the tracker returned -> (N, Hm, Wm) float32; a
        row of -1 gets the zero mask. Only those rows leave the card,
        widened to float32 there and copied into page-locked memory from
        torch's caching host allocator, which the returned array views:
        widening 128 float16 rows of 200 x 320 on the host and copying them
        pageable took 38-47 ms a frame beside an H100, against about 1 ms
        this way (PERF.md)."""
        sel = torch.from_numpy(np.maximum(rows, 0)).to(masks.device)
        coast = torch.from_numpy(rows < 0).to(masks.device)
        m = masks.index_select(0, sel).float().masked_fill_(
            coast[:, None, None], 0.0)
        out = torch.empty(m.shape, dtype=torch.float32,
                          pin_memory=m.is_cuda)
        return out.copy_(m).numpy()

    def update(self, image):
        """image: HWC uint8. Returns (bboxes (N, 5) [x1, y1, x2, y2, score]
        in image coords, labels (N,), track_ids (N,)), plus masks (N, Hm,
        Wm) float32 probabilities on the mask grid, row-aligned with the
        tracker's output, when with_mask. Stores last_scale, the
        letterbox ratio r, for resizing the masks."""
        img, r = self.preprocess(image)
        self.last_scale = r
        fpn_outs, feat_cur = self.backbone(img)
        flat, dets, valid, idx = self.detect(self.head(fpn_outs))
        # first frame: the interaction of the frame with itself
        feat_prev = feat_cur if self.feat_prev is None else self.feat_prev
        embeds = self.embed(feat_prev, feat_cur, dets)
        masks = (self.mask_decode(fpn_outs, flat, idx) if self.with_mask
                 else None)
        self.feat_prev = feat_cur   # stays on the card
        self.frame_id += 1
        out, rows = self.associate(self.fetch(dets, valid, embeds), r)
        if not self.with_mask:
            return out
        return out + (self.fetch_masks(masks, rows),)
