"""VOS driver: multi-object mask propagation + CondInst mask decoding (port
of unicorn_tpu/drivers/vos.py VOSDriver).

Objects live in a fixed number of slots K (`max_objects`). `initialize`
runs the trunk on the first frame and keeps its stride-16 feature and one
stride-8 box-rectangle label map per slot on the device; `add_objects`
gives objects that enter mid-video a free slot whose reference is their
entry frame. Every later frame: the uint8 frame goes up and is letterboxed
on the device -> backbone + PAFPN -> interaction of the reference feature(s)
with the frame's -> embeddings -> correlation label propagation of the K
label maps -> SOT head over the K slots with each slot's prior pyramid ->
decode -> NMS -> the CondInst mask of each slot's best detection, at the
input size. The tail resizes the K probability maps to the original frame,
soft-aggregates them and fetches one uint8 label map.

Two paths propagate the labels, as in JAX:
  track_fn_shared  every object entered on one frame (the DAVIS-standard
                   case): one interaction, one correlation with the K label
                   maps as its value rows (groups of at most 16 maps, one
                   kernel call each).
  track_fn         the general path after a mid-video entry: the
                   interaction batched over the K (ref, cur) pairs, so the
                   MSDA kernel runs at batch K, and the correlation at
                   batch K with one label map each.
JAX also keeps the general path as a loop of K batch-1 interactions
(track_fn_mapped), an A/B form for its benchmark; `track` never takes it
there, and the port leaves it out.

The head runs once at batch K, where JAX runs a lax.map of K batch-1
passes: one set of dispatches a frame whatever K is, and one NMS over the
K slots. The mask branch runs once a frame at batch 1.

Both paths take the references as arguments (the cached ones when none are
given) and a batch of S frames, so that one code path also serves S
sequences in lockstep, each with its own K slots (drivers/seq_parallel.py):
the backbone and the mask branch run at batch S, the interaction at batch
S (shared) or S * K (general), the head and NMS at batch S * K.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models.heads import decode_flat, flatten_raw_outputs
from ..models.mask_head import instance_mask_probs
from ..ops.correlation import resize_bilinear_torch
from ..ops.correlation_kernel import correlation_propagate_auto
from ..ops.dynamic_conv import aligned_bilinear
from ..ops.letterbox import letterbox_image
from ..ops.nms import postprocess_device

STRIDES = (8, 16, 32)


class VOSDriver:
    """The stages of `track` are public so that a caller can time them."""

    def __init__(self, model, input_size=(800, 1280), max_objects: int = 4,
                 conf_thre: float = 0.001, nms_thre: float = 0.65,
                 use_raft: bool = False, up_rate: int = 8, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.input_size = tuple(input_size)
        self.K = max_objects
        self.conf_thre = conf_thre
        self.nms_thre = nms_thre
        self.use_raft = use_raft
        self.up_rate = up_rate
        self.feat_ref = None    # (K, C, H/16, W/16) per-slot references
        self.feat_ref1 = None   # (1, C, H/16, W/16) the shared reference
        self.lbs_ref = None     # (K, 1, H/8 * W/8) float32 per-slot label maps
        self.obj_valid = np.zeros((max_objects,), np.float32)
        self.obj_ids: list = []  # slot -> original object id
        # objects added this frame: on their entry frame the output is the
        # GT mask verbatim; {oid: binary mask at original res}, cleared by
        # postprocess_masks_host
        self._entry_overlay: dict = {}
        self.shared_ref = False
        self.scale = None
        self.orig_shape = None

    # ------------------------------------------------------------ host side
    def preprocess(self, image: np.ndarray):
        """HWC uint8 frame -> ((1, 3, H, W) float32 channels_last on the
        device, letterbox scale r). The frame goes up as uint8."""
        return letterbox_image(image, self.input_size, self.device)

    def _box_raster(self, bbox_xywh, r):
        """One object's label prior: xywh -> xyxy, scaled by r, rounded,
        clamped, a hard rectangle on the input-size canvas."""
        H, W = self.input_size
        x, y, w, h = bbox_xywh
        x1 = max(0, min(int(round(x * r)), W))
        y1 = max(0, min(int(round(y * r)), H))
        x2 = max(0, min(int(round((x + w) * r)), W))
        y2 = max(0, min(int(round((y + h) * r)), H))
        lb = np.zeros((H, W), np.float32)
        lb[y1:y2, x1:x2] = 1.0
        return lb

    @staticmethod
    def _mask_bbox(m):
        """Object mask -> tlwh bbox, inclusive-pixel size."""
        ys, xs = np.where(m)
        if len(xs) == 0:
            return [0.0, 0.0, 0.0, 0.0]
        return [float(xs.min()), float(ys.min()),
                float(xs.max() - xs.min() + 1), float(ys.max() - ys.min() + 1)]

    def _label_canvas(self, slots_bboxes, r):
        """[(slot, bbox)] -> (K, H, W) uint8 rectangles on the device."""
        lb = np.zeros((self.K,) + self.input_size, np.uint8)
        for slot, bbox in slots_bboxes:
            lb[slot] = self._box_raster(bbox, r)
        return torch.from_numpy(lb).to(self.device)

    # ---------------------------------------------------------- device side
    @torch.inference_mode()
    def init_fn(self, img, obj_masks):
        """img (1, 3, H, W); obj_masks (K, H, W) binary -> (the stride-16
        feature (1, C, H/16, W/16), label maps (K, 1, H/8 * W/8) float32)."""
        H, W = self.input_size
        feat16 = self.model.forward_backbone(img, run_fpn=False)
        lbs = resize_bilinear_torch(obj_masks[:, None].float(), H // 8, W // 8)
        return feat16, lbs.reshape(obj_masks.shape[0], 1, -1)

    @torch.inference_mode()
    def backbone(self, img):
        """img (S, 3, H, W), S = 1 but in lockstep -> (fpn_outs,
        feat_cur)."""
        return self.model.forward_backbone(img)

    @torch.inference_mode()
    def embed(self, feat_ref, feat_cur):
        """Interaction of reference features (B, C, H/16, W/16) with
        feat_cur of the same batch, then the embedding upsample of both ->
        (emb_ref, emb_cur), each (B, embed_dim, H/8, W/8)."""
        new_ref, new_cur = self.model.forward_interaction(feat_ref.float(),
                                                          feat_cur.float())
        return (self.model.forward_upsample(new_ref),
                self.model.forward_upsample(new_cur))

    @torch.inference_mode()
    def propagate(self, emb_ref, emb_cur, lbs):
        """Correlation label propagation: emb (B, C, H8, W8), lbs (B, k, N8)
        -> one prior map per label map, (B * k, 1, H8, W8) float32."""
        b, c, h8, w8 = emb_cur.shape

        def tokens(e):
            return e.permute(0, 2, 3, 1).reshape(b, h8 * w8, c).float() \
                .contiguous()

        out = correlation_propagate_auto(tokens(emb_ref), tokens(emb_cur),
                                         lbs.contiguous())
        return out.reshape(-1, 1, h8, w8)

    @torch.inference_mode()
    def head(self, fpn_outs, priors_k):
        """The SOT head over the slots at batch S * K (S frames' FPN maps,
        K slots each, slot-major within a frame), each slot with its own
        prior pyramid; decode + NMS -> (flat head outputs, dets (S * K, 8,
        7), valid (S * K, 8), the kept rows' anchor indices (S * K, 8))."""
        SK, _, h8, w8 = priors_k.shape
        K = SK // fpn_outs[0].shape[0]
        priors = (priors_k,
                  resize_bilinear_torch(priors_k, h8 // 2, w8 // 2),
                  resize_bilinear_torch(priors_k, h8 // 4, w8 // 4))
        fpn_k = tuple(f.repeat_interleave(K, 0).contiguous(
            memory_format=torch.channels_last) for f in fpn_outs)
        raw = self.model.forward_head(
            fpn_k, tuple(p.to(f.dtype) for p, f in zip(priors, fpn_k)))
        flat = flatten_raw_outputs(raw, "sot")
        dets, valid, idx = postprocess_device(
            decode_flat(flat, STRIDES), num_classes=1,
            conf_thre=self.conf_thre, nms_thre=self.nms_thre,
            class_agnostic=True, n_cand=256, max_out=8, return_idx=True)
        return flat, dets, valid, idx

    @torch.inference_mode()
    def mask_decode(self, fpn_outs, flat, idx):
        """Each slot's mask probabilities (S * K, H, W) at the input size,
        from the controllers of its top detection's anchor (taken even when
        the slot kept no row, as in JAX) and its frame's mask features."""
        mask_feats, up_mask, _ = self.model.forward_mask_branch(fpn_outs)
        S = mask_feats.shape[0]
        rows = torch.arange(idx.shape[0], device=idx.device)
        anchors = idx[:, 0]
        if S > 1:      # frame s decodes its slots on its own mask features
            rows, anchors = rows.reshape(S, -1), anchors.reshape(S, -1)
        m = instance_mask_probs(mask_feats, up_mask, flat, rows, anchors,
                                STRIDES, self.use_raft, self.up_rate)
        # probabilities, not logits, go to the full input size
        d_up = self.input_size[0] // m.shape[-2]
        m = aligned_bilinear(m, d_up) if d_up > 1 else m
        return m.reshape(-1, *m.shape[-2:])

    def head_tail(self, fpn_outs, priors_k):
        """(dets (S * K, 8, 7), valid (S * K, 8), mask probabilities (S * K,
        H, W), or None without the mask branch)."""
        flat, dets, valid, idx = self.head(fpn_outs, priors_k)
        if self.model.head.mask_branch is None:
            return dets, valid, None
        return dets, valid, self.mask_decode(fpn_outs, flat, idx)

    def track_fn(self, img, feat_ref=None, lbs_ref=None):
        """The general path: per-slot references, the interaction batched
        over the (ref, cur) pairs of the slots. img (S, 3, H, W); feat_ref
        (S * K, C, H/16, W/16) and lbs_ref (S * K, 1, H/8 * W/8), frame s's
        slots at rows s * K ..; the cached ones (S = 1) when None."""
        feat_ref = self.feat_ref if feat_ref is None else feat_ref
        lbs_ref = self.lbs_ref if lbs_ref is None else lbs_ref
        fpn_outs, feat_cur = self.backbone(img)
        emb_ref, emb_cur = self.embed(
            feat_ref, feat_cur.repeat_interleave(self.K, 0))
        return self.head_tail(fpn_outs,
                              self.propagate(emb_ref, emb_cur, lbs_ref))

    def track_fn_shared(self, img, feat_ref1=None, lbs_ref=None):
        """The shared-reference path: one interaction a frame and one
        correlation whose value rows are its K label maps. img (S, 3, H,
        W); feat_ref1 (S, C, H/16, W/16); lbs_ref (S * K, 1, H/8 * W/8);
        the cached ones (S = 1) when None."""
        feat_ref1 = self.feat_ref1 if feat_ref1 is None else feat_ref1
        lbs_ref = self.lbs_ref if lbs_ref is None else lbs_ref
        fpn_outs, feat_cur = self.backbone(img)
        emb_ref, emb_cur = self.embed(feat_ref1, feat_cur)
        priors_k = self.propagate(emb_ref, emb_cur,
                                  lbs_ref.reshape(img.shape[0], self.K, -1))
        return self.head_tail(fpn_outs, priors_k)

    @torch.inference_mode()
    def aggregate(self, mask_probs, obj_valid):
        """Soft aggregation of (K, H, W) probabilities into an indexed map
        on the device: p / (1 - p) odds against the background's, argmax ->
        labels {0 = bg, k = slot k - 1}."""
        v = torch.as_tensor(obj_valid, dtype=torch.float32,
                            device=mask_probs.device)
        p = (mask_probs * v[:, None, None]).clamp(1e-7, 1 - 1e-7)
        bg = torch.prod(1.0 - p, 0, keepdim=True)
        odds = torch.cat([bg / (1 - bg + 1e-7), p / (1 - p)], 0)
        return (odds / odds.sum(0, keepdim=True)).argmax(0)

    # ------------------------------------------------------------ the API
    @torch.inference_mode()
    def initialize(self, image, mask, init_bboxes=None):
        """mask: (H, W) int labels (0 = bg, 1..n = objects). init_bboxes:
        optional {obj_id: [x, y, w, h]} per-object rects; defaults to each
        object's mask bounding box. The label priors are built from boxes,
        never from the mask itself."""
        img, r = self.preprocess(image)
        self._entry_overlay = {}
        all_ids = sorted(int(i) for i in np.unique(mask) if i != 0)
        if len(all_ids) > self.K:
            raise ValueError(
                f"sequence has {len(all_ids)} objects but max_objects="
                f"{self.K}; raise max_objects (silently dropping objects "
                f"would mis-score the benchmark)")
        self.obj_ids = all_ids
        lb = self._label_canvas(
            [(slot, (init_bboxes or {}).get(oid)
              or self._mask_bbox(mask == oid))
             for slot, oid in enumerate(self.obj_ids)], r)
        self.obj_valid = np.zeros((self.K,), np.float32)
        self.obj_valid[:len(self.obj_ids)] = 1.0
        feat16, self.lbs_ref = self.init_fn(img, lb)
        self.feat_ref1 = feat16
        self.feat_ref = feat16.expand(self.K, -1, -1, -1)
        # all objects share this entry frame: the shared-reference path
        self.shared_ref = True
        self.scale = r
        self.orig_shape = mask.shape

    @torch.inference_mode()
    def add_objects(self, image, mask, init_bboxes=None):
        """Register objects that enter mid-video: ids in `mask` not yet
        tracked get the next free slots, whose reference is this frame,
        with a box-rectangle label prior. mask: (H, W) int labels."""
        new_ids = [int(i) for i in np.unique(mask)
                   if i != 0 and int(i) not in self.obj_ids]
        if not new_ids:
            return
        img, r = self.preprocess(image)
        slots = []
        for oid in new_ids:
            slot = len(self.obj_ids) + len(slots)
            if slot >= self.K:
                raise ValueError(
                    f"object {oid} enters but all {self.K} slots are taken; "
                    f"raise max_objects (dropping it would mis-score)")
            slots.append((slot, oid))
        lb = self._label_canvas(
            [(slot, (init_bboxes or {}).get(oid)
              or self._mask_bbox(mask == oid)) for slot, oid in slots], r)
        feat16, lbs_new = self.init_fn(img, lb)
        self.shared_ref = False   # mixed entry frames: per-slot references
        # new tensors, not writes into the old state (which a caller, or
        # feat_ref1's expanded view, may still hold)
        self.feat_ref = self.feat_ref.clone()
        self.lbs_ref = self.lbs_ref.clone()
        for slot, oid in slots:
            self.feat_ref[slot] = feat16[0]
            self.lbs_ref[slot] = lbs_new[slot]
            self.obj_valid[slot] = 1.0
            self.obj_ids.append(oid)
            self._entry_overlay[oid] = (mask == oid)

    def track(self, image):
        """Returns (indexed mask (H_orig, W_orig) uint8 with the original
        object ids, per-object boxes dict)."""
        img, r = self.preprocess(image)
        fn = self.track_fn_shared if self.shared_ref else self.track_fn
        return self.postprocess_masks_host(*fn(img), r)

    @torch.inference_mode()
    def postprocess_masks_host(self, dets, valid, masks, r):
        """The tail of track(): the boxes dict, and the label map at the
        original resolution. Each slot's probabilities, stored as float16,
        are resized by 1/r (half-pixel bilinear), cropped to the original
        size, then soft-aggregated by `aggregate`; slots map to their
        object ids and entry-frame objects take their GT
        mask. Runs on the masks' device; fetches the packed detections and
        one uint8 map."""
        packed = torch.cat([dets.float(), valid[..., None].float()], -1)
        packed = packed.cpu().numpy()     # one fetch of dets and valid
        dets_np, valid_np = packed[..., :7], packed[..., 7] > 0.5
        boxes = {}
        for slot, oid in enumerate(self.obj_ids):
            d = dets_np[slot][valid_np[slot]]
            if len(d):
                boxes[oid] = (d[0, :4] / r).tolist()
        if masks is None:
            self._entry_overlay = {}
            return None, boxes
        # slots with no detection give a zero mask; objects on their entry
        # frame give their GT mask instead of a prediction
        agg_valid = self.obj_valid * valid_np.any(axis=1)
        for slot, oid in enumerate(self.obj_ids):
            if oid in self._entry_overlay:
                agg_valid[slot] = 0.0
        H, W = self.orig_shape
        # round, not floor: fp error in 1/r must not drop the last row or
        # column of the original resolution
        Hn = int(round(self.input_size[0] / r))
        Wn = int(round(self.input_size[1] / r))
        K = masks.shape[0]
        pr = F.interpolate(masks.half().float()[None], size=(Hn, Wn),
                           mode="bilinear", align_corners=False,
                           antialias=False)[0, :, :H, :W]
        probs = F.pad(pr, (0, W - pr.shape[2], 0, H - pr.shape[1]))
        # JAX's host tail argmaxes (bg, p_1 .. p_K) themselves; the odds are
        # monotone in them, so the labels differ only at near-ties
        lab = self.aggregate(probs, agg_valid)
        lut = torch.zeros(K + 1, dtype=torch.uint8)
        lut[1:1 + len(self.obj_ids)] = torch.tensor(self.obj_ids,
                                                    dtype=torch.uint8)
        out = lut.to(masks.device)[lab].cpu().numpy()
        for oid, gt in self._entry_overlay.items():
            out[gt] = oid
        self._entry_overlay = {}
        return out, boxes
