"""VOS / instance-mask training datasets (port of
unicorn_tpu/data/datasets/vos.py): YouTube-VOS, DAVIS, saliency sets,
COCO instances as MOTS samples and MOTS-Challenge videos.

`pull_item_omni(seq_id, num_frames, rng)` returns frames of (img HWC uint8,
res (N, 6) [xyxy, cls, tid], masks (H, W, N) uint8). Palette annotations
are read as their indices (image_io.read_indexed_mask), COCO polygons
filled by image_io.fill_poly (cv2.fillPoly's pixels), RLE decoded by
evaluators.rle. The draws come from `rng` (a random.Random; the loader's)
in the order JAX's come from the process-global `random`.
"""
from __future__ import annotations

import json
import os
import random
from collections import defaultdict

import numpy as np

from ...evaluators import rle as rle_codec
from ..image_io import IMREAD_GRAYSCALE, fill_poly, imread, read_indexed_mask
from .coco import COCOJson


def _boxes_from_masks(masks):
    """(H, W, N) -> (N, 4) xyxy tight boxes."""
    out = []
    for k in range(masks.shape[2]):
        ys, xs = np.nonzero(masks[:, :, k])
        if len(xs) == 0:
            out.append([0, 0, 0, 0])
        else:
            out.append([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
    return np.asarray(out, np.float32)


def _indexed_frame(img_path, ann_path):
    """(img, res (N, 6), masks (H, W, N)) of a frame with a palette mask:
    one object a non-zero index, its id the track id, class 0."""
    img = imread(img_path)
    ann = read_indexed_mask(ann_path)
    obj_ids = sorted(int(i) for i in np.unique(ann) if i != 0)
    masks = np.stack([(ann == oid).astype(np.uint8) for oid in obj_ids],
                     axis=2) if obj_ids else np.zeros(ann.shape + (0,),
                                                      np.uint8)
    boxes = _boxes_from_masks(masks)
    res = np.concatenate([
        boxes, np.zeros((len(obj_ids), 1), np.float32),
        np.asarray(obj_ids, np.float32).reshape(-1, 1),
    ], axis=1) if obj_ids else np.zeros((0, 6), np.float32)
    return img, res, masks


class _VideoPairs:
    """Two annotated frames of a sequence, the second within max_gap of
    the first (in positions of the sorted annotation files)."""

    def __len__(self):
        return len(self.sequences)

    def _dirs(self, name):
        raise NotImplementedError

    def pull_item_omni(self, seq_id, num_frames=2, *, rng: random.Random):
        jdir, adir = self._dirs(self.sequences[seq_id])
        files = self._files_cache.get(seq_id)
        if files is None:  # immutable directory listing: once a sequence
            files = sorted(os.listdir(adir))
            self._files_cache[seq_id] = files
        a = rng.randint(0, len(files) - 1)
        b = rng.randint(max(0, a - self.max_gap),
                        min(len(files) - 1, a + self.max_gap))
        return [_indexed_frame(
            os.path.join(jdir, os.path.splitext(files[i])[0] + ".jpg"),
            os.path.join(adir, files[i])) for i in [a, b][:num_frames]]


class YoutubeVOSDataset(_VideoPairs):
    """YouTube-VOS 2018 / 2019 train. Layout: root/train/JPEGImages/<seq>/
    *.jpg + Annotations/<seq>/*.png [+ meta.json]."""

    def __init__(self, root, split="train", max_gap=30):
        self.root = os.path.join(root, split)
        self.max_gap = max_gap
        self._files_cache: dict = {}
        meta_path = os.path.join(self.root, "meta.json")
        self.sequences = []
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                self.sequences = sorted(json.load(f)["videos"].keys())
        elif os.path.isdir(os.path.join(self.root, "JPEGImages")):
            self.sequences = sorted(os.listdir(
                os.path.join(self.root, "JPEGImages")))

    def _dirs(self, name):
        return (os.path.join(self.root, "JPEGImages", name),
                os.path.join(self.root, "Annotations", name))


class DAVISTrainDataset(_VideoPairs):
    """DAVIS 2017 train: root/JPEGImages/480p + Annotations/480p +
    ImageSets/2017/train.txt."""

    def __init__(self, root, year="2017", split="train", max_gap=30):
        self.root = root
        self.max_gap = max_gap
        self._files_cache: dict = {}
        set_file = os.path.join(root, "ImageSets", year, f"{split}.txt")
        self.sequences = []
        if os.path.exists(set_file):
            with open(set_file) as f:
                self.sequences = [l.strip() for l in f]

    def _dirs(self, name):
        return (os.path.join(self.root, "JPEGImages", "480p", name),
                os.path.join(self.root, "Annotations", "480p", name))


class SaliencyDataset:
    """Saliency datasets (DUTS etc.): an image and its binary mask (read
    as gray, > 127), the box from the mask, duplicated as a 2-frame video.
    Layout: root/image/*.jpg + mask/*.png."""

    def __init__(self, root):
        self.root = root
        img_dir = os.path.join(root, "image")
        self.items = sorted(os.listdir(img_dir)) if os.path.isdir(img_dir) \
            else []

    def __len__(self):
        return len(self.items)

    def pull_item_omni(self, seq_id, num_frames=2, *, rng: random.Random):
        del rng  # nothing drawn
        stem = os.path.splitext(self.items[seq_id])[0]
        img = imread(os.path.join(self.root, "image", self.items[seq_id]))
        mask = imread(os.path.join(self.root, "mask", stem + ".png"),
                      IMREAD_GRAYSCALE)
        m = (mask > 127).astype(np.uint8)[:, :, None]
        boxes = _boxes_from_masks(m)
        res = np.concatenate([boxes, np.zeros((1, 1), np.float32),
                              np.ones((1, 1), np.float32)], axis=1)
        return [(img.copy(), res.copy(), m.copy()) for _ in range(num_frames)]


class COCOMOTSDataset:
    """COCO instances as static 2-frame MOTS samples: polygons / RLE
    decoded to masks, per-instance track ids."""

    def __init__(self, data_dir, json_file="instances_train2017.json",
                 name="train2017", person_only=False):
        self.data_dir = data_dir
        self.coco = COCOJson(os.path.join(data_dir, "annotations", json_file))
        self.name = name
        self.class_ids = self.coco.get_cat_ids()
        self.person_only = person_only
        self.ids = [i for i in self.coco.get_img_ids()
                    if self.coco.load_anns_for_img(i)]

    def __len__(self):
        return len(self.ids)

    def _decode_seg(self, a, h, w):
        seg = a.get("segmentation")
        if seg is None:
            return None
        if isinstance(seg, dict):
            return rle_codec.decode(seg)
        mask = np.zeros((h, w), np.uint8)
        for poly in seg:  # one fill a polygon, as the JAX package does
            fill_poly(mask, [np.asarray(poly, np.float64).reshape(-1, 2)], 1)
        return mask

    def pull_item_omni(self, seq_id, num_frames=2, *, rng: random.Random):
        del rng  # nothing drawn
        img_id = self.ids[seq_id]
        im = self.coco.imgs[img_id]
        img = imread(os.path.join(self.data_dir, self.name, im["file_name"]))
        h, w = im["height"], im["width"]
        objs, masks = [], []
        tid = 1
        for a in self.coco.load_anns_for_img(img_id):
            if a.get("iscrowd", 0):
                continue
            cls = self.class_ids.index(a["category_id"])
            if self.person_only and cls != 0:
                continue
            m = self._decode_seg(a, h, w)
            if m is None or m.sum() == 0:
                continue
            x, y, bw, bh = a["bbox"]
            objs.append([x, y, x + bw, y + bh, cls, tid])
            masks.append(m)
            tid += 1
        if not objs:
            res = np.zeros((0, 6), np.float32)
            mk = np.zeros((h, w, 0), np.uint8)
        else:
            res = np.asarray(objs, np.float32)
            mk = np.stack(masks, axis=2)
        return [(img.copy(), res.copy(), mk.copy()) for _ in range(num_frames)]


class MOTSVideoDataset:
    """MOTS-Challenge video training: 2-frame samples with per-instance RLE
    masks and persistent track ids, from the COCO-video json of
    `tools/convert_datasets.py mots` (RLE segmentations + video_id /
    frame_id / track_id). The second frame is any annotated frame within
    max_gap frame ids."""

    def __init__(self, data_dir, json_file="train_mots.json", max_gap=30):
        self.data_dir = data_dir
        self.coco = COCOJson(os.path.join(data_dir, "annotations", json_file))
        self.max_gap = max_gap
        # frames by video, only those with an annotation
        self.video_frames = defaultdict(list)
        for img_id in self.coco.get_img_ids():
            im = self.coco.imgs[img_id]
            if self.coco.load_anns_for_img(img_id):
                self.video_frames[im.get("video_id", -1)].append(
                    (im.get("frame_id", 0), img_id))
        for v in self.video_frames.values():
            v.sort()
        self.ids = [i for v in self.video_frames.values() for _, i in v]

    def __len__(self):
        return len(self.ids)

    def _load(self, img_id):
        im = self.coco.imgs[img_id]
        img = imread(os.path.join(self.data_dir, im["file_name"]))
        h, w = im["height"], im["width"]
        objs, masks = [], []
        for a in self.coco.load_anns_for_img(img_id):
            if a.get("iscrowd", 0):
                continue
            m = a.get("segmentation")
            m = rle_codec.decode(m) if isinstance(m, dict) else None
            if m is None or m.sum() == 0:
                continue
            x, y, bw, bh = a["bbox"]
            objs.append([x, y, x + bw, y + bh, 0, a.get("track_id", -1)])
            masks.append(m)
        if not objs:
            return img, np.zeros((0, 6), np.float32), np.zeros((h, w, 0),
                                                               np.uint8)
        return img, np.asarray(objs, np.float32), np.stack(masks, axis=2)

    def pull_item_omni(self, seq_id, num_frames=2, *, rng: random.Random):
        img_id = self.ids[seq_id]
        im = self.coco.imgs[img_id]
        frames_avail = self.video_frames[im.get("video_id", -1)]
        fid = im.get("frame_id", 0)
        cands = [i for f, i in frames_avail if abs(f - fid) <= self.max_gap]
        out = [self._load(img_id)]
        for _ in range(num_frames - 1):
            out.append(self._load(rng.choice(cands)))
        return out
