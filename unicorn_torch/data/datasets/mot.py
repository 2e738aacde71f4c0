"""MOT datasets (port of unicorn_tpu/data/datasets/mot.py): 2-frame omni
training sampling from COCO-format video annotations (MOT17 / CrowdHuman
/ CityPersons / ETHZ) and the per-video eval dataset. Video jsons carry
`video_id` + `frame_id` per image and `track_id` per annotation.
"""
from __future__ import annotations

import bisect
import os
import random
from collections import defaultdict

import numpy as np

from ..image_io import imread
from .coco import COCOJson


class MOTOmniDataset:
    """2-frame MOT training sampling. Static-image datasets (CrowdHuman
    etc.) duplicate the frame; video datasets draw a second frame within
    max_gap frame ids from the same video."""

    def __init__(self, data_dir, json_file, name="train", max_gap=30,
                 img_root=None):
        self.data_dir = data_dir
        self.coco = COCOJson(os.path.join(data_dir, "annotations", json_file))
        self.name = name
        self.img_root = img_root or os.path.join(data_dir, name)
        self.max_gap = max_gap
        self.ids = self.coco.get_img_ids()
        self.class_ids = self.coco.get_cat_ids()
        # images by video, for temporal sampling
        self.video_frames = defaultdict(list)  # video_id -> [(frame_id, img_id)]
        for img_id in self.ids:
            im = self.coco.imgs[img_id]
            self.video_frames[im.get("video_id", -1)].append(
                (im.get("frame_id", 0), img_id))
        for v in self.video_frames.values():
            v.sort()

    def __len__(self):
        return len(self.ids)

    def _load(self, img_id):
        im = self.coco.imgs[img_id]
        img = imread(os.path.join(self.img_root, im["file_name"]))
        objs = []
        for a in self.coco.load_anns_for_img(img_id):
            if a.get("iscrowd", 0):
                continue
            x, y, w, h = a["bbox"]
            cls = self.class_ids.index(a["category_id"])
            objs.append([x, y, x + w, y + h, cls, a.get("track_id", -1)])
        return img, np.asarray(objs, np.float32).reshape(-1, 6)

    def pull_item_omni(self, seq_id, num_frames=2, *, rng: random.Random):
        img_id = self.ids[seq_id]
        im = self.coco.imgs[img_id]
        vid = im.get("video_id", -1)
        frames_avail = self.video_frames[vid]
        if len(frames_avail) <= 1 or vid == -1:
            img, res = self._load(img_id)
            if res[:, 5].max(initial=-1) < 0:
                # static image: unique track ids
                res[:, 5] = np.arange(1, len(res) + 1)
            return [(img.copy(), res.copy()) for _ in range(num_frames)]
        fid = im.get("frame_id", 0)
        fids = [f for f, _ in frames_avail]
        pos = fids.index(fid)
        lo = bisect.bisect_left(fids, fid - self.max_gap)
        hi = bisect.bisect_right(fids, fid + self.max_gap) - 1
        pos2 = rng.randint(lo, hi)
        return [self._load(frames_avail[p][1])
                for p in [pos, pos2][:num_frames]]


class MOTEvalDataset:
    """Frame-ordered eval dataset over a COCO-format video json.
    pull_item -> (img, target (N, 5), img_info, img_id) with img_info =
    (height, width, frame_id, video_id, file_name)."""

    def __init__(self, data_dir, json_file="test.json", name="test",
                 img_size=(800, 1280), preproc=None):
        self.data_dir = data_dir
        self.coco = COCOJson(os.path.join(data_dir, "annotations", json_file))
        self.name = name
        self.img_size = img_size
        self.preproc = preproc
        self.ids = self.coco.get_img_ids()
        self.class_ids = self.coco.get_cat_ids()

    def __len__(self):
        return len(self.ids)

    def pull_item(self, index):
        img_id = self.ids[index]
        im = self.coco.imgs[img_id]
        img = imread(os.path.join(self.data_dir, self.name, im["file_name"]))
        objs = []
        for a in self.coco.load_anns_for_img(img_id):
            x, y, w, h = a["bbox"]
            objs.append([x, y, x + w, y + h,
                         self.class_ids.index(a["category_id"])])
        res = np.asarray(objs, np.float32).reshape(-1, 5)
        info = (im["height"], im["width"], im.get("frame_id", 0),
                im.get("video_id", -1), im["file_name"])
        return img, res, info, np.array([img_id])

    def __getitem__(self, index):
        img, target, info, img_id = self.pull_item(index)
        if self.preproc is not None:
            img, target = self.preproc(img, target, self.img_size)
        return img, target, info, img_id
