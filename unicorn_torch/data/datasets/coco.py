"""COCO-format detection dataset (port of unicorn_tpu/data/datasets/coco.py):
its own json parsing (no pycocotools), frames read by data.image_io.

`pull_item(i)` -> (img HWC uint8 BGR, res (N, 5) [x1, y1, x2, y2, cls],
(h, w), id); `get_item(i, rng=, np_rng=)` passes it through a preproc
that draws (DetLoader's interface). A frame that cannot be read raises (FileNotFoundError /
ValueError) where the JAX package asserts.
"""
from __future__ import annotations

import json
import os
from collections import defaultdict

import numpy as np

from ..image_io import imread


class COCOJson:
    """Minimal pycocotools.COCO replacement: images / annotations / cats."""

    def __init__(self, ann_file: str):
        with open(ann_file) as f:
            d = json.load(f)
        self.dataset = d
        self.imgs = {im["id"]: im for im in d.get("images", [])}
        self.anns = {a["id"]: a for a in d.get("annotations", [])}
        self.cats = {c["id"]: c for c in d.get("categories", [])}
        self.img_to_anns = defaultdict(list)
        for a in d.get("annotations", []):
            self.img_to_anns[a["image_id"]].append(a)

    def get_img_ids(self):
        return sorted(self.imgs.keys())

    def get_cat_ids(self):
        return sorted(self.cats.keys())

    def load_anns_for_img(self, img_id):
        return self.img_to_anns.get(img_id, [])


class COCODataset:
    """Detection dataset over a COCO-format json + image dir."""

    def __init__(self, data_dir: str, json_file: str = "instances_train2017.json",
                 name: str = "train2017", img_size=(640, 640), preproc=None,
                 min_box: float = 0.0):
        self.data_dir = data_dir
        self.json_file = json_file
        self.coco = COCOJson(os.path.join(data_dir, "annotations", json_file))
        self.ids = self.coco.get_img_ids()
        self.class_ids = self.coco.get_cat_ids()
        self.name = name
        self.img_size = img_size
        self.preproc = preproc
        self.min_box = min_box
        self.annotations = [self._load_anno(i) for i in self.ids]

    def __len__(self):
        return len(self.ids)

    def _load_anno(self, img_id):
        im = self.coco.imgs[img_id]
        width, height = im["width"], im["height"]
        objs = []
        for a in self.coco.load_anns_for_img(img_id):
            if a.get("iscrowd", 0):
                continue
            x, y, w, h = a["bbox"]
            x1 = max(0.0, x)
            y1 = max(0.0, y)
            x2 = min(width, x + w)
            y2 = min(height, y + h)
            if a.get("area", w * h) > 0 and x2 >= x1 and y2 >= y1:
                objs.append([x1, y1, x2, y2,
                             self.class_ids.index(a["category_id"])])
        res = np.asarray(objs, np.float32).reshape(-1, 5)
        file_name = im.get("file_name", f"{img_id:012d}.jpg")
        return res, (height, width), file_name

    def load_image(self, index):
        _, _, file_name = self.annotations[index]
        return imread(os.path.join(self.data_dir, self.name, file_name))

    def pull_item(self, index):
        res, img_info, _ = self.annotations[index]
        img = self.load_image(index)
        return img, res.copy(), img_info, np.array([self.ids[index]])

    def get_item(self, index, *, rng, np_rng):
        """pull_item through `preproc`, which draws from the generators (a
        TrainTransform)."""
        img, target, img_info, img_id = self.pull_item(index)
        img, target = self.preproc(img, target, self.img_size, rng=rng,
                                   np_rng=np_rng)
        return img, target, img_info, img_id

    def __getitem__(self, index):
        img, target, img_info, img_id = self.pull_item(index)
        if self.preproc is not None:
            img, target = self.preproc(img, target, self.img_size)
        return img, target, img_info, img_id
