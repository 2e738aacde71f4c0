"""Pascal VOC detection dataset (port of unicorn_tpu/data/datasets/voc.py):
a native XML parser, frames read by data.image_io. pull_item(i) -> (img,
res (N, 5) [x1, y1, x2, y2, cls], (h, w), img_id).
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from ..image_io import imread

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)
_CLS_INDEX = {c: i for i, c in enumerate(VOC_CLASSES)}


def parse_voc_xml(path, keep_difficult=True):
    """VOC Annotations/<id>.xml -> (res (N, 5), (h, w)): 1-based inclusive
    pixel boxes shifted to 0-based [x1, y1, x2, y2]."""
    root = ET.parse(path).getroot()
    size = root.find("size")
    h = int(size.find("height").text)
    w = int(size.find("width").text)
    objs = []
    for obj in root.iter("object"):
        difficult = obj.find("difficult")
        if not keep_difficult and difficult is not None \
                and int(difficult.text) == 1:
            continue
        name = obj.find("name").text.strip().lower()
        if name not in _CLS_INDEX:
            continue
        bb = obj.find("bndbox")
        box = [float(bb.find(k).text) - (1 if k in ("xmin", "ymin") else 0)
               for k in ("xmin", "ymin", "xmax", "ymax")]
        objs.append(box + [_CLS_INDEX[name]])
    return np.asarray(objs, np.float32).reshape(-1, 5), (h, w)


class VOCDetection:
    """VOC0712-style detection dataset:
    data_dir/VOC{year}/{Annotations,JPEGImages,ImageSets/Main}. A missing
    split file raises."""

    def __init__(self, data_dir,
                 image_sets=(("2007", "trainval"), ("2012", "trainval")),
                 img_size=(640, 640), preproc=None, keep_difficult=True):
        self.root = data_dir
        self.img_size = img_size
        self.preproc = preproc
        self.keep_difficult = keep_difficult
        self.ids = []
        for year, name in image_sets:
            rootpath = os.path.join(self.root, "VOC" + year)
            set_file = os.path.join(rootpath, "ImageSets", "Main",
                                    name + ".txt")
            if not os.path.exists(set_file):
                raise FileNotFoundError(f"VOC split file missing: {set_file}")
            with open(set_file) as f:
                self.ids += [(rootpath, l.strip()) for l in f if l.strip()]
        self.annotations = [self._load_anno(i) for i in range(len(self.ids))]
        self.class_ids = list(range(len(VOC_CLASSES)))

    def __len__(self):
        return len(self.ids)

    def _load_anno(self, index):
        rootpath, img_id = self.ids[index]
        return parse_voc_xml(os.path.join(rootpath, "Annotations",
                                          img_id + ".xml"),
                             self.keep_difficult)

    def load_anno(self, index):
        return self.annotations[index][0]

    def load_image(self, index):
        rootpath, img_id = self.ids[index]
        return imread(os.path.join(rootpath, "JPEGImages", img_id + ".jpg"))

    def pull_item(self, index):
        res, (h, w) = self.annotations[index]
        img = self.load_image(index)
        return img, res.copy(), (h, w), np.array([index])

    def __getitem__(self, index):
        img, target, img_info, img_id = self.pull_item(index)
        if self.preproc is not None:
            img, target = self.preproc(img, target, self.img_size)
        return img, target, img_info, img_id
