"""BDD100K datasets (port of unicorn_tpu/data/datasets/bdd.py): scalabel
json loaders for MOT (box_track_20) and MOTS (seg_track_20), 2-frame omni
training sampling, and the per-video eval dataset.

Scalabel is BDD's annotation schema: one json per split (or one per video)
holding frames with `videoName`, `frameIndex`, `name`, and `labels` [{id,
category, box2d{x1,y1,x2,y2}[, rle]}]. Layout under `data_dir` (the
official bdd100k download):
  images/track/{split}/{videoName}/{frame name}.jpg
  labels/box_track_20/{split}.json        (or {split}/ per-video jsons)
  labels/seg_track_20/rles/{split}.json   (MOTS, rle-carrying labels)
"""
from __future__ import annotations

import json
import os
import random
from collections import defaultdict

import numpy as np

from ...evaluators import rle as rle_codec
from ..image_io import imread

# the 8 scored classes of the BDD100K MOT / MOTS benchmark, in order
BDD_CLASSES = ("pedestrian", "rider", "car", "truck", "bus", "train",
               "motorcycle", "bicycle")
# annotated but unscored categories (scalabel's eval ignores them)
BDD_IGNORE = ("other person", "other vehicle", "trailer")
_CLS_INDEX = {c: i for i, c in enumerate(BDD_CLASSES)}


def load_scalabel(path):
    """Scalabel frames from a json file or a directory of per-video jsons:
    {videoName: [frame, ...]}, frames sorted by frameIndex, each its raw
    scalabel dict."""
    if os.path.isdir(path):
        frames = []
        for fn in sorted(os.listdir(path)):
            if fn.endswith(".json"):
                with open(os.path.join(path, fn)) as f:
                    frames.extend(json.load(f))
    else:
        with open(path) as f:
            frames = json.load(f)
        if isinstance(frames, dict) and "frames" in frames:
            frames = frames["frames"]
    videos = defaultdict(list)
    for f in frames:
        videos[f.get("videoName") or f["name"].rsplit("-", 1)[0]].append(f)
    for v in videos.values():
        v.sort(key=lambda f: f.get("frameIndex", 0))
    return dict(videos)


def parse_labels(frame, with_rle=False):
    """Scalabel frame -> (res (N, 6) [x1, y1, x2, y2, cls, tid], rles | None).
    Crowd boxes and unscored categories are dropped; track ids are the
    scalabel label ids (stable across frames); a MOTS label with only its
    rle gets the rle's tight box."""
    objs, rles = [], []
    for lab in frame.get("labels") or []:
        cat = lab.get("category")
        if cat not in _CLS_INDEX:
            continue
        if (lab.get("attributes") or {}).get("crowd", False):
            continue
        box = lab.get("box2d")
        rle = lab.get("rle") if with_rle else None
        if box is None and rle is None:
            continue
        if box is None:
            ys, xs = np.nonzero(rle_codec.decode(rle))
            if len(xs) == 0:
                continue
            box = {"x1": xs.min(), "y1": ys.min(),
                   "x2": xs.max() + 1, "y2": ys.max() + 1}
        objs.append([box["x1"], box["y1"], box["x2"], box["y2"],
                     _CLS_INDEX[cat], int(lab["id"])])
        if with_rle:
            rles.append(rle)
    res = np.asarray(objs, np.float32).reshape(-1, 6)
    return (res, rles) if with_rle else (res, None)


class BDDOmniDataset:
    """2-frame BDD MOT training sampling: pull_item_omni returns [(img,
    res (N, 6)), (img2, res2)], the second frame within max_gap frames of
    the first, track ids consistent across the two."""

    num_classes = len(BDD_CLASSES)

    def __init__(self, data_dir, split="train", max_gap=3, label_path=None,
                 img_root=None):
        self.data_dir = data_dir
        self.split = split
        self.img_root = img_root or os.path.join(data_dir, "images", "track",
                                                 split)
        self.videos = load_scalabel(label_path or self._default_labels(
            data_dir, split))
        self.index = [(v, i) for v, frames in sorted(self.videos.items())
                      for i in range(len(frames))]
        self.max_gap = max_gap

    @staticmethod
    def _default_labels(data_dir, split):
        base = os.path.join(data_dir, "labels", "box_track_20")
        f = base + f"/{split}.json"
        return f if os.path.exists(f) else os.path.join(base, split)

    def __len__(self):
        return len(self.index)

    def _load_frame(self, video, i):
        frame = self.videos[video][i]
        img = imread(os.path.join(self.img_root, video, frame["name"]))
        res, _ = parse_labels(frame)
        return img, res

    def pull_item_omni(self, seq_id, num_frames=2, *, rng: random.Random):
        video, i = self.index[seq_id % len(self.index)]
        frames = self.videos[video]
        j = rng.randint(max(0, i - self.max_gap),
                        min(len(frames) - 1, i + self.max_gap))
        out = [self._load_frame(video, i)]
        for _ in range(num_frames - 1):
            out.append(self._load_frame(video, j))
        return out


class BDDOmniMOTSDataset(BDDOmniDataset):
    """MOTS variant: per-instance masks decoded from the seg_track_20 rles;
    pull_item_omni returns [(img, res (N, 6), masks (H, W, N)), ...].
    Labels with a box but no rle are dropped (an all-zero mask would teach
    the mask head empty masks for visible objects)."""

    @staticmethod
    def _default_labels(data_dir, split):
        base = os.path.join(data_dir, "labels", "seg_track_20", "rles")
        f = base + f"/{split}.json"
        return f if os.path.exists(f) else os.path.join(base, split)

    def _load_frame(self, video, i):
        frame = self.videos[video][i]
        img = imread(os.path.join(self.img_root, video, frame["name"]))
        res, rles = parse_labels(frame, with_rle=True)
        has_rle = np.asarray([r is not None for r in rles], bool)
        if len(res) and not has_rle.all():
            res = res[has_rle]
            rles = [r for r in rles if r is not None]
        h, w = img.shape[:2]
        if len(res) == 0:
            return img, res, np.zeros((h, w, 0), np.uint8)
        return img, res, np.stack([rle_codec.decode(r) for r in rles], axis=2)


class BDDEvalDataset:
    """Frame-ordered BDD eval dataset (val / test split): pull_item(i) ->
    (img, res (N, 5), info, img_id) with info = (h, w, frame_index,
    video_id, "videoName/name")."""

    def __init__(self, data_dir, split="val", label_path=None, img_root=None,
                 img_size=(800, 1440), preproc=None):
        self.data_dir = data_dir
        self.split = split
        self.img_root = img_root or os.path.join(data_dir, "images", "track",
                                                 split)
        self.videos = load_scalabel(
            label_path or BDDOmniDataset._default_labels(data_dir, split))
        self.video_names = sorted(self.videos)
        self.index = [(v, i) for v in self.video_names
                      for i in range(len(self.videos[v]))]
        self.img_size = img_size
        self.preproc = preproc

    def __len__(self):
        return len(self.index)

    def gt_frames(self):
        """All scalabel gt frames, in eval order."""
        return [self.videos[v][i] for v, i in self.index]

    def pull_item(self, index):
        video, i = self.index[index]
        frame = self.videos[video][i]
        img = imread(os.path.join(self.img_root, video, frame["name"]))
        res, _ = parse_labels(frame)
        info = (img.shape[0], img.shape[1], frame.get("frameIndex", i),
                self.video_names.index(video), f"{video}/{frame['name']}")
        return img, res[:, :5], info, np.array([index])

    def __getitem__(self, index):
        img, target, info, img_id = self.pull_item(index)
        if self.preproc is not None:
            img, target = self.preproc(img, target, self.img_size)
        return img, target, info, img_id
