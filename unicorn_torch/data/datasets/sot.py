"""SOT video datasets: LaSOT / GOT-10k / TrackingNet / COCO-SOT (port of
unicorn_tpu/data/datasets/sot.py).

`pull_item_omni(seq_id, num_frames, rng)` returns num_frames of (HWC uint8
img, (1, 5) [xyxy, cls = 0]) sampled from one video (COCO-SOT duplicates a
static image). The pair is drawn from `rng` (a random.Random; the loader's)
in the order JAX's draws from the process-global `random`.
"""
from __future__ import annotations

import os
import random

import numpy as np

from ..image_io import imread


def _clip_box(box_xywh, h, w):
    x, y, bw, bh = box_xywh
    x1 = max(0.0, x)
    y1 = max(0.0, y)
    x2 = min(w, x + max(bw, 1.0))
    y2 = min(h, y + max(bh, 1.0))
    return np.asarray([[x1, y1, x2, y2, 0.0]], np.float32)


class SequenceSOTBase:
    """Shared frame-pair sampling: 2 frames within max_gap, counted in
    frame ids, so that occluded or absent stretches do not widen it."""

    max_gap = 200

    def __len__(self):
        return len(self.sequences)

    def _sample_pair(self, n_frames_avail, num_frames, rng: random.Random):
        """Dense case: list index == frame id (TrackingNet, COCOSOT)."""
        if n_frames_avail == 1:
            return [0] * num_frames
        a = rng.randint(0, n_frames_avail - 1)
        lo = max(0, a - self.max_gap)
        hi = min(n_frames_avail - 1, a + self.max_gap)
        b = rng.randint(lo, hi)
        return [a, b][:num_frames]

    def _sample_pair_ids(self, frame_ids, num_frames, rng: random.Random):
        """Sparse case: `frame_ids` is the sorted array of sample-able frame
        ids (visible frames). Returns positions into frame_ids whose
        frame-id distance is <= max_gap."""
        n = len(frame_ids)
        if n == 1:
            return [0] * num_frames
        a = rng.randint(0, n - 1)
        fa = int(frame_ids[a])
        lo = int(np.searchsorted(frame_ids, fa - self.max_gap, side="left"))
        hi = int(np.searchsorted(frame_ids, fa + self.max_gap, side="right")) - 1
        b = rng.randint(lo, hi)
        return [a, b][:num_frames]


class Lasot(SequenceSOTBase):
    """LaSOT train split. Layout: root/<class>/<class>-<idx>/img/*.jpg +
    groundtruth.txt (x,y,w,h) [+ full_occlusion.txt, out_of_view.txt]."""

    def __init__(self, root, split_ids=None, max_gap=200):
        self.root = root
        self.max_gap = max_gap
        self._info_cache: dict = {}
        self.sequences = []
        if os.path.isdir(root):
            for cls in sorted(os.listdir(root)):
                cdir = os.path.join(root, cls)
                if not os.path.isdir(cdir):
                    continue
                for seq in sorted(os.listdir(cdir)):
                    if seq.startswith(cls + "-"):
                        self.sequences.append(os.path.join(cdir, seq))

    def _seq_info(self, seq_id):
        """(gt, visible frame ids), parsed once a sequence."""
        cached = self._info_cache.get(seq_id)
        if cached is not None:
            return cached
        seq_dir = self.sequences[seq_id]
        gt = np.loadtxt(os.path.join(seq_dir, "groundtruth.txt"),
                        delimiter=",").astype(np.float32)
        occ_f = os.path.join(seq_dir, "full_occlusion.txt")
        oov_f = os.path.join(seq_dir, "out_of_view.txt")
        occ = np.loadtxt(occ_f, delimiter=",") if os.path.exists(occ_f) \
            else None
        oov = np.loadtxt(oov_f, delimiter=",") if os.path.exists(oov_f) \
            else None
        visible = (gt[:, 2] > 0) & (gt[:, 3] > 0)
        if occ is not None:
            visible &= occ == 0
        if oov is not None:
            visible &= oov == 0
        vis_idx = np.flatnonzero(visible)
        if len(vis_idx) == 0:
            vis_idx = np.arange(len(gt))
        self._info_cache[seq_id] = (gt, vis_idx)
        return gt, vis_idx

    def pull_item_omni(self, seq_id, num_frames=2, *, rng: random.Random):
        seq_dir = self.sequences[seq_id]
        gt, vis_idx = self._seq_info(seq_id)
        frames = []
        for i in self._sample_pair_ids(vis_idx, num_frames, rng):
            fi = int(vis_idx[i])
            img = imread(os.path.join(seq_dir, "img", f"{fi + 1:08d}.jpg"))
            frames.append((img, _clip_box(gt[fi], img.shape[0], img.shape[1])))
        return frames


class Got10k(SequenceSOTBase):
    """GOT-10k train split. Layout: root/GOT-10k_Train_XXXXXX/{*.jpg,
    groundtruth.txt, absence.label} [+ root/list.txt]."""

    def __init__(self, root, max_gap=200):
        self.root = root
        self.max_gap = max_gap
        self._info_cache: dict = {}
        self.sequences = []
        if os.path.isdir(root):
            list_file = os.path.join(root, "list.txt")
            if os.path.exists(list_file):
                with open(list_file) as f:
                    self.sequences = [os.path.join(root, l.strip())
                                      for l in f if l.strip()]
            else:
                self.sequences = [
                    os.path.join(root, d) for d in sorted(os.listdir(root))
                    if os.path.isdir(os.path.join(root, d))]

    def _seq_info(self, seq_id):
        """(gt, visible frame ids), parsed once a sequence."""
        cached = self._info_cache.get(seq_id)
        if cached is not None:
            return cached
        seq_dir = self.sequences[seq_id]
        gt = np.loadtxt(os.path.join(seq_dir, "groundtruth.txt"),
                        delimiter=",").reshape(-1, 4).astype(np.float32)
        absence_f = os.path.join(seq_dir, "absence.label")
        visible = (gt[:, 2] > 0) & (gt[:, 3] > 0)
        if os.path.exists(absence_f):
            visible &= np.loadtxt(absence_f) == 0
        vis_idx = np.flatnonzero(visible)
        if len(vis_idx) == 0:
            vis_idx = np.arange(len(gt))
        self._info_cache[seq_id] = (gt, vis_idx)
        return gt, vis_idx

    def pull_item_omni(self, seq_id, num_frames=2, *, rng: random.Random):
        seq_dir = self.sequences[seq_id]
        gt, vis_idx = self._seq_info(seq_id)
        frames = []
        for i in self._sample_pair_ids(vis_idx, num_frames, rng):
            fi = int(vis_idx[i])
            img = imread(os.path.join(seq_dir, f"{fi + 1:08d}.jpg"))
            frames.append((img, _clip_box(gt[fi], img.shape[0], img.shape[1])))
        return frames


class TrackingNet(SequenceSOTBase):
    """TrackingNet train chunks. Layout: root/TRAIN_k/frames/<seq>/<i>.jpg
    + anno/<seq>.txt."""

    def __init__(self, root, set_ids=range(12), max_gap=200):
        self.root = root
        self.max_gap = max_gap
        self._info_cache: dict = {}
        self.sequences = []  # (chunk_dir, seq_name)
        for k in set_ids:
            anno_dir = os.path.join(root, f"TRAIN_{k}", "anno")
            if not os.path.isdir(anno_dir):
                continue
            for f in sorted(os.listdir(anno_dir)):
                if f.endswith(".txt"):
                    self.sequences.append((os.path.join(root, f"TRAIN_{k}"),
                                           f[:-4]))

    def pull_item_omni(self, seq_id, num_frames=2, *, rng: random.Random):
        chunk, name = self.sequences[seq_id]
        gt = self._info_cache.get(seq_id)
        if gt is None:
            gt = np.loadtxt(os.path.join(chunk, "anno", name + ".txt"),
                            delimiter=",").reshape(-1, 4).astype(np.float32)
            self._info_cache[seq_id] = gt
        frames = []
        for i in self._sample_pair(len(gt), num_frames, rng):
            img = imread(os.path.join(chunk, "frames", name, f"{i}.jpg"))
            frames.append((img, _clip_box(gt[i], img.shape[0], img.shape[1])))
        return frames


class COCOSOT(SequenceSOTBase):
    """Static-image SOT: one random instance of a COCO image duplicated as
    a 2-frame video, each frame its own array (the HSV jitter works in
    place, per frame)."""

    def __init__(self, coco_dataset):
        self.ds = coco_dataset
        # keep only images with at least one box
        self.sequences = [i for i in range(len(coco_dataset))
                          if len(coco_dataset.annotations[i][0]) > 0]

    def pull_item_omni(self, seq_id, num_frames=2, *, rng: random.Random):
        idx = self.sequences[seq_id]
        img, res, _, _ = self.ds.pull_item(idx)
        k = rng.randint(0, len(res) - 1)
        box = res[k: k + 1].copy()
        box[:, 4] = 0.0  # class 0 for SOT
        return [(img if i == 0 else img.copy(), box.copy())
                for i in range(num_frames)]
