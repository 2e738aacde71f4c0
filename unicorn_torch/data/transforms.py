"""Augmentations and train / val transforms on the host in numpy (port of
unicorn_tpu/data/transforms.py, which converts colours and resizes with
cv2). Images stay HWC; labels are [cls, cx, cy, w, h, tid] padded to
max_labels.

Colour. `bgr2hsv` is cv2.COLOR_BGR2HSV on uint8 (hue on 0-180) as OpenCV
computes it, in integers with its 12-bit division tables: equal to cv2 on
all 2**24 colours. `hsv2bgr` is cv2.COLOR_HSV2BGR on uint8 as OpenCV 5.0
computes it in float32, 1 - s * h as one fused multiply-add, the result
times 255 truncated by its vector code (blocks of 32 pixels of a row on an
AVX2 CPU) and rounded to nearest by its scalar code (the row's last W mod
32 pixels): `augment_hsv` follows the same split, and is then equal to cv2
on all 180 * 256 * 256 inputs in either position.
`augment_hsv` runs both conversions as lookups in tables of every
colour that the two functions build once a process (`_colour_tables`,
about 4 s and 114 MB): 0.17 s for a 1080x1920 frame where the arithmetic
takes 0.5 s.

Randomness. The JAX package draws from the process-global `random` (the
HSV and flip coin tosses) and `np.random` (the HSV gains); here every
transform takes the generators, `rng` (random.Random) and `np_rng`
(np.random.RandomState), and draws from them in the same order, so
generators seeded as JAX's `seed_everything(s)` seeds the globals give
the same draws.
"""
from __future__ import annotations

import functools
import random
import threading

import numpy as np

from .preproc import letterbox, letterbox_mask, resize_linear

_SHIFT = 12
_I = np.arange(256, dtype=np.float64)
# OpenCV's division tables of RGB2HSV_b, saturate_cast (round half even)
_SDIV = np.concatenate([[0], np.rint((255 << _SHIFT) / _I[1:])]
                       ).astype(np.int32)
_HDIV = np.concatenate([[0], np.rint((180 << _SHIFT) / (6.0 * _I[1:]))]
                       ).astype(np.int32)
# HSV2RGB's (b, g, r) <- (v, tab1, tab2, tab3) per hue sector
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])


def bgr2hsv(img: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 BGR -> (..., 3) uint8 HSV, hue on 0-180 (cv2's)."""
    x = img.astype(np.int32)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    s = (diff * _SDIV[v] + (1 << (_SHIFT - 1))) >> _SHIFT
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + (1 << (_SHIFT - 1))) >> _SHIFT
    h += np.where(h < 0, 180, 0)
    return np.stack([h, s, v], -1).astype(np.uint8)


def _one_minus_product(a, b):
    """1 - a * b in float32, rounded once (a fused multiply-add)."""
    return (1.0 - a.astype(np.float64) * b).astype(np.float32)


def hsv2bgr(hsv: np.ndarray, vector: bool = True) -> np.ndarray:
    """(..., 3) uint8 HSV (hue on 0-180) -> (..., 3) uint8 BGR, as cv2's
    vector code (vector=True: truncated) or its scalar code (rounded to
    nearest) computes it."""
    f32 = np.float32
    inv = f32(1.0 / 255.0)
    h = hsv[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = hsv[..., 1].astype(f32) * inv
    v = hsv[..., 2].astype(f32) * inv
    sector = np.trunc(h)
    h = h - sector
    tab = np.stack([v, v * (f32(1) - s), v * _one_minus_product(s, h),
                    v * _one_minus_product(s, f32(1) - h)], -1)
    out = np.take_along_axis(tab, _SECTORS[sector.astype(np.int64) % 6], -1)
    out = out * f32(255)
    out = np.trunc(out) if vector else np.rint(out)
    return out.clip(0, 255).astype(np.uint8)


def xyxy2cxcywh(boxes):
    out = boxes.copy()
    out[:, 0] = (boxes[:, 0] + boxes[:, 2]) / 2
    out[:, 1] = (boxes[:, 1] + boxes[:, 3]) / 2
    out[:, 2] = boxes[:, 2] - boxes[:, 0]
    out[:, 3] = boxes[:, 3] - boxes[:, 1]
    return out


_TABLES_LOCK = threading.Lock()


def _colour_tables():
    """(hsv_of, bgr_of): uint32 tables of every colour. hsv_of[b | g << 8
    | r << 16] = h | s << 8 | v << 16 (bgr2hsv); bgr_of[h << 16 | s << 8 |
    v] = b | g << 8 | r << 16 (hsv2bgr's vector code, hue below 180).
    Built once a process: the loader's worker threads that ask first wait
    for the one build."""
    with _TABLES_LOCK:
        return _build_colour_tables()


@functools.lru_cache(maxsize=None)
def _build_colour_tables():
    """`_colour_tables`' tables, built in chunks of 2**20 colours to bound
    the temporaries."""
    def build(n, unpack, fn, pack):
        out = np.empty(n, np.uint32)
        for lo in range(0, n, 1 << 20):
            code = np.arange(lo, min(lo + (1 << 20), n), dtype=np.uint32)
            y = fn(unpack(code)).astype(np.uint32)
            out[lo:lo + len(code)] = pack(y)
        return out

    def bytes_low_first(c):
        return np.stack([c & 255, (c >> 8) & 255, c >> 16],
                        -1).astype(np.uint8)

    def pack_low_first(y):
        return y[:, 0] | (y[:, 1] << 8) | (y[:, 2] << 16)

    hsv_of = build(1 << 24, bytes_low_first, bgr2hsv, pack_low_first)
    bgr_of = build(180 << 16, lambda c: bytes_low_first(c)[:, ::-1],
                   hsv2bgr, pack_low_first)
    return hsv_of, bgr_of


def augment_hsv(img, np_rng: np.random.RandomState, hgain=0.015, sgain=0.7,
                vgain=0.4):
    """In-place HSV jitter of an (H, W, 3) uint8 BGR image: one gain each
    for hue, saturation and value, applied through lookup tables (cv2's
    BGR -> HSV -> LUT -> BGR, row by row in blocks of 32 pixels).

    The last W mod 32 pixels of each row go through `hsv2bgr`'s scalar
    (rounding) code on purpose, as cv2 converts them: the tables alone
    truncate there, one level off on about a third of those values,
    which at widths such as 854 or 120 is more than the 1% share of
    differing values that tests/test_torch_port_data.py holds
    `augment_hsv` (`test_augment_hsv_matches_jax`, widths 120 and 31)
    and the loaders' batches to."""
    r = np_rng.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
    x = np.arange(0, 256, dtype=np.int16)
    lut_hue = ((x * r[0]) % 180).astype(np.uint8).astype(np.uint32)
    lut_sat = np.clip(x * r[1], 0, 255).astype(np.uint8).astype(np.uint32)
    lut_val = np.clip(x * r[2], 0, 255).astype(np.uint8).astype(np.uint32)
    hsv_of, bgr_of = _colour_tables()
    idx = img[..., 0].astype(np.uint32)
    idx |= img[..., 1].astype(np.uint32) << 8
    idx |= img[..., 2].astype(np.uint32) << 16
    hsv = hsv_of[idx]
    idx = lut_hue[hsv & 255] << 16
    idx |= lut_sat[(hsv >> 8) & 255] << 8
    idx |= lut_val[hsv >> 16]
    bgr = bgr_of[idx].view(np.uint8).reshape(*img.shape[:2], 4)[..., :3]
    img[...] = bgr
    cut = 32 * (img.shape[1] // 32)
    if cut < img.shape[1]:  # the pixels cv2's scalar code converts
        tail = idx[:, cut:]
        img[:, cut:] = hsv2bgr(np.stack(
            [tail >> 16, (tail >> 8) & 255, tail & 255], -1).astype(np.uint8),
            vector=False)


def mirror(image, boxes, rng: random.Random, prob=0.5):
    """Random horizontal flip; boxes xyxy."""
    if rng.random() < prob:
        image, boxes = mirror_joint(image, boxes)
    return image, boxes


def mirror_joint(image, boxes):
    """Horizontal flip, for flipping both frames of a pair alike."""
    _, width, _ = image.shape
    image = image[:, ::-1]
    boxes = boxes.copy()
    boxes[:, 0::2] = width - boxes[:, 2::-2]
    return image, boxes


def _pad_labels(labels, boxes, tids, max_labels):
    targets = np.hstack([labels[:, None], boxes, tids[:, None]])
    padded = np.zeros((max_labels, 6), np.float32)
    n = min(len(targets), max_labels)
    padded[:n] = targets[:n]
    return padded, n


def _split_targets(targets):
    """(boxes xyxy, labels, tids) of (N, 5 | 6) targets; without a tid
    column the first target gets tid 1 (SOT)."""
    boxes = targets[:, :4].copy()
    labels = targets[:, 4].copy()
    if targets.shape[1] == 6:
        tids = targets[:, 5].copy()
    else:
        tids = np.zeros((len(targets),))
        tids[0] = 1
    return boxes, labels, tids


class TrainTransformOmni:
    """The two-frame SOT / MOT transform, one call per frame; `joint` and
    `flip` keep the flip the same across the frames of a pair. Always
    6-column labels (an SOT target gets tid 1)."""

    def __init__(self, max_labels=100, flip_prob=0.5, hsv_prob=1.0):
        self.max_labels = max_labels
        self.flip_prob = flip_prob
        self.hsv_prob = hsv_prob

    def __call__(self, image, targets, input_dim, joint=False, flip=False, *,
                 rng: random.Random, np_rng: np.random.RandomState):
        if len(targets) == 0:
            image, _ = letterbox(image, input_dim)
            return image, np.zeros((self.max_labels, 6), np.float32)
        boxes, labels, tids = _split_targets(targets)
        image_o, targets_o = image.copy(), targets.copy()

        if rng.random() < self.hsv_prob:
            augment_hsv(image, np_rng)
        if joint:
            image_t, boxes = (mirror_joint(image, boxes) if flip
                              else (image, boxes))
        else:
            image_t, boxes = mirror(image, boxes, rng, self.flip_prob)
        image_t, r_ = letterbox(image_t, input_dim)
        boxes = xyxy2cxcywh(boxes) * r_

        keep = np.minimum(boxes[:, 2], boxes[:, 3]) > 1
        boxes_t, labels_t, tids_t = boxes[keep], labels[keep], tids[keep]
        if len(boxes_t) == 0:
            # every box shrank under 1 px: the un-augmented frame and boxes
            image_t, r_o = letterbox(image_o, input_dim)
            boxes_t, labels_t, tids_t = _split_targets(targets_o)
            boxes_t = xyxy2cxcywh(boxes_t) * r_o
        return image_t, _pad_labels(labels_t, boxes_t, tids_t,
                                    self.max_labels)[0]


class TrainTransformIns:
    """TrainTransformOmni plus the instance masks (H, W, N), aligned with
    the targets' rows, letterboxed and shrunk by d_rate."""

    def __init__(self, max_labels=100, flip_prob=0.5, hsv_prob=1.0, d_rate=4):
        self.max_labels = max_labels
        self.flip_prob = flip_prob
        self.hsv_prob = hsv_prob
        self.d_rate = d_rate

    def __call__(self, image, targets, masks, input_dim, joint=False,
                 flip=False, *, rng: random.Random,
                 np_rng: np.random.RandomState):
        out_h, out_w = input_dim[0] // self.d_rate, input_dim[1] // self.d_rate
        if len(targets) == 0:
            image, _ = letterbox(image, input_dim)
            return (image, np.zeros((self.max_labels, 6), np.float32),
                    np.zeros((self.max_labels, out_h, out_w), np.float32))
        boxes, labels, tids = _split_targets(targets)
        image_o, targets_o = image.copy(), targets.copy()

        if rng.random() < self.hsv_prob:
            augment_hsv(image, np_rng)
        do_flip = flip if joint else (rng.random() < self.flip_prob)
        if do_flip:
            image, boxes = mirror_joint(image, boxes)
            masks = masks[:, ::-1]

        image_t, r_ = letterbox(image, input_dim)
        masks_t, _ = letterbox_mask(masks, input_dim)
        boxes = xyxy2cxcywh(boxes) * r_

        keep = np.minimum(boxes[:, 2], boxes[:, 3]) > 1
        boxes_t, labels_t, tids_t = boxes[keep], labels[keep], tids[keep]
        masks_t = masks_t[:, :, keep]
        if len(boxes_t) == 0:
            # every box shrank under 1 px: the un-augmented frame and
            # boxes, and zero masks, as the reference does
            image_t, r_o = letterbox(image_o, input_dim)
            boxes_t, labels_t, tids_t = _split_targets(targets_o)
            boxes_t = xyxy2cxcywh(boxes_t) * r_o
            masks_t = np.zeros(
                (image_t.shape[0], image_t.shape[1], len(boxes_t)), np.float32)

        padded, n = _pad_labels(labels_t, boxes_t, tids_t, self.max_labels)
        padded_masks = np.zeros((self.max_labels, out_h, out_w), np.float32)
        if n:
            small = resize_linear(np.ascontiguousarray(masks_t[:, :, :n]),
                                  (out_w, out_h))
            padded_masks[:n] = np.transpose(small, (2, 0, 1))
        return image_t, padded, padded_masks


class TrainTransform4Tasks:
    """The four-task transform: a sample without masks (SOT, MOT) goes
    through TrainTransformOmni and returns masks None, one with masks (VOS,
    MOTS) through TrainTransformIns."""

    def __init__(self, max_labels=100, flip_prob=0.5, hsv_prob=1.0,
                 d_rate=4):
        self.trans_omni = TrainTransformOmni(max_labels, flip_prob, hsv_prob)
        self.trans_inst = TrainTransformIns(max_labels, flip_prob, hsv_prob,
                                            d_rate=d_rate)

    def __call__(self, image, targets, masks, input_dim, joint=False,
                 flip=False, *, rng: random.Random,
                 np_rng: np.random.RandomState):
        if masks is None:
            img_t, labels = self.trans_omni(image, targets, input_dim,
                                            joint=joint, flip=flip, rng=rng,
                                            np_rng=np_rng)
            return img_t, labels, None
        return self.trans_inst(image, targets, masks, input_dim, joint=joint,
                               flip=flip, rng=rng, np_rng=np_rng)


class ValTransform:
    """Eval-time letterbox."""

    def __call__(self, img, res, input_size):
        img, _ = letterbox(img, input_size)
        return img, np.zeros((1, 5), np.float32)
