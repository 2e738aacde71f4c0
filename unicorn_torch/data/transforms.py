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

Warps. `warp_affine` and `warp_perspective` are cv2.warpAffine /
cv2.warpPerspective with INTER_LINEAR and a constant border on uint8 as
OpenCV 5.0 computes them, and equal to it on an AVX-512 CPU:
  * 1, 3 or 4 channels take OpenCV 5's float path: the inverse map
    (`invert_affine`, float64) rounded to float32; each row's source
    coordinate is fma(m0, x, m1 * y + m2) in float32 in vector blocks of
    `_LANES` pixels, fma(m0, x, m1 * y) + m2 in the row's last W mod
    `_LANES` pixels (the perspective's three rows alike, then X / W);
    the weights are the coordinate less its floor; a neighbour outside
    the image is the border value; two horizontal lerps a + t * (b - a),
    then one vertical, each one fused multiply-add in float32, rounded
    half to even once;
  * other channel counts (the masks) take OpenCV's fixed-point remap: the
    coordinate in 1/1024 px from float64, 5 fraction bits a axis, weights
    (32 - f) * (32 - g) * 32 and so on (15 bits), (sum + 2**14) >> 15.
On a CPU whose OpenCV build dispatches a narrower vector (8 lanes on
AVX2) cv2 itself computes the pixels of a row's tail the other way, which
moves a value by one gray level at about 1e-5 of them.

Randomness. The JAX package draws from the process-global `random` (the
HSV and flip coin tosses, the warp's parameters) and `np.random` (the HSV
gains); here every transform takes the generators, `rng` (random.Random)
and `np_rng` (np.random.RandomState), and draws from them in the same
order, so generators seeded as JAX's `seed_everything(s)` seeds the
globals give the same draws.
"""
from __future__ import annotations

import functools
import math
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


# ---------------------------------------------------------------- warps
_LANES = 16   # float32 lanes of OpenCV's AVX-512 warp kernels


def get_rotation_matrix_2d(angle, center, scale) -> np.ndarray:
    """cv2.getRotationMatrix2D: (2, 3) float64, `angle` in degrees
    counter-clockwise about `center` (x, y), times `scale`."""
    a = angle * math.pi / 180
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def invert_affine(M) -> np.ndarray:
    """cv2.invertAffineTransform of a (2, 3) matrix, in float64."""
    M = np.asarray(M, np.float64)
    d = M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22, a12, a21 = M[1, 1] * d, M[0, 0] * d, -M[0, 1] * d, -M[1, 0] * d
    return np.array([[a11, a12, -a11 * M[0, 2] - a12 * M[1, 2]],
                     [a21, a22, -a21 * M[0, 2] - a22 * M[1, 2]]])


def _fma32(a, b, c):
    """a * b + c of float32 operands rounded once to float32 (the product
    is exact in float64)."""
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


def _map_rows(rows, W, H):
    """The float32 source coordinate of each output pixel under each
    (m0, m1, m2) of `rows`, in OpenCV 5's order (see the module's
    docstring) -> list of (H, W)."""
    f32 = np.float32
    xs = np.arange(W, dtype=f32)[None, :]
    ys = np.arange(H, dtype=f32)[:, None]
    cut = W // _LANES * _LANES
    out = []
    for m0, m1, m2 in np.asarray(rows, np.float64).astype(f32):
        m1y = m1 * ys
        s = np.empty((H, W), f32)
        s[:, :cut] = _fma32(m0, xs[:, :cut], m1y + m2)
        s[:, cut:] = _fma32(m0, xs[:, cut:], m1y) + m2
        out.append(s)
    return out


def _gather4(x, iy, ix, border):
    """The 2x2 neighbourhoods at (iy, ix) of x (h, w, c), a neighbour
    outside the image reading `border` -> (p00, p01, p10, p11)."""
    h, w, c = x.shape
    pad = np.empty((h + 2, w + 2, c), x.dtype)
    pad[...] = border
    pad[1:-1, 1:-1] = x
    flat = pad.reshape(-1, c)
    out = []
    for dy in (0, 1):
        yy = np.clip(iy + dy, -1, h) + 1
        for dx in (0, 1):
            out.append(flat[yy * (w + 2) + np.clip(ix + dx, -1, w) + 1])
    return out


def _remap_float(x, sx, sy, border):
    """Bilinear sampling of uint8 x (h, w, c) at float32 (sx, sy): OpenCV
    5's float path."""
    fx, fy = np.floor(sx), np.floor(sy)
    ax = (sx - fx)[..., None]
    ay = (sy - fy)[..., None]
    p00, p01, p10, p11 = (p.astype(np.float32) for p in _gather4(
        x, fy.astype(np.int64), fx.astype(np.int64), border))
    t0 = _fma32(ax, p01 - p00, p00)
    t1 = _fma32(ax, p11 - p10, p10)
    out = _fma32(ay, t1 - t0, t0)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _remap_fixed(x, A, W, H, border):
    """cv2.warpAffine's fixed-point path at the inverse map A (float64) on
    uint8 x (h, w, c)."""
    xs = np.arange(W, dtype=np.float64)
    ys = np.arange(H, dtype=np.float64)
    X = ((np.rint((A[0, 1] * ys + A[0, 2]) * 1024).astype(np.int64) + 16)[
        :, None] + np.rint(A[0, 0] * xs * 1024).astype(np.int64)) >> 5
    Y = ((np.rint((A[1, 1] * ys + A[1, 2]) * 1024).astype(np.int64) + 16)[
        :, None] + np.rint(A[1, 0] * xs * 1024).astype(np.int64)) >> 5
    fx, fy = (X & 31)[..., None], (Y & 31)[..., None]
    p00, p01, p10, p11 = (p.astype(np.int64) for p in _gather4(
        x, Y >> 5, X >> 5, border))
    s = ((32 - fy) * ((32 - fx) * p00 + fx * p01)
         + fy * ((32 - fx) * p10 + fx * p11)) * 32
    return np.clip((s + (1 << 14)) >> 15, 0, 255).astype(np.uint8)


def _warp(img, M, dsize, border_value, perspective):
    if img.dtype != np.uint8:
        raise TypeError(f"warp: uint8 images only, got {img.dtype}")
    W, H = int(dsize[0]), int(dsize[1])
    x = img[:, :, None] if img.ndim == 2 else img
    c = x.shape[2]
    if perspective:
        if c not in (1, 3, 4):
            raise ValueError(f"warp_perspective: 1, 3 or 4 channels, got {c}")
        inv = np.linalg.inv(np.asarray(M, np.float64))
        X, Y, Z = _map_rows(inv, W, H)
        out = _remap_float(x, X / Z, Y / Z, border_value)
    elif c in (1, 3, 4):
        out = _remap_float(x, *_map_rows(invert_affine(M), W, H),
                           border_value)
    else:
        out = _remap_fixed(x, invert_affine(M), W, H, border_value)
    return out[:, :, 0] if img.ndim == 2 else out


def warp_affine(img, M, dsize, border_value=0) -> np.ndarray:
    """cv2.warpAffine(img, M, dsize=(w, h), flags=INTER_LINEAR,
    borderValue=border_value) for an (H, W) or (H, W, C) uint8 image, any
    C (see the module's docstring)."""
    return _warp(img, M, dsize, border_value, False)


def warp_perspective(img, M, dsize, border_value=0) -> np.ndarray:
    """cv2.warpPerspective(img, M, dsize=(w, h), flags=INTER_LINEAR,
    borderValue=border_value) for an (H, W) or (H, W, 1 | 3 | 4) uint8
    image."""
    return _warp(img, M, dsize, border_value, True)


def box_candidates(box1, box2, wh_thr=2, ar_thr=20, area_thr=0.2):
    """Which boxes survive a warp: box1 / box2 (4, N) xyxy before (scaled)
    and after it; wider and taller than wh_thr px, an aspect ratio under
    ar_thr, and more than area_thr of the area kept."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + 1e-16), h2 / (w2 + 1e-16))
    return ((w2 > wh_thr) & (h2 > wh_thr)
            & (w2 * h2 / (w1 * h1 + 1e-16) > area_thr) & (ar < ar_thr))


def random_perspective(img, targets=(), degrees=10, translate=0.1,
                       scale=(0.5, 1.5), shear=2.0, perspective=0.0,
                       border=(0, 0), masks=None, *, rng: random.Random):
    """Random rotation, scale, shear and translation of a uint8 image and
    its targets (N, >= 4) [x1, y1, x2, y2, ...] (the other columns kept),
    grown or cut by `border` (rows, columns) on each side; `masks` (H, W,
    N) uint8 warp alike (border 0). Draws from rng: the angle, the scale,
    the two shears, the two translations. Returns (img, targets[,
    masks]), the targets that `box_candidates` drops taken out."""
    height = img.shape[0] + border[0] * 2
    width = img.shape[1] + border[1] * 2

    C = np.eye(3)
    C[0, 2] = -img.shape[1] / 2
    C[1, 2] = -img.shape[0] / 2
    R = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(scale[0], scale[1])
    R[:2] = get_rotation_matrix_2d(a, (0, 0), s)
    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * width
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * height
    M = T @ S @ R @ C

    if (border[0] != 0) or (border[1] != 0) or (M != np.eye(3)).any():
        if perspective:
            img = warp_perspective(img, M, (width, height), 114)
        else:
            img = warp_affine(img, M[:2], (width, height), 114)
        if masks is not None:
            masks = warp_affine(masks, M[:2], (width, height), 0)
            if masks.ndim == 2:
                masks = masks[:, :, None]

    n = len(targets)
    if n:
        xy = np.ones((n * 4, 3))
        xy[:, :2] = targets[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)
        xy = xy @ M.T
        xy = (xy[:, :2] / xy[:, 2:3] if perspective else xy[:, :2]
              ).reshape(n, 8)
        x = xy[:, [0, 2, 4, 6]]
        y = xy[:, [1, 3, 5, 7]]
        new_boxes = np.concatenate(
            (x.min(1), y.min(1), x.max(1), y.max(1))).reshape(4, n).T
        new_boxes[:, [0, 2]] = new_boxes[:, [0, 2]].clip(0, width)
        new_boxes[:, [1, 3]] = new_boxes[:, [1, 3]].clip(0, height)
        keep = box_candidates(box1=targets[:, :4].T * s, box2=new_boxes.T)
        targets = targets[keep]
        targets[:, :4] = new_boxes[keep]
        if masks is not None and masks.shape[2] == n:
            masks = masks[:, :, keep]
    if masks is not None:
        return img, targets, masks
    return img, targets


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


class TrainTransform:
    """The single-frame detection / MOT transform: HSV jitter, a flip and
    the letterbox of an (H, W, 3) uint8 image and its targets (N, 5 | 6)
    [x1, y1, x2, y2, cls(, tid)] -> (float32 image at input_dim, labels
    (max_labels, 5 | 6) [cls, cx, cy, w, h(, tid)]); boxes under 1 px
    after the letterbox are dropped, and where none is left the
    un-augmented image and boxes are taken."""

    def __init__(self, max_labels=50, flip_prob=0.5, hsv_prob=1.0):
        self.max_labels = max_labels
        self.flip_prob = flip_prob
        self.hsv_prob = hsv_prob

    def __call__(self, image, targets, input_dim, *, rng: random.Random,
                 np_rng: np.random.RandomState):
        ncol = targets.shape[1] if len(targets) else 5
        has_tid = ncol == 6
        if len(targets) == 0:
            image, _ = letterbox(image, input_dim)
            return image, np.zeros((self.max_labels, ncol), np.float32)

        image_o, targets_o = image.copy(), targets.copy()
        boxes = targets[:, :4].copy()
        labels = targets[:, 4].copy()
        tids = targets[:, 5].copy() if has_tid else None

        if rng.random() < self.hsv_prob:
            augment_hsv(image, np_rng)
        image_t, boxes = mirror(image, boxes, rng, self.flip_prob)
        image_t, r_ = letterbox(image_t, input_dim)
        boxes = xyxy2cxcywh(boxes) * r_

        keep = np.minimum(boxes[:, 2], boxes[:, 3]) > 1
        boxes_t, labels_t = boxes[keep], labels[keep]
        tids_t = tids[keep] if has_tid else None
        if len(boxes_t) == 0:
            image_t, r_o = letterbox(image_o, input_dim)
            boxes_t = xyxy2cxcywh(targets_o[:, :4].copy()) * r_o
            labels_t = targets_o[:, 4]
            tids_t = targets_o[:, 5] if has_tid else None

        cols = [labels_t[:, None], boxes_t]
        if has_tid:
            cols.append(tids_t[:, None])
        targets_t = np.hstack(cols)
        padded = np.zeros((self.max_labels, ncol), np.float32)
        n = min(len(targets_t), self.max_labels)
        padded[:n] = targets_t[:n]
        return image_t, padded


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
