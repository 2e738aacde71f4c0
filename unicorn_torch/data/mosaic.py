"""Mosaic and MixUp augmentation for detection pretraining, on the host in
numpy (port of unicorn_tpu/data/mosaic.py, which resizes and warps with
cv2): four images pasted around a jittered centre, a random_perspective
warp, an optional copy-paste MixUp, then the final TrainTransform.

Resizes are `preproc.resize_linear` and the warp `transforms.warp_affine`,
both equal to cv2 on uint8. Every draw comes from the generators passed
in, `rng` (random.Random, for JAX's process-global `random`) and `np_rng`
(np.random.RandomState, for its `np.random`), in JAX's order.
"""
from __future__ import annotations

import random

import numpy as np

from .preproc import resize_linear
from .transforms import random_perspective


def get_mosaic_coordinate(mosaic_index, xc, yc, w, h, input_h, input_w):
    """The paste rectangle (x1, y1, x2, y2) in the (2 input_h, 2 input_w)
    canvas of tile `mosaic_index` (0 top left, 1 top right, 2 bottom left,
    3 bottom right) of size (h, w) at the centre (xc, yc), and the part
    (x1, y1, x2, y2) of the tile that lands there."""
    if mosaic_index == 0:  # top left
        x1, y1, x2, y2 = max(xc - w, 0), max(yc - h, 0), xc, yc
        small = (w - (x2 - x1), h - (y2 - y1), w, h)
    elif mosaic_index == 1:  # top right
        x1, y1, x2, y2 = xc, max(yc - h, 0), min(xc + w, input_w * 2), yc
        small = (0, h - (y2 - y1), min(w, x2 - x1), h)
    elif mosaic_index == 2:  # bottom left
        x1, y1, x2, y2 = max(xc - w, 0), yc, xc, min(input_h * 2, yc + h)
        small = (w - (x2 - x1), 0, w, min(y2 - y1, h))
    else:  # bottom right
        x1, y1, x2, y2 = (xc, yc, min(xc + w, input_w * 2),
                          min(input_h * 2, yc + h))
        small = (0, 0, min(w, x2 - x1), min(y2 - y1, h))
    return (x1, y1, x2, y2), small


class MosaicDetection:
    """Wraps a detection dataset (`pull_item(i)` -> (img (H, W, 3) uint8,
    labels (N, 5) [x1, y1, x2, y2, cls], info, id); `annotations[i][0]`
    the labels, as COCODataset and VOCDetection hold them) with mosaic
    and MixUp.
    `get_item(idx, rng=, np_rng=)` -> (image float32 at img_size, labels
    (max_labels, 5), info, id); `close_mosaic` turns both off for the
    no-aug epochs."""

    def __init__(self, dataset, img_size, preproc, mosaic_prob=1.0,
                 mixup_prob=1.0, degrees=10.0, translate=0.1,
                 mosaic_scale=(0.1, 2.0), mixup_scale=(0.5, 1.5),
                 shear=2.0, enable_mixup=True):
        self.dataset = dataset
        self.input_dim = tuple(img_size)
        self.preproc = preproc
        self.mosaic_prob = mosaic_prob
        self.mixup_prob = mixup_prob
        self.degrees = degrees
        self.translate = translate
        self.scale = mosaic_scale
        self.mixup_scale = mixup_scale
        self.shear = shear
        self.enable_mixup = enable_mixup
        self.enable_mosaic = True

    def __len__(self):
        return len(self.dataset)

    def close_mosaic(self):
        """The no-aug final epochs: neither mosaic nor MixUp from now on."""
        self.enable_mosaic = False
        self.enable_mixup = False

    def get_item(self, idx, *, rng: random.Random,
                 np_rng: np.random.RandomState):
        if self.enable_mosaic and rng.random() < self.mosaic_prob:
            input_h, input_w = self.input_dim
            yc = int(rng.uniform(0.5 * input_h, 1.5 * input_h))
            xc = int(rng.uniform(0.5 * input_w, 1.5 * input_w))
            indices = [idx] + [rng.randint(0, len(self.dataset) - 1)
                               for _ in range(3)]
            mosaic_img = np.full((input_h * 2, input_w * 2, 3), 114,
                                 np.uint8)
            mosaic_labels = []
            for i, index in enumerate(indices):
                img, labels, _, _ = self.dataset.pull_item(index)
                h0, w0 = img.shape[:2]
                scale = min(1.0 * input_h / h0, 1.0 * input_w / w0)
                img = resize_linear(img, (int(w0 * scale), int(h0 * scale)))
                h, w = img.shape[:2]
                (x1, y1, x2, y2), (sx1, sy1, sx2, sy2) = \
                    get_mosaic_coordinate(i, xc, yc, w, h, input_h, input_w)
                mosaic_img[y1:y2, x1:x2] = img[sy1:sy2, sx1:sx2]
                pad_w, pad_h = x1 - sx1, y1 - sy1
                if len(labels):
                    lab = labels.copy()
                    lab[:, [0, 2]] = labels[:, [0, 2]] * scale + pad_w
                    lab[:, [1, 3]] = labels[:, [1, 3]] * scale + pad_h
                    mosaic_labels.append(lab)
            if mosaic_labels:
                mosaic_labels = np.concatenate(mosaic_labels, 0)
                mosaic_labels[:, [0, 2]] = np.clip(
                    mosaic_labels[:, [0, 2]], 0, 2 * input_w)
                mosaic_labels[:, [1, 3]] = np.clip(
                    mosaic_labels[:, [1, 3]], 0, 2 * input_h)
            else:
                mosaic_labels = np.zeros((0, 5), np.float32)

            mosaic_img, mosaic_labels = random_perspective(
                mosaic_img, mosaic_labels, degrees=self.degrees,
                translate=self.translate, scale=self.scale, shear=self.shear,
                border=(-input_h // 2, -input_w // 2), rng=rng)
            if (self.enable_mixup and len(mosaic_labels)
                    and rng.random() < self.mixup_prob):
                mosaic_img, mosaic_labels = self.mixup(
                    mosaic_img, mosaic_labels, self.input_dim, rng=rng)
            img_t, labels_t = self.preproc(mosaic_img, mosaic_labels,
                                           self.input_dim, rng=rng,
                                           np_rng=np_rng)
            return img_t, labels_t, (input_h, input_w), np.array([idx])
        img, labels, info, img_id = self.dataset.pull_item(idx)
        img_t, labels_t = self.preproc(img, labels, self.input_dim, rng=rng,
                                       np_rng=np_rng)
        return img_t, labels_t, info, img_id

    def mixup(self, origin_img, origin_labels, input_dim, *,
              rng: random.Random):
        """Copy-paste MixUp: an item with labels, letterboxed, jittered in
        scale, maybe flipped and cropped at a random offset, blended half
        and half into origin_img (float32, truncated to uint8); its boxes
        of more than 1 px join origin_labels."""
        jit_factor = rng.uniform(*self.mixup_scale)
        flip = rng.random() > 0.5
        # the redraw reads the held labels, not the image: the same draws
        cp_index = rng.randint(0, len(self.dataset) - 1)
        while len(self.dataset.annotations[cp_index][0]) == 0:
            cp_index = rng.randint(0, len(self.dataset) - 1)
        img, cp_labels, _, _ = self.dataset.pull_item(cp_index)

        if len(img.shape) == 3:
            cp_img = np.full((input_dim[0], input_dim[1], 3), 114, np.uint8)
        else:
            cp_img = np.full(input_dim, 114, np.uint8)
        cp_scale_ratio = min(input_dim[0] / img.shape[0],
                             input_dim[1] / img.shape[1])
        resized = resize_linear(img, (int(img.shape[1] * cp_scale_ratio),
                                      int(img.shape[0] * cp_scale_ratio)))
        cp_img[: resized.shape[0], : resized.shape[1]] = resized
        cp_img = resize_linear(cp_img, (int(cp_img.shape[1] * jit_factor),
                                        int(cp_img.shape[0] * jit_factor)))
        cp_scale_ratio *= jit_factor
        if flip:
            cp_img = cp_img[:, ::-1, :]

        origin_h, origin_w = cp_img.shape[:2]
        target_h, target_w = origin_img.shape[:2]
        padded = np.zeros((max(origin_h, target_h),
                           max(origin_w, target_w), 3), np.uint8)
        padded[:origin_h, :origin_w] = cp_img
        x_offset = rng.randint(0, max(padded.shape[1] - target_w, 0)) \
            if padded.shape[1] > target_w else 0
        y_offset = rng.randint(0, max(padded.shape[0] - target_h, 0)) \
            if padded.shape[0] > target_h else 0
        cropped = padded[y_offset: y_offset + target_h,
                         x_offset: x_offset + target_w]

        boxes = cp_labels[:, :4].copy() * cp_scale_ratio
        if flip:
            boxes[:, 0::2] = origin_w - boxes[:, 2::-2]
        boxes[:, 0::2] = np.clip(boxes[:, 0::2] - x_offset, 0, target_w)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2] - y_offset, 0, target_h)
        keep = (((boxes[:, 2] - boxes[:, 0]) > 1)
                & ((boxes[:, 3] - boxes[:, 1]) > 1))
        if keep.any():
            labels = np.hstack([boxes[keep], cp_labels[keep, 4:5]])
            origin_labels = np.vstack([origin_labels, labels])
            origin_img = origin_img.astype(np.float32)
            origin_img = 0.5 * origin_img + 0.5 * cropped.astype(np.float32)
        return origin_img.astype(np.uint8), origin_labels
