"""Letterbox on the host in numpy (port of unicorn_tpu/data/preproc.py,
which resizes with cv2).

`resize_linear` reproduces `cv2.resize(..., interpolation=cv2.INTER_LINEAR)`
as OpenCV 5.0 computes it, so that the port's batches equal the JAX
package's:
  * uint8: the weights of both taps of each axis rounded to 11 bits
    (2048 = 1.0), the horizontal pass in integers, the vertical one as
    OpenCV's vector code does it, ((r0 >> 4) * b0 >> 16) + ((r1 >> 4) * b1
    >> 16), then (t + 2) >> 2 saturated to [0, 255]. Equal to cv2 on every
    shape tried (gray levels differ at 0 pixels);
  * float32: the float weights, two products and a sum a pass. Equal to
    cv2 for 2 and for 5 or more channels; cv2's 1-, 3- and 4-channel float
    code differs from it by up to 3e-5 (on 0/1 masks; 0 after the
    letterbox mask's cast to uint8).
The source coordinate is (d + 0.5) * scale - 0.5 in float32 with scale =
1 / (dst / src); columns are clamped with their weights (the edge pixel
alone), rows only in index, keeping both weights, as OpenCV does.

`resize_nearest` is cv2's INTER_NEAREST (its legacy rule, resizeNN): the
source index of output coordinate d is floor(d * (1 / (dst / src))) in
double, clamped to src - 1.
"""
from __future__ import annotations

import numpy as np


def _taps(src: int, dst: int, clamp_weights: bool):
    """(first index, second index, weight of the first, weight of the
    second) for each output coordinate of one axis, weights in float32."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    f = (f - s).astype(np.float32)
    s = s.astype(np.int64)
    if clamp_weights:
        lo, hi = s < 0, s >= src - 1
        f[lo | hi] = 0
        s[lo] = 0
        s[hi] = src - 1
    return (np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1),
            (np.float32(1) - f).astype(np.float32), f)


def resize_linear(img: np.ndarray, dsize) -> np.ndarray:
    """cv2.resize(img, dsize=(w, h), interpolation=INTER_LINEAR) for an
    (H, W) or (H, W, C) uint8 or float32 array."""
    dw, dh = int(dsize[0]), int(dsize[1])
    if (dh, dw) == img.shape[:2]:
        return img.copy()  # the weights are (1, 0): a copy, bit for bit
    squeeze = img.ndim == 2
    x = img[:, :, None] if squeeze else img
    sh, sw = x.shape[:2]
    x0, x1, a0, a1 = _taps(sw, dw, True)
    y0, y1, b0, b1 = _taps(sh, dh, False)
    if x.dtype == np.uint8:
        # the horizontal pass on (H, W * C) rows, one column per channel
        c = x.shape[2]
        cols0 = (x0[:, None] * c + np.arange(c)).ravel()
        cols1 = (x1[:, None] * c + np.arange(c)).ravel()
        w0 = np.repeat(np.rint(a0 * 2048).astype(np.int32), c)
        w1 = np.repeat(np.rint(a1 * 2048).astype(np.int32), c)
        flat = x.reshape(sh, sw * c)
        rows = np.take(flat, cols0, axis=1).astype(np.int32) * w0
        rows += np.take(flat, cols1, axis=1) * w1
        rows >>= 4
        b0 = np.rint(b0 * 2048).astype(np.int32)[:, None]
        b1 = np.rint(b1 * 2048).astype(np.int32)[:, None]
        t = (rows[y0] * b0) >> 16
        t += (rows[y1] * b1) >> 16
        t += 2
        t >>= 2
        out = np.clip(t, 0, 255).astype(np.uint8).reshape(dh, dw, c)
    elif x.dtype == np.float32:
        rows = x[:, x0] * a0[None, :, None] + x[:, x1] * a1[None, :, None]
        out = rows[y0] * b0[:, None, None] + rows[y1] * b1[:, None, None]
    else:
        raise TypeError(f"resize_linear: uint8 or float32, got {x.dtype}")
    return out[:, :, 0] if squeeze else out


def _nearest_index(src: int, dst: int) -> np.ndarray:
    inv = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * inv).astype(np.int64),
                      src - 1)


def resize_nearest(img: np.ndarray, dsize) -> np.ndarray:
    """cv2.resize(img, dsize=(w, h), interpolation=INTER_NEAREST) for an
    (H, W) or (H, W, C) array of any dtype."""
    dw, dh = int(dsize[0]), int(dsize[1])
    if dw <= 0 or dh <= 0 or img.shape[0] == 0 or img.shape[1] == 0:
        raise ValueError(f"resize_nearest of {img.shape[:2]} to {dh}x{dw}")
    ys = _nearest_index(img.shape[0], dh)
    xs = _nearest_index(img.shape[1], dw)
    return np.ascontiguousarray(img[ys[:, None], xs[None, :]])


def letterbox(img: np.ndarray, input_size) -> tuple[np.ndarray, float]:
    """img: (H, W, 3) uint8 BGR. Returns (the image resized to fit
    input_size at its aspect ratio, top-left, padded with 114, as float32
    HWC; scale r)."""
    if img.ndim == 3:
        padded = np.full((input_size[0], input_size[1], 3), 114, np.uint8)
    else:
        padded = np.full(input_size, 114, np.uint8)
    r = min(input_size[0] / img.shape[0], input_size[1] / img.shape[1])
    rw, rh = int(img.shape[1] * r), int(img.shape[0] * r)
    padded[:rh, :rw] = resize_linear(np.ascontiguousarray(img, np.uint8),
                                     (rw, rh))
    return np.ascontiguousarray(padded, dtype=np.float32), r


def letterbox_mask(mask: np.ndarray, input_size) -> tuple[np.ndarray, float]:
    """mask: (H, W, K) or (H, W) binary. Returns (padded float32
    (input_h, input_w, K), r): resized in the mask's dtype, then truncated
    to uint8 as the JAX package's cv2 path does."""
    if mask.ndim == 2:
        mask = mask[:, :, None]
    padded = np.zeros((input_size[0], input_size[1], mask.shape[2]), np.uint8)
    r = min(input_size[0] / mask.shape[0], input_size[1] / mask.shape[1])
    rw, rh = int(mask.shape[1] * r), int(mask.shape[0] * r)
    if r != 1:
        resized = resize_linear(mask, (rw, rh)).astype(np.uint8)
    else:
        resized = mask.astype(np.uint8)
    padded[:rh, :rw] = resized
    return np.ascontiguousarray(padded, dtype=np.float32), r
