"""Debug visualization dumps (port of unicorn_tpu/utils/debug_dump.py; the
reference's Trainer.debug_data, trainer.py:97-141, and Unicorn
mode="debug", unicorn.py:140-227): a training batch written with its boxes,
labels and masks drawn, for checking the data pipeline by eye.

The images are PNGs written by data/image_io.py `write_png` (the port has
no JPEG encoder; JAX writes JPEGs), drawn with utils/visualize.py, whose
label text is not cv2's Hershey font (the pixels outside each label's box
are cv2's)."""
from __future__ import annotations

import os

import numpy as np

from ..data.image_io import write_png
from ..data.preproc import resize_nearest
from .visualize import _COLORS, put_text, rectangle


def dump_uni_batch(save_dir, images, targets, task_ids, masks=None,
                   prefix="batch"):
    """A uni batch on the host, in the loader's layout: images (B, 2, H, W,
    3) float BGR; targets (B, 2, M, 6) [cls cx cy w h tid]; task_ids (B,);
    masks optional (B, 2, M, Hm, Wm). Writes
    <save_dir>/<prefix>_b{b}_f{f}_task{t}.png; returns save_dir."""
    os.makedirs(save_dir, exist_ok=True)
    B = images.shape[0]
    for b in range(B):
        for f in range(2):
            img = np.clip(np.asarray(images[b, f]), 0,
                          255).astype(np.uint8).copy()
            for m in range(targets.shape[2]):
                cls, cx, cy, w, h, tid = targets[b, f, m]
                if w <= 0 or h <= 0:
                    continue
                color = tuple(int(c) for c in _COLORS[int(tid) % len(_COLORS)])
                rectangle(img, (int(cx - w / 2), int(cy - h / 2)),
                          (int(cx + w / 2), int(cy + h / 2)), color, 2)
                put_text(img, f"t{int(tid)}c{int(cls)}",
                         (int(cx - w / 2), max(int(cy - h / 2) - 3, 10)),
                         0.4, color, 1)
            if masks is not None:
                Hm, Wm = masks.shape[3:]
                overlay = np.zeros((Hm, Wm, 3), np.float32)
                for m in range(masks.shape[2]):
                    mm = np.asarray(masks[b, f, m]) > 0.5
                    overlay[mm] = _COLORS[m % len(_COLORS)]
                overlay = resize_nearest(overlay, (img.shape[1], img.shape[0]))
                # blend only where a mask is painted: blending the whole
                # frame with the mostly-zero overlay would dim every pixel
                # and wash out the box and label annotations drawn above
                on = overlay.any(axis=2, keepdims=True)
                img = np.where(on, 0.6 * img + 0.4 * overlay,
                               img).astype(np.uint8)
            task = int(task_ids[b])
            write_png(os.path.join(save_dir,
                                   f"{prefix}_b{b}_f{f}_task{task}.png"),
                      np.ascontiguousarray(img[..., ::-1]))
    return save_dir
