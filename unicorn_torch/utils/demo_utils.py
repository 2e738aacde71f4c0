"""Demo helpers (port of unicorn_tpu/utils/demo_utils.py; the reference's
unicorn/utils/demo_utils.py): result formatting and the frame IO of
tools/demo.py.

The port has no video codec: `VideoReader` reads a directory of frames
(sorted by name, decoded by data/image_io.py `imread`) at the frame rate
the caller gives, and `VideoWriter` writes numbered PNGs into a directory;
a video file raises NotImplementedError."""
from __future__ import annotations

import os

import numpy as np

from ..data.image_io import imread, write_png

FRAME_EXTS = (".jpg", ".jpeg", ".png")


def mkdir(path):
    os.makedirs(path, exist_ok=True)
    return path


class VideoReader:
    """The frames of a directory, BGR uint8, in name order."""

    def __init__(self, path, fps: float = 30):
        if not os.path.isdir(path):
            raise NotImplementedError(
                f"{path}: the port reads video as a directory of frames "
                "(.jpg / .png, sorted by name); it has no video decoder")
        self.paths = [os.path.join(path, f) for f in sorted(os.listdir(path))
                      if f.lower().endswith(FRAME_EXTS)]
        self.fps = fps
        self.n_frames = len(self.paths)
        first = imread(self.paths[0]) if self.paths else None
        self.height, self.width = (first.shape[:2] if first is not None
                                   else (0, 0))

    def __iter__(self):
        for p in self.paths:
            yield imread(p)


class VideoWriter:
    """Frames written as <path>/<index:06d>.png (BGR in, RGB in the file,
    as cv2.imwrite stores them)."""

    def __init__(self, path, fps, size_wh):
        self.path = mkdir(path)
        self.fps = fps
        self.size_wh = tuple(size_wh)
        self.n = 0

    def write(self, frame):
        write_png(os.path.join(self.path, f"{self.n:06d}.png"),
                  np.ascontiguousarray(frame[..., ::-1]))
        self.n += 1

    def release(self):
        pass


def dets_to_json(dets, class_names=None):
    """(N, 7) dets -> list of dicts for result dumping."""
    out = []
    for d in np.asarray(dets):
        cls_id = int(d[6])
        out.append({
            "bbox": [float(x) for x in d[:4]],
            "score": float(d[4] * d[5]),
            "category": class_names[cls_id] if class_names else cls_id,
        })
    return out
