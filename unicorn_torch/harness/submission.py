"""Benchmark submission packers (port of unicorn_tpu/harness/submission.py;
the reference's lib/test/utils/transform_got10k.py and
transform_trackingnet.py): per-sequence result txts reformatted into the
GOT-10k / TrackingNet evaluation-server layouts and zipped.
"""
from __future__ import annotations

import os
import zipfile

import numpy as np


def transform_got10k(results_dir: str, out_dir: str, tracker_name: str = "unicorn"):
    """GOT-10k server layout: <seq>/<seq>_001.txt (comma-separated xywh) +
    <seq>_time.txt."""
    stage = os.path.join(out_dir, tracker_name)
    os.makedirs(stage, exist_ok=True)
    for f in sorted(os.listdir(results_dir)):
        if not f.endswith(".txt") or f.endswith("_time.txt"):
            continue
        seq = f[:-4]
        seq_dir = os.path.join(stage, seq)
        os.makedirs(seq_dir, exist_ok=True)
        boxes = np.loadtxt(os.path.join(results_dir, f), delimiter="\t")
        np.savetxt(os.path.join(seq_dir, f"{seq}_001.txt"), boxes,
                   fmt="%.4f", delimiter=",")
        np.savetxt(os.path.join(seq_dir, f"{seq}_time.txt"),
                   np.full(len(boxes), 0.033), fmt="%.6f")
    zip_path = os.path.join(out_dir, f"{tracker_name}_got10k.zip")
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as z:
        for root, _, files in os.walk(stage):
            for name in files:
                p = os.path.join(root, name)
                z.write(p, os.path.relpath(p, stage))
    return zip_path


def transform_trackingnet(results_dir: str, out_dir: str,
                          tracker_name: str = "unicorn"):
    """TrackingNet server layout: flat <seq>.txt with comma-separated xywh."""
    stage = os.path.join(out_dir, tracker_name)
    os.makedirs(stage, exist_ok=True)
    for f in sorted(os.listdir(results_dir)):
        if not f.endswith(".txt"):
            continue
        boxes = np.loadtxt(os.path.join(results_dir, f), delimiter="\t")
        np.savetxt(os.path.join(stage, f), boxes, fmt="%.2f", delimiter=",")
    zip_path = os.path.join(out_dir, f"{tracker_name}_trackingnet.zip")
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as z:
        for name in os.listdir(stage):
            z.write(os.path.join(stage, name), name)
    return zip_path
