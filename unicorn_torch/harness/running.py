"""Sequence and dataset runners for SOT and VOS evaluation (port of
unicorn_tpu/harness/running.py; the reference's lib/test/evaluation/
running.py:176-203 and tracker.py:70-212).

The runners here take the sequences one after another; the lockstep
runners, S sequences a step on one card, are in _parallel_runners.py and
re-exported here. Frames are read with the port's decoder
(data/image_io.py `imread`, BGR uint8 as cv2.imread gives them; a missing
or unreadable frame raises), VOS annotations with `read_indexed_mask`,
and the predicted VOS masks are written as 8-bit gray PNGs with
`write_png`.
"""
from __future__ import annotations

import os
import time

import numpy as np

from ..data.image_io import imread, read_indexed_mask, write_png
from ._parallel_runners import (run_dataset_sot_parallel,  # noqa: F401
                                run_dataset_vos_parallel)
from .datasets import Sequence


def run_sequence_sot(driver, seq: Sequence, result_dir: str | None = None,
                     window: int = 8):
    """Run one SOT sequence; returns (boxes (N, 4) xywh, fps).

    Uses the driver's batched `track_window` when it has one and window > 1
    (a frame's computation reads only the reference state, so windows batch
    without changing the result). With result_dir, writes
    <result_dir>/<seq.name>.txt, tab-separated integers."""
    frames = seq.frames
    driver.initialize(imread(frames[0]), seq.init_bbox)
    boxes = [seq.init_bbox]
    t0 = time.time()
    if hasattr(driver, "track_window") and window > 1:
        # decoded a window at a time: LaSOT sequences run to ~10k frames,
        # so memory stays bounded at window * frame size
        for start in range(1, len(frames), window):
            imgs = [imread(p) for p in frames[start: start + window]]
            outs = driver.track_window(imgs, window=window)
            boxes.extend(o["target_bbox"] for o in outs)
    else:
        for path in frames[1:]:
            out = driver.track(imread(path))
            boxes.append(out["target_bbox"])
    fps = max(len(frames) - 1, 1) / max(time.time() - t0, 1e-9)
    boxes = np.asarray(boxes, np.float64)
    if result_dir:
        os.makedirs(result_dir, exist_ok=True)
        np.savetxt(os.path.join(result_dir, f"{seq.name}.txt"), boxes,
                   delimiter="\t", fmt="%d")
    return boxes, fps


def run_dataset_sot(driver_factory, sequences, result_dir=None, max_seqs=None,
                    verbose=True):
    """driver_factory() -> a fresh SOTDriver for each sequence. Returns
    {sequence name: (N, 4) boxes}."""
    results = {}
    n = len(sequences) if max_seqs is None else min(max_seqs, len(sequences))
    for i in range(n):
        seq = sequences[i]
        driver = driver_factory()
        boxes, fps = run_sequence_sot(driver, seq, result_dir)
        results[seq.name] = boxes
        if verbose:
            print(f"[{i + 1}/{n}] {seq.name}: {len(boxes)} frames, {fps:.1f} FPS")
    return results


def run_sequence_vos(driver, seq: Sequence, result_dir: str | None = None):
    """Run one VOS sequence from its first-frame annotation; returns the
    (H, W) uint8 label map of every frame. With result_dir, writes
    <result_dir>/<seq.name>/<frame stem>.png (the DAVIS submission format).

    YouTube-VOS style mid-video entries: when a later annotated frame
    (seq.masks beyond index 0, matched to seq.frames by file stem)
    introduces new object ids, they are registered with driver.add_objects,
    that frame their reference (the reference's unicorn_vos.py:86-101)."""
    mask0 = read_indexed_mask(seq.masks[0])
    driver.initialize(imread(seq.frames[0]), mask0)
    anno_by_name = {os.path.splitext(os.path.basename(mp))[0]: mp
                    for mp in (seq.masks or [])[1:]}
    masks = [mask0]
    for path in seq.frames[1:]:
        img = imread(path)
        name = os.path.splitext(os.path.basename(path))[0]
        if name in anno_by_name and hasattr(driver, "add_objects"):
            driver.add_objects(img, read_indexed_mask(anno_by_name[name]))
        mask, _ = driver.track(img)
        masks.append(mask if mask is not None else np.zeros_like(mask0))
    if result_dir:
        out_dir = os.path.join(result_dir, seq.name)
        os.makedirs(out_dir, exist_ok=True)
        for path, m in zip(seq.frames, masks):
            name = os.path.splitext(os.path.basename(path))[0] + ".png"
            write_png(os.path.join(out_dir, name), m.astype(np.uint8))
    return masks
