"""Sequence-parallel SOT / VOS serving: S independent sequences in lockstep
on one card (port of unicorn_tpu/drivers/seq_parallel.py).

The reference benchmarks SOT / VOS one sequence a GPU process. JAX stacks
S sequences' references (feature and label maps) on a leading axis, vmaps
a driver's per-frame function over it and shards the axis over a "seq"
mesh of chips. Here the S frames go through the driver's own per-frame
path at batch S, with the stacked references as arguments to its stages:
one backbone, one interaction, one correlation and one head call a frame
for all S sequences, and slot s reads only sequence s's references. The
functions take no mesh: the sequences share one card.

Frames are (S, 3, H, W) float32 at the input size, as S of the driver's
`preprocess` give them (letterboxed on the card), concatenated; the
references stacked from S `SOTDriver.init_refs` / `VOSDriver.initialize`
on axis 0. Used by harness/_parallel_runners.py.
"""
from __future__ import annotations

import torch


def make_sot_seq_parallel_fn(driver):
    """(feat_refs (S, 1, C, H/16, W/16) or (S, C, ...), lbs_refs (S, 1, 1,
    N8) or (S, 1, N8), frames (S, 3, H, W)) -> packed (S, max_inst, 8)
    [x1, y1, x2, y2, obj, cls_conf, cls_id, valid] on the device."""

    @torch.inference_mode()
    def fn(feat_refs, lbs_refs, frames):
        S = frames.shape[0]
        return driver.postprocess(driver.forward(
            frames, feat_refs.reshape(S, *feat_refs.shape[-3:]),
            lbs_refs.reshape(S, 1, -1)))

    return fn


def _vos_outputs(driver, S, out):
    """(dets (S * K, 8, 7), valid (S * K, 8), masks (S * K, H, W) or None)
    -> (dets (S, K, 8, 7), valid (S, K, 8), masks (S, K, H, W) or None)."""
    dets, valid, masks = out
    K = driver.K
    return (dets.reshape(S, K, *dets.shape[1:]),
            valid.reshape(S, K, -1),
            None if masks is None else masks.reshape(S, K, *masks.shape[1:]))


def make_vos_seq_parallel_fn(driver):
    """The general form, per-slot references (objects of one sequence may
    carry different entry frames): (feat_refs (S, K, C, H/16, W/16),
    lbs_refs (S, K, 1, N8), frames (S, 3, H, W)) -> (dets (S, K, 8, 7),
    valid (S, K, 8), masks (S, K, H, W) or None without the mask branch);
    each sequence carries its own K object slots."""

    @torch.inference_mode()
    def fn(feat_refs, lbs_refs, frames):
        S, K = frames.shape[0], driver.K
        return _vos_outputs(driver, S, driver.track_fn(
            frames, feat_refs.reshape(S * K, *feat_refs.shape[-3:]),
            lbs_refs.reshape(S * K, 1, -1)))

    return fn


def make_vos_shared_seq_parallel_fn(driver):
    """The shared-reference form (all of a sequence's objects entered on one
    frame, the DAVIS case): one interaction and one K-row correlation a
    sequence a frame. (feat_ref1s (S, 1, C, H/16, W/16) or (S, C, ...),
    lbs_refs (S, K, 1, N8), frames (S, 3, H, W)) -> the outputs of
    `make_vos_seq_parallel_fn`."""

    @torch.inference_mode()
    def fn(feat_ref1s, lbs_refs, frames):
        S, K = frames.shape[0], driver.K
        return _vos_outputs(driver, S, driver.track_fn_shared(
            frames, feat_ref1s.reshape(S, *feat_ref1s.shape[-3:]),
            lbs_refs.reshape(S * K, 1, -1)))

    return fn
