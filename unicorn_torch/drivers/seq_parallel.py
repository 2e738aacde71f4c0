"""Sequence-parallel SOT / VOS serving: S independent sequences in lockstep
on one card or over a process mesh (port of
unicorn_tpu/drivers/seq_parallel.py).

The reference benchmarks SOT / VOS one sequence a GPU process. JAX stacks
S sequences' references (feature and label maps) on a leading axis, vmaps
a driver's per-frame function over it and shards the axis over a "seq"
mesh of chips. Here the S frames go through the driver's own per-frame
path at batch S, with the stacked references as arguments to its stages:
one backbone, one interaction, one correlation and one head call a frame
for all S sequences, and slot s reads only sequence s's references.

With a ProcessMesh (parallel/mesh.py `make_mesh`) the S sequences split
over its "seq" axis, one process a card, as JAX shards them: every rank
passes all S sequences' inputs, as JAX's single controller does, runs its
S / W of them at batch S / W through the one-card function, and the
outputs are gathered in rank order (one all-reduce each, parallel/rows.py
`gather_dim0`), so every rank returns all S. S must divide over the W
ranks.

Frames are (S, 3, H, W) float32 at the input size, as S of the driver's
`preprocess` give them (letterboxed on the card), concatenated; the
references stacked from S `SOTDriver.init_refs` / `VOSDriver.initialize`
on axis 0. Used by harness/_parallel_runners.py.
"""
from __future__ import annotations

import torch

from ..parallel.rows import RowPlan, gather_dim0


def _over_mesh(fn, mesh, axis):
    """fn on this rank's S / W of the sequences (every argument's leading
    axis), its outputs gathered over the ranks; fn itself without a
    mesh."""
    if mesh is None:
        return fn
    n = mesh.size(axis)
    ranks = RowPlan((1,) * n, mesh.rank, mesh.group)   # a block a rank

    @torch.inference_mode()
    def sharded(*args):
        S = args[-1].shape[0]
        if S % n:
            raise ValueError(f"seq-parallel: {S} sequences do not divide "
                             f"over the {n} ranks of axis {axis!r}")
        lo, per = mesh.rank * S // n, S // n
        outs = fn(*(a[lo:lo + per] for a in args))
        if isinstance(outs, torch.Tensor):
            return gather_dim0(outs, ranks)
        return tuple(None if o is None else gather_dim0(o, ranks)
                     for o in outs)

    return sharded


def make_sot_seq_parallel_fn(driver, mesh=None, axis: str = "seq"):
    """(feat_refs (S, 1, C, H/16, W/16) or (S, C, ...), lbs_refs (S, 1, 1,
    N8) or (S, 1, N8), frames (S, 3, H, W)) -> packed (S, max_inst, 8)
    [x1, y1, x2, y2, obj, cls_conf, cls_id, valid] on the device."""

    @torch.inference_mode()
    def fn(feat_refs, lbs_refs, frames):
        S = frames.shape[0]
        return driver.postprocess(driver.forward(
            frames, feat_refs.reshape(S, *feat_refs.shape[-3:]),
            lbs_refs.reshape(S, 1, -1)))

    return _over_mesh(fn, mesh, axis)


def _vos_outputs(driver, S, out):
    """(dets (S * K, 8, 7), valid (S * K, 8), masks (S * K, H, W) or None)
    -> (dets (S, K, 8, 7), valid (S, K, 8), masks (S, K, H, W) or None)."""
    dets, valid, masks = out
    K = driver.K
    return (dets.reshape(S, K, *dets.shape[1:]),
            valid.reshape(S, K, -1),
            None if masks is None else masks.reshape(S, K, *masks.shape[1:]))


def make_vos_seq_parallel_fn(driver, mesh=None, axis: str = "seq"):
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

    return _over_mesh(fn, mesh, axis)


def make_vos_shared_seq_parallel_fn(driver, mesh=None,
                                    axis: str = "seq"):
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

    return _over_mesh(fn, mesh, axis)
