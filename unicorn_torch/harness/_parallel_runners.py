"""Lockstep multi-sequence SOT / VOS dataset runners on one card (port of
unicorn_tpu/harness/_parallel_runners.py; re-exported by running.py).

They take the place of the reference's one-process-a-GPU sequence pool
(lib/test/evaluation/running.py:176-203): S slots each hold a sequence,
and every step advances all of them by one frame through the
sequence-parallel functions (drivers/seq_parallel.py), their references
stacked on axis 0. A slot whose sequence ends takes the next one from the
queue at once; a slot left empty at the tail runs a zero frame whose
outputs are dropped. The host protocol of a sequence is the sequential
runners' (SOTDriver.update_state_from_packed, VOSDriver.
postprocess_masks_host), and so are the reads (data/image_io.py `imread`,
`read_indexed_mask`) and the written files (txt, `write_png`).

JAX sizes the slots by a "seq" mesh axis of chips; here `n_slots` is the
batch of one card, or, with a ProcessMesh (parallel/mesh.py `make_mesh`),
the slots of all W ranks: sequence i goes to rank i mod W, each rank runs
the lockstep over its share on n_slots / W slots of its card and writes
its sequences' files, and then the results are gathered to every rank
(`all_gather_object`).
"""
from __future__ import annotations

import copy
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..data.image_io import imread, read_indexed_mask, write_png
from ..drivers.seq_parallel import (make_sot_seq_parallel_fn,
                                    make_vos_shared_seq_parallel_fn)


class _RefStackCache:
    """Stacked per-slot reference tensors, rebuilt only when a slot
    changes (references are constant between slot refills)."""

    def __init__(self):
        self.dirty = True
        self.stacks = None

    def get(self, build):
        if self.dirty:
            self.stacks = build()
            self.dirty = False
        return self.stacks


def _zero_frame(driver):
    """An empty slot's frame: (1, 3, H, W) zeros, channels_last, on the
    driver's device, as `preprocess` lays a frame out."""
    return torch.zeros((1, 3) + driver.input_size, device=driver.device) \
        .contiguous(memory_format=torch.channels_last)


def _share(sequences, max_seqs, n_slots, mesh, axis):
    """(n, this process's sequence indices, its slots): all of the first n
    and n_slots without a mesh; with one, i mod W == rank and n_slots / W
    (n_slots defaults to W, JAX's slots of a "seq" mesh)."""
    n = len(sequences) if max_seqs is None else min(max_seqs, len(sequences))
    if mesh is None:
        if n_slots is None:
            raise ValueError("n_slots: the slots of the one card")
        return n, list(range(n)), int(n_slots)
    w = mesh.size(axis)
    n_slots = w if n_slots is None else int(n_slots)
    if n_slots % w:
        raise ValueError(f"{n_slots} slots do not divide over the {w} ranks "
                         f"of axis {axis!r}")
    return n, list(range(mesh.rank, n, w)), n_slots // w


def _gathered(results, sequences, n, mesh, axis):
    """Every rank's results on every rank, after all have written their
    files, in sequence order."""
    if mesh is None:
        return results
    if mesh.group is not None:
        every = [None] * mesh.size(axis)
        dist.all_gather_object(every, results, group=mesh.group)
        for part in every:
            results.update(part)
    return {sequences[i].name: results[sequences[i].name] for i in range(n)}


def run_dataset_sot_parallel(driver, sequences, n_slots=None,
                             result_dir=None, max_seqs=None, verbose=True,
                             mesh=None, axis: str = "seq"):
    """Lockstep multi-sequence SOT on `n_slots` slots of one card, or over
    the ranks of `mesh` (module docstring). driver: ONE SOTDriver (its
    model shared by the slots). Returns {seq.name: boxes (N, 4) xywh}, as
    run_dataset_sot."""
    n, mine, S = _share(sequences, max_seqs, n_slots, mesh, axis)
    fn = make_sot_seq_parallel_fn(driver)
    queue = list(mine)
    slots = [None] * S
    cache = _RefStackCache()
    results = {}
    t0 = time.time()
    n_frames_done = 0

    def finish(seq, boxes):
        boxes = np.asarray(boxes, np.float64)
        results[seq.name] = boxes
        if result_dir:
            os.makedirs(result_dir, exist_ok=True)
            np.savetxt(os.path.join(result_dir, f"{seq.name}.txt"),
                       boxes, delimiter="\t", fmt="%d")
        if verbose:
            print(f"[{len(results)}/{len(mine)}] {seq.name}: "
                  f"{len(boxes)} frames")

    def load_next():
        while queue:
            seq = sequences[queue.pop(0)]
            if len(seq.frames) <= 1:
                # nothing to track beyond the init frame
                finish(seq, [list(seq.init_bbox)])
                continue
            feat_ref, lbs_ref, _ = driver.init_refs(imread(seq.frames[0]),
                                                    seq.init_bbox)
            return {"seq": seq, "feat_ref": feat_ref, "lbs_ref": lbs_ref,
                    "cursor": 1, "state": list(seq.init_bbox),
                    "boxes": [list(seq.init_bbox)]}
        return None

    for i in range(S):
        slots[i] = load_next()
    zero_frame = _zero_frame(driver)

    while any(s is not None for s in slots):
        live = [i for i, s in enumerate(slots) if s is not None]
        frames, scales = [], []
        for s in slots:
            f, r = ((zero_frame, None) if s is None   # empty: output dropped
                    else driver.preprocess(
                        imread(s["seq"].frames[s["cursor"]])))
            frames.append(f)
            scales.append(r)
        filler = slots[live[0]]
        feat_refs, lbs_refs = cache.get(lambda: (
            torch.stack([(s or filler)["feat_ref"] for s in slots]),
            torch.stack([(s or filler)["lbs_ref"] for s in slots])))
        packed = fn(feat_refs, lbs_refs, torch.cat(frames)).cpu().numpy()
        for i in live:
            s = slots[i]
            s["state"] = driver.update_state_from_packed(
                packed[i], scales[i], s["state"], driver.input_size)
            s["boxes"].append(list(s["state"]))
            s["cursor"] += 1
            n_frames_done += 1
            if s["cursor"] >= len(s["seq"].frames):
                finish(s["seq"], s["boxes"])
                slots[i] = load_next()
                cache.dirty = True
    if verbose:
        dt = max(time.time() - t0, 1e-9)
        print(f"parallel SOT: {len(mine)} seqs, {n_frames_done} frames, "
              f"{n_frames_done / dt:.1f} FPS aggregate over {S} slots")
    return _gathered(results, sequences, n, mesh, axis)


def _introduces_new_ids(seq):
    """True when a later annotated mask holds object ids absent from the
    frame-0 annotation (a YouTube-VOS mid-video entry, which needs the
    sequential add_objects protocol). Merely having later masks (DAVIS
    ships one a frame) does not take a sequence out of lockstep."""
    later = (seq.masks or [])[1:]
    if not later:
        return False
    ids0 = set(np.unique(read_indexed_mask(seq.masks[0]))) - {0}
    for mp in later:
        if (set(np.unique(read_indexed_mask(mp))) - {0}) - ids0:
            return True
    return False


def run_dataset_vos_parallel(driver, sequences, n_slots=None,
                             result_dir=None, max_seqs=None, verbose=True,
                             mesh=None, axis: str = "seq"):
    """Lockstep multi-sequence VOS on `n_slots` slots of one card, or over
    the ranks of `mesh` (module docstring). Sequences whose later
    annotated frames bring in new object ids (YouTube-VOS entries) go to
    the sequential run_sequence_vos, as JAX's runner sends them; the rest
    (DAVIS included, which annotates every frame but enters every object
    on frame 0) run in lockstep through the shared-reference function: one
    interaction and one K-row correlation a sequence a frame. Each slot
    holds a shallow copy of `driver` (the model shared, the sequence's
    state its own). Returns {seq.name: [label maps]}, as repeated
    run_sequence_vos."""
    from .running import run_sequence_vos

    n, mine, S = _share(sequences, max_seqs, n_slots, mesh, axis)
    fn = make_vos_shared_seq_parallel_fn(driver)
    parallel_idx, sequential_idx = [], []
    for i in mine:
        (sequential_idx if _introduces_new_ids(sequences[i])
         else parallel_idx).append(i)

    results = {}
    queue = list(parallel_idx)
    slots = [None] * S
    cache = _RefStackCache()
    t0 = time.time()
    n_frames_done = 0

    def write_out(seq, masks):
        results[seq.name] = masks
        if result_dir:
            out_dir = os.path.join(result_dir, seq.name)
            os.makedirs(out_dir, exist_ok=True)
            for path, m in zip(seq.frames, masks):
                name = os.path.splitext(os.path.basename(path))[0] + ".png"
                write_png(os.path.join(out_dir, name), m.astype(np.uint8))
        if verbose:
            print(f"[{len(results)}/{len(mine)}] {seq.name}: "
                  f"{len(masks)} frames")

    def load_next():
        while queue:
            seq = sequences[queue.pop(0)]
            mask0 = read_indexed_mask(seq.masks[0])
            if len(seq.frames) <= 1:
                write_out(seq, [mask0])
                continue
            drv = copy.copy(driver)   # the model shared; a state of its own
            drv.initialize(imread(seq.frames[0]), mask0)
            return {"seq": seq, "drv": drv, "cursor": 1, "masks": [mask0]}
        return None

    for i in range(S):
        slots[i] = load_next()
    zero_frame = _zero_frame(driver)

    while any(s is not None for s in slots):
        live = [i for i, s in enumerate(slots) if s is not None]
        frames, scales = [], []
        for s in slots:
            f, r = ((zero_frame, None) if s is None   # empty: output dropped
                    else s["drv"].preprocess(
                        imread(s["seq"].frames[s["cursor"]])))
            frames.append(f)
            scales.append(r)
        filler = slots[live[0]]
        feat_ref1s, lbs_refs = cache.get(lambda: (
            torch.stack([(s or filler)["drv"].feat_ref1 for s in slots]),
            torch.stack([(s or filler)["drv"].lbs_ref for s in slots])))
        dets, valid, masks = fn(feat_ref1s, lbs_refs, torch.cat(frames))
        for i in live:
            s = slots[i]
            out, _ = s["drv"].postprocess_masks_host(
                dets[i], valid[i], None if masks is None else masks[i],
                scales[i])
            s["masks"].append(out if out is not None
                              else np.zeros_like(s["masks"][0]))
            s["cursor"] += 1
            n_frames_done += 1
            if s["cursor"] >= len(s["seq"].frames):
                write_out(s["seq"], s["masks"])
                slots[i] = load_next()
                cache.dirty = True

    for i in sequential_idx:
        seq = sequences[i]
        results[seq.name] = run_sequence_vos(copy.copy(driver), seq,
                                             result_dir)
        if verbose:
            print(f"[{len(results)}/{len(mine)}] {seq.name} (sequential: "
                  f"mid-video object entries)")
    if verbose:
        dt = max(time.time() - t0, 1e-9)
        print(f"parallel VOS: {len(mine)} seqs, {n_frames_done} lockstep "
              f"frames, {n_frames_done / dt:.1f} FPS aggregate over {S} "
              f"slots")
    return _gathered(results, sequences, n, mesh, axis)
