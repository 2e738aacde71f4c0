"""SOT / VOS benchmark runs (the port's tools/test.py; the reference's
tools/test.py and its lib/test harness).

  python -m unicorn_torch.tools.test unicorn_sot --dataset lasot \
      -n unicorn_track_tiny -c Unicorn_outputs/unicorn_track_tiny/best
  python -m unicorn_torch.tools.test unicorn_vos --dataset dv2017 \
      -n unicorn_track_tiny_mask [--result-dir test_results] \
      [--max-seqs N] [--device cpu] [key value ...]

-f takes an experiment file, -n the name of one of unicorn_torch/exp/. The
model is the exp's served model (bf16 interaction where the exp says
serve_interact_bf16); its weights come from a checkpoint of the port's
Trainer (the EMA weights, else the weights), else from the exp's seeded
init (seed 0). The datasets are read under $UNICORN_DATADIR
(harness/datasets.py). SOT writes one <seq>.txt a sequence and prints the
OPE AUC / precision where the ground truth has more than the first frame;
VOS writes one PNG a frame and prints J&F over the annotated frames. Runs
on the card unless --device cpu.
"""
import argparse
import os

import numpy as np
import torch

from ..core.checkpoint import load_checkpoint
from ..data.image_io import read_indexed_mask
from ..exp.base import get_exp
from ..harness.datasets import get_dataset


def make_parser():
    p = argparse.ArgumentParser("unicorn_torch SOT/VOS test")
    p.add_argument("tracker", choices=["unicorn_sot", "unicorn_vos"])
    p.add_argument("--dataset", default="lasot")
    p.add_argument("-f", "--exp_file", default=None)
    p.add_argument("-n", "--name", default=None)
    p.add_argument("-c", "--ckpt", default=None)
    p.add_argument("--result-dir", default="test_results")
    p.add_argument("--max-seqs", type=int, default=None)
    p.add_argument("--parallel-seqs", type=int, default=0,
                   help="sequences in lockstep over a multi-card mesh: not "
                        "ported, N > 1 raises")
    p.add_argument("--device", default="cuda")
    # not argparse.REMAINDER: after a leading positional (the tracker name)
    # REMAINDER would swallow every following option
    p.add_argument("opts", nargs="*")
    return p


def _stem(path):
    return os.path.splitext(os.path.basename(path))[0]


def main(argv=None):
    """Returns {"results": {seq: (N, 4) boxes}} (SOT) or {"preds": {seq:
    [label maps]}} (VOS), with "metrics": the printed scores, or None."""
    args = make_parser().parse_args(argv)
    if args.parallel_seqs > 1:
        raise NotImplementedError(
            "--parallel-seqs > 1 (lockstep sequences over a multi-card "
            "mesh) is not ported: ROADMAP.md Queue 1 item 5, multi-GPU")
    exp = get_exp(args.exp_file, args.name)
    exp.merge(args.opts)
    model = exp.get_model(torch.Generator().manual_seed(0), serve=True)
    if args.ckpt:
        ckpt = load_checkpoint(os.path.dirname(args.ckpt) or ".",
                               os.path.basename(args.ckpt))
        model.load_state_dict(ckpt.get("ema_model") or ckpt["model"])

    sequences = get_dataset(args.dataset)
    if not sequences:
        print(f"dataset {args.dataset} not found under UNICORN_DATADIR")
        return None
    result_dir = os.path.join(args.result_dir, args.tracker, args.dataset)

    if args.tracker == "unicorn_sot":
        from ..drivers.sot import SOTDriver
        from ..harness.analysis import evaluate_sot
        from ..harness.running import run_dataset_sot

        results = run_dataset_sot(
            lambda: SOTDriver(model, exp.test_size, device=args.device),
            sequences, result_dir, max_seqs=args.max_seqs)
        gts = {s.name: s.ground_truth_rect for s in sequences
               if len(s.ground_truth_rect) > 1}
        metrics = evaluate_sot(results, gts) if gts else None
        if metrics:
            print(metrics)
        return {"results": results, "metrics": metrics}

    from ..drivers.vos import VOSDriver
    from ..harness.davis_metrics import evaluate_davis
    from ..harness.running import run_sequence_vos

    n = len(sequences) if args.max_seqs is None else args.max_seqs
    # the driver's object slots sized from the data: DAVIS 2017 has
    # 5-object sequences, YT-VOS more (VOSDriver raises on overflow)
    gt_by_seq = {seq.name: [read_indexed_mask(m) for m in seq.masks]
                 for seq in sequences[:n]}
    max_objs = max((len({int(i) for g in gts for i in np.unique(g) if i != 0})
                    for gts in gt_by_seq.values()), default=1)
    preds = {}
    for seq in sequences[:n]:
        driver = VOSDriver(model, exp.test_size, max_objects=max(1, max_objs),
                           use_raft=getattr(exp, "use_raft", False),
                           up_rate=getattr(exp, "up_rate", 8),
                           device=args.device)
        preds[seq.name] = run_sequence_vos(driver, seq, result_dir)
        print(f"{seq.name}: {len(preds[seq.name])} frames")
    # predictions aligned to the ANNOTATED frames by stem: YT-VOS valid
    # ships sparse annotations (first-appearance frames only)
    gts, preds_aligned = {}, {}
    for seq in sequences[:n]:
        frame_idx = {_stem(p): i for i, p in enumerate(seq.frames)}
        sel = [(frame_idx[_stem(m)], g)
               for m, g in zip(seq.masks, gt_by_seq[seq.name])
               if _stem(m) in frame_idx]
        gts[seq.name] = [g for _, g in sel]
        preds_aligned[seq.name] = [preds[seq.name][i] for i, _ in sel]
    metrics = evaluate_davis(preds_aligned, gts)
    print(metrics)
    return {"preds": preds, "metrics": metrics}


if __name__ == "__main__":
    main()
