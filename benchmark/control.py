"""The control of a cell's `correct`: the plain reference put in the
program's place, one precision below what the configuration states (fp8
where it computes in bf16, bf16 where it computes in fp32), read by the
same comparisons as a benchmark run. Each reading has to come out above its
limit; the smallest over the seeds is the limit's upper reading (PERF.md).

    python3 benchmark/control.py --workload <name> --seeds 1 2 3

With --fault, the program itself with a fault planted in its training
step (half of the batch left out; a step that leaves its state unchanged;
one that leaves its EMA copy unchanged), the faults a training cell's
numbers are also held against.

On the card; the benchmark's own runs never run it. Prints one JSON line a
seed: {"seed", "fault", "readings": {name: value}}.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.reference import postprocess as ref_post  # noqa: E402
from benchmark.reference.precision import bf16  # noqa: E402


def mot_control(cell, seed, device, ticks: int) -> dict:
    """The mot_streams comparisons of a control pipeline run for `ticks`
    ticks: letterbox in bf16, the model in fp8, decode and NMS in bf16, the
    tracker's floats in bf16."""
    from benchmark.kinds import mot_streams as ms

    tr, exp = cell.traffic, cell.cfg["exp_fields"]
    pl = tr["pipeline"]
    in_hw = tuple(exp["test_size"])
    ring = ms.frame_ring(cell, seed, device)
    ctl = ms.reference_model(cell, device, q_main="fp8")
    keep = set(range(0, ticks, max(ticks // tr["check_ticks"], 1)))
    sample, dets, tracks = [], [], []
    ts = ms.ref_tracker.init_state(pl["max_tracks"], tr["streams"], device)
    with torch.no_grad():
        for i in range(ticks):
            r = i % ring.shape[0]
            lb = ref_post.letterbox(ring[r].to(device), in_hw,
                                    dtype=torch.bfloat16)
            head = ctl.forward_whole(lb.permute(0, 3, 1, 2))
            d, v = ref_post.nms(ref_post.decode(head, dtype=torch.bfloat16),
                                exp["num_classes"], exp["test_conf"],
                                exp["nmsthre"], pl["n_cand"], pl["max_dets"],
                                cluster_iters=8, dtype=torch.bfloat16)
            ts, out, ov = ms.ref_tracker.tracker_step(
                ts, d, v, pl["track_thresh"], pl["match_thresh"],
                pl["track_buffer"], q=bf16)
            dets.append((d, v))
            tracks.append(torch.cat([out, ov[..., None].float()], -1).cpu())
            if i in keep:
                sample.append((i, r, lb, head))
    del ctl
    checks = ms.check(cell, device, ring, sample, dets, tracks, in_hw)
    return {name: v for name, v, _ in checks}


def uni_control(cell, seed, device) -> dict:
    from benchmark.kinds import uni_step as us

    batches = us.make_batches(cell, seed, device)
    ctl = us.reference_readings(cell, device, batches, q_main="fp8",
                                q_inter="bf16", simota_dtype=torch.bfloat16)
    return {name: v for name, v, _ in us.compare(
        cell.limits, ctl, *us.followed_reference(cell, device, batches,
                                                 ctl.calls))}


def _half_batch():
    """The uni loss over the first half of the batch only."""
    from unicorn_torch.core import train_step

    loss = train_step.uni_loss_fn

    def half(model, images, targets, task_ids, *a, **kw):
        n = images.shape[0] // 2
        return loss(model, images[:n], targets[:n], task_ids[:n], *a, **kw)

    return train_step, "uni_loss_fn", half


def _unchanged():
    """A step that drops its gradients and leaves the state as it was."""
    from unicorn_torch.core.train_state import TrainState

    def unchanged(self):
        for p in self.model.parameters():
            p.grad = None
        self.step += 1
        return self

    return TrainState, "apply_gradients", unchanged


def _ema_unchanged():
    """A step that updates the parameters and leaves the EMA copy as it
    was."""
    from unicorn_torch.core.train_state import TrainState

    sound = TrainState.apply_gradients

    def ema_unchanged(self):
        ema, self._ema = self._ema, None
        try:
            return sound(self)
        finally:
            self._ema = ema

    return TrainState, "apply_gradients", ema_unchanged


FAULTS = {"half_batch": _half_batch, "unchanged": _unchanged,
          "ema_unchanged": _ema_unchanged}


def uni_fault(cell, seed, device, fault) -> dict:
    """The uni_step comparisons of the program with `fault` planted in it,
    over the check steps (no window)."""
    from benchmark.kinds import uni_step as us

    owner, name, broken = FAULTS[fault]()
    sound = getattr(owner, name)
    setattr(owner, name, broken)
    try:
        _, state, step = us.build_program(cell, device)
        batches = us.make_batches(cell, seed, device)
        prog = us.check_readings(state, step, batches,
                                 cell.traffic["check_steps"])
    finally:
        setattr(owner, name, sound)
    del state, step
    torch.cuda.empty_cache()
    return {n: v for n, v, _ in us.compare(
        cell.limits, prog, *us.followed_reference(cell, device, batches,
                                                  prog.calls))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--ticks", type=int, default=40,
                   help="ticks of a serving control (default 40)")
    p.add_argument("--fault", choices=sorted(FAULTS),
                   help="instead of the control, the program with this "
                        "fault planted in its training step")
    args = p.parse_args(argv)
    cell = harness.Cell(args.workload, harness.manifest())
    device = torch.device("cuda", 0)
    kind = cell.traffic["kind"]
    for seed in args.seeds:
        if args.fault:
            r = uni_fault(cell, seed, device, args.fault)
        elif kind == "mot_streams":
            r = mot_control(cell, seed, device, args.ticks)
        elif kind == "uni_step":
            r = uni_control(cell, seed, device)
        else:
            raise ValueError(f"no control for traffic kind {kind!r}")
        print(json.dumps({"seed": seed, "fault": args.fault,
                          "readings": r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
