"""The uni stage's training step on one card: `ExpTrack.get_train_step` on a
`TrainState` (AdamW, gradient accumulation, EMA) at the configuration's
fields, fed from a ring of batches made on the card from --seed (SOT and
MOT batches alternating, as `alter_step` 1 sets), as if the loader kept up.

Set-up builds the model (the traffic's `weights_seed` draw of weights, made
on the card: the model is the configuration's, the data the seed's) and the
state,
places the state at `start_iter` of the schedule (a run past its warm-up,
whose learning rate is not 0), and drives it through `check_steps` steps on
the ring's first batches with the window's own call, keeping what the
check compares. The window then runs the same state for --seconds.

End to end: `train_pairs_per_s` (pairs trained over the window's seconds,
the window ending in a synchronise), `setup_s` (process start to the first
timed step). With --trace 1 the second half profiles `profile_steps`
steps; the first half's rate feeds the model's share of the peak.

Correct: the plain reference (benchmark/reference/, fp32, TF32 off) runs
the same `check_steps` steps from the same weights and batches after
the window, with the program freed. Compared, each as a share:
- `loss_gap`: the largest gap between the program's and the reference's
  total loss of a step, over the reference's;
- `grad_gap`: the worst tensor's gap between the norms of the first
  gradient the optimizer got (the program's worked out from AdamW's first
  moment, exp_avg / (1 - beta1), after its first update) and the
  reference's, over the larger of the reference tensor's norm and the
  median tensor's;
- `grad_gap_median`: the same gap of the median tensor;
- `update_gap`: the worst tensor's gap of the parameters' change after the
  check steps (with `check_steps` 4 and accumulation 2, two updates);
- `ema_gap`: the worst tensor's gap of the EMA copy's change after the
  check steps (the EMA moves on every micro-step);
- `simota_off`: the share of SimOTA's foreground anchors, over the check
  steps' calls, that the reference's SimOTA run on the program's own
  inputs assigns otherwise;
- `simota_unfollowed`: 1 where the reference could not follow the
  program's SimOTA calls (another batch or anchor count, another number of
  calls), and then compares under its own assignment; else 0.
Tensors whose reference gradient is under a thousandth of the median
tensor's are left out of the gradient and change gaps (their change is
round-off). The reference follows the program's SimOTA assignment, call by
call (checked apart by `simota_off`): the assignment is discrete, and one
anchor that bf16 moves to another level or count changes the loss's
normaliser for every term (PERF.md gives the seeds and the look). Beside
the checks, `loss_gap_own_assignment` is printed, not compared: the
largest gap of a step's loss against the reference's loss of the same
forward under its own SimOTA.

The check steps are set-up's, not the window's: the window runs the same
call on the same state, and a reference that followed the window's steps
would take longer than the window.
"""
from __future__ import annotations

import statistics
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass

import torch

from benchmark import flops, harness, synth, weights
from benchmark import trace as tracing
from benchmark.reference import losses as ref_losses
from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train
from benchmark.reference.precision import QUANTISERS

BETA1 = 0.9


@dataclass
class Readings:
    """What the check compares, of the program, the reference or the
    control, by tensor in named_parameters order: the check steps' losses,
    the norms of the first update's gradient, of the parameters' change and
    of the EMA copy's change, and the SimOTA calls recorded."""
    names: list
    losses: list
    grads: torch.Tensor
    changes: torch.Tensor
    ema: torch.Tensor
    calls: list


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_batches(cell, seed, device):
    """[(images (B, 2, 3, H, W) float in [0, 255], targets (B, 2, M, 6)
    [cls, cx, cy, w, h, track id], task_ids (B,))] of the ring."""
    tr, e = cell.traffic, cell.cfg["exp_fields"]
    H, W = e["input_size"]
    B, M = tr["pairs"], tr["max_labels"]
    out = []
    for t in range(tr["ring"]):
        task = tr["tasks"][t % len(tr["tasks"])]
        K = tr["objects"][str(task)]
        frames, boxes = synth.video(B, 2, H, W, K, tr["object_px"],
                                    tr["shift_px"], seed * 7919 + t, device)
        g = torch.Generator(device=device)
        g.manual_seed((seed * 7919 + t) % 2 ** 63)
        cls = (torch.randint(0, e["num_classes"], (B, 1, K), generator=g,
                             device=device).float() if task == 2
               else torch.zeros(B, 1, K, device=device))
        targets = torch.zeros(B, 2, M, 6, device=device)
        targets[:, :, :K, 0] = cls
        targets[:, :, :K, 1:5] = boxes
        targets[:, :, :K, 5] = torch.arange(1, K + 1, device=device).float()
        images = frames.permute(0, 1, 4, 2, 3).float().contiguous()
        out.append((images, targets,
                    torch.full((B,), task, dtype=torch.int64, device=device)))
    return out


def build_program(cell, device):
    """(exp, state, step) of the program, the traffic's `weights_seed` draw
    of weights, the state at the traffic's `start_iter`."""
    from unicorn_torch.core.train_state import TrainState, rewind_opt_counts

    tr = cell.traffic
    exp = harness.program_exp(cell.cfg)
    model = harness.program_model(exp, device, serve=False)
    weights.load_seeded(model, tr["weights_seed"], cell.cfg["prior_raise"])
    model.train()
    iters = exp.samples_per_epoch // tr["global_batch"]
    state = TrainState.create(
        model, exp.get_optimizer(tr["global_batch"], iters),
        use_ema=exp.ema, device=device)
    acc = exp.grad_acc_step if exp.use_grad_acc else 1
    rewind_opt_counts(state, tr["start_iter"] // acc, tr["start_iter"])
    return exp, state, exp.get_train_step(tr["pairs"])


class AssignCalls:
    """While active, records every call of a module's `simota_assign`: its
    inputs and its result (the program's, or the reference's own)."""

    def __init__(self, module, dtype=None):
        self.module, self.dtype, self.calls = module, dtype, []

    def __enter__(self):
        self.sound = self.module.simota_assign

        def recorded(*args):
            kw = {"dtype": self.dtype} if self.dtype is not None else {}
            out = self.sound(*args, **kw)
            self.calls.append((tuple(a.detach().clone()
                                     if torch.is_tensor(a) else a
                                     for a in args), out))
            return out

        self.module.simota_assign = recorded
        return self

    def __exit__(self, *exc):
        self.module.simota_assign = self.sound


class Unfollowable(Exception):
    """The program's SimOTA calls do not match the reference's."""


class Following:
    """While active, the reference's SimOTA returns, call by call, the
    assignment `calls` recorded (fg anchors and matched gts; its own boxes
    give pred_iou). A call beyond the recorded ones, or of another batch or
    anchor count, raises Unfollowable; so does leaving with calls unread.
    `own()` is a context in which SimOTA is the reference's own again."""

    def __init__(self, calls):
        self.calls = list(calls)

    def __enter__(self):
        self.sound = ref_losses.simota_assign
        self.used = 0

        def follow(gt_boxes, gt_classes, gt_valid, pred_boxes, *rest):
            if self.used >= len(self.calls):
                raise Unfollowable(
                    f"the reference made SimOTA call {self.used + 1}; the "
                    f"program made {len(self.calls)}")
            _, prog = self.calls[self.used]
            self.used += 1
            if prog.fg_mask.shape != pred_boxes.shape[:2]:
                raise Unfollowable(
                    f"SimOTA call {self.used}: the program assigned "
                    f"{tuple(prog.fg_mask.shape)} anchors, the reference "
                    f"asks for {tuple(pred_boxes.shape[:2])}")
            return ref_losses.following(prog.fg_mask, prog.matched_gt,
                                        gt_boxes, gt_valid, pred_boxes)

        ref_losses.simota_assign = follow
        return self

    def __exit__(self, exc_type, *exc):
        ref_losses.simota_assign = self.sound
        if exc_type is None and self.used != len(self.calls):
            raise Unfollowable(f"the reference read {self.used} of the "
                               f"program's {len(self.calls)} SimOTA calls")

    @contextmanager
    def own(self):
        follow = ref_losses.simota_assign
        ref_losses.simota_assign = self.sound
        try:
            yield
        finally:
            ref_losses.simota_assign = follow


def simota_off(calls) -> float:
    """The share of the recorded calls' foreground anchors (either side's)
    whose assignment the fp32 reference SimOTA, run on the same inputs,
    gives otherwise (not foreground, or another gt)."""
    off = total = 0
    for args, out in calls:
        ref = ref_losses.simota_assign(*args)
        both = out.fg_mask | ref.fg_mask
        differ = (out.fg_mask != ref.fg_mask) | (
            out.fg_mask & (out.matched_gt != ref.matched_gt))
        off += int(differ.sum())
        total += int(both.sum())
    return off / max(total, 1)


def _norms(tensors):
    return torch.stack([t.detach().float().norm() for t in tensors]).cpu()


def check_readings(state, step, batches, n_steps) -> Readings:
    """The program's readings over its first n_steps steps (a state without
    an EMA copy reads an EMA change of 0)."""
    names = [n for n, _ in state.model.named_parameters()]
    params = [p for _, p in state.model.named_parameters()]
    p0 = [p.detach().clone() for p in params]
    ema = (dict(state.ema_model.named_parameters())
           if state.ema_model is not None else None)
    ema = [ema[n] for n in names] if ema is not None else None
    e0 = [e.detach().clone() for e in ema] if ema is not None else None
    losses, g_norms = [], None
    updates = state.opt_count
    from unicorn_torch.losses import det

    with AssignCalls(det) as rec:
        for t in range(n_steps):
            _, ld = step(state, *batches[t])
            losses.append({k: float(v) for k, v in ld.items()})
            if g_norms is None and state.opt_count > updates:
                g_norms = _norms([
                    state.optimizer.state[p]["exp_avg"] / (1 - BETA1)
                    if p in state.optimizer.state else torch.zeros_like(p)
                    for p in params])
    d_norms = _norms([p.detach() - q for p, q in zip(params, p0)])
    e_norms = (_norms([e.detach() - q for e, q in zip(ema, e0)])
               if ema is not None else torch.zeros(len(names)))
    return Readings(names, losses, g_norms, d_norms, e_norms, rec.calls)


def run(cell, args, device, start_wall):
    tr = cell.traffic
    t_b = time.time()
    exp, state, step = build_program(cell, device)
    t_r = time.time()
    batches = make_batches(cell, args.seed, device)
    R = len(batches)
    t_c = time.time()
    prog = check_readings(state, step, batches, tr["check_steps"])
    losses = prog.losses
    _sync(device)
    print(f"set-up: {t_b - start_wall:.3f} s to the kind, program "
          f"{t_r - t_b:.3f} s, batches {t_c - t_r:.3f} s, check steps "
          f"{time.time() - t_c:.3f} s", file=sys.stderr)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - start_wall
    half = args.seconds / 2 if args.trace else float("inf")
    prof_box, prof_window = {}, 0.0
    plain_steps = plain_end = None
    k = tr["check_steps"]
    n = 0
    mid = None
    t_start = time.perf_counter()
    while True:
        now = time.perf_counter() - t_start
        if now >= args.seconds:
            break
        if mid is None and now >= args.seconds / 2:
            _sync(device)
            mid = (n, time.perf_counter() - t_start)
        if now >= half and plain_steps is None:
            _sync(device)
            plain_steps, plain_end = n, time.perf_counter() - t_start
        if plain_steps is not None and not prof_box:
            with tracing.profiled(device.type == "cuda") as prof_box:
                p0 = time.perf_counter()
                for _ in range(tr["profile_steps"]):
                    with torch.profiler.record_function(tracing.LABEL
                                                        + "step"):
                        step(state, *batches[(k + n) % R])
                    n += 1
                prof_window = time.perf_counter() - p0
            prof_box = prof_box or {"events": []}
            continue
        step(state, *batches[(k + n) % R])
        n += 1
    _sync(device)
    window_s = time.perf_counter() - t_start
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    B = tr["pairs"]
    e2e = {"train_pairs_per_s": B * n / window_s, "setup_s": setup_s}
    if mid and n > mid[0]:
        print(f"uni_step: pairs/s of the halves {B * mid[0] / mid[1]:.4f}, "
              f"{B * (n - mid[0]) / (window_s - mid[1]):.4f}", flush=True)
    print(f"uni_step: {n} steps of {B} pairs in {window_s:.3f} s; setup "
          f"{setup_s:.3f} s; check-step losses "
          f"{[x['total_loss'] for x in losses]}", flush=True)
    layer_ctx = None
    if args.trace:
        layer_ctx = {
            "trace": tracing.reduce(prof_box.get("events", []), prof_window),
            "rate": ({"steps_per_s": plain_steps / plain_end}
                     if plain_steps else {}),
            "flops_per_step": flops.train_flops_per_step(
                cell.cfg, B, tr["max_labels"]),
            "peak_mem_bytes_window": peak,
            "exp": cell.cfg["exp_fields"], "batch": B, "mode": "train",
        }
    del state, step
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = compare(cell.limits, prog,
                     *followed_reference(cell, device, batches, prog.calls))
    return {"attempted": n * B, "failed": 0, "e2e": e2e, "checks": checks,
            "memory_peak_bytes": peak, "layer_ctx": layer_ctx}


def followed_reference(cell, device, batches, calls):
    """(the reference's readings following the SimOTA calls `calls`, 0);
    where it cannot follow them (the program assigned another batch or
    anchor count, or made another number of calls), (its readings under its
    own SimOTA, 1): the run is then not correct."""
    try:
        return reference_readings(cell, device, batches, follow=calls), 0
    except Unfollowable as e:
        print(f"reference: {e}; compared under its own SimOTA",
              file=sys.stderr)
    # outside the handler, so that the failed attempt's tensors are freed
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return reference_readings(cell, device, batches), 1


def reference_readings(cell, device, batches, q_main="exact",
                       q_inter="exact", follow=None, simota_dtype=None):
    """The plain reference's readings over the check steps, following the
    assignment of the SimOTA calls `follow` (the program's) where given,
    each step's loss under its own assignment beside; with q_main / q_inter
    below exact and SimOTA in `simota_dtype`, the control's."""
    tr, e = cell.traffic, cell.cfg["exp_fields"]
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        m = ref_model.build(e, device)
        weights.load_seeded(m, tr["weights_seed"], cell.cfg["prior_raise"])
        ref_model.set_quantisers(m, QUANTISERS[q_main], QUANTISERS[q_inter])
        m.train()
        named = list(m.named_parameters())
        p0 = [p.detach().clone() for _, p in named]
        iters = e["samples_per_epoch"] // tr["global_batch"]
        lr = e["basic_lr_per_img"] * tr["global_batch"]

        def lr_fn(it):
            return ref_train.warm_cos_lr(
                lr, e["min_lr_ratio"], e["max_epoch"] * iters,
                e["warmup_epochs"] * iters, e["warmup_lr"],
                e["no_aug_epochs"] * iters, it)

        acc = e["grad_acc_step"] if e["use_grad_acc"] else 1
        opt = ref_train.AdamWAccum(named, lr_fn, e["weight_decay"], acc,
                                   tr["start_iter"])
        ema = ref_train.EMA([p for _, p in named], tr["start_iter"])
        mot_w = float(e["mot_weight"]) if e["scale_all_mot"] else 1.0
        losses = []
        assign = (Following(follow) if follow is not None
                  else AssignCalls(ref_losses, simota_dtype))
        with assign:
            g_norms = _reference_steps(
                m, opt, ema, batches, tr["check_steps"], e, mot_w, q_inter,
                losses, assign.own if follow is not None else None)
        d_norms = _norms([p.detach() - q for (_, p), q in zip(named, p0)])
        e_norms = _norms([x - q for x, q in zip(ema.ema, p0)])
        calls = assign.calls if follow is None else []
        return Readings([n for n, _ in named], losses, g_norms, d_norms,
                        e_norms, calls)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _reference_steps(m, opt, ema, batches, n, e, mot_w, q_inter, losses,
                     own_assign):
    """n reference steps (loss, backward, the optimizer's micro-step, the
    EMA's), each step's losses appended to `losses`; returns the norms of
    the first update's gradient, or None."""
    first = None
    for t in range(n):
        total, parts = ref_train.uni_loss(
            m, *batches[t], tuple(e["input_size"]), mot_w, e["bidirect"],
            e["always_l1"], q_inter=QUANTISERS[q_inter],
            own_assign=own_assign)
        total.backward()
        losses.append({k: float(v.detach()) for k, v in parts.items()})
        opt.step()
        ema.update()
        if first is None and opt.applied is not None:
            first = _norms(opt.applied)
    return first


def _tensor_gaps(names_p, a, names_r, b, g_ref):
    """(the worst, the median) tensor's |norm_a - norm_b| / max(norm_b,
    median norm_b), over tensors whose reference gradient is at least a
    thousandth of the median's; a missing reading counts as a gap of 1."""
    if a is None or b is None:
        return 1.0, 1.0
    ia = dict(zip(names_p, a.tolist()))
    ib = dict(zip(names_r, b.tolist()))
    ig = dict(zip(names_r, g_ref.tolist()))
    med_g = statistics.median(ig.values())
    keep = [n for n in names_r if ig[n] >= 1e-3 * med_g]
    med = statistics.median(ib[n] for n in keep)
    gaps = {n: abs(ia.get(n, 0.0) - ib[n]) / max(ib[n], med, 1e-30)
            for n in keep}
    worst = sorted(gaps, key=gaps.get)[-3:]
    print(f"  worst tensors: "
          f"{[(n, gaps[n], ia.get(n), ib[n]) for n in worst]}"
          f"; median gap {statistics.median(gaps.values()):.4g}, "
          f"{len(keep)} of {len(names_r)} tensors", file=sys.stderr)
    return max(gaps.values()), statistics.median(gaps.values())


def _rel_gap(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def compare(limits, prog, ref, unfollowed=0):
    """[(name, value, limit)] of the program's (or the control's) readings
    `prog` against the reference's `ref` that followed its assignment
    (`unfollowed` 1: that could not)."""
    loss_p, loss_r = prog.losses, ref.losses
    gaps = [_rel_gap(a["total_loss"], b["total_loss"])
            for a, b in zip(loss_p, loss_r)]
    own = [_rel_gap(a["total_loss"], b["total_loss_own"])
           for a, b in zip(loss_p, loss_r) if "total_loss_own" in b]
    if own:
        print(f"reported, not compared: loss_gap_own_assignment "
              f"{max(own)!r} (by step {[round(g, 6) for g in own]})",
              file=sys.stderr)
    for t, (a, b) in enumerate(zip(loss_p, loss_r)):
        parts = sorted(((_rel_gap(a.get(k, 0.0), v), k) for k, v in b.items()
                        if abs(v) > 1e-6 and k != "total_loss_own"),
                       reverse=True)[:3]
        print(f"  step {t}: loss gap {gaps[t]:.4g}; widest terms "
              + ", ".join(f"{k} {g:.3g} ({a.get(k)} vs {b[k]})"
                          for g, k in parts), file=sys.stderr)
    loss_gap = max(gaps)
    if any(a["total_loss"] != a["total_loss"] for a in loss_p):
        loss_gap = 1e30                  # a non-finite loss
    g_r = ref.grads
    grad_gap, grad_median = _tensor_gaps(prog.names, prog.grads, ref.names,
                                         g_r, g_r)
    update_gap, _ = _tensor_gaps(prog.names, prog.changes, ref.names,
                                 ref.changes, g_r)
    ema_gap, _ = _tensor_gaps(prog.names, prog.ema, ref.names, ref.ema, g_r)
    return [("loss_gap", loss_gap, limits["loss_gap"]),
            ("grad_gap", grad_gap, limits["grad_gap"]),
            ("grad_gap_median", grad_median, limits["grad_gap_median"]),
            ("update_gap", update_gap, limits["update_gap"]),
            ("ema_gap", ema_gap, limits["ema_gap"]),
            ("simota_off", simota_off(prog.calls), limits["simota_off"]),
            ("simota_unfollowed", unfollowed, limits["simota_unfollowed"])]
