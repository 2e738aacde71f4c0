"""The plain reference of the uni stage's training step: the two-frame
forward, the SOT priors by correlation, the head with the prior pyramid,
the unified loss with MOT-helps-SOT, the update (the mean of
`grad_accum` micro-steps' gradients, then AdamW with decay on kernels only,
at the learning rate of the exps' warm-up-cosine schedule) and the EMA copy
of the parameters, moved on every micro-step. A frozen copy
of `unicorn_torch/core/train_step.py` (`uni_forward_embeddings`,
`uni_loss_fn`), `core/train_state.py` and `core/schedule.py`, with AdamW
and the EMA copy written out.
"""
from __future__ import annotations

import math

import torch

from .losses import (build_mhs_labels, build_sot_priors, resize_bilinear,
                     unicorn_uni_loss)


def uni_loss(model, images, targets, task_ids, img_size, mot_weight,
             bidirect=True, use_l1=True, mhs_weight=0.5, q_inter=None,
             own_assign=None):
    """(total, loss dict) of a (B, 2, 3, H, W) batch. With `own_assign`, a
    context in which SimOTA is the reference's own, the dict also holds
    `total_loss_own`: the same forward's total loss under that assignment,
    without gradient."""
    B = images.shape[0]
    flat = images.transpose(0, 1).reshape(2 * B, *images.shape[2:])
    fpn_outs, feat16 = model.forward_backbone(flat)
    fpn_1 = tuple(x[B:] for x in fpn_outs)
    new0, new1 = model.forward_interaction(feat16[:B].float(),
                                           feat16[B:].float())
    embed_0, embed_1 = model.forward_upsample(new0), model.forward_upsample(new1)
    pred_prior, gt_lbs1 = build_sot_priors(embed_0, embed_1, targets,
                                           img_size, task_ids, q_inter)
    H8, W8 = pred_prior.shape[2:]

    def pyramid(p):
        return (p, resize_bilinear(p, H8 // 2, W8 // 2),
                resize_bilinear(p, H8 // 4, W8 // 4))

    head_raw = model.forward_head(fpn_1, pyramid(pred_prior))
    mhs_targets, has_pair = build_mhs_labels(targets)
    mhs_task = ((task_ids == 2) & has_pair).to(task_ids.dtype)
    mhs_prior, mhs_gt1 = build_sot_priors(embed_0, embed_1, mhs_targets,
                                          img_size, mhs_task, q_inter)
    mhs_raw = model.forward_head(fpn_1, pyramid(mhs_prior))

    def losses():
        out = unicorn_uni_loss(head_raw, embed_0, embed_1, pred_prior,
                               gt_lbs1, targets, task_ids, img_size,
                               mot_weight=mot_weight, bidirect=bidirect,
                               use_l1=use_l1)
        mhs = unicorn_uni_loss(mhs_raw, embed_0, embed_1, mhs_prior, mhs_gt1,
                               mhs_targets, mhs_task, img_size,
                               use_l1=use_l1, sot_only=True)
        n_mhs = (mhs_task == 1).float().sum().clamp_min(1.0)
        out["mhs_loss"] = mhs["total_loss"] * B / n_mhs
        out["total_loss"] = out["total_loss"] + mhs_weight * out["mhs_loss"]
        return out

    out = losses()
    if own_assign is not None:
        with torch.no_grad(), own_assign():
            out["total_loss_own"] = losses()["total_loss"]
    return out["total_loss"], out


def warm_cos_lr(lr, min_lr_ratio, total_iters, warmup_iters, warmup_lr_start,
                no_aug_iters, iters):
    """YOLOX's schedule: quadratic warm-up, cosine, the no-augmentation
    floor."""
    min_lr = lr * min_lr_ratio
    if iters >= total_iters - no_aug_iters:
        return min_lr
    if iters <= warmup_iters:
        return ((lr - warmup_lr_start) * (iters / max(warmup_iters, 1)) ** 2
                + warmup_lr_start)
    return min_lr + 0.5 * (lr - min_lr) * (1.0 + math.cos(
        math.pi * (iters - warmup_iters)
        / max(total_iters - warmup_iters - no_aug_iters, 1)))


class AdamWAccum:
    """Gradient accumulation (the running mean of `accum` micro-steps) and
    AdamW (betas 0.9 / 0.999, eps 1e-8 outside the root, decoupled decay on
    tensors of two or more dimensions except the head's fuse scales)."""

    def __init__(self, named_params, lr_fn, weight_decay, accum, start_iter):
        self.params = [p for _, p in named_params]
        self.decay = [p.ndim > 1 and not n.rpartition(".")[2].startswith(
            "beta_") for n, p in named_params]
        self.lr_fn, self.wd, self.accum = lr_fn, weight_decay, accum
        self.opt_count = start_iter // accum
        self.mini = 0
        self.t = 0
        self.acc = [torch.zeros_like(p) for p in self.params]
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.applied = None   # the gradient of the last update

    @torch.no_grad()
    def step(self):
        self.mini += 1
        for a, p in zip(self.acc, self.params):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            a.add_((g - a) / self.mini)
            p.grad = None
        if self.mini < self.accum:
            return
        lr = self.lr_fn(self.opt_count * self.accum)
        self.t += 1
        c1, c2 = 1 - 0.9 ** self.t, 1 - 0.999 ** self.t
        for p, g, m, v, dec in zip(self.params, self.acc, self.m, self.v,
                                   self.decay):
            if dec:
                p.mul_(1 - lr * self.wd)
            m.mul_(0.9).add_(g, alpha=0.1)
            v.mul_(0.999).addcmul_(g, g, value=0.001)
            p.addcdiv_(m / c1, (v / c2).sqrt_().add_(1e-8), value=-lr)
        self.applied = [g.clone() for g in self.acc]
        for a in self.acc:
            a.zero_()
        self.mini = 0
        self.opt_count += 1


class EMA:
    """The exponential moving average of the parameters (YOLOX's ModelEMA:
    decay 0.9998 ramped as 1 - exp(-step / 2000)), moved after every
    micro-step, also where the parameters did not move; `step` counts the
    micro-steps from the schedule position the state starts at."""

    def __init__(self, params, step, base=0.9998, ramp=2000.0):
        self.params = list(params)
        self.ema = [p.detach().clone() for p in self.params]
        self.step, self.base, self.ramp = step, base, ramp

    @torch.no_grad()
    def update(self):
        self.step += 1
        d = self.base * (1.0 - math.exp(-self.step / self.ramp))
        for e, p in zip(self.ema, self.params):
            e.mul_(d).add_(p, alpha=1.0 - d)
