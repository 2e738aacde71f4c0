"""Learning-rate and EMA schedules as plain functions of the iteration
(port of unicorn_tpu/core/schedule.py). `iters` is a Python number; the
result is a Python float."""
from __future__ import annotations

import math


def yolox_warm_cos_lr(lr: float, min_lr_ratio: float, total_iters: int,
                      warmup_total_iters: int, warmup_lr_start: float,
                      no_aug_iter: int, iters) -> float:
    """Quadratic warm-up -> cosine -> the no-augmentation floor."""
    iters = float(iters)
    min_lr = lr * min_lr_ratio
    if iters >= total_iters - no_aug_iter:
        return min_lr
    if iters <= warmup_total_iters:
        return ((lr - warmup_lr_start)
                * (iters / max(warmup_total_iters, 1)) ** 2 + warmup_lr_start)
    return min_lr + 0.5 * (lr - min_lr) * (1.0 + math.cos(
        math.pi * (iters - warmup_total_iters)
        / max(total_iters - warmup_total_iters - no_aug_iter, 1)))


def warm_cos_lr_fn(exp, batch_size, iters_per_epoch):
    """iteration -> learning rate of an experiment's fields: quadratic
    warm-up, cosine, the no-augmentation floor."""
    lr = exp.basic_lr_per_img * batch_size

    def lr_fn(step):
        return yolox_warm_cos_lr(
            lr, exp.min_lr_ratio,
            total_iters=exp.max_epoch * iters_per_epoch,
            warmup_total_iters=exp.warmup_epochs * iters_per_epoch,
            warmup_lr_start=exp.warmup_lr,
            no_aug_iter=exp.no_aug_epochs * iters_per_epoch,
            iters=step)

    return lr_fn


def warm_cos_lr(lr: float, total_iters: int, warmup_total_iters: int,
                warmup_lr_start: float, iters) -> float:
    """Linear warm-up -> cosine."""
    iters = float(iters)
    if iters <= warmup_total_iters:
        return ((lr - warmup_lr_start) * iters / max(warmup_total_iters, 1)
                + warmup_lr_start)
    return lr * 0.5 * (1.0 + math.cos(
        math.pi * (iters - warmup_total_iters)
        / max(total_iters - warmup_total_iters, 1)))


def multistep_lr(lr: float, milestones, gamma: float, iters) -> float:
    """Step decay: lr * gamma for every milestone reached."""
    return lr * gamma ** sum(1 for m in milestones if float(iters) >= m)


def ema_decay_schedule(base_decay: float, updates) -> float:
    """Exponentially ramped EMA decay: d(t) = base * (1 - exp(-t / 2000))."""
    return base_decay * (1.0 - math.exp(-float(updates) / 2000.0))
