"""Train state: model, its EMA copy, the optimizer and the step count (port
of unicorn_tpu/core/train_state.py).

The JAX package keeps parameters, optimizer state and EMA in one immutable
pytree and returns a new one each step; here the state owns an nn.Module and
updates it in place. `make_optimizer` returns a description of the update
rule (what optax calls a gradient transformation); `TrainState.create` turns
it into a torch.optim optimizer over the model's parameters.

How the update rule maps onto optax's, which the tests hold it to:
  * `optax.adamw` (eps outside the root, decay added to the update before the
    learning rate) is `torch.optim.AdamW` algebraically; decay applies where
    `default_wd_mask` says, which selects the same tensors on torch shapes
    as `p.ndim > 1` does on flax shapes.
  * `optax.MultiSteps` averages the gradients of `grad_accum` micro-steps
    (a running mean) and runs the inner update once per `grad_accum`; the
    schedule is read at `count * grad_accum`, in iteration units.
  * `apply_gradients` advances `step` and updates the EMA on every
    micro-step, also on those where the parameters did not move. The EMA
    runs over every parameter, frozen ones too, as JAX's does.
  * `state_dict` / `load_state_dict` carry what optax keeps in one state
    tree: the optimizer's moments and per-parameter step counts, the
    counters and the accumulator, beside the model and its EMA copy.
  * Frozen parameters (`trainable_mask_fn`): JAX chains
    `optax.masked(optax.set_to_zero(), frozen)` after the whole update, so
    a frozen parameter neither moves nor decays. Here it is left out of
    the optimizer's groups and set `requires_grad_(False)`, so that the
    backward does not reach it either; its optimizer state (which JAX keeps
    and never reads) does not exist.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn as nn

from ..device import resolve_device
from ..utils.profiling import span, spanned
from .schedule import ema_decay_schedule


@dataclass(frozen=True)
class OptimizerSpec:
    """The update rule `make_optimizer` describes."""
    lr_fn: Callable
    kind: str = "adamw"
    weight_decay: float = 1e-4
    momentum: float = 0.9
    grad_accum: int = 1
    max_grad_norm: Optional[float] = None
    no_decay_mask_fn: Optional[Callable] = None
    trainable_mask_fn: Optional[Callable] = None


def default_wd_mask(named_params) -> dict:
    """{name: True where weight decay applies}: kernels of two or more
    dimensions only, not biases, scales or norms. The head's fuse scales
    `beta_k` are vectors in the JAX package and are kept as (1, C, 1, 1)
    here for broadcasting: they do not decay either."""
    return {name: p.ndim > 1 and not name.rpartition(".")[2].startswith("beta_")
            for name, p in named_params}


def make_optimizer(lr_fn: Callable, kind: str = "adamw",
                   weight_decay: float = 1e-4, momentum: float = 0.9,
                   grad_accum: int = 1,
                   max_grad_norm: Optional[float] = None,
                   no_decay_mask_fn: Optional[Callable] = None
                   ) -> OptimizerSpec:
    """AdamW for the uni stage, SGD with Nesterov momentum for detection
    pretraining. lr_fn maps the iteration to the learning rate. Without a
    mask function weight decay applies to every parameter. Every parameter
    trains; an experiment that freezes some sets the spec's
    `trainable_mask_fn` (named_params -> {name: True where it trains})."""
    if kind not in ("adamw", "sgd"):
        raise ValueError(kind)
    return OptimizerSpec(lr_fn, kind, weight_decay, momentum, grad_accum,
                         max_grad_norm, no_decay_mask_fn)


class TrainState:
    """model + optimizer + EMA + step. `create` builds it; `apply_gradients`
    consumes the `.grad` of the model's parameters."""

    def __init__(self, model, ema_model, tx, optimizer, ema_base_decay):
        self.model = model
        self.ema_model = ema_model
        self.tx = tx
        self.optimizer = optimizer
        self.ema_base_decay = ema_base_decay
        self.step = 0          # micro-steps taken
        self.opt_count = 0     # inner optimizer updates taken
        self.mini_step = 0     # micro-steps since the last inner update
        self._params = [p for p in model.parameters() if p.requires_grad]
        self._all = list(model.parameters())
        self._ema = ([p for p in ema_model.parameters()]
                     if ema_model is not None else None)
        self._acc = None       # running mean of the micro-steps' gradients

    @classmethod
    def create(cls, model: nn.Module, tx: OptimizerSpec,
               ema_base_decay: float = 0.9998, use_ema: bool = True,
               device="cuda") -> "TrainState":
        """The model goes to `device` (the card unless the caller asks for
        the CPU); the EMA copy starts equal to it. The parameters the rule
        freezes stop requiring gradients."""
        model = model.to(resolve_device(device))
        named = list(model.named_parameters())
        mask = (tx.no_decay_mask_fn(named) if tx.no_decay_mask_fn
                else {n: True for n, _ in named})
        trains = (tx.trainable_mask_fn(named) if tx.trainable_mask_fn
                  else {n: True for n, _ in named})
        for n, p in named:
            p.requires_grad_(trains[n])
        named = [(n, p) for n, p in named if trains[n]]
        groups = [
            {"params": [p for n, p in named if mask[n]],
             "weight_decay": tx.weight_decay},
            {"params": [p for n, p in named if not mask[n]],
             "weight_decay": 0.0}]
        if tx.kind == "adamw":
            opt = torch.optim.AdamW(groups, lr=0.0, betas=(0.9, 0.999),
                                    eps=1e-8)
        else:
            opt = torch.optim.SGD(groups, lr=0.0, momentum=tx.momentum,
                                  nesterov=True)
        ema = None
        if use_ema:
            ema = copy.deepcopy(model).requires_grad_(False)
        return cls(model, ema, tx, opt, ema_base_decay)

    def lr(self) -> float:
        """The learning rate of the next inner update."""
        return float(self.tx.lr_fn(self.opt_count * self.tx.grad_accum))

    @torch.no_grad()
    @spanned("train.optimizer")
    def apply_gradients(self) -> "TrainState":
        """One micro-step from the trainable parameters' `.grad` (one
        without a gradient counts as a zero gradient, so that it still
        decays)."""
        tx = self.tx
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self._params]
        if tx.grad_accum > 1:
            if self._acc is None:
                self._acc = [torch.zeros_like(p) for p in self._params]
            # acc += (g - acc) / (mini_step + 1): optax.MultiSteps' mean
            torch._foreach_sub_(grads, self._acc)
            torch._foreach_add_(self._acc, grads,
                                alpha=1.0 / (self.mini_step + 1))
            self.mini_step += 1
            grads = self._acc if self.mini_step == tx.grad_accum else None
        if grads is not None:
            if tx.max_grad_norm is not None:
                norm = torch.linalg.vector_norm(torch.stack(
                    [torch.linalg.vector_norm(g) for g in grads]))
                scale = tx.max_grad_norm / norm.clamp_min(tx.max_grad_norm)
                grads = [g * scale for g in grads]
            lr = self.lr()
            for group in self.optimizer.param_groups:
                group["lr"] = lr
            for p, g in zip(self._params, grads):
                p.grad = g
            self.optimizer.step()
            self.opt_count += 1
            self.mini_step = 0
            if self._acc is not None:
                torch._foreach_zero_(self._acc)
        for p in self._params:
            p.grad = None
        self.step += 1
        if self._ema is not None:
            with span("train.ema"):
                d = ema_decay_schedule(self.ema_base_decay, self.step)
                torch._foreach_mul_(self._ema, d)
                torch._foreach_add_(self._ema, self._all, alpha=1.0 - d)
        return self

    def state_dict(self) -> dict:
        """model, EMA model (None without EMA), optimizer, the counters and
        the accumulation buffer (None until the first micro-step). The
        tensors are the state's own, not copies."""
        return {
            "model": self.model.state_dict(),
            "ema_model": (self.ema_model.state_dict()
                          if self.ema_model is not None else None),
            "optimizer": self.optimizer.state_dict(),
            "step": self.step, "opt_count": self.opt_count,
            "mini_step": self.mini_step,
            "acc": list(self._acc) if self._acc is not None else None}

    def load_state_dict(self, sd: dict, optimizer: bool = True):
        """Restore what state_dict saved. The EMA copy loads `ema_model`
        (the model's entry when that is None) and stays off when this state
        has none. optimizer=False restores the weights and `step` only and
        leaves the optimizer, its counters and the accumulator fresh."""
        self.model.load_state_dict(sd["model"])
        if self.ema_model is not None:
            self.ema_model.load_state_dict(sd.get("ema_model") or sd["model"])
        self.step = int(sd["step"])
        if not optimizer:
            return
        self.optimizer.load_state_dict(sd["optimizer"])
        self.opt_count = int(sd["opt_count"])
        self.mini_step = int(sd["mini_step"])
        self._acc = None
        if sd.get("acc") is not None:
            self._acc = [a.to(p.device, p.dtype)
                         for a, p in zip(sd["acc"], self._params)]


def rewind_opt_counts(state: TrainState, opt_step: int, step: int):
    """Set every step counter to the epoch boundary: `opt_count` and each
    AdamW parameter's `state["step"]` (its bias correction) to `opt_step`,
    `step` (the EMA decay, BoxInst's warm-up) to `step`, `mini_step` to 0
    with the accumulator zeroed (port of JAX's, which sets optax's counts
    and MultiSteps' `mini_step` in the state tree).

    Used when resuming a mid-epoch preemption checkpoint: the trainer
    replays that epoch from iteration 0, so counters saved mid-epoch would
    run the learning-rate schedule ahead of the iteration count by the
    replayed iterations."""
    state.opt_count = opt_step
    state.step = step
    state.mini_step = 0
    if state._acc is not None:
        torch._foreach_zero_(state._acc)
    for s in state.optimizer.state.values():
        if "step" in s:  # AdamW; SGD keeps none
            s["step"].fill_(float(opt_step))
