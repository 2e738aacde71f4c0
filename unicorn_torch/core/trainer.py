"""Training loop (port of unicorn_tpu/core/trainer.py).

Keeps the JAX trainer's protocol: the loader's task alternation, a
multiscale size drawn every 10 iterations from (epoch, iter) alone, EMA and
gradient accumulation in the TrainState, checkpoints with resume (a
mid-epoch preemption checkpoint rewinds the counters to the epoch
boundary), the no-aug switch to L1, in-training eval and the `best`
checkpoint where the exp has an evaluator (every eval_interval epochs), and
metrics.jsonl / train_log.txt.

Data parallelism (JAX: a "data" mesh over the devices): with a process
group up (parallel/multihost.py `initialize_multihost`, one process a
card), the global batch `batch_size` splits over the W ranks (a batch that
does not divide raises), each rank's loader draws its own stream of
`batch_size / W` samples (`set_rank`), the state starts as rank 0's
(`replicate_state`), and the steps sum the gradients and the losses'
normalising counts over the ranks (core/train_step.py), so that the EMA
and the optimizer state stay equal on every rank. Checkpoints, metrics,
the eval and the log file are rank 0's. Without a group, one process on
one device.

The model, the state and every batch live on `device`, the card unless the
caller passes device="cpu" (under torchrun, tools/train.py passes the card
of the rank's LOCAL_RANK). Batches leave the loader as numpy in JAX's
layout; `device_batch` copies them through page-locked memory (on the
card) and gives the images the steps' NCHW layout, (B, 2, 3, H, W) or
(B, 3, H, W) float32 in [0, 255].
"""
from __future__ import annotations

import json
import os
import signal
import threading
import time

import numpy as np
import torch

from ..device import resolve_device
from ..evaluators.coco_evaluator import decode_forward
from ..evaluators.coco_inst_evaluator import COCOInstEvaluator
from ..parallel.mesh import local_batch_slice, rank, replicate_state, world
from ..utils.debug_dump import dump_uni_batch
from ..utils.logger import setup_logger
from ..utils.meters import MeterBuffer
from .checkpoint import (load_checkpoint, load_matching, save_checkpoint,
                         wait_for_checkpoints)
from .train_state import TrainState, rewind_opt_counts
from .train_step import make_det_train_step


class Trainer:
    def __init__(self, exp, args=None, device="cuda"):
        self.exp = exp
        self.args = args or {}
        self.device = resolve_device(device)
        self.max_epoch = exp.max_epoch
        self.input_size = tuple(exp.input_size)
        self.batch_size = int(self.args.get("batch_size", 8))
        # the global batch over the ranks: this rank loads its share
        self.rank, self.world = rank(), world()
        self.local_batch_size = local_batch_slice(self.batch_size)[1]
        self.iters_per_epoch = int(
            getattr(exp, "samples_per_epoch", 200000) // self.batch_size)
        self.output_dir = os.path.join(exp.output_dir, exp.exp_name)
        os.makedirs(self.output_dir, exist_ok=True)
        self.logger = setup_logger(self.output_dir if self.rank == 0
                                   else None)
        # data_time, step_time: seconds an iteration over the whole run
        self.meters = MeterBuffer()
        self.start_epoch = 0
        self.epoch = 0
        self.iter = 0
        self.best_ap = 0.0
        self.no_aug = False  # flips at max_epoch - no_aug_epochs
        self._preempted = None  # signal number once SIGTERM/SIGUSR1 lands

    # ------------------------------------------------------------------
    def train(self):
        self.before_train()
        old_handlers = self._install_preemption_handlers()
        try:
            for self.epoch in range(self.start_epoch, self.max_epoch):
                self.before_epoch()
                if self.train_in_epoch() == "debug_only":
                    break  # the first batch is dumped; nothing trains
                if self._preempted is not None:
                    break  # checkpoint already written by train_in_epoch
                self.after_epoch()
        finally:
            for sig, h in old_handlers.items():
                signal.signal(sig, h)
            self.loader.stop()
            wait_for_checkpoints()
            self.logger.info(
                "Training done." if self._preempted is None else
                "Training stopped by signal %s; resume with --resume."
                % self._preempted)

    def _install_preemption_handlers(self):
        """Preemptible machines send SIGTERM (maintenance, SIGUSR1) with a
        short grace window before eviction. The handler only sets a flag;
        the loop writes a blocking `latest` at the next step boundary and
        stops. Resume replays the interrupted epoch. Returns the displaced
        handlers."""
        if threading.current_thread() is not threading.main_thread():
            return {}  # signal.signal works on the main thread only

        def handler(signum, frame):
            self._preempted = signum

        old = {}
        for sig in (signal.SIGTERM, signal.SIGUSR1):
            try:
                old[sig] = signal.signal(sig, handler)
            except (ValueError, OSError):  # unsupported on this platform
                pass
        return old

    def before_train(self):
        exp = self.exp
        model = exp.get_model(torch.Generator().manual_seed(exp.seed or 0))
        self.model = model.train()
        if getattr(exp, "pretrain_name", None) and \
                hasattr(exp, "load_pretrained"):
            try:
                self.model.load_state_dict(
                    exp.load_pretrained(self.model.state_dict()))
                self.logger.info("loaded pretrained weights: %s",
                                 exp.pretrain_name)
            except FileNotFoundError:
                self.logger.warning("pretrain checkpoint not found; "
                                    "training from scratch")
        tx = exp.get_optimizer(self.batch_size, self.iters_per_epoch)
        self.state = TrainState.create(
            self.model, tx, use_ema=getattr(exp, "ema", True),
            device=self.device)
        if self.args.get("resume"):
            self._resume()
        elif self.args.get("ckpt"):
            # fine-tuning: weights only, shape-tolerant; optimizer, epoch
            # and counters fresh
            ckpt_dir, ckpt_name = os.path.split(
                os.path.abspath(self.args["ckpt"]))
            loaded = load_checkpoint(ckpt_dir, ckpt_name)
            self.model.load_state_dict(load_matching(
                self.model.state_dict(), loaded["model"]))
            self.logger.info("loaded fine-tune checkpoint %s",
                             self.args["ckpt"])
        # every rank starts from rank 0's weights
        replicate_state(self.state)
        self.loader = exp.get_data_loader(self.local_batch_size)
        if self.world > 1:
            # rank-disjoint sampling: without it every rank would draw the
            # same images
            self.loader.set_rank(self.rank, self.world)
        self._step_fns = {}
        self.step_fn = self._get_step_fn(self.input_size)
        # multiscale sizes in 32-px steps at the input's aspect ratio
        steps = int(getattr(exp, "multiscale_range", 0))
        h, w = self.input_size
        self.size_list = [
            (h + 32 * d, int(round((w + 32 * d * w / h) / 32)) * 32)
            for d in range(-steps, steps + 1)] if steps else [self.input_size]

    def _resume(self):
        """Resume from args["ckpt"] or <output>/latest: weights, EMA,
        optimizer, counters, epoch and best AP. A checkpoint without a
        usable optimizer state resumes the weights with fresh optimizer
        moments and a warning. A checkpoint saved mid-epoch replays that
        epoch, so its counters rewind to the epoch boundary. A missing
        checkpoint that was named explicitly raises; a missing `latest`
        starts fresh."""
        ckpt_dir, ckpt_name = self.output_dir, "latest"
        if self.args.get("ckpt"):
            ckpt_dir, ckpt_name = os.path.split(
                os.path.abspath(self.args["ckpt"]))
        try:
            loaded = load_checkpoint(ckpt_dir, ckpt_name)
        except FileNotFoundError:
            if self.args.get("ckpt"):
                # restarting a long run from scratch on a mistyped path
                # would overwrite it
                raise
            self.logger.info("no checkpoint to resume; starting fresh")
            return
        try:
            self.state.load_state_dict(loaded)
        except (KeyError, ValueError) as e:
            self.state.load_state_dict(loaded, optimizer=False)
            self.logger.warning(
                "checkpoint has no (or mismatched) optimizer state (%r); "
                "resuming with fresh optimizer moments", e)
        self.start_epoch = int(loaded.get("epoch", 0))
        if self.args.get("start_epoch") is not None:
            self.start_epoch = int(self.args["start_epoch"]) - 1
        boundary = self.start_epoch * self.iters_per_epoch
        if self.state.step > boundary:
            # mid-epoch (preemption) checkpoint: the epoch replays from
            # iteration 0, so the counters go back to its boundary, or the
            # schedule runs ahead of the iteration count from then on
            saved = self.state.step
            rewind_opt_counts(self.state,
                              boundary // self.state.tx.grad_accum, boundary)
            self.logger.info(
                "mid-epoch checkpoint (step %d): rewound the counters to the "
                "epoch-%d boundary (step %d) for the replayed epoch", saved,
                self.start_epoch, boundary)
        self.best_ap = float(loaded.get("best_ap", 0.0))
        self.logger.info("resumed from epoch %d (best_ap %.4f)",
                         self.start_epoch, self.best_ap)

    def _get_step_fn(self, size):
        """The step function at `size` (H, W), built once a size."""
        size = tuple(size)
        if size not in self._step_fns:
            exp = self.exp
            if exp.task in ("uni", "inst") and hasattr(exp, "get_train_step"):
                old = exp.input_size
                exp.input_size = size
                self._step_fns[size] = exp.get_train_step(self.batch_size)
                exp.input_size = old
            else:
                self._step_fns[size] = make_det_train_step(
                    size, use_l1=getattr(exp, "always_l1", False)
                    or self.no_aug)
        return self._step_fns[size]

    def before_epoch(self):
        """The no-aug transition at max_epoch - no_aug_epochs: mosaic and
        mixup close, the losses switch to L1 for the remaining epochs."""
        exp = self.exp
        no_aug = int(getattr(exp, "no_aug_epochs", 0))
        if self.no_aug or not no_aug or self.epoch < self.max_epoch - no_aug:
            return
        self.no_aug = True
        self.logger.info("epoch %d: closing mosaic/mixup, enabling L1 "
                         "(no-aug final epochs)", self.epoch)
        for obj in (getattr(self.loader, "dataset", None), self.loader):
            if hasattr(obj, "close_mosaic"):
                obj.close_mosaic()
                break
        # the uni and inst step factories read exp.always_l1
        if hasattr(exp, "always_l1"):
            exp.always_l1 = True
        self._step_fns = {}
        self.save_ckpt("last_mosaic_epoch")

    def device_batch(self, batch):
        """A loader batch (numpy, JAX's layout) as tensors on the device:
        images to NCHW, task ids int64."""
        def put(a):
            t = torch.from_numpy(np.ascontiguousarray(a))
            if self.device.type == "cuda":
                t = t.pin_memory()
            return t.to(self.device, non_blocking=True)

        out = [put(a) for a in batch]
        images = out[0]
        order = (0, 1, 4, 2, 3) if images.dim() == 5 else (0, 3, 1, 2)
        out[0] = images.permute(*order).contiguous()
        if self.exp.task == "uni":
            out[2] = out[2].long()
        return out

    def train_in_epoch(self):
        """One epoch of steps. With the exp's debug_only, the first batch
        of a uni exp is drawn to <output_dir>/debug_data instead
        (utils/debug_dump.py) and no step runs: returns "debug_only"."""
        t_data = t_step = 0.0
        it = iter(self.loader)
        for self.iter in range(self.iters_per_epoch):
            t0 = time.perf_counter()
            batch = next(it)
            if getattr(self.exp, "debug_only", False) and self.iter == 0:
                if self.exp.task == "uni" and self.rank == 0:
                    dump_uni_batch(os.path.join(self.output_dir, "debug_data"),
                                   *batch[:3],
                                   masks=batch[3] if len(batch) == 4 else None)
                self.logger.info("debug_only: dumped first batch to %s; "
                                 "stopping", self.output_dir)
                return "debug_only"
            batch = self.device_batch(batch)
            t1 = time.perf_counter()
            self.step_fn = self._get_step_fn(tuple(batch[0].shape[-2:]))
            if self.exp.task == "inst":
                images, labels, masks = batch
                self.state, loss_dict = self.step_fn(
                    self.state, images, labels[..., :5], masks)
            else:
                self.state, loss_dict = self.step_fn(self.state, *batch)
            t2 = time.perf_counter()
            t_data += t1 - t0
            t_step += t2 - t1
            self.meters.update(data_time=t1 - t0, step_time=t2 - t1)
            if self._preempted is not None:
                self.logger.warning(
                    "signal %s received: writing preemption checkpoint "
                    "(epoch %d, iter %d) and stopping", self._preempted,
                    self.epoch, self.iter + 1)
                # an async `latest` may still be in flight: drain it first
                wait_for_checkpoints()
                # epoch not advanced: resume replays this epoch
                self.save_ckpt("latest", epoch=self.epoch, blocking=True)
                break
            if (self.iter + 1) % 10 == 0 and len(self.size_list) > 1 and \
                    hasattr(self.loader, "set_input_size"):
                # a function of (seed, epoch, iter) alone
                seed = ((self.exp.seed or 0) * 1000003
                        + self.epoch * 100003 + self.iter) % (2 ** 32)
                idx = np.random.RandomState(seed).randint(len(self.size_list))
                self.loader.set_input_size(self.size_list[idx])
            if (self.iter + 1) % self.exp.print_interval == 0:
                losses = {k: float(v) for k, v in loss_dict.items()}
                self._log_metrics({"epoch": self.epoch, "iter": self.iter + 1,
                                   **losses})
                left = (self.iters_per_epoch - self.iter - 1) \
                    + (self.max_epoch - self.epoch - 1) * self.iters_per_epoch
                eta = left * (t_step + t_data) / max(self.iter + 1, 1)
                self.logger.info(
                    "epoch %d iter %d/%d  total=%.3f  data %.2fs step %.2fs "
                    "ETA %.0fmin  %s", self.epoch, self.iter + 1,
                    self.iters_per_epoch, losses.get("total_loss", 0.0),
                    t_data, t_step, eta / 60,
                    {k: round(v, 3) for k, v in losses.items()
                     if k != "total_loss"})

    def after_epoch(self):
        self.save_ckpt("latest")
        if self.rank == 0 and (self.epoch + 1) % self.exp.eval_interval == 0:
            # rank 0's alone: the other ranks would repeat the eval forward
            # and interleave their records into metrics.jsonl
            self.evaluate_and_save_best()

    def evaluate_and_save_best(self):
        """In-training eval of the EMA model (the model without EMA) on the
        exp's trainer evaluator, its first 1000 images, under
        inference_mode, the model in eval mode and every module's mode
        restored afterwards; a new best AP writes `best`. An exp without an
        evaluator (get_trainer_evaluator raises NotImplementedError) skips
        the eval; any other failure propagates."""
        try:
            evaluator = self.exp.get_trainer_evaluator(device=self.device)
        except NotImplementedError:
            self.logger.debug("exp has no evaluator; skipping in-training "
                              "eval")
            return
        model = self.state.ema_model or self.state.model
        modes = [(m, m.training) for m in model.modules()]
        try:
            if isinstance(evaluator, COCOInstEvaluator):
                # the mask exps' evaluator takes decode + NMS + the CondInst
                # mask decode, (dets, valid, masks) an image
                forward = self.exp.get_inst_forward(model, device=self.device)
            else:
                model.eval()
                forward = decode_forward(model)
            with torch.inference_mode():
                metrics = evaluator.evaluate(forward, max_images=1000)
        finally:
            for m, training in modes:
                m.training = training
        # det evals report "AP"; the inst evaluator "mask_AP" or "box_AP"
        ap = metrics.get("AP", metrics.get("mask_AP",
                                           metrics.get("box_AP", 0.0)))
        self.logger.info("eval: %s", metrics)
        self._log_metrics({"epoch": self.epoch, "eval": True,
                           **{k: float(v) for k, v in metrics.items()
                              if isinstance(v, (int, float))}})
        if ap > self.best_ap:
            self.best_ap = ap
            self.save_ckpt("best")

    def _log_metrics(self, record):
        """Scalar metrics appended to metrics.jsonl, by rank 0."""
        if self.rank != 0:
            return
        with open(os.path.join(self.output_dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(record) + "\n")

    def save_ckpt(self, name, epoch=None, blocking=False):
        """Write the state, epoch (the next one to run, unless given) and
        best AP to <output>/<name>; without EMA the weights stand in for
        the EMA weights. Asynchronous unless blocking; train() waits for
        the writes on exit. Rank 0 writes; the other ranks hold the same
        state."""
        if self.rank != 0:
            return
        epoch = self.epoch + 1 if epoch is None else epoch
        sd = self.state.state_dict()
        if sd["ema_model"] is None:
            sd["ema_model"] = sd["model"]
        save_checkpoint(self.output_dir, {**sd, "epoch": epoch,
                                          "best_ap": float(self.best_ap)},
                        name, blocking=blocking)
        self.logger.info("saved checkpoint %s (epoch %d)", name, epoch)
